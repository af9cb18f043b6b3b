"""Mean host milliseconds of a train step's rollout: the duration of its
``ppo.rollout`` span, beside ``rollout_ms.train``, the same half between
CUDA events on the card's stream."""

from benchmark.harness import HERE, load_module

spans = load_module(HERE / "metrics" / "host_syncs_per_call.rollout.py", "benchmark_spans")


def read(run):
    return spans.mean_ms(run.trace, "ppo.rollout")
