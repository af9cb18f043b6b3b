"""Mean host milliseconds of an episode rollout's call: the duration of
its ``rollout.call`` span, from the call's entry to its return (the
host's enqueue of the call's work, not the card's time on it)."""

from benchmark.harness import HERE, load_module

spans = load_module(HERE / "metrics" / "host_syncs_per_call.rollout.py", "benchmark_spans")


def read(run):
    return spans.mean_ms(run.trace, "rollout.call")
