"""Mean host milliseconds of a per-step call: the duration of its
``env.step`` span (the transition, the observation and the auto-reset as
the host launches them)."""

from benchmark.harness import HERE, load_module

spans = load_module(HERE / "metrics" / "host_syncs_per_call.rollout.py", "benchmark_spans")


def read(run):
    return spans.mean_ms(run.trace, "env.step")
