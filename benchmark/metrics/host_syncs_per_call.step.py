"""Host synchronisations a per-step call: the synchronising runtime calls
(``host_syncs_per_call.rollout``'s ``SYNCS``) inside an ``env.step``
span, over the window's calls."""

from benchmark.harness import HERE, load_module

spans = load_module(HERE / "metrics" / "host_syncs_per_call.rollout.py", "benchmark_spans")


def read(run):
    return spans.syncs_per_call(run.trace, ("env.step",))
