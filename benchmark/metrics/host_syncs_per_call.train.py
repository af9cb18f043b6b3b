"""Host synchronisations a train step: the synchronising runtime calls
(``host_syncs_per_call.rollout``'s ``SYNCS``) inside the learner's two
roots, ``ppo.rollout`` and ``ppo.update``, over the window's train
steps."""

from benchmark.harness import HERE, load_module

spans = load_module(HERE / "metrics" / "host_syncs_per_call.rollout.py", "benchmark_spans")


def read(run):
    return spans.syncs_per_call(run.trace, ("ppo.rollout", "ppo.update"))
