"""Milliseconds a train step the host spends blocked in the CUDA runtime:
the summed durations of the runtime calls it waits in
(``host_syncs_per_call.rollout``'s ``WAITS``: the synchronising calls and
every copy) inside ``ppo.rollout`` and ``ppo.update``, over the window's
train steps."""

from benchmark.harness import HERE, load_module

spans = load_module(HERE / "metrics" / "host_syncs_per_call.rollout.py", "benchmark_spans")


def read(run):
    tr = run.trace
    if tr is None or not tr.calls:
        return None
    roots = spans.spans(tr, ("ppo.rollout", "ppo.update"))
    if not roots:
        return None
    return sum(op[2] for op in spans.inside(tr, roots, spans.WAITS)) / tr.calls / 1e6
