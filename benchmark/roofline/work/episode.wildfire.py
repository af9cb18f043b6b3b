"""``wf_steps_philox``'s work in a Wildfire episode window: per call from
the checked call's replay (its fresh boards and the Philox calls and
words its data needs), times the traced calls."""

from benchmark.reference import ctf as ref_ctf
from benchmark.reference import wildfire as ref_wf
from benchmark.roofline import counts, window

KERNEL = "wf_steps_philox"


def read(run):
    seconds = window.matched(run, "wildfire::", "philox_steps_kernel")
    need = run.counts.get("philox")
    if seconds is None or not need:
        return None
    c, t = run.counts, ref_wf.tables(run.cell.config["config"])
    Ks = ref_ctf.chunk_sizes(c["steps_per_call"], c["chunk"])
    nbytes, ops = counts.wf_steps_philox_call(c["num_envs"], t.n_cells, t.n_agents, t.n_fires,
                                              Ks, need["fresh"], need["calls"], need["words"])
    return nbytes * run.trace.calls, ops * run.trace.calls, seconds
