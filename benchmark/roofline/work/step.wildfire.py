"""``wildfire_step``'s work in a per-step Wildfire window: one launch a
call, counted by the wrapper."""

from benchmark.reference import wildfire as ref_wf
from benchmark.roofline import counts, window

KERNEL = "wildfire_step"


def read(run):
    seconds = window.matched(run, "wildfire::", "step_kernel", exclude=("philox",))
    if seconds is None:
        return None
    t = ref_wf.tables(run.cell.config["config"])
    b, o = counts.wildfire_step_launch(run.counts["num_envs"], t.n_cells, t.n_agents)
    n = run.counts["launches"]
    return b * n, o * n, seconds
