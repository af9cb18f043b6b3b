"""The work a traced window gave each measured kernel: (bytes,
operations, the kernel's summed device seconds), read from the run's
trace and counts and from the configuration's own tables.  None where
the run has no trace, or the trace's launches of the kernel are not the
launches the program's wrapper counted."""

from __future__ import annotations

from benchmark.reference import ctf as ref_ctf
from benchmark.reference import wildfire as ref_wf
from benchmark.roofline import counts


def _matched(run, *fragments, exclude=()):
    if run.trace is None:
        return None
    ops = run.trace.kernels(*fragments, exclude=exclude)
    if not ops or len(ops) != run.counts.get("launches"):
        return None
    return sum(op[2] for op in ops) / 1e9


def ctf_steps(run):
    seconds = _matched(run, "ctf::", "steps_kernel")
    if seconds is None:
        return None
    c, t = run.counts, ref_ctf.tables(run.cell.config["config"])
    B, Ks = c["num_envs"], ref_ctf.chunk_sizes(c["steps_per_call"], c["chunk"])
    static = t.s0 * t.s1 + 8 + 8 + 4 * 2 * (len(t.blue_terr) + len(t.red_terr))
    nbytes = ops = 0
    for K in Ks * run.trace.calls:
        b, o = counts.ctf_steps_launch(B, K, t.n_blue, t.n_red, [k for k, _ in t.policies],
                                       t.mvn, t.step_draws, static, 0)
        nbytes, ops = nbytes + b, ops + o
    A = t.n_agents
    done = c["episodes"]
    nbytes += done * A * 4
    ops += done * A * (counts.CTF_SPAWN_OPS
                       + counts.CTF_SPAWN_PAIR_OPS * (max(t.n_blue, t.n_red) - 1))
    return nbytes, ops, seconds


def wf_steps_philox(run):
    """Per-call work from the checked call's replay (its fresh boards and
    the Philox calls and words its data needs), times the traced calls."""
    seconds = _matched(run, "wildfire::", "philox_steps_kernel")
    need = run.counts.get("philox")
    if seconds is None or not need:
        return None
    c, t = run.counts, ref_wf.tables(run.cell.config["config"])
    Ks = ref_ctf.chunk_sizes(c["steps_per_call"], c["chunk"])
    nbytes, ops = counts.wf_steps_philox_call(c["num_envs"], t.n_cells, t.n_agents, t.n_fires,
                                              Ks, need["fresh"], need["calls"], need["words"])
    return nbytes * run.trace.calls, ops * run.trace.calls, seconds


def wildfire_step(run):
    seconds = _matched(run, "wildfire::", "step_kernel", exclude=("philox",))
    if seconds is None:
        return None
    t = ref_wf.tables(run.cell.config["config"])
    b, o = counts.wildfire_step_launch(run.counts["num_envs"], t.n_cells, t.n_agents)
    n = run.counts["launches"]
    return b * n, o * n, seconds


#: The measured kernel of each kind of cell, by (driver, family).
BY_CELL = {("episode", "ctf"): ctf_steps, ("episode", "wildfire"): wf_steps_philox,
           ("step", "wildfire"): wildfire_step}


def share(work) -> float | None:
    """The kernel's roofline share in %, or None."""
    if work is None:
        return None
    nbytes, ops, seconds = work
    return 100.0 * counts.bound_s(nbytes, ops)[0] / seconds
