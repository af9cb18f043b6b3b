"""``ctf_steps``'s work in a CtF episode window: each traced call's
chunks, and the spawns of the window's finished episodes."""

from benchmark.reference import ctf as ref_ctf
from benchmark.roofline import counts, window

KERNEL = "ctf_steps"


def read(run):
    seconds = window.matched(run, "ctf::", "steps_kernel")
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
