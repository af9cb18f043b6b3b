"""Wildfire in the episode driver: the program's ``WildfireConfig``, the
episode rollout (``ops/wildfire_slab.py``) with its K-step wrapper, and
the reference's replay of a checked call on the Philox counters
(``reference/wildfire.py``), which also counts the fresh boards and the
Philox calls and words the roofline needs."""

from __future__ import annotations

import torch

from benchmark.reference import philox
from benchmark.reference import wildfire as ref_wf

#: Steps and chunk of an episode call at the CPU tests' size.
TINY = {"episode": {"steps_per_call": 12, "chunk": 5}}


def config(c: dict):
    from gym_multigrid_tpu_torch.envs.wildfire import WildfireConfig

    return WildfireConfig(**dict(c, agents_index=tuple(c["agents_index"])))


def make(cfg, B: int, device, chunk: int):
    from gym_multigrid_tpu_torch.ops import wildfire_slab

    return wildfire_slab.make_wildfire_episode_rollout(cfg, B, device=device, chunk=chunk)


def wrapper():
    from gym_multigrid_tpu_torch.ops import wildfire_slab

    return wildfire_slab.wf_philox_slab


def call(rollout, states, steps: int, run_ret):
    return rollout(states, steps, run_ret)


def flat(state, B: int):
    return (state.cells.reshape(B, -1), state.agent_pos.reshape(B, -1), state.step_count,
            state.extinguished)


def reference(conf: dict, seed: int, state, run_ret, index: int, steps: int, chunk: int, fdt,
              count=None):
    """The reference's first reset and its run of call ``index`` from the
    program's state before it: (reset state, state after, running return,
    sums).  ``count``, a dict, gets ``philox``: the call's fresh boards and
    the Philox calls and words its data needs."""
    B, dev = run_ret.shape[0], run_ret.device
    need = None
    if count is not None:
        need = count["philox"] = {"calls": 0, "words": 0, "fresh": 0}
    t = ref_wf.tables(conf)
    key = philox.key_of(seed)
    rnd = philox.first_reset_draws(key, B, t.n_cells, t.n_fires + t.n_agents, dev)
    cells, pos = ref_wf.fresh(t, rnd, fdt)
    zeros = torch.zeros((B,), dtype=torch.int32, device=dev)
    prog = (state.cells.reshape(B, -1), state.agent_pos.reshape(B, -1), state.step_count,
            state.extinguished, run_ret.to(fdt))
    out, sums = ref_wf.episode_call(t, prog, key, index * steps, steps, chunk, fdt, need)
    return (cells, pos, zeros, zeros), out[:4], out[4], sums
