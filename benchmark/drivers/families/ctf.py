"""Capture the Flag in the episode driver: the program's ``CtfConfig``,
the episode rollout (``ops/ctf_slab.py``) with its K-step wrapper, and
the reference's replay of a checked call (``reference/ctf.py``), whose
draws are the rollout's ``torch.Generator`` replayed from the seed."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import ctf as ref_ctf

#: Steps and chunk of an episode call at the CPU tests' size.
TINY = {"episode": {"steps_per_call": 20, "chunk": 7}}


def config(c: dict):
    from gym_multigrid_tpu_torch.envs.ctf import CtfConfig, PolicySpec

    c = dict(c)
    fm = np.asarray(c.pop("map_rows"), dtype=np.int64).T
    c["enemy_policies"] = tuple(PolicySpec(**p) for p in c["enemy_policies"])
    return CtfConfig(map_data=tuple(tuple(int(v) for v in row) for row in fm), **c)


def make(cfg, B: int, device, chunk: int):
    from gym_multigrid_tpu_torch.ops import ctf_slab

    return ctf_slab.make_ctf_episode_rollout(cfg, B, device=device, chunk=chunk)


def wrapper():
    from gym_multigrid_tpu_torch.ops import ctf_slab

    return ctf_slab.ctf_ms_slab


def call(rollout, states, steps: int, run_ret):
    return rollout(states, steps, run_ret)


def flat(state, B: int):
    return (state.pos.reshape(B, -1), state.dir, state.terminated, state.collided,
            state.step_count)


def reference(conf: dict, seed: int, state, run_ret, index: int, steps: int, chunk: int, fdt,
              count=None):
    """The reference's first reset and its run of call ``index`` from the
    program's state before it: (reset state, state after, running return,
    sums).  ``count`` is not read: the roofline counts the window's
    finished episodes."""
    B, dev = run_ret.shape[0], run_ret.device
    t = ref_ctf.tables(conf)
    gen = torch.Generator(device=dev).manual_seed(seed)
    (reset, sc0) = ref_ctf.first_reset(t, gen, B, dev, fdt)
    for _ in range(index):  # the draws of the calls before this one
        for K in ref_ctf.chunk_sizes(steps, chunk):
            ref_ctf.episode_draws(t, gen, B, K, dev)
    prog = (state.pos.reshape(B, -1), state.dir, state.terminated, state.collided)
    out, sc, rr, sums = ref_ctf.episode_call(t, prog, state.step_count, run_ret, gen, steps,
                                             chunk, fdt)
    return (*reset, sc0), (*out, sc), rr, sums
