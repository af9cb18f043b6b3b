"""Maze in the episode driver: the program's ``MazeConfig``, the episode
rollout (``ops/maze_slab.py``) with its K-step wrapper, and the
reference's replay of a checked call on the Philox counters
(``reference/maze.py``).  The check compares the position (packed as
one cell), the direction and the step count after the call, the first
reset, the finished episodes, the running return and the two sums."""

from __future__ import annotations

import numpy as np

from benchmark.reference import maze as ref_mz
from benchmark.reference import philox

#: Steps and chunk of an episode call at the CPU tests' size: each call
#: reaches the 100-step truncation and some envs the flag; its chunks
#: start at odd and even steps.
TINY = {"episode": {"steps_per_call": 130, "chunk": 45}}


def config(c: dict):
    from gym_multigrid_tpu_torch.envs.maze import MazeConfig

    c = dict(c)
    fm = np.asarray(c.pop("map_rows"), dtype=np.int64).T
    return MazeConfig(map_data=tuple(tuple(int(v) for v in row) for row in fm), **c)


def make(cfg, B: int, device, chunk: int):
    from gym_multigrid_tpu_torch.ops import maze_slab

    return maze_slab.make_maze_episode_rollout(cfg, B, device=device, chunk=chunk)


def wrapper():
    from gym_multigrid_tpu_torch.ops import maze_slab

    return maze_slab.maze_philox_slab


def call(rollout, states, steps: int, run_ret):
    return rollout(states, steps, run_ret)


def flat(state, B: int):
    return ref_mz.pack(state.pos), state.dir, state.step_count


def reference(conf: dict, seed: int, state, run_ret, index: int, steps: int, chunk: int, fdt,
              count=None):
    """The reference's first reset and its run of call ``index`` from the
    program's state before it: (reset state, state after, running return,
    sums); ``count`` is not used, as the cell has no work reader."""
    B, dev = run_ret.shape[0], run_ret.device
    t, key = ref_mz.tables(conf), philox.key_of(seed)
    step0 = index * steps
    prog = (state.pos, state.dir, state.step_count, run_ret.to(fdt))
    out, run, sums = ref_mz.episode_call(t, prog, key, step0, steps, fdt)
    return ref_mz.first_reset(t, key, B, dev, fdt), out, run, sums
