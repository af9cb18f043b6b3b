"""Batched lockstep envs of the port: the names of
``gym_multigrid_tpu.parallel`` but its mesh helpers and
``sharded_rollout``, which belong to the multi-process runs."""

from gym_multigrid_tpu_torch.parallel.vector import (
    BatchedEnv,
    make_collect_batch,
    make_ctf_batch,
    make_maze_batch,
    make_wildfire_batch,
)

__all__ = [
    "BatchedEnv",
    "make_collect_batch",
    "make_ctf_batch",
    "make_maze_batch",
    "make_wildfire_batch",
]
