"""Batched lockstep execution and multi-process runs (PyTorch port): the
names of ``gym_multigrid_tpu.parallel`` that have a meaning without GSPMD
(``batch_sharding``, ``batch_tree_shardings``, ``replicated`` and the
tensor-parallel ``param_tp_shardings`` are not ported; see
``parallel/mesh.py``)."""

from gym_multigrid_tpu_torch.parallel.mesh import (
    distributed_initialize,
    fold_in_axis,
    make_mesh,
    shard_batch_tree,
)
from gym_multigrid_tpu_torch.parallel.shard import sharded_rollout
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
    "make_mesh",
    "shard_batch_tree",
    "distributed_initialize",
    "fold_in_axis",
    "sharded_rollout",
]
