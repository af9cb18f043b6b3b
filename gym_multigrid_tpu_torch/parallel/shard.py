"""Sharded rollouts: each rank steps its own envs, and only the scalar
metrics cross processes (PyTorch port).

Counterpart of ``gym_multigrid_tpu/parallel/shard.py``.  JAX runs the
rollout body per shard under ``shard_map`` and ``psum``s the metrics; here
each process (``parallel/mesh.py``) runs a batch of ``num_envs / W`` envs
with a generator seeded by ``fold_in_axis``, and sums the scalar metrics
over ranks in one all-reduce a call.  The env math never communicates:
per-env leaves such as ``run_return`` stay with their rank.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed as dist

from gym_multigrid_tpu_torch.parallel.mesh import Mesh, fold_in_axis

__all__ = ["ShardedRollout", "local_batch", "psum_scalars", "sharded_rollout",
           "sharded_episode_rollout"]


def psum_scalars(metrics: dict, mesh: Mesh) -> dict:
    """``metrics`` with every 0-d tensor summed over the mesh's ranks, in
    ONE all-reduce of a packed float64 buffer; other entries unchanged.
    float64 holds every int32 count exactly and a sum of float32 values
    of two ranks rounds back to their float32 sum (53 >= 2 * 24 + 2 bits:
    the double rounding is innocuous).  Each sum keeps its own dtype."""
    names = [k for k, v in metrics.items() if isinstance(v, torch.Tensor) and v.ndim == 0]
    buf = torch.stack([metrics[k].to(torch.float64) for k in names])
    dist.all_reduce(buf, group=mesh.group)
    return {**metrics, **{k: buf[i].to(metrics[k].dtype) for i, k in enumerate(names)}}


@dataclass(frozen=True, eq=False)
class ShardedRollout:
    """``rollout(states, num_steps, **kwargs) -> (states, metrics)`` of this
    rank's envs, its scalar metrics summed over the mesh.

    ``local`` is the rank's batch (a ``BatchedEnv`` or an episode rollout
    of ``num_envs / W`` envs); :meth:`reset` resets it from the rank's
    seed, ``fold_in_axis(seed, mesh)``."""

    local: Any
    mesh: Mesh
    run: Callable  # run(states, num_steps, **kwargs) on the rank's envs

    def reset(self, seed: int):
        """(states, obs) of the rank's envs, from ``fold_in_axis(seed)``."""
        return self.local.reset(fold_in_axis(seed, self.mesh))

    def __call__(self, states, num_steps: int, **kwargs):
        states, metrics = self.run(states, num_steps, **kwargs)
        return states, psum_scalars(metrics, self.mesh)


def _local_envs(num_envs: int, mesh: Mesh) -> int:
    if num_envs % mesh.world_size:
        raise ValueError(f"num_envs={num_envs} does not split over {mesh.world_size} ranks")
    return num_envs // mesh.world_size


def local_batch(env, mesh: Mesh):
    """This rank's share of ``env`` (a ``BatchedEnv`` of the whole batch):
    a ``BatchedEnv`` of ``num_envs / W`` envs with a generator of its own."""
    return dataclasses.replace(env, num_envs=_local_envs(env.num_envs, mesh),
                               generator=torch.Generator(device=env.device))


def sharded_rollout(env, mesh: Mesh, num_actions: int | None = None,
                    actions_shape: tuple[int, ...] | None = None) -> ShardedRollout:
    """The rollout of ``env`` (a ``BatchedEnv`` of the global batch) spread
    over the mesh: each rank runs ``env.rollout`` on a ``BatchedEnv`` of
    ``num_envs / W`` envs with a generator of its own, uniform actions over
    ``num_actions`` ids in ``actions_shape`` (by default the env's), then
    sums ``reward_sum``, ``episodes`` and ``ep_return_sum`` over ranks.
    ``run_return`` stays the rank's."""
    local = local_batch(env, mesh)
    run = functools.partial(local.rollout, num_actions=num_actions, actions_shape=actions_shape)
    return ShardedRollout(local, mesh, run)


def sharded_episode_rollout(rollout, mesh: Mesh) -> ShardedRollout:
    """One of the four episode rollouts (``ops/*_slab.py``
    ``make_*_episode_rollout``, built for the global batch) spread over the
    mesh: each rank runs a copy built at ``num_envs / W`` envs, with a
    generator of its own where the rollout draws from one (the Wildfire
    rollout keys its counters in ``reset``), and sums the scalar metrics
    over ranks; per-env leaves stay the rank's."""
    n_local = _local_envs(rollout.num_envs, mesh)
    extra = {}
    if any(f.name == "generator" for f in dataclasses.fields(rollout)):
        extra["generator"] = torch.Generator(device=rollout.slab.device)
    local = dataclasses.replace(rollout, num_envs=n_local, **extra)
    return ShardedRollout(local, mesh, local)
