"""Process group, mesh and batch sharding of multi-process runs (PyTorch port).

Counterpart of ``gym_multigrid_tpu/parallel/mesh.py``.  The env batch is
the data-parallel axis: each of the ``world_size`` processes (ranks) owns
``num_envs / world_size`` envs on its own device, and the collectives that
cross processes (the scalar metric sums of ``parallel/shard.py``, the
gradient all-reduces of ``rl/ppo.py`` under ``DistributedDataParallel``)
go through ``torch.distributed``: NCCL between CUDA devices, gloo on the
CPU.

Not ported on purpose (``README.md`` lists them):

- ``batch_sharding``, ``batch_tree_shardings`` and ``replicated`` describe
  a GSPMD sharding of one global array; a process here holds its own rows
  as ordinary tensors (:func:`shard_batch_tree`), so there is nothing to
  describe.
- ``param_tp_shardings`` and ``opt_tp_shardings`` are tensor parallelism
  of the MLP over a ``model`` axis: one H100 holds the ``(256, 256)`` MLP
  whole, so :func:`make_mesh` has no model axis and refuses one.
"""

from __future__ import annotations

import os
import weakref
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from gym_multigrid_tpu_torch.ops import _build
from gym_multigrid_tpu_torch.utils.misc import tree_map

__all__ = ["Mesh", "distributed_initialize", "make_mesh", "shard_batch_tree", "fold_in_axis"]


@dataclass(frozen=True)
class Mesh:
    """This process's place in a data-parallel run: the process group, its
    size, this rank and this rank's device."""

    group: Any  # a torch.distributed.ProcessGroup; None stands for the default one
    world_size: int
    rank: int
    device: torch.device


#: A weak reference to the group :func:`distributed_initialize` made, and
#: the device it chose for this rank.  Weak, so that
#: ``destroy_process_group`` frees the group there and then: a gloo group
#: still held when the interpreter exits is torn down during its
#: finalization, where it aborted a rank now and then ("terminate called
#: without an active exception").
_joined: tuple[weakref.ref, torch.device] | None = None


def distributed_initialize(backend: str | None = None, init_method: str | None = None,
                           rank: int | None = None, world_size: int | None = None,
                           device=None) -> None:
    """Join the run's process group: ``torch.distributed.init_process_group``.

    Does nothing when a group already exists, as JAX's
    ``distributed_initialize`` does.  ``device`` is this rank's device,
    which :func:`make_mesh` reads back: by default a CUDA card (without
    one this raises), ``"cpu"`` only where asked for.  A CUDA device
    without an index is the card ``LOCAL_RANK`` (else the rank) modulo the
    host's card count, made current.  The backend defaults to NCCL for a
    CUDA device and gloo for the CPU; gloo on a CUDA device keeps the
    device (so two gloo ranks can share one card).  A backend that fails
    raises: nothing falls back to gloo.  ``init_method``, ``rank`` and
    ``world_size`` default to torch's ``env://`` rendezvous
    (``MASTER_ADDR``, ``RANK``, ``WORLD_SIZE``), as ``torchrun`` sets
    them; the launchers of ``scripts/`` pass a ``file://`` store instead."""
    global _joined
    if dist.is_initialized():
        return
    device = _build.default_device(device, "distributed_initialize")
    if device.type == "cuda":
        if device.index is None:
            local = os.environ.get("LOCAL_RANK", rank if rank is not None
                                   else os.environ.get("RANK", 0))
            device = torch.device("cuda", int(local) % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=init_method,
        rank=-1 if rank is None else rank, world_size=-1 if world_size is None else world_size,
    )
    _joined = (weakref.ref(dist.group.WORLD), device)


def make_mesh(n_devices: int | None = None, model_parallel: int = 1) -> Mesh:
    """The data-parallel mesh of the initialised process group.

    ``n_devices``, where given, must be the group's size: a process group
    cannot be cut down here.  ``model_parallel`` must be 1 (no tensor
    parallelism; see the module docstring).  The rank's device is the one
    :func:`distributed_initialize` chose; for a group made by other means,
    the current CUDA device (without one this raises)."""
    if model_parallel != 1:
        raise ValueError(
            f"model_parallel={model_parallel}: the port has no tensor parallelism "
            "(one card holds the policy MLP whole)"
        )
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call distributed_initialize first")
    world_size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world_size:
        raise ValueError(f"n_devices={n_devices}, but the process group has {world_size} ranks")
    if _joined is not None and _joined[0]() is dist.group.WORLD:
        device = _joined[1]
    else:
        device = _build.default_device(None, "make_mesh")
    # The default group as None: a mesh holds no reference that would keep
    # the group alive past destroy_process_group.
    return Mesh(group=None, world_size=world_size, rank=rank, device=device)


def shard_batch_tree(tree: Any, mesh: Mesh) -> Any:
    """This rank's rows of every tensor leaf of ``tree``: rows
    ``[r * n / W, (r + 1) * n / W)`` of a leading axis of ``n`` rows, as
    new tensors on the mesh's device.  Raises unless ``W`` divides ``n``."""
    W, r = mesh.world_size, mesh.rank

    def rows(x):
        n = x.shape[0]
        if n % W:
            raise ValueError(f"a leading axis of {n} rows does not split over {W} ranks")
        k = n // W
        return x[r * k:(r + 1) * k].to(mesh.device, copy=True)

    return tree_map(rows, tree)


def fold_in_axis(seed: int, mesh: Mesh) -> int:
    """The rank's own seed from (``seed``, rank), as ``rl/ppo.py``'s
    ``init_fn`` derives its seeds: ``SeedSequence([seed, rank])``.  The
    same pair gives the same seed; ranks get independent streams."""
    return int(np.random.SeedSequence([seed, mesh.rank]).generate_state(1)[0])
