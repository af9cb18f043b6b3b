"""Collective inventory of a multi-process call (PyTorch port).

Counterpart of ``gym_multigrid_tpu/parallel/comm_audit.py``.  The
weak-scaling claim rests on what crosses processes: a sharded rollout
should sum a few scalars and a data-parallel train step should all-reduce
gradients no larger than the parameters, never the rollout buffer.  torch
has no compiled program to read, so the audit runs the call once under
``torch.profiler`` and reads the collectives it issued
(``utils/profiling.py`` :func:`collective_events`): ``gloo:all_reduce``,
``nccl:all_reduce``, ``gloo:broadcast``, ``nccl:all_gather`` and the rest,
with their operands.  That includes the gradient all-reduces that
``DistributedDataParallel``'s reducer issues from C++.

JAX's inventory is static, one entry for each collective of the compiled
program, which a loop runs many times.  This one is dynamic: one entry for
each collective the call issued, so a train step of 2 epochs of 8
minibatches lists each minibatch's all-reduces 16 times.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from gym_multigrid_tpu_torch.utils.profiling import collective_events, trace

__all__ = ["CollectiveOp", "collective_inventory", "audit_call"]

#: The profiler's operand dtype names -> torch dtypes.
_DTYPES = {
    "bool": torch.bool, "unsigned char": torch.uint8, "signed char": torch.int8,
    "short int": torch.int16, "int": torch.int32, "long int": torch.int64,
    "c10::Half": torch.float16, "c10::BFloat16": torch.bfloat16,
    "float": torch.float32, "double": torch.float64,
}


@dataclass
class CollectiveOp:
    kind: str  # the collective: "all_reduce", "broadcast", "all_gather", ...
    shapes: list[tuple[str, tuple[int, ...]]]  # (dtype, dims) per operand, e.g. ("float32", (8,))
    bytes: int  # total operand bytes of this rank
    op_name: str  # the profiler's event name, e.g. "nccl:all_reduce"

    @property
    def max_elems(self) -> int:
        return max((int(np.prod(d, dtype=np.int64)) for _, d in self.shapes), default=0)


def _operand(shape, dtype_name: str) -> tuple[str, tuple[int, ...], int]:
    if dtype_name not in _DTYPES:
        raise ValueError(f"collective operand of unknown dtype {dtype_name!r}")
    dtype = _DTYPES[dtype_name]
    dims = tuple(int(d) for d in shape)
    itemsize = torch.empty((), dtype=dtype).element_size()
    return str(dtype).removeprefix("torch."), dims, itemsize * int(np.prod(dims, dtype=np.int64))


def collective_inventory(prof) -> list[CollectiveOp]:
    """Every collective a profiled block issued (``record_shapes=True``),
    in issue order, with its operands."""
    ops = []
    for e in collective_events(prof):
        operands = [_operand(s, d) for s, d in zip(e.shapes, e.dtypes)]
        ops.append(CollectiveOp(
            kind=e.name.split(":", 1)[1],
            shapes=[(d, dims) for d, dims, _ in operands],
            bytes=sum(n for *_, n in operands),
            op_name=e.name,
        ))
    return ops


def audit_call(fn: Callable, *args: Any, **kwargs: Any) -> list[CollectiveOp]:
    """Run ``fn(*args, **kwargs)`` once under ``torch.profiler`` (shapes
    recorded) and return the collectives it issued."""
    with trace(record_shapes=True) as prof:
        fn(*args, **kwargs)
    return collective_inventory(prof)
