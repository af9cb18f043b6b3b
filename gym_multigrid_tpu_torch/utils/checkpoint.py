"""Checkpoints of the learner state (PyTorch port of
``gym_multigrid_tpu/utils/checkpoint.py``'s ``save_pytree``/``load_pytree``;
its orbax path is not ported).

A state is a tree of dicts, lists and tuples whose leaves are tensors,
numbers, strings, booleans or None: module and optimizer
``state_dict``s, env state tensors, generator states.  :func:`save_state`
writes the arrays to ``<stem>.npz`` and the tree, with each array's
index and dtype in its place, to ``<stem>.json``; nothing is pickled, so
loading runs no code from the file.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

# numpy has no bfloat16: such tensors travel as their int16 bits.
_BITS = {torch.bfloat16: torch.int16}


def _stem(path: str) -> str:
    return path[: -len(".npz")] if path.endswith(".npz") else path


def _encode(x, arrays: list):
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        arrays.append(t.view(_BITS[t.dtype]).numpy() if t.dtype in _BITS else t.numpy())
        return {"tensor": len(arrays) - 1, "dtype": str(t.dtype).removeprefix("torch.")}
    if isinstance(x, dict):
        for k in x:
            if not isinstance(k, (str, int)) or isinstance(k, bool):
                raise TypeError(f"checkpoint dict keys must be str or int, got {k!r}")
        return {"dict": [[k, _encode(v, arrays)] for k, v in x.items()]}
    if isinstance(x, (list, tuple)):
        return {type(x).__name__: [_encode(v, arrays) for v in x]}
    if x is None or isinstance(x, (bool, int, float, str)):
        return {"value": x}
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def _decode(node, data):
    (kind, v), *rest = node.items()
    if kind == "tensor":
        dtype = getattr(torch, rest[0][1])
        t = torch.from_numpy(np.array(data[f"arr_{v}"]))
        return t.view(dtype) if dtype in _BITS else t
    if kind == "dict":
        return {k: _decode(x, data) for k, x in v}
    if kind == "list":
        return [_decode(x, data) for x in v]
    if kind == "tuple":
        return tuple(_decode(x, data) for x in v)
    return v


def save_state(path: str, state: Any) -> None:
    """Write ``state`` to ``<stem>.npz`` and ``<stem>.json`` (``path``
    with or without ``.npz``)."""
    stem = _stem(path)
    os.makedirs(os.path.dirname(stem) or ".", exist_ok=True)
    arrays: list = []
    tree = _encode(state, arrays)
    np.savez(stem + ".npz", **{f"arr_{i}": a for i, a in enumerate(arrays)})
    with open(stem + ".json", "w") as f:
        json.dump(tree, f)


def load_state(path: str) -> Any:
    """The state saved by :func:`save_state`, its tensors on the CPU."""
    stem = _stem(path)
    with open(stem + ".json") as f:
        tree = json.load(f)
    with np.load(stem + ".npz") as data:
        return _decode(tree, data)
