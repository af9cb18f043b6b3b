"""One env as a batch of one: the per-env functions' view of the batch
functions (``make_collect``, ``make_ctf``, ``make_maze``,
``make_wildfire``).

A state of one env is the family's state dataclass with no batch axis on
its fields; the per-env functions add the axis, call the batch function
and take row 0 of what it returns.
"""

from __future__ import annotations

from dataclasses import fields

import torch


def given(x, device):
    """Draws given for one env, (n,), as a batch of one, (1, n), on
    ``device``; None stays None."""
    return None if x is None else torch.as_tensor(x, device=device).reshape(1, -1)


def batch(state):
    """``state`` of one env as a batch of one (views, no copy)."""
    return type(state)(**{f.name: getattr(state, f.name)[None] for f in fields(state)})


def row(states, i: int = 0):
    """Row ``i`` of a batch state, of a dict of batch tensors, or of a
    batch tensor; None stays None."""
    if states is None:
        return None
    if isinstance(states, dict):
        return {k: v[i] for k, v in states.items()}
    if hasattr(states, "__dataclass_fields__"):
        return type(states)(**{f.name: getattr(states, f.name)[i] for f in fields(states)})
    return states[i]


def step_row(out):
    """Row 0 of a batch step's (states', obs, reward, terminated,
    truncated, info)."""
    return tuple(row(x) for x in out)
