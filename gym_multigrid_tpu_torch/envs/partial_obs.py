"""Batched partial observations: each agent's field of view (PyTorch port).

Counterpart of ``gym_multigrid_tpu/envs/partial_obs.py``: the view-extent
slice, the rotation to face up, the shadow-cast visibility and the masked
3-dim encode of the reference's ``gen_obs`` pipeline, as batched tensor
ops over any number of (env, agent) rows.

* Cells outside the board read as the family's wall encode and block
  sight.  JAX pads the planes by V on every side and slices; here the
  view's cells are gathered from the unpadded planes and the cells off the
  board are filled, which reads the same values without the padded copy.
  The view's start is clamped as ``lax.dynamic_slice`` clamps it.
* ``dir + 1`` left rotations, ``rotate_left(m) = m[::-1, :].T``, are one
  index map per direction, built in numpy and composed with the slice, so
  the view is gathered already rotated.
* The shadow cast is JAX's ``_process_vis``, column by column from V - 1
  down: per column an east and a west pass, each the nearest blocker and
  "any lit cell between it and me", then the spill into column j - 1.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["device_tables", "draw_cells", "make_partial_obs_fn", "rotation_maps"]


def device_tables(**tables: torch.Tensor):
    """``get(device) -> {name: tensor on device}``, each table copied to a
    device once: a copy to the card made every call would wait for it."""
    cache = {}

    def get(device):
        if device not in cache:
            cache[device] = {k: v.to(device) for k, v in tables.items()}
        return cache[device]

    return get


def draw_cells(planes, rows, pos, values):
    """Write ``values`` (type, color, state), each (B,), into the (B, 3, W,
    H) ``planes`` at each row's cell ``pos`` (B, 2).  A cell off the board
    is not drawn, as JAX drops an out-of-range update; the write is a
    select on a clamped cell, so nothing waits for the device."""
    W, H = planes.shape[2:]
    x, y = pos[:, 0].long(), pos[:, 1].long()
    on = (x >= 0) & (x < W) & (y >= 0) & (y < H)
    x, y = x.clamp(0, W - 1), y.clamp(0, H - 1)
    for c, v in enumerate(values):
        planes[rows, c, x, y] = torch.where(on, v.to(planes.dtype), planes[rows, c, x, y])


def rotation_maps(view_size: int) -> np.ndarray:
    """(4, 2, V, V) int64: for ``dir`` d, the view cell (i, j) that lands
    at (a, b) after d + 1 left rotations, ``out[a, b] = view[i, j]``.

    One rotation is ``out[a, b] = m[V - 1 - b, a]``; the maps compose it
    with itself starting from the identity."""
    V = view_size
    a, b = np.meshgrid(np.arange(V), np.arange(V), indexing="ij")
    si, sj = a, b
    maps = []
    for _ in range(4):
        si, sj = si[V - 1 - b, a], sj[V - 1 - b, a]
        maps.append(np.stack([si, sj]))
    return np.stack(maps).astype(np.int64)


def _sweep(row: torch.Tensor, see: torch.Tensor, before: torch.Tensor) -> torch.Tensor:
    """One pass of the cast along the last axis of (N, V) masks: a cell i
    is lit if it was, or if a lit cell k lies after the nearest opaque
    cell strictly before i, b[i] < k < i.

    JAX takes b as the running max of the opaque cells' indices and tests
    the window with prefix sums; the same two definitions are written here
    as reductions over a (k, i) axis pair (``before[k, i]`` is k < i):
    scans along a row of V cells are slow on the card (PyTorch's innermost
    scans), and the results are the same integers."""
    V = row.shape[1]
    k = torch.arange(V, device=row.device)[:, None]
    blocker = torch.where(~see[:, :, None] & before, k, -1).amax(dim=1)  # -1 if none
    window = before & (k > blocker[:, None, :])
    return row | (row[:, :, None] & window).any(dim=1)


def process_vis(see: torch.Tensor, ax: int, ay: int) -> torch.Tensor:
    """Shadow-cast visibility of (N, V, V) xy-indexed see-through masks
    from the agent cell (ax, ay): JAX's ``_process_vis`` on a batch."""
    V = see.shape[1]
    idx = torch.arange(V, device=see.device)
    before = idx[:, None] < idx[None, :]
    mask = torch.zeros_like(see)
    mask[:, ax, ay] = True
    for j in reversed(range(V)):
        s = see[:, :, j]
        lit1 = _sweep(mask[:, :, j], s, before)
        lit2 = _sweep(lit1.flip(1), s.flip(1), before).flip(1)
        mask[:, :, j] = lit2
        if j > 0:
            p1 = lit1 & s
            p1[:, V - 1] = False  # the east pass visits i <= V - 2
            p2 = lit2 & s
            p2[:, 0] = False  # the west pass visits i >= 1
            below = mask[:, :, j - 1] | p1 | p2
            below[:, 1:] |= p1[:, :-1]
            below[:, :-1] |= p2[:, 1:]
            mask[:, :, j - 1] = below
    return mask


def make_partial_obs_fn(
    width: int,
    height: int,
    view_size: int,
    wall_encode: tuple[int, int, int],
    wall_type_idx: int | None = None,
    see_through_walls: bool = False,
):
    """Build ``obs_fn(planes, opaque, pos, dir) -> (..., V, V, 3) uint8``.

    planes: (N, 3, W, H) xy-indexed (type, color, state); opaque: (N, W, H)
    bool, the cells that block sight; pos: (N, 2) int (x, y) and dir: (N,)
    int in 0..3, one view per row; or pos (N, A, 2) and dir (N, A), A views
    of each row's board, then the result is (N, A, V, V, 3).  Cells off the
    board read as ``wall_encode`` and block sight.  ``wall_type_idx`` is
    taken for JAX's signature; like JAX's, the pipeline does not read it."""
    V = view_size
    hs = V // 2
    if V % 2 != 1:
        raise ValueError(f"view size must be odd, got {V}")
    del wall_type_idx
    W, H = width, height
    tables = device_tables(
        rot=torch.from_numpy(rotation_maps(V)),
        # View top-left per dir, as (dx, dy) offsets from the agent
        # (reference agent.py:293-322): right, down, left, up.
        tops=torch.tensor([[0, -hs], [-hs, 0], [-V + 1, -hs], [-hs, -V + 1]]),
        wall=torch.tensor(wall_encode),
    )

    def obs_fn(planes, opaque, pos, dir):
        dev = planes.device
        N = planes.shape[0]
        rot, tops, wall = tables(dev).values()
        per_row = pos.ndim == 2
        if per_row:
            pos, dir = pos[:, None], dir[:, None]
        A = pos.shape[1]
        d = dir.long().clamp(0, 3)  # lax.switch clamps its index
        top = pos.long() + tops[d]  # (N, A, 2)
        # lax.dynamic_slice keeps the slice inside the V-padded planes.
        top = torch.stack([top[..., 0].clamp(-V, W), top[..., 1].clamp(-V, H)], dim=-1)
        r = rot[d]  # (N, A, 2, V, V)
        x = top[..., 0, None, None] + r[:, :, 0]  # (N, A, V, V)
        y = top[..., 1, None, None] + r[:, :, 1]
        on = (x >= 0) & (x < W) & (y >= 0) & (y < H)
        flat = (x.clamp(0, W - 1) * H + y.clamp(0, H - 1)).reshape(N, -1)
        cells = planes.reshape(N, 3, W * H).gather(2, flat[:, None].expand(N, 3, -1))
        cells = cells.reshape(N, 3, A, V, V).permute(0, 2, 3, 4, 1)
        out = torch.where(on[..., None], cells, wall.to(planes.dtype))
        if see_through_walls:
            vis = torch.ones_like(on)
        else:
            opq = opaque.reshape(N, W * H).gather(1, flat).reshape(N, A, V, V) | ~on
            vis = process_vis(~opq.reshape(N * A, V, V), hs, V - 1).reshape(N, A, V, V)
        out = torch.where(vis[..., None], out, 0).to(torch.uint8)
        return out[:, 0] if per_row else out

    return obs_fn
