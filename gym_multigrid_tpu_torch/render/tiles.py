"""Sprite-bank renderer (PyTorch port).

Counterpart of ``gym_multigrid_tpu/render/tiles.py``.  Each distinct tile
is rasterised once into a sprite bank with vectorised numpy predicates
(3x supersampling, mean downsample, grid lines), and a frame is a gather
of the bank by tile id.  The banks are rasterised in float64 numpy exactly
as the JAX package does, so the uint8 banks are byte-equal to its; each is
then cached as a uint8 tensor per ``(tile_size, device)``.

``render_<family>_batch(cfg, states, tile_size)`` computes (B, H, W) tile
ids with torch ops on the states' device and gathers the bank there:
(B, H*T, W*T, 3) uint8 on that device, written by one gather.
``render_<family>(cfg, state)`` renders one env, a state with no batch
axis or a batch of one, to an (H*T, W*T, 3) numpy frame.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from gym_multigrid_tpu_torch.core.constants import (
    COLORS,
    CTF_COLORS,
    MAZE_COLORS,
    TILE_PIXELS,
)

# ---------------------------------------------------------------------------
# Vectorised shape predicates, evaluated over the whole pixel grid at once.
# ---------------------------------------------------------------------------


def _pixel_coords(size: int) -> tuple[np.ndarray, np.ndarray]:
    ys, xs = np.mgrid[0:size, 0:size]
    return (xs + 0.5) / size, (ys + 0.5) / size  # (xf, yf)


def mask_rect(xf, yf, xmin, xmax, ymin, ymax):
    return (xf >= xmin) & (xf <= xmax) & (yf >= ymin) & (yf <= ymax)


def mask_circle(xf, yf, cx, cy, r):
    return (xf - cx) ** 2 + (yf - cy) ** 2 <= r * r


def mask_line(xf, yf, x0, y0, x1, y1, r):
    d = np.array([x1 - x0, y1 - y0], dtype=float)
    dist = float(np.linalg.norm(d))
    d = d / dist
    a = np.clip((xf - x0) * d[0] + (yf - y0) * d[1], 0, dist)
    px = x0 + a * d[0]
    py = y0 + a * d[1]
    return (xf - px) ** 2 + (yf - py) ** 2 <= r * r


def mask_triangle(xf, yf, a, b, c):
    a, b, c = np.array(a), np.array(b), np.array(c)
    v0, v1 = c - a, b - a
    v2x, v2y = xf - a[0], yf - a[1]
    dot00 = v0 @ v0
    dot01 = v0 @ v1
    dot11 = v1 @ v1
    dot02 = v0[0] * v2x + v0[1] * v2y
    dot12 = v1[0] * v2x + v1[1] * v2y
    inv = 1.0 / (dot00 * dot11 - dot01 * dot01)
    u = (dot11 * dot02 - dot01 * dot12) * inv
    v = (dot00 * dot12 - dot01 * dot02) * inv
    return (u >= 0) & (v >= 0) & ((u + v) < 1)


def rotate_coords(xf, yf, cx, cy, theta):
    """Inverse-rotate pixel coords so a predicate draws rotated by theta."""
    x = xf - cx
    y = yf - cy
    x2 = cx + x * math.cos(-theta) - y * math.sin(-theta)
    y2 = cy + y * math.cos(-theta) + x * math.sin(-theta)
    return x2, y2


# ---------------------------------------------------------------------------
# Tile rasterisation
# ---------------------------------------------------------------------------

GRID_LINE = np.array([100, 100, 100], dtype=np.float64)


def _downsample(img: np.ndarray, factor: int) -> np.ndarray:
    h, w, _ = img.shape
    img = img.reshape(h // factor, factor, w // factor, factor, 3)
    return img.mean(axis=(1, 3))


def render_tile(paint_ops, tile_size: int = TILE_PIXELS, subdivs: int = 3) -> np.ndarray:
    """Rasterise one tile.

    paint_ops: list of (mask_fn(xf, yf) -> bool mask, color, bg_color|None)
    applied in order (in-shape -> color, else bg_color if given); grid
    lines drawn last, then the ``subdivs``-fold downsample.
    """
    s = tile_size * subdivs
    xf, yf = _pixel_coords(s)
    img = np.zeros((s, s, 3), dtype=np.float64)
    for mask_fn, color, bg_color in paint_ops:
        m = mask_fn(xf, yf)
        img[m] = color
        if bg_color is not None:
            img[~m] = bg_color
    img[mask_rect(xf, yf, 0, 0.031, 0, 1)] = GRID_LINE
    img[mask_rect(xf, yf, 0, 1, 0, 0.031)] = GRID_LINE
    return _downsample(img, subdivs).astype(np.uint8)


def tile_empty(tile_size=TILE_PIXELS):
    return render_tile([], tile_size)


def tile_filled(color, tile_size=TILE_PIXELS):
    """Wall, floor, obstacle: a full-rect fill."""
    return render_tile([(lambda xf, yf: mask_rect(xf, yf, 0, 1, 0, 1), color, None)], tile_size)


def tile_ball(color, bg_color=None, tile_size=TILE_PIXELS):
    """Ball, flag: a circle of radius 0.31."""
    return render_tile(
        [(lambda xf, yf: mask_circle(xf, yf, 0.5, 0.5, 0.31), color, bg_color)],
        tile_size,
    )


def tile_agent(color, dir: int, bg_color=None, tile_size=TILE_PIXELS):
    """Agent: a triangle rotated by ``dir`` quarter turns."""

    def fn(xf, yf):
        x2, y2 = rotate_coords(xf, yf, 0.5, 0.5, 0.5 * math.pi * dir)
        return mask_triangle(x2, y2, (0.12, 0.19), (0.87, 0.50), (0.12, 0.81))

    return render_tile([(fn, color, bg_color)], tile_size)


def assemble(bank, tile_ids):
    """Frame assembly: (H, W) tile ids + (K, T, T, 3) bank -> (H*T, W*T, 3).

    A gather and a reshape, for numpy arrays or torch tensors alike."""
    h, w = tile_ids.shape
    t = bank.shape[1]
    tiles = bank[tile_ids]  # (H, W, T, T, 3)
    order = (0, 2, 1, 3, 4)
    tiles = tiles.permute(order) if isinstance(tiles, torch.Tensor) else tiles.transpose(order)
    return tiles.reshape(h * t, w * t, 3)


# ---------------------------------------------------------------------------
# Sprite banks
# ---------------------------------------------------------------------------

#: Collect colors: ball sprites are ids 2 + color, agents 2 + NCOL + color.
NCOL = len(COLORS)


@functools.cache
def _collect_bank(tile_size: int = TILE_PIXELS) -> np.ndarray:
    colors = list(COLORS.values())
    bank = [tile_empty(tile_size), tile_filled(COLORS["grey"], tile_size)]
    for c in range(NCOL):
        bank.append(tile_ball(colors[c], None, tile_size))
    for c in range(NCOL):  # agents face up (dir 3): Collect never turns them
        bank.append(tile_agent(colors[c], 3, None, tile_size))
    return np.stack(bank)


# CtF bank: 0 empty, 1 blue territory, 2 red territory, 3 obstacle,
# 4 blue flag, 5 red flag, then 6 + (color * 3 + bg) * 4 + dir for agents,
# color in {0: blue, 1: red, 2: blue_grey, 3: red_grey} (grey once
# terminated) and bg in {0: light_blue, 1: light_red, 2: none}.
_CTF_AGENT_BASE = 6
_CTF_AGENT_COLORS = ("blue", "red", "blue_grey", "red_grey")
_CTF_BGS = ("light_blue", "light_red", None)


@functools.cache
def _ctf_bank(tile_size: int = TILE_PIXELS) -> np.ndarray:
    c = CTF_COLORS
    bank = [
        tile_empty(tile_size),
        tile_filled(c["light_blue"], tile_size),
        tile_filled(c["light_red"], tile_size),
        tile_filled(c["grey"], tile_size),
        tile_ball(c["blue"], c["light_blue"], tile_size),
        tile_ball(c["red"], c["light_red"], tile_size),
    ]
    for color in _CTF_AGENT_COLORS:
        for bg in _CTF_BGS:
            for d in range(4):
                bank.append(tile_agent(c[color], d, c[bg] if bg else None, tile_size))
    return np.stack(bank)


# Maze bank: 0 empty, 1 white background, 2 grey obstacle, 3 red flag on
# white, 4..7 the blue agent on white by dir.
@functools.cache
def _maze_bank(tile_size: int = TILE_PIXELS) -> np.ndarray:
    c = MAZE_COLORS
    bank = [
        tile_empty(tile_size),
        tile_filled(c["white"], tile_size),
        tile_filled(c["grey"], tile_size),
        tile_ball(c["red"], c["white"], tile_size),
    ]
    for d in range(4):
        bank.append(tile_agent(c["blue"], d, c["white"], tile_size))
    return np.stack(bank)


# Wildfire bank: 0 empty, 1 green tree, 2 red fire, 3 grey burnt, 4 + color
# for agents.
@functools.cache
def _wildfire_bank(tile_size: int = TILE_PIXELS) -> np.ndarray:
    bank = [
        tile_empty(tile_size),
        tile_ball(COLORS["green"], None, tile_size),
        tile_filled(COLORS["red"], tile_size),
        tile_filled(COLORS["grey"], tile_size),
    ]
    for c in COLORS.values():
        bank.append(tile_agent(c, 3, None, tile_size))
    return np.stack(bank)


@functools.cache
def _device_bank(make_bank, tile_size: int, device: torch.device) -> torch.Tensor:
    """``make_bank(tile_size)`` as a uint8 (K * T, T * 3) tensor on
    ``device``: row k * T + r is pixel row r of tile k."""
    bank = make_bank(tile_size)
    return torch.from_numpy(bank.reshape(-1, tile_size * 3)).to(device)


#: Word types a bank row is gathered in, widest first.
_WORDS = (torch.int64, torch.int32, torch.int16, torch.uint8)


def _assemble_batch(make_bank, ids: torch.Tensor, tile_size: int) -> torch.Tensor:
    """(B, H, W) tile ids -> (B, H*T, W*T, 3) uint8 on the ids' device.

    One gather writes the frame in its final layout: element
    (b, y, r, x) is pixel row r of tile ids[b, y, x], T * 3 bytes, and
    (B, H, T, W, T*3) is (B, H*T, W*T, 3) as a view.  The row index r is
    broadcast, not materialised, and the rows move as the widest words
    that divide them (8 bytes at T = 32)."""
    n, h, w = ids.shape
    t = tile_size
    bank = _device_bank(make_bank, t, ids.device)
    word = next(d for d in _WORDS if (t * 3) % d.itemsize == 0)
    tiles = bank.view(word).view(-1, t, t * 3 // word.itemsize)  # (K, T, words)
    r = torch.arange(t, device=ids.device)
    # Contiguous ids: the gather's output takes the layout of its indices.
    frames = tiles[ids.contiguous()[:, :, None, :], r[None, None, :, None]]  # (B, H, T, W, words)
    return frames.view(torch.uint8).view(n, h * t, w * t, 3)


# ---------------------------------------------------------------------------
# Batch renderers
# ---------------------------------------------------------------------------


def _put_agents(ids: torch.Tensor, i: torch.Tensor, j: torch.Tensor, tiles: torch.Tensor) -> None:
    """ids[b, i[b, a], j[b, a]] = tiles[b, a] in place, agent by agent in
    order, so the last agent on a cell wins.  Negative coordinates wrap as
    in numpy.  Each write covers one cell a row, so no two indices of one
    write meet (a scatter with duplicate indices has no defined winner on
    CUDA)."""
    n, h, w = ids.shape
    flat = torch.arange(n, device=ids.device)[:, None] * (h * w) + (i % h) * w + (j % w)
    flat, tiles = flat.t().contiguous(), tiles.t().to(ids.dtype).contiguous()  # (A, B)
    for a in range(flat.shape[0]):
        ids.view(-1).index_copy_(0, flat[a], tiles[a])


def collect_tile_ids(cfg, states) -> torch.Tensor:
    """(B, H, W) tile ids of Collect planes (B, C) (rows = y, cols = x)."""
    from gym_multigrid_tpu_torch.envs.collect import AGENT, BALL, WALL

    obj = torch.as_tensor(states.grid_obj).reshape(-1, cfg.height, cfg.width)
    color = torch.as_tensor(states.grid_color).reshape(-1, cfg.height, cfg.width)
    ids = torch.zeros_like(obj)
    ids = torch.where(obj == WALL, 1, ids)
    ids = torch.where(obj == BALL, 2 + color, ids)
    return torch.where(obj == AGENT, 2 + NCOL + color, ids)


@functools.cache
def _ctf_static(cfg, device: torch.device):
    """(base tile ids, blue_mask, red_mask, each agent's team: 0 blue,
    1 red) of the config on ``device``."""
    from gym_multigrid_tpu_torch.envs.ctf import (
        BLUE_FLAG,
        BLUE_TERRITORY,
        OBSTACLE,
        RED_FLAG,
        RED_TERRITORY,
        build_tables,
    )

    t = build_tables(cfg)
    fm = t.fm
    base = np.zeros(fm.shape, dtype=np.int32)
    base[fm == BLUE_TERRITORY] = 1
    base[fm == RED_TERRITORY] = 2
    base[fm == OBSTACLE] = 3
    base[fm == BLUE_FLAG] = 4
    base[fm == RED_FLAG] = 5
    team = (np.arange(cfg.num_agents) >= cfg.num_blue_agents).astype(np.int32)
    return tuple(torch.from_numpy(x).to(device) for x in (base, t.blue_mask, t.red_mask, team))


def ctf_tile_ids(cfg, states) -> torch.Tensor:
    """(B, H, W) tile ids of CtF states: the map's tiles, then each
    agent's triangle in agent order (blue first; the last agent on a cell
    wins) with its territory's background, grey once terminated.  Rows
    are the map's second coordinate, columns its first."""
    pos = torch.as_tensor(states.pos)
    pos = pos.reshape(-1, pos.shape[-2], 2)
    dirs = torch.as_tensor(states.dir).reshape(pos.shape[:2])
    term = torch.as_tensor(states.terminated).reshape(pos.shape[:2])
    base, blue_mask, red_mask, team = _ctf_static(cfg, pos.device)
    s0, s1 = base.shape
    i, j = pos[..., 0] % s0, pos[..., 1] % s1  # (B, A)
    color = team + 2 * term.to(torch.int32)
    bg = torch.where(blue_mask[i, j], 0, torch.where(red_mask[i, j], 1, 2))
    ids = base.expand(pos.shape[0], s0, s1).clone()
    _put_agents(ids, i, j, _CTF_AGENT_BASE + (color * 3 + bg) * 4 + dirs % 4)
    return ids.transpose(1, 2)


@functools.cache
def _maze_base(cfg, device: torch.device) -> torch.Tensor:
    from gym_multigrid_tpu_torch.envs.maze import BACKGROUND, FLAG, M_OBSTACLE

    fm = cfg.field_map
    base = np.zeros(fm.shape, dtype=np.int32)
    base[fm == BACKGROUND] = 1
    base[fm == M_OBSTACLE] = 2
    base[fm == FLAG] = 3
    return torch.from_numpy(base).to(device)


def maze_tile_ids(cfg, states) -> torch.Tensor:
    """(B, H, W) tile ids of Maze states: white background, grey
    obstacles, red flags, the blue agent by dir.  Rows are the map's second
    coordinate, columns its first."""
    pos = torch.as_tensor(states.pos).reshape(-1, 2)
    dirs = torch.as_tensor(states.dir).reshape(-1)
    base = _maze_base(cfg, pos.device)
    ids = base.expand(pos.shape[0], *base.shape).clone()
    _put_agents(ids, pos[:, :1], pos[:, 1:], (4 + dirs % 4)[:, None])
    return ids.transpose(1, 2)


def wildfire_tile_ids(cfg, states) -> torch.Tensor:
    """(B, H, W) tile ids of Wildfire boards: tree circles, fire and burnt
    fills, then each agent's triangle in agent order (the last agent on a
    cell wins)."""
    from gym_multigrid_tpu_torch.envs.wildfire import BURNT, FIRE, TREE

    cells = torch.as_tensor(states.cells)
    cells = cells.reshape(-1, *cells.shape[-2:])  # [b, y, x]
    ids = torch.zeros_like(cells)
    ids = torch.where(cells == TREE, 1, ids)
    ids = torch.where(cells == FIRE, 2, ids)
    ids = torch.where(cells == BURNT, 3, ids)
    pos = torch.as_tensor(states.agent_pos).reshape(cells.shape[0], -1, 2)  # (x, y)
    tiles = _wildfire_agent_tiles(cfg, pos.device).expand(pos.shape[:2])
    _put_agents(ids, pos[..., 1], pos[..., 0], tiles)
    return ids


@functools.cache
def _wildfire_agent_tiles(cfg, device: torch.device) -> torch.Tensor:
    """(A,) each agent's tile id, 4 + its color, on ``device``."""
    return torch.tensor([4 + int(ci) for ci in cfg.agents_index], dtype=torch.int32, device=device)


def render_collect_batch(cfg, states, tile_size: int = TILE_PIXELS) -> torch.Tensor:
    """(B, ...) Collect states -> (B, H*T, W*T, 3) uint8 on their device."""
    return _assemble_batch(_collect_bank, collect_tile_ids(cfg, states), tile_size)


def render_ctf_batch(cfg, states, tile_size: int = TILE_PIXELS) -> torch.Tensor:
    """(B, ...) CtF states -> (B, H*T, W*T, 3) uint8 on their device."""
    return _assemble_batch(_ctf_bank, ctf_tile_ids(cfg, states), tile_size)


def render_maze_batch(cfg, states, tile_size: int = TILE_PIXELS) -> torch.Tensor:
    """(B, ...) Maze states -> (B, H*T, W*T, 3) uint8 on their device."""
    return _assemble_batch(_maze_bank, maze_tile_ids(cfg, states), tile_size)


def render_wildfire_batch(cfg, states, tile_size: int = TILE_PIXELS) -> torch.Tensor:
    """(B, ...) Wildfire states -> (B, H*T, W*T, 3) uint8 on their device."""
    return _assemble_batch(_wildfire_bank, wildfire_tile_ids(cfg, states), tile_size)


# ---------------------------------------------------------------------------
# One env
# ---------------------------------------------------------------------------


def _frame(batch_frames: torch.Tensor) -> np.ndarray:
    return batch_frames[0].cpu().numpy()


def render_collect(cfg, state, tile_size: int = TILE_PIXELS) -> np.ndarray:
    """One Collect env -> (H*T, W*T, 3) uint8 numpy frame."""
    return _frame(render_collect_batch(cfg, state, tile_size))


def render_ctf(cfg, state, tile_size: int = TILE_PIXELS) -> np.ndarray:
    """One CtF env -> (H*T, W*T, 3) uint8 numpy frame."""
    return _frame(render_ctf_batch(cfg, state, tile_size))


def render_maze(cfg, state, tile_size: int = TILE_PIXELS) -> np.ndarray:
    """One Maze env -> (H*T, W*T, 3) uint8 numpy frame."""
    return _frame(render_maze_batch(cfg, state, tile_size))


def render_wildfire(cfg, state, tile_size: int = TILE_PIXELS) -> np.ndarray:
    """One Wildfire env -> (H*T, W*T, 3) uint8 numpy frame."""
    return _frame(render_wildfire_batch(cfg, state, tile_size))
