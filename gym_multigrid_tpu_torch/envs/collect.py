"""Collect env family: config, placement plan, slot tables, state, encode
(PyTorch port).

Counterpart of ``gym_multigrid_tpu/envs/collect.py``.  The config checks,
the static placement plan and the reward-slot tables are the same numpy
code; the state is a dataclass of batched tensors.  Randomness never lives
in the state: the batch env owns a ``torch.Generator`` and the slab
functions take their uniforms as input tensors.  :func:`make_collect`
gives the per-env functions, a state of one env having no batch axis.

Semantics carried over unchanged (see the JAX module's docstring): NESW
moves with invalid ids as no-ops, a random move order where later movers
see earlier movers' board, pickup then respawn *before* the mover enters
(so a respawn may land on the vacated ball cell and be stomped), flat
per-ball-instance rewards, termination only without respawn or fixed
horizon, truncation at ``max_steps``, and the full-grid uint8 encode.
"""

from __future__ import annotations

import functools
from collections import Counter
from dataclasses import dataclass, fields
from typing import Literal

import numpy as np
import torch

from gym_multigrid_tpu_torch.core.constants import COLOR_TO_IDX
from gym_multigrid_tpu_torch.core.world import CollectWorld
from gym_multigrid_tpu_torch.envs.single import batch, given, row, step_row

EMPTY = CollectWorld.OBJECT_TO_IDX["empty"]
WALL = CollectWorld.OBJECT_TO_IDX["wall"]
BALL = CollectWorld.OBJECT_TO_IDX["ball"]
AGENT = CollectWorld.OBJECT_TO_IDX["agent"]
WALL_COLOR = COLOR_TO_IDX["grey"]
AGENT_DIR = 3  # place_agent default direction; Collect never turns agents

Layout = Literal["even", "quadrants", "rooms", "quadrants_respawn"]


@dataclass(frozen=True)
class CollectConfig:
    """Static Collect configuration (same fields and checks as the JAX
    package's ``CollectConfig``)."""

    size: int = 10
    num_balls: int = 15
    agents_index: tuple[int, ...] = (3, 5)
    balls_index: tuple[int, ...] = (0, 1, 2)
    balls_reward: tuple[float, ...] = (1.0, 1.0, 1.0)
    respawn: bool = False
    max_steps: int = 100
    layout: Layout = "even"
    fixed_horizon: bool = False

    def __post_init__(self):
        if self.size < 4:
            raise ValueError(
                f"size must be >= 4 (walled perimeter + interior), "
                f"got {self.size}"
            )
        if len(self.agents_index) < 1:
            raise ValueError("agents_index must name at least one agent")
        if len(self.balls_index) < 1:
            raise ValueError("balls_index must name at least one ball type")
        if len(self.balls_reward) < len(self.balls_index):
            raise ValueError(
                f"balls_reward has {len(self.balls_reward)} entries for "
                f"{len(self.balls_index)} ball types"
            )
        if self.max_steps < 1:
            raise ValueError(f"max_steps must be >= 1, got {self.max_steps}")
        # Every group of balls sharing a placement rect must fit that
        # rect's non-wall cells, and everything placed must fit the board.
        wall = _wall_mask(self)
        plan = build_plan(self)
        rects = np.asarray(plan.ball_rects, dtype=bool)
        for key, cnt in Counter(r.tobytes() for r in rects).items():
            rect = np.frombuffer(key, dtype=bool)
            avail = int((rect & ~wall).sum())
            if cnt > avail:
                raise ValueError(
                    f"layout {self.layout!r} places {cnt} balls into a "
                    f"region with only {avail} free cells "
                    f"(size={self.size}, num_balls={self.num_balls})"
                )
        free = int((~wall).sum())
        if len(plan.ball_colors) + len(self.agents_index) > free:
            raise ValueError(
                f"{len(plan.ball_colors)} balls + "
                f"{len(self.agents_index)} agents cannot fit the {free} "
                f"free cells of a {self.size}x{self.size} "
                f"{self.layout!r} board"
            )

    @property
    def width(self) -> int:
        return self.size

    @property
    def height(self) -> int:
        return self.size

    @property
    def num_agents(self) -> int:
        return len(self.agents_index)

    @property
    def num_ball_types(self) -> int:
        return len(self.balls_index)

    @property
    def num_cells(self) -> int:
        return self.size * self.size


@dataclass
class CollectState:
    """Batched env state.  Grid planes are flat per env, idx = y*W + x.

    There is no PRNG key: the batch env's generator supplies uniforms."""

    grid_obj: torch.Tensor  # (B, C) int32 object ids
    grid_color: torch.Tensor  # (B, C) int32 color ids
    grid_slot: torch.Tensor  # (B, C) int32 reward-table slot of each ball
    agent_pos: torch.Tensor  # (B, A, 2) int32 (x, y)
    collected: torch.Tensor  # (B,) int32
    step_count: torch.Tensor  # (B,) int32
    info_counts: torch.Tensor  # (B, A, num_ball_types) int32


def state_from_numpy(arrays, device) -> CollectState:
    """Build a state from a mapping of numpy arrays keyed by field name
    (e.g. a JAX ``CollectState`` converted by the caller).  Keys that are
    not state fields, such as a JAX PRNG ``key``, are ignored.  The arrays
    are copied: the batch env's auto-reset writes into its state."""
    return CollectState(**{
        f.name: torch.tensor(np.asarray(arrays[f.name]), device=device)
        for f in fields(CollectState)
    })


def state_to_numpy(state: CollectState) -> dict[str, np.ndarray]:
    """The state's fields as numpy arrays, keyed by field name."""
    return {
        f.name: getattr(state, f.name).cpu().numpy() for f in fields(state)
    }


def _rect_mask(
    width: int, height: int, top: tuple[int, int], size: tuple[int, int]
) -> np.ndarray:
    """Flat bool mask of the inclusive sampling rect used by place_obj:
    x in [top0, min(top0+size0, W-1)], y in [top1, min(top1+size1, H-1)]."""
    x0, y0 = max(top[0], 0), max(top[1], 0)
    x1 = min(x0 + size[0], width - 1)
    y1 = min(y0 + size[1], height - 1)
    mask = np.zeros((height, width), dtype=bool)
    mask[y0 : y1 + 1, x0 : x1 + 1] = True
    return mask.reshape(-1)


def _wall_mask(cfg: CollectConfig) -> np.ndarray:
    """(H*W,) flat bool: perimeter walls + rooms inner walls."""
    w, h = cfg.width, cfg.height
    m = np.zeros((h, w), dtype=bool)  # [y, x]
    m[0, :] = m[h - 1, :] = True
    m[:, 0] = m[:, w - 1] = True
    if cfg.layout == "rooms":
        # Inner walls; the reference uses `width` for both axes.
        ws = w // 2 - 1
        m[w // 2, 0:ws] = True
        m[w // 2, w - ws : w] = True
        m[0:ws, w // 2] = True
        m[w - ws : w, w // 2] = True
    return m.reshape(-1)


@dataclass(frozen=True)
class _PlacementPlan:
    """Static reset program: sequential uniform-empty placements."""

    # Per ball, in placement order: color id, reward, flat rect mask.
    ball_colors: tuple[int, ...]
    ball_rewards: tuple[float, ...]
    ball_rects: np.ndarray  # (n_balls, N) bool
    balls_before_agents: bool
    # Agents: fixed positions, a coordinate pool, or (both None) uniform
    # over the empty cells.
    agent_fixed: tuple[tuple[int, int], ...] | None
    agent_choice_coords: np.ndarray | None  # (n_choices, 2) or None
    # Respawn rect per ball color id: the whole grid, or the color's
    # partition for quadrants_respawn.
    respawn_rects: np.ndarray  # (max_color+1, N) bool


def build_plan(cfg: CollectConfig) -> _PlacementPlan:
    w, h = cfg.width, cfg.height
    n = cfg.num_cells
    full = _rect_mask(w, h, (0, 0), (w, h))

    colors: list[int] = []
    rewards: list[float] = []
    rects: list[np.ndarray] = []
    agent_fixed = None
    agent_choice = None
    balls_before_agents = True

    num_types = cfg.num_ball_types
    per_type = cfg.num_balls // num_types

    if cfg.layout == "even":
        for t in range(num_types):
            for _ in range(per_type):
                colors.append(cfg.balls_index[t])
                rewards.append(cfg.balls_reward[t])
                rects.append(full)
    elif cfg.layout == "quadrants":
        partitions = [(0, 0), (w // 2 - 1, h // 2 - 1), (w // 2 - 1, 0), (0, h // 2)]
        psize = (w // 2 - 1, h // 2 - 1)
        for t in range(num_types):
            for _ in range(per_type):
                colors.append(cfg.balls_index[t])
                rewards.append(cfg.balls_reward[t])
                rects.append(_rect_mask(w, h, partitions[t], psize))
        agent_fixed = tuple((1 + i, h - 2) for i in range(cfg.num_agents))
    elif cfg.layout == "rooms":
        # Agents first, then balls, with the reference's extra ball into
        # partitions[3] at each type boundary.
        balls_before_agents = False
        partitions = [(0, 0), (w // 2 + 1, w // 2 + 1), (w // 2 + 1, 0), (0, w // 2 + 1)]
        psize = (w // 2 - 1, w // 2 - 1)
        num_ball = round(cfg.num_balls / num_types)
        top = partitions[0]
        index = 0
        for ball in range(cfg.num_balls):
            if ball % num_ball == 0:
                index = ball // num_ball
                top = partitions[index]
                colors.append(cfg.balls_index[index])
                rewards.append(cfg.balls_reward[index])
                rects.append(_rect_mask(w, h, partitions[3], psize))
            colors.append(cfg.balls_index[index])
            rewards.append(cfg.balls_reward[index])
            rects.append(_rect_mask(w, h, top, psize))
        agent_choice = np.array(
            [
                (w // 2, w // 2),
                (w // 2 - 1, w // 2 - 1),
                (w // 2 - 1, w // 2 + 1),
                (w // 2 + 1, w // 2 + 1),
                (w // 2 + 1, w // 2 - 1),
            ],
            dtype=np.int32,
        )
    elif cfg.layout == "quadrants_respawn":
        # Ball color = partition index, reward 1.
        partitions = [(0, 0), (w // 2 - 1, h // 2 - 1), (w // 2 - 1, 0)]
        psize = (w // 2 + 1, h // 2 + 1)
        npt = cfg.num_balls // len(partitions)
        top = partitions[0]
        index = 0
        for ball in range(cfg.num_balls):
            if ball % npt == 0:
                index = ball // npt
                top = partitions[index]
            colors.append(index)
            rewards.append(1.0)
            rects.append(_rect_mask(w, h, top, psize))
        agent_fixed = tuple((1 + i, h - 2) for i in range(cfg.num_agents))
    else:
        raise ValueError(f"unknown layout {cfg.layout}")

    max_color = max(list(cfg.balls_index) + colors)
    respawn_rects = np.tile(full, (max_color + 1, 1))
    if cfg.layout == "quadrants_respawn":
        partitions = [(0, 0), (w // 2 - 1, h // 2 - 1), (w // 2 - 1, 0)]
        psize = (w // 2 + 1, h // 2 + 1)
        for c, top in enumerate(partitions):
            if c <= max_color:
                respawn_rects[c] = _rect_mask(w, h, top, psize)

    return _PlacementPlan(
        ball_colors=tuple(colors),
        ball_rewards=tuple(rewards),
        ball_rects=np.stack(rects) if rects else np.zeros((0, n), dtype=bool),
        balls_before_agents=balls_before_agents,
        agent_fixed=agent_fixed,
        agent_choice_coords=agent_choice,
        respawn_rects=respawn_rects,
    )


def reward_slot_tables(cfg: CollectConfig, plan: _PlacementPlan):
    """Per-slot reward/info tables.

    Slots [0, n_balls) are the planned balls in placement order (they pay
    their placement reward); slots [n_balls, n_balls + n_colors) are
    respawned balls of color c (they pay balls_reward[color], clamped).
    Info counters are keyed by the ball's color id, clamped into the
    counter table.  Returns (slot_rewards f32, slot_info i32, n_balls).
    """
    max_color = plan.respawn_rects.shape[0] - 1
    nb_r = len(cfg.balls_reward)
    nt = cfg.num_ball_types

    def respawn_reward(c):
        return float(cfg.balls_reward[min(c, nb_r - 1)])

    slot_rewards = np.array(
        list(plan.ball_rewards)
        + [respawn_reward(c) for c in range(max_color + 1)],
        dtype=np.float32,
    )
    slot_info = np.array(
        [min(int(c), nt - 1) for c in plan.ball_colors]
        + [min(c, nt - 1) for c in range(max_color + 1)],
        dtype=np.int32,
    )
    return slot_rewards, slot_info, len(plan.ball_colors)


def encode(cfg: CollectConfig, state: CollectState) -> torch.Tensor:
    """Full-grid (B, W, H, 3) uint8 encode: obs[b, x, y] = (obj, color,
    3 on agent cells else 0)."""
    B = state.grid_obj.shape[0]
    w, h = cfg.width, cfg.height
    obj = state.grid_obj.reshape(B, h, w).transpose(1, 2)
    color = state.grid_color.reshape(B, h, w).transpose(1, 2)
    ch2 = (obj == AGENT).to(torch.int32) * AGENT_DIR
    return torch.stack([obj, color, ch2], dim=-1).to(torch.uint8)


def make_collect_partial_encode(
    cfg: CollectConfig, view_size: int = 7, see_through_walls: bool = False
):
    """Each agent's field of view: ``fn(states) -> (B, A, V, V, 3)`` uint8
    (JAX's ``make_collect_partial_encode``).  Walls are the only cells that
    block sight, and the board's edge reads as wall; agents always face
    dir 3."""
    from gym_multigrid_tpu_torch.envs.partial_obs import make_partial_obs_fn

    w, h = cfg.width, cfg.height
    obs_fn = make_partial_obs_fn(
        w, h, view_size, wall_encode=(WALL, WALL_COLOR, 0),
        see_through_walls=see_through_walls,
    )

    def encode_partial(state: CollectState) -> torch.Tensor:
        B = state.grid_obj.shape[0]
        obj = state.grid_obj.reshape(B, h, w).transpose(1, 2)  # xy-indexed (W, H)
        color = state.grid_color.reshape(B, h, w).transpose(1, 2)
        ch2 = (obj == AGENT).to(obj.dtype) * AGENT_DIR
        dirs = torch.full(state.agent_pos.shape[:2], AGENT_DIR, device=obj.device)
        return obs_fn(torch.stack([obj, color, ch2], dim=1), obj == WALL, state.agent_pos, dirs)

    return encode_partial


def make_collect(cfg: CollectConfig, device=None):
    """(reset_fn, step_fn, encode_fn) for one env on ``device``: the
    counterpart of JAX's ``make_collect``.  A state of one env is a
    :class:`CollectState` whose fields have no batch axis.

    - ``reset_fn(generator=None, *, rnd=None) -> state``
    - ``step_fn(state, actions, generator=None, *, rnd=None, perm=None)
      -> (state', obs, rewards (A,), terminated, truncated, info_counts)``
      with ``actions`` (A,) ids 0..3 (others are a no-op)
    - ``encode_fn(state) -> (W, H, 3) uint8``

    These are the batch functions of ``ops/collect_slab.py`` at B = 1, on
    the slab's route (``kernel_route``): a config the kernels take launches
    the step kernel, and the reset kernel on each reset, on a CUDA device
    and runs their plain versions on the CPU; any other config is plain
    PyTorch on either.  Randomness comes from ``generator``, or as ``rnd``:
    ``reset_fn``'s (``reset_draws``,) and ``step_fn``'s (``step_draws``,)
    uniforms of the slab.  ``perm`` (A,) gives the move order of an agent
    count other than one or two instead of drawing it.  Device as for
    ``make_collect_batch``: the current CUDA device by default,
    ``device="cpu"`` on the CPU."""
    from gym_multigrid_tpu_torch.ops import _build, collect_slab

    device = _build.default_device(device, "make_collect")
    slab = collect_slab.make_collect_slab(cfg, device)

    def reset_fn(generator=None, *, rnd=None):
        return row(collect_slab.reset_batch(slab, 1, generator=generator,
                                            rnd=given(rnd, device)))

    def step_fn(state, actions, generator=None, *, rnd=None, perm=None):
        actions = torch.as_tensor(actions, device=device).reshape(1, cfg.num_agents)
        return step_row(collect_slab.step_batch(
            slab, batch(state), actions, generator=generator, rnd=given(rnd, device),
            perm=given(perm, device),
        ))

    def encode_fn(state):
        return encode(cfg, batch(state))[0]

    return reset_fn, step_fn, encode_fn


@functools.cache
def _cached_collect(cfg: CollectConfig, device: torch.device):
    return make_collect(cfg, device)


def cached_collect(cfg: CollectConfig, device=None):
    """Memoised :func:`make_collect`, one per (config, device)."""
    from gym_multigrid_tpu_torch.ops import _build

    return _cached_collect(cfg, _build.default_device(device, "cached_collect"))
