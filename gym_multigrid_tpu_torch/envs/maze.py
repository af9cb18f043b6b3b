"""Maze env family: config, state, observations and info (PyTorch port).

Counterpart of ``gym_multigrid_tpu/envs/maze.py``.  One agent on a static
map of background, flag and obstacle cells; the whole dynamic state of an
env is its position, its render direction and its step count.  The state
is a dataclass of batched tensors with no PRNG key: the batch env owns a
``torch.Generator``.  The transition is ``ops/maze_slab.py``.

Semantics carried over unchanged (see the JAX module's docstring): moves
stay/left/down/right/up with the CtF vectors, bounds checked in the
natural axis order (row against S0, column against S1), obstacles block
unless the obstacle penalty is on, +flag_reward and the end of the episode
on a flag cell, -obstacle_penalty and the end on an obstacle cell when the
penalty is on, the step penalty every step, action ids clipped into 0..4,
and the spawn uniform over the background cells.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, fields
from typing import Callable, Literal

import numpy as np
import torch

from gym_multigrid_tpu_torch.core.world import MazeWorld
from gym_multigrid_tpu_torch.envs.single import batch, given, row, step_row
from gym_multigrid_tpu_torch.utils.map import load_text_map

_W = MazeWorld.OBJECT_TO_IDX
BACKGROUND = _W["background"]
M_AGENT = _W["agent"]
FLAG = _W["flag"]
M_OBSTACLE = _W["obstacle"]

NUM_ACTIONS = 5
#: Render direction of a fresh agent.
SPAWN_DIR = 3


@dataclass(frozen=True)
class MazeConfig:
    """Static Maze configuration (same fields and checks as the JAX
    package's ``MazeConfig``).  ``map_data`` is the transposed text map, as
    :func:`load_text_map` returns it."""

    map_data: tuple[tuple[int, ...], ...]
    max_steps: int = 100
    flag_reward: float = 1.0
    obstacle_penalty_ratio: float = 0.0
    step_penalty_ratio: float = 0.01
    observation_option: Literal["positional", "map"] = "map"

    def __post_init__(self):
        if self.observation_option not in ("positional", "map"):
            raise ValueError(
                f"observation_option must be 'positional' or 'map', "
                f"got {self.observation_option!r}"
            )
        if self.max_steps < 1:
            raise ValueError(f"max_steps must be >= 1, got {self.max_steps}")

    @classmethod
    def from_map_path(cls, map_path: str, **kwargs) -> "MazeConfig":
        fm = load_text_map(map_path).astype(int)
        return cls(map_data=tuple(tuple(int(v) for v in row) for row in fm), **kwargs)

    @property
    def field_map(self) -> np.ndarray:
        return np.asarray(self.map_data, dtype=np.int64)

    @property
    def num_agents(self) -> int:
        """One agent, as in every Maze env; not a field, so the fields stay
        the JAX package's."""
        return 1

    # Products in double, as in the JAX package; the step rounds each to
    # float32 once.
    @property
    def obstacle_penalty(self) -> float:
        return self.obstacle_penalty_ratio * self.flag_reward

    @property
    def step_penalty(self) -> float:
        return self.step_penalty_ratio * self.flag_reward


@dataclass
class MazeState:
    """Batched env state; the map is static.  No PRNG key: the batch env's
    generator supplies the spawn uniforms."""

    pos: torch.Tensor  # (B, 2) int32 (row, col) on the field map
    dir: torch.Tensor  # (B,) int32 render direction
    step_count: torch.Tensor  # (B,) int32


def maze_state_from_numpy(arrays, device) -> MazeState:
    """Build a state from a mapping of numpy arrays keyed by field name
    (e.g. a JAX ``MazeState`` converted by the caller).  Keys that are not
    state fields, such as a JAX PRNG ``key``, are ignored.  The arrays are
    copied."""
    return MazeState(**{
        f.name: torch.tensor(np.asarray(arrays[f.name]), device=device)
        for f in fields(MazeState)
    })


def cell_lists(cfg: MazeConfig):
    """(background, flags, obstacles): the (n, 2) int32 cells of each kind,
    row-major (``np.argwhere`` order)."""
    fm = cfg.field_map
    return tuple(
        np.argwhere(fm == kind).astype(np.int32).reshape(-1, 2)
        for kind in (BACKGROUND, FLAG, M_OBSTACLE)
    )


def _base_map(cfg: MazeConfig) -> np.ndarray:
    fm = cfg.field_map
    m = np.zeros(fm.shape, dtype=np.float32)
    for kind in (BACKGROUND, M_OBSTACLE, FLAG):
        m[fm == kind] = kind
    return m


def encode(cfg: MazeConfig, state: MazeState):
    """The configured observation of each env: ``map`` a (B, S0, S1)
    float32 map, NOT transposed, with the agent's cell set to ``M_AGENT``;
    ``positional`` a dict of (B, ·) int32 tensors (the agent's cell and the
    flat cell lists).  An agent off the board is not drawn on the map."""
    B, dev = state.pos.shape[0], state.pos.device
    if cfg.observation_option == "positional":
        background, flags, obstacles = cell_lists(cfg)

        def rows(x):
            return torch.as_tensor(x.reshape(-1), device=dev)[None, :].expand(B, -1)

        return {
            "agent": state.pos,
            "background": rows(background),
            "flag": rows(flags),
            "obstacle": rows(obstacles),
        }
    S0, S1 = cfg.field_map.shape
    m = torch.as_tensor(_base_map(cfg), device=dev).repeat(B, 1, 1)
    x, y = state.pos[:, 0].long(), state.pos[:, 1].long()
    on = (x >= 0) & (x < S0) & (y >= 0) & (y < S1)
    m[torch.arange(B, device=dev)[on], x[on], y[on]] = float(M_AGENT)
    return m


def make_maze_partial_encode(
    cfg: MazeConfig, view_size: int = 7, see_through_walls: bool = True
):
    """The agent's field of view: ``fn(states) -> (B, 1, V, V, 3)`` uint8
    (JAX's ``make_maze_partial_encode``): white background, grey obstacles,
    red flags and the blue agent with its direction; the board's edge reads
    as a grey obstacle, and nothing on the board blocks sight."""
    from gym_multigrid_tpu_torch.envs.partial_obs import (
        device_tables, draw_cells, make_partial_obs_fn)

    fm = cfg.field_map
    W, H = fm.shape
    CI = MazeWorld.COLOR_TO_IDX
    typ = np.zeros((W, H), np.int32)
    col = np.zeros((W, H), np.int32)
    col[fm == BACKGROUND] = CI["white"]
    typ[fm == M_OBSTACLE] = M_OBSTACLE
    col[fm == M_OBSTACLE] = CI["grey"]
    typ[fm == FLAG] = FLAG
    col[fm == FLAG] = CI["red"]
    base = device_tables(planes=torch.from_numpy(np.stack([typ, col, np.zeros_like(typ)])))
    obs_fn = make_partial_obs_fn(
        W, H, view_size, wall_encode=(M_OBSTACLE, CI["grey"], 0),
        see_through_walls=see_through_walls,
    )

    def encode_partial(state: MazeState) -> torch.Tensor:
        B, dev = state.pos.shape[0], state.pos.device
        planes = base(dev)["planes"].repeat(B, 1, 1, 1)
        agent = torch.full((B,), M_AGENT, device=dev)
        draw_cells(planes, torch.arange(B, device=dev), state.pos,
              (agent, torch.full_like(agent, CI["blue"]), state.dir))
        # Obstacles can be seen through: no cell on the board is opaque.
        opaque = torch.zeros((B, W, H), dtype=torch.bool, device=dev)
        return obs_fn(planes, opaque, state.pos[:, None], state.dir[:, None])

    return encode_partial


def info(cfg: MazeConfig, state: MazeState) -> dict[str, torch.Tensor]:
    """``d_a_f`` and ``d_a_ob``: the agent's Euclidean distance to the
    closest flag and obstacle cell, (B,) float32, inf when the map has no
    cell of that kind.  ``sqrt(dx*dx + dy*dy)`` in float32 is exact up to
    the square root's rounding, as JAX's float32 ``jnp.linalg.norm`` is."""
    _, flags, obstacles = cell_lists(cfg)
    B, dev = state.pos.shape[0], state.pos.device
    p = state.pos.to(torch.float32)

    def d_area(area):
        if area.shape[0] == 0:
            return torch.full((B,), float("inf"), dtype=torch.float32, device=dev)
        d = p[:, None, :] - torch.as_tensor(area.astype(np.float32), device=dev)[None]
        return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]).amin(dim=1)

    return {"d_a_f": d_area(flags), "d_a_ob": d_area(obstacles)}


@dataclass(frozen=True)
class MazeFns:
    """The functions of one Maze env (JAX's ``MazeFns``).  A state of one
    env is a :class:`MazeState` whose fields have no batch axis."""

    #: (generator, *, rnd=None) -> state
    reset_fn: Callable
    #: (state, action) -> (state', obs, reward, terminated, truncated, info)
    step_fn: Callable
    #: state -> obs (a dict of tensors for "positional")
    obs_fn: Callable
    #: state -> {"d_a_f", "d_a_ob"}, 0-d float32 tensors
    info_fn: Callable


def make_maze(cfg: MazeConfig, device=None) -> MazeFns:
    """The functions of one env of ``cfg`` on ``device`` (JAX's
    ``make_maze``): the batch functions of ``ops/maze_slab.py`` at B = 1,
    so ``step_fn`` launches the step kernel on a CUDA device and runs the
    plain version on the CPU.  The device is the current CUDA device by
    default and ``device="cpu"`` the CPU, as for ``make_maze_batch``.  The step draws nothing; ``reset_fn`` draws its
    spawn uniform from ``generator``, or takes it as ``rnd`` (1,)."""
    from gym_multigrid_tpu_torch.ops import _build, maze_slab

    device = _build.default_device(device, "make_maze")
    slab = maze_slab.make_maze_slab(cfg, device)

    def reset_fn(generator=None, *, rnd=None):
        return row(maze_slab.reset_batch(slab, 1, generator=generator, rnd=given(rnd, device)))

    def step_fn(state, action):
        action = torch.as_tensor(action, device=device).reshape(1)
        return step_row(maze_slab.step_batch(slab, batch(state), action))

    def obs_fn(state):
        return row(encode(cfg, batch(state)))

    def info_fn(state):
        return row(info(cfg, batch(state)))

    return MazeFns(reset_fn, step_fn, obs_fn, info_fn)


@functools.cache
def _cached_maze(cfg: MazeConfig, device: torch.device) -> MazeFns:
    return make_maze(cfg, device)


def cached_maze(cfg: MazeConfig, device=None) -> MazeFns:
    """Memoised :func:`make_maze`, one per (config, device)."""
    from gym_multigrid_tpu_torch.ops import _build

    return _cached_maze(cfg, _build.default_device(device, "cached_maze"))
