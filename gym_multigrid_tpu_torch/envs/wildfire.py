"""Wildfire env family: config, static tables, state and observation
(PyTorch port).

Counterpart of ``gym_multigrid_tpu/envs/wildfire.py``.  Firefighter
agents move over a board of empty, tree, fire and burnt cells.  The config
checks and the static tables are the same numpy code; the state is a
dataclass of batched tensors with no PRNG key: the batch env owns a
``torch.Generator``.  The transition is ``ops/wildfire_slab.py``.

Semantics carried over unchanged (see the JAX module's docstring): per
step the agents move in a uniformly random order (each blocked by any
agent on its target, earlier movers at their new cells; moves are clipped
to the board), fires under agents are put out (+ext_reward per cell),
trees with n burning 4-neighbours ignite with probability
1 - (1 - p_spread)^n (-burn_penalty each), fires burn out with
probability p_burnout on the same uniform, and -step_penalty; an episode
ends when no fire is left.  Action ids are clipped into 0..4.
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass, fields
from typing import Callable, NamedTuple

import numpy as np
import torch

from gym_multigrid_tpu_torch.core.constants import COLOR_TO_IDX, CTF_ACTION_TO_VEC
from gym_multigrid_tpu_torch.core.world import WildfireWorld
from gym_multigrid_tpu_torch.envs.single import batch, given, row, step_row

_W = WildfireWorld.OBJECT_TO_IDX
EMPTY = _W["empty"]
TREE = _W["tree"]
FIRE = _W["fire"]
BURNT = _W["burnt"]
W_AGENT = _W["agent"]

TREE_COLOR = COLOR_TO_IDX["green"]
FIRE_COLOR = COLOR_TO_IDX["red"]
BURNT_COLOR = COLOR_TO_IDX["grey"]

NUM_ACTIONS = 5
#: Agents the move-order table takes, as the JAX ``wf_tables`` asserts.
MAX_AGENTS = 4


@dataclass(frozen=True)
class WildfireConfig:
    """Static Wildfire configuration (same fields and checks as the JAX
    package's ``WildfireConfig``)."""

    size: int = 16
    num_agents: int = 2
    agents_index: tuple[int, ...] = (4, 5)  # blue, purple
    tree_density: float = 0.6
    num_initial_fires: int = 2
    p_spread: float = 0.3
    p_burnout: float = 0.1
    ext_reward: float = 1.0
    burn_penalty: float = 0.1
    step_penalty: float = 0.0
    max_steps: int = 100

    def __post_init__(self):
        if self.num_agents < 1:
            raise ValueError(f"num_agents must be >= 1, got {self.num_agents}")
        if len(self.agents_index) != self.num_agents:
            raise ValueError(
                f"agents_index has {len(self.agents_index)} entries for "
                f"num_agents={self.num_agents}"
            )
        if self.size < 3:
            raise ValueError(f"size must be >= 3, got {self.size}")
        if self.num_initial_fires < 1:
            raise ValueError(
                f"num_initial_fires must be >= 1, got {self.num_initial_fires}"
            )
        for name in ("tree_density", "p_spread", "p_burnout"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")

    @property
    def width(self) -> int:
        return self.size

    @property
    def height(self) -> int:
        return self.size


class WfTables(NamedTuple):
    """Static per-config tables of the step and reset: the fields of the
    JAX ``WfTables`` but its ``*_u8`` thresholds, which belong to the
    compact episode form."""

    width: int
    height: int
    n_cells: int
    n_agents: int
    n_fires: int
    tree_density: float
    p_burnout: float
    # (1 - p_spread)^k for k = 0..4 as numpy float32 powers: the ignition
    # survival table, selected by the integer neighbour count.
    survival: tuple[float, float, float, float, float]
    ext_reward: float
    burn_penalty: float
    step_penalty: float
    max_steps: int
    # every permutation of range(n_agents), itertools order: the move
    # order is perms[floor(u * n!)]
    perms: tuple[tuple[int, ...], ...]
    # action id -> (dx, dy); stay/left/down/right/up (CTF_ACTION_TO_VEC
    # applied as x += vec[1], y += vec[0])
    action_dx: tuple[int, ...]
    action_dy: tuple[int, ...]


def wf_tables(cfg: WildfireConfig) -> WfTables:
    if cfg.num_agents > MAX_AGENTS:
        raise ValueError(
            f"the move-order table takes at most {MAX_AGENTS} agents, got {cfg.num_agents}"
        )
    q = 1.0 - cfg.p_spread
    return WfTables(
        width=cfg.width,
        height=cfg.height,
        n_cells=cfg.width * cfg.height,
        n_agents=cfg.num_agents,
        n_fires=cfg.num_initial_fires,
        tree_density=float(cfg.tree_density),
        p_burnout=float(cfg.p_burnout),
        survival=tuple(np.float32(q) ** k for k in range(5)),
        ext_reward=float(cfg.ext_reward),
        burn_penalty=float(cfg.burn_penalty),
        step_penalty=float(cfg.step_penalty),
        max_steps=int(cfg.max_steps),
        perms=tuple(itertools.permutations(range(cfg.num_agents))),
        action_dx=tuple(int(v[1]) for v in CTF_ACTION_TO_VEC),
        action_dy=tuple(int(v[0]) for v in CTF_ACTION_TO_VEC),
    )


def ignite_thresholds(t: WfTables) -> tuple[float, ...]:
    """Ignition probability of a tree by its count of burning neighbours,
    0..4: 0, then ``1.0 - survival[k]`` as the JAX step forms it from the
    numpy float32 table, each exactly a float32."""
    return (0.0,) + tuple(float(np.float32(1.0 - t.survival[k])) for k in range(1, 5))


def step_rnd_width(t: WfTables) -> int:
    """Uniforms per env per step: the move order, then one per cell."""
    return 1 + t.n_cells


def reset_rnd_width(t: WfTables) -> int:
    """Uniforms per env per reset: one tree draw per cell, then the fire
    picks, then the agent picks."""
    return t.n_cells + t.n_fires + t.n_agents


@dataclass
class WildfireState:
    """Batched env state.  No PRNG key: the batch env's generator supplies
    the uniforms."""

    cells: torch.Tensor  # (B, H, W) int32 cell type (empty/tree/fire/burnt)
    agent_pos: torch.Tensor  # (B, A, 2) int32 (x, y)
    step_count: torch.Tensor  # (B,) int32
    extinguished: torch.Tensor  # (B,) int32, cumulative over the episode


def wildfire_state_from_numpy(arrays, device) -> WildfireState:
    """Build a state from a mapping of numpy arrays keyed by field name
    (e.g. a JAX ``WildfireState`` converted by the caller).  Keys that are
    not state fields, such as a JAX PRNG ``key``, are ignored.  The arrays
    are copied."""
    return WildfireState(**{
        f.name: torch.tensor(np.asarray(arrays[f.name]), device=device)
        for f in fields(WildfireState)
    })


def _typ_color(cfg: WildfireConfig, state: WildfireState):
    """(type, color) planes, (B, H, W) y-major: cells coloured by type,
    then each agent written over its cell in agent order."""
    cells = state.cells
    B, dev = cells.shape[0], cells.device
    color = torch.zeros_like(cells)
    color = torch.where(cells == TREE, TREE_COLOR, color)
    color = torch.where(cells == FIRE, FIRE_COLOR, color)
    color = torch.where(cells == BURNT, BURNT_COLOR, color)
    typ = cells.clone()
    rows = torch.arange(B, device=dev)
    for i, agent_color in enumerate(cfg.agents_index):
        x, y = state.agent_pos[:, i, 0].long(), state.agent_pos[:, i, 1].long()
        typ[rows, y, x] = W_AGENT
        color[rows, y, x] = agent_color
    return typ, color


def make_wildfire_partial_encode(cfg: WildfireConfig, view_size: int = 7):
    """Each agent's field of view: ``fn(states) -> (B, A, V, V, 3)`` uint8
    (JAX's ``make_wildfire_partial_encode``): agents face dir 3, nothing
    blocks sight, and the cells beyond the board's edge read as empty."""
    from gym_multigrid_tpu_torch.envs.partial_obs import make_partial_obs_fn

    obs_fn = make_partial_obs_fn(
        cfg.width, cfg.height, view_size, wall_encode=(EMPTY, 0, 0), see_through_walls=True
    )

    def encode_partial(state: WildfireState) -> torch.Tensor:
        typ, color = _typ_color(cfg, state)
        ch2 = torch.where(typ == W_AGENT, 3, 0).to(typ.dtype)
        planes = torch.stack([typ, color, ch2], dim=1).transpose(2, 3)  # xy-indexed
        opaque = torch.zeros_like(planes[:, 0], dtype=torch.bool)
        dirs = torch.full(state.agent_pos.shape[:2], 3, device=typ.device)
        return obs_fn(planes, opaque, state.agent_pos, dirs)

    return encode_partial


def encode(cfg: WildfireConfig, state: WildfireState) -> torch.Tensor:
    """(B, W, H, 3) uint8 (type, color, state), transposed like the other
    families: cells coloured by type, then each agent written over its cell
    in agent order, channel 2 = 3 on agents."""
    typ, color = _typ_color(cfg, state)
    ch2 = torch.where(typ == W_AGENT, 3, 0)
    return torch.stack([typ.transpose(1, 2), color.transpose(1, 2), ch2.transpose(1, 2)],
                       dim=-1).to(torch.uint8)


@dataclass(frozen=True)
class WildfireFns:
    """The functions of one Wildfire env (JAX's ``WildfireFns``).  A state
    of one env is a :class:`WildfireState` whose fields have no batch
    axis."""

    #: (generator, *, rnd=None) -> state
    reset_fn: Callable
    #: (state, actions, generator=None, *, rnd=None)
    #: -> (state', obs, rewards (A,), terminated, truncated, info)
    step_fn: Callable
    #: state -> (W, H, 3) uint8
    encode_fn: Callable


def make_wildfire(cfg: WildfireConfig, device=None) -> WildfireFns:
    """The functions of one env of ``cfg`` on ``device`` (JAX's
    ``make_wildfire``): the batch functions of ``ops/wildfire_slab.py`` at
    B = 1, so ``step_fn`` launches the step kernel on a CUDA device (the
    config must fit its envelope, as for ``make_wildfire_batch``) and runs
    the plain version on the CPU.  The device is the current CUDA device
    by default and ``device="cpu"`` the CPU, as for
    ``make_wildfire_batch``.

    Randomness comes from ``generator`` where JAX splits the state's key,
    or as ``rnd``: ``reset_fn``'s (``reset_rnd_width``,) and ``step_fn``'s
    (``step_rnd_width``,) uniforms, JAX's own ``rnd`` row.  The info is
    ``extinguished`` (the episode's count), ``burning`` and ``burnt``, 0-d
    int32 tensors."""
    from gym_multigrid_tpu_torch.ops import _build, wildfire_slab

    device = _build.default_device(device, "make_wildfire")
    slab = wildfire_slab.make_wildfire_slab(cfg, device)

    def reset_fn(generator=None, *, rnd=None):
        return row(wildfire_slab.reset_batch(slab, 1, generator=generator,
                                             rnd=given(rnd, device)))

    def step_fn(state, actions, generator=None, *, rnd=None):
        actions = torch.as_tensor(actions, device=device).reshape(1, cfg.num_agents)
        return step_row(wildfire_slab.step_batch(
            slab, batch(state), actions, generator=generator, rnd=given(rnd, device)))

    def encode_fn(state):
        return encode(cfg, batch(state))[0]

    return WildfireFns(reset_fn, step_fn, encode_fn)


@functools.cache
def _cached_wildfire(cfg: WildfireConfig, device: torch.device) -> WildfireFns:
    return make_wildfire(cfg, device)


def cached_wildfire(cfg: WildfireConfig, device=None) -> WildfireFns:
    """Memoised :func:`make_wildfire`, one per (config, device)."""
    from gym_multigrid_tpu_torch.ops import _build

    return _cached_wildfire(cfg, _build.default_device(device, "cached_wildfire"))
