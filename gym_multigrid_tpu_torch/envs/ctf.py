"""Capture-the-Flag env family: config, static tables, state, observations
and info (PyTorch port).

Counterpart of ``gym_multigrid_tpu/envs/ctf.py``.  The config checks and
the static tables are the same numpy code; the state is a dataclass of
batched tensors with no PRNG key: the batch env owns a
``torch.Generator`` and the slab functions take their uniforms as input
tensors.  The transition itself is ``ops/ctf_slab.py``.

Semantics carried over unchanged (see the JAX module's docstring): moves
stay/left/down/right/up with the reference's swapped bounds check, every
agent blocking (dead ones and the mover itself, so ``stay`` is blocked),
MvN shuffled move order and sticky ``collided`` flag, flag captures that
count terminated agents, sequential row-major battles with the territory
truth table, the 1v1 episode end on a lost battle or an obstacle cell,
and invalid blue action ids clamped into 0..4.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, fields
from typing import Callable, Literal, TypeAlias, TypedDict

import numpy as np
import torch

from gym_multigrid_tpu_torch.core.world import CtfWorld
from gym_multigrid_tpu_torch.envs.single import batch, given, row, step_row
from gym_multigrid_tpu_torch.utils.map import load_text_map

_W = CtfWorld.OBJECT_TO_IDX
BLUE_TERRITORY = _W["blue_territory"]
RED_TERRITORY = _W["red_territory"]
BLUE_AGENT = _W["blue_agent"]
RED_AGENT = _W["red_agent"]
BLUE_FLAG = _W["blue_flag"]
RED_FLAG = _W["red_flag"]
OBSTACLE = _W["obstacle"]

A_STAY, A_LEFT, A_DOWN, A_RIGHT, A_UP = 0, 1, 2, 3, 4
NUM_ACTIONS = 5
#: Render direction of a fresh agent (place_agent's default).
SPAWN_DIR = 3

ObservationOption = Literal["positional", "map", "flattened"]
POLICY_KINDS = ("rw", "fight", "capture", "patrol", "patrol_fight")


# -- typing surface of the reference's env module --------------------------
#
# The adapters' positional obs and ``game_stats`` carry exactly these
# keys, as int64 numpy arrays (``adapters/ctf_adapter.py``).


class ObservationDict(TypedDict):
    """1v1 positional observation (one red opponent)."""

    blue_agent: np.ndarray
    red_agent: np.ndarray
    blue_flag: np.ndarray
    red_flag: np.ndarray
    blue_territory: np.ndarray
    red_territory: np.ndarray
    obstacle: np.ndarray
    is_red_agent_defeated: int


class MultiAgentObservationDict(TypedDict):
    """MvN positional observation (flattened agent position lists)."""

    blue_agent: np.ndarray
    red_agent: np.ndarray
    blue_flag: np.ndarray
    red_flag: np.ndarray
    blue_territory: np.ndarray
    red_territory: np.ndarray
    obstacle: np.ndarray
    terminated_agents: np.ndarray


#: Any CtF observation: positional dicts or the map/flattened arrays.
Observation: TypeAlias = "ObservationDict | MultiAgentObservationDict | np.ndarray"


class GameStats(TypedDict):
    """Cumulative per-episode event flags (the adapters' ``game_stats``)."""

    blue_agent_defeated: list[bool]
    red_agent_defeated: list[bool]
    blue_flag_captured: bool
    red_flag_captured: bool


@dataclass(frozen=True)
class PolicySpec:
    """A scripted red policy: its kind, and ``randomness``, the probability
    of taking the optimal action (same fields and checks as the JAX
    package's ``PolicySpec``)."""

    kind: Literal["rw", "fight", "capture", "patrol", "patrol_fight"] = "rw"
    randomness: float = 0.75

    def __post_init__(self):
        if self.kind not in POLICY_KINDS:
            raise ValueError(
                f"unknown scripted-policy kind {self.kind!r}; "
                f"expected one of {POLICY_KINDS} (custom policies: pass a "
                "BaseAgentPolicy subclass to the adapter instead)"
            )
        if not 0.0 <= self.randomness <= 1.0:
            raise ValueError(
                f"randomness must be in [0, 1], got {self.randomness}"
            )


@dataclass(frozen=True)
class CtfConfig:
    """Static CtF configuration (same fields and checks as the JAX
    package's ``CtfConfig``).  ``map_data`` is the transposed text map, as
    :func:`load_text_map` returns it."""

    map_data: tuple[tuple[int, ...], ...]
    num_blue_agents: int = 1
    num_red_agents: int = 1
    variant: Literal["1v1", "mvn"] = "mvn"
    enemy_policies: tuple[PolicySpec, ...] = (PolicySpec("rw"),)
    battle_range: float = 1.0
    randomness: float = 0.75
    flag_reward: float = 1.0
    battle_reward_ratio: float = 0.25
    obstacle_penalty_ratio: float = 0.0
    step_penalty_ratio: float = 0.01
    max_steps: int = 100
    observation_option: ObservationOption = "positional"
    observation_scaling: float = 1.0

    def __post_init__(self):
        if self.variant not in ("1v1", "mvn"):
            raise ValueError(
                f"variant must be '1v1' or 'mvn', got {self.variant!r}"
            )
        if self.num_blue_agents < 1 or self.num_red_agents < 1:
            raise ValueError(
                "need at least one agent per team, got "
                f"{self.num_blue_agents} blue / {self.num_red_agents} red"
            )
        if self.variant == "1v1" and (
            self.num_blue_agents != 1 or self.num_red_agents != 1
        ):
            raise ValueError(
                "variant='1v1' requires exactly one agent per team "
                f"(got {self.num_blue_agents}v{self.num_red_agents}); "
                "use variant='mvn'"
            )
        if self.max_steps < 1:
            raise ValueError(f"max_steps must be >= 1, got {self.max_steps}")
        if len(self.enemy_policies) != self.num_red_agents:
            raise ValueError(
                f"enemy_policies has {len(self.enemy_policies)} specs for "
                f"{self.num_red_agents} red agents"
            )

    @classmethod
    def from_map_path(cls, map_path: str, **kwargs) -> "CtfConfig":
        fm = load_text_map(map_path).astype(int)
        return cls(map_data=tuple(tuple(int(v) for v in row) for row in fm), **kwargs)

    @property
    def field_map(self) -> np.ndarray:
        return np.asarray(self.map_data, dtype=np.int64)

    @property
    def num_agents(self) -> int:
        return self.num_blue_agents + self.num_red_agents

    # The derived rewards are products in double, as in the JAX package;
    # the step rounds each to float32 once.
    @property
    def battle_reward(self) -> float:
        return self.battle_reward_ratio * self.flag_reward

    @property
    def obstacle_penalty(self) -> float:
        return self.obstacle_penalty_ratio * self.flag_reward

    @property
    def step_penalty(self) -> float:
        return self.step_penalty_ratio * self.flag_reward


@dataclass
class CtfState:
    """Batched env state; everything else about the world is static.

    There is no PRNG key: the batch env's generator supplies uniforms."""

    pos: torch.Tensor  # (B, A, 2) int32 (row, col), blue agents first
    dir: torch.Tensor  # (B, A) int32 render direction
    terminated: torch.Tensor  # (B, A) bool
    collided: torch.Tensor  # (B, A) bool, sticky (MvN obstacle penalty)
    step_count: torch.Tensor  # (B,) int32


def ctf_state_from_numpy(arrays, device) -> CtfState:
    """Build a state from a mapping of numpy arrays keyed by field name
    (e.g. a JAX ``CtfState`` converted by the caller).  Keys that are not
    state fields, such as a JAX PRNG ``key``, are ignored.  The arrays are
    copied: the batch env's auto-reset writes into its state."""
    return CtfState(**{
        f.name: torch.tensor(np.asarray(arrays[f.name]), device=device)
        for f in fields(CtfState)
    })


@dataclass(frozen=True)
class _Tables:
    """Static tables of one map."""

    fm: np.ndarray  # (S0, S1) field map
    blue_flag: np.ndarray  # (2,)
    red_flag: np.ndarray  # (2,)
    blue_territory: np.ndarray  # (n_bt, 2) row-major, flag appended
    red_territory: np.ndarray  # (n_rt, 2)
    obstacle: np.ndarray  # (n_ob, 2)
    can_enter: np.ndarray  # (S0, S1) bool (static cells only)
    blue_mask: np.ndarray  # (S0, S1) bool own territory incl. flag
    red_mask: np.ndarray  # (S0, S1) bool
    obstacle_mask: np.ndarray  # (S0, S1) bool


@functools.cache
def build_tables(cfg: CtfConfig) -> _Tables:
    fm = cfg.field_map
    blue_flag = np.argwhere(fm == BLUE_FLAG)[0]
    red_flag = np.argwhere(fm == RED_FLAG)[0]
    # Territory lists: row-major order with the flag cell appended; the
    # order decides closest-target ties and spawn indices.
    blue_territory = np.concatenate(
        [np.argwhere(fm == BLUE_TERRITORY), blue_flag[None]], axis=0
    )
    red_territory = np.concatenate(
        [np.argwhere(fm == RED_TERRITORY), red_flag[None]], axis=0
    )
    obstacle = np.argwhere(fm == OBSTACLE)

    blue_mask = fm == BLUE_TERRITORY
    blue_mask[tuple(blue_flag)] = True
    red_mask = fm == RED_TERRITORY
    red_mask[tuple(red_flag)] = True

    # Cells an agent may enter, agents aside: everything but obstacles
    # that carry no penalty (a penalised obstacle can be stepped on).
    if cfg.obstacle_penalty != 0:
        can_enter = np.ones_like(fm, dtype=bool)
    else:
        can_enter = fm != OBSTACLE

    return _Tables(
        fm=fm,
        blue_flag=blue_flag,
        red_flag=red_flag,
        blue_territory=blue_territory,
        red_territory=red_territory,
        obstacle=obstacle,
        can_enter=can_enter,
        blue_mask=blue_mask,
        red_mask=red_mask,
        obstacle_mask=fm == OBSTACLE,
    )


# ---------------------------------------------------------------------------
# Observations and info
# ---------------------------------------------------------------------------


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, dtype=np.int32).reshape(-1), device=device)


def _positional(cfg: CtfConfig, t: _Tables, state: CtfState) -> dict[str, torch.Tensor]:
    B, dev, nb = state.pos.shape[0], state.pos.device, cfg.num_blue_agents

    def rows(x):
        return _i32(x, dev)[None, :].expand(B, -1)

    obs = {
        "blue_agent": state.pos[:, :nb].reshape(B, -1),
        "red_agent": state.pos[:, nb:].reshape(B, -1),
        "blue_flag": rows(t.blue_flag),
        "red_flag": rows(t.red_flag),
        "blue_territory": rows(t.blue_territory),
        "red_territory": rows(t.red_territory),
        "obstacle": rows(t.obstacle),
    }
    if cfg.variant == "mvn":
        obs["terminated_agents"] = state.terminated.to(torch.int32)
    else:
        obs["is_red_agent_defeated"] = state.terminated[:, 1].to(torch.int32)
    return obs


def _flattened(cfg: CtfConfig, t: _Tables, state: CtfState) -> torch.Tensor:
    obs = _positional(cfg, t, state)
    tail = (
        state.terminated.to(torch.int32)
        if cfg.variant == "mvn"
        else state.terminated[:, 1:2].to(torch.int32)
    )
    parts = [obs[k] for k in ("blue_agent", "red_agent", "blue_flag", "red_flag",
                              "blue_territory", "red_territory", "obstacle")]
    return torch.cat(parts + [tail], dim=1)


def _base_map(t: _Tables) -> np.ndarray:
    m = np.zeros(t.fm.shape, dtype=np.int32)
    for i, j in t.blue_territory:
        m[i, j] = BLUE_TERRITORY
    for i, j in t.red_territory:
        m[i, j] = RED_TERRITORY
    for i, j in t.obstacle.reshape(-1, 2):
        m[i, j] = OBSTACLE
    m[tuple(t.blue_flag)] = BLUE_FLAG
    m[tuple(t.red_flag)] = RED_FLAG
    return m


def _map(cfg: CtfConfig, t: _Tables, state: CtfState) -> torch.Tensor:
    """The static map with each agent written over it in agent order (a
    defeated agent as an obstacle), transposed: (B, S1, S0) int32.  An
    agent outside the board (the swapped bounds check lets one leave a
    non-square map) is not drawn, as JAX drops an out-of-range update."""
    B, dev = state.pos.shape[0], state.pos.device
    S0, S1 = t.fm.shape
    m = torch.as_tensor(_base_map(t), device=dev).repeat(B, 1, 1)
    rows = torch.arange(B, device=dev)
    for a in range(cfg.num_agents):
        live = BLUE_AGENT if a < cfg.num_blue_agents else RED_AGENT
        v = torch.where(state.terminated[:, a], OBSTACLE, live).to(torch.int32)
        x, y = state.pos[:, a, 0].long(), state.pos[:, a, 1].long()
        on = (x >= 0) & (x < S0) & (y >= 0) & (y < S1)
        m[rows[on], x[on], y[on]] = v[on]
    return m.transpose(1, 2)


def encode(cfg: CtfConfig, state: CtfState):
    """The configured observation of each env: ``positional`` a dict of
    (B, ·) int32 tensors, ``map`` a (B, S1, S0) int32 map, ``flattened``
    (B, L) int32."""
    t = build_tables(cfg)
    if cfg.observation_option == "positional":
        return _positional(cfg, t, state)
    if cfg.observation_option == "map":
        return _map(cfg, t, state)
    if cfg.observation_option == "flattened":
        return _flattened(cfg, t, state)
    raise ValueError(f"Invalid observation_option: {cfg.observation_option}")


def make_ctf_partial_encode(
    cfg: CtfConfig, view_size: int = 7, see_through_walls: bool = False
):
    """Each agent's field of view: ``fn(states) -> (B, A, V, V, 3)`` uint8
    (JAX's ``make_ctf_partial_encode``): light blue and light red
    territory, grey obstacles, the flags, and agents typed blue or red
    whose colour greys once defeated, with their directions.  The board's
    edge reads as a grey obstacle and blocks sight; nothing on the board
    does."""
    from gym_multigrid_tpu_torch.envs.partial_obs import (
        device_tables, draw_cells, make_partial_obs_fn)

    t = build_tables(cfg)
    W, H = t.fm.shape
    CI = CtfWorld.COLOR_TO_IDX
    nb = cfg.num_blue_agents
    typ = np.zeros((W, H), np.int32)
    col = np.zeros((W, H), np.int32)
    for (i, j) in t.blue_territory:
        typ[i, j], col[i, j] = BLUE_TERRITORY, CI["light_blue"]
    for (i, j) in t.red_territory:
        typ[i, j], col[i, j] = RED_TERRITORY, CI["light_red"]
    for (i, j) in t.obstacle.reshape(-1, 2):
        typ[i, j], col[i, j] = OBSTACLE, CI["grey"]
    typ[tuple(t.blue_flag)], col[tuple(t.blue_flag)] = BLUE_FLAG, CI["blue"]
    typ[tuple(t.red_flag)], col[tuple(t.red_flag)] = RED_FLAG, CI["red"]
    base = device_tables(planes=torch.from_numpy(np.stack([typ, col, np.zeros_like(typ)])))
    obs_fn = make_partial_obs_fn(
        W, H, view_size, wall_encode=(OBSTACLE, CI["grey"], 0),
        see_through_walls=see_through_walls,
    )

    def encode_partial(state: CtfState) -> torch.Tensor:
        B, dev = state.pos.shape[0], state.pos.device
        planes = base(dev)["planes"].repeat(B, 1, 1, 1)
        rows = torch.arange(B, device=dev)
        for a in range(cfg.num_agents):
            blue = a < nb
            color = torch.where(state.terminated[:, a], CI["blue_grey" if blue else "red_grey"],
                                CI["blue" if blue else "red"]).to(planes.dtype)
            kind = torch.full_like(color, BLUE_AGENT if blue else RED_AGENT)
            draw_cells(planes, rows, state.pos[:, a], (kind, color, state.dir[:, a]))
        # Obstacles can be seen through: no cell on the board is opaque.
        opaque = torch.zeros((B, W, H), dtype=torch.bool, device=dev)
        return obs_fn(planes, opaque, state.pos, state.dir)

    return encode_partial


def info(cfg: CtfConfig, state: CtfState) -> dict[str, torch.Tensor]:
    """The 11 distance features, (B,) float32 each.

    As in the reference, "ba" is agents[0] and "ra" is agents[1], which in
    MvN with two or more blue agents is the second *blue* agent.  Each
    distance is ``sqrt(dx*dx + dy*dy)`` in float32: the squares and their
    sum are exact for board coordinates, so it equals JAX's float32
    ``jnp.linalg.norm`` bit for bit.  ``d_ba_ob`` is inf on a map with no
    obstacle."""
    t = build_tables(cfg)
    dev = state.pos.device
    B = state.pos.shape[0]
    p0 = state.pos[:, 0].to(torch.float32)
    p1 = state.pos[:, 1].to(torch.float32)

    def pts(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32).reshape(-1, 2), device=dev)

    def norm(diff):  # (..., 2) -> (...)
        return torch.sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])

    def d_area(p, area):
        return norm(p[:, None, :] - pts(area)[None]).amin(dim=1)

    bf, rf = pts(t.blue_flag)[0], pts(t.red_flag)[0]
    return {
        "d_ba_ra": norm(p0 - p1),
        "d_ba_bf": norm(p0 - bf),
        "d_ba_rf": norm(p0 - rf),
        "d_ra_bf": norm(p1 - bf),
        "d_ra_rf": norm(p1 - rf),
        "d_bf_rf": norm(bf - rf).expand(B),
        "d_ba_bb": d_area(p0, t.blue_territory),
        "d_ba_rb": d_area(p0, t.red_territory),
        "d_ra_bb": d_area(p1, t.blue_territory),
        "d_ra_rb": d_area(p1, t.red_territory),
        "d_ba_ob": (
            d_area(p0, t.obstacle)
            if t.obstacle.shape[0] > 0
            else torch.full((B,), float("inf"), dtype=torch.float32, device=dev)
        ),
    }


# ---------------------------------------------------------------------------
# One env: per-env functions and the host policies' observation
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CtfFns:
    """The functions of one CtF env (JAX's ``CtfFns``).  A state of one
    env is a :class:`CtfState` whose fields have no batch axis."""

    #: (generator, *, rnd=None) -> state
    reset_fn: Callable
    #: (state, blue_actions, generator=None, *, rnd=None)
    #: -> (state', obs, reward, terminated, truncated, info)
    step_fn: Callable
    #: (state, actions, generator=None, *, order=None, battle_u=None)
    #: -> the same; every agent's action given, blue first
    step_actions_fn: Callable
    #: (state, generator=None, *, rnd=None) -> (n_red,) int32
    red_actions_fn: Callable
    #: state -> obs (a dict of tensors for "positional")
    obs_fn: Callable
    #: state -> the 11 distances of :func:`info`, 0-d float32 tensors
    info_fn: Callable


def make_ctf(cfg: CtfConfig, device=None) -> CtfFns:
    """The functions of one env of ``cfg`` on ``device`` (JAX's
    ``make_ctf``): the batch functions of ``ops/ctf_slab.py`` at B = 1, so
    ``step_fn`` takes the slab's route: the step kernel on a CUDA device
    (the config must fit its envelope, as for ``make_ctf_batch``), the
    plain version on the CPU.  ``step_actions_fn`` and ``red_actions_fn``
    are plain PyTorch on either device (no kernel computes them).  The
    device is the current CUDA device by default and ``device="cpu"`` the
    CPU, as for ``make_ctf_batch``.

    Randomness comes from the ``generator`` argument where JAX splits the
    state's key; each function also takes its draws explicitly:
    ``reset_fn``'s ``rnd`` (A,) spawn uniforms; ``step_fn``'s and
    ``red_actions_fn``'s ``rnd`` (``ctf_slab.rnd_width``,) step uniforms
    (move order, three a red policy, the battles), of which
    ``red_actions_fn`` reads the reds'; ``step_actions_fn``'s ``order``
    (A,), the agent that moves in each slot, and ``battle_u`` (n_blue *
    n_red,).  The reward is a 0-d float32 tensor, the flags 0-d bool
    tensors, and the info the 11 distances with the step's flags."""
    from gym_multigrid_tpu_torch.ops import _build, ctf_slab

    device = _build.default_device(device, "make_ctf")
    slab = ctf_slab.make_ctf_slab(cfg, device)
    A, nb = cfg.num_agents, cfg.num_blue_agents

    def reset_fn(generator=None, *, rnd=None):
        return row(ctf_slab.reset_batch(slab, 1, generator=generator, rnd=given(rnd, device)))

    def step_fn(state, blue_actions, generator=None, *, rnd=None):
        actions = torch.as_tensor(blue_actions, device=device).reshape(1, nb)
        return step_row(ctf_slab.step_batch(
            slab, batch(state), actions, generator=generator, rnd=given(rnd, device)))

    def step_actions_fn(state, actions, generator=None, *, order=None, battle_u=None):
        actions = torch.as_tensor(actions, device=device).reshape(1, A)
        return step_row(ctf_slab.step_actions_batch(
            slab, batch(state), actions, generator=generator, order=given(order, device),
            battle_u=given(battle_u, device)))

    def red_actions_fn(state, generator=None, *, rnd=None):
        rnd = given(rnd, device)
        if rnd is None:
            rnd = torch.rand((1, slab.step_draws), generator=generator, device=device)
        pos = state.pos.reshape(1, 2 * A)
        return ctf_slab._red_actions(slab.t, pos[:, 0::2], pos[:, 1::2], rnd, slab.cells,
                                     slab.border, slab.pool)[0]

    def obs_fn(state):
        return row(encode(cfg, batch(state)))

    def info_fn(state):
        return row(info(cfg, batch(state)))

    return CtfFns(reset_fn, step_fn, step_actions_fn, red_actions_fn, obs_fn, info_fn)


@functools.cache
def _cached_ctf(cfg: CtfConfig, device: torch.device) -> CtfFns:
    return make_ctf(cfg, device)


def cached_ctf(cfg: CtfConfig, device=None) -> CtfFns:
    """Memoised :func:`make_ctf`, one per (config, device)."""
    from gym_multigrid_tpu_torch.ops import _build

    return _cached_ctf(cfg, _build.default_device(device, "cached_ctf"))


def host_observation(cfg: CtfConfig, state: CtfState) -> ObservationDict | MultiAgentObservationDict:
    """The positional observation of one env as int64 numpy arrays on the
    host: what a host policy's ``act`` reads, before the move (the JAX
    adapter's ``_get_dict_obs``)."""
    t = build_tables(cfg)
    pos = state.pos.cpu().numpy().astype(np.int64)
    term = state.terminated.cpu().numpy()
    nb = cfg.num_blue_agents
    obs = {
        "blue_flag": t.blue_flag.astype(np.int64),
        "red_flag": t.red_flag.astype(np.int64),
        "blue_territory": t.blue_territory.astype(np.int64).reshape(-1),
        "red_territory": t.red_territory.astype(np.int64).reshape(-1),
        "obstacle": t.obstacle.astype(np.int64).reshape(-1),
    }
    if cfg.variant == "1v1":
        obs.update(blue_agent=pos[0], red_agent=pos[1], is_red_agent_defeated=int(term[1]))
    else:
        obs.update(blue_agent=pos[:nb].reshape(-1), red_agent=pos[nb:].reshape(-1),
                   terminated_agents=term.astype(np.int64))
    return obs


def host_red_actions(cfg: CtfConfig, policies, state: CtfState) -> np.ndarray:
    """(n_red,) int32: each red agent's action from its host policy's
    ``act(observation, curr_pos)``, on :func:`host_observation` of the
    pre-move state, in agent order."""
    obs = host_observation(cfg, state)
    pos = state.pos.cpu().numpy()
    nb = cfg.num_blue_agents
    return np.asarray([int(p.act(obs, pos[nb + i])) for i, p in enumerate(policies)],
                      dtype=np.int32)
