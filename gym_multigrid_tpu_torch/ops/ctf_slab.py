"""CtF slab math: one transition and one spawn draw for a batch of envs
(PyTorch port).

Counterpart of ``gym_multigrid_tpu/ops/pallas_ctf.py``: its Pallas kernel
``ctf_step_slab`` is the hand-written CUDA kernel
``gym_multigrid_tpu_torch/csrc/ctf_step.cu``, its plain body
``_ctf_step_math`` is :func:`step_spec` here, and ``_ctf_reset_math`` is
:func:`reset_spec`.

* :func:`ctf_step_slab` takes the plain version for tensors on the CPU and
  launches the kernel for CUDA tensors.  It is never a fallback: a slab
  whose config the kernels do not take calls the plain versions itself
  (:func:`kernel_route`, decided when the slab is built).  It takes and
  returns the
  batch state's own types (``terminated``/``collided`` and every flag as
  bool) and the board as one flag byte per cell (:func:`cell_flags`,
  built once per slab); :func:`step_spec` keeps the JAX step's int32
  interface, and :func:`step_spec_bool` casts around it.
* The reset has no kernel, here as in the JAX package (which has one
  ``pallas_call``, the step): :func:`reset_spec` runs as PyTorch tensor
  ops on whatever device its inputs are on.
* :func:`step_batch` / :func:`reset_batch` are the batch glue of
  ``make_ctf_step_batch`` and of the auto-reset in ``_ctf_ms_math``:
  state, termination, truncation, obs and info.  Their uniforms come from
  a ``torch.Generator``, or from an ``rnd`` tensor used as is (which is
  how the tests hold them to JAX bit for bit).
* :func:`step_spec` is the scripted reds' actions and the move order
  drawn from its uniforms, then :func:`step_actions_spec`, the transition
  with every agent's action given (JAX's ``_transition`` under
  ``step_actions_fn``).  :func:`step_actions_batch` is its batch glue for
  self-play and the match evaluator; no kernel computes it, in either
  package, so it runs as PyTorch ops on the batch's device.
* :func:`ms_spec` is ``_ctf_ms_math``: K steps with the per-env auto-reset
  and the return accounting.  :func:`ctf_ms_slab` runs it, or for CUDA
  tensors the kernel entry ``ctf_steps`` of ``csrc/ctf_step.cu``, which
  runs all K steps and the respawns in one launch;
  :func:`make_ctf_episode_rollout` drives it chunk by chunk, the
  counterpart of JAX's ``make_ctf_episode_rollout``.

Every float constant of the step is formed in double on the host and
rounded to float32 once, where the JAX package's weakly typed Python
floats meet a float32 array.
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from gym_multigrid_tpu_torch.core.constants import CTF_ACTION_TO_VEC
from gym_multigrid_tpu_torch.envs.ctf import (
    A_DOWN,
    A_LEFT,
    A_RIGHT,
    A_STAY,
    A_UP,
    NUM_ACTIONS,
    POLICY_KINDS,
    SPAWN_DIR,
    CtfConfig,
    CtfState,
    build_tables,
    encode,
    info,
)
from gym_multigrid_tpu_torch.ops import _build
from gym_multigrid_tpu_torch.ops.sampling import PickState
from gym_multigrid_tpu_torch.policy.ctf.heuristic import locate_border, patrol_targets
from gym_multigrid_tpu_torch.utils.profiling import annotate

#: Agent counts the step kernel takes (the JAX kernel's envelope).
MAX_AGENTS = 8
#: Largest board the step kernel takes; border and pool lists are bounded
#: by it too (a border cell per own cell, four pool entries per border
#: cell).  20x20 (tests/assets/board_large.txt) is 400 cells.
MAX_CELLS = 1024

# The render direction of each action: stay/left/down/right/up.
_A2DIR = (3, 3, 2, 1, 0)


class CtfKTables(NamedTuple):
    """Static per-config tables of the step (the JAX ``CtfKTables``)."""

    mvn: bool
    s0: int
    s1: int
    n_blue: int
    n_red: int
    bound0: int  # pos[0] upper bound: the map's shape[1] (reference quirk)
    bound1: int
    blue_flag: tuple[int, int]
    red_flag: tuple[int, int]
    battle_range: float
    randomness: float
    flag_reward: float
    battle_reward: float
    obstacle_penalty: float
    step_penalty: float
    max_steps: int
    # per red agent: (kind, probability of the optimal action)
    policies: tuple[tuple[str, float], ...]


def make_ctf_ktables(cfg: CtfConfig) -> CtfKTables:
    t = build_tables(cfg)
    S0, S1 = t.fm.shape
    return CtfKTables(
        mvn=cfg.variant == "mvn",
        s0=S0,
        s1=S1,
        n_blue=cfg.num_blue_agents,
        n_red=cfg.num_red_agents,
        bound0=S1,
        bound1=S0,
        blue_flag=(int(t.blue_flag[0]), int(t.blue_flag[1])),
        red_flag=(int(t.red_flag[0]), int(t.red_flag[1])),
        battle_range=float(cfg.battle_range),
        randomness=float(cfg.randomness),
        flag_reward=float(cfg.flag_reward),
        battle_reward=float(cfg.battle_reward),
        obstacle_penalty=float(cfg.obstacle_penalty),
        step_penalty=float(cfg.step_penalty),
        max_steps=int(cfg.max_steps),
        policies=tuple((s.kind, float(s.randomness)) for s in cfg.enemy_policies),
    )


def ctf_static_inputs(cfg: CtfConfig, device="cpu"):
    """(cells (4, N), border (2, nb), pool (2, np)) int32 on ``device``.

    cells rows: can_enter, blue_mask, red_mask, obstacle_mask, flat index
    ``row * S1 + col``.  border and pool are the red patrol tables as
    (row; col) rows, in the order the step reads them; a dummy (2, 1) of
    zeros when no red agent patrols."""
    t = build_tables(cfg)
    cells = np.stack([
        t.can_enter.reshape(-1), t.blue_mask.reshape(-1),
        t.red_mask.reshape(-1), t.obstacle_mask.reshape(-1),
    ]).astype(np.int32)
    if any(s.kind in ("patrol", "patrol_fight") for s in cfg.enemy_policies):
        border_list, _ = locate_border(t.fm, "red")
        border = np.asarray(border_list, dtype=np.int32).reshape(-1, 2)
        pool = np.asarray(patrol_targets(border_list), dtype=np.int32).reshape(-1, 2)
    else:
        border = np.zeros((1, 2), dtype=np.int32)
        pool = np.zeros((1, 2), dtype=np.int32)
    return tuple(
        torch.as_tensor(np.ascontiguousarray(x), device=device)
        for x in (cells, border.T, pool.T)
    )


#: Weight of each row of ``cells`` (can_enter, blue_mask, red_mask,
#: obstacle_mask) in the step kernel's flag byte (its kCanEnter, kBlueOwn,
#: kRedOwn, kObstacle).
CELL_FLAG_BITS = (1, 2, 4, 8)


def cell_flags(cells):
    """(N,) uint8: one flag byte per cell from the (4, N) ``cells`` rows,
    bit ``CELL_FLAG_BITS[r]`` set where row r is positive."""
    weights = torch.tensor(CELL_FLAG_BITS, dtype=torch.uint8, device=cells.device)
    return ((cells > 0).to(torch.uint8) * weights[:, None]).sum(dim=0, dtype=torch.uint8)


def cell_planes(flags):
    """The (4, N) int32 0/1 ``cells`` rows back from :func:`cell_flags`."""
    weights = torch.tensor(CELL_FLAG_BITS, dtype=torch.uint8, device=flags.device)
    return ((flags[None, :] & weights[:, None]) != 0).to(torch.int32)


#: A cell's key in the K-step kernel (``csrc/ctf_step.cu`` ``kRowKey``):
#: ``row * KEY_ROW + col``.
KEY_ROW = 65536
#: Where the K-step kernel's info word (:func:`cell_info`) holds the row and
#: the column of the closest red-border cell (its ``kInfoRowShift``,
#: ``kInfoColShift``), 10 bits each, above the flag byte.
INFO_ROW_SHIFT = 8
INFO_COL_SHIFT = 18


def agent_positions(t: CtfKTables) -> tuple[np.ndarray, np.ndarray]:
    """(rows, cols) int64 of every position an agent can hold, in the K-step
    kernel's order: the positions the move's bounds check admits (row below
    ``bound0``, column below ``bound1``, row-major), then the board's cells
    (row-major), where the spawns land.  On a non-square board the first
    part holds cells off the board, and the second cells the moves cannot
    reach."""
    rows, cols = np.divmod(np.arange(t.bound0 * t.bound1), t.bound1)
    board_rows, board_cols = np.divmod(np.arange(t.s0 * t.s1), t.s1)
    return np.concatenate([rows, board_rows]), np.concatenate([cols, board_cols])


def closest_border(t: CtfKTables, border) -> np.ndarray:
    """(n,) int32: for each position of :func:`agent_positions`, the index of
    the closest cell of ``border`` ((2, nb) rows then columns), ties to the
    first: ``_red_actions``' patrol scan, tabulated once a slab."""
    rows, cols = agent_positions(t)
    border = np.asarray(border, dtype=np.int64)
    d = (rows[:, None] - border[0][None, :]) ** 2 + (cols[:, None] - border[1][None, :]) ** 2
    return d.argmin(axis=1).astype(np.int32)


def cell_info(t: CtfKTables, cells, border) -> np.ndarray:
    """(n,) int32, the K-step kernel's info word of each position of
    :func:`agent_positions`: the flag byte (:data:`CELL_FLAG_BITS`) of the
    board cell it clips to, the row of its closest border cell
    (:func:`closest_border`) at bit ``INFO_ROW_SHIFT`` and the column at
    ``INFO_COL_SHIFT``."""
    rows, cols = agent_positions(t)
    cells, border = np.asarray(cells), np.asarray(border, dtype=np.int64)
    q = rows.clip(0, t.s0 - 1) * t.s1 + cols.clip(0, t.s1 - 1)
    flags = sum((cells[r][q] > 0).astype(np.int64) * bit for r, bit in enumerate(CELL_FLAG_BITS))
    near = closest_border(t, border)
    info = flags | border[0][near] << INFO_ROW_SHIFT | border[1][near] << INFO_COL_SHIFT
    return info.astype(np.int32)


def steps_table(t: CtfKTables, cells, border, pool, bterr, rterr) -> np.ndarray:
    """(2 * (n_bt + n_rt) + n_positions + n_pool,) int32, the static table
    the K-step kernel copies into shared memory: each territory cell
    (blue, then red) as its key (:data:`KEY_ROW`) and its info word, then
    :func:`cell_info`, then the patrol pool's keys."""
    info = cell_info(t, cells, border)
    n_ab = t.bound0 * t.bound1

    def keys(rc):
        rc = np.asarray(rc, dtype=np.int64)
        return rc[0] * KEY_ROW + rc[1]

    terr = np.concatenate([np.asarray(bterr), np.asarray(rterr)], axis=1).astype(np.int64)
    terr_info = info[n_ab + terr[0] * t.s1 + terr[1]]
    pairs = np.stack([keys(terr), terr_info], axis=1).reshape(-1)
    return np.concatenate([pairs, info, keys(pool)]).astype(np.int32)


def n_perm_draws(t: CtfKTables) -> int:
    """Uniforms for the MvN move order: one index into the A! permutations
    for up to 4 agents, A - 1 Fisher-Yates draws beyond."""
    A = t.n_blue + t.n_red
    return 1 if A <= 4 else A - 1


def rnd_width(t: CtfKTables) -> int:
    """Uniforms per env per step: move order, 3 per red policy, battles."""
    return n_perm_draws(t) + 3 * t.n_red + t.n_blue * t.n_red


# ---------------------------------------------------------------------------
# Step
# ---------------------------------------------------------------------------


def _optimal_action(cr, cc, tr, tc):
    """First step of the reference A*'s path on an open board, closed
    form: down while the target row is smaller, then along the row, then
    up."""
    dr, dc = tr - cr, tc - cc
    along = torch.where(dc < 0, A_LEFT, A_RIGHT)
    return torch.where(
        (dr == 0) & (dc == 0),
        A_STAY,
        torch.where(dr < 0, A_DOWN, torch.where(dc != 0, along, A_UP)),
    ).to(torch.int32)


@functools.cache
def _table(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A constant table on ``device``, copied there once (a copy to the card
    made every step would wait for it).  Read only."""
    return torch.tensor(values, dtype=dtype, device=device)


def _f32(v: float, device) -> torch.Tensor:
    """A double rounded to float32 once, as a 0-d tensor on ``device``."""
    return _table(v, torch.float32, torch.device(device))


def _red_actions(t: CtfKTables, px, py, rnd, cells, border, pool):
    """(B, n_red) int32: each scripted red policy's action from the
    pre-move positions, with its three uniforms of ``rnd``."""
    B, nb, dev = px.shape[0], t.n_blue, px.device

    def col(x, i):
        return x[:, i : i + 1]

    def sq(a, b):  # float32 squared distance of integer points, exact
        dx, dy = (a[0] - b[0]).to(torch.float32), (a[1] - b[1]).to(torch.float32)
        return dx * dx + dy * dy

    perm_draws = n_perm_draws(t)
    acts = []
    for r, (kind, p_opt) in enumerate(t.policies):
        base = perm_draws + 3 * r
        u_t, u_g, u_a = col(rnd, base), col(rnd, base + 1), col(rnd, base + 2)
        rand_act = ((u_a * NUM_ACTIONS).to(torch.int32)).clamp(max=NUM_ACTIONS - 1)
        if kind == "rw":
            acts.append(rand_act)
            continue
        cr, cc = col(px, nb + r), col(py, nb + r)
        if kind == "capture":
            trow = torch.full((B, 1), t.blue_flag[0], dtype=torch.int32, device=dev)
            tcol = torch.full((B, 1), t.blue_flag[1], dtype=torch.int32, device=dev)
        else:
            # closest blue agent; ties go to the first
            d = sq((px[:, :nb], py[:, :nb]), (cr, cc))
            k = d.argmin(dim=1, keepdim=True)
            trow, tcol = px[:, :nb].gather(1, k), py[:, :nb].gather(1, k)
        if kind in ("patrol", "patrol_fight"):
            n_pool = pool.shape[1]
            onb = ((cr == border[0]) & (cc == border[1])).any(dim=1, keepdim=True)
            # uniform over the pool, duplicates weighing more
            if n_pool:
                j = ((u_t * n_pool).to(torch.int32)).clamp(max=n_pool - 1).long()
                prow, pcol = pool[0][j], pool[1][j]
            else:
                prow = pcol = torch.zeros((B, 1), dtype=torch.int32, device=dev)
            # closest border cell; ties go to the first
            k = sq((border[0][None, :], border[1][None, :]), (cr, cc)).argmin(dim=1, keepdim=True)
            brow, bcol = border[0][k], border[1][k]
            patrol_row = torch.where(onb, prow, brow)
            patrol_col = torch.where(onb, pcol, bcol)
            if kind == "patrol":
                trow, tcol = patrol_row, patrol_col
            else:
                # chase once any blue stands in red territory (flag included)
                q = px[:, :nb].clamp(0, t.s0 - 1) * t.s1 + py[:, :nb].clamp(0, t.s1 - 1)
                opp_in = (cells[2][q.long()] > 0).any(dim=1, keepdim=True)
                trow = torch.where(opp_in, trow, patrol_row)
                tcol = torch.where(opp_in, tcol, patrol_col)
        optimal = _optimal_action(cr, cc, trow, tcol)
        acts.append(torch.where(u_g < _f32(p_opt, dev), optimal, rand_act))
    return torch.cat(acts, dim=1)


def _move_order(t: CtfKTables, rnd):
    """(B, A) int32, the agent that moves in each slot: MvN shuffles with
    the first ``n_perm_draws(t)`` uniforms of ``rnd`` (an index into the A!
    permutations up to 4 agents, Fisher-Yates beyond), 1v1 is blue then
    red."""
    B, A, dev = rnd.shape[0], t.n_blue + t.n_red, rnd.device
    agent = torch.arange(A, dtype=torch.int32, device=dev)[None, :]
    if t.mvn and A <= 4:
        perms = _table(tuple(itertools.permutations(range(A))), torch.int32, dev)
        j = ((rnd[:, :1] * len(perms)).to(torch.int32)).clamp(max=len(perms) - 1)
        return perms[j[:, 0].long()]
    if not t.mvn:
        return agent.expand(B, A)
    # Fisher-Yates: slot s moves the floor(u_s * (A - s))-th agent not yet
    # moved.
    taken = torch.zeros((B, A), dtype=torch.bool, device=dev)
    movers = []
    for slot in range(A):
        remaining = A - slot
        if slot < A - 1:
            r_pick = ((rnd[:, slot : slot + 1] * remaining).to(torch.int32)).clamp(
                max=remaining - 1)
        else:
            r_pick = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        rank = torch.cumsum(~taken, dim=1, dtype=torch.int32) - 1
        hit = ~taken & (rank == r_pick)
        i_vec = torch.where(hit, agent, 0).sum(dim=1, keepdim=True, dtype=torch.int32)
        taken = taken | (agent == i_vec)
        movers.append(i_vec)
    return torch.cat(movers, dim=1)


def step_spec(t: CtfKTables, pos, dirs, term, coll, blue_actions, rnd, cells, border, pool):
    """One CtF transition (both variants) for a batch, in plain PyTorch.

    pos:   (B, 2A) int32 [a0 row, a0 col, a1 row, ...], blue agents first
    dirs, term, coll: (B, A) int32 (term and coll 0/1 flags)
    blue_actions: (B, n_blue) int32; ids outside 0..4 are clamped
    rnd:   (B, rnd_width(t)) float32 uniforms
    cells: (4, N) int32; border (2, nb), pool (2, np) int32

    The scripted red actions from the pre-move state, then
    :func:`step_actions_spec` with the move order and the battle uniforms
    taken from ``rnd``.  Returns (pos, dirs, term, coll, reward (B, 1)
    float32, episode_term (B, 1), red flag captured (B, 1), blue flag
    captured (B, 1), blue battle lost (B, n_blue), red battle lost (B,
    n_red)), all int32 but the reward.
    """
    red = _red_actions(t, pos[:, 0::2], pos[:, 1::2], rnd, cells, border, pool)
    ub_base = n_perm_draws(t) + 3 * t.n_red
    return step_actions_spec(
        t, pos, dirs, term, coll, torch.cat([blue_actions, red], dim=1), _move_order(t, rnd),
        rnd[:, ub_base : ub_base + t.n_blue * t.n_red], cells,
    )


def step_actions_spec(t: CtfKTables, pos, dirs, term, coll, actions, order, battle_u, cells):
    """One CtF transition with every agent's action given: JAX's
    ``_transition`` (``step_actions_fn``), in plain PyTorch.

    pos (B, 2A) int32, blue agents first; dirs, term, coll (B, A) int32;
    actions (B, A) int32, blue first, every id clamped into 0..4; order
    (B, A) the agent that moves in each slot; battle_u (B, n_blue * n_red)
    float32, the uniform of each (blue, red) battle in row-major order (1v1:
    one); cells (4, N) int32.  Returns what :func:`step_spec` returns.

    A battle is won by blue when its uniform is below p_blue, JAX's
    ``bernoulli``; the range test compares squared distances, exact for
    board coordinates, and each reward term is added on its own."""
    B = pos.shape[0]
    nb, A = t.n_blue, t.n_blue + t.n_red
    dev = pos.device

    def col(x, i):
        return x[:, i : i + 1]

    def flag(row, cx, cy):  # static cell flag at the clipped position
        q = cx.clamp(0, t.s0 - 1) * t.s1 + cy.clamp(0, t.s1 - 1)
        return cells[row][q.long()] > 0

    def sq(a, b):  # float32 squared distance of integer points, exact
        dx, dy = (a[0] - b[0]).to(torch.float32), (a[1] - b[1]).to(torch.float32)
        return dx * dx + dy * dy

    px, py = pos[:, 0::2].clone(), pos[:, 1::2].clone()
    tm, cl, dr_ = term.clone(), coll.clone(), dirs.clone()
    agent = torch.arange(A, dtype=torch.int32, device=dev)[None, :]
    CAN_ENTER, BLUE_MASK, RED_MASK, OBSTACLE_MASK = range(4)
    acts = actions.clamp(0, NUM_ACTIONS - 1)

    # ---- sequential moves in ``order``; later movers see earlier ones ----
    dx_of, dy_of = _table(tuple(map(tuple, CTF_ACTION_TO_VEC.T.tolist())), torch.int32, dev)
    dir_of = _table(_A2DIR, torch.int32, dev)
    for slot in range(A):
        i_vec = order[:, slot : slot + 1].long()
        mine = agent == i_vec
        act = acts.gather(1, i_vec).long()
        cr, cc = px.gather(1, i_vec), py.gather(1, i_vec)
        alive = tm.gather(1, i_vec) == 0
        nr, nc = cr + dx_of[act], cc + dy_of[act]
        inb = (nr >= 0) & (nc >= 0) & (nr < t.bound0) & (nc < t.bound1)
        static_ok = flag(CAN_ENTER, nr, nc)
        # every agent blocks: dead ones, and the mover itself on ``stay``
        occupied = ((px == nr) & (py == nc)).any(dim=1, keepdim=True)
        if t.mvn and t.obstacle_penalty != 0:
            hit_agent = (alive & inb & occupied).to(torch.int32)
            cl = torch.where(mine, torch.maximum(cl, hit_agent), cl)
        moved = mine & (alive & inb & static_ok & ~occupied)
        px = torch.where(moved, nr, px)
        py = torch.where(moved, nc, py)
        dr_ = torch.where(moved, dir_of[act], dr_)

    # ---- collided penalty and termination, MvN only ----
    reward = torch.zeros((B, 1), dtype=torch.float32, device=dev)
    episode_term = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    if t.mvn and t.obstacle_penalty != 0:
        for b in range(nb):
            reward = reward - _f32(t.obstacle_penalty, dev) * col(cl, b).to(torch.float32)
        tm = torch.maximum(tm, cl)

    # ---- flag captures, terminated agents included ----
    flag_reward = _f32(t.flag_reward, dev)
    on_red = (px[:, :nb] == t.red_flag[0]) & (py[:, :nb] == t.red_flag[1])
    on_blue = (px[:, nb:] == t.blue_flag[0]) & (py[:, nb:] == t.blue_flag[1])
    for b in range(nb):
        reward = reward + flag_reward * col(on_red, b).to(torch.float32)
    for r in range(t.n_red):
        reward = reward - flag_reward * col(on_blue, r).to(torch.float32)
    rfc = on_red.any(dim=1, keepdim=True)
    bfc = on_blue.any(dim=1, keepdim=True)
    episode_term = episode_term | rfc | bfc

    # ---- battles, row-major and sequential ----
    bin_own = flag(BLUE_MASK, px[:, :nb], py[:, :nb])
    rin_own = flag(RED_MASK, px[:, nb:], py[:, nb:])
    battle_reward = _f32(t.battle_reward, dev)
    range2 = _f32(t.battle_range * t.battle_range, dev)
    p_half, p_own = _f32(0.5, dev), _f32(t.randomness, dev)
    p_away = _f32(1.0 - t.randomness, dev)
    bbl = torch.zeros((B, nb), dtype=torch.bool, device=dev)
    brl = torch.zeros((B, t.n_red), dtype=torch.bool, device=dev)
    k = 0
    for b in range(nb):
        for r in range(t.n_red):
            if not t.mvn and (b, r) != (0, 0):
                continue
            i = nb + r
            d2 = sq((col(px, b), col(py, b)), (col(px, i), col(py, i)))
            eligible = (d2 <= range2) & (col(tm, b) == 0) & (col(tm, i) == 0)
            bo, ro = col(bin_own, b), col(rin_own, r)
            p_blue = torch.where(bo == ro, p_half, torch.where(bo, p_own, p_away))
            blue_win = col(battle_u, k) < p_blue
            k += 1
            win, lose = eligible & blue_win, eligible & ~blue_win
            reward = reward + battle_reward * win.to(torch.float32)
            reward = reward - battle_reward * lose.to(torch.float32)
            tm = torch.where(agent == i, torch.maximum(tm, win.to(torch.int32)), tm)
            if t.mvn:
                tm = torch.where(agent == b, torch.maximum(tm, lose.to(torch.int32)), tm)
            else:
                # 1v1: blue losing ends the episode
                episode_term = episode_term | lose
            brl[:, r : r + 1] |= win
            bbl[:, b : b + 1] |= lose

    if t.mvn:
        episode_term = episode_term | (tm[:, :nb] == 1).all(dim=1, keepdim=True)
        reward = reward - _f32(t.step_penalty * t.n_blue, dev)
    else:
        # 1v1: standing on an obstacle cell costs and ends the episode
        if t.obstacle_penalty != 0:
            on_obs = flag(OBSTACLE_MASK, col(px, 0), col(py, 0))
            reward = reward - _f32(t.obstacle_penalty, dev) * on_obs.to(torch.float32)
            episode_term = episode_term | on_obs
        reward = reward - _f32(t.step_penalty, dev)

    def i32(x):
        return x.to(torch.int32)

    return (
        torch.stack([px, py], dim=2).reshape(B, 2 * A),
        dr_, tm, cl, reward,
        i32(episode_term), i32(rfc), i32(bfc), i32(bbl), i32(brl),
    )


def step_spec_bool(t: CtfKTables, pos, dirs, term, coll, blue_actions, rnd, flags, border, pool):
    """:func:`step_spec` with the kernel's interface: ``term``/``coll``
    (B, A) bool and the flag bytes of :func:`cell_flags` in; every flag out
    (term, coll, episode_term, rfc, bfc, bbl, brl) bool."""
    out = step_spec(t, pos, dirs, term.to(torch.int32), coll.to(torch.int32), blue_actions,
                    rnd, cell_planes(flags), border, pool)
    pos, dirs, term, coll, reward, *rest = out
    return (pos, dirs, term.to(torch.bool), coll.to(torch.bool), reward,
            *(x.to(torch.bool) for x in rest))


def _envelope_fault(t: CtfKTables, n_border: int = 0, n_pool: int = 0) -> str | None:
    """Why the step kernels do not take this config, or None where they do:
    2 to 8 agents, known policy kinds, a board of at most ``MAX_CELLS``
    cells, and patrol lists that fit their shared memory."""
    A = t.n_blue + t.n_red
    if not 2 <= A <= MAX_AGENTS:
        return f"the CtF step kernel takes 2 to {MAX_AGENTS} agents, got {A}"
    kinds = [k for k, _ in t.policies]
    if any(k not in POLICY_KINDS for k in kinds):
        return f"the CtF step kernel takes policies {POLICY_KINDS}, got {kinds}"
    if t.s0 * t.s1 > MAX_CELLS:
        return f"the CtF step kernel takes boards of at most {MAX_CELLS} cells, got {t.s0}x{t.s1}"
    if n_border > MAX_CELLS or n_pool > 4 * MAX_CELLS:
        return (f"the CtF step kernel takes at most {MAX_CELLS} border cells and "
                f"{4 * MAX_CELLS} pool entries, got {n_border} and {n_pool}")
    return None


def check_envelope(t: CtfKTables, n_border: int = 0, n_pool: int = 0):
    """Raise unless the step kernels take this config (:func:`_envelope_fault`)."""
    fault = _envelope_fault(t, n_border, n_pool)
    if fault:
        raise ValueError(fault)


def kernel_route(t: CtfKTables, device_type: str, n_border: int = 0, n_pool: int = 0) -> bool:
    """The route of a slab of ``t`` on a device of this type, decided once
    when the slab is built: True for the kernel wrappers
    (:func:`ctf_step_slab`, :func:`ctf_ms_slab`), which launch the kernels
    on the card and run their plain versions on the CPU; False for the
    plain versions called on the device's tensors directly.  The CPU takes
    every config on the first route; off the CPU only a config inside the
    kernels' envelope does (:func:`_envelope_fault`), as JAX's batch runs
    the rest as plain XLA.  Not a fallback: nothing is tried and caught."""
    return device_type == "cpu" or _envelope_fault(t, n_border, n_pool) is None


@functools.cache
def _policy_arrays(t: CtfKTables, device: torch.device):
    """Each red agent's policy kind (its index in POLICY_KINDS) and its
    probability of the optimal action, as the kernel reads them."""
    kinds = torch.tensor([POLICY_KINDS.index(k) for k, _ in t.policies], dtype=torch.int32)
    p_opt = torch.tensor([p for _, p in t.policies], dtype=torch.float32)
    return kinds.to(device), p_opt.to(device)


def ctf_step_slab(t: CtfKTables, pos, dirs, term, coll, blue_actions, rnd, flags, border, pool):
    """One transition of the batch: :func:`step_spec_bool` for CPU tensors,
    the CUDA kernel ``csrc/ctf_step.cu`` for CUDA tensors (new output
    tensors; the inputs are not changed).  Same arguments and results as
    :func:`step_spec_bool`."""
    if pos.device.type == "cpu":
        return step_spec_bool(t, pos, dirs, term, coll, blue_actions, rnd, flags, border, pool)
    if pos.device.type != "cuda":
        raise ValueError(f"no CtF step for tensors on {pos.device}")
    B, A, nb, nr = pos.shape[0], t.n_blue + t.n_red, t.n_blue, t.n_red
    n_border, n_pool = border.shape[-1], pool.shape[-1]
    check_envelope(t, n_border, n_pool)
    if B < 1:
        raise ValueError("an empty batch has nothing to step")
    dev = pos.device
    R = rnd_width(t)
    for name, x, dtype, shape in (
        ("pos", pos, torch.int32, (B, 2 * A)),
        ("dirs", dirs, torch.int32, (B, A)),
        ("term", term, torch.bool, (B, A)),
        ("coll", coll, torch.bool, (B, A)),
        ("blue_actions", blue_actions, torch.int32, (B, nb)),
        ("rnd", rnd, torch.float32, (B, R)),
        ("flags", flags, torch.uint8, (t.s0 * t.s1,)),
        ("border", border, torch.int32, (2, n_border)),
        ("pool", pool, torch.int32, (2, n_pool)),
    ):
        _build.check_arg(name, x, dtype, shape, dev)
    kinds, p_opt = _policy_arrays(t, dev)
    outs = (
        torch.empty_like(pos), torch.empty_like(dirs), torch.empty_like(term),
        torch.empty_like(coll),
        torch.empty((B, 1), dtype=torch.float32, device=dev),
        *(torch.empty((B, 1), dtype=torch.bool, device=dev) for _ in range(3)),
        torch.empty((B, nb), dtype=torch.bool, device=dev),
        torch.empty((B, nr), dtype=torch.bool, device=dev),
    )
    # Float constants: doubles rounded to float32 once, as the plain
    # version's f32() does; ctypes passes each as a C float.
    kernels = _build.load()
    with torch.cuda.device(dev):
        err = kernels.ctf_step(
            pos.data_ptr(), dirs.data_ptr(), term.data_ptr(), coll.data_ptr(),
            blue_actions.data_ptr(), rnd.data_ptr(), flags.data_ptr(),
            border.data_ptr(), pool.data_ptr(), kinds.data_ptr(), p_opt.data_ptr(),
            *(o.data_ptr() for o in outs),
            B, nb, nr, int(t.mvn), t.s0, t.s1, t.bound0, t.bound1,
            *t.blue_flag, *t.red_flag, n_border, n_pool, R,
            int(t.mvn and t.obstacle_penalty != 0),
            int(not t.mvn and t.obstacle_penalty != 0),
            t.battle_range * t.battle_range, t.randomness, 1.0 - t.randomness,
            t.flag_reward, t.battle_reward, t.obstacle_penalty,
            t.step_penalty * t.n_blue if t.mvn else t.step_penalty,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"ctf_step kernel launch failed: CUDA error {err}")
    ctf_step_slab.launches += 1
    return outs


#: Launches of the step kernel since the count was last set to 0.
ctf_step_slab.launches = 0


# ---------------------------------------------------------------------------
# Reset (no kernel: plain PyTorch on the batch's device)
# ---------------------------------------------------------------------------


def ctf_reset_inputs(cfg: CtfConfig, device="cpu"):
    """(bterr, rterr): the (2, n) int32 spawn territory lists, (row; col)
    rows in the order of ``build_tables``."""
    t = build_tables(cfg)
    bterr = np.asarray(t.blue_territory, dtype=np.int32).T.copy()
    rterr = np.asarray(t.red_territory, dtype=np.int32).T.copy()
    # reset_spec packs both coordinates of a cell into one row | col << 8
    # word; a coordinate above 255 would corrupt the other field.
    for name, terr in (("blue", bterr), ("red", rterr)):
        if terr.size and int(terr.max()) > 255:
            raise ValueError(
                f"{name} territory coordinates reach {int(terr.max())} — "
                "the packed spawn reduce supports boards up to 256x256"
            )
    return torch.as_tensor(bterr, device=device), torch.as_tensor(rterr, device=device)


def reset_spec(t: CtfKTables, rnd, bterr, rterr):
    """Spawn positions for a batch: MvN draws cells without replacement
    per team (``PickState``), 1v1 draws each agent independently.

    rnd: (B, n_blue + n_red) float32; bterr/rterr: (2, n) int32.
    Returns pos (B, 2A) int32."""
    B = rnd.shape[0]

    def draw_team(terr, n_agents, base):
        n = terr.shape[1]
        packed = terr[0] | (terr[1] << 8)
        ps = PickState.full(B, n, rnd.device)
        cols = []
        for a in range(n_agents):
            u = rnd[:, base + a : base + a + 1]
            if t.mvn:
                _, idx, ps = ps.pick(u)
            else:
                idx = ((u * n).to(torch.int32)).clamp(max=n - 1)
            p = packed[idx.long()]
            cols += [p & 255, p >> 8]
        return cols

    cols = draw_team(bterr, t.n_blue, 0) + draw_team(rterr, t.n_red, t.n_blue)
    return torch.cat(cols, dim=1)


# ---------------------------------------------------------------------------
# K steps with the auto-reset
# ---------------------------------------------------------------------------


def ms_spec(t: CtfKTables, K: int, pos, dirs, term, coll, sc, run_ret, blue_acts, rnd_step,
            rnd_reset, flags, border, pool, bterr, rterr):
    """K CtF steps with the per-env auto-reset and the return accounting,
    in plain PyTorch: ``_ctf_ms_math`` with one slice of draws a step.

    pos (B, 2A), dirs (B, A) int32; term, coll (B, A) bool; sc (B,) int32;
    run_ret (B,) float32, the return of each episode in progress;
    blue_acts (K, B, n_blue) int32 ids (clamped as by :func:`step_spec`);
    rnd_step (K, B, ``rnd_width(t)``) and rnd_reset (K, B, n_blue + n_red)
    float32, the step's and the spawn's uniforms, the spawn's drawn for
    every env whether it finished or not; flags, border and pool as for
    :func:`step_spec_bool`, bterr and rterr as for :func:`reset_spec`.
    Returns (pos, dirs, term, coll, sc, run_ret, rew_sum, ep_sum, eps): the
    state after the K steps and, per env, the sum of its rewards, the
    summed returns of the episodes it finished (float32) and how many it
    finished (int32), all (B,).  Every sum is taken one step at a time in
    JAX's order.  A finished env respawns with direction ``SPAWN_DIR``, no
    agent terminated or collided and step count 0."""
    B = pos.shape[0]
    rew_sum = torch.zeros((B,), dtype=torch.float32, device=pos.device)
    ep_sum = torch.zeros_like(rew_sum)
    eps = torch.zeros((B,), dtype=torch.int32, device=pos.device)
    for k in range(K):
        pos2, dirs2, term2, coll2, reward, ep_term, *_ = step_spec_bool(
            t, pos, dirs, term, coll, blue_acts[k], rnd_step[k], flags, border, pool)
        reward, sc2 = reward[:, 0], sc + 1
        done = ep_term[:, 0] | (sc2 >= t.max_steps)
        run2 = run_ret + reward
        rew_sum = rew_sum + reward
        ep_sum = ep_sum + torch.where(done, run2, 0.0)
        eps = eps + done.to(torch.int32)
        run_ret = torch.where(done, 0.0, run2)
        rows = done[:, None]
        pos = torch.where(rows, reset_spec(t, rnd_reset[k], bterr, rterr), pos2)
        dirs = dirs2.masked_fill(rows, SPAWN_DIR)
        term = term2 & ~rows
        coll = coll2 & ~rows
        sc = torch.where(done, 0, sc2)
    return pos, dirs, term, coll, sc, run_ret, rew_sum, ep_sum, eps


def ctf_ms_slab(slab: "CtfSlab", pos, dirs, term, coll, sc, run_ret, blue_acts, rnd_step,
                rnd_reset):
    """K = ``blue_acts.shape[0]`` steps of the batch with the auto-reset:
    :func:`ms_spec` for CPU tensors, the CUDA kernel entry ``ctf_steps`` of
    ``csrc/ctf_step.cu`` for CUDA tensors, one launch for all K steps (new
    output tensors; the inputs are not changed).  Same arguments and
    results as :func:`ms_spec`, the tables taken from ``slab``."""
    t = slab.t
    K = blue_acts.shape[0]
    if pos.device.type == "cpu":
        return ms_spec(t, K, pos, dirs, term, coll, sc, run_ret, blue_acts, rnd_step, rnd_reset,
                       slab.flags, slab.border, slab.pool, slab.bterr, slab.rterr)
    if pos.device.type != "cuda":
        raise ValueError(f"no CtF steps for tensors on {pos.device}")
    B, A, nb, nr = pos.shape[0], t.n_blue + t.n_red, t.n_blue, t.n_red
    n_border, n_pool = slab.border.shape[1], slab.pool.shape[1]
    n_bt, n_rt = slab.bterr.shape[1], slab.rterr.shape[1]
    check_envelope(t, n_border, n_pool)
    if B < 1 or K < 1:
        raise ValueError(f"nothing to step: {B} envs, {K} steps")
    dev = pos.device
    R = rnd_width(t)
    for name, x, dtype, shape in (
        ("pos", pos, torch.int32, (B, 2 * A)),
        ("dirs", dirs, torch.int32, (B, A)),
        ("term", term, torch.bool, (B, A)),
        ("coll", coll, torch.bool, (B, A)),
        ("sc", sc, torch.int32, (B,)),
        ("run_ret", run_ret, torch.float32, (B,)),
        ("blue_acts", blue_acts, torch.int32, (K, B, nb)),
        ("rnd_step", rnd_step, torch.float32, (K, B, R)),
        ("rnd_reset", rnd_reset, torch.float32, (K, B, A)),
        ("steps_table", slab.steps_table, torch.int32,
         (2 * (n_bt + n_rt) + t.bound0 * t.bound1 + t.s0 * t.s1 + n_pool,)),
    ):
        _build.check_arg(name, x, dtype, shape, dev)
    kinds, p_opt = _policy_arrays(t, dev)
    outs = (
        torch.empty_like(pos), torch.empty_like(dirs), torch.empty_like(term),
        torch.empty_like(coll), torch.empty_like(sc), torch.empty_like(run_ret),
        torch.empty_like(run_ret), torch.empty_like(run_ret), torch.empty_like(sc),
    )
    kernels = _build.load()
    with torch.cuda.device(dev):
        err = kernels.ctf_steps(
            pos.data_ptr(), dirs.data_ptr(), term.data_ptr(), coll.data_ptr(),
            sc.data_ptr(), run_ret.data_ptr(), blue_acts.data_ptr(), rnd_step.data_ptr(),
            rnd_reset.data_ptr(), slab.steps_table.data_ptr(), kinds.data_ptr(),
            p_opt.data_ptr(),
            *(o.data_ptr() for o in outs),
            B, K, nb, nr, int(t.mvn), t.s0, t.s1, t.bound0, t.bound1,
            *t.blue_flag, *t.red_flag, n_pool, R,
            int(t.mvn and t.obstacle_penalty != 0),
            int(not t.mvn and t.obstacle_penalty != 0),
            n_bt, n_rt, t.max_steps,
            t.battle_range * t.battle_range, t.randomness, 1.0 - t.randomness,
            t.flag_reward, t.battle_reward, t.obstacle_penalty,
            t.step_penalty * t.n_blue if t.mvn else t.step_penalty,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"ctf_steps kernel launch failed: CUDA error {err}")
    ctf_ms_slab.launches += 1
    return outs


#: Launches of the K-step kernel since the count was last set to 0.
ctf_ms_slab.launches = 0


# ---------------------------------------------------------------------------
# Batch glue
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class CtfSlab:
    """Everything the batch glue needs for one config on one device."""

    cfg: CtfConfig
    device: torch.device
    t: CtfKTables
    cells: torch.Tensor  # (4, N) int32
    flags: torch.Tensor  # (N,) uint8, cell_flags(cells): what the step reads
    border: torch.Tensor  # (2, nb) int32
    pool: torch.Tensor  # (2, np) int32
    bterr: torch.Tensor  # (2, n_bt) int32
    rterr: torch.Tensor  # (2, n_rt) int32
    #: The K-step kernel's static table (:func:`steps_table`), int32.
    steps_table: torch.Tensor
    #: The route (:func:`kernel_route`): the kernel wrappers, or the plain
    #: versions on the slab's device.
    kernel: bool

    @property
    def step_draws(self) -> int:
        """Uniforms one env's step takes."""
        return rnd_width(self.t)

    @property
    def reset_draws(self) -> int:
        """Uniforms one env's reset takes: one per agent."""
        return self.cfg.num_agents


def make_ctf_slab(cfg: CtfConfig, device) -> CtfSlab:
    """The slab of ``cfg`` on ``device``, its route picked by
    :func:`kernel_route`: a CUDA slab of a config outside the kernels'
    envelope runs the plain versions on the card."""
    device = torch.device(device)
    t = make_ctf_ktables(cfg)
    if any(k in ("patrol", "patrol_fight") for k, _ in t.policies) and not (
        locate_border(build_tables(cfg).fm, "red")[0]
    ):
        raise ValueError("a patrol policy needs a red border, and this map has none")
    cells, border, pool = ctf_static_inputs(cfg)
    kernel = kernel_route(t, device.type, border.shape[1], pool.shape[1])
    bterr, rterr = ctf_reset_inputs(cfg)
    table = torch.from_numpy(steps_table(t, cells.numpy(), border.numpy(), pool.numpy(),
                                         bterr.numpy(), rterr.numpy()))
    cells = cells.to(device)
    return CtfSlab(cfg, device, t, cells, cell_flags(cells), border.to(device),
                   pool.to(device), bterr.to(device), rterr.to(device), table.to(device),
                   kernel)


def step_batch(
    slab: CtfSlab,
    states: CtfState,
    blue_actions: torch.Tensor,
    *,
    generator: torch.Generator | None = None,
    rnd: torch.Tensor | None = None,
    encode_obs: bool = True,
    with_info: bool = True,
):
    """Batch-level CtF step with the scripted red policies.

    Returns (states', obs, reward (B,) float32, terminated (B,),
    truncated (B,), info).  ``rnd`` (B, ``slab.step_draws``) is used as is
    when given, else drawn from ``generator``.  ``encode_obs=False`` and
    ``with_info=False`` return None for the obs and the info, for callers
    that would throw them away."""
    t = slab.t
    B, A = states.pos.shape[0], slab.cfg.num_agents
    if rnd is None:
        rnd = torch.rand((B, slab.step_draws), generator=generator, device=slab.device)
    step = ctf_step_slab if slab.kernel else step_spec_bool
    out = step(
        t,
        states.pos.reshape(B, 2 * A),
        states.dir,
        states.terminated,
        states.collided,
        blue_actions.reshape(B, -1).to(torch.int32).contiguous(),
        rnd,
        slab.flags,
        slab.border,
        slab.pool,
    )
    return _step_result(slab, states, *out, encode_obs, with_info)


def step_actions_batch(
    slab: CtfSlab,
    states: CtfState,
    actions: torch.Tensor,
    *,
    generator: torch.Generator | None = None,
    order: torch.Tensor | None = None,
    battle_u: torch.Tensor | None = None,
    encode_obs: bool = True,
    with_info: bool = True,
):
    """Batch-level CtF step with every agent's action given, blue first:
    (B, n_blue + n_red) ids (JAX's ``step_actions_fn`` under ``vmap``).
    No kernel computes it, in either package: it is :func:`step_actions_spec`
    on the batch's device.

    ``order`` (B, A), the agent that moves in each slot, and ``battle_u``
    (B, n_blue * n_red) are used as given, else drawn from ``generator``:
    MvN a uniform order (the argsort of uniform keys), 1v1 blue then red.
    Returns what :func:`step_batch` returns."""
    t = slab.t
    B, A = states.pos.shape[0], slab.cfg.num_agents
    dev = slab.device
    if order is None:
        if t.mvn:
            keys = torch.rand((B, A), generator=generator, device=dev)
            order = keys.argsort(dim=1).to(torch.int32)
        else:
            order = torch.arange(A, dtype=torch.int32, device=dev).expand(B, A)
    if battle_u is None:
        battle_u = torch.rand((B, t.n_blue * t.n_red), generator=generator, device=dev)
    out = step_actions_spec(
        t, states.pos.reshape(B, 2 * A), states.dir, states.terminated.to(torch.int32),
        states.collided.to(torch.int32), actions.reshape(B, A).to(torch.int32), order,
        battle_u, slab.cells,
    )
    pos, dirs, term, coll, reward, ep_term, rfc, bfc, bbl, brl = out
    return _step_result(slab, states, pos, dirs, term.to(torch.bool), coll.to(torch.bool),
                        reward, ep_term.to(torch.bool), rfc.to(torch.bool), bfc.to(torch.bool),
                        bbl.to(torch.bool), brl.to(torch.bool), encode_obs, with_info)


def _step_result(slab, states, pos, dirs, term, coll, reward, ep_term, rfc, bfc, bbl, brl,
                 encode_obs, with_info):
    """The batch step's (states', obs, reward, terminated, truncated,
    info) from the transition's outputs, the flags bool."""
    B, A = states.pos.shape[0], slab.cfg.num_agents
    step_count = states.step_count + 1
    new_states = CtfState(
        pos=pos.reshape(B, A, 2),
        dir=dirs,
        terminated=term,
        collided=coll,
        step_count=step_count,
    )
    obs = encode(slab.cfg, new_states) if encode_obs else None
    step_info = None
    if with_info:
        step_info = dict(
            info(slab.cfg, new_states),
            red_flag_captured=rfc[:, 0],
            blue_flag_captured=bfc[:, 0],
            agent_terminated=new_states.terminated,
            battle_blue_lost=bbl,
            battle_red_lost=brl,
        )
    return (
        new_states, obs, reward[:, 0], ep_term[:, 0],
        step_count >= slab.t.max_steps, step_info,
    )


def reset_batch(
    slab: CtfSlab,
    num_envs: int,
    *,
    generator: torch.Generator | None = None,
    rnd: torch.Tensor | None = None,
    done: torch.Tensor | None = None,
    states: CtfState | None = None,
) -> CtfState:
    """Batch reset: spawn positions from :func:`reset_spec`, direction 3,
    no agent terminated or collided, step count 0.

    ``rnd`` (num_envs, ``slab.reset_draws``) is used as is when given, else
    drawn from ``generator``.  With ``done`` (num_envs,) bool, the result is
    ``states`` with the rows where it is True reset, in new tensors:
    ``states`` itself is not changed, so obs and info that hold views of
    it keep the pre-reset values."""
    A = slab.cfg.num_agents
    if rnd is None:
        rnd = torch.rand((num_envs, slab.reset_draws), generator=generator, device=slab.device)
    pos = reset_spec(slab.t, rnd, slab.bterr, slab.rterr).reshape(num_envs, A, 2)
    if done is None:
        def zeros(dtype, *shape):
            return torch.zeros(shape, dtype=dtype, device=slab.device)

        return CtfState(
            pos=pos,
            dir=torch.full((num_envs, A), SPAWN_DIR, dtype=torch.int32, device=slab.device),
            terminated=zeros(torch.bool, num_envs, A),
            collided=zeros(torch.bool, num_envs, A),
            step_count=zeros(torch.int32, num_envs),
        )
    rows = done[:, None]
    return CtfState(
        pos=torch.where(rows[:, :, None], pos, states.pos),
        dir=states.dir.masked_fill(rows, SPAWN_DIR),
        terminated=states.terminated.masked_fill(rows, False),
        collided=states.collided.masked_fill(rows, False),
        step_count=states.step_count.masked_fill(done, 0),
    )


# ---------------------------------------------------------------------------
# Episode rollout
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class CtfEpisodeRollout:
    """``rollout(states, num_steps)`` of a batch of CtF envs, ``chunk``
    steps a kernel launch (:func:`make_ctf_episode_rollout`)."""

    slab: CtfSlab
    num_envs: int
    generator: torch.Generator
    chunk: int

    @property
    def cfg(self) -> CtfConfig:
        return self.slab.cfg

    def reset(self, seed: int):
        """Seed the generator and reset every env: (states, obs)."""
        self.generator.manual_seed(seed)
        states = reset_batch(self.slab, self.num_envs, generator=self.generator)
        return states, encode(self.cfg, states)

    def __call__(self, states: CtfState, num_steps: int, run_return=None):
        """``num_steps`` steps with uniform random blue actions and the
        auto-reset; returns (states, metrics) with ``BatchedEnv.rollout``'s
        metrics.  Each chunk of K steps draws its (K, B, n_blue) actions,
        step uniforms and spawn uniforms in three calls and runs as one
        :func:`ctf_ms_slab` (on the plain route, :func:`ms_spec`); a last
        chunk covers ``num_steps % chunk``.
        Nothing in the loop waits for the device."""
        with annotate("rollout.call"):
            slab, B, dev, gen = self.slab, self.num_envs, self.slab.device, self.generator
            A, nb = self.cfg.num_agents, self.cfg.num_blue_agents
            run_ret = (torch.zeros((B,), dtype=torch.float32, device=dev)
                       if run_return is None else run_return)
            reward_sum = torch.zeros((), dtype=torch.float32, device=dev)
            ep_ret_sum = torch.zeros_like(reward_sum)
            episodes = torch.zeros((), dtype=torch.int32, device=dev)
            state = (states.pos.reshape(B, 2 * A), states.dir, states.terminated,
                     states.collided, states.step_count)
            for start in range(0, num_steps, self.chunk):
                with annotate("rollout.chunk"):
                    K = min(self.chunk, num_steps - start)
                    acts = torch.randint(0, NUM_ACTIONS, (K, B, nb), generator=gen, device=dev,
                                         dtype=torch.int32)
                    rnd_step = torch.rand((K, B, slab.step_draws), generator=gen, device=dev)
                    rnd_reset = torch.rand((K, B, slab.reset_draws), generator=gen, device=dev)
                    if slab.kernel:
                        out = ctf_ms_slab(slab, *state, run_ret, acts, rnd_step, rnd_reset)
                    else:
                        out = ms_spec(slab.t, K, *state, run_ret, acts, rnd_step, rnd_reset,
                                      slab.flags, slab.border, slab.pool, slab.bterr, slab.rterr)
                    *state, run_ret, rew, ep, eps = out
                    reward_sum = reward_sum + rew.sum()
                    ep_ret_sum = ep_ret_sum + ep.sum()
                    episodes = episodes + eps.sum(dtype=torch.int32)
            pos, dirs, term, coll, sc = state
            return CtfState(pos.reshape(B, A, 2), dirs, term, coll, sc), {
                "reward_sum": reward_sum,
                "episodes": episodes,
                "ep_return_sum": ep_ret_sum,
                "run_return": run_ret,
            }


def make_ctf_episode_rollout(
    cfg: CtfConfig, num_envs: int, device=None, chunk: int = 25
) -> CtfEpisodeRollout | None:
    """The CtF episode rollout: the counterpart of JAX's
    ``make_ctf_episode_rollout`` (``ops/pallas_ctf.py``), one kernel launch
    a chunk of steps instead of ``BatchedEnv``'s step launch and plain
    masked spawn draw a step.  None where JAX's gives None: more than
    ``MAX_AGENTS`` agents or a red policy outside ``POLICY_KINDS``.

    ``reset(seed)`` gives fresh states; ``rollout(states, num_steps)`` (the
    object is callable) steps them.  The default device is the current
    CUDA device; with no CUDA device and no explicit ``device`` this
    raises, and ``device="cpu"`` runs :func:`ms_spec`."""
    if cfg.num_agents > MAX_AGENTS or any(
        s.kind not in POLICY_KINDS for s in cfg.enemy_policies
    ):
        return None
    device = _build.default_device(device, "make_ctf_episode_rollout")
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")
    return CtfEpisodeRollout(
        make_ctf_slab(cfg, device), num_envs, torch.Generator(device=device), chunk
    )
