"""The design of the CtF K-step kernel ``ctf_steps`` (``csrc/ctf_step.cu``,
namespace ``ms``) walked in numpy on the CPU, where no kernel runs.

A numpy model of its transition (agents as cell keys and info words, the
moves resolved in slot order on bit masks, the battles' row-major scan on
the terminated mask, the reward's float32 terms in order) is held bit for
bit to ``step_spec_bool`` and to JAX's eager ``_ctf_step_math`` on the same
numpy inputs, over chained steps of five configs.  The slab's
``steps_table`` is held to what it tabulates: the closest red-border cell
of every position an agent can hold is the one ``_red_actions``' scan
finds, on ``board.txt``, ``board_large.txt`` and a non-square board.
"""

import itertools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ctf_slab import CONFIGS, cfg_pair, non_square_map

from gym_multigrid_tpu.ops import pallas_ctf as jpc
from gym_multigrid_tpu_torch.core.constants import CTF_ACTION_TO_VEC
from gym_multigrid_tpu_torch.envs import ctf as tctf
from gym_multigrid_tpu_torch.ops import _build
from gym_multigrid_tpu_torch.ops import ctf_slab as tslab

torch.set_num_threads(1)

F = np.float32
# The kernel's action vectors and render directions: stay, left, down,
# right, up.
DX, DY, DIR = np.array([0, 0, -1, 0, 1]), np.array([0, -1, 0, 1, 0]), np.array([3, 3, 2, 1, 0])
KEY = tslab.KEY_ROW


def floor_pick(u, n):
    """min(floor(u * n), n - 1), the product rounded to float32."""
    return np.minimum((u.astype(F) * F(n)).astype(np.int64), n - 1)


def sq_dist(ar, ac, br, bc):
    dx, dy = (ar - br).astype(F), (ac - bc).astype(F)
    return dx * dx + dy * dy


def optimal_action(cr, cc, tr, tc):
    dr, dc = tr - cr, tc - cc
    along = np.where(dc < 0, tctf.A_LEFT, tctf.A_RIGHT)
    return np.where((dr == 0) & (dc == 0), tctf.A_STAY,
                    np.where(dr < 0, tctf.A_DOWN, np.where(dc != 0, along, tctf.A_UP)))


class Tables:
    """The parts of ``slab.steps_table`` the transition reads."""

    def __init__(self, slab):
        t = slab.t
        table = slab.steps_table.numpy().astype(np.int64)
        n_terr = slab.bterr.shape[1] + slab.rterr.shape[1]
        n_pos = t.bound0 * t.bound1 + t.s0 * t.s1
        self.terr = table[:2 * n_terr].reshape(-1, 2)
        self.info = table[2 * n_terr:2 * n_terr + n_pos]
        self.pool = table[2 * n_terr + n_pos:]
        assert self.pool.shape == (slab.pool.shape[1],)


def info_index(t, r, c):
    """Where the info word of position (r, c) is (``ms::info_index``)."""
    in_reach = (r >= 0) & (c >= 0) & (r < t.bound0) & (c < t.bound1)
    board = t.bound0 * t.bound1 + r.clip(0, t.s0 - 1) * t.s1 + c.clip(0, t.s1 - 1)
    return np.where(in_reach, r * t.bound1 + c, board)


def decode(t, tab, acts, u):
    """``ms::decode`` without the spawns: the movers (B, A), the actions
    (blue clamped, red random), the optimal-action gates, the pool picks
    and the three win masks."""
    B, nb, A = u.shape[0], t.n_blue, t.n_blue + t.n_red
    perm_draws = tslab.n_perm_draws(t)
    if not t.mvn:
        movers = np.tile(np.arange(A), (B, 1))
    elif A <= 4:
        perms = np.array(list(itertools.permutations(range(A))))
        movers = perms[floor_pick(u[:, 0], len(perms))]
    else:  # Fisher-Yates on a taken mask
        taken, cols = np.zeros(B, np.int64), []
        for slot in range(A):
            r_pick = floor_pick(u[:, slot], A - slot) if slot < A - 1 else np.zeros(B, np.int64)
            cnt, mover = np.zeros(B, np.int64), np.zeros(B, np.int64)
            for i in range(A):
                free = ((taken >> i) & 1) == 0
                mover = np.where(free & (cnt == r_pick), i, mover)
                cnt += free
            taken |= 1 << mover
            cols.append(mover)
        movers = np.stack(cols, axis=1)
    act = np.zeros((B, A), np.int64)
    opt = np.zeros((B, A), bool)
    pool = np.zeros((B, A), np.int64)
    act[:, :nb] = acts.clip(0, tctf.NUM_ACTIONS - 1)
    for i in range(nb, A):
        kind, p_opt = t.policies[i - nb]
        base = perm_draws + 3 * (i - nb)
        act[:, i] = floor_pick(u[:, base + 2], tctf.NUM_ACTIONS)
        opt[:, i] = (kind != "rw") & (u[:, base + 1] < F(p_opt))
        if kind in ("patrol", "patrol_fight") and len(tab.pool):
            pool[:, i] = tab.pool[floor_pick(u[:, base], len(tab.pool))]
    ub, n_pairs = perm_draws + 3 * t.n_red, t.n_blue * t.n_red if t.mvn else 1
    wins = np.zeros((3, B), np.int64)
    for k in range(n_pairs):
        for w, p in enumerate((0.5, t.randomness, 1.0 - t.randomness)):
            wins[w] |= (u[:, ub + k] < F(p)).astype(np.int64) << k
    return movers, act, opt, pool, wins


def kernel_transition(t, tab, key, info, dirs, tm, cl, acts, u):
    """``ms::transition`` over a batch: key, info, dirs (B, A) int64, tm and
    cl (B,) masks, acts (B, n_blue), u (B, rnd_width) float32.  Returns the
    new (key, info, dirs, tm, cl), the reward (B,) float32, the episode's
    end (B,) bool and how many patrolling reds stood on the border."""
    B, nb, A = key.shape[0], t.n_blue, t.n_blue + t.n_red
    key, info, dirs = key.copy(), info.copy(), dirs.copy()
    movers, act, opt, pool, wins = decode(t, tab, acts, u)
    r, c = key >> 16, key & 0xFFFF
    opp_in = ((info[:, :nb] & 4) != 0).any(axis=1)
    on_border = 0
    for i in range(nb, A):  # scripted red actions from the pre-move state
        kind = t.policies[i - nb][0]
        if kind == "rw":
            continue
        tr, tc, best = r[:, 0], c[:, 0], sq_dist(r[:, 0], c[:, 0], r[:, i], c[:, i])
        for j in range(1, nb):
            dj = sq_dist(r[:, j], c[:, j], r[:, i], c[:, i])
            closer = dj < best
            best, tr, tc = np.where(closer, dj, best), np.where(closer, r[:, j], tr), \
                np.where(closer, c[:, j], tc)
        if kind == "capture":
            tr, tc = np.full(B, t.blue_flag[0]), np.full(B, t.blue_flag[1])
        if kind in ("patrol", "patrol_fight"):
            near = ((info[:, i] >> tslab.INFO_ROW_SHIFT) & 1023) * KEY \
                + ((info[:, i] >> tslab.INFO_COL_SHIFT) & 1023)
            on_border += int((near == key[:, i]).sum())
            target = np.where(near == key[:, i], pool[:, i], near)
            patrol = np.ones(B, bool) if kind == "patrol" else ~opp_in
            tr, tc = np.where(patrol, target >> 16, tr), np.where(patrol, target & 0xFFFF, tc)
        act[:, i] = np.where(opt[:, i], optimal_action(r[:, i], c[:, i], tr, tc), act[:, i])
    # Each target, read once; can1: alive and in bounds, can3: enterable too.
    tr, tc = r + DX[act], c + DY[act]
    inb = (tr >= 0) & (tc >= 0) & (tr < t.bound0) & (tc < t.bound1)
    tinfo = tab.info[tr.clip(0, t.bound0 - 1) * t.bound1 + tc.clip(0, t.bound1 - 1)]
    tkey = tr * KEY + tc
    alive = ((tm[:, None] >> np.arange(A)) & 1) == 0
    can1 = inb & alive
    can3 = can1 & ((tinfo & 1) != 0)
    w = np.zeros((B, A), np.int64)
    for m in range(A):
        for j in range(A):
            w[:, m] |= (tkey[:, m] == key[:, j]).astype(np.int64) << j
            if j != m:
                w[:, m] |= (tkey[:, m] == tkey[:, j]).astype(np.int64) << (8 + j)
        w[:, m] |= can3[:, m].astype(np.int64) << 16 | can1[:, m].astype(np.int64) << 17
    moved, bumped = np.zeros(B, np.int64), np.zeros(B, np.int64)
    for slot in range(A):
        m = movers[:, slot]
        ws = w[np.arange(B), m]
        blocked = (((ws & ~moved) | ((ws >> 8) & moved)) & 0xFF) != 0
        moved |= np.where(((ws >> 16) & 1 == 1) & ~blocked, 1 << m, 0)
        bumped |= np.where(((ws >> 17) & 1 == 1) & blocked, 1 << m, 0)
    mv = ((moved[:, None] >> np.arange(A)) & 1) == 1
    key, info = np.where(mv, tkey, key), np.where(mv, tinfo, info)
    dirs = np.where(mv, DIR[act], dirs)
    coll_penalty = t.mvn and t.obstacle_penalty != 0
    if coll_penalty:
        cl = cl | bumped
        tm = tm | cl
    # Flags, territories, battles; the reward's terms in order, in float32.
    blue = np.arange(A) < nb
    red_flag = t.red_flag[0] * KEY + t.red_flag[1]
    blue_flag = t.blue_flag[0] * KEY + t.blue_flag[1]
    on_red = blue & (key == red_flag)
    on_blue = ~blue & (key == blue_flag)
    own = (info & np.where(blue, 2, 4)) != 0
    r, c = key >> 16, key & 0xFFFF
    reward = np.zeros(B, F)
    if coll_penalty:
        for i in range(nb):
            reward = np.where((cl >> i) & 1 == 1, reward - F(t.obstacle_penalty), reward)
    for i in range(A):
        reward = np.where(on_red[:, i], reward + F(t.flag_reward), reward)
    for i in range(A):
        reward = np.where(on_blue[:, i], reward - F(t.flag_reward), reward)
    ep_term = on_red.any(axis=1) | on_blue.any(axis=1)
    pair = 0
    for j in range(nb):
        for i in range(nb, A):
            if not t.mvn and (j, i) != (0, nb):
                continue
            which = np.where(own[:, j] == own[:, i], 0, np.where(own[:, j], 1, 2))
            win = (wins[which, np.arange(B)] >> pair) & 1 == 1
            eligible = (sq_dist(r[:, j], c[:, j], r[:, i], c[:, i])
                        <= F(t.battle_range * t.battle_range)) & ((((tm >> j) | (tm >> i)) & 1) == 0)
            battle = np.where(win, F(t.battle_reward), -F(t.battle_reward))
            reward = np.where(eligible, reward + battle, reward)
            out = np.where(win, 1 << i, (1 << j) if t.mvn else 0)
            tm = tm | np.where(eligible, out, 0)
            ep_term |= eligible & ~win & (not t.mvn)
            pair += 1
    if t.mvn:
        mask = (1 << nb) - 1
        ep_term |= (tm & mask) == mask
    elif t.obstacle_penalty != 0:
        on_obs = (info[:, 0] & 8) != 0
        reward = np.where(on_obs, reward - F(t.obstacle_penalty), reward)
        ep_term |= on_obs
    step_penalty = t.step_penalty * t.n_blue if t.mvn else t.step_penalty
    return key, info, dirs, tm, cl, reward - F(step_penalty), ep_term, on_border


def reachable_start(rng, t, tab, n):
    """(key, info, dirs, tm, cl) of n envs, every agent on a position an
    agent can hold (``agent_positions``), a tenth terminated, a tenth
    collided; in every fourth row blue agent 0 starts next to the red flag
    and the last red agent next to the blue flag."""
    A = t.n_blue + t.n_red
    rows, cols = tslab.agent_positions(t)
    pick = rng.integers(0, len(rows), (n, A))
    r, c = rows[pick], cols[pick]
    for agent, (fr, fc) in ((0, t.red_flag), (A - 1, t.blue_flag)):
        r[::4, agent] = fr
        c[::4, agent] = fc - 1 if fc > 0 else fc + 1
    key = r * KEY + c
    info = tab.info[info_index(t, r, c)]
    dirs = rng.integers(0, 4, (n, A))
    bits = 1 << np.arange(A)
    tm = ((rng.random((n, A)) < 0.1) * bits).sum(axis=1)
    cl = ((rng.random((n, A)) < 0.1) * bits).sum(axis=1)
    return key, info, dirs, tm, cl


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernel_transition_model_equals_step_spec_and_jax(name):
    jcfg, tcfg = cfg_pair(name)
    slab = tslab.make_ctf_slab(tcfg, "cpu")
    t, tab = slab.t, Tables(slab)
    jt = jpc.make_ctf_ktables(jcfg)
    jstatic = jpc.ctf_static_inputs(jcfg)
    n, steps, A = 64, 12, t.n_blue + t.n_red
    bits = 1 << np.arange(A)
    rng = np.random.default_rng(300 + sorted(CONFIGS).index(name))
    key, info, dirs, tm, cl = reachable_start(rng, t, tab, n)
    battles = flags = on_border = 0
    for _ in range(steps):
        acts = rng.integers(-2, 7, (n, t.n_blue)).astype(np.int32)
        u = rng.random((n, slab.step_draws), dtype=np.float32)
        pos = np.stack([key >> 16, key & 0xFFFF], axis=2).reshape(n, 2 * A).astype(np.int32)
        term, coll = (tm[:, None] & bits) != 0, (cl[:, None] & bits) != 0
        args = (pos, dirs.astype(np.int32), term, coll, acts, u)
        want = tslab.step_spec_bool(t, *(torch.from_numpy(x) for x in args), slab.flags,
                                    slab.border, slab.pool)
        jwant = jpc._ctf_step_math(jt, *(jnp.asarray(x) for x in (
            pos, dirs.astype(np.int32), term.astype(np.int32), coll.astype(np.int32), acts, u)),
            *jstatic)
        key, info, dirs, tm, cl, reward, ep_term, seen = kernel_transition(
            t, tab, key, info, dirs, tm, cl, acts, u)
        on_border += seen
        got = (np.stack([key >> 16, key & 0xFFFF], axis=2).reshape(n, 2 * A).astype(np.int32),
               dirs.astype(np.int32), (tm[:, None] & bits) != 0, (cl[:, None] & bits) != 0,
               reward[:, None], ep_term[:, None])
        for g, w, jw in zip(got, want[:6], jwant[:6]):
            np.testing.assert_array_equal(g, w.numpy())
            np.testing.assert_array_equal(g.astype(np.asarray(jw).dtype), np.asarray(jw))
        # The info word carried along is the one of the new cell.
        np.testing.assert_array_equal(info, tab.info[info_index(t, key >> 16, key & 0xFFFF)])
        battles += int(want[8].sum() + want[9].sum())
        flags += int(want[6].sum() + want[7].sum())
        done = ep_term
        fresh = reachable_start(rng, t, tab, n)
        key, info, dirs, tm, cl = (np.where(done[:, None] if x.ndim == 2 else done, f, x)
                                   for f, x in zip(fresh, (key, info, dirs, tm, cl)))
    assert battles > 0 and flags > 0, (battles, flags)
    if any(k in ("patrol", "patrol_fight") for k, _ in t.policies):
        assert on_border > 0


BOARDS = {
    "board": dict(board="tests/assets/board.txt"),
    "board_large": dict(board="tests/assets/board_large.txt"),
    "non_square": dict(board=None),
}


def _patrol_cfg(board):
    """A 1 v 2 config on ``board`` with both patrol kinds."""
    kw = dict(num_blue_agents=1, num_red_agents=2,
              enemy_policies=(tctf.PolicySpec("patrol", 1.0), tctf.PolicySpec("patrol_fight", 1.0)))
    if board is None:
        return tctf.CtfConfig(map_data=non_square_map(), **kw)
    return tctf.CtfConfig.from_map_path(board, **kw)


@pytest.mark.parametrize("name", sorted(BOARDS))
def test_closest_border_table_equals_red_actions_scan(name, monkeypatch):
    """Every position an agent can hold: the closest border cell the table
    gives, and "on the border" as "the closest cell is its own", are the
    target ``_red_actions`` steers a patrolling red agent to (captured at
    its call of ``_optimal_action``)."""
    cfg = _patrol_cfg(BOARDS[name]["board"])
    slab = tslab.make_ctf_slab(cfg, "cpu")
    t, tab = slab.t, Tables(slab)
    rows, cols = tslab.agent_positions(t)
    n = len(rows)
    assert n == t.bound0 * t.bound1 + t.s0 * t.s1
    if name == "non_square":
        assert (t.s0, t.s1) != (t.bound0, t.bound1)
    border = slab.border.numpy()
    near = tslab.closest_border(t, border)
    near_r = (tab.info >> tslab.INFO_ROW_SHIFT) & 1023
    near_c = (tab.info >> tslab.INFO_COL_SHIFT) & 1023
    np.testing.assert_array_equal(near_r, border[0][near])
    np.testing.assert_array_equal(near_c, border[1][near])
    # The flag byte of the board cell each position clips to.
    q = rows.clip(0, t.s0 - 1) * t.s1 + cols.clip(0, t.s1 - 1)
    np.testing.assert_array_equal(tab.info & 255, slab.flags.numpy()[q])

    targets = []
    real = tslab._optimal_action

    def spy(cr, cc, tr, tc):
        targets.append((tr.clone(), tc.clone()))
        return real(cr, cc, tr, tc)

    monkeypatch.setattr(tslab, "_optimal_action", spy)
    # Both red agents on each position, the blue agent far from red
    # territory (so patrol_fight patrols); pool pick 0, the optimal action.
    px = torch.from_numpy(np.stack([np.zeros(n), rows, rows], axis=1).astype(np.int32))
    py = torch.from_numpy(np.stack([np.zeros(n), cols, cols], axis=1).astype(np.int32))
    blue_home = slab.bterr[:, 0]
    px[:, 0], py[:, 0] = blue_home[0], blue_home[1]
    rnd = torch.zeros((n, slab.step_draws))
    tslab._red_actions(t, px, py, rnd, slab.cells, slab.border, slab.pool)
    assert len(targets) == 2
    on = (border[0][near] == rows) & (border[1][near] == cols)
    want_r = np.where(on, slab.pool[0, 0].item(), border[0][near])
    want_c = np.where(on, slab.pool[1, 0].item(), border[1][near])
    for tr, tc in targets:
        np.testing.assert_array_equal(tr[:, 0].numpy(), want_r)
        np.testing.assert_array_equal(tc[:, 0].numpy(), want_c)
    assert on.any() and not on.all()


@pytest.mark.parametrize("name", ["a_main", "d_3v3", "e_non_square"])
def test_steps_table_layout(name):
    """Each territory cell as its key and the info word of its board cell,
    then the info words, then the pool's keys."""
    _, tcfg = cfg_pair(name)
    slab = tslab.make_ctf_slab(tcfg, "cpu")
    t, tab = slab.t, Tables(slab)
    terr = torch.cat([slab.bterr, slab.rterr], dim=1).numpy().astype(np.int64)
    np.testing.assert_array_equal(tab.terr[:, 0], terr[0] * KEY + terr[1])
    np.testing.assert_array_equal(tab.terr[:, 1], tab.info[info_index(t, terr[0], terr[1])])
    assert (terr[0] < t.s0).all() and (terr[1] < t.s1).all()
    np.testing.assert_array_equal(tab.info, tslab.cell_info(t, slab.cells.numpy(),
                                                            slab.border.numpy()))
    pool = slab.pool.numpy().astype(np.int64)
    np.testing.assert_array_equal(tab.pool, pool[0] * KEY + pool[1])


def test_kernel_layout_constants_equal_python():
    """The key and the info word's fields as ``ms`` in ``csrc/ctf_step.cu``
    declares them."""
    text = (_build.CSRC / "ctf_step.cu").read_text()
    consts = {
        name: int(value)
        for decl in re.findall(r"constexpr int ([^;]*);", text)
        for name, value in re.findall(r"(k\w+) = (-?\d+)", decl)
    }
    assert consts["kRowKey"] == tslab.KEY_ROW
    assert consts["kInfoRowShift"] == tslab.INFO_ROW_SHIFT
    assert consts["kInfoColShift"] == tslab.INFO_COL_SHIFT
    # Coordinates below MAX_CELLS fit the 10-bit fields, above the flag byte.
    assert consts["kCoordMask"] + 1 >= tslab.MAX_CELLS
    assert tslab.INFO_ROW_SHIFT >= 8
    assert tslab.INFO_COL_SHIFT - tslab.INFO_ROW_SHIFT >= 10
    assert tslab.INFO_COL_SHIFT + 10 <= 31
    assert tslab.KEY_ROW >= 2 * tslab.MAX_CELLS


def test_kernel_action_tables_equal_python():
    """``ms``'s 4-bit action tables (row step + 1, column step + 1, render
    direction) against ``CTF_ACTION_TO_VEC`` and the plain step's
    directions, for the five actions."""
    text = (_build.CSRC / "ctf_step.cu").read_text()
    tables = {name: int(value, 16)
              for name, value in re.findall(r"(kRowStep|kColStep|kDirOf) = (0x[0-9a-f]+)u", text)}
    assert set(tables) == {"kRowStep", "kColStep", "kDirOf"}
    vec = CTF_ACTION_TO_VEC.tolist()
    for a in range(tctf.NUM_ACTIONS):
        def nibble(t):
            return (tables[t] >> (4 * a)) & 15
        assert (nibble("kRowStep") - 1, nibble("kColStep") - 1) == tuple(vec[a]), a
        assert nibble("kDirOf") == tslab._A2DIR[a], a
    assert (DX.tolist(), DY.tolist(), DIR.tolist()) == (
        [v[0] for v in vec], [v[1] for v in vec], list(tslab._A2DIR))
