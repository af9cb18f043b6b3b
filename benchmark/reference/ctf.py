"""Capture the Flag (MvN and 1v1), written out plainly: tables from the
configuration file's map, the scripted red policies ``rw``, ``fight`` and
``capture``, one transition, the spawns, K steps with the per-env
auto-reset and the return sums, the episode call and the batch step on a
``torch.Generator``'s draws, and the flattened observation.

The map is the upstream text map: 0 blue territory, 1 red, 4 the blue
flag, 5 the red flag, 6 an obstacle; position (i, j) is (text column,
text row).  Agents are blue first; a position is (row, col) of the
transposed map; moves are clipped by the upstream bounds check, row below
the map's second size and column below its first."""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

STAY, LEFT, DOWN, RIGHT, UP = range(5)
ACTION_VEC = ((0, 0), (0, -1), (-1, 0), (0, 1), (1, 0))  # (row, col) step
ACTION_DIR = (3, 3, 2, 1, 0)
SPAWN_DIR = 3
BLUE_T, RED_T, BLUE_FLAG, RED_FLAG, OBSTACLE = 0, 1, 4, 5, 6


@dataclass(frozen=True)
class Tables:
    mvn: bool
    s0: int
    s1: int
    n_blue: int
    n_red: int
    blue_flag: tuple[int, int]
    red_flag: tuple[int, int]
    blue_terr: np.ndarray  # (n, 2) row-major, the flag last
    red_terr: np.ndarray
    obstacles: np.ndarray  # (n, 2)
    planes: np.ndarray  # (4, S0 * S1): can enter, blue own, red own, obstacle
    battle_range: float
    randomness: float
    flag_reward: float
    battle_reward: float
    obstacle_penalty: float
    step_penalty: float
    max_steps: int
    policies: tuple[tuple[str, float], ...]

    @property
    def n_agents(self) -> int:
        return self.n_blue + self.n_red

    @property
    def n_perm_draws(self) -> int:
        return 1 if self.n_agents <= 4 else self.n_agents - 1

    @property
    def step_draws(self) -> int:
        """Uniforms an env's step takes: the move order, three a red
        policy, one a battle pair."""
        return self.n_perm_draws + 3 * self.n_red + self.n_blue * self.n_red


def tables(cfg: dict) -> Tables:
    """The step's tables from a configuration file's ``config``."""
    fm = np.asarray(cfg["map_rows"], dtype=np.int64).T
    blue_flag, red_flag = np.argwhere(fm == BLUE_FLAG)[0], np.argwhere(fm == RED_FLAG)[0]
    blue_terr = np.concatenate([np.argwhere(fm == BLUE_T), blue_flag[None]])
    red_terr = np.concatenate([np.argwhere(fm == RED_T), red_flag[None]])
    blue_own, red_own = fm == BLUE_T, fm == RED_T
    blue_own[tuple(blue_flag)] = red_own[tuple(red_flag)] = True
    flag_reward = cfg["flag_reward"]
    obstacle_penalty = cfg["obstacle_penalty_ratio"] * flag_reward
    can_enter = np.ones_like(blue_own) if obstacle_penalty != 0 else fm != OBSTACLE
    kinds = tuple((p["kind"], p["randomness"]) for p in cfg["enemy_policies"])
    for kind, _ in kinds:
        if kind not in ("rw", "fight", "capture"):
            raise NotImplementedError(f"the reference has no red policy {kind!r}")
    return Tables(
        mvn=cfg["variant"] == "mvn", s0=fm.shape[0], s1=fm.shape[1],
        n_blue=cfg["num_blue_agents"], n_red=cfg["num_red_agents"],
        blue_flag=tuple(int(v) for v in blue_flag), red_flag=tuple(int(v) for v in red_flag),
        blue_terr=blue_terr, red_terr=red_terr, obstacles=np.argwhere(fm == OBSTACLE),
        planes=np.stack([can_enter, blue_own, red_own, fm == OBSTACLE]).reshape(4, -1),
        battle_range=cfg["battle_range"], randomness=cfg["randomness"],
        flag_reward=flag_reward, battle_reward=cfg["battle_reward_ratio"] * flag_reward,
        obstacle_penalty=obstacle_penalty, step_penalty=cfg["step_penalty_ratio"] * flag_reward,
        max_steps=cfg["max_steps"], policies=kinds,
    )


def _c(v: float, fdt, dev):
    """A double rounded to float32 once, in ``fdt``."""
    return torch.tensor(float(np.float32(v)), dtype=torch.float32, device=dev).to(fdt)


def _sq(ar, ac, br, bc, fdt):
    dr, dc = (ar - br).to(fdt), (ac - bc).to(fdt)
    return dr * dr + dc * dc


def _toward(cr, cc, tr, tc):
    """The first step of the upstream A* path on an open board: down
    while the target row is smaller, then along the row, then up."""
    dr, dc = tr - cr, tc - cc
    along = torch.where(dc < 0, LEFT, RIGHT)
    return torch.where((dr == 0) & (dc == 0), STAY,
                       torch.where(dr < 0, DOWN, torch.where(dc != 0, along, UP)))


def red_actions(t: Tables, rows, cols, rnd, fdt):
    """(B, n_red) each red policy's action from the positions before the
    moves, with its three uniforms (target, gate, random action)."""
    nb, acts = t.n_blue, []
    for r, (kind, p_opt) in enumerate(t.policies):
        base = t.n_perm_draws + 3 * r
        u_g, u_a = rnd[:, base + 1 : base + 2].to(fdt), rnd[:, base + 2 : base + 3].to(fdt)
        rand = (u_a * 5).to(torch.int32).clamp(max=4)
        if kind == "rw":
            acts.append(rand)
            continue
        cr, cc = rows[:, nb + r : nb + r + 1], cols[:, nb + r : nb + r + 1]
        if kind == "capture":
            tr, tc = torch.full_like(cr, t.blue_flag[0]), torch.full_like(cc, t.blue_flag[1])
        else:  # fight: the closest blue agent, ties to the first
            k = _sq(rows[:, :nb], cols[:, :nb], cr, cc, fdt).argmin(dim=1, keepdim=True)
            tr, tc = rows[:, :nb].gather(1, k), cols[:, :nb].gather(1, k)
        best = _toward(cr, cc, tr, tc).to(torch.int32)
        acts.append(torch.where(u_g < _c(p_opt, fdt, rnd.device), best, rand))
    return torch.cat(acts, dim=1)


def move_order(t: Tables, rnd, fdt):
    """(B, A) the agent that moves in each slot."""
    B, A, dev = rnd.shape[0], t.n_agents, rnd.device
    agent = torch.arange(A, dtype=torch.int64, device=dev)[None, :]
    if not t.mvn:
        return agent.expand(B, A)
    if A <= 4:
        perms = torch.tensor(list(itertools.permutations(range(A))), device=dev)
        j = (rnd[:, 0].to(fdt) * len(perms)).to(torch.int32).clamp(max=len(perms) - 1)
        return perms[j.long()]
    # Fisher-Yates: slot s moves the floor(u_s * (A - s))-th agent not yet moved
    taken = torch.zeros((B, A), dtype=torch.bool, device=dev)
    order = []
    for slot in range(A):
        left = A - slot
        pick = ((rnd[:, slot : slot + 1].to(fdt) * left).to(torch.int32).clamp(max=left - 1)
                if slot < A - 1 else torch.zeros((B, 1), dtype=torch.int32, device=dev))
        rank = torch.cumsum(~taken, dim=1) - 1
        who = torch.where(~taken & (rank == pick), agent, 0).sum(dim=1, keepdim=True)
        taken |= agent == who
        order.append(who)
    return torch.cat(order, dim=1)


def step(t: Tables, state, blue_actions, rnd, fdt=torch.float32):
    """One transition.  ``state`` (pos (B, 2A) [row, col, ...], dirs (B, A),
    term, coll (B, A) bool); blue_actions (B, n_blue); rnd (B,
    ``step_draws``).  Returns (pos, dirs, term, coll, reward (B,) in
    ``fdt``, episode over (B,) bool)."""
    pos, dirs, term, coll = state
    B, nb, A, dev = pos.shape[0], t.n_blue, t.n_agents, pos.device
    planes = torch.as_tensor(t.planes, device=dev)
    rows, cols = pos[:, 0::2].clone(), pos[:, 1::2].clone()
    acts = torch.cat([blue_actions.to(torch.int32),
                      red_actions(t, rows, cols, rnd, fdt)], dim=1).clamp(0, 4).long()
    order = move_order(t, rnd, fdt)
    battle_u = rnd[:, t.n_perm_draws + 3 * t.n_red:].to(fdt)
    tm, cl, dirs = term.clone(), coll.clone(), dirs.clone()

    def on(plane, r, c):
        q = r.clamp(0, t.s0 - 1) * t.s1 + c.clamp(0, t.s1 - 1)
        return planes[plane][q.long()]

    dr = torch.tensor([v[0] for v in ACTION_VEC], device=dev)
    dc = torch.tensor([v[1] for v in ACTION_VEC], device=dev)
    to_dir = torch.tensor(ACTION_DIR, dtype=torch.int32, device=dev)
    agent = torch.arange(A, device=dev)[None, :]
    penalised = t.obstacle_penalty != 0
    for slot in range(A):
        who = order[:, slot : slot + 1]
        mine = agent == who
        a = acts.gather(1, who)
        r0, c0 = rows.gather(1, who), cols.gather(1, who)
        alive = ~tm.gather(1, who)
        nr, nc = r0 + dr[a], c0 + dc[a]
        inside = (nr >= 0) & (nc >= 0) & (nr < t.s1) & (nc < t.s0)
        taken = ((rows == nr) & (cols == nc)).any(dim=1, keepdim=True)
        if t.mvn and penalised:
            cl = cl | (mine & alive & inside & taken)
        go = mine & alive & inside & on(0, nr, nc) & ~taken
        rows, cols = torch.where(go, nr, rows).to(torch.int32), torch.where(go, nc, cols).to(torch.int32)
        dirs = torch.where(go, to_dir[a], dirs)

    reward = torch.zeros((B,), dtype=fdt, device=dev)
    over = torch.zeros((B,), dtype=torch.bool, device=dev)
    if t.mvn and penalised:
        for b in range(nb):
            reward = reward - _c(t.obstacle_penalty, fdt, dev) * cl[:, b].to(fdt)
        tm = tm | cl
    flag = _c(t.flag_reward, fdt, dev)
    on_red = (rows[:, :nb] == t.red_flag[0]) & (cols[:, :nb] == t.red_flag[1])
    on_blue = (rows[:, nb:] == t.blue_flag[0]) & (cols[:, nb:] == t.blue_flag[1])
    for b in range(nb):
        reward = reward + flag * on_red[:, b].to(fdt)
    for r in range(t.n_red):
        reward = reward - flag * on_blue[:, r].to(fdt)
    over = over | on_red.any(dim=1) | on_blue.any(dim=1)

    blue_own = on(1, rows[:, :nb], cols[:, :nb])
    red_own = on(2, rows[:, nb:], cols[:, nb:])
    battle = _c(t.battle_reward, fdt, dev)
    reach = _c(t.battle_range * t.battle_range, fdt, dev)
    half, own, away = (_c(v, fdt, dev) for v in (0.5, t.randomness, 1.0 - t.randomness))
    k = 0
    for b in range(nb):
        for r in range(t.n_red):
            if not t.mvn and (b, r) != (0, 0):
                continue
            i = nb + r
            d2 = _sq(rows[:, b], cols[:, b], rows[:, i], cols[:, i], fdt)
            fight = (d2 <= reach) & ~tm[:, b] & ~tm[:, i]
            bo, ro = blue_own[:, b], red_own[:, r]
            p_blue = torch.where(bo == ro, half, torch.where(bo, own, away))
            blue_wins = battle_u[:, k] < p_blue
            k += 1
            win, lose = fight & blue_wins, fight & ~blue_wins
            reward = reward + battle * win.to(fdt)
            reward = reward - battle * lose.to(fdt)
            tm[:, i] |= win
            if t.mvn:
                tm[:, b] |= lose
            else:
                over = over | lose
    if t.mvn:
        over = over | tm[:, :nb].all(dim=1)
        reward = reward - _c(t.step_penalty * t.n_blue, fdt, dev)
    else:
        if penalised:
            on_obstacle = on(3, rows[:, 0], cols[:, 0])
            reward = reward - _c(t.obstacle_penalty, fdt, dev) * on_obstacle.to(fdt)
            over = over | on_obstacle
        reward = reward - _c(t.step_penalty, fdt, dev)
    pos = torch.stack([rows, cols], dim=2).reshape(B, 2 * A)
    return pos, dirs, tm, cl, reward, over


def spawn(t: Tables, rnd, fdt=torch.float32):
    """(B, 2A) spawn positions from (B, A) uniforms: each team's agents on
    cells of its territory list (with the flag), MvN without replacement,
    1v1 independently."""
    B, dev = rnd.shape[0], rnd.device
    cols = []
    for terr, n_agents, base in ((t.blue_terr, t.n_blue, 0), (t.red_terr, t.n_red, t.n_blue)):
        cells = torch.as_tensor(terr, device=dev)
        n = len(terr)
        free = torch.ones((B, n), dtype=torch.bool, device=dev)
        lane = torch.arange(n, device=dev)
        for a in range(n_agents):
            u = rnd[:, base + a : base + a + 1].to(fdt)
            if t.mvn:
                count = free.sum(dim=1, keepdim=True, dtype=torch.int32)
                r = torch.minimum((u * count.to(fdt)).to(torch.int32), count - 1)
                hit = free & (torch.cumsum(free.to(torch.int32), dim=1) == r + 1)
                idx = torch.where(hit, lane, 0).sum(dim=1)
                free = free & ~hit
            else:
                idx = (u * n).to(torch.int32).clamp(max=n - 1)[:, 0].long()
            cols += [cells[idx, 0], cells[idx, 1]]
    return torch.stack(cols, dim=1).to(torch.int32)


def auto_reset(t: Tables, new, sc, run_ret, spawn_rnd, fdt):
    """The per-env auto-reset after a step ``new`` (step's outputs):
    (state', step count', run_ret', done, the finished episodes' returns)."""
    pos, dirs, tm, cl, reward, over = new
    sc2 = sc + 1
    done = over | (sc2 >= t.max_steps)
    run2 = run_ret + reward
    rows = done[:, None]
    state = (torch.where(rows, spawn(t, spawn_rnd, fdt), pos), dirs.masked_fill(rows, SPAWN_DIR),
             tm & ~rows, cl & ~rows)
    return (state, torch.where(done, 0, sc2), torch.where(done, torch.zeros_like(run2), run2),
            done, torch.where(done, run2, torch.zeros_like(run2)))


def episode_draws(t: Tables, gen, num_envs: int, K: int, device):
    """One chunk's draws, in the episode rollout's order: blue actions (K,
    B, n_blue) int32, the steps' uniforms, the spawns' uniforms."""
    acts = torch.randint(0, 5, (K, num_envs, t.n_blue), generator=gen, device=device,
                         dtype=torch.int32)
    rnd = torch.rand((K, num_envs, t.step_draws), generator=gen, device=device)
    return acts, rnd, torch.rand((K, num_envs, t.n_agents), generator=gen, device=device)


def chunk_sizes(num_steps: int, chunk: int):
    return [min(chunk, num_steps - s) for s in range(0, num_steps, chunk)]


def episode_call(t: Tables, state, sc, run_ret, gen, num_steps: int, chunk: int,
                 fdt=torch.float32):
    """One call of the CtF episode rollout from ``state`` (pos, dirs, term,
    coll), step counts ``sc`` and running returns ``run_ret``, its draws
    taken from ``gen`` a chunk at a time.  Returns (state, sc, run_ret,
    {reward_sum, episodes, ep_return_sum})."""
    B, dev = sc.shape[0], sc.device
    z = torch.zeros((), dtype=fdt, device=dev)
    sums = {"reward_sum": z, "ep_return_sum": z.clone(),
            "episodes": torch.zeros((), dtype=torch.int32, device=dev)}
    run_ret = run_ret.to(fdt)
    for K in chunk_sizes(num_steps, chunk):
        acts, rnd, spawn_rnd = episode_draws(t, gen, B, K, dev)
        rew, ep = torch.zeros((B,), dtype=fdt, device=dev), torch.zeros((B,), dtype=fdt, device=dev)
        eps = torch.zeros((B,), dtype=torch.int32, device=dev)
        for k in range(K):
            new = step(t, state, acts[k], rnd[k], fdt)
            state, sc, run_ret, done, ret = auto_reset(t, new, sc, run_ret, spawn_rnd[k], fdt)
            rew, ep, eps = rew + new[4], ep + ret, eps + done.to(torch.int32)
        sums["reward_sum"] = sums["reward_sum"] + rew.sum()
        sums["ep_return_sum"] = sums["ep_return_sum"] + ep.sum()
        sums["episodes"] = sums["episodes"] + eps.sum(dtype=torch.int32)
    return state, sc, run_ret, sums


def first_reset(t: Tables, gen, num_envs: int, device, fdt=torch.float32):
    """``reset``'s states from ``gen`` (seeded by the caller): (pos, dirs,
    term, coll), step counts."""
    pos = spawn(t, torch.rand((num_envs, t.n_agents), generator=gen, device=device), fdt)
    A = t.n_agents
    return ((pos, torch.full((num_envs, A), SPAWN_DIR, dtype=torch.int32, device=device),
             torch.zeros((num_envs, A), dtype=torch.bool, device=device),
             torch.zeros((num_envs, A), dtype=torch.bool, device=device)),
            torch.zeros((num_envs,), dtype=torch.int32, device=device))


def observe(t: Tables, pos, term):
    """(B, L) int32 flattened observation: blue then red positions, the two
    flags, the blue and red territory lists, the obstacles, then each
    agent's terminated flag (MvN; 1v1 the red agent's)."""
    B, dev = pos.shape[0], pos.device
    nb = t.n_blue

    def fixed(x):
        return torch.as_tensor(np.asarray(x, dtype=np.int32).reshape(-1), device=dev)[None].expand(B, -1)

    tail = term.to(torch.int32) if t.mvn else term[:, 1:2].to(torch.int32)
    return torch.cat([pos[:, : 2 * nb], pos[:, 2 * nb:], fixed(t.blue_flag), fixed(t.red_flag),
                      fixed(t.blue_terr), fixed(t.red_terr), fixed(t.obstacles), tail], dim=1)


def batch_step(t: Tables, state, sc, blue_actions, gen, fdt=torch.float32):
    """``BatchedEnv.step`` with the auto-reset: the step's uniforms (B,
    ``step_draws``), then the spawns' (B, A), both from ``gen``.  Returns
    (state', step count', the observation of the stepped state before the
    reset, reward (B,), terminated, truncated)."""
    B, dev = sc.shape[0], sc.device
    rnd = torch.rand((B, t.step_draws), generator=gen, device=dev)
    pos, dirs, tm, cl, reward, over = step(t, state, blue_actions, rnd, fdt)
    sc2 = sc + 1
    obs = observe(t, pos, tm)
    trunc = sc2 >= t.max_steps
    done = over | trunc
    rows = done[:, None]
    spawn_pos = spawn(t, torch.rand((B, t.n_agents), generator=gen, device=dev), fdt)
    state = (torch.where(rows, spawn_pos, pos), dirs.masked_fill(rows, SPAWN_DIR),
             tm & ~rows, cl & ~rows)
    return state, torch.where(done, 0, sc2), obs, reward, over, trunc
