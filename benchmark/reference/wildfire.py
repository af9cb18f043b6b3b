"""Wildfire, written out plainly: tables from the configuration file, one
transition, a fresh board, K steps with the per-env auto-reset and the
return sums, the episode call on the Philox draws, the batch step with
the auto-reset on a ``torch.Generator``'s draws, and the observation.

Per step the agents move in the order ``perms[min(floor(u * A!), A! -
1)]`` (each blocked by any agent on its target, earlier movers at their
new cells; moves clipped to the board); a fire under an agent is put out
(+ext_reward a cell); a tree with n burning 4-neighbours (no wrap) ignites
when its uniform is below ``1 - (1 - p_spread)^n`` (-burn_penalty each);
a fire burns out when the same uniform is below ``p_burnout``; then
-step_penalty.  The episode ends when no fire is left, or at max_steps.
A fresh board: a tree where the cell's uniform is below tree_density,
the fires uniform among the trees and the agents uniform among all cells,
each without replacement."""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference import philox

EMPTY, TREE, FIRE, BURNT, AGENT = range(5)
COLORS = {"green": 3, "red": 0, "grey": 7}  # tree, fire, burnt
# action id -> (row, col) step: stay, left, down, right, up; x += col, y += row
ACTION_VEC = ((0, 0), (0, -1), (-1, 0), (0, 1), (1, 0))


@dataclass(frozen=True)
class Tables:
    width: int
    height: int
    n_agents: int
    n_fires: int
    tree_density: float
    p_burnout: float
    thresholds: tuple[float, ...]  # ignition threshold by burning-neighbour count
    ext_reward: float
    burn_penalty: float
    step_penalty: float
    max_steps: int
    agent_colors: tuple[int, ...]

    @property
    def n_cells(self) -> int:
        return self.width * self.height


def f32(v: float) -> float:
    return float(np.float32(v))


def tables(cfg: dict) -> Tables:
    """The step's constants from a configuration file's ``config``."""
    survival = [np.float32(1.0 - cfg["p_spread"]) ** k for k in range(5)]
    return Tables(
        width=cfg["size"], height=cfg["size"], n_agents=cfg["num_agents"],
        n_fires=cfg["num_initial_fires"], tree_density=cfg["tree_density"],
        p_burnout=cfg["p_burnout"],
        thresholds=(0.0,) + tuple(f32(1.0 - survival[k]) for k in range(1, 5)),
        ext_reward=cfg["ext_reward"], burn_penalty=cfg["burn_penalty"],
        step_penalty=cfg["step_penalty"], max_steps=cfg["max_steps"],
        agent_colors=tuple(cfg["agents_index"]),
    )


def _const(v, fdt, dev):
    return torch.tensor(f32(v), dtype=torch.float32, device=dev).to(fdt)


def move(t: Tables, pos, acts, u_perm, fdt):
    """(xs, ys) (B, A) after the moves in a random order."""
    A, dev = t.n_agents, pos.device
    perms = torch.tensor(list(itertools.permutations(range(A))), dtype=torch.int64, device=dev)
    n = len(perms)
    pidx = (u_perm.to(fdt) * n).to(torch.int32).clamp(0, n - 1).long()[:, 0]
    order = perms[pidx]
    xs, ys = pos[:, 0::2].clone(), pos[:, 1::2].clone()
    acts = acts.clamp(0, 4).long()
    dx = torch.tensor([v[1] for v in ACTION_VEC], dtype=torch.int32, device=dev)
    dy = torch.tensor([v[0] for v in ACTION_VEC], dtype=torch.int32, device=dev)
    agent = torch.arange(A, device=dev)[None, :]
    for slot in range(A):
        who = order[:, slot : slot + 1]
        mine = agent == who
        a = acts.gather(1, who)
        px, py = xs.gather(1, who), ys.gather(1, who)
        nx = (px + dx[a]).clamp(0, t.width - 1)
        ny = (py + dy[a]).clamp(0, t.height - 1)
        blocked = ((xs == nx) & (ys == ny)).any(dim=1, keepdim=True)
        go = ~blocked & ((nx != px) | (ny != py))
        xs = torch.where(mine & go, nx, xs)
        ys = torch.where(mine & go, ny, ys)
    return xs, ys


def burning_neighbours(t: Tables, cells):
    B, C, w = cells.shape[0], t.n_cells, t.width
    f = (cells == FIRE).reshape(B, t.height, w).to(torch.int32)
    n = torch.zeros_like(f)
    n[:, 1:, :] += f[:, :-1, :]
    n[:, :-1, :] += f[:, 1:, :]
    n[:, :, 1:] += f[:, :, :-1]
    n[:, :, :-1] += f[:, :, 1:]
    return n.reshape(B, C)


def step(t: Tables, cells, pos, acts, rnd, fdt=torch.float32):
    """One transition.  cells (B, C) int32 (``y * width + x``), pos (B, 2A)
    int32 [x0, y0, x1, ...], acts (B, A), rnd (B, 1 + C) float32.  Returns
    (cells, pos, reward (B,) in ``fdt``, put out (B,) int32, no fire left
    (B,) bool)."""
    B, dev = cells.shape[0], cells.device
    xs, ys = move(t, pos, acts, rnd[:, :1], fdt)
    under = torch.zeros_like(cells, dtype=torch.bool)
    under.scatter_(1, (ys * t.width + xs).long(), True)
    out = under & (cells == FIRE)
    n_out = out.sum(dim=1, dtype=torch.int32)
    cells = torch.where(out, BURNT, cells)
    u = rnd[:, 1:].to(fdt)
    thr = torch.tensor(t.thresholds, dtype=torch.float32, device=dev).to(fdt)
    ignite = (cells == TREE) & (u < thr[burning_neighbours(t, cells).long()])
    burnout = (cells == FIRE) & (u < _const(t.p_burnout, fdt, dev))
    n_ign = ignite.sum(dim=1, dtype=torch.int32)
    cells = torch.where(burnout, BURNT, torch.where(ignite, FIRE, cells))
    reward = (_const(t.ext_reward, fdt, dev) * n_out.to(fdt)
              - _const(t.burn_penalty, fdt, dev) * n_ign.to(fdt)
              - _const(t.step_penalty, fdt, dev))
    pos = torch.stack([xs, ys], dim=2).reshape(B, 2 * t.n_agents)
    return cells, pos, reward, n_out, ~(cells == FIRE).any(dim=1)


def _pick(free, u, fdt):
    """The ``min(floor(u * n), n - 1)``-th free cell of each row (n free
    cells): (one-hot (B, C), index (B,) int32, free after the pick).  A
    row with no free cell picks nothing and gets index 0."""
    count = free.sum(dim=1, keepdim=True, dtype=torch.int32)
    r = torch.minimum((u.to(fdt) * count.to(fdt)).to(torch.int32), count - 1)
    cum = torch.cumsum(free.to(torch.int32), dim=1)
    hit = free & (cum == r + 1)
    lane = torch.arange(free.shape[1], dtype=torch.int32, device=free.device)
    idx = torch.where(hit, lane, 0).sum(dim=1, dtype=torch.int32)
    return hit, idx, free & ~hit


def fresh(t: Tables, rnd, fdt=torch.float32):
    """Fresh boards from (B, C + n_fires + A) uniforms: (cells, pos)."""
    B, C = rnd.shape[0], t.n_cells
    trees = rnd[:, :C].to(fdt) < _const(t.tree_density, fdt, rnd.device)
    cells = torch.where(trees, TREE, EMPTY).to(torch.int32)
    free = trees
    for j in range(t.n_fires):
        hit, _, free = _pick(free, rnd[:, C + j : C + j + 1], fdt)
        cells = torch.where(hit, FIRE, cells)
    free = torch.ones_like(trees)
    cols = []
    for i in range(t.n_agents):
        _, idx, free = _pick(free, rnd[:, C + t.n_fires + i : C + t.n_fires + i + 1], fdt)
        cols += [idx % t.width, idx // t.width]
    return cells, torch.stack(cols, dim=1)


def after_step(t: Tables, state, new, reward, n_out, nofire, fresh_rnd, fdt):
    """The auto-reset: ``state`` (cells, pos, sc, ext, run_ret) stepped to
    ``new`` (cells, pos); returns (state', done, the finished episodes'
    returns (0 elsewhere))."""
    _, _, sc, ext, run_ret = state
    sc2 = sc + 1
    done = nofire | (sc2 >= t.max_steps)
    run2 = run_ret + reward
    rcells, rpos = fresh(t, fresh_rnd, fdt)
    rows = done[:, None]
    state = (torch.where(rows, rcells, new[0]), torch.where(rows, rpos, new[1]),
             torch.where(done, 0, sc2), torch.where(done, 0, ext + n_out),
             torch.where(done, torch.zeros_like(run2), run2))
    return state, done, torch.where(done, run2, torch.zeros_like(run2))


def episode_call(t: Tables, state, key, step0: int, num_steps: int, chunk: int,
                 fdt=torch.float32, count=None):
    """One call of the Wildfire episode rollout: ``num_steps`` steps from
    ``state`` (cells (B, C), pos (B, 2A), step count, put-out count, the
    running return) at global step ``step0`` of the draws keyed by
    ``key``, with uniform random actions; sums taken per env over each
    chunk of ``chunk`` steps, then over the envs.  Returns (state,
    {reward_sum, episodes, ep_return_sum}).  ``count``, a dict, gathers
    the Philox calls and words the steps need (see ``philox_need``)."""
    B, dev = state[0].shape[0], state[0].device
    z = torch.zeros((), dtype=fdt, device=dev)
    sums = {"reward_sum": z, "ep_return_sum": z.clone(),
            "episodes": torch.zeros((), dtype=torch.int32, device=dev)}
    picks = t.n_fires + t.n_agents
    for start in range(0, num_steps, chunk):
        rew = torch.zeros((B,), dtype=fdt, device=dev)
        ep, eps = torch.zeros_like(rew), torch.zeros((B,), dtype=torch.int32, device=dev)
        for k in range(start, min(start + chunk, num_steps)):
            acts, rnd, fresh_rnd = philox.step_draws(key, step0 + k, B, t.n_agents,
                                                     t.n_cells, picks, dev)
            new = step(t, state[0], state[1], acts, rnd, fdt)
            if count is not None:
                philox_need(t, state[0], new, acts, rnd, count)
            state, done, ret = after_step(t, state, new[:2], new[2], new[3], new[4],
                                          fresh_rnd, fdt)
            rew, ep, eps = rew + new[2], ep + ret, eps + done.to(torch.int32)
            if count is not None:
                count["fresh"] += int(done.sum())
        sums["reward_sum"] = sums["reward_sum"] + rew.sum()
        sums["ep_return_sum"] = sums["ep_return_sum"] + ep.sum()
        sums["episodes"] = sums["episodes"] + eps.sum(dtype=torch.int32)
    return state, sums


def philox_need(t: Tables, cells, new, acts, rnd, count):
    """Add to ``count`` the Philox calls and words one step of the episode
    kernel needs, by the counter layout: per env the actions' call (A
    words) and the move order's (1 word); the cell uniforms of each lane's
    4-cell group that holds a fire or a tree with a burning neighbour
    after the moves and the put-out (a word a cell that does)."""
    B, C = cells.shape
    under = torch.zeros_like(cells, dtype=torch.bool)
    xs, ys = new[1][:, 0::2], new[1][:, 1::2]
    under.scatter_(1, (ys * t.width + xs).long(), True)
    board = torch.where(under & (cells == FIRE), BURNT, cells)
    cand = (board == FIRE) | ((board == TREE) & (burning_neighbours(t, board) > 0))
    groups = -(-C // 128)
    cand = torch.nn.functional.pad(cand, (0, 128 * groups - C)).view(B, groups, 4, 32)
    count["calls"] += 2 * B + int(cand.any(dim=2).sum())
    count["words"] += B * (t.n_agents + 1) + int(cand.sum())


def batch_step(t: Tables, state, actions, gen, fdt=torch.float32):
    """``BatchedEnv.step`` with the auto-reset: the step's uniforms (B, 1 +
    C), then the fresh boards' (B, C + n_fires + A), both from ``gen``.
    ``state`` is (cells (B, C), pos (B, 2A), step count, put-out count).
    Returns (state', obs of the stepped boards before the reset, rewards
    (B, A), terminated, truncated)."""
    cells, pos, sc, ext = state
    B, C, A = cells.shape[0], t.n_cells, t.n_agents
    rnd = torch.rand((B, 1 + C), generator=gen, device=cells.device)
    cells2, pos2, reward, n_out, nofire = step(t, cells, pos, actions, rnd, fdt)
    sc2, ext2 = sc + 1, ext + n_out
    obs = observe(t, cells2, pos2)
    trunc = sc2 >= t.max_steps
    done = nofire | trunc
    fresh_rnd = torch.rand((B, C + t.n_fires + A), generator=gen, device=cells.device)
    rcells, rpos = fresh(t, fresh_rnd, fdt)
    rows = done[:, None]
    state = (torch.where(rows, rcells, cells2), torch.where(rows, rpos, pos2),
             torch.where(done, 0, sc2), torch.where(done, 0, ext2))
    return state, obs, (reward / A)[:, None].repeat(1, A), nofire, trunc


def first_reset(t: Tables, gen, num_envs: int, device, fdt=torch.float32):
    """``BatchedEnv.reset``'s boards from ``gen`` (seeded by the caller)."""
    rnd = torch.rand((num_envs, t.n_cells + t.n_fires + t.n_agents), generator=gen,
                     device=device)
    cells, pos = fresh(t, rnd, fdt)
    z = torch.zeros((num_envs,), dtype=torch.int32, device=device)
    return cells, pos, z, z.clone()


def observe(t: Tables, cells, pos):
    """(B, W, H, 3) uint8: (type, colour, state) x-major; trees green,
    fires red, burnt grey, each agent over its cell in agent order with
    its own colour and state 3."""
    B, dev = cells.shape[0], cells.device
    typ = cells.reshape(B, t.height, t.width).clone()
    color = torch.zeros_like(typ)
    color = torch.where(typ == TREE, COLORS["green"], color)
    color = torch.where(typ == FIRE, COLORS["red"], color)
    color = torch.where(typ == BURNT, COLORS["grey"], color)
    rows = torch.arange(B, device=dev)
    for i, c in enumerate(t.agent_colors):
        x, y = pos[:, 2 * i].long(), pos[:, 2 * i + 1].long()
        typ[rows, y, x] = AGENT
        color[rows, y, x] = c
    state = torch.where(typ == AGENT, 3, 0)
    return torch.stack([typ.transpose(1, 2), color.transpose(1, 2), state.transpose(1, 2)],
                       dim=-1).to(torch.uint8)
