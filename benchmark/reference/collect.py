"""Collect, written out plainly from upstream's semantics
(Tran-Research-Group/gym-multigrid ``envs/collect_game.py``:
``CollectGameEnv.step``, ``move_agent``, ``_handle_pickup`` and
``CollectGameQuadrantsRespawn``'s placement and ``_respawn``) and the
episode path's draw layout on the Philox counters: tables from the
configuration file, a fresh board, one transition, and the episode call.

A board is three (B, C) int32 planes, cell ``y * width + x``: the object
(empty 0, wall 1, ball 2, agent 3), its colour (a wall grey 7, a ball its
colour, an agent its own) and a ball's reward slot (a placed ball its
placement index, a ball respawned in colour c the slot ``n_balls + c``;
every other cell 0); the agents' positions are (B, 2A) int32 [x0, y0, x1,
y1].  A pick among the set cells of a mask is the ``min(floor(u n), n -
1)``-th of its n set cells, in cell order.

A fresh board (the ``quadrants_respawn`` layout): walls on the perimeter;
ball b, of colour ``b // (num_balls // 3)``, at the pick of its uniform
among the empty cells of its colour's rect; agent i at (1 + i, H - 2).
Colour c's rect holds x in [x0, min(x0 + W // 2 + 1, W - 1)] and y in [y0,
min(y0 + H // 2 + 1, H - 1)], with (x0, y0) = (0, 0), (W // 2 - 1, H // 2
- 1), (W // 2 - 1, 0) (upstream's ``place_obj`` draws both ends
inclusive).

A step: the two agents move in a random order, agent 1 first where the
step's first uniform is below 0.5.  A mover's action (0 north, 1 east, 2
south, 3 west) names its target cell; it moves there if the cell holds a
ball or nothing.  A ball there is picked up: it pays its slot's reward,
and with ``respawn`` a ball of its colour appears, before the mover
enters, at the pick of the mover's uniform (the step's second for the
first mover, its third for the second) among the empty cells of the
colour's rect, the vacated cell included; a ball respawned there is
overwritten by the mover.  Episodes only truncate, at ``max_steps``.

The draws, Philox4x32-10 (``reference/philox.py``) on counters (index,
env, global step, stream) keyed by the seed: stream ``ACTIONS``, word i
of index 0 is agent i's action ``(x * 4) >> 32``; ``RND``, words 0..2 of
index 0 the step's three uniforms; ``FRESH``, the uniforms of the fresh
board every env takes after global step s where ``(s + 1) % max_steps ==
0`` (uniform i word ``i % 4`` of index ``i // 4``, one a ball, then one an
agent); ``FIRST``, the same for the first reset, at step 0.  A word x is
the uniform ``(x >> 8) * 2**-24``."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from benchmark.reference import philox

EMPTY, WALL, BALL, AGENT = range(4)
GREY = 7
#: action id -> (dx, dy): north, east, south, west
ACTION_VEC = ((0, -1), (1, 0), (0, 1), (-1, 0))
ACTIONS, RND, FRESH, FIRST = range(7, 11)


@dataclass(frozen=True)
class Tables:
    width: int
    height: int
    n_agents: int
    agent_colors: tuple[int, ...]
    agent_cells: tuple[int, ...]
    ball_colors: tuple[int, ...]  # a placed ball's colour, by placement
    slot_rewards: tuple[float, ...]  # the placed balls', then a respawn's by colour
    rects: tuple[tuple[bool, ...], ...]  # each colour's rect, by cell
    respawn: bool
    max_steps: int

    @property
    def n_cells(self) -> int:
        return self.width * self.height

    @property
    def n_uniforms(self) -> int:
        """Uniforms of a fresh board: one a ball, then one an agent."""
        return len(self.ball_colors) + self.n_agents


def tables(cfg: dict) -> Tables:
    """The constants of a configuration file's ``config``."""
    if cfg["layout"] != "quadrants_respawn" or cfg.get("fixed_horizon"):
        raise ValueError("the Collect reference holds the quadrants_respawn layout alone")
    w, h, A = cfg["size"], cfg["size"], len(cfg["agents_index"])
    if A not in (1, 2):
        raise ValueError(f"the Collect reference moves one or two agents, not {A}")
    tops = ((0, 0), (w // 2 - 1, h // 2 - 1), (w // 2 - 1, 0))
    rects = tuple(tuple(x0 <= c % w <= min(x0 + w // 2 + 1, w - 1)
                        and y0 <= c // w <= min(y0 + h // 2 + 1, h - 1) for c in range(w * h))
                  for x0, y0 in tops)
    per = cfg["num_balls"] // len(tops)
    colors = tuple(b // per for b in range(cfg["num_balls"]))
    rewards = cfg["balls_reward"]
    return Tables(
        width=w, height=h, n_agents=A, agent_colors=tuple(cfg["agents_index"]),
        agent_cells=tuple((h - 2) * w + 1 + i for i in range(A)), ball_colors=colors,
        slot_rewards=tuple([1.0] * len(colors)
                           + [float(rewards[min(c, len(rewards) - 1)]) for c in range(3)]),
        rects=rects, respawn=cfg["respawn"], max_steps=cfg["max_steps"],
    )


def pack(go, gc, gs):
    """The (B, C) int32 board of three planes, a cell ``obj + 256 colour +
    65536 slot``: what the check compares."""
    return go + 256 * gc + 65536 * gs


def pick(mask, u, fdt):
    """One-hot (B, C) of the ``min(floor(u n), n - 1)``-th set cell of each
    row of ``mask`` (n set cells), ``u`` (B,) taken in ``fdt``; a row with
    none picks nothing."""
    n = mask.sum(dim=1, dtype=torch.int32)
    r = torch.minimum((u.to(fdt) * n.to(fdt)).to(torch.int32), n - 1)
    return mask & (torch.cumsum(mask.to(torch.int32), dim=1) == (r + 1)[:, None])


def _walls(t: Tables, device):
    x = torch.arange(t.n_cells, device=device) % t.width
    y = torch.arange(t.n_cells, device=device) // t.width
    return (x == 0) | (x == t.width - 1) | (y == 0) | (y == t.height - 1)


def fresh(t: Tables, rnd, fdt=torch.float32):
    """Fresh boards from (B, n_uniforms) uniforms: (go, gc, gs, pos)."""
    B, dev = rnd.shape[0], rnd.device
    wall = _walls(t, dev).expand(B, -1)
    go = torch.where(wall, WALL, EMPTY).to(torch.int32)
    gc = torch.where(wall, GREY, 0).to(torch.int32)
    gs = torch.zeros_like(go)
    rects = torch.tensor(t.rects, device=dev)
    for b, c in enumerate(t.ball_colors):
        hit = pick(rects[c] & (go == EMPTY), rnd[:, b], fdt)
        go, gc, gs = torch.where(hit, BALL, go), torch.where(hit, c, gc), torch.where(hit, b, gs)
    lane = torch.arange(t.n_cells, device=dev)
    cols = []
    for i, cell in enumerate(t.agent_cells):
        hit = lane == cell
        go, gc, gs = (torch.where(hit, AGENT, go), torch.where(hit, t.agent_colors[i], gc),
                      torch.where(hit, 0, gs))
        cols += [cell % t.width, cell // t.width]
    pos = torch.tensor(cols, dtype=torch.int32, device=dev).expand(B, -1).clone()
    return go, gc, gs, pos


def step(t: Tables, board, acts, rnd, fdt=torch.float32):
    """One transition: ``board`` (go, gc, gs, pos), ``acts`` (B, A) ids
    0..3, ``rnd`` (B, 3) uniforms.  Returns (board, reward (B, A) in
    ``fdt``, pickups (B,) int32)."""
    go, gc, gs, pos = board
    B, C, dev = go.shape[0], t.n_cells, go.device
    lane = torch.arange(C, device=dev)[None, :]
    rows = torch.arange(B, device=dev)
    dx = torch.tensor([v[0] for v in ACTION_VEC], dtype=torch.int32, device=dev)
    dy = torch.tensor([v[1] for v in ACTION_VEC], dtype=torch.int32, device=dev)
    colors = torch.tensor(t.agent_colors, dtype=torch.int32, device=dev)
    rewards = torch.tensor(t.slot_rewards, dtype=torch.float32, device=dev).to(fdt)
    rects = torch.tensor(t.rects, device=dev)
    xs, ys = pos[:, 0::2].clone(), pos[:, 1::2].clone()
    first = (rnd[:, 0].to(fdt) < 0.5).long() if t.n_agents == 2 else torch.zeros_like(rows)
    reward = torch.zeros((B, t.n_agents), dtype=fdt, device=dev)
    picks = torch.zeros((B,), dtype=torch.int32, device=dev)
    for s in range(t.n_agents):
        i = first if s == 0 else 1 - first
        px, py, a = xs[rows, i], ys[rows, i], acts[rows, i].long()
        nx = (px + dx[a]).clamp(0, t.width - 1)
        ny = (py + dy[a]).clamp(0, t.height - 1)
        target = (ny * t.width + nx).long()
        cell, color, slot = go[rows, target], gc[rows, target], gs[rows, target]
        ball = cell == BALL
        moves = ball | (cell == EMPTY)
        at = (lane == target[:, None]) & ball[:, None]
        go, gc, gs = torch.where(at, EMPTY, go), torch.where(at, 0, gc), torch.where(at, 0, gs)
        if t.respawn:
            c = color.clamp(0, len(t.rects) - 1).long()
            hit = pick(rects[c] & (go == EMPTY), rnd[:, 1 + s], fdt) & ball[:, None]
            go, gc = torch.where(hit, BALL, go), torch.where(hit, color[:, None], gc)
            gs = torch.where(hit, len(t.ball_colors) + color[:, None], gs)
        into = (lane == target[:, None]) & moves[:, None]
        go, gs = torch.where(into, AGENT, go), torch.where(into, 0, gs)
        gc = torch.where(into, colors[i][:, None], gc)
        out = (lane == (py * t.width + px)[:, None]) & moves[:, None]
        go, gc = torch.where(out, EMPTY, go), torch.where(out, 0, gc)
        xs[rows, i] = torch.where(moves, nx, px)
        ys[rows, i] = torch.where(moves, ny, py)
        got = torch.where(ball, rewards[slot.clamp(0, len(t.slot_rewards) - 1).long()], 0)
        reward[rows, i] = reward[rows, i] + got.to(fdt)
        picks += ball.to(torch.int32)
    return (go, gc, gs, torch.stack([xs, ys], dim=2).reshape(B, -1)), reward, picks


def words(key, step0: int, S: int, envs: int, n: int, stream: int, device):
    """(S, B, n) int64 words 0..n-1 of ``stream`` at the global steps
    ``step0 .. step0 + S - 1``: word i is word ``i % 4`` of index ``i // 4``."""
    s = ((step0 + torch.arange(S, dtype=torch.int64, device=device)) & philox.MASK32)
    b = torch.arange(envs, dtype=torch.int64, device=device)
    index = torch.arange(-(-n // 4), dtype=torch.int64, device=device)
    w = philox.philox(index[None, None, :], b[None, :, None], s[:, None, None], stream, key)
    return torch.stack(w, dim=3).reshape(S, envs, -1)[..., :n]


def action(x):
    return ((x * 4) >> 32).to(torch.int32)


def first_reset(t: Tables, key, envs: int, device, fdt=torch.float32):
    """The first reset's boards: (packed board, pos)."""
    rnd = philox.uniform(words(key, 0, 1, envs, t.n_uniforms, FIRST, device)[0])
    go, gc, gs, pos = fresh(t, rnd, fdt)
    return pack(go, gc, gs), pos


def episode_call(t: Tables, board, key, step0: int, num_steps: int, fdt=torch.float32,
                 count=None):
    """One call of the Collect episode rollout: ``num_steps`` steps from
    ``board`` (go, gc, gs, pos) at global step ``step0`` of the draws keyed
    by ``key``, with uniform random actions and the fresh boards at each
    episode's end.  Returns ((packed board, pos), {reward_sum, episodes}):
    the rewards summed in ``fdt`` per env and agent over the call, then
    over them all.  ``count``, a dict, gets ``pickups``, the balls picked
    up in the call."""
    B, dev = board[0].shape[0], board[0].device
    reward = torch.zeros((B, t.n_agents), dtype=fdt, device=dev)
    picks = torch.zeros((B,), dtype=torch.int32, device=dev)
    episodes = 0
    k = 0
    while k < num_steps:
        # The steps up to and with the one that ends an episode.
        n = min(num_steps - k, t.max_steps - (step0 + k) % t.max_steps)
        acts = action(words(key, step0 + k, n, B, t.n_agents, ACTIONS, dev))
        rnd = philox.uniform(words(key, step0 + k, n, B, 3, RND, dev))
        for j in range(n):
            board, r, p = step(t, board, acts[j], rnd[j], fdt)
            reward, picks = reward + r, picks + p
        k += n
        if (step0 + k) % t.max_steps == 0:
            u = philox.uniform(words(key, step0 + k - 1, 1, B, t.n_uniforms, FRESH, dev)[0])
            board = fresh(t, u, fdt)
            episodes += B
    if count is not None:
        count["pickups"] = int(picks.sum())
    sums = {"reward_sum": reward.sum(),
            "episodes": torch.tensor(episodes, dtype=torch.int32, device=dev)}
    return (pack(*board[:3]), board[3]), sums
