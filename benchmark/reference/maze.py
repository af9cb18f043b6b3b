"""Maze, written out plainly from upstream's semantics
(Tran-Research-Group/gym-multigrid ``envs/maze.py``
``MazeSingleAgentEnv``: ``reset``, ``step`` and ``move_agent``) and the
episode path's draw layout on the Philox counters: tables from the
configuration file's map, the spawn, one transition with the per-env
auto-reset and the return sums, and the episode call.

The map is the upstream text map: 0 background, 2 a flag, 3 an obstacle;
position (i, j) is (text column, text row), the transposed map.  One
agent; its actions 0..4 are stay, left, down, right, up, the (row, col)
steps of ``ACTION_VEC``, ids outside 0..4 clipped into them.  A move that
stays on the map and does not enter an obstacle (any cell can be entered
when the obstacle penalty is on) is made and turns the agent to its
``ACTION_DIR``; any other move, and stay, leaves position and direction.
On a flag the step pays ``+flag_reward`` and ends the episode; on an
obstacle, with the penalty on, it pays ``-obstacle_penalty`` and ends it;
every step pays ``-step_penalty``.  An episode is truncated when its step
count reaches ``max_steps``.  A finished env spawns at once, on the
``min(floor(u n), n - 1)``-th of the map's n background cells (row-major
on the transposed map), facing ``SPAWN_DIR``, its step count 0.

The draws, Philox4x32-10 (``reference/philox.py``) on counters (index,
env, counter, stream) keyed by the seed: stream ``MAZE`` serves two steps
a call, global step s reading words ``2 (s & 1)`` (the action ``(x * 5)
>> 32``) and ``2 (s & 1) + 1`` (the spawn uniform) of index 0 at counter
``s >> 1``; ``MAZE_FIRST``, word 0 of index 0 at counter 0, the first
reset's spawn uniform.  A word x is the uniform ``(x >> 8) * 2**-24``.

Departures from upstream, none of which this map or configuration shows
but the last three:
- upstream's bounds check (``maze.py:290-295``) tests the row against the
  map's second size and the column against its first; here the natural
  order, row against the first.  On a square map they agree;
- upstream's spawn draws from numpy's global stream, here from the
  counters; and upstream has no auto-reset, which the batch adds;
- upstream computes the rewards in float64; here each float constant is
  rounded to float32 once (``fdt`` float32), and the rewards and sums are
  taken in ``fdt``."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference import philox

BACKGROUND, FLAG, OBSTACLE = 0, 2, 3
ACTION_VEC = ((0, 0), (0, -1), (-1, 0), (0, 1), (1, 0))  # (row, col) step
ACTION_DIR = (3, 3, 2, 1, 0)
SPAWN_DIR = 3
NUM_ACTIONS = 5
MAZE, MAZE_FIRST = 11, 12


@dataclass(frozen=True)
class Tables:
    s0: int
    s1: int
    background: np.ndarray  # (n, 2) row-major: the spawn cells
    can_enter: np.ndarray  # (s0, s1) bool
    flag: np.ndarray
    obstacle: np.ndarray
    flag_reward: float
    obstacle_penalty: float
    step_penalty: float
    max_steps: int


def f32(v: float) -> float:
    return float(np.float32(v))


def tables(cfg: dict) -> Tables:
    """The step's constants from a configuration file's ``config``."""
    fm = np.asarray(cfg["map_rows"], dtype=np.int64).T
    flag_reward = cfg["flag_reward"]
    obstacle_penalty = cfg["obstacle_penalty_ratio"] * flag_reward
    return Tables(
        s0=fm.shape[0], s1=fm.shape[1], background=np.argwhere(fm == BACKGROUND),
        can_enter=np.ones(fm.shape, bool) if obstacle_penalty != 0 else fm != OBSTACLE,
        flag=fm == FLAG, obstacle=fm == OBSTACLE, flag_reward=flag_reward,
        obstacle_penalty=obstacle_penalty,
        step_penalty=cfg["step_penalty_ratio"] * flag_reward, max_steps=cfg["max_steps"],
    )


def _const(v: float, fdt, dev):
    return torch.tensor(f32(v), dtype=torch.float32, device=dev).to(fdt)


def spawn(t: Tables, u, fdt=torch.float32):
    """(B, 2) int32 spawn cells of (B,) uniforms taken in ``fdt``."""
    n = len(t.background)
    j = torch.clamp((u.to(fdt) * n).to(torch.int32), max=n - 1)
    return torch.as_tensor(t.background, dtype=torch.int32, device=u.device)[j.long()]


def step(t: Tables, pos, dirs, acts, fdt=torch.float32):
    """One transition: pos (B, 2) int32 (row, col), dirs (B,) int32, acts
    (B,) int32 ids.  Returns (pos, dirs, reward (B,) in ``fdt``,
    terminated (B,) bool)."""
    dev = pos.device
    a = acts.clamp(0, NUM_ACTIONS - 1).long()
    vec = torch.tensor(ACTION_VEC, dtype=torch.int32, device=dev)
    nxt = pos + vec[a]
    inb = (nxt[:, 0] >= 0) & (nxt[:, 0] < t.s0) & (nxt[:, 1] >= 0) & (nxt[:, 1] < t.s1)
    r, c = nxt[:, 0].clamp(0, t.s0 - 1).long(), nxt[:, 1].clamp(0, t.s1 - 1).long()
    moves = inb & torch.as_tensor(t.can_enter, device=dev)[r, c] & (a != 0)
    pos = torch.where(moves[:, None], nxt, pos)
    turn = torch.tensor(ACTION_DIR, dtype=torch.int32, device=dev)[a]
    dirs = torch.where(moves, turn, dirs)
    r, c = pos[:, 0].clamp(0, t.s0 - 1).long(), pos[:, 1].clamp(0, t.s1 - 1).long()
    on_flag = torch.as_tensor(t.flag, device=dev)[r, c]
    zero = torch.zeros((), dtype=fdt, device=dev)
    reward = torch.where(on_flag, _const(t.flag_reward, fdt, dev), zero)
    term = on_flag
    if t.obstacle_penalty != 0:
        on_obstacle = torch.as_tensor(t.obstacle, device=dev)[r, c]
        reward = reward - torch.where(on_obstacle, _const(t.obstacle_penalty, fdt, dev), zero)
        term = term | on_obstacle
    return pos, dirs, reward - _const(t.step_penalty, fdt, dev), term


def draws(key, step0: int, K: int, envs: int, device):
    """The actions (K, B) int32 and spawn uniforms (K, B) float32 of the
    global steps ``step0 .. step0 + K - 1``."""
    s = (step0 + torch.arange(K, dtype=torch.int64, device=device)) & philox.MASK32
    b = torch.arange(envs, dtype=torch.int64, device=device)
    words = torch.stack(philox.philox(0, b[None, :], (s >> 1)[:, None], MAZE, key), dim=2)
    first = (2 * (s & 1))[:, None, None].expand(K, envs, 1)
    return (philox.action(words.gather(2, first)[..., 0]),
            philox.uniform(words.gather(2, first + 1)[..., 0]))


def first_reset(t: Tables, key, envs: int, device, fdt=torch.float32):
    """The first reset: (packed cell, direction, step count), each (B,)."""
    b = torch.arange(envs, dtype=torch.int64, device=device)
    u = philox.uniform(philox.philox(0, b, 0, MAZE_FIRST, key)[0])
    pos = spawn(t, u, fdt)
    z = torch.zeros((envs,), dtype=torch.int32, device=device)
    return pack(pos), z + SPAWN_DIR, z


def pack(pos):
    """(B,) int32 cells ``row << 16 | col``: what the check compares."""
    return pos[:, 0] * 65536 + pos[:, 1]


#: Steps whose draws are formed at once: (K, B, 4) int64 words.
DRAW_BLOCK = 128


def episode_call(t: Tables, state, key, step0: int, num_steps: int, fdt=torch.float32):
    """One call of the Maze episode rollout: ``num_steps`` steps from
    ``state`` (pos (B, 2), dirs, step count, the running return in
    ``fdt``) at global step ``step0`` of the draws keyed by ``key``, with
    the auto-reset.  Each env's reward, finished-episode return and
    episode count are summed one step at a time over the call, then over
    the envs.  Returns ((packed cell, dirs, step count), running return,
    {reward_sum, ep_return_sum, episodes})."""
    pos, dirs, sc, run = state
    B, dev = pos.shape[0], pos.device
    rew = torch.zeros((B,), dtype=fdt, device=dev)
    ep, eps = torch.zeros_like(rew), torch.zeros((B,), dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=fdt, device=dev)
    for start in range(0, num_steps, DRAW_BLOCK):
        K = min(DRAW_BLOCK, num_steps - start)
        acts, u = draws(key, step0 + start, K, B, dev)
        for k in range(K):
            pos2, dirs2, reward, term = step(t, pos, dirs, acts[k], fdt)
            sc2 = sc + 1
            done = term | (sc2 >= t.max_steps)
            run2 = run + reward
            rew = rew + reward
            ep = ep + torch.where(done, run2, zero)
            eps = eps + done.to(torch.int32)
            run = torch.where(done, zero, run2)
            pos = torch.where(done[:, None], spawn(t, u[k], fdt), pos2)
            dirs = torch.where(done, SPAWN_DIR, dirs2)
            sc = torch.where(done, 0, sc2)
    sums = {"reward_sum": rew.sum(), "ep_return_sum": ep.sum(),
            "episodes": eps.sum(dtype=torch.int32)}
    return (pack(pos), dirs, sc), run, sums
