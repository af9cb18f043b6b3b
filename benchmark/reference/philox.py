"""Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1,
2, 3", SC 2011) in plain int64 tensor arithmetic, with the counter layout
the Wildfire episode draws use: counters (index, env, global step,
stream), the key the seed's low and high 32 bits.

A word ``x`` is the uniform ``(x >> 8) * 2**-24`` and the action id
``(x * 5) >> 32``.  Streams: 0 actions (word i of index 0 is agent i's),
1 the move order (word 0 of index 0), 2 the step's cell uniforms, 3 a
fresh board's tree uniforms, 4 its fire and agent picks, 5 and 6 the tree
and pick uniforms of the first reset (at step 0).  A cell ``c = l + 32 k``
takes word ``k % 4`` of index ``32 (k // 4) + l``; pick ``i`` takes word
``i % 4`` of index ``i // 4``."""

from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
MASK32 = 0xFFFFFFFF
ACTIONS, ORDER, CELLS, TREES, PICKS, FIRST_TREES, FIRST_PICKS = range(7)


def key_of(seed: int) -> tuple[int, int]:
    return seed & MASK32, seed >> 32


def _mulhilo(a, m: int):
    """(high, low) halves of ``a * m``, ``a`` below 2**32, from ``a``'s
    16-bit halves so that no product passes 2**63."""
    p, q = (a >> 16) * m, (a & 0xFFFF) * m
    return (p + (q >> 16)) >> 16, (((p & 0xFFFF) << 16) + q) & MASK32


def philox(c0, c1, c2, c3, key):
    """The four words of Philox4x32-10 for broadcast counters and key."""
    dev = next(c.device for c in (c0, c1, c2, c3) if isinstance(c, torch.Tensor))
    c0, c1, c2, c3 = torch.broadcast_tensors(
        *(torch.as_tensor(c, dtype=torch.int64, device=dev) for c in (c0, c1, c2, c3)))
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(c0, M0)
        hi1, lo1 = _mulhilo(c2, M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform(x):
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def action(x):
    return ((x * 5) >> 32).to(torch.int32)


def _counters(step: int, envs: int, device):
    b = torch.arange(envs, dtype=torch.int64, device=device)[:, None]
    return step & MASK32, b


def cell_uniforms(key, step: int, envs: int, n_cells: int, stream: int, device):
    """(B, n_cells) float32 cell uniforms of one step."""
    s, b = _counters(step, envs, device)
    groups = -(-n_cells // 128)
    index = torch.arange(32 * groups, dtype=torch.int64, device=device)
    words = philox(index, b, s, stream, key)  # each (B, 32 G), index 32 q + l
    stacked = torch.stack([w.reshape(envs, groups, 32) for w in words], dim=2)
    return uniform(stacked.reshape(envs, 128 * groups)[:, :n_cells])


def scalar_words(key, step: int, envs: int, n: int, stream: int, device):
    """(B, n) int64 words 0..n-1 of ``stream`` at one step."""
    s, b = _counters(step, envs, device)
    index = torch.arange(-(-n // 4), dtype=torch.int64, device=device)
    return torch.stack(philox(index, b, s, stream, key), dim=2).reshape(envs, -1)[:, :n]


def step_draws(key, step: int, envs: int, n_agents: int, n_cells: int, n_picks: int, device):
    """One Wildfire episode step's draws: actions (B, A) int32, the step's
    uniforms (B, 1 + C) and the fresh board's (B, C + n_picks)."""
    acts = action(scalar_words(key, step, envs, n_agents, ACTIONS, device))
    order = uniform(scalar_words(key, step, envs, 1, ORDER, device))
    cells = cell_uniforms(key, step, envs, n_cells, CELLS, device)
    trees = cell_uniforms(key, step, envs, n_cells, TREES, device)
    picks = uniform(scalar_words(key, step, envs, n_picks, PICKS, device))
    return acts, torch.cat([order, cells], dim=1), torch.cat([trees, picks], dim=1)


def first_reset_draws(key, envs: int, n_cells: int, n_picks: int, device):
    """(B, C + n_picks): the first reset's fresh-board uniforms."""
    trees = cell_uniforms(key, 0, envs, n_cells, FIRST_TREES, device)
    picks = uniform(scalar_words(key, 0, envs, n_picks, FIRST_PICKS, device))
    return torch.cat([trees, picks], dim=1)
