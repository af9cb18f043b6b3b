"""Philox4x32-10, the counter-based generator of the Wildfire, Collect and
Maze episode paths, in plain PyTorch integer ops on any device, and the layout
of its counters.

Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
3", SC 2011; the Random123 library) maps a 128-bit counter and a 64-bit key
to four 32-bit words.  The CUDA entries ``wf_steps_philox`` of
``csrc/wildfire_step.cu``, ``collect_steps_philox`` of
``csrc/collect_steps.cu`` and ``maze_steps_philox`` of
``csrc/maze_step.cu`` form the same words from the same counters, so
the plain versions and the kernels draw the same numbers without either
storing them, and a seed fixes a trajectory on every device.

A word ``x`` becomes the uniform ``(x >> 8) * 2**-24``, exact in float32,
the Wildfire and Maze action id ``(x * 5) >> 32``, uniform over 0..4 up
to 5 / 2**32, and the Collect action id ``(x * 4) >> 32``, uniform over
0..3.

Counter layout, (c0, c1, c2, c3) = (index, env b, global step s, stream):

* ``ACTIONS``: index 0, word i the action of agent i (at most 4 agents);
* ``ORDER``: index 0, word 0 the move-order uniform;
* ``CELLS``: the step's cell uniforms.  Cell ``c = l + 32 k`` (lane l of the
  warp that holds the board, its word k) takes word ``k % 4`` of index
  ``32 (k // 4) + l``: one call gives a lane the uniforms of four of its
  cells;
* ``TREES``: the fresh board's tree uniforms, laid out as ``CELLS``;
* ``PICKS``: the fresh board's fire and agent picks, pick i word ``i % 4``
  of index ``i // 4``;
* ``FIRST_TREES``, ``FIRST_PICKS``: the same for the boards of the first
  reset, at step 0.

The Collect streams follow, so that no stream is shared:

* ``COLLECT_ACTIONS``: index 0, word i the action of agent i (one or two);
* ``COLLECT_RND``: index 0, words 0..2 the step's three uniforms as
  ``step_spec`` takes them: the fair-coin move order, then the respawn
  uniforms of the first and the second mover;
* ``COLLECT_FRESH``: the fresh board's reset uniforms (one a ball, then
  one an agent, or the agents first, as the plan places them), uniform i
  word ``i % 4`` of index ``i // 4``;
* ``COLLECT_FIRST``: the same for the boards of the first reset, at step 0.

The Maze streams follow Collect's:

* ``MAZE``: two words a step, one call for two steps: step s takes words
  ``2 (s & 1)`` (the action id) and ``2 (s & 1) + 1`` (the spawn uniform)
  of index 0 at step counter ``s >> 1``, so the steps 2c and 2c + 1 share
  the call (0, b, c, MAZE);
* ``MAZE_FIRST``: word 0 of index 0 at step 0, the spawn uniform of the
  first reset.

``s`` is the rollout's running step count (modulo 2**32), so how the steps
are cut into chunks changes no draw (a Maze chunk may start at an odd
step); the fresh board an env takes after
step ``s`` uses step ``s``'s ``TREES`` and ``PICKS``.  The key is the seed's
low and high 32 bits.
"""

from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
ROUNDS = 10
MASK32 = 0xFFFFFFFF

ACTIONS, ORDER, CELLS, TREES, PICKS, FIRST_TREES, FIRST_PICKS = range(7)
COLLECT_ACTIONS, COLLECT_RND, COLLECT_FRESH, COLLECT_FIRST = range(7, 11)
MAZE, MAZE_FIRST = range(11, 13)
#: Wildfire and Maze action ids the words map to, 0..NUM_ACTIONS - 1.
NUM_ACTIONS = 5
#: Collect action ids the words map to, 0..NUM_COLLECT_ACTIONS - 1.
NUM_COLLECT_ACTIONS = 4


def key_of(seed: int) -> tuple[int, int]:
    """The Philox key of a seed: its low and high 32 bits."""
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"a seed is an integer in [0, 2**64), got {seed}")
    return seed & MASK32, seed >> 32


def signed(word: int) -> int:
    """A 32-bit word as the C int that holds the same bits (how the kernel
    entries take the key and the step)."""
    word &= MASK32
    return word - (1 << 32) if word >> 31 else word


def _mulhilo(a, m: int):
    """(high, low) 32-bit halves of ``a * m`` for an int64 tensor ``a`` of
    values below 2**32 and a 32-bit constant ``m``.  The product can pass
    2**63, so it is formed from ``a``'s 16-bit halves, each product below
    2**48."""
    p, q = (a >> 16) * m, (a & 0xFFFF) * m
    return (p + (q >> 16)) >> 16, (((p & 0xFFFF) << 16) + q) & MASK32


def philox(c0, c1, c2, c3, key):
    """The four output words of Philox4x32-10 for counters (c0, c1, c2, c3)
    (int64 tensors or ints of values below 2**32, broadcast together) and
    ``key`` (k0, k1): four int64 tensors of values below 2**32."""
    dev = next((c.device for c in (c0, c1, c2, c3) if isinstance(c, torch.Tensor)), None)
    c0, c1, c2, c3 = torch.broadcast_tensors(*(torch.as_tensor(c, dtype=torch.int64, device=dev)
                                               for c in (c0, c1, c2, c3)))
    k0, k1 = key
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(c0, M0)
        hi1, lo1 = _mulhilo(c2, M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform(x):
    """Float32 uniforms in [0, 1) from words: ``(x >> 8) * 2**-24``."""
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def action(x):
    """Int32 action ids in 0..4 from words: ``(x * 5) >> 32``."""
    return ((x * NUM_ACTIONS) >> 32).to(torch.int32)


def collect_action(x):
    """Int32 Collect action ids in 0..3 from words: ``(x * 4) >> 32``."""
    return ((x * NUM_COLLECT_ACTIONS) >> 32).to(torch.int32)


def _counters(steps, envs, device):
    """int64 (S, 1, 1) step and (1, B, 1) env counters."""
    s = torch.as_tensor(steps, dtype=torch.int64, device=device) & MASK32
    b = torch.arange(envs, dtype=torch.int64, device=device)
    return s[:, None, None], b[None, :, None]


def cell_uniforms(key, steps, envs: int, n_cells: int, stream: int, device):
    """(S, B, n_cells) float32: each cell's uniform in ``stream`` (``CELLS``
    or ``TREES`` layout) for the global steps ``steps`` (S,) and envs
    0..B-1."""
    s, b = _counters(steps, envs, device)
    groups = -(-n_cells // 128)
    index = torch.arange(32 * groups, dtype=torch.int64, device=device)
    words = philox(index, b, s, stream, key)  # each (S, B, 32 G): index 32 q + l
    # cell 128 q + 32 j + l is word j of index 32 q + l
    stacked = torch.stack([w.reshape(*w.shape[:2], groups, 32) for w in words], dim=3)
    return uniform(stacked.reshape(*stacked.shape[:2], 128 * groups)[..., :n_cells])


def scalar_words(key, steps, envs: int, n: int, stream: int, device):
    """(S, B, n) int64 words 0..n-1 of ``stream``: word i is word ``i % 4``
    of index ``i // 4``."""
    s, b = _counters(steps, envs, device)
    index = torch.arange(-(-n // 4), dtype=torch.int64, device=device)
    words = torch.stack(philox(index, b, s, stream, key), dim=3)  # (S, B, n4, 4)
    return words.reshape(*words.shape[:2], -1)[..., :n]


def episode_draws(key, steps, envs: int, n_agents: int, n_cells: int, n_picks: int, device):
    """The draws of the Wildfire episode steps ``steps`` (S,) in the
    pre-drawn form ``ms_spec`` takes: actions (S, B, A) int32, the step's
    uniforms (S, B, 1 + C) [move order, one per cell] and the fresh board's
    (S, B, C + n_picks) [one per cell, then the fire and agent picks]."""
    acts = action(scalar_words(key, steps, envs, n_agents, ACTIONS, device))
    order = uniform(scalar_words(key, steps, envs, 1, ORDER, device))
    cells = cell_uniforms(key, steps, envs, n_cells, CELLS, device)
    trees = cell_uniforms(key, steps, envs, n_cells, TREES, device)
    picks = uniform(scalar_words(key, steps, envs, n_picks, PICKS, device))
    return acts, torch.cat([order, cells], dim=2), torch.cat([trees, picks], dim=2)


def first_reset_draws(key, envs: int, n_cells: int, n_picks: int, device):
    """(B, C + n_picks) float32: the first reset's fresh-board uniforms."""
    steps = torch.zeros((1,), dtype=torch.int64, device=device)
    trees = cell_uniforms(key, steps, envs, n_cells, FIRST_TREES, device)
    picks = uniform(scalar_words(key, steps, envs, n_picks, FIRST_PICKS, device))
    return torch.cat([trees, picks], dim=2)[0]


def collect_step_draws(key, steps, envs: int, n_agents: int, device):
    """The draws of the Collect episode steps ``steps`` (S,) in the form
    ``ms_spec`` takes: actions (S, B, A) int32 ids 0..3 and the step's
    uniforms (S, B, 3) float32."""
    acts = collect_action(scalar_words(key, steps, envs, n_agents, COLLECT_ACTIONS, device))
    return acts, uniform(scalar_words(key, steps, envs, 3, COLLECT_RND, device))


def collect_fresh_draws(key, steps, envs: int, n: int, device, stream: int = COLLECT_FRESH):
    """(S, B, n) float32: the ``n`` reset uniforms of the fresh board an env
    takes after each of the steps ``steps`` (S,)."""
    return uniform(scalar_words(key, steps, envs, n, stream, device))


def collect_first_reset_draws(key, envs: int, n: int, device):
    """(B, n) float32: the first reset's uniforms."""
    steps = torch.zeros((1,), dtype=torch.int64, device=device)
    return collect_fresh_draws(key, steps, envs, n, device, COLLECT_FIRST)[0]


def maze_draws(key, step0: int, K: int, envs: int, device):
    """The draws of the Maze episode steps ``step0 .. step0 + K - 1`` in
    the form ``ms_spec`` takes: action ids (K, B) int32 in 0..4 and spawn
    uniforms (K, B) float32.  Step s reads words ``2 (s & 1)`` and
    ``2 (s & 1) + 1`` of the ``MAZE`` call at step counter ``s >> 1``."""
    s = (step0 + torch.arange(K, dtype=torch.int64, device=device)) & MASK32
    b = torch.arange(envs, dtype=torch.int64, device=device)
    words = torch.stack(philox(0, b[None, :], (s >> 1)[:, None], MAZE, key), dim=2)  # (K, B, 4)
    first = (2 * (s & 1))[:, None, None].expand(K, envs, 1)
    return (action(words.gather(2, first)[..., 0]),
            uniform(words.gather(2, first + 1)[..., 0]))


def maze_first_reset_draws(key, envs: int, device):
    """(B, 1) float32: the first reset's spawn uniforms, word 0 of the
    ``MAZE_FIRST`` call at step 0."""
    b = torch.arange(envs, dtype=torch.int64, device=device)
    return uniform(philox(0, b, 0, MAZE_FIRST, key)[0])[:, None]
