"""The Maze episode path on counter-based draws, on the CPU:
``ms_philox_spec`` (the plain version of the kernel entry
``maze_steps_philox``) against ``ms_spec`` and JAX's ``_maze_ms_math`` on
the draws ``ops/philox.py`` forms, chunkings from odd steps, the counters
and the kernel's ring of draw windows walked as ``csrc/maze_step.cu``
walks them, its layout constants, the one-step kernel's table walk against ``step_spec``, the header's
stream constants, the wrapper's device rule, and the episode rollout: one
wrapper call a chunk, reproducible from a seed, and against JAX's in
distribution."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_multigrid_tpu.envs import maze as jmaze
from gym_multigrid_tpu.ops import pallas_maze as jpm
from gym_multigrid_tpu.parallel.vector import make_maze_batch as jax_make_maze_batch
from gym_multigrid_tpu_torch.envs import maze as tmaze
from gym_multigrid_tpu_torch.ops import _build, philox
from gym_multigrid_tpu_torch.ops import maze_slab as tslab

torch.set_num_threads(1)

MAZE = "tests/assets/board_maze.txt"
PENALTIES = [0.0, 0.5]


def _cfgs(**kw):
    return jmaze.MazeConfig.from_map_path(MAZE, **kw), tmaze.MazeConfig.from_map_path(MAZE, **kw)


def _start(slab, B, seed):
    """(cell, dirs, sc, run_ret, rew_sum, ep_sum, eps): spawns from the
    first reset's counters, random step counts, running returns and sums,
    made with numpy."""
    rng = np.random.default_rng(seed)
    s = tslab.reset_batch(slab, B, rnd=philox.maze_first_reset_draws(philox.key_of(seed), B,
                                                                       "cpu"))
    f32 = lambda x: torch.from_numpy(x.astype(np.float32))  # noqa: E731
    return (s.pos[:, 0] * slab.t.s1 + s.pos[:, 1], s.dir,
            torch.from_numpy(rng.integers(0, slab.t.max_steps, B).astype(np.int32)),
            f32(rng.random(B) - 0.5), f32(rng.random(B) * 4 - 2), f32(rng.random(B) * 4 - 2),
            torch.from_numpy(rng.integers(0, 5, B).astype(np.int32)))


def _unpack(slab, cell):
    return torch.stack([cell // slab.t.s1, cell % slab.t.s1], dim=1)


def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("step0", [0, 7])
@pytest.mark.parametrize("penalty", PENALTIES)
def test_ms_philox_spec_is_ms_spec_and_jax_on_the_counters_draws(penalty, step0):
    """From zero sums, ``ms_philox_spec`` gives ``ms_spec``'s results on
    ``maze_draws``' actions and uniforms, and JAX's eager ``_maze_ms_math``
    gives the same ints and float32 sums on the same draws (tolerance 0);
    episodes end inside the chunk (max_steps 5), so the auto-reset runs."""
    jcfg, tcfg = _cfgs(max_steps=5, obstacle_penalty_ratio=penalty)
    slab = tslab.make_maze_slab(tcfg, "cpu")
    B, K, key = 48, 21, philox.key_of(3)
    cell, dirs, sc, run, *_ = _start(slab, B, seed=3)
    zeros = torch.zeros(B)
    got = tslab.ms_philox_spec(slab, K, cell, dirs, sc, run, zeros, zeros,
                               torch.zeros(B, dtype=torch.int32), key, step0)
    acts, rnd = philox.maze_draws(key, step0, K, B, "cpu")
    pos = _unpack(slab, cell)
    want = tslab.ms_spec(slab.t, K, pos, dirs, sc, run, acts, rnd, slab.cells, slab.bg)
    assert torch.equal(_unpack(slab, got[0]), want[0])
    _equal(got[1:], want[1:])
    assert int(got[6].sum()) > B
    jgot = jpm._maze_ms_math(
        jmaze.maze_tables(jcfg), K, jnp.asarray(pos.numpy()), jnp.asarray(dirs.numpy()[:, None]),
        jnp.asarray(sc.numpy()[:, None]), jnp.asarray(run.numpy()[:, None]),
        (jnp.asarray(acts.numpy().T), jnp.asarray(rnd.numpy().T)),
        *jmaze.maze_static_inputs(jcfg))
    np.testing.assert_array_equal(np.asarray(jgot[0]), want[0].numpy())
    for g, w in zip(jgot[1:], want[1:]):
        g = np.asarray(g)[:, 0]
        assert g.dtype == w.numpy().dtype
        np.testing.assert_array_equal(g, w.numpy())


@pytest.mark.parametrize("penalty", PENALTIES)
def test_three_chunks_of_7_from_an_odd_step_equal_one_of_21(penalty):
    """The state and the carried sums bit for bit: a chunk boundary changes
    no draw and no addition, also where a chunk starts inside a pair of
    steps that share a Philox call."""
    _, tcfg = _cfgs(max_steps=6, obstacle_penalty_ratio=penalty)
    slab = tslab.make_maze_slab(tcfg, "cpu")
    B, key, step0 = 32, philox.key_of(11), 13
    state = _start(slab, B, seed=11)
    want = tslab.ms_philox_spec(slab, 21, *state, key, step0)
    for k0 in range(0, 21, 7):
        state = tslab.ms_philox_spec(slab, 7, *state, key, step0 + k0)
    _equal(state, want)


def test_the_counter_layout_is_the_kernels():
    """Step s of env b takes words 2 (s & 1) (the action, ``(x * 5) >>
    32``) and 2 (s & 1) + 1 (the uniform, ``(x >> 8) * 2**-24``) of the
    call (0, b, s >> 1, MAZE); the step wraps at 2**32; the first reset's
    uniform is word 0 of (0, b, 0, MAZE_FIRST)."""
    key, B = (123, 456), 3
    for step0 in (5, 2**32 - 3):
        acts, rnd = philox.maze_draws(key, step0, 6, B, "cpu")
        for k in range(6):
            s = (step0 + k) & philox.MASK32
            for b in range(B):
                w = [int(x) for x in philox.philox(0, b, s >> 1, philox.MAZE, key)]
                assert int(acts[k, b]) == (w[2 * (s & 1)] * 5) >> 32
                assert float(rnd[k, b]) == (w[2 * (s & 1) + 1] >> 8) * 2.0**-24
    first = philox.maze_first_reset_draws(key, B, "cpu")
    assert first.shape == (B, 1)
    for b in range(B):
        w = int(philox.philox(0, b, 0, philox.MAZE_FIRST, key)[0])
        assert float(first[b, 0]) == (w >> 8) * 2.0**-24


def test_action_ids_are_uniform():
    """Chi-square of the action ids over 0..4 on 40 steps of 1024 envs
    (40,960 draws, 4 degrees of freedom): below 18.47, the 0.999 quantile;
    the uniforms lie in [0, 1) with mean 1/2 within 4 standard errors."""
    acts, rnd = philox.maze_draws(philox.key_of(2024), 17, 40, 1024, "cpu")
    counts = torch.bincount(acts.flatten().long(), minlength=6).numpy()
    assert counts[5] == 0 and acts.min() >= 0
    n = acts.numel()
    chi2 = float((((counts[:5] - n / 5) ** 2) / (n / 5)).sum())
    assert chi2 < 18.47, (chi2, counts)
    assert float(rnd.min()) >= 0 and float(rnd.max()) < 1
    assert abs(float(rnd.double().mean()) - 0.5) < 4 * (1 / 12 / n) ** 0.5


def test_the_maze_streams_are_distinct_and_in_the_header():
    """``csrc/philox.cuh``'s Maze streams equal ``ops/philox.py``'s, come
    after Wildfire's seven and Collect's four and share none; the kernel's
    action map is ``(x * 5) >> 32``."""
    text = (_build.CSRC / "philox.cuh").read_text()
    consts = dict((k, int(v)) for k, v in re.findall(r"(k\w+) = (\d+)u?\b", text))
    assert (consts["kMaze"], consts["kMazeFirst"]) == (philox.MAZE, philox.MAZE_FIRST)
    streams = (philox.ACTIONS, philox.ORDER, philox.CELLS, philox.TREES, philox.PICKS,
               philox.FIRST_TREES, philox.FIRST_PICKS, philox.COLLECT_ACTIONS,
               philox.COLLECT_RND, philox.COLLECT_FRESH, philox.COLLECT_FIRST)
    assert len(set(streams)) == 11 and max(streams) < philox.MAZE < philox.MAZE_FIRST
    assert re.search(r"int action\(unsigned x\) \{ return \(int\)__umulhi\(x, 5u\); \}", text)
    assert philox.NUM_ACTIONS == tmaze.NUM_ACTIONS
    source = (_build.CSRC / "maze_step.cu").read_text()
    assert "philox::kMaze," in source and "#include \"philox.cuh\"" in source


def _shared_table(slab):
    """``ms_table`` re-encoded as the K-step kernel copies it into shared
    memory: a move entry as the byte offset of the row the move ends on
    (20 bytes a cell: five 4-byte entries) with the direction in bits
    24..26 and the termination in the sign bit, the rewards as they are,
    the spawns as their rows' byte offsets."""
    table = slab.ms_table.numpy().astype(np.int64)
    n5, n_bg = slab.t.n_cells * tmaze.NUM_ACTIONS, slab.bg.shape[1]
    e = table[:n5]
    entry = ((e >> 4) * 4 | ((e >> 1) & 7) << 24 | (e & 1) << 31).astype(np.uint32)
    return entry.view(np.int32), table[n5:2 * n5].astype(np.int32).view(np.float32), \
        table[2 * n5:2 * n5 + n_bg] * 4


def _kernel_walk(slab, W, K, state, key, step0):
    """``maze_steps_philox`` walked in Python as its threads walk it: ring
    slots of W steps, window w's slot i holding the packed draw (spawn row
    offset << 8 | 4 action) of word pair i & 1 of pair W / 2 * w + i // 2
    (counter ((step0 & ~1) + 2 pair) >> 1), its step the chunk's W w + i -
    off, steps outside the chunk skipped; then each step on the shared
    table (:func:`_shared_table`) at the position's row offset plus 4
    action, float32 sums in order."""
    t, f32 = slab.t, np.float32
    entries, rewards, spawns = _shared_table(slab)
    n_bg = spawns.shape[0]
    cell, dirs, sc, run, rew, ep, eps = (x.numpy().copy() for x in state)
    off = step0 & 1
    n_windows = (off + K + W - 1) // W
    out = [[] for _ in range(7)]
    for b in range(cell.shape[0]):
        base, d, s, r = int(cell[b]) * 20, int(dirs[b]), int(sc[b]), f32(run[b])
        rs, es, n = f32(rew[b]), f32(ep[b]), int(eps[b])

        def pair(i):
            c = (((step0 & ~1) + 2 * i) & philox.MASK32) >> 1
            w = [int(x) for x in philox.philox(0, b, c, philox.MAZE, key)]
            packed = []
            for wa, wu in ((w[0], w[1]), (w[2], w[3])):
                u = f32((wu >> 8) * 2.0**-24)
                j = min(int(u * f32(n_bg)), n_bg - 1)
                packed.append(int(spawns[j]) << 8 | ((wa * 5) >> 32) * 4)
            return packed

        for w in range(n_windows):
            slot = [v for j in range(W // 2) for v in pair(W // 2 * w + j)]
            first = W * w - off
            for i in range(W):
                if not 0 <= first + i < K:
                    continue
                draw = slot[i]
                at = (base + (draw & 0xFF)) // 4
                m, reward = int(entries[at]), rewards[at]
                nd, s2 = (m >> 24) & 7, s + 1
                done = m < 0 or s2 >= t.max_steps
                run2 = f32(r + reward)
                rs = f32(rs + reward)
                es = f32(es + (run2 if done else f32(0)))
                n += done
                r = f32(0) if done else run2
                base = draw >> 8 if done else m & 0xFFFFFF
                d = 3 if done else (nd if nd != 4 else d)
                s = 0 if done else s2
        for col, v in zip(out, (base // 20, d, s, r, rs, es, n)):
            col.append(v)
    return [np.asarray(v, dtype=x.numpy().dtype) for v, x in zip(out, state)]


@pytest.mark.parametrize("W", [8, 16, 32])
@pytest.mark.parametrize("step0, K", [(0, 16), (3, 9), (6, 5), (1, 1), (5, 40)])
def test_kernel_window_walk_equals_ms_philox_spec(W, step0, K):
    """The kernel's draw and step order, at each window it builds with,
    gives ``ms_philox_spec``'s results bit for bit: whole windows, a chunk
    starting at an odd step, ragged last windows, one step, chunks of
    several windows."""
    _, tcfg = _cfgs(max_steps=4, obstacle_penalty_ratio=0.5)
    slab = tslab.make_maze_slab(tcfg, "cpu")
    key = philox.key_of(77)
    state = _start(slab, 6, seed=77)
    want = tslab.ms_philox_spec(slab, K, *state, key, step0)
    got = _kernel_walk(slab, W, K, state, key, step0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())


def test_kernel_layout_constants():
    """The header's build knobs and the envelope: draw threads an env 1, 2
    or 4, a window of whole Philox calls, and ``MS_MAX_TABLE_BYTES`` the
    card's 232,448 bytes a block less the ring of two windows of 64 envs'
    packed draws."""
    text = (_build.CSRC / "maze_step.cu").read_text()
    producers = int(re.search(r"#define MAZE_STEPS_PRODUCERS (\d+)\n", text).group(1))
    window = int(re.search(r"#define MAZE_STEPS_WINDOW (\d+)\n", text).group(1))
    envs = int(re.search(r"constexpr int kEnvs = (\d+);", text).group(1))
    assert producers in (1, 2, 4) and window % (2 * producers) == 0
    assert re.search(r"constexpr int kRingBytes = 2 \* kWindow \* kEnvs \* 4;", text)
    assert re.search(r"constexpr int kMaxSmem = 232448;", text)
    assert re.search(r"constexpr int kRowBytes = kNumActions \* 4;", text)
    assert re.search(r"constexpr int kDirShift = 24;", text)
    assert tslab.MS_MAX_TABLE_BYTES == 232448 - 2 * window * envs * 4


@pytest.mark.parametrize("penalty", PENALTIES)
def test_step_kernel_table_walk_equals_step_spec(penalty):
    """The one-step kernel reads ``ms_table`` as this walk does: for every
    on-board cell, every direction and the ids -1..9 (-1 clips to stay, 5
    and 9 to up), entry ``cell * 5 + clip(a)`` and its reward give
    ``step_spec``'s position, direction, reward and termination bit for
    bit."""
    _, tcfg = _cfgs(obstacle_penalty_ratio=penalty)
    slab = tslab.make_maze_slab(tcfg, "cpu")
    t = slab.t
    n5 = t.n_cells * tmaze.NUM_ACTIONS
    cell = torch.arange(t.n_cells, dtype=torch.int32)
    ids = torch.arange(-1, 10, dtype=torch.int32)
    cell, d, a = (x.reshape(-1) for x in torch.meshgrid(
        cell, torch.arange(4, dtype=torch.int32), ids, indexing="ij"))
    pos = torch.stack([cell // t.s1, cell % t.s1], dim=1)
    want = tslab.step_spec(t, pos, d[:, None], a[:, None], slab.cells)
    at = (cell * 5 + a.clamp(0, 4)).long()
    e = slab.ms_table[at]
    reward = slab.ms_table[n5 + at].view(torch.float32)
    nxt, nd = (e >> 4) // 5, (e >> 1) & 7
    got = (torch.stack([nxt // t.s1, nxt % t.s1], dim=1), torch.where(nd == 4, d, nd)[:, None],
           reward[:, None], (e & 1)[:, None])
    _equal(got, want)
    assert bool(want[3].any()) and bool((want[1][:, 0] != d).any())


class _OnCard:
    """A stand-in for a CUDA tensor: the wrappers' checks before a launch
    read only its device and shape."""

    def __init__(self, t):
        self.shape, self.device = t.shape, torch.device("cuda", 0)


def test_wrapper_runs_the_plain_version_on_the_cpu_and_refuses_the_rest():
    """``maze_philox_slab`` runs ``ms_philox_spec`` on CPU tensors and
    launches nothing; it refuses "meta" tensors and, off the CPU, a map
    whose table passes ``MS_MAX_TABLE_BYTES`` (``MAZE_LARGE`` of
    ``chip_smoke.py``, 6 x 6 copies of the map, stays outside the
    envelope), before any build or launch.  The one-step wrapper takes
    every map but needs the table off the CPU."""
    _, tcfg = _cfgs(max_steps=5)
    slab = tslab.make_maze_slab(tcfg, "cpu")
    key, state = philox.key_of(1), _start(slab, 6, seed=1)
    before = tslab.maze_philox_slab.launches
    _equal(tslab.maze_philox_slab(slab, 30, *state, key, 9),
           tslab.ms_philox_spec(slab, 30, *state, key, 9))
    assert tslab.maze_philox_slab.launches == before
    with pytest.raises(ValueError, match="no Maze steps"):
        tslab.maze_philox_slab(slab, 5, *(x.to("meta") for x in state), key, 0)
    fm = np.tile(tcfg.field_map, (6, 6))
    big = tslab.make_maze_slab(tmaze.MazeConfig(map_data=tuple(map(tuple, fm.tolist()))), "cpu")
    assert big.ms_table.numel() * 4 > tslab.MS_MAX_TABLE_BYTES >= slab.ms_table.numel() * 4
    assert not tslab.kernel_route(big.t, big.bg.shape[1], "cuda")
    with pytest.raises(ValueError, match=f"at most {tslab.MS_MAX_TABLE_BYTES} bytes"):
        tslab.maze_philox_slab(big, 5, _OnCard(state[0]), *state[1:], key, 0)
    pos = torch.zeros((6, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="pass table"):
        tslab.maze_step_slab(slab.t, _OnCard(pos), None, None, slab.cells)
    assert tslab.maze_philox_slab.launches == before


def test_rollout_makes_one_wrapper_call_a_chunk_and_no_draw(monkeypatch):
    """On the kernel route a 100-step call at chunk 30 makes four
    ``maze_philox_slab`` calls (30, 30, 30, 10) at the running step count
    and no ``torch.rand`` or ``torch.randint``; on the plain route it calls
    no wrapper, with the same result."""
    import dataclasses

    roll = tslab.make_maze_episode_rollout(_cfgs(max_steps=8)[1], 8, device="cpu", chunk=30)
    assert roll.slab.kernel
    states, _ = roll.reset(seed=5)
    starts = []
    wrapper = tslab.maze_philox_slab

    def counted(slab, K, *args):
        starts.append((args[-1], K))
        return wrapper(slab, K, *args)

    def refuse(*args, **kwargs):
        raise AssertionError("the episode path drew from a torch generator")

    monkeypatch.setattr(tslab, "maze_philox_slab", counted)
    monkeypatch.setattr(torch, "rand", refuse)
    monkeypatch.setattr(torch, "randint", refuse)
    got, m = roll(states, 100)
    assert starts == [(0, 30), (30, 30), (60, 30), (90, 10)] and roll.step == 100
    plain = dataclasses.replace(roll, slab=dataclasses.replace(roll.slab, kernel=False), step=0)
    want, wm = plain(states, 100)
    assert len(starts) == 4
    assert torch.equal(got.pos, want.pos) and torch.equal(got.dir, want.dir)
    for k in m:
        assert torch.equal(m[k], wm[k]), k


def test_the_cpu_rollout_is_reproducible_from_a_seed():
    """Two rollouts reset with one seed give the same states and metrics
    over two calls; another seed gives other spawns."""
    cfg = _cfgs(max_steps=10)[1]
    runs = []
    for seed in (4, 4, 5):
        roll = tslab.make_maze_episode_rollout(cfg, 16, device="cpu", chunk=7)
        states, obs = roll.reset(seed=seed)
        out, m = [states.pos.clone(), obs], None
        for _ in range(2):
            states, m = roll(states, 30, run_return=m and m["run_return"])
            out += [states.pos, states.dir, states.step_count, *m.values()]
        runs.append(out)
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert not torch.equal(runs[0][0], runs[2][0])


def test_episode_length_and_reward_agree_with_jax_episode_rollout():
    """Mean episode length and reward per step over ten independent runs a
    side of 64 envs and 150 steps (episodes end on a flag or at 25 steps),
    against JAX's ``make_maze_episode_rollout`` (``rnd_mode="packed"``):
    the two draw their own numbers, so they agree in distribution.
    Tolerance: 4 standard errors of the difference of the two means, each
    from its ten runs' spread."""
    n, steps, runs = 64, 150, 10
    jcfg, tcfg = _cfgs(max_steps=25)
    jenv = jax_make_maze_batch(jcfg, n)
    jroll = jax.jit(lambda s, k: jpm.make_maze_episode_rollout(jcfg, chunk=25)(s, k, steps))
    roll = tslab.make_maze_episode_rollout(tcfg, n, device="cpu", chunk=25)
    sides = {"jax": ([], []), "port": ([], [])}
    for seed in range(runs):
        jstates, _ = jenv.reset(jax.random.PRNGKey(seed))
        jstates, jm = jroll(jstates, jax.random.PRNGKey(100 + seed))
        states, _ = roll.reset(seed=seed)
        states, m = roll(states, steps)
        for side, sc, metrics in (("jax", jstates.step_count, jm), ("port", states.step_count, m)):
            lengths, rewards = sides[side]
            lengths.append(float((steps - np.asarray(sc)).sum()) / int(metrics["episodes"]))
            rewards.append(float(metrics["reward_sum"]) / (n * steps))
    for i, what in enumerate(("mean episode length", "reward per step")):
        want, got = np.asarray(sides["jax"][i]), np.asarray(sides["port"][i])
        se = np.sqrt(want.var(ddof=1) / runs + got.var(ddof=1) / runs)
        assert abs(want.mean() - got.mean()) < 4 * se, (what, want.mean(), got.mean(), se)
