"""The port's Maze episode path on the CPU: ``ms_spec`` (K steps with the
auto-reset) against the eager JAX episode math bit for bit, chained chunks
against one long run, the kernel's table walked as the kernel walks it,
``maze_philox_slab``'s CPU rule, and ``make_maze_episode_rollout``'s
invariants, draws and episode lengths against the JAX episode rollout."""

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


def _cfgs(**kw):
    return jmaze.MazeConfig.from_map_path(MAZE, **kw), tmaze.MazeConfig.from_map_path(MAZE, **kw)


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _inputs(slab, B, K, seed):
    """Start states on the background, running returns, ids -2..9 and
    spawn uniforms, made with numpy."""
    rng = np.random.default_rng(seed)
    bg = slab.bg.numpy().T
    pos = bg[rng.integers(0, len(bg), B)].astype(np.int32)
    dirs = rng.integers(0, 4, B).astype(np.int32)
    sc = rng.integers(0, slab.t.max_steps, B).astype(np.int32)
    run = (rng.random(B, dtype=np.float32) - np.float32(0.5)).astype(np.float32)
    acts = rng.integers(-2, 10, (K, B)).astype(np.int32)
    rnd = rng.random((K, B), dtype=np.float32)
    return pos, dirs, sc, run, acts, rnd


def _jax_ms(jcfg, K, pos, dirs, sc, run, acts, rnd):
    """The eager ``_maze_ms_math`` on its (B, K) tuple form."""
    return jpm._maze_ms_math(
        jmaze.maze_tables(jcfg), K, jnp.asarray(pos), jnp.asarray(dirs[:, None]),
        jnp.asarray(sc[:, None]), jnp.asarray(run[:, None]),
        (jnp.asarray(acts.T), jnp.asarray(rnd.T)), *jmaze.maze_static_inputs(jcfg),
    )


def _torch_ms(slab, K, pos, dirs, sc, run, acts, rnd):
    return tslab.ms_spec(
        slab.t, K, *(torch.from_numpy(x.copy()) for x in (pos, dirs, sc, run, acts, rnd)),
        slab.cells, slab.bg,
    )


@pytest.mark.parametrize("K", [1, 7, 25])
@pytest.mark.parametrize("penalty", [0.0, 0.5])
def test_ms_spec_matches_jax_episode_math(K, penalty):
    """State, running returns and the per-env sums bit for bit; episodes end
    inside K (max_steps 4), so the auto-reset runs."""
    jcfg, tcfg = _cfgs(max_steps=4, obstacle_penalty_ratio=penalty)
    slab = tslab.make_maze_slab(tcfg, "cpu")
    B = 48
    args = _inputs(slab, B, K, seed=K)
    want = _jax_ms(jcfg, K, *args)
    got = _torch_ms(slab, K, *args)
    w_pos, w_dirs, w_sc, w_run, w_rew, w_ep, w_eps = want
    _eq(got[0], w_pos)
    for g, w in zip(got[1:], (w_dirs, w_sc, w_run, w_rew, w_ep, w_eps)):
        assert g.shape == (B,)
        _eq(g, np.asarray(w)[:, 0])
    assert int(got[6].sum()) > (B if K > 4 else 0)


def test_chained_chunks_equal_one_long_run():
    """Chunks of 7, 7 and a partial 6 carry the state of one 20-step run:
    state and running returns bit for bit, episode counts exactly, and the
    float sums up to the rounding of adding three partial sums (one ulp of
    the largest partial sum per addition)."""
    jcfg, tcfg = _cfgs(max_steps=5, obstacle_penalty_ratio=0.5)
    slab = tslab.make_maze_slab(tcfg, "cpu")
    B, K = 40, 20
    pos, dirs, sc, run, acts, rnd = _inputs(slab, B, K, seed=3)
    w_pos, w_dirs, w_sc, w_run, w_rew, w_ep, w_eps = _jax_ms(jcfg, K, pos, dirs, sc, run, acts, rnd)
    state = tuple(torch.from_numpy(x.copy()) for x in (pos, dirs, sc, run))
    rew = torch.zeros(B)
    ep = torch.zeros(B)
    eps = torch.zeros(B, dtype=torch.int32)
    for start in range(0, K, 7):
        k = min(7, K - start)
        out = tslab.ms_spec(slab.t, k, *state, torch.from_numpy(acts[start:start + k].copy()),
                            torch.from_numpy(rnd[start:start + k].copy()), slab.cells, slab.bg)
        state = out[:4]
        rew, ep, eps = rew + out[4], ep + out[5], eps + out[6]
    _eq(state[0], w_pos)
    for g, w in zip(state[1:], (w_dirs, w_sc, w_run)):
        _eq(g, np.asarray(w)[:, 0])
    _eq(eps, np.asarray(w_eps)[:, 0])
    for g, w in ((rew, w_rew), (ep, w_ep)):
        w = np.asarray(w)[:, 0]
        tol = 3 * np.spacing(np.float32(np.abs(w).max() + 2))
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=tol)


@pytest.mark.parametrize("penalty", [0.0, 0.5])
def test_kernel_table_walk_equals_ms_spec(penalty):
    """``ms_table`` walked as ``csrc/maze_step.cu`` walks it (position as
    ``cell * 5``, one entry a move, the reward read beside it, the spawn
    row of the draw taken where the episode ends) gives ``ms_spec``'s
    results: the kernel's arithmetic on the CPU."""
    _, tcfg = _cfgs(max_steps=6, obstacle_penalty_ratio=penalty)
    slab = tslab.make_maze_slab(tcfg, "cpu")
    t = slab.t
    B, K = 64, 20
    pos, dirs, sc, run, acts, rnd = _inputs(slab, B, K, seed=9)
    want = [x.numpy() for x in _torch_ms(slab, K, pos, dirs, sc, run, acts, rnd)]
    table = slab.ms_table.numpy()
    n5, n_bg = t.n_cells * tmaze.NUM_ACTIONS, slab.bg.shape[1]
    assert table.size % 4 == 0 and table.size >= 2 * n5 + n_bg
    moves, rewards, spawns = table[:n5], table[n5:2 * n5].view(np.float32), table[2 * n5:2 * n5 + n_bg]
    f32 = np.float32
    for b in range(B):
        base, d, s, r = (int(pos[b, 0]) * t.s1 + int(pos[b, 1])) * 5, int(dirs[b]), int(sc[b]), f32(run[b])
        rew_sum = ep_sum = f32(0)
        eps = 0
        for k in range(K):
            a = min(max(int(acts[k, b]), 0), 4)
            e, reward = int(moves[base + a]), rewards[base + a]
            spawn = int(spawns[min(int(f32(rnd[k, b]) * f32(n_bg)), n_bg - 1)])
            if (e >> 1) & 7 != 4:
                d = (e >> 1) & 7
            s += 1
            done = bool(e & 1) or s >= t.max_steps
            run2 = f32(r + reward)
            rew_sum = f32(rew_sum + reward)
            ep_sum = f32(ep_sum + (run2 if done else f32(0)))
            eps += done
            r = f32(0) if done else run2
            base, d, s = (spawn, tmaze.SPAWN_DIR, 0) if done else (e >> 4, d, s)
        cell = base // 5
        assert (cell // t.s1, cell % t.s1) == tuple(want[0][b]), b
        assert (d, s, eps) == (want[1][b], want[2][b], want[6][b]), b
        assert (r, rew_sum, ep_sum) == (want[3][b], want[4][b], want[5][b]), b


def test_kernel_constants_equal_python_tables():
    text = (_build.CSRC / "maze_step.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (-?\d+);", text))
    assert int(consts["kNumActions"]) == tmaze.NUM_ACTIONS
    assert int(consts["kKeepDir"]) == tslab._KEEP_DIR
    assert int(consts["kSpawnDir"]) == tmaze.SPAWN_DIR
    assert tslab._KEEP_DIR not in tslab._A2DIR
    assert "maze_steps_philox" in _build.ENTRY_POINTS["maze_step.cu"]


def test_maze_ms_slab_runs_ms_spec_on_the_cpu():
    """The K-step wrapper ``maze_philox_slab`` runs ``ms_spec``'s steps on
    the CPU, on the counters' draws from the sums it is given, and launches
    nothing; it refuses "meta" tensors."""
    _, tcfg = _cfgs(max_steps=4)
    slab = tslab.make_maze_slab(tcfg, "cpu")
    K, B, key, step0 = 9, 16, philox.key_of(1), 3
    pos, dirs, sc, run, _, _ = (torch.from_numpy(x.copy()) for x in _inputs(slab, B, K, seed=1))
    rew, ep = torch.rand(B), torch.rand(B)
    eps = torch.randint(0, 3, (B,), dtype=torch.int32)
    cell = pos[:, 0] * slab.t.s1 + pos[:, 1]
    before = tslab.maze_philox_slab.launches
    got = tslab.maze_philox_slab(slab, K, cell, dirs, sc, run, rew, ep, eps, key, step0)
    assert tslab.maze_philox_slab.launches == before  # the plain version launches nothing
    acts, rnd = philox.maze_draws(key, step0, K, B, "cpu")
    want = tslab._ms_steps(slab.t, K, pos, dirs, sc, run, rew, ep, eps, acts, rnd,
                           slab.cells, slab.bg)
    assert torch.equal(got[0], want[0][:, 0] * slab.t.s1 + want[0][:, 1])
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="no Maze steps"):
        tslab.maze_philox_slab(slab, K, *(x.to("meta") for x in (cell, dirs, sc, run, rew, ep,
                                                                   eps)), key, step0)


def _rollout(n, chunk=25, **kw):
    return tslab.make_maze_episode_rollout(_cfgs(**kw)[1], n, device="cpu", chunk=chunk)


@pytest.mark.parametrize("penalty", [0.0, 0.5])
def test_episode_rollout_invariants(penalty):
    """Spawns on the background, agents on the board and never on an
    obstacle without the penalty, fresh spawns where the step count is 0,
    the metrics consistent across two calls with a partial last chunk."""
    n = 64
    roll = _rollout(n, chunk=12, max_steps=20, obstacle_penalty_ratio=penalty)
    states, obs = roll.reset(seed=2)
    fm = torch.from_numpy(roll.cfg.field_map)
    assert (fm[states.pos[:, 0], states.pos[:, 1]] == tmaze.BACKGROUND).all()
    assert obs.shape == (n, 13, 13) and obs.dtype == torch.float32
    again, _ = roll.reset(seed=2)
    assert torch.equal(again.pos, states.pos)
    runs = []
    for _ in range(2):
        states, m = roll(states, 30, run_return=runs[-1]["run_return"] if runs else None)
        runs.append(m)
        on = fm[states.pos[:, 0], states.pos[:, 1]]
        assert ((states.pos >= 0) & (states.pos < 13)).all()
        assert penalty != 0 or not (on == tmaze.M_OBSTACLE).any()
        assert (states.step_count < roll.cfg.max_steps).all()
        assert (on[states.step_count == 0] == tmaze.BACKGROUND).all()
        assert (states.dir[states.step_count == 0] == tmaze.SPAWN_DIR).all()
        assert int(m["episodes"]) > n // 2 and m["episodes"].dtype == torch.int32
    reward = float(runs[0]["reward_sum"]) + float(runs[1]["reward_sum"])
    finished = float(runs[0]["ep_return_sum"]) + float(runs[1]["ep_return_sum"])
    # The same rewards summed in another order: float32 rounding only.
    assert finished + float(runs[1]["run_return"].sum()) == pytest.approx(reward, rel=1e-5)


def test_episode_rollout_draws_one_chunk_at_a_time_from_the_generator():
    """The rollout equals ``ms_spec`` on the counters' (K, B) draws
    (``philox.maze_draws``) chunk by chunk at the running step count, each
    env's sums carried from chunk to chunk and reduced once at the end;
    ``reset(seed)`` spawns on the ``MAZE_FIRST`` uniforms."""
    n, steps, chunk = 16, 23, 10
    roll = _rollout(n, chunk=chunk, max_steps=6)
    states, _ = roll.reset(seed=5)
    key = philox.key_of(5)
    first = tslab.reset_batch(roll.slab, n, rnd=philox.maze_first_reset_draws(key, n, "cpu"))
    assert torch.equal(states.pos, first.pos) and torch.equal(states.dir, first.dir)
    got, m = roll(states, steps)
    assert roll.step == steps
    state = (states.pos, states.dir, states.step_count, torch.zeros(n), torch.zeros(n),
             torch.zeros(n), torch.zeros(n, dtype=torch.int32))
    for k0 in range(0, steps, chunk):
        K = min(chunk, steps - k0)
        acts, rnd = philox.maze_draws(key, k0, K, n, "cpu")
        state = tslab._ms_steps(roll.slab.t, K, *state, acts, rnd, roll.slab.cells,
                                roll.slab.bg)
    pos, dirs, sc, run, rew, ep, eps = state
    assert torch.equal(got.pos, pos) and torch.equal(got.dir, dirs)
    assert torch.equal(got.step_count, sc)
    assert torch.equal(m["run_return"], run)
    assert torch.equal(m["reward_sum"], rew.sum())
    assert torch.equal(m["ep_return_sum"], ep.sum())
    assert int(m["episodes"]) == int(eps.sum())


def _mean_length(final_sc, episodes, steps):
    """Mean length of the episodes a rollout finished, from fresh states:
    every step not in the episode still running belongs to a finished one."""
    return float((steps - np.asarray(final_sc)).sum()) / int(episodes)


def test_mean_episode_length_agrees_with_jax_episode_rollout():
    """Random walks that reach the flag or run out at 25 steps, over ten
    independent runs a side: the two rollouts draw their own numbers, so
    they agree in distribution."""
    n, steps, runs = 64, 150, 10
    jcfg, tcfg = _cfgs(max_steps=25)
    jenv = jax_make_maze_batch(jcfg, n)
    jroll = jax.jit(lambda s, k: jpm.make_maze_episode_rollout(jcfg, chunk=25)(s, k, steps))
    want, got = [], []
    roll = tslab.make_maze_episode_rollout(tcfg, n, device="cpu", chunk=25)
    for seed in range(runs):
        jstates, _ = jenv.reset(jax.random.PRNGKey(seed))
        jstates, jm = jroll(jstates, jax.random.PRNGKey(100 + seed))
        want.append(_mean_length(jstates.step_count, jm["episodes"], steps))
        states, _ = roll.reset(seed=seed)
        states, m = roll(states, steps)
        got.append(_mean_length(states.step_count, m["episodes"], steps))
    want, got = np.asarray(want), np.asarray(got)
    se = np.sqrt(want.var(ddof=1) / runs + got.var(ddof=1) / runs)
    assert abs(want.mean() - got.mean()) < 5 * se, (want.mean(), got.mean(), se)


def test_no_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tslab.make_maze_episode_rollout(_cfgs()[1], 8)
    with pytest.raises(ValueError, match="chunk"):
        tslab.make_maze_episode_rollout(_cfgs()[1], 8, device="cpu", chunk=0)


def test_config_counts_one_agent_as_a_property():
    """``num_agents`` is 1, read as Collect's and CtF's configs are read by
    the episode paths' callers; it is a read-only property, not a field, so
    the fields stay the JAX package's (``test_torch_bench.py``
    ``test_family_cfg_matches_jax``)."""
    import dataclasses

    _, tcfg = _cfgs(max_steps=7)
    assert tcfg.num_agents == 1
    assert "num_agents" not in {f.name for f in dataclasses.fields(tcfg)}
    with pytest.raises(dataclasses.FrozenInstanceError):
        tcfg.num_agents = 2
