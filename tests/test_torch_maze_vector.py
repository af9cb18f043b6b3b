"""The port's batched Maze env on the CPU: K steps with auto-reset against
the JAX package's episode math bit for bit, then ``make_maze_batch``'s
seeding, spawns, action shape, rollout invariants and metrics, its episode
lengths against the JAX batch env, and the device rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_multigrid_tpu.envs import maze as jmaze
from gym_multigrid_tpu.ops import pallas_maze as jpm
from gym_multigrid_tpu.parallel.vector import make_maze_batch as jax_make_maze_batch
from gym_multigrid_tpu_torch.envs import maze as tmaze
from gym_multigrid_tpu_torch.ops import maze_slab as tslab
from gym_multigrid_tpu_torch.parallel.vector import make_maze_batch

torch.set_num_threads(1)

MAZE = "tests/assets/board_maze.txt"


def _cfgs(**kw):
    return jmaze.MazeConfig.from_map_path(MAZE, **kw), tmaze.MazeConfig.from_map_path(MAZE, **kw)


def _env(n, **kw):
    return make_maze_batch(_cfgs(**kw)[1], n, device="cpu")


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("penalty", [0.0, 0.5])
def test_steps_with_auto_reset_match_jax_episode_math(penalty):
    """K port steps, each followed by the masked reset, on the per-step
    slices of one packed (B, K * MS_STRIDE) buffer [action as a float, reset
    uniform], equal the eager ``_maze_ms_math`` on that buffer: state,
    running returns and the per-row sums.  Episodes end inside K
    (max_steps 4), so the auto-reset runs."""
    jcfg, tcfg = _cfgs(max_steps=4, obstacle_penalty_ratio=penalty)
    jt = jmaze.maze_tables(jcfg)
    slab = tslab.make_maze_slab(tcfg, "cpu")
    B, K, stride = 48, 10, jpm.MS_STRIDE
    assert stride == 1 + slab.reset_draws
    rng = np.random.default_rng(7)
    bg = np.argwhere(tcfg.field_map == tmaze.BACKGROUND).astype(np.int32)
    pos = bg[rng.integers(0, len(bg), B)]
    dirs = rng.integers(0, 4, (B, 1)).astype(np.int32)
    sc = rng.integers(0, 4, (B, 1)).astype(np.int32)
    packed = rng.random((B, K * stride), dtype=np.float32)
    packed[:, ::stride] = rng.integers(-1, 7, (B, K))  # ids as floats, cast back by both sides
    want = jpm._maze_ms_math(
        jt, K, jnp.asarray(pos), jnp.asarray(dirs), jnp.asarray(sc),
        jnp.zeros((B, 1), jnp.float32), jnp.asarray(packed), *jmaze.maze_static_inputs(jcfg),
    )

    states = tmaze.MazeState(pos=torch.from_numpy(pos.copy()), dir=torch.from_numpy(dirs[:, 0].copy()),
                             step_count=torch.from_numpy(sc[:, 0].copy()))
    run_ret, rew_sum, ep_sum = (torch.zeros(B) for _ in range(3))
    eps = torch.zeros(B, dtype=torch.int32)
    for k in range(K):
        step = torch.from_numpy(packed[:, k * stride : (k + 1) * stride].copy())
        new, _, reward, term, trunc, _ = tslab.step_batch(
            slab, states, step[:, 0].to(torch.int32), encode_obs=False, with_info=False)
        done = term | trunc
        run2 = run_ret + reward
        rew_sum = rew_sum + reward
        ep_sum = ep_sum + torch.where(done, run2, 0.0)
        eps = eps + done.to(torch.int32)
        run_ret = torch.where(done, 0.0, run2)
        states = tslab.reset_batch(slab, B, rnd=step[:, 1:].contiguous(), done=done, states=new)
    w_pos, w_dirs, w_sc, w_run, w_rew, w_ep, w_eps = want
    _eq(states.pos, w_pos)
    _eq(states.dir[:, None], w_dirs)
    _eq(states.step_count[:, None], w_sc)
    for got, w in ((run_ret, w_run), (rew_sum, w_rew), (ep_sum, w_ep), (eps, w_eps)):
        _eq(got[:, None], w)
    assert int(eps.sum()) > B  # every env ended an episode, most more than one


def _on_background(cfg, pos):
    return torch.from_numpy(cfg.field_map == tmaze.BACKGROUND)[pos[:, 0], pos[:, 1]]


def test_reset_seed_reproduces_spawns_on_the_background():
    env = _env(64)
    a, obs_a = env.reset(seed=3)
    b, obs_b = env.reset(seed=3)
    c, _ = env.reset(seed=4)
    for f in ("pos", "dir", "step_count"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(obs_a, obs_b)
    assert not torch.equal(a.pos, c.pos)
    assert _on_background(env.cfg, a.pos).all()
    assert (a.dir == tmaze.SPAWN_DIR).all() and (a.step_count == 0).all()
    assert obs_a.shape == (64, 13, 13) and obs_a.dtype == torch.float32
    assert ((obs_a == tmaze.M_AGENT).sum(dim=(1, 2)) == 1).all()


@pytest.mark.parametrize("penalty", [0.0, 0.5])
def test_rollout_invariants(penalty):
    """Agents stay on the board, never on an obstacle without the penalty;
    the metrics add up across two calls."""
    n = 64
    env = _env(n, obstacle_penalty_ratio=penalty, max_steps=30)
    states, _ = env.reset(seed=1)
    fm = torch.from_numpy(env.cfg.field_map)
    seen_obstacle = False
    runs = []
    for _ in range(2):
        states, m = env.rollout(states, 40, run_return=runs[-1]["run_return"] if runs else None)
        runs.append(m)
        assert ((states.pos >= 0) & (states.pos < 13)).all()
        on = fm[states.pos[:, 0], states.pos[:, 1]]
        seen_obstacle |= bool((on == tmaze.M_OBSTACLE).any())
        assert (states.step_count < env.cfg.max_steps).all()
    assert not (penalty == 0 and seen_obstacle)
    for m in runs:
        assert int(m["episodes"]) > 0 and m["run_return"].shape == (n,)
    reward = float(runs[0]["reward_sum"]) + float(runs[1]["reward_sum"])
    episodes = float(runs[0]["ep_return_sum"]) + float(runs[1]["ep_return_sum"])
    # The same rewards summed in another order: float32 rounding only.
    assert episodes + float(runs[1]["run_return"].sum()) == pytest.approx(reward, rel=1e-5)


def test_actions_have_no_agent_axis():
    n = 16
    env = _env(n)
    assert env.actions_shape == (n,)
    states, _ = env.reset(seed=2)
    states, obs, rewards, term, trunc = env.step(states, torch.zeros(n, dtype=torch.int32))
    assert rewards.shape == term.shape == trunc.shape == (n,)
    assert rewards.dtype == torch.float32
    with pytest.raises(ValueError, match="actions must have shape"):
        env.step(states, torch.zeros((n, 1), dtype=torch.int32))


def test_step_returns_the_pre_reset_obs():
    """On the step where an env finishes, ``step`` returns the map with the
    agent where it ended: ``step_batch``'s own obs."""
    n = 32
    env = _env(n, max_steps=3)
    states, _ = env.reset(seed=6)
    rng = np.random.default_rng(6)
    respawned = 0
    for _ in range(7):
        acts = torch.from_numpy(rng.integers(0, 5, n).astype(np.int32))
        want_states, want_obs, *_ = tslab.step_batch(env.slab, states, acts)
        states, obs, _, term, trunc = env.step(states, acts)
        assert torch.equal(obs, want_obs)
        respawned += int((states.pos != want_states.pos).any(dim=1).sum())
    assert respawned > n // 2


def test_rollout_reward_sum_is_the_sum_of_step_rewards():
    """The same generator stream, stepped by hand, gives the same sums."""
    n, steps = 16, 30
    env = _env(n, max_steps=10)
    states, _ = env.reset(seed=5)
    _, m = env.rollout(states, steps)
    states, _ = env.reset(seed=5)
    total = torch.zeros((), dtype=torch.float32)
    run = torch.zeros(n)
    for _ in range(steps):
        acts = torch.randint(0, env.num_actions, env.actions_shape,
                             generator=env.generator, dtype=torch.int32)
        states, _, rewards, term, trunc = env.step(states, acts)
        total = total + rewards.sum()
        run = torch.where(term | trunc, 0.0, run + rewards)
    assert torch.equal(m["reward_sum"], total)
    assert torch.equal(m["run_return"], run)


def _episode_lengths(step, states, acts_for, steps):
    """Lengths of the episodes that end within ``steps`` lockstep steps."""
    lengths, count = [], None
    for _ in range(steps):
        states, _, _, term, trunc = step(states, acts_for())
        done = np.asarray(term) | np.asarray(trunc)
        count = (np.zeros(done.shape, np.int64) if count is None else count) + 1
        lengths += count[done].tolist()
        count[done] = 0
    return np.asarray(lengths, dtype=np.float64)


def test_mean_episode_length_agrees_with_jax_batch_env():
    """Random walks that reach the flag or run out at 25 steps: the JAX
    batch env draws its spawns with its own keys, so the two agree in
    distribution."""
    n, steps = 64, 150
    jcfg, tcfg = _cfgs(max_steps=25)
    rng = np.random.default_rng(4)

    def acts():
        return rng.integers(0, 5, n).astype(np.int32)

    jenv = jax_make_maze_batch(jcfg, n)
    jstates, _ = jenv.reset(jax.random.PRNGKey(0))
    want = _episode_lengths(jax.jit(jenv.step), jstates, lambda: jnp.asarray(acts()), steps)
    env = make_maze_batch(tcfg, n, device="cpu")
    states, _ = env.reset(seed=0)
    got = _episode_lengths(env.step, states, lambda: torch.from_numpy(acts()), steps)
    assert len(want) > 100 and len(got) > 100
    se = np.sqrt(want.var(ddof=1) / len(want) + got.var(ddof=1) / len(got))
    assert abs(want.mean() - got.mean()) < 5 * se, (want.mean(), got.mean(), se)


def test_no_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_maze_batch(_cfgs()[1], 8)
