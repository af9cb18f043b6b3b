"""The port's batched Wildfire env on the CPU: K steps with auto-reset
against the JAX package's episode math bit for bit, then
``make_wildfire_batch``'s seeding, fresh boards against the JAX batch env's,
rollout invariants and metrics, episode lengths against the JAX batch env,
and the device rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_multigrid_tpu.envs import wildfire as jwf
from gym_multigrid_tpu.ops import pallas_wildfire as jpw
from gym_multigrid_tpu.parallel.vector import make_wildfire_batch as jax_make_wildfire_batch
from gym_multigrid_tpu_torch.envs import wildfire as twf
from gym_multigrid_tpu_torch.ops import wildfire_slab as tslab
from gym_multigrid_tpu_torch.parallel.vector import make_wildfire_batch

torch.set_num_threads(1)

MAIN = dict(size=16, max_steps=100)
FOUR = dict(size=10, num_agents=4, agents_index=(1, 2, 4, 5), step_penalty=0.01)


def _cfgs(kw=MAIN, **over):
    kw = {**kw, **over}
    return jwf.WildfireConfig(**kw), twf.WildfireConfig(**kw)


def _env(n, kw=MAIN, **over):
    return make_wildfire_batch(_cfgs(kw, **over)[1], n, device="cpu")


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _distinct_cells(pos):
    """(B,) bool: no two agents of an env share a cell."""
    key = pos[:, :, 0] * 1024 + pos[:, :, 1]
    return ~(key[:, :, None] == key[:, None, :]).triu(diagonal=1).any(dim=(1, 2))


@pytest.mark.parametrize("kw", [MAIN, FOUR], ids=["main", "four_agents"])
def test_steps_with_auto_reset_match_jax_episode_math(kw):
    """K port steps, each followed by the masked reset, on the per-step
    slices of one packed (B, K * stride) buffer [A actions as floats, the
    step's uniforms, the reset's uniforms], equal the eager ``_ms_math``
    on that buffer (2-D form, adj = tril = None): state, running returns
    and the per-row sums.  Episodes end inside K (max_steps 3), so the
    auto-reset runs."""
    jcfg, tcfg = _cfgs(kw, max_steps=3)
    jt = jwf.wf_tables(jcfg)
    slab = tslab.make_wildfire_slab(tcfg, "cpu")
    t = slab.t
    B, K, A, C = 12, 7, t.n_agents, t.n_cells
    Rs, Rr = slab.step_draws, slab.reset_draws
    stride = A + Rs + Rr
    rng = np.random.default_rng(7)
    cells0, pos0 = tslab.reset_spec(t, torch.from_numpy(rng.random((B, Rr), dtype=np.float32)))
    cells0, pos0 = cells0.numpy(), pos0.numpy()
    sc = rng.integers(0, 3, (B, 1)).astype(np.int32)
    ext = rng.integers(0, 5, (B, 1)).astype(np.int32)
    packed = rng.random((B, K * stride), dtype=np.float32)
    for k in range(K):  # action ids -2..6 as floats, cast back by both sides
        packed[:, k * stride : k * stride + A] = rng.integers(-2, 7, (B, A))
    want = jpw._ms_math(
        jt, K, *(jnp.asarray(x) for x in (cells0, pos0, sc, ext)),
        jnp.zeros((B, 1), jnp.float32), jnp.asarray(packed), None, None,
    )

    states = twf.WildfireState(
        cells=torch.from_numpy(cells0.reshape(B, t.height, t.width).copy()),
        agent_pos=torch.from_numpy(pos0.reshape(B, A, 2).copy()),
        step_count=torch.from_numpy(sc[:, 0].copy()), extinguished=torch.from_numpy(ext[:, 0].copy()),
    )
    run_ret, rew_sum, ep_sum = (torch.zeros(B) for _ in range(3))
    eps = torch.zeros(B, dtype=torch.int32)
    for k in range(K):
        step = torch.from_numpy(packed[:, k * stride : (k + 1) * stride].copy())
        new, _, rewards, term, trunc, _ = tslab.step_batch(
            slab, states, step[:, :A].to(torch.int32), rnd=step[:, A : A + Rs].contiguous(),
            encode_obs=False, with_info=False,
        )
        # The team reward: the JAX episode math carries it unsplit.
        reward = tslab.wildfire_step_slab(
            t, states.cells.reshape(B, C), states.agent_pos.reshape(B, 2 * A),
            step[:, :A].to(torch.int32), step[:, A : A + Rs].contiguous())[2][:, 0]
        assert torch.equal(rewards, (reward[:, None] / A).repeat(1, A))
        done = term | trunc
        run2 = run_ret + reward
        rew_sum = rew_sum + reward
        ep_sum = ep_sum + torch.where(done, run2, 0.0)
        eps = eps + done.to(torch.int32)
        run_ret = torch.where(done, 0.0, run2)
        states = tslab.reset_batch(slab, B, rnd=step[:, A + Rs :].contiguous(), done=done,
                                   states=new)
    w_cells, w_pos, w_sc, w_ext, w_run, w_rew, w_ep, w_eps = want
    _eq(states.cells.reshape(B, C), w_cells)
    _eq(states.agent_pos.reshape(B, 2 * A), w_pos)
    _eq(states.step_count[:, None], w_sc)
    _eq(states.extinguished[:, None], w_ext)
    for got, w in ((run_ret, w_run), (rew_sum, w_rew), (ep_sum, w_ep), (eps, w_eps)):
        _eq(got[:, None], w)
    assert int(eps.sum()) > B  # every env ended an episode, most more than one


def test_reset_seed_reproduces_boards():
    env = _env(32)
    a, obs_a = env.reset(seed=3)
    b, obs_b = env.reset(seed=3)
    c, _ = env.reset(seed=4)
    for f in ("cells", "agent_pos", "step_count", "extinguished"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(obs_a, obs_b)
    assert not torch.equal(a.cells, c.cells)
    assert obs_a.shape == (32, 16, 16, 3) and obs_a.dtype == torch.uint8
    assert ((obs_a[..., 0] == twf.W_AGENT).sum(dim=(1, 2)) == 2).all()


def _board_stats(cells, pos, n_fires):
    """Per env: tree share (trees and fires over cells), and checks that the
    fires number min(n_fires, trees) and the agents are distinct."""
    cells = np.asarray(cells).reshape(len(cells), -1)
    fires = (cells == twf.FIRE).sum(axis=1)
    grown = (cells == twf.TREE).sum(axis=1) + fires
    assert (fires == np.minimum(n_fires, grown)).all()
    assert np.isin(cells, (twf.EMPTY, twf.TREE, twf.FIRE)).all()
    assert _distinct_cells(torch.as_tensor(np.array(pos))).all()
    return grown / cells.shape[1]


def test_fresh_boards_agree_with_jax_batch_env():
    """Initial fires on trees (as many as asked, fewer where the board has
    fewer trees), distinct agents, and a tree share whose mean agrees with
    the JAX batch env's within 5 standard errors and with tree_density."""
    n = 256
    jcfg, tcfg = _cfgs(MAIN)
    jenv = jax_make_wildfire_batch(jcfg, n)
    js, _ = jenv.reset(jax.random.PRNGKey(0))
    want = _board_stats(js.cells, js.agent_pos, jcfg.num_initial_fires)
    states, _ = make_wildfire_batch(tcfg, n, device="cpu").reset(seed=0)
    got = _board_stats(states.cells, states.agent_pos, tcfg.num_initial_fires)
    se = np.sqrt(want.var(ddof=1) / n + got.var(ddof=1) / n)
    assert abs(want.mean() - got.mean()) < 5 * se, (want.mean(), got.mean(), se)
    assert abs(got.mean() - tcfg.tree_density) < 5 * np.sqrt(got.var(ddof=1) / n)


@pytest.mark.parametrize("kw", [MAIN, FOUR], ids=["main", "four_agents"])
def test_rollout_invariants(kw):
    n = 32
    env = _env(n, kw, max_steps=20)
    states, _ = env.reset(seed=1)
    runs = []
    for _ in range(2):
        states, m = env.rollout(states, 30, run_return=runs[-1]["run_return"] if runs else None)
        runs.append(m)
        assert _distinct_cells(states.agent_pos).all()
        assert ((states.agent_pos >= 0) & (states.agent_pos < env.cfg.size)).all()
        assert ((states.cells >= 0) & (states.cells <= 3)).all()
        assert (states.step_count < env.cfg.max_steps).all()
    for m in runs:
        assert int(m["episodes"]) > 0 and m["run_return"].shape == (n,)
    reward = float(runs[0]["reward_sum"]) + float(runs[1]["reward_sum"])
    episodes = float(runs[0]["ep_return_sum"]) + float(runs[1]["ep_return_sum"])
    # The same rewards summed in another order: float32 rounding only.
    assert episodes + float(runs[1]["run_return"].sum()) == pytest.approx(reward, rel=1e-5, abs=1e-3)


def test_step_returns_the_pre_reset_obs_and_split_rewards():
    """On the step where an env finishes, ``step`` returns the obs of the
    board where it ended: ``step_batch``'s own obs on the same uniforms.
    Each agent gets the team reward divided by the agent count."""
    n = 16
    env = _env(n, max_steps=3)
    states, _ = env.reset(seed=6)
    rng = np.random.default_rng(6)
    for _ in range(7):
        acts = torch.from_numpy(rng.integers(0, 5, (n, 2)).astype(np.int32))
        gen = torch.Generator()
        gen.set_state(env.generator.get_state())
        want_states, want_obs, want_rewards, *_ = tslab.step_batch(env.slab, states, acts,
                                                                   generator=gen)
        states, obs, rewards, term, trunc = env.step(states, acts)
        assert torch.equal(obs, want_obs)
        assert rewards.shape == (n, 2) and torch.equal(rewards, want_rewards)
        assert torch.equal(rewards[:, 0], rewards[:, 1])
    assert (states.step_count < 3).all()
    with pytest.raises(ValueError, match="actions must have shape"):
        env.step(states, torch.zeros(n, dtype=torch.int32))


def test_rollout_reward_sum_is_the_sum_of_step_rewards():
    """Per-agent rewards: the rollout sums each env's into its team return.
    The same generator stream, stepped by hand, gives the same sums."""
    n, steps = 8, 20
    env = _env(n, max_steps=8)
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
        run = torch.where(term | trunc, 0.0, run + rewards.sum(dim=1))
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
    """Fires that burn out or are put out, or 20 steps: the JAX batch env
    draws with its own keys, so the two agree in distribution."""
    n, steps = 64, 100
    jcfg, tcfg = _cfgs(MAIN, max_steps=20)
    rng = np.random.default_rng(4)

    def acts():
        return rng.integers(0, 5, (n, 2)).astype(np.int32)

    jenv = jax_make_wildfire_batch(jcfg, n)
    jstates, _ = jenv.reset(jax.random.PRNGKey(0))
    want = _episode_lengths(jax.jit(jenv.step), jstates, lambda: jnp.asarray(acts()), steps)
    env = make_wildfire_batch(tcfg, n, device="cpu")
    states, _ = env.reset(seed=0)
    got = _episode_lengths(env.step, states, lambda: torch.from_numpy(acts()), steps)
    assert len(want) > 100 and len(got) > 100
    se = np.sqrt(want.var(ddof=1) / len(want) + got.var(ddof=1) / len(got))
    assert abs(want.mean() - got.mean()) < 5 * se, (want.mean(), got.mean(), se)


def test_no_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_wildfire_batch(_cfgs()[1], 8)
