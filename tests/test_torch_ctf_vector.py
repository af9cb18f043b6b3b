"""The port's batched CtF env on the CPU: K steps with auto-reset against
the JAX package's episode math bit for bit, then ``make_ctf_batch``'s
seeding, spawns, rollout invariants and metrics, its episode lengths
against the JAX batch env, and the device rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_multigrid_tpu.envs import ctf as jctf
from gym_multigrid_tpu.ops import pallas_ctf as jpc
from gym_multigrid_tpu.parallel.vector import make_ctf_batch as jax_make_ctf_batch
from gym_multigrid_tpu_torch.envs import ctf as tctf
from gym_multigrid_tpu_torch.ops import ctf_slab as tslab
from gym_multigrid_tpu_torch.parallel.vector import make_ctf_batch

torch.set_num_threads(1)

BOARD = "tests/assets/board.txt"
# The config the family bench drives: 2v2 on the 10x10 board.
MAIN = dict(num_blue_agents=2, num_red_agents=2, variant="mvn",
            policies=("fight", "rw"), observation_option="flattened")
ONE_V_ONE = dict(num_blue_agents=1, num_red_agents=1, variant="1v1",
                 policies=("fight",), obstacle_penalty_ratio=0.5)
THREE_V_THREE = dict(num_blue_agents=3, num_red_agents=3, variant="mvn",
                     policies=("capture", "patrol", "rw"))


def _cfgs(kw, **over):
    kw = {**kw, **over}
    policies = kw.pop("policies")
    return (
        jctf.CtfConfig.from_map_path(
            BOARD, enemy_policies=tuple(jctf.PolicySpec(k) for k in policies), **kw),
        tctf.CtfConfig.from_map_path(
            BOARD, enemy_policies=tuple(tctf.PolicySpec(k) for k in policies), **kw),
    )


def _env(n, kw=MAIN, **over):
    return make_ctf_batch(_cfgs(kw, **over)[1], n, device="cpu")


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _distinct_cells(pos):
    """(B,) bool: no two agents of an env share a cell."""
    key = pos[:, :, 0] * 1024 + pos[:, :, 1]
    return ~(key[:, :, None] == key[:, None, :]).triu(diagonal=1).any(dim=(1, 2))


@pytest.mark.parametrize("kw", [MAIN, ONE_V_ONE, THREE_V_THREE], ids=["main", "1v1", "3v3"])
def test_steps_with_auto_reset_match_jax_episode_math(kw):
    """K port steps, each followed by the masked reset, on the per-step
    slices of one packed buffer laid out as ``ms_stride`` says, equal
    ``_ctf_ms_math`` on that buffer: state, running returns and the per-row
    sums.  Episodes end inside K (max_steps 5), so the auto-reset runs."""
    jcfg, tcfg = _cfgs(kw, max_steps=5)
    jt, tt = jpc.make_ctf_ktables(jcfg), tslab.make_ctf_ktables(tcfg)
    slab = tslab.make_ctf_slab(tcfg, "cpu")
    B, K, A, nb = 32, 12, tcfg.num_agents, tcfg.num_blue_agents
    R, stride = tslab.rnd_width(tt), jpc.ms_stride(jt)
    assert stride == nb + R + A
    rng = np.random.default_rng(7)
    fns = jctf.make_ctf(jcfg)
    js = jax.vmap(fns.reset_fn)(jax.random.split(jax.random.PRNGKey(2), B))
    pos = np.asarray(js.pos).reshape(B, 2 * A)
    dirs = np.asarray(js.dir)
    sc = rng.integers(0, 5, (B, 1)).astype(np.int32)
    packed = rng.random((B, K * stride), dtype=np.float32)
    for k in range(K):  # blue action ids -2..6 as floats, cast back by both sides
        packed[:, k * stride : k * stride + nb] = rng.integers(-2, 7, (B, nb))
    zeros = np.zeros((B, A), np.int32)
    # Eager: compiling the K unrolled steps takes minutes on the CPU.
    want = jpc._ctf_ms_math(
        jt, K, *(jnp.asarray(x) for x in (pos, dirs, zeros, zeros, sc)),
        jnp.zeros((B, 1), jnp.float32), jnp.asarray(packed),
        *jpc.ctf_static_inputs(jcfg), *jpc.ctf_reset_inputs(jcfg),
    )

    states = tctf.CtfState(
        pos=torch.from_numpy(pos.reshape(B, A, 2).copy()), dir=torch.from_numpy(dirs.copy()),
        terminated=torch.zeros((B, A), dtype=torch.bool),
        collided=torch.zeros((B, A), dtype=torch.bool), step_count=torch.from_numpy(sc[:, 0]),
    )
    run_ret, rew_sum, ep_sum = (torch.zeros(B) for _ in range(3))
    eps = torch.zeros(B, dtype=torch.int32)
    for k in range(K):
        step = torch.from_numpy(packed[:, k * stride : (k + 1) * stride].copy())
        ba = step[:, :nb].to(torch.int32)
        new, _, reward, term, trunc, _ = tslab.step_batch(
            slab, states, ba, rnd=step[:, nb : nb + R].contiguous(),
            encode_obs=False, with_info=False,
        )
        done = term | trunc
        run2 = run_ret + reward
        rew_sum = rew_sum + reward
        ep_sum = ep_sum + torch.where(done, run2, 0.0)
        eps = eps + done.to(torch.int32)
        run_ret = torch.where(done, 0.0, run2)
        states = tslab.reset_batch(slab, B, rnd=step[:, nb + R :].contiguous(), done=done,
                                   states=new)
    w_pos, w_dirs, w_term, w_coll, w_sc, w_run, w_rew, w_ep, w_eps = want
    _eq(states.pos.reshape(B, 2 * A), w_pos)
    _eq(states.dir, w_dirs)
    _eq(states.terminated.to(torch.int32), w_term)
    _eq(states.collided.to(torch.int32), w_coll)
    _eq(states.step_count[:, None], w_sc)
    for got, w in ((run_ret, w_run), (rew_sum, w_rew), (ep_sum, w_ep), (eps, w_eps)):
        _eq(got[:, None], w)
    assert int(eps.sum()) > B  # every env ended an episode, most more than one


def test_reset_seed_reproduces_spawns_in_own_territory():
    env = _env(64)
    a, obs_a = env.reset(seed=3)
    b, obs_b = env.reset(seed=3)
    c, _ = env.reset(seed=4)
    for f in ("pos", "dir", "terminated", "collided", "step_count"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(obs_a, obs_b)
    assert not torch.equal(a.pos, c.pos)
    nb = env.cfg.num_blue_agents
    for agent in range(env.cfg.num_agents):
        terr = env.slab.bterr if agent < nb else env.slab.rterr
        at = (a.pos[:, agent, :1] == terr[0]) & (a.pos[:, agent, 1:] == terr[1])
        assert at.any(dim=1).all(), agent
    assert _distinct_cells(a.pos).all()
    assert (a.dir == tctf.SPAWN_DIR).all() and (a.step_count == 0).all()
    assert not a.terminated.any() and not a.collided.any()


@pytest.mark.parametrize("kw", [MAIN, THREE_V_THREE], ids=["main", "3v3"])
def test_no_two_agents_share_a_cell_over_a_rollout(kw):
    n = 32
    env = _env(n, kw)
    states, _ = env.reset(seed=1)
    rng = np.random.default_rng(2)
    ended = 0
    for _ in range(40):
        acts = torch.from_numpy(rng.integers(0, 5, (n, env.cfg.num_blue_agents), dtype=np.int32))
        states, obs, rewards, term, trunc = env.step(states, acts)
        assert rewards.shape == (n,) and rewards.dtype == torch.float32
        assert _distinct_cells(states.pos).all()
        assert (states.pos >= 0).all() and (states.pos < 10).all()
        ended += int((term | trunc).sum())
    assert ended > 0
    with pytest.raises(ValueError, match="actions must have shape"):
        env.step(states, torch.zeros((n, env.cfg.num_agents), dtype=torch.int32))


def test_step_returns_the_pre_reset_positional_obs():
    """On the step where an env finishes, ``step`` returns the obs of where
    its agents ended, not of their new spawns: ``step_batch``'s own obs on
    the same uniforms."""
    n = 32
    env = _env(n, observation_option="positional", max_steps=3)
    states, _ = env.reset(seed=6)
    rng = np.random.default_rng(6)
    respawned = 0
    for _ in range(7):
        acts = torch.from_numpy(rng.integers(0, 5, (n, 2), dtype=np.int32))
        gen = torch.Generator()
        gen.set_state(env.generator.get_state())
        want_states, want_obs, *_ = tslab.step_batch(env.slab, states, acts, generator=gen)
        states, obs, _, term, trunc = env.step(states, acts)
        assert sorted(obs) == sorted(want_obs)
        for key in want_obs:
            assert torch.equal(obs[key], want_obs[key]), key
        respawned += int((states.pos != want_states.pos).any(dim=(1, 2)).sum())
    assert respawned > n  # every env finished, most more than once


def test_reset_leaves_the_step_obs_and_info_alone():
    n = 32
    _, tcfg = _cfgs(MAIN, observation_option="positional", max_steps=2)
    slab = tslab.make_ctf_slab(tcfg, "cpu")
    gen = torch.Generator().manual_seed(8)
    states = tslab.reset_batch(slab, n, generator=gen)
    for _ in range(2):
        acts = torch.randint(0, 5, (n, 2), generator=gen, dtype=torch.int32)
        new, obs, _, term, trunc, info = tslab.step_batch(slab, states, acts, generator=gen)
        seen = {**obs, **info}
        kept = {k: v.clone() for k, v in seen.items()}
        states = tslab.reset_batch(slab, n, generator=gen, done=term | trunc, states=new)
        for key, v in seen.items():
            assert torch.equal(v, kept[key]), key
    assert (term | trunc).all() and not torch.equal(states.pos, new.pos)


def test_rollout_metrics_add_up():
    n = 64
    env = _env(n)
    states, _ = env.reset(seed=0)
    states, m1 = env.rollout(states, 40)
    states, m2 = env.rollout(states, 40, run_return=m1["run_return"])
    for m in (m1, m2):
        assert int(m["episodes"]) > 0
        assert m["run_return"].shape == (n,)
    reward = float(m1["reward_sum"]) + float(m2["reward_sum"])
    episodes = float(m1["ep_return_sum"]) + float(m2["ep_return_sum"])
    # The same rewards summed in another order: float32 rounding only.
    assert episodes + float(m2["run_return"].sum()) == pytest.approx(reward, rel=1e-5)
    assert (states.step_count < env.cfg.max_steps).all()


def test_rollout_reward_sum_is_the_sum_of_step_rewards():
    """A CtF reward is one scalar per env: the rollout adds it as it is.
    The same generator stream, stepped by hand, gives the same sums."""
    n, steps = 16, 30
    env = _env(n)
    states, _ = env.reset(seed=5)
    _, m = env.rollout(states, steps)
    states, _ = env.reset(seed=5)
    total = torch.zeros((), dtype=torch.float32)
    run = torch.zeros(n)
    for _ in range(steps):
        acts = torch.randint(0, env.num_actions, (n, env.action_cols),
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
    n, steps = 64, 150
    jcfg, tcfg = _cfgs(MAIN)
    rng = np.random.default_rng(4)

    def acts():
        return rng.integers(0, 5, (n, 2)).astype(np.int32)

    jenv = jax_make_ctf_batch(jcfg, n)
    jstates, _ = jenv.reset(jax.random.PRNGKey(0))
    want = _episode_lengths(jax.jit(jenv.step), jstates, lambda: jnp.asarray(acts()), steps)
    env = make_ctf_batch(tcfg, n, device="cpu")
    states, _ = env.reset(seed=0)
    got = _episode_lengths(env.step, states, lambda: torch.from_numpy(acts()), steps)
    assert len(want) > 50 and len(got) > 50
    se = np.sqrt(want.var(ddof=1) / len(want) + got.var(ddof=1) / len(got))
    assert abs(want.mean() - got.mean()) < 5 * se, (want.mean(), got.mean(), se)


def test_no_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_ctf_batch(_cfgs(MAIN)[1], 8)
