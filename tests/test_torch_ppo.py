"""The PPO learner on the CPU: GAE and one whole update held to the JAX
package's (``_gae`` and ``make_update_fn``, from carried-over flax params),
the counterparts of ``tests/test_ppo.py`` (minibatch algebra, buffer
compaction, shuffle blocks), and determinism of ``train_step`` on
Collect, CtF and Maze batches."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gym_multigrid_tpu.rl import networks as jnet
from gym_multigrid_tpu.rl import ppo as jppo
from gym_multigrid_tpu_torch.envs.collect import CollectConfig
from gym_multigrid_tpu_torch.parallel.vector import make_collect_batch
from gym_multigrid_tpu_torch.rl import networks as tnet
from gym_multigrid_tpu_torch.rl import ppo as tppo
from gym_multigrid_tpu_torch.rl.families import make_family_batch

torch.set_num_threads(1)

T, B = 6, 16
METRICS = ("loss", "pg_loss", "v_loss", "entropy", "approx_kl", "clip_fraction",
           "reward_per_step", "explained_variance")


def _rollout_data(seed=0):
    """A seeded Transition of Collect observations (T, B, 10, 10, 3),
    random actions with log-probabilities near their flax net's and that
    net's values, rewards, terminations and truncations mixed (never both), boot
    values; as numpy, with the flax net and its params."""
    env = make_collect_batch(CollectConfig(layout="quadrants_respawn", respawn=True), B, device="cpu")
    states, obs = env.reset(seed=seed)
    obs_t = []
    for _ in range(T):
        obs_t.append(obs.numpy())
        acts = torch.randint(0, 4, (B, 2), generator=env.generator, dtype=torch.int32)
        states, obs, *_ = env.step(states, acts)
    obs = np.stack(obs_t)
    rng = np.random.default_rng(seed)
    net = jnet.ActorCritic(num_actions=4, num_agents=2, hidden=(32, 32),
                           activation_dtype=jnp.float32)
    params = net.init(jax.random.PRNGKey(seed), jnp.asarray(obs[0, :1]))
    logits, value = net.apply(params, jnp.asarray(obs.reshape((T * B,) + obs.shape[2:])))
    actions = rng.integers(0, 4, (T * B, 2)).astype(np.int32)
    logp = np.take_along_axis(np.asarray(jax.nn.log_softmax(logits)), actions[..., None], -1)
    u = rng.random((T, B))
    data = dict(
        obs=obs,
        actions=actions.reshape(T, B, 2),
        # The behaviour policy's logp: the net's, moved so that ratios
        # differ from 1 and some are clipped.
        logp=(logp.sum((1, 2)) + rng.normal(0, 0.3, T * B)).reshape(T, B).astype(np.float32),
        value=np.asarray(value).reshape(T, B),
        reward=rng.integers(0, 2, (T, B)).astype(np.float32),
        terminated=(u < 0.15).astype(np.float32),
        truncated=((u >= 0.15) & (u < 0.3)).astype(np.float32),
        boot_value=rng.normal(size=(T, B)).astype(np.float32),
    )
    last_value = rng.normal(size=B).astype(np.float32)
    return data, last_value, net, params


def _closure(fn, name):
    return dict(zip(fn.__code__.co_freevars, (c.cell_contents for c in fn.__closure__)))[name]


def test_gae_matches_jax():
    data, last_value, net, _ = _rollout_data()
    cfg = jppo.PPOConfig()
    update = jppo.make_update_fn(net, optax.adam(1e-3), cfg)
    jtraj = jppo.Transition(**{k: jnp.asarray(v) for k, v in data.items()})
    want = _closure(update, "_gae")(jtraj, jnp.asarray(last_value))
    ttraj = tppo.Transition(**{k: torch.tensor(v) for k, v in data.items()})
    got = tppo.compute_gae(ttraj, torch.from_numpy(last_value), tppo.PPOConfig())
    assert data["terminated"].any() and data["truncated"].any()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)


def test_one_update_matches_jax():
    """One full-batch, one-epoch update at float32 activations from the
    same params and Transition: every metric and every updated parameter
    within rtol 1e-4 and atol 1e-5 of JAX's (optax's global-norm clip and
    Adam against the port's).  One minibatch of the whole buffer makes the
    shuffle's order the only difference, which reorders sums."""
    data, last_value, jn, params = _rollout_data()
    cfg = dict(num_minibatches=1, num_epochs=1)
    jcfg = jppo.PPOConfig(**cfg)
    tx = optax.chain(optax.clip_by_global_norm(jcfg.max_grad_norm), optax.adam(jcfg.lr))
    update = jppo.make_update_fn(jn, tx, jcfg)
    jtraj = jppo.Transition(**{k: jnp.asarray(v) for k, v in data.items()})
    p2, _, jm = update(params, tx.init(params), jtraj, jnp.asarray(last_value), jax.random.PRNGKey(0))

    tn = tnet.ActorCritic(4, 2, (32, 32), torch.float32, obs_shape=data["obs"].shape[2:])
    tnet.load_flax_params(tn, jax.tree_util.tree_map(np.asarray, params))
    tcfg = tppo.PPOConfig(**cfg)
    tupdate = tppo.make_update_fn(tn, tppo.make_optimizer(tn, tcfg), tcfg)
    ttraj = tppo.Transition(**{k: torch.tensor(v) for k, v in data.items()})
    tm = tupdate(ttraj, torch.from_numpy(last_value), torch.Generator().manual_seed(0))
    assert 0 < float(jm["clip_fraction"]) < 1 and float(jm["approx_kl"]) > 0
    for k in METRICS:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-5, err_msg=k)
    want = tnet.ActorCritic(4, 2, (32, 32), torch.float32, obs_shape=data["obs"].shape[2:])
    tnet.load_flax_params(want, jax.tree_util.tree_map(np.asarray, p2))
    for (name, g), w in zip(tn.named_parameters(), want.parameters()):
        np.testing.assert_allclose(g.detach().numpy(), w.detach().numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def _collect_ppo(num_envs=8, hidden=(32, 32), **ppo_kwargs):
    env = make_collect_batch(
        CollectConfig(layout="quadrants_respawn", respawn=True, max_steps=50), num_envs, device="cpu")
    net = tnet.ActorCritic(4, 2, hidden, obs_shape=(10, 10, 3))
    init_fn, train_step = tppo.make_ppo(env, net, tppo.PPOConfig(rollout_len=8, **ppo_kwargs))
    return net, init_fn, train_step


def _run(init_fn, train_step, net, iters=1, seed=0):
    _, carry = init_fn(seed)
    g = torch.Generator().manual_seed(seed + 1)
    ms = []
    for _ in range(iters):
        carry, m = train_step(carry, g)
        ms.append({k: float(v) for k, v in m.items()})
    return [p.detach().clone() for p in net.parameters()], ms, carry


def test_minibatch_count_must_divide_buffer():
    net, init_fn, train_step = _collect_ppo(num_minibatches=7)  # 8 * 8 = 64 % 7 != 0
    _, carry = init_fn(0)
    with pytest.raises(ValueError, match="not divisible"):
        train_step(carry, torch.Generator().manual_seed(1))


class _Recorder(torch.nn.Module):
    """A one-input net that records the sample ids it is fed: the obs of
    each sample is its own id."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1, 2, 3))
        self.seen = []

    def forward(self, obs):
        self.seen.append(obs[:, 0].long().tolist())
        return self.w.expand(obs.shape[0], 2, 3) * obs[:, :1, None], obs[:, 0] * self.w.sum()


@pytest.mark.parametrize("blocks", [None, 4], ids=["global", "four_blocks"])
def test_each_epoch_covers_every_sample_once(blocks):
    """Per epoch the minibatches partition the (T * B) buffer: no sample
    dropped or repeated.  With ``shuffle_blocks`` each minibatch takes an
    equal share of each block of envs."""
    Tn, Bn, nm = 4, 8, 4
    ids = torch.arange(Tn * Bn, dtype=torch.float32).reshape(Tn, Bn)
    traj = tppo.Transition(
        obs=ids[..., None], actions=torch.zeros((Tn, Bn, 2), dtype=torch.int32),
        logp=torch.zeros((Tn, Bn)), value=torch.zeros((Tn, Bn)), reward=torch.ones((Tn, Bn)),
        terminated=torch.zeros((Tn, Bn)), truncated=torch.zeros((Tn, Bn)),
        boot_value=torch.zeros((Tn, Bn)),
    )
    net = _Recorder()
    cfg = tppo.PPOConfig(num_minibatches=nm, num_epochs=2, shuffle_blocks=blocks)
    update = tppo.make_update_fn(net, tppo.make_optimizer(net, cfg), cfg)
    update(traj, torch.zeros(Bn), torch.Generator().manual_seed(0))
    assert len(net.seen) == 2 * nm
    for epoch in range(2):
        mbs = net.seen[epoch * nm:(epoch + 1) * nm]
        assert sorted(i for mb in mbs for i in mb) == list(range(Tn * Bn))
        if blocks:
            for mb in mbs:  # env b = id % Bn lies in block b // (Bn // blocks)
                per_block = np.bincount([(i % Bn) // (Bn // blocks) for i in mb], minlength=blocks)
                assert (per_block == len(mb) // blocks).all(), per_block


def test_obs_buffer_compaction_is_bit_identical():
    """``obs_buffer_dtype="int8"`` changes nothing over two iterations:
    Collect's obs are small ints and the net casts its input first."""
    runs = []
    for dtype in (None, "int8"):
        net, init_fn, train_step = _collect_ppo(num_epochs=2, num_minibatches=2,
                                                obs_buffer_dtype=dtype)
        runs.append(_run(init_fn, train_step, net, iters=2))
    (p1, m1, _), (p2, m2, _) = runs
    assert m1 == m2
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))


def test_obs_buffer_compaction_refuses_floats():
    with pytest.raises(ValueError, match="integer dtype"):
        tppo.make_obs_store(tppo.PPOConfig(obs_buffer_dtype="float16"))
    env, _, n_actions, agents = make_family_batch("maze", 4, "cpu")
    net = tnet.ActorCritic(n_actions, agents, (16,), obs_shape=(13, 13))
    init_fn, train_step = tppo.make_ppo(env, net, tppo.PPOConfig(rollout_len=4,
                                                                 obs_buffer_dtype="int8"))
    _, carry = init_fn(0)
    with pytest.raises(ValueError, match="integer observations"):
        train_step(carry, torch.Generator().manual_seed(1))


def test_shuffle_blocks_train_and_must_be_shard_local():
    net, init_fn, train_step = _collect_ppo(num_minibatches=2, shuffle_blocks=4)
    before = [p.detach().clone() for p in net.parameters()]
    after, (m,), _ = _run(init_fn, train_step, net)
    assert np.isfinite(m["loss"])
    assert any(not torch.equal(a, b) for a, b in zip(before, after))
    net, init_fn, train_step = _collect_ppo(dp_shards=2, shuffle_blocks=3)
    _, carry = init_fn(0)
    with pytest.raises(ValueError, match="multiple of"):
        train_step(carry, torch.Generator().manual_seed(1))


@pytest.mark.parametrize("family", ["collect", "ctf", "maze"])
def test_train_step_is_deterministic(family):
    """Two learners built alike from one seed take the same two train
    steps, bit for bit: params, metrics and env states.  The params move,
    the losses are finite, and Maze's (B, 1) actions reach its (B,) step."""
    results = []
    for _ in range(2):
        env, _, n_actions, agents = make_family_batch(family, 8, "cpu")
        _, obs = env.reset(0)
        net = tnet.ActorCritic(n_actions, agents, (16, 16), obs_shape=obs.shape[1:])
        init_fn, train_step = tppo.make_ppo(env, net, tppo.PPOConfig(rollout_len=6, num_epochs=2,
                                                                     num_minibatches=2))
        _, carry = init_fn(3)
        before = [p.detach().clone() for p in net.parameters()]
        results.append((before, *_run(init_fn, train_step, net, iters=2, seed=3)))
    (b1, p1, m1, c1), (_, p2, m2, c2) = results
    assert m1 == m2 and all(np.isfinite(m["loss"]) for m in m1)
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))
    assert any(not torch.equal(a, b) for a, b in zip(b1, p1))
    for f in vars(c1.env):
        assert torch.equal(getattr(c1.env, f), getattr(c2.env, f)), f
    assert torch.equal(c1.run_return, c2.run_return)


def test_package_imports_no_jax():
    """The learner modules import nothing of JAX (a fresh interpreter)."""
    import subprocess
    import sys

    code = (
        "import sys; import gym_multigrid_tpu_torch.rl.trainer, gym_multigrid_tpu_torch.rl.families; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'gym_multigrid_tpu')]; assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
