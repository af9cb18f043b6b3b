"""The learner's networks on the CPU: flax's ``ActorCritic`` and
``ConvActorCritic`` carried into the port's modules by ``load_flax_params``
compute the same logits and values (float32 to 1e-5, bfloat16 to 3e-2);
the port's own init has flax's lecun-normal statistics; ``sample_actions``
draws from the softmax and returns the exact log-probability."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from gym_multigrid_tpu.rl import networks as jnet
from gym_multigrid_tpu_torch.envs.collect import CollectConfig
from gym_multigrid_tpu_torch.envs.ctf import CtfConfig, PolicySpec
from gym_multigrid_tpu_torch.parallel.vector import make_collect_batch, make_ctf_batch
from gym_multigrid_tpu_torch.rl import networks as tnet

torch.set_num_threads(1)

BOARD = os.path.join(os.path.dirname(__file__), "assets", "board.txt")
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5), "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


@functools.cache
def _collect_obs(n=16):
    """(B, W, H, 3) uint8 Collect observations a few steps into episodes."""
    env = make_collect_batch(CollectConfig(layout="quadrants_respawn", respawn=True), n, device="cpu")
    states, _ = env.reset(seed=0)
    for _ in range(5):
        acts = torch.randint(0, 4, (n, 2), generator=env.generator, dtype=torch.int32)
        states, obs, *_ = env.step(states, acts)
    return obs.numpy()


@functools.cache
def _ctf_map_obs(n=16):
    """(B, H, W) int32 CtF class maps."""
    cfg = CtfConfig.from_map_path(BOARD, num_blue_agents=2, num_red_agents=2,
                                  enemy_policies=(PolicySpec("rw"), PolicySpec("rw")),
                                  observation_option="map")
    env = make_ctf_batch(cfg, n, device="cpu")
    states, _ = env.reset(seed=0)
    for _ in range(5):
        acts = torch.randint(0, 5, (n, 2), generator=env.generator, dtype=torch.int32)
        states, obs, *_ = env.step(states, acts)
    return obs.numpy()


OBS = {"collect": _collect_obs, "ctf_map": _ctf_map_obs}


def _pair(kind, obs, jdt, tdt):
    """A flax net initialised from a PRNGKey and the port's module with its
    params carried over."""
    if kind == "mlp":
        j = jnet.ActorCritic(num_actions=5, num_agents=2, hidden=(64, 32), activation_dtype=jdt)
        t = tnet.ActorCritic(5, 2, (64, 32), tdt, obs_shape=obs.shape[1:])
    else:
        j = jnet.ConvActorCritic(num_actions=5, num_agents=2, features=(8, 16), hidden=32,
                                 activation_dtype=jdt)
        t = tnet.ConvActorCritic(5, 2, features=(8, 16), hidden=32, activation_dtype=tdt,
                                 obs_shape=obs.shape[1:])
    params = j.init(jax.random.PRNGKey(3), jnp.asarray(obs[:1]))
    tnet.load_flax_params(t, jax.tree_util.tree_map(np.asarray, params))
    return j, params, t


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("obs_kind", OBS)
@pytest.mark.parametrize("kind", ["mlp", "conv"])
def test_forward_matches_flax(kind, obs_kind, dtype):
    jdt, tdt, atol = DTYPES[dtype]
    obs = OBS[obs_kind]()
    j, params, t = _pair(kind, obs, jdt, tdt)
    jl, jv = j.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        tl, tv = t(torch.from_numpy(obs))
    assert tl.dtype == tv.dtype == torch.float32
    assert tuple(tl.shape) == (obs.shape[0], 2, 5) and tuple(tv.shape) == (obs.shape[0],)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=atol)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=atol)


def test_load_flax_params_refuses_other_shapes():
    obs = np.zeros((1, 10, 10, 3), np.uint8)
    params = jnet.ActorCritic(num_actions=4, hidden=(8,)).init(jax.random.PRNGKey(0), obs)
    params = jax.tree_util.tree_map(np.asarray, params)
    with pytest.raises(ValueError, match="do not fit"):
        tnet.load_flax_params(tnet.ActorCritic(4, hidden=(16,), obs_shape=(10, 10, 3)), params)
    for other in (tnet.ActorCritic(4, hidden=(8, 8), obs_shape=(10, 10, 3)),
                  tnet.ConvActorCritic(4, features=(8,), hidden=8, obs_shape=(10, 10, 3))):
        with pytest.raises(ValueError, match="flax params have layers"):
            tnet.load_flax_params(other, params)


def test_init_has_lecun_normal_statistics():
    """Each kernel, pooled over 12 seeds, has std within 5% of
    sqrt(1 / fan_in) and no value past two of flax's pre-truncation
    standard deviations; every bias is zero.  One seed gives the same
    weights twice."""
    nets = {
        "mlp": lambda: tnet.ActorCritic(5, 2, (64, 32), obs_shape=(10, 10, 3)),
        "conv": lambda: tnet.ConvActorCritic(5, 2, features=(8, 16), hidden=32, obs_shape=(9, 9)),
    }
    for make in nets.values():
        net = make()
        pooled = {n: [] for n, p in net.named_parameters() if n.endswith("weight")}
        for seed in range(12):
            net.reset_parameters(torch.Generator().manual_seed(seed))
            for n, p in net.named_parameters():
                if n.endswith("bias"):
                    assert not p.any(), n
                else:
                    pooled[n].append(p.detach().reshape(-1).clone())
        for n, ws in pooled.items():
            w = torch.cat(ws)
            fan_in = dict(net.named_parameters())[n][0].numel()
            target = (1.0 / fan_in) ** 0.5
            assert abs(float(w.std()) / target - 1) < 0.05, (n, float(w.std()), target)
            assert float(w.abs().max()) <= 2 * target / 0.87962566103423978 + 1e-7
        a, b = make(), make()
        a.reset_parameters(torch.Generator().manual_seed(5))
        b.reset_parameters(torch.Generator().manual_seed(5))
        assert all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))


def test_sample_actions_follow_the_softmax():
    """Over 20,000 draws of three agents' logits, the counts of each
    agent's actions fit the softmax (chi-square, p > 1e-3), and logp is
    the sum over agents of log_softmax at the drawn actions."""
    logits = torch.tensor([[[2.0, 0.0, -1.0, 0.5, -3.0],
                            [0.0, 0.0, 0.0, 0.0, 0.0],
                            [-1.0, 3.0, 1.0, 0.0, 2.0]]])
    n = 20000
    g = torch.Generator().manual_seed(0)
    acts, logp = tnet.sample_actions(logits.expand(n, -1, -1), g)
    assert acts.dtype == torch.int32 and tuple(acts.shape) == (n, 3)
    probs = torch.softmax(logits[0], dim=-1).double().numpy()
    for a in range(3):
        counts = np.bincount(acts[:, a].numpy(), minlength=5)
        want = probs[a] / probs[a].sum() * counts.sum()
        assert stats.chisquare(counts, want).pvalue > 1e-3, (a, counts)
    want = torch.log_softmax(logits[0], -1).gather(1, acts.T.long()).T.sum(-1)
    np.testing.assert_allclose(logp.numpy(), want.numpy(), rtol=0, atol=2e-6)
