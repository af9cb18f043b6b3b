"""The port's worked example (``gym_multigrid_tpu_torch/examples/custom_env.py``)
against the JAX package's (``examples/custom_env.py``), on the CPU: the two
tests of ``tests/test_example.py`` on the port's batch functions, the
batch step held to JAX's ``step_one`` (vmapped, eager) with tolerance 0,
the masked reset, the per-agent rewards summed into PPO's team reward,
and the example's ``main`` at a tiny size."""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_multigrid_tpu_torch.examples import custom_env as port
from gym_multigrid_tpu_torch.rl.networks import ActorCritic
from gym_multigrid_tpu_torch.rl.ppo import PPOConfig, make_ppo

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "examples")
)

import custom_env as jax_example  # noqa: E402  (the JAX package's example)

torch.set_num_threads(1)


def _state(pursuers, prey, step_count):
    return port.PursuitState(
        pursuers=torch.as_tensor(pursuers, dtype=torch.int32),
        prey=torch.as_tensor(prey, dtype=torch.int32),
        step_count=torch.as_tensor(step_count, dtype=torch.int32),
    )


def test_pursuit_core_semantics():
    cfg = port.PursuitConfig(size=7, num_agents=2, max_steps=10)
    slab = port.make_pursuit(cfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    s = port.reset_batch(slab, 16, generator=gen)
    # Distinct start cells in every env.
    cells = torch.cat([s.pursuers, s.prey[:, None]], dim=1).numpy()
    assert all(len({tuple(c) for c in row}) == 3 for row in cells)
    # Stepping with all-stay keeps the pursuers (the scripted prey moves).
    stay = torch.zeros((16, 2), dtype=torch.int32)
    s2, obs, r, term, trunc, _ = port.step_batch(slab, s, stay, generator=gen)
    assert obs.shape == (16, (cfg.num_agents + 1) * 2) and obs.dtype == torch.float32
    assert r.shape == (16, cfg.num_agents)
    assert torch.equal(s2.pursuers, s.pursuers)
    assert not torch.equal(s2.prey, s.prey)
    # Toroidal wrap: a pursuer at the west edge moving west appears east.
    s_edge = _state([[[0, 0], [3, 3]]], [[5, 5]], [0])
    s3, *_ = port.step_batch(slab, s_edge, torch.tensor([[1, 0]]))
    assert tuple(s3.pursuers[0, 0].tolist()) == (0, cfg.size - 1)
    # Every env ends by cornering or truncation at max_steps.
    ended = torch.zeros(16, dtype=torch.bool)
    for _ in range(cfg.max_steps):
        s, _, _, term, trunc, _ = port.step_batch(slab, s, stay, encode_obs=False)
        ended |= term | trunc
    assert bool(ended.all())
    assert bool(trunc.any() | term.any())


def test_pursuit_batch_rollout_and_ppo_step():
    cfg = port.PursuitConfig(size=7, num_agents=2, max_steps=12)
    env = port.make_pursuit_batch(cfg, num_envs=32, device="cpu")
    states, obs = env.reset(seed=0)
    assert obs.shape == (32, 6)
    states, metrics = env.rollout(states, 24)
    assert int(metrics["episodes"]) > 0
    assert np.isfinite(float(metrics["ep_return_sum"]))
    # Determinism: same seed, same metrics.
    states2, _ = env.reset(seed=0)
    _, m2 = env.rollout(states2, 24)
    assert float(m2["reward_sum"]) == float(metrics["reward_sum"])

    net = ActorCritic(port.NUM_ACTIONS, cfg.num_agents, obs_shape=(6,))
    init_fn, train_step = make_ppo(env, net, PPOConfig(rollout_len=8, num_minibatches=2))
    _, carry = init_fn(2)
    carry, m = train_step(carry, torch.Generator().manual_seed(3))
    assert np.isfinite(float(m["loss"]))


def _jax_states(pursuers, prey, step_count):
    return jax_example.PursuitState(
        pursuers=jnp.asarray(pursuers, jnp.int32),
        prey=jnp.asarray(prey, jnp.int32),
        step_count=jnp.asarray(step_count, jnp.int32),
        key=jax.random.split(jax.random.PRNGKey(0), len(prey)),
    )


@pytest.mark.parametrize("size,agents", [(7, 2), (9, 3)])
def test_step_matches_jax_step_one(size, agents):
    """64 rows of distinct-cell states and actions (ids -1..6, clipped by
    both) from a numpy seed, 3 chained steps: the port's batch step equals
    JAX's ``step_one`` vmapped, eager, field for field, tolerance 0."""
    cfg = dict(size=size, num_agents=agents)
    slab = port.make_pursuit(port.PursuitConfig(**cfg), "cpu")
    _, step_one, _ = jax_example.make_pursuit(jax_example.PursuitConfig(**cfg))
    vstep = jax.vmap(step_one)
    rng = np.random.default_rng(size * 10 + agents)
    n, W, A = 64, size, agents
    cells = np.stack([rng.permutation(W * W)[: A + 1] for _ in range(n)])
    pos = np.stack([cells // W, cells % W], axis=2).astype(np.int32)
    sc = rng.integers(0, 60, n).astype(np.int32)  # some rows truncate within 3 steps
    acts = rng.integers(-1, 7, (3, n, A)).astype(np.int32)
    p_state = _state(pos[:, :A], pos[:, A], sc)
    j_state = _jax_states(pos[:, :A], pos[:, A], sc)
    ended = 0
    for t in range(3):
        p_state, p_obs, p_r, p_term, p_trunc, _ = port.step_batch(
            slab, p_state, torch.from_numpy(acts[t]))
        j_state, j_obs, j_r, j_term, j_trunc, _ = vstep(j_state, jnp.asarray(acts[t]))
        for got, want in ((p_state.pursuers, j_state.pursuers), (p_state.prey, j_state.prey),
                          (p_state.step_count, j_state.step_count), (p_term, j_term),
                          (p_trunc, j_trunc), (p_obs, j_obs), (p_r, j_r)):
            want = np.asarray(want)
            assert got.numpy().dtype == want.dtype
            np.testing.assert_array_equal(got.numpy(), want)
        ended += int((p_term | p_trunc).sum())
    assert ended > 0


def test_masked_reset_resets_only_done_rows():
    cfg = port.PursuitConfig()
    slab = port.make_pursuit(cfg, "cpu")
    gen = torch.Generator().manual_seed(5)
    s = port.reset_batch(slab, 32, generator=gen)
    for _ in range(5):
        s, *_ = port.step_batch(slab, s, torch.randint(0, 5, (32, 3), generator=gen))
    done = torch.arange(32) % 3 == 0
    r = port.reset_batch(slab, 32, generator=gen, done=done, states=s)
    assert torch.equal(r.step_count, torch.where(done, 0, s.step_count))
    keep = ~done
    assert torch.equal(r.pursuers[keep], s.pursuers[keep]) and torch.equal(r.prey[keep],
                                                                          s.prey[keep])
    cells = torch.cat([r.pursuers, r.prey[:, None]], dim=1)[done].numpy()
    assert all(len({tuple(c) for c in row}) == 4 for row in cells)
    assert not torch.equal(r.pursuers[done], s.pursuers[done])


def test_ppo_sums_per_agent_rewards_into_the_team_reward():
    """PPO's rollout stores (T, B) team rewards: the (B, A) per-agent
    rewards of the same steps, replayed on the same draws, summed."""
    cfg = port.PursuitConfig(size=7, num_agents=2, max_steps=6)
    env = port.make_pursuit_batch(cfg, num_envs=16, device="cpu")
    net = ActorCritic(port.NUM_ACTIONS, cfg.num_agents, obs_shape=(6,),
                      activation_dtype=torch.float32)
    init_fn, train_step = make_ppo(env, net, PPOConfig(rollout_len=8, num_minibatches=2))
    _, carry = init_fn(0)
    states, env_draws = carry.env, env.generator.get_state()
    _, traj, _, _ = train_step.rollout(carry, torch.Generator().manual_seed(1))
    assert traj.reward.shape == (8, 16)
    env.generator.set_state(env_draws)
    for t in range(8):
        states, _, rewards, term, trunc = env.step(states, traj.actions[t])
        assert rewards.shape == (16, 2)
        assert torch.equal(traj.reward[t], rewards.sum(dim=1))
        assert torch.equal(traj.terminated[t], term.float())
        assert torch.equal(traj.truncated[t], trunc.float())
    assert bool(traj.truncated.any() | traj.terminated.any())


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        port.make_pursuit_batch(port.PursuitConfig(), 4)


def test_main_runs_tiny(capsys, monkeypatch):
    monkeypatch.setattr(port, "ENVS", 8)
    monkeypatch.setattr(port, "RANDOM_STEPS", 70)
    monkeypatch.setattr(port, "ITERS", 2)
    res = port.main(["--cpu"])
    out = capsys.readouterr().out
    assert "random policy:" in out and "PPO after 2 iters" in out
    assert res["device"] == "cpu" and res["random_episodes"] > 0
    assert len(res["losses"]) == 2 and all(np.isfinite(res["losses"]))
