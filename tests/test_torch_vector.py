"""The port's batched Collect env (``BatchedEnv``, ``make_collect_batch``)
on the CPU: the rollout's metric invariants, its reward rate against the
JAX batch env, seeding, the autoreset convention, the device rule, and
that the package runs without JAX."""

import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gym_multigrid_tpu.envs.collect import CollectConfig as JaxCollectConfig
from gym_multigrid_tpu.parallel.vector import make_collect_batch as jax_make_batch
from gym_multigrid_tpu_torch.envs.collect import BALL, AGENT, CollectConfig
from gym_multigrid_tpu_torch.parallel.vector import make_collect_batch

torch.set_num_threads(1)

MAIN = dict(layout="quadrants_respawn", respawn=True, max_steps=50)
N_BALLS = 15


def _env(n, **kw):
    return make_collect_batch(CollectConfig(**{**MAIN, **kw}), n, device="cpu")


def _count(states, obj):
    return (states.grid_obj == obj).sum(dim=1)


def test_rollout_keeps_metric_invariants_over_two_episodes():
    n = 32
    env = _env(n)
    states, obs = env.reset(seed=0)
    assert obs.shape == (n, 10, 10, 3) and obs.dtype == torch.uint8
    states, m1 = env.rollout(states, 30)
    # Mid-episode: balls only lost to respawn stomps, two agents a board.
    balls = _count(states, BALL)
    assert (balls <= N_BALLS).all() and (balls >= N_BALLS - states.collected).all()
    assert (_count(states, AGENT) == 2).all()
    # Every ball, placed or respawned, lies in its colour's partition.
    rects = env.slab.respawn_rects
    for c in range(rects.shape[0]):
        of_c = (states.grid_obj == BALL) & (states.grid_color == c)
        assert not (of_c & ~rects[c]).any()
    assert (states.grid_slot >= env.slab.t.respawn_slot_base).any()  # respawns seen
    assert int(m1["episodes"]) == 0
    states, m2 = env.rollout(states, 70, run_return=m1["run_return"])
    # Lockstep truncation at 50: every env finished 2 episodes in 100 steps.
    assert int(m2["episodes"]) == 2 * n
    assert (states.step_count == 0).all() and (states.collected == 0).all()
    assert (_count(states, BALL) == N_BALLS).all()
    np.testing.assert_array_equal(m2["run_return"].numpy(), np.zeros(n, np.float32))
    total = float(m1["reward_sum"]) + float(m2["reward_sum"])
    assert total > 0
    assert float(m2["ep_return_sum"]) == pytest.approx(total, rel=1e-6)


def test_reward_rate_agrees_with_jax_batch_env():
    n, steps, seeds = 64, 50, (0, 1)
    jenv = jax_make_batch(JaxCollectConfig(**MAIN), n)
    run = jax.jit(lambda s, k: jenv.rollout(s, k, steps))
    want = []
    for seed in seeds:
        states, _ = jenv.reset(jax.random.PRNGKey(seed))
        want.append(float(run(states, jax.random.PRNGKey(seed + 100))[1]["reward_sum"]))
    env = _env(n)
    got = []
    for seed in seeds:
        states, _ = env.reset(seed=seed)
        got.append(float(env.rollout(states, steps)[1]["reward_sum"]))
    per_agent_step = n * steps * 2
    rate_jax = np.mean(want) / per_agent_step
    rate_port = np.mean(got) / per_agent_step
    assert abs(rate_jax - rate_port) < 0.03, (rate_jax, rate_port)


def test_step_returns_pre_reset_obs_and_resets_done_envs():
    n = 8
    env = _env(n, max_steps=3)
    states, _ = env.reset(seed=4)
    acts = torch.zeros((n, 2), dtype=torch.int32)  # everyone walks north
    for step in range(1, 4):
        states, obs, rewards, term, trunc = env.step(states, acts)
        assert rewards.shape == (n, 2) and rewards.dtype == torch.float32
        assert not term.any()
        assert bool(trunc.all()) == (step == 3)
    # The returned obs is the final board: nothing but walls blocks a move
    # north, so the agents stand three rows up from (1, 8) and (2, 8).
    # The states are freshly reset: agents back on row 8.
    assert (obs[:, 1:3, 5, 0] == AGENT).all() and (obs[:, 1:3, 5, 2] == 3).all()
    assert (obs[:, 1:3, 8, 0] != AGENT).all()
    assert (states.step_count == 0).all()
    np.testing.assert_array_equal(
        states.agent_pos.numpy(), np.tile([[1, 8], [2, 8]], (n, 1, 1))
    )
    with pytest.raises(ValueError, match="actions must have shape"):
        env.step(states, torch.zeros((n + 1, 2), dtype=torch.int32))


def test_reset_seed_reproduces_boards():
    env = _env(16)
    a, obs_a = env.reset(seed=3)
    b, obs_b = env.reset(seed=3)
    c, _ = env.reset(seed=4)
    torch.testing.assert_close(obs_a, obs_b, rtol=0, atol=0)
    for f in ("grid_obj", "grid_color", "grid_slot", "agent_pos"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    assert not torch.equal(a.grid_obj, c.grid_obj)


def test_no_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_collect_batch(CollectConfig(**MAIN), 8)


def test_package_imports_no_jax():
    code = """
import importlib, pkgutil, sys
import gym_multigrid_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
loaded = [n for n in sys.modules
          if n == "jax" or n.startswith(("jax.", "jaxlib"))
          or n == "gym_multigrid_tpu" or n.startswith("gym_multigrid_tpu.")]
assert not loaded, loaded
print(" ".join(n for n in sys.modules if n.startswith("gym_multigrid_tpu_torch")))
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    walked = set(out.stdout.split())
    assert len(walked) >= 10  # the package and every module in it
    for module in ("core.world", "utils.map", "policy.ctf.heuristic", "ops.sampling",
                   "envs.ctf", "ops.ctf_slab", "envs.maze", "ops.maze_slab",
                   "envs.wildfire", "ops.wildfire_slab", "parallel.vector"):
        assert f"gym_multigrid_tpu_torch.{module}" in walked, module
