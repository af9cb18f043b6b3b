"""Training with the port on the CPU: PPO learns Collect at JAX's own bar
(``tests/test_training.py``), the metrics logger round-trips and continues
its step axis, ``train_loop`` resumes bit for bit, checkpoints keep every
leaf, and ``make_family_batch`` builds all four families with the JAX
registry's ``obs_option`` checks."""

import os

import numpy as np
import pytest
import torch

from gym_multigrid_tpu_torch.envs.collect import CollectConfig
from gym_multigrid_tpu_torch.parallel.vector import make_collect_batch
from gym_multigrid_tpu_torch.rl.families import FAMILIES, make_family_batch
from gym_multigrid_tpu_torch.rl.networks import ActorCritic
from gym_multigrid_tpu_torch.rl.ppo import PPOConfig, make_ppo
from gym_multigrid_tpu_torch.rl.trainer import resume_or_init, train_loop
from gym_multigrid_tpu_torch.utils.checkpoint import load_state, save_state
from gym_multigrid_tpu_torch.utils.logging import MetricsLogger, read_metrics_csv

torch.set_num_threads(1)


def test_ppo_learns_collect():
    """``test_ppo_learns_collect``'s config and bar: mean reward per step
    over the last quarter of 60 iterations beats the first five by 1.3x."""
    cfg = CollectConfig(layout="quadrants", respawn=False, max_steps=30)
    env = make_collect_batch(cfg, 64, device="cpu")
    net = ActorCritic(num_actions=4, num_agents=2, hidden=(64, 64), obs_shape=(10, 10, 3))
    init_fn, train_step = make_ppo(
        env, net, PPOConfig(rollout_len=16, num_epochs=2, num_minibatches=4, lr=1e-3))
    _, carry = init_fn(0)
    generator = torch.Generator().manual_seed(1)
    hist = []
    for _ in range(60):
        carry, metrics = train_step(carry, generator)
        hist.append({k: float(v) for k, v in metrics.items()})
    early = np.mean([h["reward_per_step"] for h in hist[:5]])
    late = np.mean([h["reward_per_step"] for h in hist[-15:]])
    assert late > early * 1.3, (early, late)
    assert hist[-1]["episodes"] > 0
    assert np.isfinite(hist[-1]["ep_return_mean"])


def test_metrics_logger_roundtrip(tmp_path):
    logger = MetricsLogger(str(tmp_path), use_tensorboard=False)
    for i in range(4):
        logger.log(i, {"a": i * 1.5, "b": -i})
    logger.close()
    m = read_metrics_csv(str(tmp_path / "metrics.csv"))
    assert m["step"] == [0.0, 1.0, 2.0, 3.0]
    assert m["a"] == [0.0, 1.5, 3.0, 4.5]
    assert m["b"][3] == -3.0


def test_metrics_logger_resume_continues_step_axis(tmp_path):
    """Appending adopts the existing header, reports last_step, and warns
    on unknown keys instead of misaligning rows."""
    l1 = MetricsLogger(str(tmp_path), use_tensorboard=False)
    assert l1.last_step == -1
    for i in range(3):
        l1.log(i, {"a": float(i), "b": 0.0})
    l1.close()
    l2 = MetricsLogger(str(tmp_path), use_tensorboard=False)
    assert l2.last_step == 2
    l2.log(3, {"a": 3.0, "b": 1.0})
    with pytest.warns(UserWarning, match="new_key"):
        l2.log(4, {"a": 4.0, "b": 1.0, "new_key": 9.0})
    l2.close()
    m = read_metrics_csv(str(tmp_path / "metrics.csv"))
    assert m["step"] == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert m["a"] == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert "new_key" not in m


def _loop(env, out, iters):
    net = ActorCritic(4, 2, (16, 16), obs_shape=(10, 10, 3))
    result = train_loop(env, net, PPOConfig(rollout_len=4, num_minibatches=2), iters=iters,
                        out=out, model_name="m", use_tensorboard=False)
    return net, result


def test_train_loop_resume_semantics(tmp_path):
    """Two iterations, saved, then two more equal four straight, bit for
    bit (params, optimizer moments, env states, metrics); the step axis
    continues; another env batch resumes the params only; a fresh model
    rotates stale logs aside."""
    cfg = CollectConfig(layout="quadrants", max_steps=10)
    env = make_collect_batch(cfg, 8, device="cpu")
    straight, resumed = str(tmp_path / "straight"), str(tmp_path / "resumed")
    n4, (o4, c4, g4, m4) = _loop(env, straight, 4)
    _loop(env, resumed, 2)
    n2, (o2, c2, g2, m2) = _loop(env, resumed, 2)
    assert m2 == m4
    assert all(torch.equal(a, b) for a, b in zip(n4.parameters(), n2.parameters()))
    for s4, s2 in zip(o4.state.values(), o2.state.values()):
        assert all(torch.equal(s4[k], s2[k]) for k in s4)
    for f in vars(c4.env):
        assert torch.equal(getattr(c4.env, f), getattr(c2.env, f)), f
    assert torch.equal(c4.run_return, c2.run_return)
    assert torch.equal(g4.get_state(), g2.get_state())
    m = read_metrics_csv(os.path.join(resumed, "logs", "metrics.csv"))
    assert m["step"] == [0.0, 1.0, 2.0, 3.0]
    assert m["loss"] == read_metrics_csv(os.path.join(straight, "logs", "metrics.csv"))["loss"]

    # Another env batch: the params only, fresh env states of that batch.
    env16 = make_collect_batch(cfg, 16, device="cpu")
    net16 = ActorCritic(4, 2, (16, 16), obs_shape=(10, 10, 3))
    init16, _ = make_ppo(env16, net16, PPOConfig(rollout_len=4))
    opt, carry, _, was_resumed = resume_or_init(init16, os.path.join(resumed, "models", "m"),
                                                env16, net16)
    assert was_resumed and carry.env.grid_obj.shape[0] == 16
    assert all(torch.equal(a, b) for a, b in zip(net16.parameters(), n2.parameters()))
    assert not opt.state

    # A fresh model with stale logs: the whole log dir moves aside.
    os.remove(os.path.join(resumed, "models", "m.npz"))
    _loop(env, resumed, 1)
    assert read_metrics_csv(os.path.join(resumed, "logs", "metrics.csv"))["step"] == [0.0]
    assert os.path.exists(os.path.join(resumed, "logs.old1", "metrics.csv"))


def test_checkpoint_round_trip(tmp_path):
    """Every leaf kind comes back with its type, dtype and value: bfloat16
    and integer tensors, int dict keys, tuples, None, floats, strings."""
    state = {
        "w": torch.randn(3, 4).to(torch.bfloat16),
        "i": torch.arange(6, dtype=torch.int32).reshape(2, 3),
        "b": torch.tensor([True, False]),
        "opt": {0: {"step": torch.tensor(3.0)}, 1: {}},
        "groups": [{"betas": (0.9, 0.999), "lr": 3e-4, "foreach": None, "name": "adam"}],
        "gen": torch.Generator().manual_seed(4).get_state(),
    }
    save_state(str(tmp_path / "ck"), state)
    back = load_state(str(tmp_path / "ck.npz"))
    for k in ("w", "i", "b", "gen"):
        assert back[k].dtype == state[k].dtype and torch.equal(back[k], state[k]), k
    assert back["opt"][0]["step"] == 3.0 and back["opt"][1] == {}
    assert back["groups"] == state["groups"]
    assert not os.path.exists(tmp_path / "ck.pkl")


@pytest.mark.parametrize("family", FAMILIES)
def test_make_family_batch_builds_every_family(family):
    env, cfg, num_actions, agents = make_family_batch(family, 4, "cpu")
    states, obs = env.reset(0)
    assert obs.shape[0] == 4 and env.device.type == "cpu"
    assert num_actions == env.num_actions
    assert agents == (1 if family == "maze" else env.actions_shape[1])
    actions = torch.zeros((4, agents), dtype=torch.int32).reshape(env.actions_shape)
    env.step(states, actions)


def test_family_obs_option_validation():
    with pytest.raises(ValueError, match="not trainable"):
        make_family_batch("ctf", 4, "cpu", obs_option="positional")
    with pytest.raises(ValueError, match="fixed grid observation"):
        make_family_batch("wildfire", 4, "cpu", obs_option="map")
    with pytest.raises(ValueError, match="not trainable"):
        make_family_batch("maze", 4, "cpu", obs_option="positional")
    with pytest.raises(ValueError, match="unknown family"):
        make_family_batch("chess", 4, "cpu")
    env, cfg, _, _ = make_family_batch("ctf", 4, "cpu", obs_option="map")
    assert cfg.observation_option == "map" and env.reset(0)[1].ndim == 3


def test_no_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_family_batch("collect", 4)
