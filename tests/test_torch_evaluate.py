"""Evaluation of the port (``rl/evaluate.py``) and the batch env hooks it
drives (``BatchedEnv.rollout(policy=...)``, ``auto_reset``), against the
JAX package's ``rl/evaluate.py``.

``_outcome_update`` is compared bit for bit on injected steps that take
every outcome branch (the rewards are multiples of 1/4, so every float32
sum is exact in any order).  Greedy actions from carried-over float32
flax params equal JAX's wherever JAX's top two logits are more than 1e-4
apart.  ``evaluate_ctf``'s outcome rates agree with JAX's within a
binomial bound: the two draw from different generators (and spawn with
``PickState`` where JAX's reset uses ``choice``), so they agree in
distribution only.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_multigrid_tpu.envs import collect as jcollect
from gym_multigrid_tpu.envs import ctf as jctf
from gym_multigrid_tpu.parallel import vector as jv
from gym_multigrid_tpu.rl import evaluate as jeval
from gym_multigrid_tpu.rl import networks as jnet
from gym_multigrid_tpu_torch.envs import collect as tcollect
from gym_multigrid_tpu_torch.envs import ctf as tctf
from gym_multigrid_tpu_torch.envs.maze import MazeConfig
from gym_multigrid_tpu_torch.parallel import vector as tv
from gym_multigrid_tpu_torch.rl import evaluate as teval
from gym_multigrid_tpu_torch.rl import networks as tnet
from gym_multigrid_tpu_torch.rl.families import make_family_batch
from gym_multigrid_tpu_torch.utils.checkpoint import save_state

torch.set_num_threads(1)

BOARD = os.path.join(os.path.dirname(__file__), "assets", "board.txt")
F32 = torch.float32


def _ctf_cfg(m, max_steps=20, policies=("rw", "rw")):
    return m.CtfConfig.from_map_path(
        BOARD, num_blue_agents=2, num_red_agents=len(policies), variant="mvn",
        enemy_policies=tuple(m.PolicySpec(p) for p in policies),
        observation_option="flattened", max_steps=max_steps)


def test_outcome_update_matches_jax():
    """Three chained updates of 64 envs whose (term, trunc, red flag, blue
    flag) cover every combination: wins, losses by capture and by a
    terminal without one, draws by truncation and by both captures."""
    rng = np.random.default_rng(0)
    B = 64
    jacc, tacc = jeval._outcome_acc0(B), teval._outcome_acc0(B, "cpu")
    combos = np.array([[(k >> i) & 1 for i in range(4)] for k in range(16)], bool)
    for step in range(3):
        flags = combos[(np.arange(B) + 5 * step) % 16]
        term, trunc, rf, bf = (flags[:, i].copy() for i in range(4))
        trunc[rng.random(B) < 0.3] = False
        rew = (rng.integers(-8, 9, B) / 4).astype(np.float32)
        jdone, jacc = jeval._outcome_update(
            jacc, jnp.asarray(rew), jnp.asarray(term), jnp.asarray(trunc),
            {"red_flag_captured": jnp.asarray(rf), "blue_flag_captured": jnp.asarray(bf)})
        tdone, tacc = teval._outcome_update(
            tacc, torch.tensor(rew), torch.tensor(term), torch.tensor(trunc),
            {"red_flag_captured": torch.tensor(rf), "blue_flag_captured": torch.tensor(bf)})
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        assert sorted(tacc) == sorted(jacc)
        for k in jacc:
            want = np.asarray(jacc[k])
            got = tacc[k].numpy()
            assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want, err_msg=k)
    got = teval._outcome_summary(tacc, 3, B)
    assert got == jeval._outcome_summary(jacc, 3, B)
    assert got["wins"] and got["losses"] and got["draws"]
    assert got["wins"] + got["losses"] + got["draws"] == got["episodes"]


def _jax_case(family):
    """(JAX env, its states, port env, port states) at B = 64."""
    if family == "collect":
        kw = dict(layout="quadrants_respawn", respawn=True, max_steps=50)
        jenv = jv.make_collect_batch(jcollect.CollectConfig(**kw), 64)
        tenv = tv.make_collect_batch(tcollect.CollectConfig(**kw), 64, "cpu")
        to_t = tcollect.state_from_numpy
    else:
        jenv = jv.make_ctf_batch(_ctf_cfg(jctf), 64)
        tenv = tv.make_ctf_batch(_ctf_cfg(tctf), 64, "cpu")
        to_t = tctf.ctf_state_from_numpy
    js, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(4))
    return jenv, js, tenv, to_t({k: np.asarray(v) for k, v in vars(js).items()}, "cpu")


@pytest.mark.parametrize("family", ["collect", "ctf"])
def test_make_policy_greedy_matches_jax(family):
    jenv, js, tenv, ts = _jax_case(family)
    A, n = (2, 4) if family == "collect" else (2, 5)
    fnet = jnet.ActorCritic(num_actions=n, num_agents=A, hidden=(32, 32),
                            activation_dtype=jnp.float32)
    obs = jax.vmap(jenv.encode_one)(js)
    params = fnet.init(jax.random.PRNGKey(9), obs[:1])
    want = np.asarray(jeval.make_policy(jenv, fnet)(params, jax.random.PRNGKey(0), js))
    net = tnet.ActorCritic(n, A, (32, 32), F32, obs_shape=obs.shape[1:])
    tnet.load_flax_params(net, params)
    got = teval.make_policy(tenv, net)(torch.Generator(), ts)
    assert got.dtype == torch.int32 and tuple(got.shape) == tenv.actions_shape
    top2 = np.sort(np.asarray(fnet.apply(params, obs)[0]), axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-4
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got.numpy()[clear], want[clear])
    # sampling draws actions of the same shape from the generator
    a = teval.make_policy(tenv, net, deterministic=False)(torch.Generator().manual_seed(1), ts)
    b = teval.make_policy(tenv, net, deterministic=False)(torch.Generator().manual_seed(1), ts)
    assert torch.equal(a, b) and a.shape == got.shape


def _collect_eval_setup():
    env, cfg, n_actions, agents = make_family_batch("collect", 8, "cpu")
    net = tnet.ActorCritic(n_actions, agents, (16,), F32, obs_shape=env.reset(0)[1].shape[1:])
    return env, net


def test_evaluate_counts_episodes_and_is_deterministic():
    env, net = _collect_eval_setup()
    # max_steps=50: every env truncates once within 55 steps
    res = teval.evaluate(env, net, 55, seed=2)
    assert res["episodes"] >= 8
    assert np.isfinite(res["ep_return_mean"]) and np.isfinite(res["reward_per_step"])
    assert teval.evaluate(env, net, 55, seed=2) == res
    sampled = teval.evaluate(env, net, 55, seed=2, deterministic=False)
    assert teval.evaluate(env, net, 55, seed=2, deterministic=False) == sampled


def test_evaluate_ctf_outcomes_partition_episodes():
    cfg = _ctf_cfg(tctf, max_steps=20)
    obs_shape = tv.make_ctf_batch(cfg, 1, "cpu").reset(0)[1].shape[1:]
    net = tnet.ActorCritic(5, 2, (16,), F32, obs_shape=obs_shape)
    res = teval.evaluate_ctf(cfg, 8, net, 25, seed=3, deterministic=False, device="cpu")
    assert res["episodes"] >= 8
    assert res["wins"] + res["losses"] + res["draws"] == res["episodes"]
    for k in ("win_rate", "loss_rate", "draw_rate"):
        assert 0.0 <= res[k] <= 1.0
    assert 0 < res["ep_len_mean"] <= 20
    assert np.isfinite(res["ep_return_mean"])
    again = teval.evaluate_ctf(cfg, 8, net, 25, seed=3, deterministic=False, device="cpu")
    assert again == res


def test_evaluate_ctf_rates_match_jax():
    """Carried-over float32 params, the greedy policy, B = 64 and 60 steps
    of 20-step episodes on each side: each outcome rate within four
    standard errors of the difference of two binomial rates (plus one
    episode in a hundred for the episodes' correlation within an env)."""
    jcfg, tcfg = _ctf_cfg(jctf, policies=("fight", "capture")), \
        _ctf_cfg(tctf, policies=("fight", "capture"))
    fnet = jnet.ActorCritic(num_actions=5, num_agents=2, hidden=(32, 32),
                            activation_dtype=jnp.float32)
    obs = tv.make_ctf_batch(tcfg, 1, "cpu").reset(0)[1]
    params = fnet.init(jax.random.PRNGKey(2), jnp.asarray(obs.numpy()))
    want = jeval.evaluate_ctf(jcfg, 64, fnet, params, jax.random.PRNGKey(5), 60)
    net = tnet.ActorCritic(5, 2, (32, 32), F32, obs_shape=obs.shape[1:])
    tnet.load_flax_params(net, params)
    got = teval.evaluate_ctf(tcfg, 64, net, 60, seed=5, device="cpu")
    assert sorted(got) == sorted(want)
    n1, n2 = want["episodes"], got["episodes"]
    assert min(n1, n2) > 150
    for k in ("win_rate", "loss_rate", "draw_rate"):
        p = (want[k] * n1 + got[k] * n2) / (n1 + n2)
        bound = 4 * np.sqrt(p * (1 - p) * (1 / n1 + 1 / n2)) + 0.01
        assert abs(got[k] - want[k]) <= bound, (k, got[k], want[k], bound)


def test_load_params_takes_both_layouts(tmp_path):
    net = tnet.ActorCritic(4, 2, (8,), F32, obs_shape=(3, 3, 3))
    sd = net.state_dict()
    other = {k: v + 1 for k, v in sd.items()}
    opt = torch.optim.Adam(net.parameters())
    save_state(str(tmp_path / "full"), {"net": sd, "optimizer": opt.state_dict(),
                                        "env": {"step_count": torch.zeros(4)}})
    save_state(str(tmp_path / "selfplay"), {"blue_params": sd, "red_params": other,
                                            "pool": [other]})
    save_state(str(tmp_path / "bare"), sd)
    for name in ("full", "selfplay", "bare"):
        got = teval.load_params(str(tmp_path / name))
        assert sorted(got) == sorted(sd)
        assert all(torch.equal(got[k], sd[k]) for k in sd), name
        net.load_state_dict(got)


def test_rollout_takes_a_policy():
    """``rollout(policy=...)`` steps with the policy's actions: a Maze agent
    that always stays never moves and earns the step penalty each step;
    a uniform draw over one action id does the same."""
    cfg = MazeConfig.from_map_path(os.path.join(os.path.dirname(__file__), "assets",
                                                "board_maze.txt"))
    env = tv.make_maze_batch(cfg, 16, "cpu")
    states, _ = env.reset(0)
    seen = []

    def stay(generator, s):
        seen.append(generator is env.generator)
        return torch.zeros(env.actions_shape, dtype=torch.int32)

    end, m = env.rollout(states, 5, policy=stay)
    assert seen == [True] * 5
    assert torch.equal(end.pos, states.pos) and int(m["episodes"]) == 0
    assert float(m["reward_sum"]) == pytest.approx(-cfg.step_penalty * 16 * 5)
    end2, m2 = env.rollout(states, 5, num_actions=1)
    assert torch.equal(end2.pos, states.pos)
    assert float(m2["reward_sum"]) == float(m["reward_sum"])


def test_auto_reset_false_keeps_finished_envs():
    cfg = tcollect.CollectConfig(max_steps=3)
    env = tv.make_collect_batch(cfg, 8, "cpu", auto_reset=False)
    states, _ = env.reset(0)
    for k in range(5):
        states, _, _, _, trunc = env.step(states, torch.zeros((8, 2), dtype=torch.int32))
        assert bool(trunc.all()) == (k >= 2)
    assert (states.step_count == 5).all()
    reset = tv.make_collect_batch(cfg, 8, "cpu")
    states, _ = reset.reset(0)
    for _ in range(5):
        states, *_ = reset.step(states, torch.zeros((8, 2), dtype=torch.int32))
    assert (states.step_count == 2).all()
