"""The port's gymnasium adapters (``adapters/{gym,ctf,maze,wildfire}_adapter.py``)
on the CPU against the JAX package's, mirroring the adapter tests of
``tests/test_ctf.py``, ``tests/test_maze.py`` and
``tests/test_collect.py``.

Spaces and metadata are compared with ``==``; obs, rewards, flags and
infos exactly (integer obs bit-equal; float64 Maze maps, float32 rewards
and distances widened to Python floats on both sides from the same
float32 values), for a JAX state carried into the port.
"""

import dataclasses
import os

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

import gym_multigrid_tpu
import gym_multigrid_tpu_torch
from gym_multigrid_tpu.envs import ctf as jctf  # first: the JAX adapters import envs
from gym_multigrid_tpu.adapters import ctf_adapter as jca  # noqa: E402
from gym_multigrid_tpu.adapters import maze_adapter as jma  # noqa: E402
from gym_multigrid_tpu.policy.ctf import heuristic as jh
from gym_multigrid_tpu_torch.adapters import ctf_adapter as tca
from gym_multigrid_tpu_torch.adapters import maze_adapter as tma
from gym_multigrid_tpu_torch.envs import collect as tcollect
from gym_multigrid_tpu_torch.envs import ctf as tctf
from gym_multigrid_tpu_torch.envs import maze as tmaze
from gym_multigrid_tpu_torch.envs import wildfire as twf
from gym_multigrid_tpu_torch.envs.ctf import PolicySpec, host_observation
from gym_multigrid_tpu_torch.policy.ctf import heuristic as th

torch.set_num_threads(1)

ASSETS = os.path.join(os.path.dirname(__file__), "assets")
MAP = os.path.join(ASSETS, "board.txt")
MAZE_MAP = os.path.join(ASSETS, "board_maze.txt")
JAX_IDS = ["multigrid-collect-v0", "multigrid-collect-single-v0",
           "multigrid-collect-quadrants-v0", "multigrid-collect-rooms-v0",
           "multigrid-collect-rooms-fixed-horizon-v0", "multigrid-collect-rooms-respawn-v0",
           "multigrid-collect-respawn-v0", "multigrid-collect-respawn-clustered-v0",
           "multigrid-collect-quadrants15-v0", "multigrid-wildfire-v0"]
CTF_CASES = [(cls, opt) for cls in ("Ctf1v1Env", "CtFMvNEnv")
             for opt in ("positional", "map", "flattened")]


def _pair(jmod, tmod, name, **kw):
    return getattr(jmod, name)(**kw), getattr(tmod, name)(device="cpu", **kw)


def _ids():
    gym_multigrid_tpu.register_envs()
    gym_multigrid_tpu_torch.register_envs()


def _proxies(env):
    return [{k: v for k, v in vars(a).items() if k not in ("pos", "policy")}
            for a in env.agents]


def _same_surface(jenv, tenv):
    assert tenv.observation_space == jenv.observation_space
    assert tenv.action_space == jenv.action_space
    assert tenv.metadata == jenv.metadata
    assert _proxies(tenv) == _proxies(jenv)
    for k in ("width", "height", "max_steps", "render_mode", "step_count", "ac_dim",
              "num_balls", "balls_index", "agents_index", "keys", "reward_range",
              "num_ball_types", "respawn", "num_blue_agents", "num_red_agents",
              "observation_option", "battle_reward", "step_penalty", "uncached_object_types"):
        if hasattr(jenv, k):
            assert getattr(tenv, k) == getattr(jenv, k), k
    assert tenv.world.OBJECT_TO_IDX == jenv.world.OBJECT_TO_IDX
    assert [(a.name, a.value) for a in tenv.actions_set] == [
        (a.name, a.value) for a in jenv.actions_set]


@pytest.mark.parametrize("env_id", JAX_IDS)
def test_registered_envs_have_jax_spaces_and_attributes(env_id):
    _ids()
    jenv = gym.make(env_id).unwrapped
    tenv = gym.make(f"MultiGridTorch/{env_id}", device="cpu").unwrapped
    _same_surface(jenv, tenv)
    assert type(tenv).__name__ == type(jenv).__name__


@pytest.mark.parametrize("cls,option", CTF_CASES)
def test_ctf_adapters_have_jax_spaces_and_attributes(cls, option):
    kw = dict(map_path=MAP, observation_option=option)
    if cls == "CtFMvNEnv":
        kw.update(num_blue_agents=3, num_red_agents=2)
    jenv, tenv = _pair(jca, tca, cls, **kw)
    _same_surface(jenv, tenv)
    assert (tenv.blue_flag, tenv.red_flag) == (jenv.blue_flag, jenv.red_flag)
    for k in ("blue_territory", "red_territory", "obstacle"):
        assert getattr(tenv, k) == getattr(jenv, k), k
    assert tenv._in_step


@pytest.mark.parametrize("option", ["map", "positional"])
def test_maze_adapter_has_jax_spaces_and_attributes(option):
    jenv, tenv = _pair(jma, tma, "MazeSingleAgentEnv", map_path=MAZE_MAP,
                       observation_option=option)
    _same_surface(jenv, tenv)
    for k in ("background", "obstacle", "flag"):
        assert getattr(tenv, k) == getattr(jenv, k), k


def _eq_obs(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _eq_obs(got[k], want[k])
        return
    assert type(got) is type(want)
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _eq_info(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert type(got[k]) is type(want[k]) and got[k] == want[k], k


def _carry(jstate, state_cls):
    return state_cls(**{f.name: torch.tensor(np.asarray(getattr(jstate, f.name)))
                        for f in dataclasses.fields(state_cls)})


def _reset_view(tenv, state):
    """What ``reset`` returns for ``state``: the adapter's obs and info
    conversions of the per-env functions' results."""
    tenv._state = state
    fns = tenv._fns
    obs = tenv._np_obs(fns.obs_fn(state))
    return obs, tenv._info_dict(fns.info_fn(state))


@pytest.mark.parametrize("cls,option", [("Ctf1v1Env", "positional"), ("CtFMvNEnv", "map"),
                                        ("CtFMvNEnv", "flattened")])
def test_ctf_reset_obs_and_info_of_a_carried_state_equal_jax(cls, option):
    kw = dict(map_path=MAP, observation_option=option)
    jenv, tenv = _pair(jca, tca, cls, **kw)
    jobs, jinfo = jenv.reset(seed=3)
    tenv.reset(seed=3)
    obs, info = _reset_view(tenv, _carry(jenv._state, tctf.CtfState))
    _eq_obs(obs, jobs)
    _eq_info(info, jinfo)
    assert tenv.observation_space.contains(obs)
    _eq_obs(tenv._get_dict_obs(), jenv._get_dict_obs())


def test_maze_adapter_episodes_are_bit_equal_to_jax():
    """From JAX's reset, the same actions, step for step: obs (float64
    maps), reward, flags, info, the agent proxy and the trajectories; a
    finished episode restarts both from JAX's next reset."""
    jenv, tenv = _pair(jma, tma, "MazeSingleAgentEnv", map_path=MAZE_MAP, max_steps=20,
                       obstacle_penalty_ratio=0.5)
    rng = np.random.default_rng(0)
    episodes = 0
    jobs, jinfo = jenv.reset(seed=1)
    tenv.reset(seed=1)
    obs, info = _reset_view(tenv, _carry(jenv._state, tmaze.MazeState))
    tenv.agent_traj = [tenv._state.pos.numpy()]
    _eq_obs(obs, jobs)
    _eq_info(info, jinfo)
    for t in range(45):
        a = float(rng.integers(-1, 6)) + 0.2  # rounded to an id, as JAX rounds
        want, got = jenv.step(a), tenv.step(a)
        _eq_obs(got[0], want[0])
        assert got[1:4] == want[1:4] and type(got[1]) is float, t
        _eq_info(got[4], want[4])
        np.testing.assert_array_equal(tenv.agents[0].pos, jenv.agents[0].pos)
        assert (tenv.agents[0].dir, tenv.step_count) == (jenv.agents[0].dir, jenv.step_count)
        if want[2] or want[3]:
            episodes += 1
            jenv.reset()
            tenv._state = _carry(jenv._state, tmaze.MazeState)
    assert episodes >= 2
    assert tenv.rewards[-5:] == jenv.rewards[-5:]
    np.testing.assert_array_equal(np.stack(tenv.agent_traj[-5:]), np.stack(jenv.agent_traj[-5:]))


@pytest.mark.parametrize("env_id", ["multigrid-collect-respawn-clustered-v0",
                                    "multigrid-wildfire-v0"])
def test_grid_reset_obs_and_info_of_a_carried_state_equal_jax(env_id):
    _ids()
    jenv = gym.make(env_id).unwrapped
    tenv = gym.make(f"MultiGridTorch/{env_id}", device="cpu").unwrapped
    jobs, jinfo = jenv.reset(seed=2)
    tenv.reset(seed=2)
    if "wildfire" in env_id:
        tenv._state = _carry(jenv._state, twf.WildfireState)
        obs = tenv._fns.encode_fn(tenv._state).numpy()
        tenv._sync()
    else:
        tenv._state = _carry(jenv._state, tcollect.CollectState)
        obs = tenv._encode_fn(tenv._state).numpy()
        tenv._sync_proxies()
        _eq_info(tenv._info_dict(), jinfo)
    _eq_obs(obs, jobs)
    for a, b in zip(tenv.agents, jenv.agents):
        np.testing.assert_array_equal(a.pos, b.pos)


def test_collect_step_contract_and_dtypes():
    """One action per agent; a bare Discrete sample is refused (the
    reference would IndexError on it); float actions round; the reward is
    float64 per agent, the flags bool and the info Python ints."""
    _ids()
    env = gym.make("MultiGridTorch/multigrid-collect-quadrants-v0", device="cpu").unwrapped
    obs, info = env.reset(seed=0)
    assert obs.dtype == np.uint8 and env.observation_space.contains(obs)
    obs, rew, term, trunc, info = env.step([1.4, 2.6])
    assert rew.dtype == np.float64 and rew.shape == (2,)
    assert type(term) is bool and type(trunc) is bool
    assert all(type(v) is int for v in info.values())
    with pytest.raises(ValueError, match="expected 2 actions"):
        env.step(env.action_space.sample())


def test_custom_policy_host_fallback():
    """A subclass of a stock policy acts on the host (its own ``act``)."""

    class AlwaysStay(th.FightPolicy):
        def act(self, observation, curr_pos):
            return 0

    env = tca.CtFMvNEnv(num_blue_agents=1, num_red_agents=1, map_path=MAP,
                        observation_option="positional", enemy_policies=[AlwaysStay()],
                        device="cpu")
    assert not env._in_step
    env.reset(seed=0)
    red0 = np.asarray(env.agents[1].pos).copy()
    for _ in range(5):
        env.step([0])
    np.testing.assert_array_equal(np.asarray(env.agents[1].pos), red0)


def test_host_policies_act_as_jax_on_a_carried_state():
    """A subclass of each stock class (host path): the pre-move dict obs
    of a carried state equals JAX's, and the reds' actions from it equal
    JAX's, the policies drawing from the envs' generators set alike."""
    kinds = ("RwPolicy", "FightPolicy", "CapturePolicy", "PatrolPolicy", "PatrolFightPolicy")

    def policies(mod):
        return [type(f"My{k}", (getattr(mod, k),), {})() for k in kinds]

    kw = dict(map_path=MAP, num_blue_agents=2, num_red_agents=5)
    jenv = jca.CtFMvNEnv(enemy_policies=policies(jh), **kw)
    tenv = tca.CtFMvNEnv(enemy_policies=policies(th), device="cpu", **kw)
    assert not jenv._in_graph and not tenv._in_step
    jenv.reset(seed=4)
    tenv.reset(seed=4)
    for _ in range(6):
        jenv.step([1, 3])
        tenv.np_random.bit_generator.state = jenv.np_random.bit_generator.state
        state = _carry(jenv._state, tctf.CtfState)
        obs = jenv._get_dict_obs()
        _eq_obs(host_observation(tenv.cfg, state), obs)
        pos = np.asarray(jenv._state.pos)
        want = [int(p.act(obs, pos[2 + i])) for i, p in enumerate(jenv.enemy_policies)]
        got = tctf.host_red_actions(tenv.cfg, tenv.enemy_policies, state).tolist()
        assert got == want
        tenv._state = state


def test_adapter_accepts_policy_spec_enemies():
    env = tca.CtFMvNEnv(num_blue_agents=2, num_red_agents=2, map_path=MAP,
                        observation_option="flattened",
                        enemy_policies=[PolicySpec("fight"), PolicySpec("patrol")], device="cpu")
    env.reset(seed=0)
    assert env._in_step
    assert [type(p) for p in env.enemy_policies] == [th.FightPolicy, th.PatrolPolicy]
    for _ in range(5):
        obs, rew, term, trunc, info = env.step([1, 2])
    assert np.isfinite(rew) and env.observation_space.contains(obs)
    with pytest.raises(ValueError, match="enemy policies"):
        tca.CtFMvNEnv(map_path=MAP, num_red_agents=2, enemy_policies=[th.RwPolicy()],
                      device="cpu")


def test_game_stats_after_a_forced_capture_equal_jax():
    """Blue 0 one step below the red flag, the reds far from every blue:
    stepping onto the flag captures it on both sides, with the same
    reward, flags, game_stats and trajectories' last cells."""
    jenv, tenv = _pair(jca, tca, "CtFMvNEnv", map_path=MAP)
    jenv.reset(seed=0)
    tenv.reset(seed=0)
    pos = np.array([[2, 6], [9, 9], [0, 0], [4, 0]], np.int32)
    jenv._state = dataclasses.replace(jenv._state, pos=jax.numpy.asarray(pos))
    tenv._state = dataclasses.replace(tenv._state, pos=torch.tensor(pos))
    want, got = jenv.step([2, 0]), tenv.step([2, 0])
    assert got[1:4] == want[1:4] and got[2] is True
    _eq_info(got[4], want[4])
    assert tenv.game_stats == jenv.game_stats
    assert tenv.game_stats["red_flag_captured"] and not tenv.game_stats["blue_flag_captured"]
    np.testing.assert_array_equal(tenv.blue_traj[0][-1], [1, 6])


def _render_pair(which):
    """(JAX adapter, port adapter) of one family, the port's state carried
    over from JAX's after a reset and a few steps of JAX's env."""
    if which == "collect":
        _ids()
        jenv = gym.make("multigrid-collect-quadrants-v0").unwrapped
        tenv = gym.make("MultiGridTorch/multigrid-collect-quadrants-v0", device="cpu").unwrapped
        state_cls, acts = tcollect.CollectState, [[0, 1], [2, 2], [3, 1]]
    elif which == "ctf":
        jenv, tenv = _pair(jca, tca, "CtFMvNEnv", map_path=MAP)
        state_cls, acts = tctf.CtfState, [[1, 3], [4, 2], [0, 1]]
    elif which == "maze":
        jenv, tenv = _pair(jma, tma, "MazeSingleAgentEnv", map_path=MAZE_MAP)
        state_cls, acts = tmaze.MazeState, [1, 3, 4]
    else:
        from gym_multigrid_tpu.adapters.wildfire_adapter import WildfireEnv as JWildfireEnv
        from gym_multigrid_tpu_torch.adapters.wildfire_adapter import WildfireEnv

        jenv, tenv = JWildfireEnv(size=8), WildfireEnv(device="cpu", size=8)
        state_cls, acts = twf.WildfireState, [[1, 2], [3, 4], [0, 1]]
    jenv.reset(seed=4)
    tenv.reset(seed=4)
    for a in acts:
        jenv.step(a)
    tenv._state = _carry(jenv._state, state_cls)
    return jenv, tenv


@pytest.mark.parametrize("which", ["collect", "ctf", "maze", "wildfire"])
def test_render_matches_jax(which):
    """``render()`` of the port's adapter equals the JAX adapter's on the
    same state, and ``render_mode="human"`` shows it headless (Agg) and
    ``close()`` closes the window."""
    jenv, tenv = _render_pair(which)
    want = jenv.render()
    got = tenv.render()
    assert type(got) is np.ndarray and got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    tenv.render_mode = "human"
    np.testing.assert_array_equal(tenv.render(), want)
    assert tenv.window is not None
    tenv.close()
    assert tenv.window is None


def test_adapters_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tma.MazeSingleAgentEnv(MAZE_MAP)


def test_typing_surface_matches_jax():
    for name in ("ObservationDict", "MultiAgentObservationDict", "GameStats"):
        assert getattr(tca, name).__annotations__.keys() == getattr(jca, name).__annotations__.keys()
        assert getattr(tctf, name) is getattr(tca, name)
    assert tca.Observation == jctf.Observation
