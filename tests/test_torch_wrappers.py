"""The port's toroidal observation (``wrappers/toroid.py``,
``adapters/toroid_adapter.py``), window and misc utilities on the CPU
against the JAX package's, mirroring ``tests/test_wrappers.py``.

``toroid_obs_fn`` is held to JAX's (eager, on the same states in numpy),
per env and batched, on configs where a ball id reaches past the depth and
where one agent's other-agents channel shares a ball channel.
"""

import dataclasses
import os
import types

import gymnasium as gym
import numpy as np
import pytest
import torch

import gym_multigrid_tpu
import gym_multigrid_tpu_torch
from gym_multigrid_tpu.envs import collect as jcollect
from gym_multigrid_tpu.wrappers import ToroidObservation as JToroid
from gym_multigrid_tpu.wrappers import toroid_obs_fn as j_toroid_obs_fn
from gym_multigrid_tpu_torch.envs import collect as tcollect
from gym_multigrid_tpu_torch.parallel.vector import make_collect_batch
from gym_multigrid_tpu_torch.wrappers import toroid_obs_fn

torch.set_num_threads(1)

CONFIGS = {
    "main": dict(layout="quadrants_respawn", respawn=True, max_steps=50),
    "one_agent": dict(agents_index=(3,), layout="even"),
    # ball color ids 0, 4 and 6 against a depth of 5: id 6 has no channel
    "wide_ids": dict(size=8, num_balls=9, balls_index=(0, 4, 6), balls_reward=(1.0, 1.0, 1.0),
                     agents_index=(3, 5), layout="even"),
}


def _states(cfg, seed, n=4, steps=3):
    env = make_collect_batch(cfg, n, device="cpu")
    states, _ = env.reset(seed)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        acts = torch.randint(0, 4, env.actions_shape, generator=gen, dtype=torch.int32)
        states, *_ = env.step(states, acts)
    return states


@pytest.mark.parametrize("name", list(CONFIGS))
def test_toroid_obs_fn_equals_jax_per_env_and_batched(name):
    tcfg = tcollect.CollectConfig(**CONFIGS[name])
    jcfg = jcollect.CollectConfig(**CONFIGS[name])
    states = _states(tcfg, seed=len(name))
    fn, jfn = toroid_obs_fn(tcfg), j_toroid_obs_fn(jcfg)
    batched = fn(states)
    depth = tcfg.num_ball_types + tcfg.num_agents
    assert batched.shape == (4, tcfg.num_agents, tcfg.height, tcfg.width, depth)
    assert batched.dtype == torch.float32
    for i in range(4):
        one = tcollect.CollectState(**{f.name: getattr(states, f.name)[i]
                                       for f in dataclasses.fields(states)})
        got = fn(one)
        want = np.asarray(jfn(types.SimpleNamespace(
            grid_obj=one.grid_obj.numpy(), grid_color=one.grid_color.numpy(),
            agent_pos=one.agent_pos.numpy())))
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(batched[i].numpy(), want)


def test_toroid_observation_equals_jax_wrapper():
    """Space and obs of the wrapper on the matching ids, from JAX's reset
    state carried into the port's adapter, and after a step of each."""
    gym_multigrid_tpu.register_envs()
    gym_multigrid_tpu_torch.register_envs()
    from gym_multigrid_tpu_torch.wrappers import ToroidObservation

    for env_id in ("multigrid-collect-quadrants-v0", "multigrid-collect-single-v0"):
        jenv = JToroid(gym.make(env_id))
        tenv = ToroidObservation(gym.make(f"MultiGridTorch/{env_id}", device="cpu"))
        assert tenv.observation_space == jenv.observation_space
        jobs, _ = jenv.reset(seed=3)
        tenv.reset(seed=3)
        base = tenv.unwrapped
        base._state = tcollect.CollectState(**{
            f.name: torch.tensor(np.asarray(getattr(jenv.unwrapped._state, f.name)))
            for f in dataclasses.fields(tcollect.CollectState)})
        got = tenv.observation(None)
        assert isinstance(got, list) and len(got) == len(jobs)
        for g, w in zip(got, jobs):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        obs, *_ = tenv.step([0] * len(base.agents))
        want = np.asarray(j_toroid_obs_fn(jenv.unwrapped.cfg)(types.SimpleNamespace(
            grid_obj=base._state.grid_obj.numpy(), grid_color=base._state.grid_color.numpy(),
            agent_pos=base._state.agent_pos.numpy())))
        np.testing.assert_array_equal(np.stack(obs), want)


def test_window_headless_and_import_path():
    from gym_multigrid_tpu_torch.render import Window as LazyWindow
    from gym_multigrid_tpu_torch.render.window import Window
    from gym_multigrid_tpu_torch.utils.window import Window as WindowShim

    assert WindowShim is Window and LazyWindow is Window
    w = Window("test")
    w.show_img(np.zeros((4, 4, 3), np.uint8))
    w.show_img(np.full((4, 4, 3), 255, np.uint8))  # reuses the imshow obj
    w.set_caption("caption")
    w.reg_key_handler(lambda evt: None)
    w.show(block=True)  # no-op on Agg: must not block
    w.close()


def test_set_seed_and_save_frames_as_gif(tmp_path, capsys, monkeypatch):
    import imageio.v3 as iio

    from gym_multigrid_tpu_torch.utils import save_frames_as_gif, set_seed

    monkeypatch.setenv("PYTHONHASHSEED", "0")  # restored after the test

    draws = []
    for _ in range(2):
        set_seed(11)
        draws.append((np.random.rand(), __import__("random").random(), torch.rand(1).item()))
    assert draws[0] == draws[1] and os.environ["PYTHONHASHSEED"] == "11"
    assert "Random seed set as 11" in capsys.readouterr().out
    frames = [np.full((8, 8, 3), v, np.uint8) for v in (0, 90, 180)]
    save_frames_as_gif(frames, path=str(tmp_path) + "/", filename="ep-", ep=2)
    assert iio.imread(tmp_path / "ep-2.gif", index=None).shape == (3, 8, 8, 3)
