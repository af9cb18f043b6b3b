"""The port's gymnasium registry (``gym_multigrid_tpu_torch.register_envs``)
beside the JAX package's, and the package's independence of gymnasium.

Exact comparisons: ids, kwargs, time limits and checker flags equal; the
obs of a built env lies in its space.
"""

import subprocess
import sys

import gymnasium as gym
import numpy as np
import pytest
import torch

import gym_multigrid_tpu
import gym_multigrid_tpu_torch

torch.set_num_threads(1)

JAX_IDS = ["multigrid-collect-v0", "multigrid-collect-single-v0",
           "multigrid-collect-quadrants-v0", "multigrid-collect-rooms-v0",
           "multigrid-collect-rooms-fixed-horizon-v0", "multigrid-collect-rooms-respawn-v0",
           "multigrid-collect-respawn-v0", "multigrid-collect-respawn-clustered-v0",
           "multigrid-collect-quadrants15-v0", "multigrid-wildfire-v0"]


def _register_both():
    gym_multigrid_tpu.register_envs()
    gym_multigrid_tpu_torch.register_envs()


def test_every_jax_id_has_a_twin_with_its_kwargs_and_time_limit():
    _register_both()
    jax_ids = sorted(k for k, v in gym.registry.items()
                     if str(v.entry_point).startswith("gym_multigrid_tpu.envs:"))
    assert jax_ids == sorted(JAX_IDS)
    twins = sorted(k for k in gym.registry if k.startswith("MultiGridTorch/"))
    assert twins == sorted(f"MultiGridTorch/{k}" for k in JAX_IDS)
    for k in JAX_IDS:
        j, t = gym.spec(k), gym.spec(f"MultiGridTorch/{k}")
        assert t.kwargs == j.kwargs, k
        assert t.max_episode_steps == j.max_episode_steps, k
        assert t.disable_env_checker == j.disable_env_checker is True, k
        assert t.entry_point.startswith("gym_multigrid_tpu_torch.adapters.")
        assert t.entry_point.split(":")[1] == j.entry_point.split(":")[1], k


@pytest.mark.parametrize("env_id", JAX_IDS)
def test_make_twin_on_the_cpu_builds_and_steps(env_id):
    _register_both()
    env = gym.make(f"MultiGridTorch/{env_id}", device="cpu")
    obs, _ = env.reset(seed=0)
    assert env.observation_space.contains(obs)
    u = env.unwrapped
    for _ in range(3):
        if "wildfire" in env_id:
            action = env.action_space.sample()
        else:
            action = [env.action_space.sample() for _ in u.agents]
        obs, rew, term, trunc, info = env.step(action)
    assert env.observation_space.contains(obs)
    assert np.isfinite(rew).all() and isinstance(term, bool)
    assert u.device == torch.device("cpu")


def test_both_registries_coexist():
    """Registering one package leaves the other's ids alone, in either
    order, and each builds its own package's class."""
    gym_multigrid_tpu_torch.register_envs()
    gym_multigrid_tpu.register_envs()
    gym_multigrid_tpu_torch.register_envs()
    jenv = gym.make("multigrid-collect-v0").unwrapped
    tenv = gym.make("MultiGridTorch/multigrid-collect-v0", device="cpu").unwrapped
    assert type(jenv).__module__.startswith("gym_multigrid_tpu.")
    assert type(tenv).__module__.startswith("gym_multigrid_tpu_torch.")
    assert gym.spec("multigrid-collect-v0").entry_point.startswith("gym_multigrid_tpu.envs")


def test_the_package_does_not_import_gymnasium():
    """The package and every module outside ``adapters/`` (and the alias
    module ``envs/collect_game.py``) import without gymnasium, and
    registering imports it."""
    code = """
import importlib, pathlib, sys
import gym_multigrid_tpu_torch as pkg
root = pathlib.Path(pkg.__file__).parent
skip = ("gym_multigrid_tpu_torch.adapters", "gym_multigrid_tpu_torch.envs.collect_game")
names = [".".join(("gym_multigrid_tpu_torch",) + p.relative_to(root).with_suffix("").parts)
         .removesuffix(".__init__") for p in sorted(root.rglob("*.py"))]
names = [n for n in names if not n.startswith(skip)]
for name in names:
    importlib.import_module(name)
bad = [m for m in sys.modules if m.split(".")[0] in ("gymnasium", "jax", "gym_multigrid_tpu")]
print(len(names), bad)
pkg.register_envs()
print("gymnasium" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True).stdout.split("\n")
    assert int(out[0].split()[0]) > 30
    assert out[0].split(maxsplit=1)[1] == "[]", out[0]
    assert out[1] == "True"
