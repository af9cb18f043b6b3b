"""Gymnasium ``VectorEnv`` over the port's batched envs (PyTorch port).

Counterpart of ``gym_multigrid_tpu/adapters/vector_adapter.py``: the whole
lockstep batch behind gymnasium's vector API, so that a host RL loop (SB3
VecEnv and the like) drives thousands of envs with one ``step()``.  On a
CUDA device each ``step()`` launches the family's step kernel once (and
Collect's masked reset kernel once) and copies its results to the host
once.

Autoreset is gymnasium 1.x ``AutoresetMode.NEXT_STEP``: the step that
finishes an episode returns its final obs and reward with the done flag
set; on the next step that env's action is ignored and it returns the
fresh episode's first obs with reward 0.  The batch has already reset the
state, so the env holds still for one call
(``parallel/vector.py:next_step_autoreset``; :class:`TorchVectorEnv` is a
thin shell over ``parallel/vector.py:NextStepEnv``).

Example::

    from gym_multigrid_tpu_torch.adapters.vector_adapter import make_vector_env
    venv = make_vector_env("collect", num_envs=4096)   # device="cpu" for the CPU
    obs, info = venv.reset(seed=0)
    obs, rew, term, trunc, info = venv.step(venv.action_space.sample())
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from gymnasium import spaces
from gymnasium.vector import AutoresetMode, VectorEnv
from gymnasium.vector.utils import batch_space

from gym_multigrid_tpu_torch.envs.single import row
from gym_multigrid_tpu_torch.parallel.vector import BatchedEnv, NextStepEnv, make_vector_batch


class TorchVectorEnv(VectorEnv):
    """``VectorEnv`` over a :class:`BatchedEnv`.

    ``single_observation_space`` and ``single_action_space`` are one env's
    spaces; the batched ones are built from them."""

    metadata: dict[str, Any] = {"autoreset_mode": AutoresetMode.NEXT_STEP}

    def __init__(
        self,
        env: BatchedEnv,
        single_observation_space: spaces.Space,
        single_action_space: spaces.Space,
    ):
        self._next_step = NextStepEnv(env)
        self._env = env
        self.num_envs = env.num_envs
        self.single_observation_space = single_observation_space
        self.single_action_space = single_action_space
        self.observation_space = batch_space(single_observation_space, env.num_envs)
        self.action_space = batch_space(single_action_space, env.num_envs)

    @property
    def states(self):
        """The batch state on the device."""
        return self._next_step.states

    def reset(self, *, seed: int | None = None, options=None):
        return self._next_step.reset(seed), {}

    def step(self, actions):
        obs, rewards, term, trunc = self._next_step.step(actions)
        return obs, rewards, term, trunc, {}

    def close_extras(self, **kwargs):
        self._next_step.states = None


def _box_like(probe) -> spaces.Box:
    """A Box of the probe obs's shape and dtype, so that ``contains``
    holds for the arrays the env returns."""
    arr = np.asarray(probe)
    if arr.dtype == np.uint8:
        return spaces.Box(0, 255, arr.shape, dtype=np.uint8)
    return spaces.Box(-np.inf, np.inf, arr.shape, dtype=arr.dtype)


def _probe_obs(env: BatchedEnv):
    """One fresh env's obs as numpy, from the batch's own functions on its
    device and a generator of its own."""
    gen = torch.Generator(device=env.device).manual_seed(0)
    obs = row(env.encode(env.cfg, env.reset_batch(env.slab, 1, generator=gen)))
    if isinstance(obs, dict):
        return {k: v.cpu().numpy() for k, v in obs.items()}
    return obs.cpu().numpy()


def make_vector_env(family: str, num_envs: int, device=None, **cfg_kwargs) -> TorchVectorEnv:
    """A :class:`TorchVectorEnv` of ``num_envs`` envs of ``family``
    ("collect", "ctf", "maze" or "wildfire"), on ``device`` (the current
    CUDA device by default; ``"cpu"`` runs the plain versions).  The
    configs are ``parallel/vector.py:make_vector_batch``'s, ``cfg_kwargs``
    overriding them (``map_path`` for CtF and Maze).  There is no
    ``use_pallas``: on a card the kernels always run."""
    env = make_vector_batch(family, num_envs, device, **cfg_kwargs)
    cfg = env.cfg
    if family in ("collect", "wildfire"):
        obs_space = spaces.Box(0, 255, (cfg.width, cfg.height, 3), dtype=np.uint8)
        act_space = spaces.MultiDiscrete([env.num_actions] * cfg.num_agents)
    elif family == "ctf":
        obs_space = _box_like(_probe_obs(env))
        act_space = spaces.MultiDiscrete([env.num_actions] * cfg.num_blue_agents)
    else:
        probe = _probe_obs(env)
        if isinstance(probe, dict):
            obs_space = spaces.Dict({k: _box_like(v) for k, v in probe.items()})
        else:
            obs_space = _box_like(probe)
        act_space = spaces.Discrete(env.num_actions)
    return TorchVectorEnv(env, obs_space, act_space)
