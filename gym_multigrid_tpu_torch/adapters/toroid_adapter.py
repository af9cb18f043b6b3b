"""Gymnasium wrapper of the toroidal observation (PyTorch port of
``ToroidObservation`` in ``gym_multigrid_tpu/wrappers/toroid.py``)."""

from __future__ import annotations

import gymnasium as gym
import numpy as np
from gymnasium import ObservationWrapper, spaces

from gym_multigrid_tpu_torch.wrappers.toroid import toroid_obs_fn


class ToroidObservation(ObservationWrapper):
    """Wraps a Collect adapter; ``observation`` returns a list of
    per-agent toroidal numpy arrays (``wrappers/toroid.py``)."""

    def __init__(self, env: gym.Env):
        super().__init__(env)
        self.env = env
        base = env.unwrapped
        self.depth = base.num_ball_types + len(base.agents)
        self.observation_space = spaces.Box(
            shape=(base.width, base.height, self.depth), low=-np.inf, high=np.inf
        )
        self._fn = toroid_obs_fn(base.cfg)

    def observation(self, obs):
        out = self._fn(self.env.unwrapped._state).cpu().numpy()
        return [out[i] for i in range(out.shape[0])]
