"""Gymnasium adapter of the Wildfire family (PyTorch port).

Counterpart of ``gym_multigrid_tpu/adapters/wildfire_adapter.py``, over
the per-env functions of ``envs/wildfire.py``; ``device`` and ``render()``
as in ``adapters/gym_adapter.py``.
"""

from __future__ import annotations

import gymnasium as gym
import numpy as np
from gymnasium import spaces

from gym_multigrid_tpu_torch.adapters.gym_adapter import new_generator
from gym_multigrid_tpu_torch.core.actions import WildfireActions
from gym_multigrid_tpu_torch.core.world import WildfireWorld
from gym_multigrid_tpu_torch.envs.wildfire import FIRE, BURNT, WildfireConfig, cached_wildfire
from gym_multigrid_tpu_torch.ops import _build


class WildfireAgentProxy:
    def __init__(self, index: int, color: str):
        self.index = index
        self.type = "agent"
        self.color = color
        self.pos = None
        self.dir = 3
        self.terminated = False
        self.carrying = None


class WildfireEnv(gym.Env):
    """Firefighter team against a spreading fire (``envs/wildfire.py``)."""

    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 10}

    def __init__(self, render_mode: str = "rgb_array", device=None, **kwargs):
        kwargs.pop("max_episode_steps", None)
        if "agents_index" in kwargs:
            kwargs["agents_index"] = tuple(kwargs["agents_index"])
        self.cfg = WildfireConfig(**kwargs)
        self.device = _build.default_device(device, type(self).__name__)
        self._fns = cached_wildfire(self.cfg, self.device)
        self.world = WildfireWorld
        self.actions_set = WildfireActions
        self.render_mode = render_mode
        self.width = self.cfg.width
        self.height = self.cfg.height
        self.max_steps = self.cfg.max_steps
        self.num_ball_types = 0
        self.agents = [
            WildfireAgentProxy(i, WildfireWorld.IDX_TO_COLOR.get(ci, "blue"))
            for i, ci in enumerate(self.cfg.agents_index)
        ]
        self.action_space = spaces.MultiDiscrete([len(self.actions_set)] * self.cfg.num_agents)
        self.observation_space = spaces.Box(
            low=0,
            high=255,
            shape=(self.width, self.height, 3),
            dtype="uint8",
        )
        self.step_count = 0
        self._generator = new_generator(self.device)
        self._state = None
        self.window = None

    def _sync(self):
        pos = self._state.agent_pos.cpu().numpy()
        for i, a in enumerate(self.agents):
            a.pos = pos[i]
        self.step_count = int(self._state.step_count)

    def reset(self, *, seed: int | None = None, options: dict | None = None):
        super().reset(seed=seed)
        if seed is not None:
            self._generator.manual_seed(seed)
        self._state = self._fns.reset_fn(self._generator)
        self._sync()
        obs = self._fns.encode_fn(self._state).cpu().numpy()
        cells = self._state.cells
        info = {
            "extinguished": 0,
            "burning": int((cells == FIRE).sum()),
            "burnt": int((cells == BURNT).sum()),
        }
        return obs, info

    def step(self, actions):
        actions = np.asarray(np.round(np.asarray(actions, dtype=float)), dtype=np.int32).reshape(-1)
        if actions.size != self.cfg.num_agents:
            raise ValueError(
                f"expected {self.cfg.num_agents} actions (one per agent, "
                f"action_space {self.action_space}), got {actions.size}"
            )
        self._state, obs, rewards, terminated, truncated, info = self._fns.step_fn(
            self._state, actions, self._generator
        )
        self._sync()
        return (
            obs.cpu().numpy(),
            rewards.cpu().numpy().astype(np.float64),
            bool(terminated),
            bool(truncated),
            {k: int(v) for k, v in info.items()},
        )

    def render(self):
        from gym_multigrid_tpu_torch.render.tiles import render_wildfire

        img = render_wildfire(self.cfg, self._state)
        if self.render_mode == "human":
            from gym_multigrid_tpu_torch.render.window import Window

            if self.window is None:
                self.window = Window("gym_multigrid_tpu_torch")
                self.window.show(block=False)
            self.window.show_img(img)
        return img

    def close(self):
        if self.window is not None:
            self.window.close()
            self.window = None
