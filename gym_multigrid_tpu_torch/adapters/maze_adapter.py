"""Gymnasium adapter of the Maze family (PyTorch port).

Counterpart of ``gym_multigrid_tpu/adapters/maze_adapter.py``, over the
per-env functions of ``envs/maze.py``; ``device`` and ``render()`` as in
``adapters/gym_adapter.py``.
"""

from __future__ import annotations

import gymnasium as gym
import numpy as np
from gymnasium import spaces

from gym_multigrid_tpu_torch.adapters.gym_adapter import new_generator
from gym_multigrid_tpu_torch.core.actions import MazeActions
from gym_multigrid_tpu_torch.core.world import MazeWorld
from gym_multigrid_tpu_torch.envs.maze import MazeConfig, cached_maze
from gym_multigrid_tpu_torch.ops import _build
from gym_multigrid_tpu_torch.utils.map import load_text_map


class MazeAgentProxy:
    def __init__(self):
        self.index = 0
        self.type = "agent"
        self.color = "blue"
        self.bg_color = "white"
        self.pos = None
        self.dir = 3
        self.terminated = False
        self.started = True
        self.paused = False
        self.carrying = None


class MazeSingleAgentEnv(gym.Env):
    """One agent, several flags, on a map read from ``map_path``."""

    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 10}

    def __init__(
        self,
        map_path: str,
        max_steps: int = 100,
        flag_reward: float = 1.0,
        obstacle_penalty_ratio: float = 0.0,
        step_penalty_ratio: float = 0.01,
        observation_option: str = "map",
        render_mode: str = "rgb_array",
        device=None,
    ):
        self.world = MazeWorld
        self.actions_set = MazeActions
        self._map_path = map_path
        self._field_map = load_text_map(map_path)
        self.height, self.width = self._field_map.shape
        self.max_steps = max_steps
        self.observation_option = observation_option
        self.render_mode = render_mode
        self._flag_reward = flag_reward
        self._obstacle_penalty_ratio = obstacle_penalty_ratio
        self._step_penalty_ratio = step_penalty_ratio

        fm = self._field_map
        idx = self.world.OBJECT_TO_IDX
        self.background = list(zip(*np.where(fm == idx["background"])))
        self.obstacle = list(zip(*np.where(fm == idx["obstacle"])))
        self.flag = list(zip(*np.where(fm == idx["flag"])))

        self.cfg = MazeConfig(
            map_data=tuple(tuple(int(v) for v in row) for row in fm),
            max_steps=max_steps,
            flag_reward=flag_reward,
            obstacle_penalty_ratio=obstacle_penalty_ratio,
            step_penalty_ratio=step_penalty_ratio,
            observation_option=observation_option,
        )
        self.device = _build.default_device(device, type(self).__name__)
        self._fns = cached_maze(self.cfg, self.device)

        self.agents = [MazeAgentProxy()]
        self.action_space = spaces.Discrete(len(self.actions_set))
        self.observation_space = self._set_observation_space()
        self.step_count = 0
        self._generator = new_generator(self.device)
        self._state = None
        self.window = None

    def _set_observation_space(self):
        shape = self._field_map.shape

        def box_pts(n):
            return spaces.Box(
                low=np.zeros(2 * n),
                high=np.tile(np.asarray(shape), n).astype(float) - 1,
                dtype=np.int64,
            )

        if self.observation_option == "positional":
            return spaces.Dict(
                {
                    "agent": spaces.Box(
                        low=np.array([-1, -1]),
                        high=np.array(shape) - 1,
                        dtype=np.int64,
                    ),
                    "background": box_pts(len(self.background)),
                    "flag": box_pts(len(self.flag)),
                    "obstacle": box_pts(len(self.obstacle)),
                }
            )
        if self.observation_option == "map":
            # The space says int64 and the obs is float64, as in the
            # reference.
            return spaces.Box(
                low=0,
                high=len(self.world.OBJECT_TO_IDX) - 1,
                shape=shape,
                dtype=np.int64,
            )
        raise ValueError(f"Invalid observation option: {self.observation_option}")

    def _np_obs(self, obs):
        if isinstance(obs, dict):
            return {k: v.cpu().numpy().astype(np.int64) for k, v in obs.items()}
        return obs.cpu().numpy().astype(np.float64)

    def _info_dict(self, info):
        return {"d_a_f": float(info["d_a_f"]), "d_a_ob": float(info["d_a_ob"])}

    def _sync(self):
        self.agents[0].pos = self._state.pos.cpu().numpy()
        self.agents[0].dir = int(self._state.dir)
        self.step_count = int(self._state.step_count)

    def reset(self, seed=None, options=None):
        super().reset(seed=seed)
        if seed is not None:
            self._generator.manual_seed(seed)
        self._state = self._fns.reset_fn(self._generator)
        self._sync()
        self.agent_traj = [self._state.pos.cpu().numpy()]
        self.rewards: list[float] = []
        obs = self._np_obs(self._fns.obs_fn(self._state))
        info = self._info_dict(self._fns.info_fn(self._state))
        return obs, info

    def step(self, action):
        self._state, obs, reward, terminated, truncated, info = self._fns.step_fn(
            self._state, np.int32(np.round(np.asarray(action, dtype=float)))
        )
        self._sync()
        self.agent_traj.append(self._state.pos.cpu().numpy())
        self.rewards.append(float(reward))
        return (
            self._np_obs(obs),
            float(reward),
            bool(terminated),
            bool(truncated),
            self._info_dict(info),
        )

    def render(self):
        from gym_multigrid_tpu_torch.render.tiles import render_maze

        img = render_maze(self.cfg, self._state)
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
