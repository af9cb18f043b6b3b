"""Gymnasium adapters of the Collect family (PyTorch port).

Counterpart of ``gym_multigrid_tpu/adapters/gym_adapter.py``: the
reference's public classes (names, constructor arguments, spaces,
metadata, obs and info) over the per-env functions of ``envs/collect.py``,
so that a user of the reference can switch imports.  One env, stepped
from the host; the batched API is ``parallel/vector.py``.

``device`` (None: the current CUDA device, which raises when there is
none; ``"cpu"``: the CPU) places the env's state and its plain PyTorch
step.  ``render()`` returns the frame of ``render/tiles.py``, and with
``render_mode="human"`` shows it in a ``render/window.py`` window.
"""

from __future__ import annotations

from dataclasses import dataclass

import gymnasium as gym
import numpy as np
import torch
from gymnasium import spaces

from gym_multigrid_tpu_torch.core.actions import CollectActions
from gym_multigrid_tpu_torch.core.world import CollectWorld
from gym_multigrid_tpu_torch.envs.collect import CollectConfig, cached_collect
from gym_multigrid_tpu_torch.ops import _build


def new_generator(device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from ``np.random``, as the JAX
    adapters draw their first PRNG key."""
    return torch.Generator(device=device).manual_seed(int(np.random.randint(0, 2**31 - 1)))


@dataclass
class AgentProxy:
    """Stand-in for the reference ``Agent`` object: the attributes user
    code reads."""

    index: int
    color: str | None = None
    pos: np.ndarray | None = None
    dir: int = 3
    terminated: bool = False
    started: bool = True
    paused: bool = False
    collided: bool = False
    carrying: object | None = None


class CollectGameEnv(gym.Env):
    """Reference-compatible Collect env.

    Obs: the full grid, (size, size, 3) uint8; reward: np.float64 per
    agent; info: the 6 pickup counters.  ``step`` takes one action per
    agent (the action space is one agent's ``Discrete``, as in the
    reference)."""

    metadata = {"render_modes": ["human", "rgb_array"], "video.frames_per_second": 10}
    _layout = "even"

    def __init__(self, *args, actions_set=CollectActions, render_mode="rgb_array",
                 device=None, **kwargs):
        size = kwargs.get("size", 10)
        num_balls = kwargs.get("num_balls", 15)
        if isinstance(num_balls, (list, tuple, np.ndarray)):
            num_balls = int(np.sum(np.array(num_balls)))
        balls_index = tuple(kwargs.get("balls_index", (0, 1, 2)))
        balls_reward = tuple(float(r) for r in kwargs.get("balls_reward", (1.0,) * len(balls_index)))
        agents_index = tuple(kwargs.get("agents_index", (3, 5)))
        respawn = bool(kwargs.get("respawn", False))

        self.cfg = CollectConfig(
            size=size,
            num_balls=int(num_balls),
            agents_index=agents_index,
            balls_index=balls_index,
            balls_reward=balls_reward,
            respawn=respawn,
            max_steps=kwargs.get("max_steps", 100),
            layout=self._layout,
            fixed_horizon=getattr(self, "_fixed_horizon", False),
        )
        self.device = _build.default_device(device, type(self).__name__)
        self._reset_fn, self._step_fn, self._encode_fn = cached_collect(self.cfg, self.device)

        self.size = size
        self.width = size
        self.height = size
        self.num_balls = num_balls
        self.balls_index = list(balls_index)
        self.balls_reward = list(balls_reward)
        self.num_ball_types = len(balls_index)
        self.agents_index = list(agents_index)
        self.respawn = respawn
        self.world = CollectWorld
        self.actions = actions_set
        self.actions_set = actions_set
        self.max_steps = self.cfg.max_steps
        self.render_mode = render_mode
        self.collected_balls = 0
        self.step_count = 0
        self.keys = [
            "agent1ball1",
            "agent1ball2",
            "agent1ball3",
            "agent2ball1",
            "agent2ball2",
            "agent2ball3",
        ]
        self.info = {k: 0 for k in self.keys}

        self.agents = [
            AgentProxy(index=i, color=CollectWorld.IDX_TO_COLOR[i]) for i in agents_index
        ]
        self.action_space = spaces.Discrete(len(actions_set))
        self.observation_space = spaces.Box(
            low=0,
            high=255,
            shape=(self.width, self.height, self.world.encode_dim),
            dtype="uint8",
        )
        self.ac_dim = self.action_space.n
        self.reward_range = (0, 1)

        self._generator = new_generator(self.device)
        self._state = None
        self.window = None

    # -- helpers -----------------------------------------------------------
    def _sync_proxies(self):
        pos = self._state.agent_pos.cpu().numpy()
        for i, a in enumerate(self.agents):
            a.pos = pos[i]
        self.collected_balls = int(self._state.collected)
        self.step_count = int(self._state.step_count)

    def _info_dict(self):
        counts = self._state.info_counts.cpu().numpy()
        info = {k: 0 for k in self.keys}
        for i in range(min(counts.shape[0], 2)):
            for j in range(min(counts.shape[1], 3)):
                info[self.keys[3 * i + j]] = int(counts[i, j])
        return info

    # -- gym API ------------------------------------------------------------
    def reset(self, *, seed: int | None = None, options: dict | None = None):
        super().reset(seed=seed)
        if seed is not None:
            self._generator.manual_seed(seed)
        self._state = self._reset_fn(self._generator)
        self._sync_proxies()
        self.info = self._info_dict()
        return self._encode_fn(self._state).cpu().numpy(), self.info

    def step(self, actions):
        actions = np.asarray(np.round(np.asarray(actions)), dtype=np.int32).reshape(-1)
        if actions.size != len(self.agents):
            raise ValueError(
                f"expected {len(self.agents)} actions (one per agent), got {actions.size}"
            )
        self._state, obs, rewards, terminated, truncated, _ = self._step_fn(
            self._state, actions, self._generator
        )
        self._sync_proxies()
        self.info = self._info_dict()
        return (
            obs.cpu().numpy(),
            rewards.cpu().numpy().astype(np.float64),
            bool(terminated),
            bool(truncated),
            self.info,
        )

    def phi_dim(self) -> int:
        """Feature dim = number of ball types."""
        return self.num_ball_types

    def render(self):
        from gym_multigrid_tpu_torch.render.tiles import render_collect

        img = render_collect(self.cfg, self._state)
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


class CollectGameEvenDist(CollectGameEnv):
    """Equal number of balls per type."""

    _layout = "even"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_balls_per_type = self.num_balls // len(self.balls_index)


class CollectGameQuadrants(CollectGameEnv):
    """Ball types clustered in quadrants."""

    _layout = "quadrants"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_balls_per_type = self.num_balls // len(self.balls_index)


class CollectGameRooms(CollectGameEnv):
    """Four-room layout."""

    _layout = "rooms"

    def __init__(self, size: int = 11, *args, **kwargs):
        kwargs["size"] = kwargs.get("size", size)
        super().__init__(*args, **kwargs)


class CollectGameRoomsFixedHorizon(CollectGameRooms):
    """Rooms with terminated always False."""

    _fixed_horizon = True


class CollectGameQuadrantsRespawn(CollectGameQuadrants):
    """Quadrants layout, each ball respawning in its own partition (the
    reference's documented intent; its constructor takes no kwargs)."""

    _layout = "quadrants_respawn"

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("respawn", True)
        super().__init__(*args, **kwargs)
