"""Gymnasium adapters of the CtF family (PyTorch port).

Counterpart of ``gym_multigrid_tpu/adapters/ctf_adapter.py``: the
reference's ``Ctf1v1Env`` and ``CtFMvNEnv`` (names, constructor
arguments, spaces, obs, info, ``game_stats``) over the per-env functions
of ``envs/ctf.py``; ``device`` and ``render()`` as in
``adapters/gym_adapter.py``.  When every enemy policy is exactly a stock
policy class (or a ``PolicySpec``), the red actions come from the step
itself (``step_fn``); a policy of any other type, a subclass of a stock
class included, acts on the host through its ``act`` and the step takes
every action given (``step_actions_fn``).
"""

from __future__ import annotations

import gymnasium as gym
import numpy as np
from gymnasium import spaces

from gym_multigrid_tpu_torch.adapters.gym_adapter import new_generator
from gym_multigrid_tpu_torch.core.actions import CtfActions
from gym_multigrid_tpu_torch.core.world import CtfWorld
from gym_multigrid_tpu_torch.envs.ctf import (
    CtfConfig,
    GameStats,
    MultiAgentObservationDict,
    Observation,
    ObservationDict,
    PolicySpec,
    cached_ctf,
    host_observation,
    host_red_actions,
)
from gym_multigrid_tpu_torch.ops import _build
from gym_multigrid_tpu_torch.policy.ctf.heuristic import (
    CapturePolicy,
    FightPolicy,
    PatrolFightPolicy,
    PatrolPolicy,
    RwPolicy,
)
from gym_multigrid_tpu_torch.utils.map import load_text_map

__all__ = [
    "Ctf1v1Env", "CtFMvNEnv", "CtfAgentProxy",
    # the reference's typing surface, for users who import it from here
    "ObservationDict", "MultiAgentObservationDict", "Observation", "GameStats",
]

#: Stock policy class -> the step's policy kind, matched by exact type: a
#: subclass (a custom ``get_target`` or ``act``) must act on the host.
_POLICY_KINDS = {
    RwPolicy: "rw",
    FightPolicy: "fight",
    CapturePolicy: "capture",
    PatrolPolicy: "patrol",
    PatrolFightPolicy: "patrol_fight",
}


class CtfAgentProxy:
    """Stand-in for the reference's Agent and PolicyAgent objects: the
    attributes user code reads."""

    def __init__(self, index: int, type_: str, color: str, policy=None):
        self.index = index
        self.type = type_
        self.color = color
        self.bg_color = "light_blue" if type_ == "blue_agent" else "light_red"
        self.pos = None
        self.dir = 3
        self.terminated = False
        self.collided = False
        self.started = True
        self.paused = False
        self.carrying = None
        self.policy = policy


class _CtfBase(gym.Env):
    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 10}

    def __init__(
        self,
        map_path: str,
        num_blue_agents: int,
        num_red_agents: int,
        enemy_policies,
        variant: str,
        battle_range: float = 1.0,
        randomness: float = 0.75,
        flag_reward: float = 1.0,
        battle_reward_ratio: float = 0.25,
        obstacle_penalty_ratio: float = 0.0,
        step_penalty_ratio: float = 0.01,
        max_steps: int = 100,
        observation_option: str = "positional",
        observation_scaling: float = 1.0,
        render_mode: str = "rgb_array",
        uncached_object_types=("red_agent", "blue_agent"),
        device=None,
    ):
        self.num_blue_agents = num_blue_agents
        self.num_red_agents = num_red_agents
        self.battle_range = battle_range
        self.randomness = randomness
        self.flag_reward = flag_reward
        self.battle_reward = battle_reward_ratio * flag_reward
        self.obstacle_penalty = obstacle_penalty_ratio * flag_reward
        self.step_penalty = step_penalty_ratio * flag_reward
        self.observation_option = observation_option
        self.observation_scaling = observation_scaling
        self.max_steps = max_steps
        self.render_mode = render_mode
        self.uncached_object_types = list(uncached_object_types)
        self.world = CtfWorld
        self.actions_set = CtfActions

        self._map_path = map_path
        self._field_map = load_text_map(map_path)
        height, width = self._field_map.shape
        self.height, self.width = height, width

        fm = self._field_map
        idx = self.world.OBJECT_TO_IDX
        self.obstacle = list(zip(*np.where(fm == idx["obstacle"])))
        self.blue_flag = list(zip(*np.where(fm == idx["blue_flag"])))[0]
        self.red_flag = list(zip(*np.where(fm == idx["red_flag"])))[0]
        self.blue_territory = list(zip(*np.where(fm == idx["blue_territory"]))) + [self.blue_flag]
        self.red_territory = list(zip(*np.where(fm == idx["red_territory"]))) + [self.red_flag]

        # One policy object per red agent, bound to the env's generator,
        # action set and field map.  A PolicySpec becomes its stock class
        # (RwPolicy takes no randomness).
        if not isinstance(enemy_policies, list):
            enemy_policies = [enemy_policies for _ in range(num_red_agents)]
        if len(enemy_policies) != num_red_agents:
            raise ValueError(
                f"{len(enemy_policies)} enemy policies for {num_red_agents} red agents"
            )
        kind_classes = {v: k for k, v in _POLICY_KINDS.items()}
        enemy_policies = [
            (
                kind_classes[p.kind]()
                if p.kind == "rw"
                else kind_classes[p.kind](randomness=p.randomness)
            )
            if isinstance(p, PolicySpec)
            else p
            for p in enemy_policies
        ]
        for policy in enemy_policies:
            if getattr(policy, "field_map", "missing") is None:
                policy.field_map = self._field_map
            if hasattr(policy, "random_generator"):
                policy.random_generator = self.np_random
            if hasattr(policy, "action_set"):
                policy.action_set = self.actions_set
        self.enemy_policies = enemy_policies

        self._in_step = all(type(p) in _POLICY_KINDS for p in enemy_policies)

        def _spec_randomness(p) -> float:
            # A host policy's spec is never stepped: any randomness will do.
            r = getattr(p, "randomness", 0.75)
            return float(r) if isinstance(r, (int, float)) and 0 <= r <= 1 else 0.75

        specs = tuple(
            PolicySpec(kind=_POLICY_KINDS.get(type(p), "rw"), randomness=_spec_randomness(p))
            for p in enemy_policies
        )

        self.cfg = CtfConfig(
            map_data=tuple(tuple(int(v) for v in row) for row in fm),
            num_blue_agents=num_blue_agents,
            num_red_agents=num_red_agents,
            variant=variant,
            enemy_policies=specs,
            battle_range=battle_range,
            randomness=randomness,
            flag_reward=flag_reward,
            battle_reward_ratio=battle_reward_ratio,
            obstacle_penalty_ratio=obstacle_penalty_ratio,
            step_penalty_ratio=step_penalty_ratio,
            max_steps=max_steps,
            observation_option=observation_option,
            observation_scaling=observation_scaling,
        )
        self.device = _build.default_device(device, type(self).__name__)
        self._fns = cached_ctf(self.cfg, self.device)

        self.agents = [
            CtfAgentProxy(i, "blue_agent", "blue") for i in range(num_blue_agents)
        ] + [
            CtfAgentProxy(num_blue_agents + i, "red_agent", "red", policy=enemy_policies[i])
            for i in range(num_red_agents)
        ]

        self.observation_space = self._set_observation_space()
        self.step_count = 0
        self._generator = new_generator(self.device)
        self._state = None
        self.window = None

    # -- spaces -------------------------------------------------------------
    def _set_observation_space(self):
        shape = self._field_map.shape
        n_bt, n_rt = len(self.blue_territory), len(self.red_territory)
        n_ob = len(self.obstacle)
        nb, nr = self.num_blue_agents, self.num_red_agents

        def box_pts(n):
            return spaces.Box(
                low=np.zeros(2 * n),
                high=np.tile(np.asarray(shape), n).astype(float) - 1,
                dtype=np.int64,
            )

        if self.observation_option == "positional":
            if self._is_1v1():
                d = {
                    "blue_agent": spaces.Box(
                        low=np.array([-1, -1]), high=np.array(shape) - 1, dtype=np.int64
                    ),
                    "red_agent": spaces.Box(
                        low=np.array([-1, -1]), high=np.array(shape) - 1, dtype=np.int64
                    ),
                }
            else:
                d = {
                    "blue_agent": spaces.Box(
                        low=np.tile([-1, -1], nb),
                        high=np.tile(np.asarray(shape), nb) - 1,
                        dtype=np.int64,
                    ),
                    "red_agent": spaces.Box(
                        low=np.tile([-1, -1], nr),
                        high=np.tile(np.asarray(shape), nr) - 1,
                        dtype=np.int64,
                    ),
                }
            d.update(
                {
                    "blue_flag": spaces.Box(
                        low=np.array([0, 0]), high=np.array(shape) - 1, dtype=np.int64
                    ),
                    "red_flag": spaces.Box(
                        low=np.array([0, 0]), high=np.array(shape) - 1, dtype=np.int64
                    ),
                    "blue_territory": box_pts(n_bt),
                    "red_territory": box_pts(n_rt),
                    "obstacle": box_pts(n_ob),
                }
            )
            if self._is_1v1():
                d["is_red_agent_defeated"] = spaces.Discrete(2)
            else:
                d["terminated_agents"] = spaces.Box(
                    low=np.zeros(nb + nr), high=np.ones(nb + nr), dtype=np.int64
                )
            return spaces.Dict(d)

        if self.observation_option == "map":
            return spaces.Box(
                low=0, high=len(self.world.OBJECT_TO_IDX) - 1, shape=shape, dtype=np.int64
            )

        if self.observation_option == "flattened":
            # The reference's 1v1 hardcodes the length of high (8+200+1),
            # right only on the shipped board; both variants use the MvN
            # formula here.
            tail = (nb + nr) if not self._is_1v1() else 1
            n = 2 * (nb + nr) + 4 + 2 * n_ob + 2 * n_bt + 2 * n_rt + tail
            high = np.ones(n) * (np.max(shape) - 1) / self.observation_scaling
            high[-tail:] = 1
            return spaces.Box(low=np.zeros(n), high=high, dtype=np.int64)

        raise ValueError(f"Invalid observation_option: {self.observation_option}")

    def _is_1v1(self) -> bool:
        return self.cfg.variant == "1v1"

    # -- host obs/info conversion ------------------------------------------
    def _np_obs(self, obs):
        if isinstance(obs, dict):
            return {
                k: int(v) if k == "is_red_agent_defeated" else v.cpu().numpy().astype(np.int64)
                for k, v in obs.items()
            }
        return obs.cpu().numpy().astype(np.int64)

    def _get_dict_obs(self) -> ObservationDict | MultiAgentObservationDict:
        """The pre-move positional obs the host policies' ``act`` reads."""
        return host_observation(self.cfg, self._state)

    def _sync_proxies(self):
        pos = self._state.pos.cpu().numpy()
        dirs = self._state.dir.cpu().numpy()
        term = self._state.terminated.cpu().numpy()
        coll = self._state.collided.cpu().numpy()
        for i, a in enumerate(self.agents):
            a.pos = pos[i]
            a.dir = int(dirs[i])
            a.terminated = bool(term[i])
            a.collided = bool(coll[i])
            base = "blue" if a.type == "blue_agent" else "red"
            a.color = base if not a.terminated else f"{base}_grey"
        self.step_count = int(self._state.step_count)

    def _info_dict(self, info):
        return {
            k: float(info[k])
            for k in (
                "d_ba_ra", "d_ba_bf", "d_ba_rf", "d_ra_bf", "d_ra_rf",
                "d_bf_rf", "d_ba_bb", "d_ba_rb", "d_ra_bb", "d_ra_rb",
                "d_ba_ob",
            )
        }

    # -- gym API ------------------------------------------------------------
    def reset(self, *, seed: int | None = None, options: dict | None = None):
        super().reset(seed=seed)
        if seed is not None:
            self._generator.manual_seed(seed)
            # The host policies draw from the reseeded generator.
            for p in self.enemy_policies:
                if hasattr(p, "random_generator"):
                    p.random_generator = self.np_random
        self._state = self._fns.reset_fn(self._generator)
        self._sync_proxies()

        nb, nr = self.num_blue_agents, self.num_red_agents
        pos = self._state.pos.cpu().numpy()
        if self._is_1v1():
            self.blue_traj = [pos[0]]
            self.red_traj = [pos[1]]
        else:
            self.blue_traj = [[pos[i]] for i in range(nb)]
            self.red_traj = [[pos[nb + i]] for i in range(nr)]
        self.game_stats: GameStats = {
            "blue_agent_defeated": [False] * nb,
            "red_agent_defeated": [False] * nr,
            "blue_flag_captured": False,
            "red_flag_captured": False,
        }

        obs = self._np_obs(self._fns.obs_fn(self._state))
        info = self._info_dict(self._fns.info_fn(self._state))
        return obs, info

    def step(self, action):
        nb = self.num_blue_agents
        blue_actions = np.asarray(np.round(np.asarray(action, dtype=float)), dtype=np.int32)
        blue_actions = blue_actions.reshape(-1)
        if blue_actions.size != nb:
            raise ValueError(f"expected {nb} actions (one per blue agent), got "
                             f"{blue_actions.size}")

        if self._in_step:
            out = self._fns.step_fn(self._state, blue_actions, self._generator)
        else:
            red_actions = host_red_actions(self.cfg, self.enemy_policies, self._state)
            out = self._fns.step_actions_fn(
                self._state, np.concatenate([blue_actions, red_actions]), self._generator
            )
        self._state, obs, reward, terminated, truncated, info = out
        self._sync_proxies()

        st = self.game_stats
        st["red_flag_captured"] |= bool(info["red_flag_captured"])
        st["blue_flag_captured"] |= bool(info["blue_flag_captured"])
        bl = info["battle_blue_lost"].cpu().numpy()
        rl = info["battle_red_lost"].cpu().numpy()
        for i in range(nb):
            st["blue_agent_defeated"][i] |= bool(bl[i])
        for i in range(self.num_red_agents):
            st["red_agent_defeated"][i] |= bool(rl[i])
        pos = self._state.pos.cpu().numpy()
        if self._is_1v1():
            self.blue_traj.append(pos[0])
            self.red_traj.append(pos[1])
        else:
            for i in range(nb):
                self.blue_traj[i].append(pos[i])
            for i in range(self.num_red_agents):
                self.red_traj[i].append(pos[nb + i])

        return (
            self._np_obs(obs),
            float(reward),
            bool(terminated),
            bool(truncated),
            self._info_dict(info),
        )

    def render(self):
        from gym_multigrid_tpu_torch.render.tiles import render_ctf

        img = render_ctf(self.cfg, self._state)
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


class Ctf1v1Env(_CtfBase):
    """1 blue (ego) against 1 scripted red agent."""

    def __init__(
        self,
        map_path: str,
        enemy_policy=None,
        battle_range: float = 1.0,
        randomness: float = 0.75,
        flag_reward: float = 1.0,
        battle_reward_ratio: float = 0.25,
        obstacle_penalty_ratio: float = 0.0,
        step_penalty_ratio: float = 0.01,
        max_steps: int = 100,
        observation_option: str = "positional",
        observation_scaling: float = 1.0,
        render_mode: str = "rgb_array",
        uncached_object_types=("red_agent", "blue_agent"),
        device=None,
    ):
        enemy_policy = enemy_policy if enemy_policy is not None else RwPolicy()
        super().__init__(
            map_path=map_path,
            num_blue_agents=1,
            num_red_agents=1,
            enemy_policies=[enemy_policy],
            variant="1v1",
            battle_range=battle_range,
            randomness=randomness,
            flag_reward=flag_reward,
            battle_reward_ratio=battle_reward_ratio,
            obstacle_penalty_ratio=obstacle_penalty_ratio,
            step_penalty_ratio=step_penalty_ratio,
            max_steps=max_steps,
            observation_option=observation_option,
            observation_scaling=observation_scaling,
            render_mode=render_mode,
            uncached_object_types=uncached_object_types,
            device=device,
        )
        self.action_space = spaces.Discrete(len(self.actions_set))
        self.ac_dim = self.action_space.n

    @property
    def _is_red_agent_defeated(self) -> bool:
        return bool(self._state.terminated[1])

    def step(self, action):
        return super().step([int(np.round(np.asarray(action, dtype=float).item()))])


class CtFMvNEnv(_CtfBase):
    """N blue against M scripted red agents."""

    def __init__(
        self,
        map_path: str,
        num_blue_agents: int = 2,
        num_red_agents: int = 2,
        enemy_policies=None,
        battle_range: float = 1,
        randomness: float = 0.75,
        flag_reward: float = 1,
        battle_reward_ratio: float = 0.25,
        obstacle_penalty_ratio: float = 0,
        step_penalty_ratio: float = 0.01,
        max_steps: int = 100,
        observation_option: str = "positional",
        observation_scaling: float = 1,
        render_mode: str = "rgb_array",
        uncached_object_types=("red_agent", "blue_agent"),
        device=None,
    ):
        enemy_policies = enemy_policies if enemy_policies is not None else RwPolicy()
        super().__init__(
            map_path=map_path,
            num_blue_agents=num_blue_agents,
            num_red_agents=num_red_agents,
            enemy_policies=enemy_policies,
            variant="mvn",
            battle_range=battle_range,
            randomness=randomness,
            flag_reward=flag_reward,
            battle_reward_ratio=battle_reward_ratio,
            obstacle_penalty_ratio=obstacle_penalty_ratio,
            step_penalty_ratio=step_penalty_ratio,
            max_steps=max_steps,
            observation_option=observation_option,
            observation_scaling=observation_scaling,
            render_mode=render_mode,
            uncached_object_types=uncached_object_types,
            device=device,
        )
        self.action_space = spaces.MultiDiscrete(
            [len(self.actions_set) for _ in range(num_blue_agents)]
        )
        self.ac_dim = self.action_space.shape
