"""MultiGridEnv: the host-side extensible base engine (PyTorch port).

Counterpart of ``gym_multigrid_tpu/multigrid.py``: the reference's
constructor wiring, spaces, reset/step dispatch with ``_gen_grid`` and
``_handle_*`` hooks, placement and RNG helpers, partial-obs pipeline,
ASCII dump and renderer, over the host object model (``core/object.py``,
``core/agent.py``, ``core/grid.py``).  Users subclass it to build custom
envs out of ``WorldObj``s; the four families run on the batched engines
instead.  It subclasses ``gym.Env``, so it lives in ``adapters/`` with the
package's other gymnasium code.

Two bugs of the reference are repaired as the JAX package repairs them:
``gen_obs`` calls ``encode_for_agents`` with the right arguments, so
partial observations work, and ``_rand_bool`` / ``_rand_pos`` draw with
``np_random.integers``.

RNG layout kept from the reference: ``_rand_int`` is stdlib
``random.randint`` (INCLUSIVE upper bound), and ``step`` draws its agent
order from global ``np.random``.
"""

from __future__ import annotations

import math
import random
from typing import Callable, Type

import gymnasium as gym
import numpy as np
from gymnasium import spaces

from gym_multigrid_tpu_torch.core.agent import Agent, DefaultActions
from gym_multigrid_tpu_torch.core.constants import OBJECT_TO_STR, TILE_PIXELS
from gym_multigrid_tpu_torch.core.grid import Grid
from gym_multigrid_tpu_torch.core.object import WorldObj
from gym_multigrid_tpu_torch.core.world import DefaultWorld, World
from gym_multigrid_tpu_torch.typing import Position


class MultiGridEnv(gym.Env):
    """2D grid world base environment."""

    metadata = {"render_modes": ["human", "rgb_array"], "video.frames_per_second": 10}

    def __init__(
        self,
        agents: list[Agent],
        grid_size: int | None = None,
        width: int | None = None,
        height: int | None = None,
        max_steps: int = 100,
        see_through_walls: bool = False,
        partial_obs: bool = False,
        agent_view_size: int = 7,
        actions_set: Type = DefaultActions,
        world: World = DefaultWorld,
        render_mode: str = "rgb_array",
        uncached_object_types: list[str] = [],
    ) -> None:
        self.agents = agents
        assert render_mode is None or render_mode in self.metadata["render_modes"]
        self.render_mode = render_mode
        # (sic) attribute name matches the reference's typo so user code
        # poking at it keeps working (multigrid.py:46)
        self.uncahed_object_types = uncached_object_types
        self.uncached_object_types = uncached_object_types
        self.partial_obs = partial_obs
        self.agent_view_size = agent_view_size

        if grid_size:
            assert width is None and height is None
            width = height = grid_size
        else:
            assert width is not None and height is not None
        self.width = width
        self.height = height

        self.actions = actions_set
        self.action_space = spaces.Discrete(len(self.actions))
        self.world = world
        self.observation_space = self._set_observation_space()
        self.ac_dim = self.action_space.n
        self.reward_range = (0, 1)
        self.window = None
        self.max_steps = max_steps
        self.see_through_walls = see_through_walls
        self.grid = Grid(width, height, world)

    def _set_observation_space(self) -> spaces.Box | spaces.Dict:
        side = (
            (self.agent_view_size, self.agent_view_size)
            if self.partial_obs
            else (self.width, self.height)
        )
        return spaces.Box(
            low=0, high=255, shape=(*side, self.world.encode_dim), dtype="uint8"
        )

    # -- episode lifecycle ---------------------------------------------------
    def reset(self, *, seed: int | None = None, options: dict | None = None):
        super().reset(seed=seed)
        self._gen_grid(self.width, self.height)
        for a in self.agents:
            assert a.pos is not None and a.dir is not None
            a.carrying = None
        self.step_count = 0
        obs = self._all_obs()
        return obs, self._get_info()

    def _all_obs(self):
        if self.partial_obs:
            obs = self.gen_obs()
        else:
            obs = [
                self.grid.encode_for_agents(agent_pos=a.pos) for a in self.agents
            ]
        return [self.world.normalize_obs * ob for ob in obs]

    def _get_info(self) -> dict:
        return {}

    @property
    def steps_remaining(self) -> int:
        return self.max_steps - self.step_count

    def _gen_grid(self, width: int, height: int) -> None:
        raise NotImplementedError(
            "_gen_grid needs to be implemented by each environment"
        )

    # -- subclass hooks ------------------------------------------------------
    def _handle_pickup(self, i, rewards, fwd_pos, fwd_cell):
        pass

    def _handle_build(self, i, rewards, fwd_pos, fwd_cell):
        pass

    def _handle_drop(self, i, rewards, fwd_pos, fwd_cell):
        pass

    def _handle_special_moves(self, i, rewards, fwd_pos, fwd_cell):
        pass

    def _handle_switch(self, i, rewards, fwd_pos, fwd_cell):
        pass

    def _reward(self, current_agent: int, rewards, reward: float = 1):
        """Success reward with linear time decay."""
        rewards[current_agent] += reward - 0.9 * (self.step_count / self.max_steps)
        return rewards

    # -- RNG helpers ---------------------------------------------------------
    def _rand_int(self, low: int, high: int) -> int:
        """stdlib random.randint — INCLUSIVE high (multigrid.py:225-230)."""
        return random.randint(low, high)

    def _rand_float(self, low: float, high: float) -> float:
        return self.np_random.uniform(low, high)

    def _rand_bool(self) -> bool:
        return bool(self.np_random.integers(0, 2) == 0)

    def _rand_elem(self, iterable):
        lst = list(iterable)
        return lst[self._rand_int(0, len(lst) - 1)]

    def _rand_subset(self, iterable, num_elems: int) -> list:
        lst = list(iterable)
        assert num_elems <= len(lst)
        out = []
        while len(out) < num_elems:
            elem = self._rand_elem(lst)
            lst.remove(elem)
            out.append(elem)
        return out

    def _rand_pos(self, xLow, xHigh, yLow, yHigh) -> tuple[int, int]:
        return (
            int(self.np_random.integers(xLow, xHigh)),
            int(self.np_random.integers(yLow, yHigh)),
        )

    # -- placement -----------------------------------------------------------
    def place_obj(
        self,
        obj: WorldObj | None,
        top: Position | None = None,
        size: tuple[int, int] | None = None,
        reject_fn: Callable | None = None,
        max_tries: float = math.inf,
    ) -> np.ndarray:
        """Rejection-sample an empty cell of the (inclusive) rect and place
        ``obj`` there."""
        top = (0, 0) if top is None else (max(top[0], 0), max(top[1], 0))
        if size is None:
            size = (self.grid.width, self.grid.height)
        num_tries = 0
        while True:
            if num_tries > max_tries:
                raise RecursionError("rejection sampling failed in place_obj")
            num_tries += 1
            pos = np.array(
                (
                    self._rand_int(top[0], min(top[0] + size[0], self.grid.width - 1)),
                    self._rand_int(top[1], min(top[1] + size[1], self.grid.height - 1)),
                )
            )
            if self.grid.get(*pos) is not None:
                continue
            if reject_fn and reject_fn(self, pos):
                continue
            break
        self.grid.set(*pos, obj)
        if obj is not None:
            obj.init_pos = pos
            obj.pos = pos
        return pos

    def put_obj(self, obj: WorldObj, i: int, j: int) -> None:
        self.grid.set(i, j, obj)
        obj.init_pos = (i, j)
        obj.pos = (i, j)

    def place_agent(
        self,
        agent: Agent,
        pos: Position | None = None,
        top: Position | None = None,
        size: tuple[int, int] | None = None,
        rand_dir: bool = False,
        max_tries: float = math.inf,
    ) -> Position:
        if pos is not None:
            agent.pos = pos
            self.put_obj(agent, i=pos[0], j=pos[1])
        else:
            agent.pos = None
            pos = self.place_obj(agent, top, size, max_tries=max_tries)
            agent.pos = pos
            agent.init_pos = pos
        agent.dir = self._rand_int(0, 3) if rand_dir else 3
        agent.init_dir = agent.dir
        return pos

    # -- stepping ------------------------------------------------------------
    def step(self, actions):
        """Default-action dispatch in uniform random agent order; later
        movers see earlier movers' grid."""
        self.step_count += 1
        order = np.random.permutation(len(actions))
        rewards = np.zeros(len(actions))
        terminated = False

        for i in order:
            a = self.agents[i]
            if (
                a.terminated
                or a.paused
                or not a.started
                or actions[i] == self.actions.still
            ):
                continue
            fwd_pos = a.front_pos
            fwd_cell = self.grid.get(*fwd_pos)

            if actions[i] == self.actions.left:
                a.dir = (a.dir - 1) % 4
            elif actions[i] == self.actions.right:
                a.dir = (a.dir + 1) % 4
            elif actions[i] == self.actions.forward:
                if fwd_cell is not None:
                    if fwd_cell.type == "goal":
                        terminated = True
                        rewards = self._reward(i, rewards, 1)
                    elif fwd_cell.type == "switch":
                        self._handle_switch(i, rewards, fwd_pos, fwd_cell)
                elif fwd_cell is None or fwd_cell.can_overlap():
                    self.grid.set(*fwd_pos, a)
                    self.grid.set(*a.pos, None)
                    a.pos = fwd_pos
                self._handle_special_moves(i, rewards, fwd_pos, fwd_cell)
            elif (
                hasattr(self.actions, "build")
                and actions[i] == self.actions.build
            ):
                self._handle_build(i, rewards, fwd_pos, fwd_cell)
            elif actions[i] == self.actions.pickup:
                self._handle_pickup(i, rewards, fwd_pos, fwd_cell)
            elif actions[i] == self.actions.drop:
                self._handle_drop(i, rewards, fwd_pos, fwd_cell)
            elif actions[i] == self.actions.toggle:
                if fwd_cell:
                    fwd_cell.toggle(self, fwd_pos)
            elif actions[i] == self.actions.done:
                pass
            else:
                raise AssertionError("unknown action")

        truncated = self.step_count >= self.max_steps
        obs = self._all_obs()
        return obs, rewards, terminated, truncated, self._get_info()

    # -- partial observations -------------------------------------------------
    def gen_obs_grid(self):
        """Per-agent view sub-grids + visibility masks."""
        grids, vis_masks = [], []
        for a in self.agents:
            topX, topY, _, _ = a.get_view_exts()
            grid = self.grid.slice(topX, topY, a.view_size, a.view_size)
            for _ in range(a.dir + 1):
                grid = grid.rotate_left()
            if not self.see_through_walls:
                vis_mask = grid.process_vis(
                    agent_pos=(a.view_size // 2, a.view_size - 1)
                )
            else:
                vis_mask = np.ones((grid.width, grid.height), dtype=bool)
            grids.append(grid)
            vis_masks.append(vis_mask)
        return grids, vis_masks

    def gen_obs(self):
        """Per-agent partial view encodings."""
        grids, vis_masks = self.gen_obs_grid()
        return [
            grid.encode_for_agents([grid.width // 2, grid.height - 1], vis_mask)
            for grid, vis_mask in zip(grids, vis_masks)
        ]

    def agent_sees(self, a: Agent, x: int, y: int) -> bool:
        coordinates = a.relative_coords(x, y)
        return coordinates is not None

    # -- debug / rendering -----------------------------------------------------
    def __str__(self) -> str:
        """Two-chars-per-cell ASCII dump."""
        rows = []
        for j in range(self.grid.height):
            row = ""
            for i in range(self.grid.width):
                c = self.grid.get(i, j)
                if c is None:
                    row += "  "
                elif c.type == "door":
                    if c.is_open:
                        row += "__"
                    elif c.is_locked:
                        row += "L" + c.color[0].upper()
                    else:
                        row += "D" + c.color[0].upper()
                else:
                    row += OBJECT_TO_STR.get(c.type, "?") + c.color[0].upper()
            rows.append(row)
        return "\n".join(rows)

    def render(self, close=False, highlight=False, tile_size=TILE_PIXELS):
        if close:
            if self.window:
                self.window.close()
            return None
        if self.render_mode == "human" and not self.window:
            from gym_multigrid_tpu_torch.render.window import Window

            self.window = Window("gym_multigrid_tpu_torch")
            self.window.show(block=False)

        highlight_masks = None
        if highlight:
            _, vis_masks = self.gen_obs_grid()
            highlight_masks = {
                (i, j): [] for i in range(self.width) for j in range(self.height)
            }
            for i, a in enumerate(self.agents):
                # Vectorized view->board coordinate map: view cell (u, v)
                # sits u cells to the agent's right and (V-1-v) cells
                # ahead of it, measured from the far-left corner of the
                # facing view cone.
                V = a.view_size
                ahead = np.asarray(a.dir_vec, dtype=int)
                right = np.asarray(a.right_vec, dtype=int)
                corner = np.asarray(a.pos, dtype=int) + ahead * (V - 1) \
                    - right * (V // 2)
                u, v = np.meshgrid(np.arange(V), np.arange(V), indexing="ij")
                cells = (
                    corner[None, None]
                    + u[..., None] * right[None, None]
                    - v[..., None] * ahead[None, None]
                )  # (V, V, 2) board xy per view cell
                on_board = np.logical_and.reduce([
                    cells[..., 0] >= 0, cells[..., 0] < self.width,
                    cells[..., 1] >= 0, cells[..., 1] < self.height,
                ])
                for x, y in cells[np.asarray(vis_masks[i], bool) & on_board]:
                    highlight_masks[int(x), int(y)].append(i)

        img = self.grid.render(
            tile_size,
            highlight_masks=highlight_masks,
            uncached_object_types=self.uncahed_object_types,
        )
        if self.render_mode == "human":
            self.window.show_img(img)
        return img
