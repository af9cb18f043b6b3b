"""Agent object model (PyTorch port).

Counterpart of ``gym_multigrid_tpu/core/agent.py``: the ``Agent`` world
object (pos / dir / carrying / terminated flags, direction and
field-of-view math, a grid-aware ``move``) and ``PolicyAgent``, host numpy.
The action sets live in ``core/actions.py`` and are re-exported here.  The
batched engines carry the same information as state tensors (pos, dir,
terminated per agent; ``envs/*.py``).
"""

from __future__ import annotations

import math

import numpy as np
from numpy.typing import NDArray

from gym_multigrid_tpu_torch.core.actions import (  # noqa: F401  (re-exports)
    CollectActions,
    CtfActions,
    DefaultActions,
    MazeActions,
    MineActions,
    SmallActions,
    WildfireActions,
)
from gym_multigrid_tpu_torch.core.constants import DIR_TO_VEC
from gym_multigrid_tpu_torch.core.object import WorldObj
from gym_multigrid_tpu_torch.core.world import World
from gym_multigrid_tpu_torch.typing import Position


class Agent(WorldObj):
    """An agent is itself a grid object."""

    def __init__(
        self,
        world: World,
        index: int = 0,
        view_size: int = 7,
        actions=DefaultActions,
        dir_to_vec=DIR_TO_VEC,
        color: str | None = None,
        bg_color: str | None = None,
        type: str = "agent",
    ):
        super().__init__(
            world, type, world.IDX_TO_COLOR[index] if color is None else color, bg_color
        )
        self.pos: Position | None = None
        self.dir: int | None = None
        self.init_dir: int | None = None
        self.index = index
        self.view_size = view_size
        self.carrying = None
        self.terminated = False
        self.started = True
        self.paused = False
        self.collided = False
        self.actions = actions
        self.world = world
        self.dir_to_vec = dir_to_vec

    # -- encode / render ---------------------------------------------------
    def encode(self, current_agent: bool = False) -> tuple[int, ...]:
        """Dir-aware 3/6-dim encode."""
        head = (
            self.world.OBJECT_TO_IDX[self.type],
            self.world.COLOR_TO_IDX[self.color],
        )
        if self.world.encode_dim == 3:
            return head + (self.dir,)
        if self.carrying:
            return head + (
                self.world.OBJECT_TO_IDX[self.carrying.type],
                self.world.COLOR_TO_IDX[self.carrying.color],
                self.dir,
                1 if current_agent else 0,
            )
        return head + (0, 0, self.dir, 1 if current_agent else 0)

    def render(self, img):
        from gym_multigrid_tpu_torch.utils.rendering import (
            point_in_triangle,
            rotate_fn,
        )

        assert self.dir is not None
        tri = rotate_fn(
            point_in_triangle((0.12, 0.19), (0.87, 0.50), (0.12, 0.81)),
            cx=0.5,
            cy=0.5,
            theta=0.5 * math.pi * self.dir,
        )
        self._fill(img, tri, self.color, self.bg_color)

    # -- movement ----------------------------------------------------------
    def move(
        self,
        next_pos: Position,
        grid,
        init_grid=None,
        dummy_move: bool = False,
        bg_color: str | None = None,
    ) -> None:
        """Relocate on the grid, restoring the initial cell under the old
        position and inferring the facing direction from the step delta."""
        if self.pos is not None:
            delta = np.asarray(next_pos) - np.asarray(self.pos)
            for d, vec in enumerate(self.dir_to_vec):
                if np.array_equal(vec, delta):
                    self.dir = d
                    break
            if init_grid is not None:
                grid.set(*self.pos, init_grid.get(*self.pos))
        if not dummy_move:
            self.pos = next_pos
        assert self.pos is not None
        grid.set(*self.pos, self)
        if bg_color is not None:
            self.bg_color = bg_color

    # -- direction helpers -------------------------------------------------
    @property
    def dir_vec(self) -> NDArray:
        assert self.dir is not None and 0 <= self.dir < len(self.dir_to_vec)
        return self.dir_to_vec[self.dir]

    @property
    def right_vec(self) -> NDArray:
        dx, dy = self.dir_vec
        return np.array((-dy, dx))

    @property
    def front_pos(self) -> Position:
        return self.pos + self.dir_vec

    def _offset(self, dx: int, dy: int) -> Position:
        if self.pos is None:
            raise ValueError("Agent position is not set")
        return self.pos + np.array([dx, dy])

    def west_pos(self) -> Position:
        return self._offset(-1, 0)

    def east_pos(self) -> Position:
        return self._offset(1, 0)

    def north_pos(self) -> Position:
        return self._offset(0, -1)

    def south_pos(self) -> Position:
        return self._offset(0, 1)

    # -- field of view -----------------------------------------------------
    def get_view_coords(self, i: int, j: int) -> tuple[int, int]:
        """Absolute grid coords -> agent-view coords (may be out of range)."""
        ax, ay = self.pos
        dx, dy = self.dir_vec
        rx, ry = self.right_vec
        sz, hs = self.view_size, self.view_size // 2
        tx = ax + dx * (sz - 1) - rx * hs
        ty = ay + dy * (sz - 1) - ry * hs
        lx, ly = i - tx, j - ty
        return rx * lx + ry * ly, -(dx * lx + dy * ly)

    def get_view_exts(self) -> tuple[int, int, int, int]:
        """(topX, topY, botX, botY) of the view square, bot exclusive."""
        assert self.pos is not None
        sz, hs = self.view_size, self.view_size // 2
        x, y = self.pos[0], self.pos[1]
        if self.dir == 0:  # right
            top = (x, y - hs)
        elif self.dir == 1:  # down
            top = (x - hs, y)
        elif self.dir == 2:  # left
            top = (x - sz + 1, y - hs)
        elif self.dir == 3:  # up
            top = (x - hs, y - sz + 1)
        else:
            raise AssertionError("invalid agent direction")
        return (top[0], top[1], top[0] + sz, top[1] + sz)

    def relative_coords(self, x: int, y: int) -> tuple[int, int] | None:
        vx, vy = self.get_view_coords(x, y)
        if vx < 0 or vy < 0 or vx >= self.view_size or vy >= self.view_size:
            return None
        return vx, vy

    def in_view(self, x: int, y: int) -> bool:
        return self.relative_coords(x, y) is not None


class PolicyAgent(Agent):
    """Agent driven by a scripted policy."""

    def __init__(self, policy, world: World, **kwargs):
        super().__init__(world, **kwargs)
        self.policy = policy
