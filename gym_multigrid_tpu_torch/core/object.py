"""World-object model: cell contents with behavior flags (PyTorch port).

Counterpart of ``gym_multigrid_tpu/core/object.py``: the reference's class
names, constructor signatures, behavior flags (can_overlap / can_pickup /
can_contain / see_behind / toggle) and 3- or 6-int ``encode()`` tuples,
host numpy.  These objects are the extension surface (``MultiGridEnv``
subclasses, grid construction, host rendering); the batched engines bake
the same flags into per-object-id tables (:func:`behavior_tables`).
"""

from __future__ import annotations

import numpy as np
from numpy.typing import NDArray

from gym_multigrid_tpu_torch.core.constants import STATE_TO_IDX
from gym_multigrid_tpu_torch.core.world import World
from gym_multigrid_tpu_torch.typing import Position


class WorldObj:
    """Base cell object."""

    def __init__(
        self,
        world: World,
        type: str = "base",
        color: str = "grey",
        bg_color: str | None = None,
    ):
        assert type in world.OBJECT_TO_IDX, type
        assert color in world.COLOR_TO_IDX, color
        self.type = type
        self.color = color
        self.bg_color = bg_color
        self.contains = None
        self.world = world
        self.init_pos: Position | None = None
        self.pos: Position | None = None

    # -- behavior flags ----------------------------------------------------
    def can_overlap(self) -> bool:
        return False

    def can_pickup(self) -> bool:
        return False

    def can_contain(self) -> bool:
        return False

    def see_behind(self) -> bool:
        return True

    def toggle(self, env, pos: Position) -> bool:
        return False

    # -- encoding ----------------------------------------------------------
    def encode(self, current_agent: bool = False) -> tuple[int, ...]:
        """(type, color, 0[, 0, 0, 0]) int tuple."""
        head = (
            self.world.OBJECT_TO_IDX[self.type],
            self.world.COLOR_TO_IDX[self.color],
        )
        if self.world.encode_dim == 3:
            return head + (0,)
        return head + (0, 0, 0, 0)

    @staticmethod
    def decode(type_idx: int, color_idx: int, state: int):
        raise NotImplementedError

    # -- rendering ---------------------------------------------------------
    def render(self, img: NDArray) -> None:
        raise NotImplementedError

    def _fill(self, img, fn, color, bg_color=None):
        from gym_multigrid_tpu_torch.utils.rendering import fill_coords

        fill_coords(
            img,
            fn,
            self.world.COLORS[color] if isinstance(color, str) else color,
            self.world.COLORS[bg_color] if isinstance(bg_color, str) else bg_color,
        )


class ObjectGoal(WorldObj):
    """Target marker for a given object type."""

    def __init__(self, world, index: int, target_type: str = "ball", reward: float = 1, color=None):
        super().__init__(world, "objgoal", world.IDX_TO_COLOR[index if color is None else color])
        self.target_type = target_type
        self.index = index
        self.reward = reward

    def render(self, img):
        from gym_multigrid_tpu_torch.utils.rendering import point_in_rect

        self._fill(img, point_in_rect(0, 1, 0, 1), self.color)


class Goal(WorldObj):
    """Terminal cell granting reward."""

    def __init__(self, world, index: int, reward=1, color=None):
        super().__init__(world, "goal", world.IDX_TO_COLOR[index if color is None else color])
        self.index = index
        self.reward = reward

    def can_overlap(self):
        return True

    def render(self, img):
        from gym_multigrid_tpu_torch.utils.rendering import point_in_rect

        self._fill(img, point_in_rect(0, 1, 0, 1), self.color)


class Switch(WorldObj):
    """"""

    def __init__(self, world):
        super().__init__(world, "switch", world.IDX_TO_COLOR[0])

    def can_overlap(self):
        return True

    def render(self, img):
        from gym_multigrid_tpu_torch.utils.rendering import point_in_rect

        self._fill(img, point_in_rect(0, 1, 0, 1), self.color)


class Floor(WorldObj):
    """Walkable colored tile."""

    def __init__(self, world, color: str = "blue", type: str = "floor"):
        super().__init__(world, type, color)

    def can_overlap(self):
        return True

    def render(self, img):
        from gym_multigrid_tpu_torch.utils.rendering import point_in_rect

        self._fill(img, point_in_rect(0, 1, 0, 1), self.color)


class Lava(WorldObj):
    """"""

    def __init__(self, world):
        super().__init__(world, "lava", "red")

    def can_overlap(self):
        return True

    def render(self, img):
        from gym_multigrid_tpu_torch.utils.rendering import point_in_line, point_in_rect

        self._fill(img, point_in_rect(0, 1, 0, 1), (255, 128, 0))
        for i in range(3):
            ylo, yhi = 0.3 + 0.2 * i, 0.4 + 0.2 * i
            for x0, y0, x1, y1 in [
                (0.1, ylo, 0.3, yhi),
                (0.3, yhi, 0.5, ylo),
                (0.5, ylo, 0.7, yhi),
                (0.7, yhi, 0.9, ylo),
            ]:
                self._fill(img, point_in_line(x0, y0, x1, y1, r=0.03), (0, 0, 0))


class Wall(WorldObj):
    """Opaque blocker."""

    def __init__(self, world, color: str = "grey"):
        super().__init__(world, "wall", color)

    def see_behind(self):
        return False

    def render(self, img):
        from gym_multigrid_tpu_torch.utils.rendering import point_in_rect

        self._fill(img, point_in_rect(0, 1, 0, 1), self.color)


class Obstacle(WorldObj):
    """Blocker that becomes walkable (with a penalty) when penalty != 0."""

    def __init__(self, world, penalty: float = 0, can_see_through: bool = True, color: str = "grey"):
        super().__init__(world, "obstacle", color)
        self.penalty = penalty
        self.can_see_through = can_see_through

    def see_behind(self):
        return self.can_see_through

    def can_overlap(self):
        return self.penalty != 0

    def render(self, img):
        from gym_multigrid_tpu_torch.utils.rendering import point_in_rect

        self._fill(img, point_in_rect(0, 1, 0, 1), self.color)


class Door(WorldObj):
    """Open/closed/locked state machine with 6-dim state encode."""

    def __init__(self, world, color: str, is_open: bool = False, is_locked: bool = False):
        super().__init__(world, "door", color)
        self.is_open = is_open
        self.is_locked = is_locked

    def can_overlap(self):
        return self.is_open

    def see_behind(self):
        return self.is_open

    def toggle(self, env, pos):
        if self.is_locked:
            # A matching-color key opens a locked door.
            carrying = getattr(env, "carrying", None)
            if isinstance(carrying, Key) and carrying.color == self.color:
                self.is_locked = False
                self.is_open = True
                return True
            return False
        self.is_open = not self.is_open
        return True

    def encode(self, current_agent: bool = False):
        if self.is_open:
            state = STATE_TO_IDX["open"]
        elif self.is_locked:
            state = STATE_TO_IDX["locked"]
        else:
            state = STATE_TO_IDX["closed"]
        head = (
            self.world.OBJECT_TO_IDX[self.type],
            self.world.COLOR_TO_IDX[self.color],
        )
        if self.world.encode_dim == 3:
            return head + (state,)
        return head + (state, 0, 0, 0)

    def render(self, img):
        from gym_multigrid_tpu_torch.utils.rendering import point_in_circle, point_in_rect

        c = self.world.COLORS[self.color]
        if self.is_open:
            self._fill(img, point_in_rect(0.88, 1.00, 0.00, 1.00), c)
            self._fill(img, point_in_rect(0.92, 0.96, 0.04, 0.96), (0, 0, 0))
            return
        self._fill(img, point_in_rect(0.00, 1.00, 0.00, 1.00), c)
        self._fill(img, point_in_rect(0.04, 0.96, 0.04, 0.96), (0, 0, 0))
        self._fill(img, point_in_rect(0.08, 0.92, 0.08, 0.92), c)
        self._fill(img, point_in_rect(0.12, 0.88, 0.12, 0.88), (0, 0, 0))
        if self.is_locked:
            # keyhole slot
            self._fill(img, point_in_rect(0.52, 0.75, 0.50, 0.56), c)
        else:
            self._fill(img, point_in_circle(cx=0.75, cy=0.50, r=0.08), c)


class Key(WorldObj):
    """"""

    def __init__(self, world, color: str = "blue"):
        super().__init__(world, "key", color)

    def can_pickup(self):
        return True

    def render(self, img):
        from gym_multigrid_tpu_torch.utils.rendering import point_in_circle, point_in_rect

        c = self.world.COLORS[self.color]
        # Vertical shaft + teeth + ring head
        self._fill(img, point_in_rect(0.50, 0.63, 0.31, 0.88), c)
        self._fill(img, point_in_rect(0.38, 0.50, 0.59, 0.66), c)
        self._fill(img, point_in_rect(0.38, 0.50, 0.81, 0.88), c)
        self._fill(img, point_in_circle(cx=0.56, cy=0.28, r=0.190), c)
        self._fill(img, point_in_circle(cx=0.56, cy=0.28, r=0.064), (0, 0, 0))


class Ball(WorldObj):
    """Collectible."""

    def __init__(self, world, index: int = 0, reward: float = 2):
        super().__init__(world, "ball", world.IDX_TO_COLOR[index])
        self.index = index
        self.reward = reward

    def can_pickup(self):
        return True

    def can_overlap(self):
        return True

    def render(self, img):
        from gym_multigrid_tpu_torch.utils.rendering import point_in_circle

        self._fill(img, point_in_circle(0.5, 0.5, 0.31), self.color)


class Box(WorldObj):
    """Container; toggling reveals its contents."""

    def __init__(self, world, color: str, contains=None):
        super().__init__(world, "box", color)
        self.contains = contains

    def can_pickup(self):
        return True

    def toggle(self, env, pos):
        env.grid.set(*pos, self.contains)
        return True

    def render(self, img):
        from gym_multigrid_tpu_torch.utils.rendering import point_in_rect

        c = self.world.COLORS[self.color]
        self._fill(img, point_in_rect(0.12, 0.88, 0.12, 0.88), c)
        self._fill(img, point_in_rect(0.18, 0.82, 0.18, 0.82), (0, 0, 0))
        self._fill(img, point_in_rect(0.16, 0.84, 0.47, 0.53), c)


class Flag(WorldObj):
    """Team flag: circle over a team-colored background."""

    def __init__(self, world, index: int, type: str = "flag", color: str = "blue", bg_color: str = "light_blue"):
        super().__init__(world, type, color, bg_color)
        self.index = index

    def can_pickup(self):
        return True

    def can_overlap(self):
        return True

    def render(self, img):
        from gym_multigrid_tpu_torch.utils.rendering import point_in_circle

        self._fill(img, point_in_circle(0.5, 0.5, 0.31), self.color, self.bg_color)


# ---------------------------------------------------------------------------
# Dense behavior tables — the array form the jitted engines consume.
# ---------------------------------------------------------------------------

#: Per-type default flags (class-level behavior; objects whose flags depend
#: on instance state — Obstacle penalty, Door open — are parameterized by
#: the caller).
_TYPE_FLAGS: dict[str, dict[str, bool]] = {
    "floor": {"can_overlap": True},
    "goal": {"can_overlap": True},
    "switch": {"can_overlap": True},
    "lava": {"can_overlap": True},
    "ball": {"can_overlap": True, "can_pickup": True},
    "flag": {"can_overlap": True, "can_pickup": True},
    "blue_flag": {"can_overlap": True, "can_pickup": True},
    "red_flag": {"can_overlap": True, "can_pickup": True},
    "blue_territory": {"can_overlap": True},
    "red_territory": {"can_overlap": True},
    "background": {"can_overlap": True},
    "key": {"can_pickup": True},
    "box": {"can_pickup": True},
    "wall": {"see_behind_false": True},
}


def behavior_tables(world: World, obstacle_penalty: float = 0.0) -> dict[str, np.ndarray]:
    """Dense bool tables indexed by object id for one world schema.

    Returns {"can_overlap", "can_pickup", "opaque"} arrays of length
    world.num_objects — the compile-time constants the functional engines
    index instead of dispatching on Python objects.
    """
    n = world.num_objects
    can_overlap = np.zeros(n, dtype=bool)
    can_pickup = np.zeros(n, dtype=bool)
    opaque = np.zeros(n, dtype=bool)
    for name, idx in world.OBJECT_TO_IDX.items():
        flags = _TYPE_FLAGS.get(name, {})
        can_overlap[idx] = flags.get("can_overlap", False)
        can_pickup[idx] = flags.get("can_pickup", False)
        opaque[idx] = flags.get("see_behind_false", False)
        if name == "obstacle":
            can_overlap[idx] = obstacle_penalty != 0
    return {"can_overlap": can_overlap, "can_pickup": can_pickup, "opaque": opaque}
