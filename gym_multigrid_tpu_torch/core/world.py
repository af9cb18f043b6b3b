"""World descriptors: per-env-family encoding schemas (PyTorch port).

Counterpart of ``gym_multigrid_tpu/core/world.py``.  The object
vocabularies are the observation spec, so their names and index values
must match the reference exactly.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from gym_multigrid_tpu_torch.core.constants import COLORS, CTF_COLORS, MAZE_COLORS


@dataclass(frozen=True)
class World:
    """Static encoding schema for one env family."""

    encode_dim: int
    normalize_obs: int
    OBJECT_TO_IDX: dict[str, int]
    COLORS: dict[str, np.ndarray]
    COLOR_TO_IDX: dict[str, int] = field(init=False)
    IDX_TO_COLOR: dict[int, str] = field(init=False)
    IDX_TO_OBJECT: dict[int, str] = field(init=False)

    def __post_init__(self):
        set_ = object.__setattr__
        set_(self, "COLOR_TO_IDX", {k: i for i, k in enumerate(self.COLORS)})
        set_(self, "IDX_TO_COLOR", dict(enumerate(self.COLORS)))
        set_(self, "IDX_TO_OBJECT", {v: k for k, v in self.OBJECT_TO_IDX.items()})

    @property
    def num_objects(self) -> int:
        return len(self.OBJECT_TO_IDX)


def _schema(encode_dim: int, colors, *object_names: str) -> World:
    """Build a World whose object ids are the listed name order."""
    return World(
        encode_dim=encode_dim,
        normalize_obs=1,
        COLORS=colors,
        OBJECT_TO_IDX={name: i for i, name in enumerate(object_names)},
    )


#: The 13-type, 6-dim default schema of the host object model
#: (``adapters/multigrid.py``).
DefaultWorld = _schema(
    6, COLORS,
    "unseen", "empty", "wall", "floor", "door", "key", "ball", "box",
    "goal", "lava", "agent", "objgoal", "switch",
)

#: Collect: empty/wall/ball/agent = 0..3
CollectWorld = _schema(3, COLORS, "empty", "wall", "ball", "agent")

#: CtF: territories 0/1, agents 2/3, flags 4/5, obstacle 6
CtfWorld = _schema(
    3, CTF_COLORS,
    "blue_territory", "red_territory", "blue_agent", "red_agent",
    "blue_flag", "red_flag", "obstacle",
)

#: Maze: background/agent/flag/obstacle = 0..3
MazeWorld = _schema(3, MAZE_COLORS, "background", "agent", "flag", "obstacle")

#: Wildfire: empty/tree/fire/burnt/agent = 0..4
WildfireWorld = _schema(3, COLORS, "empty", "tree", "fire", "burnt", "agent")
