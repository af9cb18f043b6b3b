"""Action vocabularies of the env families (PyTorch port).

Counterpart of ``gym_multigrid_tpu/core/actions.py``: the same seven
``IntEnum`` sets, names and ids, kept here so that the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import enum


class DefaultActions(enum.IntEnum):
    still = 0
    left = 1
    right = 2
    forward = 3
    pickup = 4
    drop = 5
    toggle = 6
    done = 7


class CollectActions(enum.IntEnum):
    north = 0
    east = 1
    south = 2
    west = 3


class SmallActions(enum.IntEnum):
    still = 0
    left = 1
    right = 2
    forward = 3


class MineActions(enum.IntEnum):
    still = 0
    left = 1
    right = 2
    forward = 3
    build = 4


class CtfActions(enum.IntEnum):
    stay = 0
    left = 1
    down = 2
    right = 3
    up = 4


class MazeActions(enum.IntEnum):
    stay = 0
    left = 1
    down = 2
    right = 3
    up = 4


class WildfireActions(enum.IntEnum):
    stay = 0
    left = 1
    down = 2
    right = 3
    up = 4
