"""Color tables and direction vectors (PyTorch port).

Counterpart of ``gym_multigrid_tpu/core/constants.py``: the tables the
Collect, CtF, Maze and Wildfire paths, the sprite-bank renderer and the
host object model read.  They are plain numpy arrays and dicts so the rest
of the port can build device tensors from them.
"""

from __future__ import annotations

import numpy as np

# Size in pixels of a tile in the full-scale human view.
TILE_PIXELS = 32

# Map of color names to RGB values (insertion order defines the color ids).
COLORS: dict[str, np.ndarray] = {
    "red": np.array([228, 3, 3]),
    "orange": np.array([255, 140, 0]),
    "yellow": np.array([255, 237, 0]),
    "green": np.array([0, 128, 38]),
    "blue": np.array([0, 77, 255]),
    "purple": np.array([117, 7, 135]),
    "brown": np.array([120, 79, 23]),
    "grey": np.array([100, 100, 100]),
    "light_red": np.array([234, 153, 153]),
    "light_blue": np.array([90, 170, 223]),
}

# CtF palette: other light_* shades, plus white and the defeated greys.
CTF_COLORS: dict[str, np.ndarray] = {
    "red": np.array([228, 3, 3]),
    "orange": np.array([255, 140, 0]),
    "yellow": np.array([255, 237, 0]),
    "green": np.array([0, 128, 38]),
    "blue": np.array([0, 77, 255]),
    "purple": np.array([117, 7, 135]),
    "brown": np.array([120, 79, 23]),
    "grey": np.array([100, 100, 100]),
    "light_red": np.array([255, 228, 225]),
    "light_blue": np.array([240, 248, 255]),
    "white": np.array([255, 250, 250]),
    "red_grey": np.array([170, 152, 169]),
    "blue_grey": np.array([140, 146, 172]),
}

# Maze palette: the CtF one without the defeated greys.
MAZE_COLORS: dict[str, np.ndarray] = {
    "red": np.array([228, 3, 3]),
    "orange": np.array([255, 140, 0]),
    "yellow": np.array([255, 237, 0]),
    "green": np.array([0, 128, 38]),
    "blue": np.array([0, 77, 255]),
    "purple": np.array([117, 7, 135]),
    "brown": np.array([120, 79, 23]),
    "grey": np.array([100, 100, 100]),
    "light_red": np.array([255, 228, 225]),
    "light_blue": np.array([240, 248, 255]),
    "white": np.array([255, 250, 250]),
}

COLOR_NAMES = sorted(COLORS)

COLOR_TO_IDX: dict[str, int] = {key: i for i, key in enumerate(COLORS)}
IDX_TO_COLOR = {v: k for k, v in COLOR_TO_IDX.items()}

# Map of door state names to integers.
STATE_TO_IDX = {"open": 0, "closed": 1, "locked": 2}

# Agent direction -> (dx, dy): right, down, left, up.
DIR_TO_VEC = np.array([(1, 0), (0, 1), (-1, 0), (0, -1)], dtype=np.int32)

# Collect action -> (dx, dy): north, east, south, west.
COLLECT_ACTION_TO_VEC = np.array(
    [(0, -1), (1, 0), (0, 1), (-1, 0)], dtype=np.int32
)

# CtF, Maze and Wildfire action -> position delta: stay, left, down, right,
# up.
CTF_ACTION_TO_VEC = np.array(
    [(0, 0), (0, -1), (-1, 0), (0, 1), (1, 0)], dtype=np.int32
)

# Object type -> the one-letter code of the ASCII dump.
OBJECT_TO_STR = {
    "wall": "x",
    "floor": "F",
    "door": "D",
    "key": "K",
    "ball": "o",
    "box": "B",
    "goal": "G",
    "lava": "V",
    "agent": "a",
}

# Short string for an opened door.
OPENED_DOOR_IDS = "_"

# Agent direction -> its arrow in the ASCII dump.
AGENT_DIR_TO_STR = {0: ">", 1: "V", 2: "<", 3: "^"}


def color_matrix(colors: dict[str, np.ndarray]) -> np.ndarray:
    """Dense (num_colors, 3) uint8 RGB matrix for on-device gathers."""
    return np.stack([np.asarray(c, dtype=np.uint8) for c in colors.values()])
