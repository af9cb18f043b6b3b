"""Map loading and geometry helpers (PyTorch port).

Counterpart of ``gym_multigrid_tpu/utils/map.py``: host-side numpy, run
when an env or a scripted policy is built and by the host policies'
``act``.
"""

from __future__ import annotations

import numpy as np

Position = tuple[int, int] | np.ndarray


def distance_points(p1: Position, p2: Position, is_defeated: bool = False) -> float:
    """Euclidean distance of two points; +inf if the agent is defeated."""
    if is_defeated:
        return float("inf")
    return float(np.linalg.norm(np.asarray(p1, dtype=float) - np.asarray(p2, dtype=float)))


def distance_area_point(point: Position, area: list[Position]) -> float:
    """Least Euclidean distance from a point to a set of cells."""
    pts = np.asarray(area, dtype=float).reshape(-1, 2)
    return float(np.min(np.linalg.norm(pts - np.asarray(point, dtype=float), axis=1)))


def load_text_map(map_path: str) -> np.ndarray:
    """Load a whitespace text map and transpose it, so that positions read
    (i, j) = (text column, text row)."""
    return np.loadtxt(map_path).T


def position_in_positions(position: Position, positions: list[Position]) -> bool:
    """Membership by coordinate equality."""
    for pos in positions:
        if position[0] == pos[0] and position[1] == pos[1]:
            return True
    return False


def closest_area_pos(pos: Position, area: list[Position]) -> Position:
    """The element of ``area`` closest to ``pos`` (Euclidean); ties go to
    the first, as ``np.argmin`` breaks them."""
    pts = np.asarray(area, dtype=float).reshape(-1, 2)
    d = np.linalg.norm(pts - np.asarray(pos, dtype=float), axis=1)
    return area[int(np.argmin(d))]
