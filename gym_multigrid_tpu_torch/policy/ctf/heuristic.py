"""The static tables of the patrol policies (PyTorch port).

Counterpart of ``PatrolPolicy.locate_border`` and
``PatrolPolicy.patrol_targets`` in
``gym_multigrid_tpu/policy/ctf/heuristic.py``.  The CtF step reads both
lists by index: the pool index is a uniform draw, and the closest border
cell wins ties by list order, so the order here is the JAX package's:
own-territory cells in row-major ``np.where`` order, the first matching
direction for each, and duplicates kept.  The host policies with ``act``
are not ported yet.
"""

from __future__ import annotations

from typing import Literal

import numpy as np

from gym_multigrid_tpu_torch.core.world import CtfWorld

Position = tuple[int, int]

#: Patrol border scan directions.
_DIRECTIONS: list[Position] = [(0, 1), (0, -1), (1, 0), (-1, 0)]


def locate_border(
    field_map: np.ndarray, ego_agent: Literal["red", "blue"] = "red"
) -> tuple[list[Position], list[Position]]:
    """(border, obstacle) of ``field_map`` for the ``ego_agent`` team.

    The border holds, for each own-territory cell, its first neighbour (in
    ``_DIRECTIONS`` order) that is opponent territory or an obstacle."""
    own_t = "red_territory" if ego_agent == "red" else "blue_territory"
    opp_t = "red_territory" if ego_agent == "blue" else "blue_territory"

    fm = np.asarray(field_map)

    def cells(name):
        return [(int(i), int(j)) for i, j in zip(*np.where(fm == CtfWorld.OBJECT_TO_IDX[name]))]

    own, opp, obstacle = cells(own_t), cells(opp_t), cells("obstacle")
    opp_set = set(opp) | set(obstacle)
    border: list[Position] = []
    for loc in own:
        for d in _DIRECTIONS:
            new_loc = (loc[0] + d[0], loc[1] + d[1])
            if new_loc in opp_set:
                border.append(new_loc)
                break
    return border, obstacle


def patrol_targets(border: list[Position]) -> list[Position]:
    """The on-border target pool, duplicates included: each neighbour of
    each border cell that is itself a border cell."""
    on_border = set(border)
    return [
        (pos[0] + d[0], pos[1] + d[1])
        for pos in border
        for d in _DIRECTIONS
        if (pos[0] + d[0], pos[1] + d[1]) in on_border
    ]
