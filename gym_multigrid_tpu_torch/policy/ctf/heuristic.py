"""Scripted CtF opponent policies (PyTorch port).

Counterpart of ``gym_multigrid_tpu/policy/ctf/heuristic.py``: the same
classes, constructor arguments, attributes and host-side ``act``, pure
numpy, so that a policy given the same ``np.random.Generator`` acts as the
JAX package's does.  Each stock class names in ``spec_kind`` the
``PolicySpec`` kind that the CtF step computes for a whole batch
(``ops/ctf_slab.py``); a subclass the adapters do not know acts on the
host.

The patrol policies' static tables are also the module functions
:func:`locate_border` and :func:`patrol_targets`, which the CtF step reads
by index: the pool index is a uniform draw, and the closest border cell
wins ties by list order, so the order is the JAX package's: own-territory
cells in row-major ``np.where`` order, the first matching direction for
each, and duplicates kept.
"""

from __future__ import annotations

from typing import Literal, TypeVar

import numpy as np
from numpy.random import Generator

from gym_multigrid_tpu_torch.core.actions import CtfActions
from gym_multigrid_tpu_torch.core.world import CtfWorld, World
from gym_multigrid_tpu_torch.policy.base import BaseAgentPolicy
from gym_multigrid_tpu_torch.policy.ctf.utils import a_star
from gym_multigrid_tpu_torch.utils.map import (
    Position,
    closest_area_pos,
    position_in_positions,
)

ObservationDictT = TypeVar("ObservationDictT", bound=dict)

#: Patrol border scan directions.
_DIRECTIONS: list[Position] = [(0, 1), (0, -1), (1, 0), (-1, 0)]


def locate_border(
    field_map: np.ndarray,
    ego_agent: Literal["red", "blue"] = "red",
    world: World = CtfWorld,
    directions: list[Position] = _DIRECTIONS,
) -> tuple[list[Position], list[Position]]:
    """(border, obstacle) of ``field_map`` for the ``ego_agent`` team.

    The border holds, for each own-territory cell, its first neighbour (in
    ``directions`` order) that is opponent territory or an obstacle."""
    own_t = "red_territory" if ego_agent == "red" else "blue_territory"
    opp_t = "red_territory" if ego_agent == "blue" else "blue_territory"

    fm = np.asarray(field_map)

    def cells(name):
        return [(int(i), int(j)) for i, j in zip(*np.where(fm == world.OBJECT_TO_IDX[name]))]

    own, opp, obstacle = cells(own_t), cells(opp_t), cells("obstacle")
    opp_set = set(opp) | set(obstacle)
    border: list[Position] = []
    for loc in own:
        for d in directions:
            new_loc = (loc[0] + d[0], loc[1] + d[1])
            if new_loc in opp_set:
                border.append(new_loc)
                break
    return border, obstacle


def patrol_targets(
    border: list[Position], directions: list[Position] = _DIRECTIONS
) -> list[Position]:
    """The on-border target pool, duplicates included: each neighbour of
    each border cell that is itself a border cell."""
    on_border = set(border)
    return [
        (pos[0] + d[0], pos[1] + d[1])
        for pos in border
        for d in directions
        if (pos[0] + d[0], pos[1] + d[1]) in on_border
    ]


class CtfPolicy(BaseAgentPolicy):
    """Abstract CtF policy."""

    def act(self, observation: ObservationDictT, curr_pos: Position) -> int:
        raise NotImplementedError


class RwPolicy(CtfPolicy):
    """Random walk: uniform over the action set."""

    spec_kind = "rw"

    def __init__(
        self,
        action_set=CtfActions,
        random_generator: Generator | None = None,
    ) -> None:
        super().__init__(action_set, random_generator)
        self.name = "rw"

    def act(self, observation=None, curr_pos=None) -> int:
        return int(self.random_generator.integers(0, len(self.action_set)))


class DestinationPolicy(CtfPolicy):
    """With probability ``randomness``, the first step of the shortest
    path to ``get_target``; else a uniform action."""

    spec_kind = None  # the target is abstract; concrete subclasses set a kind

    def __init__(
        self,
        field_map: np.ndarray | None = None,
        action_set=CtfActions,
        random_generator: Generator | None = None,
        randomness: float = 0.75,
    ) -> None:
        super().__init__(action_set, random_generator)
        self.name = "destination"
        self.field_map: np.ndarray | None = field_map
        self.randomness: float = randomness

    def get_target(self, observation: ObservationDictT, curr_pos: Position) -> Position:
        raise NotImplementedError

    def act(self, observation: ObservationDictT, curr_pos: Position) -> int:
        start = tuple(np.asarray(curr_pos))
        target = tuple(np.asarray(self.get_target(observation, curr_pos)))
        shortest_path = a_star(start, target, self.field_map)
        optimal_loc = np.array(shortest_path[1] if len(shortest_path) > 1 else target)

        is_action_optimal = self.random_generator.choice(
            [True, False], p=[self.randomness, 1 - self.randomness]
        )
        if not is_action_optimal:
            return int(self.random_generator.integers(0, len(self.action_set)))

        # Direction -> action: stay (0,0), left (0,-1), down (-1,0),
        # right (0,1), up (1,0).
        action_dir = tuple(optimal_loc - np.asarray(start))
        mapping = {
            (0, 0): self.action_set.stay,
            (0, -1): self.action_set.left,
            (-1, 0): self.action_set.down,
            (0, 1): self.action_set.right,
            (1, 0): self.action_set.up,
        }
        if action_dir not in mapping:
            raise ValueError("Invalid direction")
        return int(mapping[action_dir])


class FightPolicy(DestinationPolicy):
    """Target: the closest opponent agent."""

    spec_kind = "fight"

    def __init__(
        self,
        field_map: np.ndarray | None = None,
        action_set=CtfActions,
        random_generator: Generator | None = None,
        randomness: float = 0.75,
        ego_agent: Literal["red", "blue"] = "red",
    ) -> None:
        super().__init__(field_map, action_set, random_generator, randomness)
        self.name = "fight"
        self.ego_agent: Literal["red", "blue"] = ego_agent

    def get_target(self, observation: ObservationDictT, curr_pos: Position) -> Position:
        opponent_agent = "blue_agent" if self.ego_agent == "red" else "red_agent"
        opponent_pos = [tuple(p) for p in np.asarray(observation[opponent_agent]).reshape(-1, 2)]
        return closest_area_pos(curr_pos, opponent_pos)


class CapturePolicy(DestinationPolicy):
    """Target: the opponent's flag."""

    spec_kind = "capture"

    def __init__(
        self,
        field_map: np.ndarray | None = None,
        action_set=CtfActions,
        random_generator: Generator | None = None,
        randomness: float = 0.75,
        ego_agent: Literal["red", "blue"] = "red",
    ) -> None:
        super().__init__(field_map, action_set, random_generator, randomness)
        self.name = "capture"
        self.ego_agent: Literal["red", "blue"] = ego_agent

    def get_target(self, observation: ObservationDictT, curr_pos: Position) -> Position:
        key = "blue_flag" if self.ego_agent == "red" else "red_flag"
        return observation[key]


class PatrolPolicy(DestinationPolicy):
    """Patrol the territory border (:func:`locate_border`): on the border,
    a uniform pick from the pool (:func:`patrol_targets`, duplicates
    weighing more); off it, the closest border cell.

    The border is computed from ``field_map`` when there is one, and again
    at the first ``act`` after a map is given to a policy built without
    one (the env gives it its map)."""

    spec_kind = "patrol"

    def __init__(
        self,
        field_map: np.ndarray | None = None,
        action_set=CtfActions,
        random_generator: Generator | None = None,
        randomness: float = 0.75,
        ego_agent: Literal["red", "blue"] = "red",
        world: World = CtfWorld,
    ) -> None:
        super().__init__(field_map, action_set, random_generator, randomness)
        self.name = "patrol"
        self.ego_agent: Literal["red", "blue"] = ego_agent
        self.world: World = world
        self.directions: list[Position] = list(_DIRECTIONS)
        self.border: list[Position] = []
        self.obstacle: list[Position] = []
        if self.field_map is not None:
            self.border, self.obstacle = self.locate_border(world, self.directions)

    def _ensure_border(self) -> None:
        if not self.border and self.field_map is not None:
            self.border, self.obstacle = self.locate_border(self.world, self.directions)

    def locate_border(
        self, world: World, directions: list[Position]
    ) -> tuple[list[Position], list[Position]]:
        """(border, obstacle) of the field map (:func:`locate_border`)."""
        return locate_border(self.field_map, self.ego_agent, world, directions)

    def patrol_targets(self) -> list[Position]:
        """The on-border target pool (:func:`patrol_targets`)."""
        self._ensure_border()
        return patrol_targets(self.border, self.directions)

    def get_target(self, observation: ObservationDictT, curr_pos: Position) -> Position:
        self._ensure_border()
        if position_in_positions(curr_pos, self.border):
            optimal_locs = self.patrol_targets()
            idx = self.random_generator.integers(0, len(optimal_locs))
            return optimal_locs[int(idx)]
        return closest_area_pos(curr_pos, self.border)


class PatrolFightPolicy(PatrolPolicy):
    """Patrol until an opponent stands in the ego team's territory, then
    fight the closest opponent."""

    spec_kind = "patrol_fight"

    def __init__(
        self,
        field_map: np.ndarray | None = None,
        action_set=CtfActions,
        random_generator: Generator | None = None,
        randomness: float = 0.75,
        ego_agent: Literal["red", "blue"] = "red",
        world: World = CtfWorld,
    ) -> None:
        super().__init__(field_map, action_set, random_generator, randomness, ego_agent, world)
        self.name = "patrol_fight"

    def get_target(self, observation: ObservationDictT, curr_pos: Position) -> Position:
        opponent_agent = "blue_agent" if self.ego_agent == "red" else "red_agent"
        ego_territory = "red_territory" if self.ego_agent == "red" else "blue_territory"
        opponent_pos = [tuple(p) for p in np.asarray(observation[opponent_agent]).reshape(-1, 2)]
        ego_territory_pos = [
            tuple(p) for p in np.asarray(observation[ego_territory]).reshape(-1, 2)
        ]
        for pos in opponent_pos:
            if position_in_positions(pos, ego_territory_pos):
                return closest_area_pos(curr_pos, opponent_pos)
        return super().get_target(observation, curr_pos)
