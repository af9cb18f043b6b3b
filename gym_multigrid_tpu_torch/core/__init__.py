"""Core layer of the port: constants, worlds, action sets, and the host
object model (world objects, agents, grid)."""

from gym_multigrid_tpu_torch.core.actions import (
    CollectActions,
    CtfActions,
    DefaultActions,
    MazeActions,
    MineActions,
    SmallActions,
    WildfireActions,
)
from gym_multigrid_tpu_torch.core.agent import Agent, PolicyAgent
from gym_multigrid_tpu_torch.core.grid import Grid
from gym_multigrid_tpu_torch.core.object import (
    Ball,
    Box,
    Door,
    Flag,
    Floor,
    Goal,
    Key,
    Lava,
    ObjectGoal,
    Obstacle,
    Switch,
    Wall,
    WorldObj,
    behavior_tables,
)
from gym_multigrid_tpu_torch.core.world import (
    CollectWorld,
    CtfWorld,
    DefaultWorld,
    MazeWorld,
    WildfireWorld,
    World,
)

__all__ = [
    "Agent", "PolicyAgent", "Grid", "World", "WorldObj", "behavior_tables",
    "Ball", "Box", "Door", "Flag", "Floor", "Goal", "Key", "Lava",
    "ObjectGoal", "Obstacle", "Switch", "Wall",
    "CollectWorld", "CtfWorld", "DefaultWorld", "MazeWorld", "WildfireWorld",
    "DefaultActions", "CollectActions", "SmallActions", "MineActions",
    "CtfActions", "MazeActions", "WildfireActions",
]
