"""Env families of the port: Collect, Capture-the-Flag, Maze and Wildfire.

The names of ``gym_multigrid_tpu.envs``: each family's config, state and
per-env ``make_*``, and the gymnasium classes.  The classes subclass
``gym.Env``, so they live in ``adapters/`` and are imported from here on
first use: the package imports without gymnasium."""

from gym_multigrid_tpu_torch.envs.collect import CollectConfig, CollectState, make_collect
from gym_multigrid_tpu_torch.envs.ctf import CtfConfig, CtfState, PolicySpec, make_ctf
from gym_multigrid_tpu_torch.envs.maze import MazeConfig, MazeState, make_maze
from gym_multigrid_tpu_torch.envs.wildfire import WildfireConfig, WildfireState, make_wildfire

#: The gymnasium classes, by the adapter module that defines each.
_ADAPTERS = {
    "Ctf1v1Env": "ctf_adapter",
    "CtFMvNEnv": "ctf_adapter",
    "MazeSingleAgentEnv": "maze_adapter",
    "WildfireEnv": "wildfire_adapter",
    "CollectGameEnv": "gym_adapter",
    "CollectGameEvenDist": "gym_adapter",
    "CollectGameQuadrants": "gym_adapter",
    "CollectGameQuadrantsRespawn": "gym_adapter",
    "CollectGameRooms": "gym_adapter",
    "CollectGameRoomsFixedHorizon": "gym_adapter",
}

__all__ = [
    "Ctf1v1Env",
    "CtFMvNEnv",
    "CtfConfig",
    "CtfState",
    "PolicySpec",
    "make_ctf",
    "MazeSingleAgentEnv",
    "MazeConfig",
    "MazeState",
    "make_maze",
    "WildfireEnv",
    "WildfireConfig",
    "WildfireState",
    "make_wildfire",
    "CollectGameEnv",
    "CollectGameEvenDist",
    "CollectGameQuadrants",
    "CollectGameQuadrantsRespawn",
    "CollectGameRooms",
    "CollectGameRoomsFixedHorizon",
    "CollectConfig",
    "CollectState",
    "make_collect",
]


def __getattr__(name):
    if name in _ADAPTERS:
        import importlib

        module = importlib.import_module(f"gym_multigrid_tpu_torch.adapters.{_ADAPTERS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
