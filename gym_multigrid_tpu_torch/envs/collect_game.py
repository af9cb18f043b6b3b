"""Alias module: the reference names the Collect env classes' file
``envs/collect_game.py``; they live in ``adapters/gym_adapter.py``.

This module imports gymnasium, so ``envs/__init__.py`` does not re-export
it (as the JAX package's ``envs/__init__.py`` re-exports its adapters):
importing ``gym_multigrid_tpu_torch.envs`` needs no gymnasium.
"""

from gym_multigrid_tpu_torch.adapters.gym_adapter import (  # noqa: F401
    CollectGameEnv,
    CollectGameEvenDist,
    CollectGameQuadrants,
    CollectGameQuadrantsRespawn,
    CollectGameRooms,
    CollectGameRoomsFixedHorizon,
)
from gym_multigrid_tpu_torch.envs.collect import (  # noqa: F401
    CollectConfig,
    CollectState,
    cached_collect,
    make_collect,
)
