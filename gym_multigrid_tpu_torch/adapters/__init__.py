"""Gymnasium adapters of the port: the reference's ``gym.Env`` classes,
a ``VectorEnv`` over the batched envs, and their registration.

This package imports gymnasium; nothing else in the port does, so the
batched envs, the kernels and the learner run where gymnasium is not
installed.  :func:`register_envs` registers the JAX package's 10 ids
under the namespace ``MultiGridTorch`` (``MultiGridTorch/multigrid-collect-v0``
and so on), with the same kwargs and time limits: the JAX package owns
the bare ids, and both packages can be loaded in one process.
"""

from __future__ import annotations

from gymnasium.envs.registration import register

NAMESPACE = "MultiGridTorch"

_ADAPTERS = "gym_multigrid_tpu_torch.adapters"


def register_envs() -> None:
    """(Re-)register the 10 ids under ``MultiGridTorch/``.  Idempotent.
    ``gym.make(id)`` builds the env on the current CUDA device;
    ``gym.make(id, device="cpu")`` on the CPU."""
    common = {
        "size": 10,
        "num_balls": 15,
        "agents_index": [3, 5],  # green, purple
        "balls_index": [0, 1, 2],  # red, orange, yellow
        "balls_reward": [1, 1, 1],
    }
    collect = f"{_ADAPTERS}.gym_adapter"
    ids = [
        # (id, entry point, max_episode_steps, kwargs)
        ("multigrid-collect-v0", f"{collect}:CollectGameEvenDist", 100,
         {**common, "respawn": False}),
        ("multigrid-collect-single-v0", f"{collect}:CollectGameEvenDist", 100,
         {**common, "agents_index": [3], "respawn": False}),
        ("multigrid-collect-quadrants-v0", f"{collect}:CollectGameQuadrants", 100,
         {**common, "respawn": False}),
        ("multigrid-collect-rooms-v0", f"{collect}:CollectGameRooms", 100,
         {**common, "respawn": False}),
        ("multigrid-collect-rooms-fixed-horizon-v0", f"{collect}:CollectGameRoomsFixedHorizon",
         100, {**common, "respawn": False}),
        ("multigrid-collect-rooms-respawn-v0", f"{collect}:CollectGameRoomsFixedHorizon", 50,
         {**common, "respawn": True}),
        ("multigrid-collect-respawn-v0", f"{collect}:CollectGameEvenDist", 50,
         {**common, "respawn": True}),
        ("multigrid-collect-respawn-clustered-v0", f"{collect}:CollectGameQuadrantsRespawn", 50,
         {**common, "respawn": True}),
        ("multigrid-collect-quadrants15-v0", f"{collect}:CollectGameQuadrants", None,
         {**common, "size": 15, "num_balls": 30, "respawn": False}),
        ("multigrid-wildfire-v0", f"{_ADAPTERS}.wildfire_adapter:WildfireEnv", 100,
         {"size": 16, "num_agents": 2}),
    ]
    for env_id, entry_point, max_steps, kwargs in ids:
        register(
            id=f"{NAMESPACE}/{env_id}",
            entry_point=entry_point,
            max_episode_steps=max_steps,
            disable_env_checker=True,
            kwargs=kwargs,
        )
