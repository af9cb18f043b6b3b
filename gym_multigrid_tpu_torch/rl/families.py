"""Family registry of the learner: one place that builds a ``BatchedEnv``
and its action space for every env family (PyTorch port of
``gym_multigrid_tpu/rl/families.py``, same defaults and checks).

There is no ``use_pallas``: on a CUDA device the family's kernels run
whenever the batch steps.
"""

from __future__ import annotations

import os

FAMILIES = ("collect", "ctf", "maze", "wildfire")

# family -> (num_actions, policy_agents_fn(cfg))
_FAMILY_SPECS = {
    "collect": (4, lambda cfg: cfg.num_agents),
    "ctf": (5, lambda cfg: cfg.num_blue_agents),
    "maze": (5, lambda cfg: 1),
    "wildfire": (5, lambda cfg: cfg.num_agents),
}

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

# Observation options the MLP and conv learners take: one array per env.
_OBS_ALLOWED = {"ctf": ("flattened", "map"), "maze": ("map",)}


def make_ctf_cfg(
    map_path: str | None = None,
    opponents: tuple[str, ...] = ("rw", "rw"),
    obs_option: str | None = None,
):
    """The trainable CtF config: 2 blue in MvN against ``opponents``,
    flattened obs by default, on ``tests/assets/board.txt`` by default."""
    from gym_multigrid_tpu_torch.envs.ctf import CtfConfig, PolicySpec

    return CtfConfig.from_map_path(
        map_path or os.path.join(_REPO_ROOT, "tests/assets/board.txt"),
        num_blue_agents=2,
        num_red_agents=len(opponents),
        variant="mvn",
        enemy_policies=tuple(PolicySpec(k) for k in opponents),
        observation_option=obs_option or "flattened",
    )


def make_family_batch(
    family: str,
    num_envs: int,
    device=None,
    *,
    map_path: str | None = None,
    opponents: tuple[str, ...] = ("rw", "rw"),
    obs_option: str | None = None,
    wf_size: int = 8,
    wf_fires: int = 1,
    wf_spread: float = 0.15,
    wf_max_steps: int = 50,
    burn_penalty: float = 1.0,
):
    """(BatchedEnv, cfg, num_actions, policy_agents) for a family on
    ``device`` (the current CUDA device by default, as ``make_*_batch``;
    ``device="cpu"`` runs the plain versions).

    Defaults are the JAX package's learning configs: the quadrants-respawn
    Collect, CtF 2 blue on ``tests/assets/board.txt`` with flattened obs,
    the 13x13 Maze board at 100 steps, and the controllable Wildfire (8x8,
    one fire, spread 0.15, burn penalty 1).  ``obs_option`` is ``CtF``'s
    ("flattened" or "map") or Maze's ("map"); other families have a fixed
    grid observation."""
    from gym_multigrid_tpu_torch.parallel import vector as pv

    if obs_option is not None:
        allowed = _OBS_ALLOWED.get(family, ())
        if obs_option not in allowed:
            raise ValueError(
                f"obs_option={obs_option!r} is not trainable for {family!r}: "
                + (f"choose one of {allowed}" if allowed
                   else "this family has a fixed grid observation")
            )

    if family == "collect":
        from gym_multigrid_tpu_torch.envs.collect import CollectConfig

        cfg = CollectConfig(layout="quadrants_respawn", respawn=True, max_steps=50)
        env = pv.make_collect_batch(cfg, num_envs, device)
    elif family == "ctf":
        cfg = make_ctf_cfg(map_path, opponents, obs_option)
        env = pv.make_ctf_batch(cfg, num_envs, device)
    elif family == "maze":
        from gym_multigrid_tpu_torch.envs.maze import MazeConfig

        cfg = MazeConfig.from_map_path(
            map_path or os.path.join(_REPO_ROOT, "tests/assets/board_maze.txt"),
            max_steps=100,
            **({"observation_option": obs_option} if obs_option else {}),
        )
        env = pv.make_maze_batch(cfg, num_envs, device)
    elif family == "wildfire":
        from gym_multigrid_tpu_torch.envs.wildfire import WildfireConfig

        # burn_penalty >= the extinguish reward makes every ignition a net
        # loss, so fighting the fire is the optimum.
        cfg = WildfireConfig(
            size=wf_size,
            num_initial_fires=wf_fires,
            p_spread=wf_spread,
            max_steps=wf_max_steps,
            burn_penalty=burn_penalty,
        )
        env = pv.make_wildfire_batch(cfg, num_envs, device)
    else:
        raise ValueError(f"unknown family {family!r}; expected one of {FAMILIES}")
    num_actions, agents_fn = _FAMILY_SPECS[family]
    return env, cfg, num_actions, agents_fn(cfg)
