"""Batched lockstep envs with auto-reset (PyTorch port).

Counterpart of ``BatchedEnv`` and the ``make_*_batch`` functions in
``gym_multigrid_tpu/parallel/vector.py``, for Collect, CtF, Maze and
Wildfire.  The batch runs in lockstep on one device; each step of the
whole batch launches the family's step kernel once on a CUDA device
(``ops/*_slab.py``), beside the PyTorch glue around it.  Finished envs are
reset under a ``done`` mask (in place by the Collect reset kernel; into new
tensors by the other families' resets, which are plain PyTorch), so
neither ``step`` nor ``rollout`` waits on the device inside its loop.  A
Wildfire batch on the kernel route with the full observation takes no
glue: its ``step_reset`` (``wildfire_slab.step_reset``) is the step kernel
and one auto-reset kernel, which writes the observation, the rewards, the
flags and the fresh boards.
Randomness comes from the env's ``torch.Generator``, seeded by
``reset(seed)``.

:func:`next_step_autoreset` steps a batch under gymnasium's NEXT_STEP
autoreset, and :class:`NextStepEnv` drives it from the host with numpy
actions and results: the core of the gymnasium ``VectorEnv`` in
``adapters/vector_adapter.py``, with no gymnasium import here.
:func:`make_vector_batch` builds each family's batch with that adapter's
default configs.

The episode rollouts ``make_collect_episode_rollout``,
``make_maze_episode_rollout``, ``make_ctf_episode_rollout`` and
``make_wildfire_episode_rollout`` (``ops/*_slab.py``) are the fewer-launch
path for the same metrics: one kernel launch a chunk of steps, the reset
inside the kernel (Collect's the lockstep truncation reset, the others'
the per-env auto-reset).
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass, fields
from typing import Callable

import numpy as np
import torch

from gym_multigrid_tpu_torch.core.constants import COLLECT_ACTION_TO_VEC
from gym_multigrid_tpu_torch.envs import collect, ctf, maze, wildfire
from gym_multigrid_tpu_torch.ops import _build, collect_slab, ctf_slab, maze_slab, wildfire_slab
from gym_multigrid_tpu_torch.utils.profiling import annotate


@dataclass(frozen=True, eq=False)
class StepReset:
    """A family's whole batch step with the auto-reset in one function, and
    the glue it stands for."""

    #: ``fn(slab, states, actions, generator, encode_obs) -> (states', obs,
    #: rewards, terminated, truncated)``: the same results as ``step_batch``,
    #: ``encode`` and ``reset_batch`` of ``glue`` on the same draws.
    fn: Callable
    #: (step_batch, encode, reset_batch): the batch's glue that ``fn``
    #: stands for.
    glue: tuple


@dataclass(frozen=True, eq=False)
class BatchedEnv:
    """Batched env with auto-reset, for one env family.

    reset(seed) -> (states, obs)
    step(states, actions) -> (states', obs, rewards, terminated, truncated)

    ``step`` applies the transition to every env, then resets the envs that
    finished (unless ``auto_reset`` is False); the obs and rewards it
    returns are the *pre-reset* ones (gymnasium's autoreset convention: the
    final step is visible, and the next step starts from the reset state).
    Rewards are (B, A) per agent for Collect and Wildfire and (B,) per env
    for CtF and Maze.  The obs is ``encode(cfg, states)`` of the post-step
    states: the family's configured observation, or each agent's field of
    view where the batch was built with ``partial_obs_view``.
    """

    slab: (collect_slab.CollectSlab | ctf_slab.CtfSlab | maze_slab.MazeSlab
           | wildfire_slab.WildfireSlab)
    num_envs: int
    generator: torch.Generator
    # The family's batch functions: step_batch(slab, states, actions, *,
    # generator, encode_obs), reset_batch(slab, n, *, generator, done,
    # states) -> states and encode(cfg, states).
    step_batch: Callable
    reset_batch: Callable
    encode: Callable
    #: Action space of one env: ids 0..num_actions-1, action_cols of them,
    #: or one id with no action axis when action_cols is None (Maze).
    num_actions: int
    action_cols: int | None
    #: False: ``step`` returns the post-step states without resetting any.
    auto_reset: bool = True
    #: Optional: the whole step with the auto-reset in one function
    #: (:class:`StepReset`), which stands for ``step_batch``, ``encode`` and
    #: ``reset_batch`` together and overrides all three in ``step`` and
    #: ``rollout`` where ``auto_reset`` is True.  A batch built with other
    #: glue than the one it stands for (``dataclasses.replace`` of any of
    #: the three) drops it, and steps through its own glue.
    step_reset: StepReset | None = None

    def __post_init__(self):
        fused = self.step_reset
        if fused is not None and fused.glue != (self.step_batch, self.encode, self.reset_batch):
            object.__setattr__(self, "step_reset", None)

    @property
    def actions_shape(self) -> tuple[int, ...]:
        """Shape of the batch's actions."""
        if self.action_cols is None:
            return (self.num_envs,)
        return (self.num_envs, self.action_cols)

    @property
    def cfg(self):
        return self.slab.cfg

    @property
    def device(self) -> torch.device:
        return self.slab.device

    def reset(self, seed: int):
        """Seed the env's generator and reset every env."""
        self.generator.manual_seed(seed)
        states = self.reset_batch(self.slab, self.num_envs, generator=self.generator)
        return states, self.encode(self.cfg, states)

    def step(self, states, actions):
        with annotate("env.step"):
            if not isinstance(actions, torch.Tensor) or actions.device != self.device:
                actions = torch.as_tensor(actions, device=self.device)
            if tuple(actions.shape) != self.actions_shape:
                raise ValueError(
                    f"actions must have shape {self.actions_shape}, got {tuple(actions.shape)}"
                )
            return self._step(states, actions, encode_obs=True)

    def _step(self, states, actions, encode_obs):
        if self.step_reset is not None and self.auto_reset:
            return self.step_reset.fn(self.slab, states, actions, self.generator, encode_obs)
        # The obs is taken here, before the reset (Collect's resets the
        # finished rows in place), and never computed by the step.
        with annotate("env.transition"):
            new_states, _, rewards, term, trunc, _ = self.step_batch(
                self.slab, states, actions, generator=self.generator, encode_obs=False,
            )
        obs = self.encode(self.cfg, new_states) if encode_obs else None
        if not self.auto_reset:
            return new_states, obs, rewards, term, trunc
        with annotate("env.reset"):
            states = self.reset_batch(
                self.slab, self.num_envs, generator=self.generator,
                done=term | trunc, states=new_states,
            )
        return states, obs, rewards, term, trunc

    def rollout(
        self,
        states,
        num_steps: int,
        policy: Callable | None = None,
        run_return: torch.Tensor | None = None,
        num_actions: int | None = None,
        actions_shape: tuple[int, ...] | None = None,
    ):
        """Run ``num_steps`` lockstep steps.

        ``policy(generator, states) -> actions`` chooses each step's actions
        (it is handed the env's generator); without one they are uniform
        over ``num_actions`` ids (default the env's) in one env's
        ``actions_shape`` (default ``actions_shape[1:]``), as JAX's rollout
        draws them.

        Returns (final_states, metrics), with the per-episode accounting
        kept exact across the auto-reset:

        - ``reward_sum``: scalar, all rewards in this call.
        - ``episodes``: scalar int, episodes completed in this call.
        - ``ep_return_sum``: scalar, summed team returns of those episodes.
        - ``run_return``: (num_envs,) return of each episode in progress;
          pass it back on the next call so episodes spanning calls stay
          exact.

        The metrics stay on the device: nothing in the loop waits for it.
        The obs of each step is not computed, since nothing reads it.
        """
        B, dev = self.num_envs, self.device
        num_actions = self.num_actions if num_actions is None else num_actions
        shape = self.actions_shape if actions_shape is None else (B, *actions_shape)
        if run_return is None:
            run_return = torch.zeros((B,), dtype=torch.float32, device=dev)
        ret_sum = torch.zeros((), dtype=torch.float32, device=dev)
        ep_count = torch.zeros((), dtype=torch.int32, device=dev)
        ep_ret_sum = torch.zeros((), dtype=torch.float32, device=dev)
        run_ret = run_return
        for _ in range(num_steps):
            if policy is None:
                actions = torch.randint(
                    0, num_actions, shape, generator=self.generator, device=dev,
                    dtype=torch.int32,
                )
            else:
                actions = policy(self.generator, states)
            states, _, rewards, term, trunc = self._step(
                states, actions, encode_obs=False
            )
            done = term | trunc
            # Per-agent rewards sum into the team return; a per-env
            # reward is the team's already.
            team = rewards.sum(dim=1) if rewards.ndim > 1 else rewards
            run_ret = run_ret + team
            ret_sum = ret_sum + rewards.sum()
            ep_count = ep_count + done.sum(dtype=torch.int32)
            ep_ret_sum = ep_ret_sum + torch.where(done, run_ret, 0.0).sum()
            run_ret = torch.where(done, 0.0, run_ret)
        return states, {
            "reward_sum": ret_sum,
            "episodes": ep_count,
            "ep_return_sum": ep_ret_sum,
            "run_return": run_ret,
        }


def _encoder(encode, make_partial_encode, cfg, partial_obs_view):
    """The batch's ``encode(cfg, states)``: the family's configured
    observation, or with ``partial_obs_view=V`` each agent's field of view,
    (B, agents, V, V, 3) uint8 (JAX's ``_swap_obs``: ``step`` returns it
    for the post-step, pre-reset states).  Either runs inside the span
    ``env.encode``, which every caller of ``env.encode`` then carries."""
    if partial_obs_view is not None:
        encode_partial = make_partial_encode(cfg, partial_obs_view)

        def encode(_cfg, states):
            return encode_partial(states)

    def spanned(cfg, states):
        with annotate("env.encode"):
            return encode(cfg, states)

    return spanned


def make_collect_batch(
    cfg: collect.CollectConfig,
    num_envs: int,
    device: str | torch.device | None = None,
    auto_reset: bool = True,
    partial_obs_view: int | None = None,
) -> BatchedEnv:
    """A batch of ``num_envs`` Collect envs on ``device``.

    The default device is the current CUDA device; with no CUDA device and
    no explicit ``device`` this raises.  ``device="cpu"`` runs the plain
    PyTorch versions of the kernels.  Actions are (num_envs, num_agents)
    ids 0..3.  The kernels take one or two agents; more step and reset
    through the plain any-agent functions on ``device``, as JAX runs
    ``vmap(step_one)`` there (``ops/collect_slab.py``).

    ``auto_reset=False`` leaves finished envs as they are.
    ``partial_obs_view=V`` swaps the full-grid encode for each agent's
    field of view (``make_collect_partial_encode``): obs (num_envs, A, V,
    V, 3) uint8; the other families' ``partial_obs_view`` is the same."""
    device = _build.default_device(device, "make_collect_batch")
    return BatchedEnv(
        slab=collect_slab.make_collect_slab(cfg, device),
        num_envs=num_envs,
        generator=torch.Generator(device=device),
        step_batch=collect_slab.step_batch,
        reset_batch=collect_slab.reset_batch,
        encode=_encoder(collect.encode, collect.make_collect_partial_encode, cfg,
                        partial_obs_view),
        num_actions=len(COLLECT_ACTION_TO_VEC),
        action_cols=cfg.num_agents,
        auto_reset=auto_reset,
    )


def make_ctf_batch(
    cfg: ctf.CtfConfig,
    num_envs: int,
    device: str | torch.device | None = None,
    auto_reset: bool = True,
    partial_obs_view: int | None = None,
) -> BatchedEnv:
    """A batch of ``num_envs`` CtF envs with the scripted red policies in
    the step, on ``device`` (default and CPU as for
    :func:`make_collect_batch`).  Actions are the blue team's,
    (num_envs, num_blue_agents) ids 0..4; rewards are (num_envs,) team
    rewards."""
    device = _build.default_device(device, "make_ctf_batch")
    return BatchedEnv(
        slab=ctf_slab.make_ctf_slab(cfg, device),
        num_envs=num_envs,
        generator=torch.Generator(device=device),
        step_batch=functools.partial(ctf_slab.step_batch, with_info=False),
        reset_batch=ctf_slab.reset_batch,
        encode=_encoder(ctf.encode, ctf.make_ctf_partial_encode, cfg, partial_obs_view),
        num_actions=ctf.NUM_ACTIONS,
        action_cols=cfg.num_blue_agents,
        auto_reset=auto_reset,
    )


def make_maze_batch(
    cfg: maze.MazeConfig,
    num_envs: int,
    device: str | torch.device | None = None,
    auto_reset: bool = True,
    partial_obs_view: int | None = None,
) -> BatchedEnv:
    """A batch of ``num_envs`` Maze envs on ``device`` (default and CPU as
    for :func:`make_collect_batch`).  Actions are (num_envs,) ids 0..4, one
    per env with no agent axis; rewards are (num_envs,)."""
    device = _build.default_device(device, "make_maze_batch")
    return BatchedEnv(
        slab=maze_slab.make_maze_slab(cfg, device),
        num_envs=num_envs,
        generator=torch.Generator(device=device),
        step_batch=functools.partial(maze_slab.step_batch, with_info=False),
        reset_batch=maze_slab.reset_batch,
        encode=_encoder(maze.encode, maze.make_maze_partial_encode, cfg, partial_obs_view),
        num_actions=maze.NUM_ACTIONS,
        action_cols=None,
        auto_reset=auto_reset,
    )


def make_wildfire_batch(
    cfg: wildfire.WildfireConfig,
    num_envs: int,
    device: str | torch.device | None = None,
    auto_reset: bool = True,
    partial_obs_view: int | None = None,
) -> BatchedEnv:
    """A batch of ``num_envs`` Wildfire envs on ``device`` (default and CPU
    as for :func:`make_collect_batch`).  Actions are (num_envs, num_agents)
    ids 0..4; rewards are (num_envs, num_agents), the team reward split
    evenly.  On the kernel route with the full observation, ``step`` is
    ``wildfire_slab.step_reset``: the step kernel and one auto-reset
    kernel (the plain versions on the CPU); otherwise it is the family's
    step, encode and masked reset, as for the other families."""
    device = _build.default_device(device, "make_wildfire_batch")
    slab = wildfire_slab.make_wildfire_slab(cfg, device)
    glue = (functools.partial(wildfire_slab.step_batch, with_info=False),
            _encoder(wildfire.encode, wildfire.make_wildfire_partial_encode, cfg,
                     partial_obs_view),
            wildfire_slab.reset_batch)
    fused = slab.kernel and partial_obs_view is None
    return BatchedEnv(
        slab=slab,
        num_envs=num_envs,
        generator=torch.Generator(device=device),
        step_batch=glue[0],
        reset_batch=glue[2],
        encode=glue[1],
        num_actions=wildfire.NUM_ACTIONS,
        action_cols=cfg.num_agents,
        auto_reset=auto_reset,
        step_reset=StepReset(wildfire_slab.step_reset, glue) if fused else None,
    )


# ---------------------------------------------------------------------------
# Gymnasium's NEXT_STEP autoreset
# ---------------------------------------------------------------------------


def _rows(mask, x):
    """``mask`` (B,) shaped to broadcast over the rows of ``x``."""
    return mask.reshape(mask.shape + (1,) * (x.ndim - 1))


def _select_rows(mask, a, b):
    """The batch state with ``a``'s rows where ``mask`` is True and
    ``b``'s elsewhere, in new tensors."""
    return type(a)(**{
        f.name: torch.where(_rows(mask, getattr(a, f.name)), getattr(a, f.name),
                            getattr(b, f.name))
        for f in fields(a)
    })


def next_step_autoreset(env: BatchedEnv, states, actions, mask):
    """One step of ``env`` under gymnasium's NEXT_STEP autoreset (JAX's
    ``JaxVectorEnv._step``).

    The rows where ``mask`` (B,) bool is True finished on the previous
    call and were reset then: their action is ignored, and they keep their
    states and report ``encode`` of them with reward 0 and no done flag.
    Every other row steps as ``env.step`` steps it, with the same draws
    from ``env.generator``, and is reset when it finishes; its obs is that
    of the post-step, pre-reset state.  One launch of the family's step
    kernel on a CUDA device (and of Collect's masked reset kernel).

    ``states`` is not written: the step returns new tensors, and the
    finished rows are reset in the selected states, which are new tensors
    too (Collect's reset writes in place).  Returns (states', obs, rewards,
    terminated, truncated); the next call's ``mask`` is ``terminated |
    truncated``."""
    actions = torch.as_tensor(actions, device=env.device)
    if tuple(actions.shape) != env.actions_shape:
        raise ValueError(
            f"actions must have shape {env.actions_shape}, got {tuple(actions.shape)}"
        )
    new_states, _, rewards, term, trunc, _ = env.step_batch(
        env.slab, states, actions, generator=env.generator, encode_obs=False,
    )
    shown = _select_rows(mask, states, new_states)
    obs = env.encode(env.cfg, shown)
    rewards = torch.where(_rows(mask, rewards), 0.0, rewards)
    term, trunc = term & ~mask, trunc & ~mask
    states = env.reset_batch(
        env.slab, env.num_envs, generator=env.generator, done=term | trunc, states=shown,
    )
    return states, obs, rewards, term, trunc


def _to_host(device: torch.device, tensors):
    """numpy copies of ``tensors``: one copy each, queued together, and one
    wait for the device."""
    out = [x.to("cpu", non_blocking=True) for x in tensors]
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    return [x.numpy() for x in out]


class NextStepEnv:
    """A :class:`BatchedEnv` driven from the host under the NEXT_STEP
    autoreset: numpy actions in; numpy obs, float64 rewards and bool flags
    out.  The states and the autoreset mask stay on the device; a step is
    :func:`next_step_autoreset` and one copy of its results to the host.
    The generator starts at seed 0, so a first ``reset()`` is
    ``reset(seed=0)``."""

    def __init__(self, env: BatchedEnv):
        self.env = env
        self.num_envs = env.num_envs
        self.states = None
        self.autoreset = None
        env.generator.manual_seed(0)

    def _host_obs(self, obs, *rest):
        """(obs, *rest) on the host; a dict obs stays a dict."""
        keys = sorted(obs) if isinstance(obs, dict) else None
        parts = [obs[k] for k in keys] if keys else [obs]
        host = _to_host(self.env.device, parts + list(rest))
        obs = dict(zip(keys, host[: len(keys)])) if keys else host[0]
        return obs, host[len(parts):]

    def reset(self, seed: int | None = None):
        """Reset every env (the generator reseeded when ``seed`` is given);
        returns the obs."""
        env = self.env
        if seed is not None:
            env.generator.manual_seed(seed)
        self.states = env.reset_batch(env.slab, env.num_envs, generator=env.generator)
        self.autoreset = torch.zeros((env.num_envs,), dtype=torch.bool, device=env.device)
        return self._host_obs(env.encode(env.cfg, self.states))[0]

    def step(self, actions):
        """(obs, rewards, terminated, truncated) of one step; ``actions``
        of one env each, or all of them flat."""
        env = self.env
        actions = np.asarray(actions)
        if actions.ndim == 1 and env.action_cols is not None:
            actions = actions.reshape(env.actions_shape)
        self.states, obs, rewards, term, trunc = next_step_autoreset(
            env, self.states, actions, self.autoreset)
        self.autoreset = term | trunc
        obs, (rewards, term, trunc) = self._host_obs(obs, rewards, term, trunc)
        return obs, rewards.astype(np.float64), term, trunc


_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_vector_batch(family: str, num_envs: int, device=None, **cfg_kwargs) -> BatchedEnv:
    """The batch of ``make_vector_env`` (``adapters/vector_adapter.py``):
    each family's config with that function's defaults, ``cfg_kwargs``
    overriding them.  Collect: the quadrants-respawn config at 50 steps;
    CtF: 2 blue against 2 ``rw`` reds on ``tests/assets/board.txt``, MvN,
    flattened obs; Maze: ``tests/assets/board_maze.txt``; Wildfire: the
    default config.  ``map_path`` picks another CtF or Maze map.  Device
    as for :func:`make_collect_batch`."""
    if family == "collect":
        cfg_kwargs.setdefault("layout", "quadrants_respawn")
        cfg_kwargs.setdefault("respawn", True)
        cfg_kwargs.setdefault("max_steps", 50)
        return make_collect_batch(collect.CollectConfig(**cfg_kwargs), num_envs, device)
    if family == "ctf":
        map_path = cfg_kwargs.pop("map_path", os.path.join(_REPO_ROOT, "tests/assets/board.txt"))
        cfg_kwargs.setdefault("num_blue_agents", 2)
        cfg_kwargs.setdefault("num_red_agents", 2)
        cfg_kwargs.setdefault("variant", "mvn")
        cfg_kwargs.setdefault(
            "enemy_policies",
            tuple(ctf.PolicySpec("rw") for _ in range(cfg_kwargs["num_red_agents"])),
        )
        cfg_kwargs.setdefault("observation_option", "flattened")
        return make_ctf_batch(ctf.CtfConfig.from_map_path(map_path, **cfg_kwargs), num_envs,
                              device)
    if family == "maze":
        map_path = cfg_kwargs.pop(
            "map_path", os.path.join(_REPO_ROOT, "tests/assets/board_maze.txt"))
        return make_maze_batch(maze.MazeConfig.from_map_path(map_path, **cfg_kwargs), num_envs,
                               device)
    if family == "wildfire":
        return make_wildfire_batch(wildfire.WildfireConfig(**cfg_kwargs), num_envs, device)
    raise ValueError(f"unknown family {family!r}")
