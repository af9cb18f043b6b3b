"""Batched lockstep Collect envs with auto-reset (PyTorch port).

Counterpart of ``BatchedEnv`` and ``make_collect_batch`` in
``gym_multigrid_tpu/parallel/vector.py``.  The batch runs in lockstep on
one device; every step and reset of the whole batch is one kernel launch
on a CUDA device (``ops/collect_slab.py``).  Finished envs are reset in
place by the reset kernel under a ``done`` mask, so neither ``step`` nor
``rollout`` waits on the device inside its loop.  Randomness comes from
the env's ``torch.Generator``, seeded by ``reset(seed)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from gym_multigrid_tpu_torch.envs.collect import (
    CollectConfig,
    CollectState,
    encode,
)
from gym_multigrid_tpu_torch.ops.collect_slab import (
    CollectSlab,
    make_collect_slab,
    reset_batch,
    step_batch,
)

#: Collect's action space: north, east, south, west.
NUM_ACTIONS = 4


@dataclass(frozen=True, eq=False)
class BatchedEnv:
    """Batched Collect env with auto-reset.

    reset(seed) -> (states, obs)
    step(states, actions) -> (states', obs, rewards, terminated, truncated)

    ``step`` applies the transition to every env, then resets the envs that
    finished; the obs and rewards it returns are the *pre-reset* ones
    (gymnasium's autoreset convention: the final step is visible, and the
    next step starts from the reset state).
    """

    slab: CollectSlab
    num_envs: int
    generator: torch.Generator

    @property
    def cfg(self) -> CollectConfig:
        return self.slab.cfg

    @property
    def device(self) -> torch.device:
        return self.slab.device

    def reset(self, seed: int):
        """Seed the env's generator and reset every env."""
        self.generator.manual_seed(seed)
        states = reset_batch(self.slab, self.num_envs, generator=self.generator)
        return states, encode(self.cfg, states)

    def step(self, states: CollectState, actions):
        actions = torch.as_tensor(actions, device=self.device)
        if tuple(actions.shape) != (self.num_envs, self.cfg.num_agents):
            raise ValueError(
                f"actions must have shape ({self.num_envs}, "
                f"{self.cfg.num_agents}), got {tuple(actions.shape)}"
            )
        return self._step(states, actions, encode_obs=True)

    def _step(self, states, actions, encode_obs):
        new_states, obs, rewards, term, trunc, _ = step_batch(
            self.slab, states, actions, generator=self.generator,
            encode_obs=encode_obs,
        )
        reset_batch(
            self.slab, self.num_envs, generator=self.generator,
            done=term | trunc, states=new_states,
        )
        return new_states, obs, rewards, term, trunc

    def rollout(
        self,
        states: CollectState,
        num_steps: int,
        run_return: torch.Tensor | None = None,
    ):
        """Run ``num_steps`` lockstep steps with uniform random actions.

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
        if run_return is None:
            run_return = torch.zeros((B,), dtype=torch.float32, device=dev)
        ret_sum = torch.zeros((), dtype=torch.float32, device=dev)
        ep_count = torch.zeros((), dtype=torch.int32, device=dev)
        ep_ret_sum = torch.zeros((), dtype=torch.float32, device=dev)
        run_ret = run_return
        for _ in range(num_steps):
            actions = torch.randint(
                0, NUM_ACTIONS, (B, self.cfg.num_agents), generator=self.generator,
                device=dev, dtype=torch.int32,
            )
            states, _, rewards, term, trunc = self._step(
                states, actions, encode_obs=False
            )
            done = term | trunc
            # Per-agent rewards sum into the team return.
            run_ret = run_ret + rewards.sum(dim=1)
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


def make_collect_batch(
    cfg: CollectConfig,
    num_envs: int,
    device: str | torch.device | None = None,
) -> BatchedEnv:
    """A batch of ``num_envs`` Collect envs on ``device``.

    The default device is the current CUDA device; with no CUDA device and
    no explicit ``device`` this raises.  ``device="cpu"`` runs the plain
    PyTorch versions of the kernels."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_collect_batch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch version"
            )
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    return BatchedEnv(
        slab=make_collect_slab(cfg, device),
        num_envs=num_envs,
        generator=torch.Generator(device=device),
    )
