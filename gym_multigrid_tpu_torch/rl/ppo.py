"""PPO learner over the port's batched envs (PyTorch port).

Counterpart of ``gym_multigrid_tpu/rl/ppo.py``: the rollout of a
``BatchedEnv`` under the current policy, GAE with the truncation
bootstrap, and SB3's minibatched clipped update, with the same config,
the same math and the same diagnostics.  On a CUDA device each env step
launches the family's step kernel (``ops/*_slab.py``); the network's
products are ``torch.nn`` layers.

Randomness comes from ``torch.Generator``s: the env's own (``env.reset``
seeds it) for the env, and the learner's (passed to ``train_step``) for
the actions and the epoch shuffles.  Nothing in a train step waits for
the device: the metrics come back as 0-d device tensors.

Not ported, as TPU workarounds: the packed (n, A + 3) scalar row of the
minibatch gather (five gathers are the same math) and the remote-dispatch
scan over iterations.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from gym_multigrid_tpu_torch.rl.networks import sample_actions

__all__ = [
    "PPOConfig", "RolloutCarry", "Transition", "make_obs_store",
    "compute_gae", "make_optimizer", "make_update_fn", "make_ppo",
]


@dataclass(frozen=True)
class PPOConfig:
    """The JAX package's ``PPOConfig``: same fields, same defaults."""

    lr: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    rollout_len: int = 32
    num_epochs: int = 1
    # SB3-style minibatch SGD: each epoch shuffles the (T*B) buffer and
    # takes one clipped gradient step per minibatch.  Must divide
    # rollout_len * num_envs / shuffle blocks.
    num_minibatches: int = 1
    max_grad_norm: float = 0.5
    # Store integer observations in this narrow dtype in the rollout
    # buffer; the network casts its input before the first product either
    # way, so small-int observations train bit-identically.  None keeps
    # the env's dtype.
    obs_buffer_dtype: str | None = None
    # The epoch shuffle draws an independent permutation in each of
    # ``shuffle_blocks`` (default ``dp_shards``) blocks of envs, and every
    # minibatch takes an equal share of each block.  This changes which
    # minibatches are drawn, not their marginals; blocks must be a
    # multiple of dp_shards.
    dp_shards: int = 1
    shuffle_blocks: int | None = None


class RolloutCarry(NamedTuple):
    """Env states plus the running return of each env's episode, which
    spans train steps."""

    env: Any
    run_return: torch.Tensor  # (num_envs,) float32


class Transition(NamedTuple):
    """A rollout buffer: each field (T, B, ...)."""

    obs: torch.Tensor
    actions: torch.Tensor
    logp: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor
    # Critic value of the post-step (pre-auto-reset) observation: the
    # bootstrap target where an episode was truncated.
    boot_value: torch.Tensor


def _is_int(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex or dtype == torch.bool)


def make_obs_store(cfg: PPOConfig):
    """The rollout buffer's obs compactor for ``cfg.obs_buffer_dtype``.
    Raises now unless the dtype is integral, and at the first call unless
    the env's observations are: a float to int cast would corrupt the
    buffer."""
    obs_dtype = None
    if cfg.obs_buffer_dtype:
        np_dtype = np.dtype(cfg.obs_buffer_dtype)
        if not np.issubdtype(np_dtype, np.integer):
            raise ValueError(f"obs_buffer_dtype must be an integer dtype, got {np_dtype}")
        obs_dtype = torch.from_numpy(np.zeros(0, np_dtype)).dtype

    def store_obs(obs):
        if obs_dtype is None or obs.dtype == obs_dtype:
            return obs
        if not _is_int(obs.dtype):
            raise ValueError(
                "obs_buffer_dtype compaction needs integer observations; "
                f"this env emits {obs.dtype} (e.g. Maze's float map)"
            )
        return obs.to(obs_dtype)

    return store_obs


def compute_gae(traj: Transition, last_value: torch.Tensor, cfg: PPOConfig):
    """(advantages, returns), each (T, B): GAE backwards over the rollout.
    True terminals zero the bootstrap; truncations bootstrap from
    ``boot_value``; the accumulation never crosses an episode's end."""
    advantages = torch.empty_like(traj.reward)
    gae = torch.zeros_like(last_value)
    next_value = last_value
    for t in reversed(range(traj.reward.shape[0])):
        term, trunc = traj.terminated[t], traj.truncated[t]
        done = torch.maximum(term, trunc)
        nv = torch.where(trunc > 0, traj.boot_value[t], next_value)
        delta = traj.reward[t] + cfg.gamma * nv * (1.0 - term) - traj.value[t]
        gae = delta + cfg.gamma * cfg.gae_lambda * (1.0 - done) * gae
        advantages[t] = gae
        next_value = traj.value[t]
    return advantages, advantages + traj.value


def make_optimizer(net: torch.nn.Module, cfg: PPOConfig) -> torch.optim.Adam:
    """Adam with optax's defaults (betas 0.9/0.999, eps 1e-8 outside the
    square root, bias-corrected); the gradient clip is the update's."""
    return torch.optim.Adam(net.parameters(), lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)


def _clip_by_global_norm_(params, max_norm: float) -> None:
    """optax's ``clip_by_global_norm``: scale every gradient by
    ``max_norm / norm`` when the global norm is at least ``max_norm``
    (``clip_grad_norm_`` would add 1e-6 to the norm).  No host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for g in grads:
        g.mul_(scale)


def make_update_fn(net: torch.nn.Module, optimizer: torch.optim.Optimizer, cfg: PPOConfig):
    """The PPO update: ``update(traj, last_value, generator) -> metrics``.

    GAE, then per epoch a fresh shuffle of the (T * B) buffer split into
    ``num_minibatches`` minibatches, one clipped gradient step each (SB3's
    update), on ``net``'s parameters through ``optimizer``.  Metrics are
    0-d tensors: each loss term the mean over an epoch's minibatches, of
    the last epoch; ``reward_per_step``; ``explained_variance`` of the
    pre-update critic."""
    params = [p for p in net.parameters()]

    def loss_fn(obs, actions, old_logp, advantages, returns):
        logits, value = net(obs)
        lse = torch.logsumexp(logits, dim=-1)
        chosen = logits.gather(-1, actions[..., None].long())[..., 0]
        logp = (chosen - lse).sum(dim=-1)
        ratio = torch.exp(logp - old_logp)
        # Per-minibatch advantage normalisation (SB3), population std.
        adv = (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)
        pg1 = ratio * adv
        pg2 = ratio.clamp(1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
        pg_loss = -torch.minimum(pg1, pg2).mean()
        v_loss = 0.5 * (value - returns).square().mean()
        probs = torch.softmax(logits, dim=-1)
        entropy = (lse - (probs * logits).sum(dim=-1)).mean()
        loss = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * entropy
        with torch.no_grad():
            approx_kl = ((ratio - 1.0) - torch.log(ratio)).mean()
            clip_fraction = ((ratio - 1.0).abs() > cfg.clip_eps).float().mean()
        return loss, {
            "loss": loss.detach(), "pg_loss": pg_loss.detach(), "v_loss": v_loss.detach(),
            "entropy": entropy.detach(), "approx_kl": approx_kl,
            "clip_fraction": clip_fraction,
        }

    def update(traj: Transition, last_value: torch.Tensor, generator: torch.Generator):
        with torch.no_grad():
            advantages, returns = compute_gae(traj, last_value, cfg)
        T, B = traj.reward.shape
        S = cfg.shuffle_blocks or cfg.dp_shards
        if S % cfg.dp_shards:
            raise ValueError(
                f"shuffle_blocks={S} must be a multiple of dp_shards={cfg.dp_shards}"
            )
        if B % S:
            raise ValueError(f"num_envs={B} not divisible by shuffle blocks={S}")
        n_local = T * (B // S)
        if n_local % cfg.num_minibatches:
            raise ValueError(
                f"rollout_len*num_envs/blocks={n_local} not divisible by "
                f"num_minibatches={cfg.num_minibatches}"
            )
        mb_local = n_local // cfg.num_minibatches
        dev = traj.reward.device

        def blocks(x):
            # (T, B, ...) -> (S, T*B/S, ...), env-major: each block holds
            # whole envs.
            x = x.movedim(1, 0)
            return x.reshape((S, n_local) + x.shape[2:])

        flat = [blocks(x) for x in (traj.obs, traj.actions, traj.logp, advantages, returns)]
        rows = torch.arange(S, device=dev)[:, None]
        epoch_metrics = None
        for _ in range(cfg.num_epochs):
            perm = torch.rand((S, n_local), generator=generator, device=dev).argsort(dim=1)
            idxs = perm.reshape(S, cfg.num_minibatches, mb_local).transpose(0, 1)
            per_mb = []
            for idx in idxs:  # (S, mb_local): block s takes its own rows
                mb = [x[rows, idx].reshape((S * mb_local,) + x.shape[2:]) for x in flat]
                loss, metrics = loss_fn(*mb)
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
                _clip_by_global_norm_(params, cfg.max_grad_norm)
                optimizer.step()
                per_mb.append(metrics)
            epoch_metrics = {k: torch.stack([m[k] for m in per_mb]).mean() for k in per_mb[0]}
        metrics = dict(epoch_metrics)
        metrics["reward_per_step"] = traj.reward.mean()
        ret_var = returns.var(correction=0)
        metrics["explained_variance"] = 1.0 - (returns - traj.value).var(correction=0) / (
            ret_var + 1e-8
        )
        return metrics

    return update


def make_ppo(env, net: torch.nn.Module, cfg: PPOConfig):
    """(init_fn, train_step) for a ``BatchedEnv`` and an actor-critic.

    - ``init_fn(seed) -> (optimizer, carry)``: re-initialises ``net`` (on
      ``env.device``) as flax does, clears the optimizer and resets the
      envs, from two seeds derived from ``seed``.
    - ``train_step(carry, generator) -> (carry, metrics)``: one PPO
      iteration, the rollout of ``cfg.rollout_len`` steps then the update,
      with the actions and shuffles drawn from ``generator`` (on
      ``env.device``).

    Per-agent rewards (B, A) sum into a team reward; per-env rewards
    (CtF, Maze) are the team's.  Actions are reshaped to
    ``env.actions_shape`` (Maze takes (B,), the net emits (B, 1))."""
    net.to(env.device)
    optimizer = make_optimizer(net, cfg)
    store_obs = make_obs_store(cfg)
    update = make_update_fn(net, optimizer, cfg)
    B, dev = env.num_envs, env.device

    def init_fn(seed: int):
        env_seed, net_seed = (int(s) for s in np.random.SeedSequence(seed).generate_state(2))
        net.reset_parameters(torch.Generator().manual_seed(net_seed))
        optimizer.state.clear()
        states, _ = env.reset(env_seed)
        return optimizer, RolloutCarry(states, torch.zeros((B,), dtype=torch.float32, device=dev))

    def rollout(carry: RolloutCarry, generator: torch.Generator):
        states, run_ret = carry
        ep_sum = torch.zeros((), dtype=torch.float32, device=dev)
        ep_cnt = torch.zeros((), dtype=torch.int32, device=dev)
        obs = env.encode(env.cfg, states)
        with torch.no_grad():
            logits, value = net(obs)
        steps = []
        for _ in range(cfg.rollout_len):
            actions, logp = sample_actions(logits, generator)
            states, step_obs, rewards, term, trunc = env.step(
                states, actions.reshape(env.actions_shape)
            )
            team = rewards.sum(dim=1) if rewards.ndim > 1 else rewards
            # Episode returns across the auto-reset, as BatchedEnv.rollout
            # keeps them.
            done = term | trunc
            run_ret = run_ret + team
            ep_sum = ep_sum + torch.where(done, run_ret, 0.0).sum()
            ep_cnt = ep_cnt + done.sum(dtype=torch.int32)
            run_ret = torch.where(done, 0.0, run_ret)
            # One forward over the next step's obs (post-reset) and this
            # step's pre-reset obs, whose value is the truncation
            # bootstrap.  It runs every step: GAE reads it only where an
            # episode was truncated, and asking the device whether one was
            # would make the host wait each step.
            next_obs = env.encode(env.cfg, states)
            with torch.no_grad():
                logits_2, value_2 = net(torch.cat([next_obs, step_obs]))
            steps.append(Transition(
                obs=store_obs(obs), actions=actions, logp=logp, value=value,
                reward=team.to(torch.float32), terminated=term.to(torch.float32),
                truncated=trunc.to(torch.float32), boot_value=value_2[B:],
            ))
            obs, logits, value = next_obs, logits_2[:B], value_2[:B]
        traj = Transition(*(torch.stack(xs) for xs in zip(*steps)))
        ep_stats = {
            "episodes": ep_cnt,
            "ep_return_mean": ep_sum / ep_cnt.clamp(min=1),
        }
        return RolloutCarry(states, run_ret), traj, value, ep_stats

    def train_step(carry: RolloutCarry, generator: torch.Generator):
        carry, traj, last_value, ep_stats = rollout(carry, generator)
        metrics = update(traj, last_value, generator)
        metrics.update(ep_stats)
        return carry, metrics

    # Its two halves, for callers that time them apart:
    # rollout(carry, generator) -> (carry, traj, last_value, ep_stats) and
    # update(traj, last_value, generator) -> metrics.
    train_step.rollout, train_step.update = rollout, update
    return init_fn, train_step
