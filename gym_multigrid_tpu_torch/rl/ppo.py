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

With a mesh (``parallel/mesh.py``) W processes train one policy under
data parallelism: each rank steps ``num_envs / W`` envs and holds their
shuffle blocks, ``DistributedDataParallel`` averages the gradients before
the clip, the advantages of a minibatch are normalised by the statistics
of the whole minibatch, and the metrics are those of the whole batch.

Not ported, as TPU workarounds: the packed (n, A + 3) scalar row of the
minibatch gather (five gathers are the same math) and the remote-dispatch
scan over iterations.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from gym_multigrid_tpu_torch.parallel.mesh import fold_in_axis
from gym_multigrid_tpu_torch.parallel.shard import local_batch, psum_scalars
from gym_multigrid_tpu_torch.rl.networks import sample_actions
from gym_multigrid_tpu_torch.utils.profiling import annotate

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
    # ``shuffle_blocks`` blocks of envs, and every minibatch takes an equal
    # share of each block.  This changes which minibatches are drawn, not
    # their marginals; blocks must be a multiple of dp_shards and of a
    # mesh's world size W, and default to the least such number
    # (dp_shards without a mesh).
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


def _ddp(net: torch.nn.Module, mesh) -> torch.nn.Module:
    """``net`` under ``DistributedDataParallel`` on ``mesh``: its backward
    averages the gradients over the ranks, and no forward broadcasts
    buffers (``broadcast_buffers=False``)."""
    with warnings.catch_warnings():
        # Newer torch deprecates broadcast_buffers for forward_sync_buffers,
        # whose False still broadcasts at construction; the learner's nets
        # hold no buffers either way.
        warnings.simplefilter("ignore", FutureWarning)
        return torch.nn.parallel.DistributedDataParallel(
            net, device_ids=[mesh.device] if mesh.device.type == "cuda" else None,
            process_group=mesh.group, broadcast_buffers=False,
        )


def _episode_stats(ep_sum: torch.Tensor, ep_cnt: torch.Tensor) -> dict:
    return {"episodes": ep_cnt, "ep_return_mean": ep_sum / ep_cnt.clamp(min=1)}


def _global_metrics(epoch_metrics: dict, traj: Transition, returns: torch.Tensor,
                    episodes, mesh) -> dict:
    """The whole batch's metrics from this rank's, in ONE all-reduce.  Every
    rank holds as many rows, so a mean over the batch (each loss term of a
    minibatch, ``reward_per_step``) is the mean of the ranks' means; the two
    variances of ``explained_variance`` combine from each rank's sum and
    centred sum of squares (float64); episode counts and returns add."""
    W = mesh.world_size

    def moments(x):  # (sum, centred sum of squares + sum**2 / n): both add over ranks
        x = x.double()
        total = x.sum()
        return total, ((x - total / x.numel()) ** 2).sum() + total * total / x.numel()

    local = dict(epoch_metrics, reward_per_step=traj.reward.mean())
    local["ret_s"], local["ret_q"] = moments(returns)
    local["res_s"], local["res_q"] = moments(returns - traj.value)
    if episodes is not None:
        local["ep_sum"], local["ep_cnt"] = episodes
    g = psum_scalars(local, mesh)
    n = returns.numel() * W

    def var(s, q):
        return (q - s * s / n) / n

    metrics = {k: g[k] / W for k in (*epoch_metrics, "reward_per_step")}
    metrics["explained_variance"] = (
        1.0 - var(g["res_s"], g["res_q"]) / (var(g["ret_s"], g["ret_q"]) + 1e-8)
    ).to(torch.float32)
    if episodes is not None:
        metrics.update(_episode_stats(g["ep_sum"], g["ep_cnt"]))
    return metrics


def make_update_fn(net: torch.nn.Module, optimizer: torch.optim.Optimizer, cfg: PPOConfig,
                   mesh=None):
    """The PPO update: ``update(traj, last_value, generator, episodes=None)
    -> metrics``.

    GAE, then per epoch a fresh shuffle of the (T * B) buffer split into
    ``num_minibatches`` minibatches, one clipped gradient step each (SB3's
    update), on ``net``'s parameters through ``optimizer``.  Metrics are
    0-d tensors: each loss term the mean over an epoch's minibatches, of
    the last epoch; ``reward_per_step``; ``explained_variance`` of the
    pre-update critic; with ``episodes=(ep_sum, ep_cnt)`` (a rollout's
    summed episode returns and count), ``episodes`` and ``ep_return_mean``.

    With a ``mesh`` of W ranks, ``traj`` holds this rank's B envs, S / W of
    the S shuffle blocks (S is W unless the config asks for more), and the
    W ranks together compute the update of one process over the
    concatenated buffer: the forward and backward run
    under ``DistributedDataParallel``, which averages the gradients before
    the clip, so every rank clips and steps alike; a minibatch's advantages
    are normalised by the whole minibatch's mean and standard deviation
    (two scalar all-reduces); the metrics are the whole batch's (one
    all-reduce).  Each rank draws the whole (S, T * B * W / S) shuffle
    matrix and keeps its own blocks' rows, so generators seeded alike give
    the shuffle of one process."""
    params = [p for p in net.parameters()]
    model = net if mesh is None else _ddp(net, mesh)
    W, rank = (1, 0) if mesh is None else (mesh.world_size, mesh.rank)

    def normalise(advantages):
        """Per-minibatch advantage normalisation (SB3), population std."""
        if mesh is None:
            return (advantages - advantages.mean()) / (advantages.std(correction=0) + 1e-8)
        # Every rank holds as many rows: the minibatch's mean is the mean of
        # the ranks' means, its variance the mean of each rank's mean square
        # deviation about that mean (one all-reduce each).  At world size 1
        # both are the plain expression's bit for bit (sqrt(s * s) == s in
        # binary floating point).
        local_mean, local_std = advantages.mean(), advantages.std(correction=0)
        mean = local_mean.clone()
        dist.all_reduce(mean, group=mesh.group)
        mean = mean / W
        spread = local_std.square() + (local_mean - mean).square()
        dist.all_reduce(spread, group=mesh.group)
        return (advantages - mean) / (torch.sqrt(spread / W) + 1e-8)

    def loss_fn(obs, actions, old_logp, advantages, returns):
        logits, value = model(obs)
        lse = torch.logsumexp(logits, dim=-1)
        chosen = logits.gather(-1, actions[..., None].long())[..., 0]
        logp = (chosen - lse).sum(dim=-1)
        ratio = torch.exp(logp - old_logp)
        adv = normalise(advantages)
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

    def update(traj: Transition, last_value: torch.Tensor, generator: torch.Generator,
               episodes=None):
        with annotate("ppo.update"):
            with torch.no_grad(), annotate("ppo.gae"):
                advantages, returns = compute_gae(traj, last_value, cfg)
            T, B = traj.reward.shape
            S = cfg.shuffle_blocks or math.lcm(cfg.dp_shards, W)
            if S % cfg.dp_shards:
                raise ValueError(
                    f"shuffle_blocks={S} must be a multiple of dp_shards={cfg.dp_shards}"
                )
            if S % W:
                raise ValueError(f"shuffle_blocks={S} must be a multiple of the world size {W}")
            S_local = S // W
            if B % S_local:
                raise ValueError(f"num_envs={B * W} not divisible by shuffle blocks={S}")
            n_local = T * (B // S_local)
            if n_local % cfg.num_minibatches:
                raise ValueError(
                    f"rollout_len*num_envs/blocks={n_local} not divisible by "
                    f"num_minibatches={cfg.num_minibatches}"
                )
            mb_local = n_local // cfg.num_minibatches
            dev = traj.reward.device

            def blocks(x):
                # (T, B, ...) -> (S_local, T*B/S_local, ...), env-major: each
                # block holds whole envs.
                x = x.movedim(1, 0)
                return x.reshape((S_local, n_local) + x.shape[2:])

            flat = [blocks(x) for x in (traj.obs, traj.actions, traj.logp, advantages, returns)]
            rows = torch.arange(S_local, device=dev)[:, None]
            mine = slice(rank * S_local, (rank + 1) * S_local)
            epoch_metrics = None
            for _ in range(cfg.num_epochs):
                perm = torch.rand((S, n_local), generator=generator, device=dev)[mine]
                perm = perm.argsort(dim=1)
                idxs = perm.reshape(S_local, cfg.num_minibatches, mb_local).transpose(0, 1)
                per_mb = []
                for idx in idxs:  # (S_local, mb_local): block s takes its own rows
                    with annotate("ppo.minibatch"):
                        mb = [x[rows, idx].reshape((S_local * mb_local,) + x.shape[2:])
                              for x in flat]
                        with annotate("ppo.loss"):
                            loss, metrics = loss_fn(*mb)
                        optimizer.zero_grad(set_to_none=True)
                        with annotate("ppo.backward"):
                            loss.backward()
                        with annotate("ppo.clip"):
                            _clip_by_global_norm_(params, cfg.max_grad_norm)
                        optimizer.step()
                        per_mb.append(metrics)
                epoch_metrics = {k: torch.stack([m[k] for m in per_mb]).mean() for k in per_mb[0]}
            if mesh is not None:
                return _global_metrics(epoch_metrics, traj, returns, episodes, mesh)
            metrics = dict(epoch_metrics)
            metrics["reward_per_step"] = traj.reward.mean()
            ret_var = returns.var(correction=0)
            res_var = (returns - traj.value).var(correction=0)
            metrics["explained_variance"] = 1.0 - res_var / (ret_var + 1e-8)
            if episodes is not None:
                metrics.update(_episode_stats(*episodes))
            return metrics

    return update


def make_ppo(env, net: torch.nn.Module, cfg: PPOConfig, mesh=None):
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
    ``env.actions_shape`` (Maze takes (B,), the net emits (B, 1)).

    With a ``mesh`` (``parallel/mesh.py``) of W ranks, ``env`` describes
    the whole batch and this rank steps ``num_envs / W`` of its envs
    (``train_step.env``), reset from ``fold_in_axis`` of the env seed; the
    net starts alike on every rank; ``generator`` should be the rank's own
    (seeded from ``fold_in_axis``); the update is :func:`make_update_fn`'s
    under the mesh, and the metrics are the whole batch's.  The rollout's
    forwards call ``net`` itself, not the data-parallel wrapper, so they
    issue no collective; ``train_step.rollout`` gives the rank's own
    episode statistics."""
    if mesh is not None:
        env = local_batch(env, mesh)
    net.to(env.device)
    optimizer = make_optimizer(net, cfg)
    store_obs = make_obs_store(cfg)
    update = make_update_fn(net, optimizer, cfg, mesh)
    B, dev = env.num_envs, env.device

    def init_fn(seed: int):
        env_seed, net_seed = (int(s) for s in np.random.SeedSequence(seed).generate_state(2))
        net.reset_parameters(torch.Generator().manual_seed(net_seed))
        optimizer.state.clear()
        states, _ = env.reset(env_seed if mesh is None else fold_in_axis(env_seed, mesh))
        return optimizer, RolloutCarry(states, torch.zeros((B,), dtype=torch.float32, device=dev))

    def collect(carry: RolloutCarry, generator: torch.Generator):
        """The rollout: (carry, traj, last value, summed episode returns,
        episode count)."""
        with annotate("ppo.rollout"):
            states, run_ret = carry
            ep_sum = torch.zeros((), dtype=torch.float32, device=dev)
            ep_cnt = torch.zeros((), dtype=torch.int32, device=dev)
            obs = env.encode(env.cfg, states)
            with torch.no_grad(), annotate("ppo.forward"):
                logits, value = net(obs)
            steps = []
            for _ in range(cfg.rollout_len):
                with annotate("ppo.rollout.step"):
                    with annotate("ppo.sample"):
                        actions, logp = sample_actions(logits, generator)
                    states, step_obs, rewards, term, trunc = env.step(
                        states, actions.reshape(env.actions_shape)
                    )
                    team = rewards.sum(dim=1) if rewards.ndim > 1 else rewards
                    # Episode returns across the auto-reset, as
                    # BatchedEnv.rollout keeps them.
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
                    with torch.no_grad(), annotate("ppo.forward"):
                        logits_2, value_2 = net(torch.cat([next_obs, step_obs]))
                    steps.append(Transition(
                        obs=store_obs(obs), actions=actions, logp=logp, value=value,
                        reward=team.to(torch.float32), terminated=term.to(torch.float32),
                        truncated=trunc.to(torch.float32), boot_value=value_2[B:],
                    ))
                    obs, logits, value = next_obs, logits_2[:B], value_2[:B]
            traj = Transition(*(torch.stack(xs) for xs in zip(*steps)))
            return RolloutCarry(states, run_ret), traj, value, ep_sum, ep_cnt

    def rollout(carry: RolloutCarry, generator: torch.Generator):
        carry, traj, last_value, ep_sum, ep_cnt = collect(carry, generator)
        return carry, traj, last_value, _episode_stats(ep_sum, ep_cnt)

    def train_step(carry: RolloutCarry, generator: torch.Generator):
        carry, traj, last_value, ep_sum, ep_cnt = collect(carry, generator)
        return carry, update(traj, last_value, generator, episodes=(ep_sum, ep_cnt))

    # Its two halves, for callers that time them apart:
    # rollout(carry, generator) -> (carry, traj, last_value, ep_stats) and
    # update(traj, last_value, generator) -> metrics; and the batch it steps.
    train_step.rollout, train_step.update, train_step.env = rollout, update, env
    return init_fn, train_step
