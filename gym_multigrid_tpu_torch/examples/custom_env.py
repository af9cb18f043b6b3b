"""Build your own environment on the port: a worked example.

The reference package's extension point is subclassing ``MultiGridEnv``
(the port has that route too, ``adapters/multigrid.py``).  This example
shows the route the four built-in families use instead, the one that
steps thousands of envs at once on one device:

  1. a frozen **config** dataclass: everything static about the env;
  2. a **state** dataclass of batched tensors on one device, each field
     ``(B, ...)``, with no Python objects in the hot path and no PRNG key
     (randomness comes from an explicit ``torch.Generator``);
  3. **batch functions** over the whole batch at once, ``reset_batch``,
     ``step_batch`` and ``encode``, taking a small **slab** (the config,
     the device and the constants built once) as their first argument;
  4. a **BatchedEnv** (``parallel/vector.py``) built from the slab and the
     three functions: it adds the auto-reset under a ``done`` mask and the
     rollout with exact per-episode accounting;
  5. the stock PPO learner (``rl/ppo.py``) on top, nothing else needed.

The env itself, **Pursuit**, is deliberately small: A pursuers chase one
scripted prey on a toroidal W x W grid.  The prey flees the nearest
pursuer (a scripted opponent inside the step, the pattern CtF uses for
its red team, ``ops/ctf_slab.py`` ``_red_actions``).  Pursuers are
rewarded for being adjacent to the prey; the episode ends when the prey is
cornered (2+ adjacent pursuers).

Run it (a random rollout, then 60 PPO iterations):

    python -m gym_multigrid_tpu_torch.examples.custom_env          # on the CUDA device
    python -m gym_multigrid_tpu_torch.examples.custom_env --cpu    # on the CPU

Scaling it up needs no new code: the batch functions take any ``B``, and
``parallel/shard.py`` shards a ``BatchedEnv`` over processes like the
built-in families.  The step here is plain PyTorch, a few dozen tensor
operations over the batch; if a profile ever shows it dominating, write
it as one kernel and keep the plain function beside it as its reference,
as ``ops/*_slab.py`` do for the built-in families.
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, fields

import torch

from gym_multigrid_tpu_torch.ops import _build
from gym_multigrid_tpu_torch.parallel.vector import BatchedEnv

# stay / west / south / east / north: the same action vocabulary as CtF
# (reference agent.py:54-67), so the action space is familiar to
# reference users.
ACTION_VEC = ((0, 0), (0, -1), (-1, 0), (0, 1), (1, 0))
NUM_ACTIONS = len(ACTION_VEC)
#: ``main``'s sizes: envs, random-rollout steps, PPO iterations.
ENVS, RANDOM_STEPS, ITERS = 256, 120, 60


@dataclass(frozen=True)
class PursuitConfig:
    size: int = 9
    num_agents: int = 3
    max_steps: int = 60
    tag_reward: float = 0.25
    corner_reward: float = 1.0
    step_penalty: float = 0.01


@dataclass
class PursuitState:
    pursuers: torch.Tensor  # (B, A, 2) int32 (row, col)
    prey: torch.Tensor  # (B, 2) int32
    step_count: torch.Tensor  # (B,) int32


@dataclass(frozen=True, eq=False)
class PursuitSlab:
    """What the batch functions read besides the states: the config, the
    device, and the action vectors as a tensor on it.  ``BatchedEnv``
    reads ``slab.cfg`` and ``slab.device``."""

    cfg: PursuitConfig
    device: torch.device
    action_vec: torch.Tensor  # (5, 2) int32


def make_pursuit(cfg: PursuitConfig, device=None) -> PursuitSlab:
    """The slab of ``cfg`` on ``device``: the current CUDA device by
    default (this raises without one), ``device="cpu"`` for the CPU.  JAX
    closes its functions over the config; the port's batch functions take
    the slab as their first argument."""
    device = _build.default_device(device, "make_pursuit")
    vec = torch.tensor(ACTION_VEC, dtype=torch.int32, device=device)
    return PursuitSlab(cfg=cfg, device=device, action_vec=vec)


def _torus_delta(a, b, W: int):
    """Signed shortest displacement a -> b on the torus, per axis."""
    return (b - a + W // 2) % W - W // 2


def reset_batch(slab: PursuitSlab, num_envs: int, *, generator=None, done=None, states=None):
    """Fresh states: A + 1 distinct cells uniformly at random, pursuers
    first, then the prey, taken as the first A + 1 of an ``argsort`` of
    uniform keys over the board (rejection-free placement; the reference
    rejection-samples, multigrid.py:282-339).  With ``done`` (B,) bool,
    ``states`` with the rows where it is True reset, in new tensors."""
    cfg = slab.cfg
    W, A = cfg.size, cfg.num_agents
    keys = torch.rand((num_envs, W * W), generator=generator, device=slab.device)
    cells = keys.argsort(dim=1)[:, : A + 1].to(torch.int32)
    pos = torch.stack([cells // W, cells % W], dim=2)
    fresh = PursuitState(
        pursuers=pos[:, :A].contiguous(),
        prey=pos[:, A].contiguous(),
        step_count=torch.zeros((num_envs,), dtype=torch.int32, device=slab.device),
    )
    if done is None:
        return fresh

    def pick(new, old):
        return torch.where(done.reshape(done.shape + (1,) * (new.ndim - 1)), new, old)

    return PursuitState(**{f.name: pick(getattr(fresh, f.name), getattr(states, f.name))
                           for f in fields(fresh)})


def prey_actions(slab: PursuitSlab, states: PursuitState) -> torch.Tensor:
    """(B,) the scripted prey's action: flee the nearest pursuer, taking
    the move that maximises the new toroidal L1 distance to it.  Ties go
    to the lowest index, in ``argmin`` and ``argmax`` alike."""
    W = slab.cfg.size
    dist = _torus_delta(states.prey[:, None, :], states.pursuers, W).abs().sum(dim=2)
    nearest = states.pursuers.gather(
        1, dist.argmin(dim=1)[:, None, None].expand(-1, 1, 2))  # (B, 1, 2)
    cand = (states.prey[:, None, :] + slab.action_vec) % W  # (B, 5, 2)
    return _torus_delta(cand, nearest, W).abs().sum(dim=2).argmax(dim=1)


def step_batch(slab: PursuitSlab, states: PursuitState, actions, *, generator=None,
               encode_obs=True):
    """One step of every env: (states', obs, rewards (B, A) float32,
    terminated (B,), truncated (B,), info).  The step draws nothing (the
    prey is scripted), so ``generator`` is unused; ``encode_obs=False``
    returns None for the obs."""
    cfg, W = slab.cfg, slab.cfg.size
    acts = actions.to(torch.int64).clamp(0, NUM_ACTIONS - 1)
    pursuers = (states.pursuers + slab.action_vec[acts]) % W
    prey = (states.prey + slab.action_vec[prey_actions(slab, states)]) % W

    adjacent = _torus_delta(pursuers, prey[:, None, :], W).abs().sum(dim=2) == 1  # (B, A)
    cornered = adjacent.sum(dim=1) >= 2
    adj = adjacent.to(torch.float32)
    # Per-agent rewards, like Collect: BatchedEnv and PPO sum them into a
    # team reward.
    rewards = (cfg.tag_reward * adj + (cfg.corner_reward * cornered)[:, None] * adj
               - cfg.step_penalty)
    step_count = states.step_count + 1
    terminated = cornered
    truncated = (step_count >= cfg.max_steps) & ~terminated
    new_states = PursuitState(pursuers=pursuers, prey=prey, step_count=step_count)
    obs = encode(cfg, new_states) if encode_obs else None
    return new_states, obs, rewards, terminated, truncated, {}


def encode(cfg: PursuitConfig, states: PursuitState) -> torch.Tensor:
    """Flat normalised positions, the "flattened" observation style (CtF's
    ``observation_option="flattened"``): (B, (A + 1) * 2) float32."""
    B = states.prey.shape[0]
    flat = torch.cat([states.pursuers.reshape(B, -1), states.prey], dim=1)
    return flat.to(torch.float32) / (cfg.size - 1)


def make_pursuit_batch(cfg: PursuitConfig, num_envs: int, device=None) -> BatchedEnv:
    """A ``BatchedEnv`` of ``num_envs`` Pursuit envs on ``device`` (the
    current CUDA device by default, ``device="cpu"`` for the CPU).
    Actions are (num_envs, num_agents) ids 0..4."""
    slab = make_pursuit(cfg, device)
    return BatchedEnv(
        slab=slab,
        num_envs=num_envs,
        generator=torch.Generator(device=slab.device),
        step_batch=step_batch,
        reset_batch=reset_batch,
        encode=encode,
        num_actions=NUM_ACTIONS,
        action_cols=cfg.num_agents,
    )


def main(argv=None) -> dict:
    """A random rollout, then PPO on the same batch.  Returns the
    readings: the random policy's episodes and mean return, the PPO
    run's loss per iteration, its final mean return and iterations per
    second (host wall, ending with the read of the last return)."""
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true", help="run on the CPU, not the CUDA device")
    args = p.parse_args(argv)
    cfg = PursuitConfig()
    env = make_pursuit_batch(cfg, num_envs=ENVS, device="cpu" if args.cpu else None)

    # 1. Random rollout through the stock loop (auto-reset and episode
    #    metrics come for free).
    states, obs = env.reset(seed=0)
    states, metrics = env.rollout(states, RANDOM_STEPS)
    episodes = int(metrics["episodes"])
    random_ret = float(metrics["ep_return_sum"]) / max(1, episodes)
    print(f"random policy: {episodes} episodes, mean return {random_ret:+.3f}")

    # 2. The stock PPO learner on the custom env, unchanged.
    from gym_multigrid_tpu_torch.rl.networks import ActorCritic
    from gym_multigrid_tpu_torch.rl.ppo import PPOConfig, make_ppo

    net = ActorCritic(NUM_ACTIONS, cfg.num_agents, obs_shape=tuple(obs.shape[1:]))
    init_fn, train_step = make_ppo(env, net, PPOConfig(rollout_len=32, num_minibatches=4))
    # The shared trainer (rl/trainer.py train_loop) adds logging, resume
    # and checkpoints to this loop.
    _, carry = init_fn(2)
    generator = torch.Generator(device=env.device).manual_seed(3)
    losses = []
    t0 = time.perf_counter()
    for it in range(ITERS):
        carry, m = train_step(carry, generator)
        losses.append(m["loss"])
        if it % 10 == 9:
            print(f"iter {it + 1:3d}  ep_return {float(m['ep_return_mean']):+.3f}")
    final_ret = float(m["ep_return_mean"])
    seconds = time.perf_counter() - t0
    print(f"PPO after {ITERS} iters: {final_ret:+.3f} (random baseline {random_ret:+.3f})")
    return {
        "device": str(env.device),
        "random_episodes": episodes,
        "random_return": random_ret,
        "ppo_return": final_ret,
        "losses": torch.stack(losses).tolist(),
        "ppo_iters_per_s": ITERS / seconds,
    }


if __name__ == "__main__":
    main()
