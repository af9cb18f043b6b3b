"""The PPO learner at a million envs (the port's
``scripts/bench_ppo_scale.py``): one full PPO iteration (the rollout with
the network's forwards, GAE, the minibatched clipped update) over 2**20
concurrent CtF envs on one card.

Usage:
  python -m gym_multigrid_tpu_torch.scripts.bench_ppo_scale           # the record config
  python -m gym_multigrid_tpu_torch.scripts.bench_ppo_scale --envs 262144 --rollout-len 8
  python -m gym_multigrid_tpu_torch.scripts.bench_ppo_scale --cpu --envs 64 --rollout-len 4 \\
      --minibatches 2 --shuffle-blocks 2 --iters 1

The defaults are the config of the JAX package's record
(``artifacts/ppo_1m_envs.json``): ``make_family_batch("ctf", 1048576)``,
``rollout_len=16``, 128 minibatches, 64 shuffle blocks and an int8 obs
buffer (``PPOConfig.obs_buffer_dtype``: the same updates, 4x fewer bytes
than int32).  That record is a TPU number and no target for the port.
One untimed iteration, then ``--iters`` iterations between two CUDA events
with one synchronise at the end.  Prints one JSON line with the JAX
record's keys, ``backend`` the device, beside it the card's name and power
limit and the peak memory; ``--out`` also writes it to that file, and
nothing is written without it.  ``--profile`` adds one iteration's
rollout and update times apart and a profile of one more.  Runs on the current CUDA device, or on
the CPU with ``--cpu``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import math
import os
from typing import NamedTuple


class Learner(NamedTuple):
    """A PPO learner over a family batch, as :func:`build_learner` made it."""

    env: object  # the BatchedEnv
    net: object  # the ActorCritic
    obs_shape: tuple  # one env's observation, from the encode
    ppo_cfg: object
    train_step: object  # make_ppo's train_step(carry, generator)
    carry: object  # init_fn(0)'s rollout carry
    generator: object  # seeded 1, on the batch's device


def build_learner(family: str, args) -> Learner:
    """The learner of ``make_family_batch(family, args.envs)``: the MLP
    ``ActorCritic`` over the encode's shape and ``make_ppo`` with
    ``args.rollout_len``, ``args.minibatches``, ``args.obs_buffer_dtype``
    and ``args.shuffle_blocks`` (0 or empty: the defaults), initialised
    from ``init_fn(0)``; on the CPU with ``args.cpu``, else on the current
    CUDA device.  No train step has run."""
    import torch

    from gym_multigrid_tpu_torch.rl.families import make_family_batch
    from gym_multigrid_tpu_torch.rl.networks import ActorCritic
    from gym_multigrid_tpu_torch.rl.ppo import PPOConfig, make_ppo

    env, cfg, num_actions, policy_agents = make_family_batch(
        family, args.envs, "cpu" if args.cpu else None)
    obs_shape = tuple(env.encode(cfg, env.reset(0)[0]).shape[1:])
    net = ActorCritic(num_actions, policy_agents, obs_shape=obs_shape)
    ppo_cfg = PPOConfig(
        rollout_len=args.rollout_len,
        num_minibatches=args.minibatches,
        obs_buffer_dtype=args.obs_buffer_dtype or None,
        shuffle_blocks=args.shuffle_blocks or None,
    )
    init_fn, train_step = make_ppo(env, net, ppo_cfg)
    _, carry = init_fn(0)
    generator = torch.Generator(device=env.device).manual_seed(1)
    return Learner(env, net, obs_shape, ppo_cfg, train_step, carry, generator)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--envs", type=int, default=1 << 20)
    p.add_argument("--rollout-len", type=int, default=16)
    p.add_argument("--minibatches", type=int, default=128)
    p.add_argument("--shuffle-blocks", type=int, default=64,
                   help="epoch-shuffle block count (PPOConfig.shuffle_blocks); 0 = global "
                   "shuffle")
    p.add_argument("--iters", type=int, default=4, help="timed train steps")
    p.add_argument("--obs-buffer-dtype", default="int8")
    p.add_argument("--cpu", action="store_true", help="run on the CPU, not the CUDA device")
    p.add_argument("--out", default=None, help="also write the JSON record here")
    p.add_argument("--profile", action="store_true",
                   help="after the timed iterations, time one more's rollout and update "
                   "apart and profile one more (device time by kernel, idle share)")
    args = p.parse_args(argv)

    import torch

    from gym_multigrid_tpu_torch.scripts import out_path
    from gym_multigrid_tpu_torch.utils.profiling import (
        card_label,
        summarize_profile,
        timed,
        trace,
    )

    out = out_path(args.out) if args.out else None

    if not args.cpu:
        torch.cuda.reset_peak_memory_stats()
    learner = build_learner("ctf", args)
    net, train_step, carry, generator = (
        learner.net, learner.train_step, learner.carry, learner.generator)
    dev = learner.env.device
    on_card = dev.type == "cuda"
    start = [x.detach().clone() for x in net.parameters()]
    carry, metrics = train_step(carry, generator)  # untimed: kernels loaded, allocator warm
    float(metrics["loss"])

    def iterations():
        nonlocal carry
        for _ in range(args.iters):
            carry, m = train_step(carry, generator)
        return m

    metrics, seconds = timed(dev, iterations)
    sps = args.envs * args.rollout_len * args.iters / seconds
    losses = {k: float(metrics[k]) for k in ("loss", "pg_loss", "v_loss", "entropy")}
    moved = max(float((a.detach() - b).abs().max()) for a, b in zip(net.parameters(), start))
    rec = {
        "config": "the JAX package's 1M-env PPO record config (artifacts/ppo_1m_envs.json): "
        "a 1M-env CtF batch feeding the PPO learner",
        "command": f"make_family_batch('ctf', {args.envs}) + make_ppo("
        f"rollout_len={args.rollout_len}, num_minibatches={args.minibatches}, "
        f"obs_buffer_dtype={args.obs_buffer_dtype!r}, "
        f"shuffle_blocks={args.shuffle_blocks or None}); {args.iters} train steps timed "
        f"after one untimed (python -m gym_multigrid_tpu_torch.scripts.bench_ppo_scale)",
        "envs": args.envs,
        "rollout_len": args.rollout_len,
        "num_minibatches": args.minibatches,
        "obs_buffer_dtype": args.obs_buffer_dtype,
        "shuffle_blocks": args.shuffle_blocks or None,
        "env_steps_per_sec": sps,
        "backend": str(dev),
        "card": card_label(dev),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev) if on_card else None,
        "run_date": datetime.date.today().isoformat(),
        "harness": "CUDA events around the timed iterations, one synchronise at the end "
        "(host clock on the CPU)",
        "notes": "The port's learner (rl/ppo.py): actions by Gumbel-max and the blocked "
        "epoch shuffle by an argsort of uniforms, both from a torch.Generator; five "
        "gathers a minibatch (JAX's packed scalar row is a TPU workaround, not ported).",
        "losses": losses,
        "param_max_change": moved,
        "finite": all(math.isfinite(v) for v in losses.values()),
    }
    if args.profile:
        (carry, traj, last_value, _), rollout_s = timed(
            dev, lambda: train_step.rollout(carry, generator))
        update_s = timed(dev, lambda: train_step.update(traj, last_value, generator)).seconds
        del traj, last_value
        with trace() as prof:
            train_step(carry, generator)
        rec["split_s"] = {"rollout": rollout_s, "update": update_s}
        rec["profile"] = summarize_profile(prof)
    print(json.dumps(rec))
    if out:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            json.dump(rec, f)
            f.write("\n")
    return rec


if __name__ == "__main__":
    main()
