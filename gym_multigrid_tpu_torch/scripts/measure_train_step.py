"""The PPO train step's time on one device (the port's
``scripts/measure_train_step.py``).

Usage:
  python -m gym_multigrid_tpu_torch.scripts.measure_train_step [--envs 512] [--rollout 32]
      [--minibatches 8] [--epochs 1] [--reps 5] [--cpu] [--out out/train_step_time_torch.json]

The pod efficiency model of ``scripts/audit_comm.py`` (``pod_model``)
needs the compute window that a gradient all-reduce overlaps with: the
whole train step (the rollout with its forwards, GAE and the minibatched
update), not the env's step alone.  This times ``make_ppo``'s train step
at the weak-scaling unit of the JAX package's measurement: Collect
``quadrants_respawn``, ``--envs`` envs a device, ``--rollout`` steps.
One untimed step, then ``--reps`` steps, each between two CUDA events
with one synchronise (the host clock on the CPU); the best is the
measurement.  It goes to ``--out`` with the JAX record's fields,
``backend`` the card's name and power limit.  Runs on the current CUDA
device, or on the CPU with ``--cpu``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os

#: Where the measurement goes and ``audit_comm`` reads it from.
DEFAULT_OUT = os.path.join("out", "train_step_time_torch.json")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--envs", type=int, default=512,
                   help="per-device env count (the weak-scaling unit)")
    p.add_argument("--rollout", type=int, default=32)
    p.add_argument("--minibatches", type=int, default=8)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--cpu", action="store_true", help="run on the CPU, not the CUDA device")
    p.add_argument("--out", default=DEFAULT_OUT)
    args = p.parse_args(argv)

    import torch

    from gym_multigrid_tpu_torch.envs.collect import CollectConfig
    from gym_multigrid_tpu_torch.parallel.vector import make_collect_batch
    from gym_multigrid_tpu_torch.rl.networks import ActorCritic
    from gym_multigrid_tpu_torch.rl.ppo import PPOConfig, make_ppo
    from gym_multigrid_tpu_torch.scripts import out_path
    from gym_multigrid_tpu_torch.utils.profiling import card_label, timed

    out = out_path(args.out)
    cfg = CollectConfig(layout="quadrants_respawn", respawn=True, max_steps=50)
    env = make_collect_batch(cfg, args.envs, "cpu" if args.cpu else None)
    net = ActorCritic(4, cfg.num_agents, obs_shape=(cfg.size, cfg.size, 3))
    ppo_cfg = PPOConfig(rollout_len=args.rollout, num_epochs=args.epochs,
                        num_minibatches=args.minibatches)
    init_fn, train_step = make_ppo(env, net, ppo_cfg)
    _, carry = init_fn(0)
    generator = torch.Generator(device=env.device).manual_seed(1)
    carry, m = train_step(carry, generator)  # untimed: kernels loaded, allocator warm
    float(m["loss"])

    def step():
        nonlocal carry
        carry, metrics = train_step(carry, generator)
        return metrics

    times = [timed(env.device, step).seconds for _ in range(args.reps)]
    rec = {
        "train_step_s": min(times),
        "env_steps_per_train_step": args.envs * args.rollout,
        "config": {
            "per_device_envs": args.envs,
            "rollout_len": args.rollout,
            "num_minibatches": args.minibatches,
            "num_epochs": args.epochs,
            "family": "collect quadrants_respawn",
        },
        "backend": card_label(env.device),
        "harness": f"best of {args.reps} train steps after one untimed, each between CUDA "
        "events with one synchronise (host clock on the CPU); python -m "
        "gym_multigrid_tpu_torch.scripts.measure_train_step",
        "run_date": datetime.date.today().isoformat(),
        "train_step_s_all": times,
    }
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=2)
        f.write("\n")
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
