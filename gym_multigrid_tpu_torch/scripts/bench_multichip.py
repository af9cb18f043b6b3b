"""Weak scaling: per-device throughput and efficiency over 1..N processes
(the port's ``bench_multichip.py``).

Usage:
  python -m gym_multigrid_tpu_torch.scripts.bench_multichip [--points 1,2]
      [--per-device-envs 512] [--steps 100] [--reps 4] [--family collect]
      [--path episode|step|ppo-train] [--device cuda|cpu]

Each point of W starts W processes (``multihost_dryrun.launch``), one rank
each, every rank with ``--per-device-envs`` envs of the family's benchmark
config (``bench_all.family_cfg``, the configs of JAX's ``bench_all.py``),
and times ``--reps`` calls of the path after one untimed call:

- ``episode``: the family's episode rollout under
  ``sharded_episode_rollout`` (the K-step kernels on the card);
- ``step``: its ``BatchedEnv`` under ``sharded_rollout`` (a step kernel
  launch a step);
- ``ppo-train``: the PPO train step under data parallelism
  (``make_ppo(..., mesh)``, ``rollout_len = --steps``).

A point's rate is its agent-steps over the slowest rank's time; its
efficiency is its rate per device over the first point's.  Prints ONE JSON
line: ``{"metric": "weak-scaling efficiency (...)", "value": eff at the
last point, "unit": "fraction", "vs_baseline": eff / 0.90, "detail": {W:
{...}}}``.

On CUDA the ranks run NCCL, one card each, so a point needs that many
cards; on one card only point 1 runs, and efficiency at one point is 1.0
by definition.  ``--device cpu`` runs the plain versions under gloo, to
check the plumbing at any point: its rates say nothing about the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from gym_multigrid_tpu_torch.scripts.bench_all import (
    CHUNKS,
    FAMILIES,
    align_steps,
    family_cfg,
)
from gym_multigrid_tpu_torch.scripts.multihost_dryrun import (
    add_worker_flags,
    launch,
    report,
    start_worker,
)

PATHS = ("episode", "step", "ppo-train")
#: Weak-scaling target of the JAX package's BASELINE.md.
TARGET = 0.90


def synchronize(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(mesh, family: str, path: str, per_device_envs: int, steps: int, reps: int) -> dict:
    """This rank's share of one point: its agent-steps and seconds over
    ``reps`` timed calls after one untimed call."""
    import torch

    from gym_multigrid_tpu_torch.parallel.mesh import fold_in_axis
    from gym_multigrid_tpu_torch.parallel.shard import sharded_episode_rollout, sharded_rollout

    cfg, make_batch, make_episode, agents = family_cfg(family)
    num_envs, device = per_device_envs * mesh.world_size, mesh.device
    if path == "ppo-train":
        from gym_multigrid_tpu_torch.rl.families import _FAMILY_SPECS
        from gym_multigrid_tpu_torch.rl.networks import ActorCritic
        from gym_multigrid_tpu_torch.rl.ppo import PPOConfig, make_ppo

        env = make_batch(cfg, num_envs, device=device)
        num_actions, agents_fn = _FAMILY_SPECS[family]
        agents = agents_fn(cfg)
        obs_shape = env.encode(cfg, env.reset(0)[0]).shape[1:]
        net = ActorCritic(num_actions, agents, obs_shape=obs_shape)
        init_fn, train_step = make_ppo(env, net, PPOConfig(
            rollout_len=steps, num_minibatches=2), mesh)
        _, carry = init_fn(0)
        gen = torch.Generator(device=device).manual_seed(fold_in_axis(1, mesh))

        def call():
            nonlocal carry
            carry, metrics = train_step(carry, gen)
            return metrics["loss"]
    else:
        if path == "episode":
            roll = make_episode(cfg, num_envs, device=device, chunk=CHUNKS[family])
            if roll is None:
                raise ValueError(f"{family} has no episode rollout for this config")
            rollout = sharded_episode_rollout(roll, mesh)
        else:
            rollout = sharded_rollout(make_batch(cfg, num_envs, device=device), mesh)
        states, _ = rollout.reset(0)

        def call():
            nonlocal states
            states, metrics = rollout(states, steps)
            return metrics["reward_sum"]

    float(call())  # untimed: kernels loaded, allocator warm
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        last = call()
    float(last)
    synchronize(device)
    return {"agent_steps": per_device_envs * steps * reps * agents,
            "seconds": time.perf_counter() - t0}


def run_weak_scaling(family: str = "collect", per_device_envs: int = 512, steps: int = 100,
                     reps: int = 4, points: list[int] | None = None, path: str = "episode",
                     device: str = "cuda", verbose: bool = True, timeout: float = 900):
    """Measure each point; returns (results by W, efficiency at the last
    point).  On CUDA a point of W needs W cards (NCCL puts one rank on a
    card): this raises before launching otherwise."""
    import torch

    if path not in PATHS:
        raise ValueError(f"unknown path {path!r}; expected one of {PATHS}")
    points = points or [1]
    if device == "cuda":
        cards = torch.cuda.device_count()
        if max(points) > cards:
            raise ValueError(f"a point of {max(points)} ranks needs {max(points)} cards; "
                             f"this host has {cards}")
    if path != "ppo-train":
        steps = align_steps(family, steps)
    results = {}
    for W in points:
        records = launch([sys.executable, "-m", "gym_multigrid_tpu_torch.scripts.bench_multichip",
                          "--family", family, "--path", path, "--device", device,
                          "--per-device-envs", str(per_device_envs), "--steps", str(steps),
                          "--reps", str(reps)], W, timeout)
        seconds = max(r["seconds"] for r in records)
        rate = sum(r["agent_steps"] for r in records) / seconds
        r = {"devices": W, "envs": per_device_envs * W, "agent_steps_per_sec": rate,
             "per_chip": rate / W, "seconds": seconds,
             "device": records[0]["device"], "backend": records[0]["backend"]}
        r["efficiency"] = r["per_chip"] / results[points[0]]["per_chip"] if results else 1.0
        results[W] = r
        if verbose:
            print(f"  {family} {path} @ {W} ranks ({r['backend']}, {r['device']}): "
                  f"{rate:,.0f} agent-steps/s, {r['per_chip']:,.0f} a rank, "
                  f"efficiency {r['efficiency']:.4f}", file=sys.stderr)
    return results, results[points[-1]]["efficiency"]


def run_worker(args) -> None:
    import torch.distributed as dist

    mesh = start_worker(args)
    try:
        rec = measure(mesh, args.family, args.path, args.per_device_envs, args.steps, args.reps)
        report(dict(rec, rank=mesh.rank, device=str(mesh.device), backend=dist.get_backend()))
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--family", default="collect", choices=FAMILIES)
    p.add_argument("--path", default="episode", choices=PATHS)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--points", default="1", help="comma-separated rank counts")
    p.add_argument("--per-device-envs", type=int, default=512)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--timeout", type=float, default=900)
    p.add_argument("--json-only", action="store_true")
    add_worker_flags(p)
    args = p.parse_args(argv)
    if args.rank is not None:
        run_worker(args)
        return 0
    points = [int(x) for x in args.points.split(",")]
    results, eff = run_weak_scaling(args.family, args.per_device_envs, args.steps, args.reps,
                                    points, args.path, args.device, not args.json_only,
                                    args.timeout)
    last = results[points[-1]]
    if len(points) == 1:
        print("note: one point; its efficiency is 1.0 by definition", file=sys.stderr)
    print(json.dumps({
        "metric": (f"weak-scaling efficiency ({args.family}, {args.path}, {points[-1]} ranks, "
                   f"{args.per_device_envs} envs/rank, {last['backend']} on {last['device']})"),
        "value": eff,
        "unit": "fraction",
        "vs_baseline": eff / TARGET,
        "physical_cores": os.cpu_count(),
        "detail": {str(w): {k: r[k] for k in ("agent_steps_per_sec", "per_chip", "efficiency",
                                               "seconds")} for w, r in results.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
