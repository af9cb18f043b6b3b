"""Batch-size sweep of the episode rollouts (the port's
``scripts/sweep_batch.py``).

Usage:
  python -m gym_multigrid_tpu_torch.scripts.sweep_batch [--families collect,ctf]
      [--batches 1024,4096,16384,65536] [--steps 200] [--reps 4] [--cpu]

Measures agent-steps/s as the batch grows, for each family's episode
rollout (the benchmark config and chunk of ``scripts/bench_all.py``;
on the card one K-step kernel launch a chunk, the port's counterpart of
JAX's ``xla-ms`` path).  Each (family, batch) runs one untimed call of
``--steps`` steps (Collect's aligned to whole episodes), then ``--reps``
calls between two CUDA events with one synchronise (the host clock on the
CPU), and prints one JSON line.  The rate should rise until the device
saturates, then flatten: the knee is the smallest batch that buys the
card's full rate.  Runs on the current CUDA device, or on the CPU with
``--cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys


def measure(family: str, batch: int, steps: int, reps: int, device) -> dict:
    """One point of the sweep: ``reps`` timed calls after one untimed."""
    from gym_multigrid_tpu_torch.scripts.bench_all import chained_calls, episode_rollout
    from gym_multigrid_tpu_torch.utils.profiling import card_label, timed

    roll, agents = episode_rollout(family, batch, device)
    states, _ = roll.reset(0)
    states, m = roll(states, steps)  # untimed: kernels loaded, allocator warm
    float(m["reward_sum"])
    _, seconds = timed(roll.slab.device, lambda: chained_calls(roll, states, steps, reps))
    return {
        "family": family,
        "batch": batch,
        "path": "episode",
        "agent_steps_per_sec": batch * steps * reps * agents / seconds,
        "device": card_label(roll.slab.device),
    }


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser()
    p.add_argument("--families", default="collect,ctf")
    p.add_argument("--batches", default="1024,4096,16384,65536")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--cpu", action="store_true", help="run on the CPU, not the CUDA device")
    args = p.parse_args(argv)

    from gym_multigrid_tpu_torch.scripts.bench_all import align_steps

    points = []
    for family in args.families.split(","):
        steps = align_steps(family, args.steps)
        for batch in (int(b) for b in args.batches.split(",")):
            points.append(measure(family, batch, steps, args.reps, "cpu" if args.cpu else None))
            print(json.dumps(points[-1]))
            sys.stdout.flush()
    return points


if __name__ == "__main__":
    main()
