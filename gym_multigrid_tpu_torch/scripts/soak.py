"""Sustained load: consecutive timed windows of a family's episode rollout
(the port's ``scripts/soak.py``).

Usage:
  python -m gym_multigrid_tpu_torch.scripts.soak [--family ctf] [--batch 8192]
      [--windows 30] [--window-steps 400] [--cpu] [--out out/soak_<family>_torch.json]

Runs the family's episode rollout (the benchmark config, chunk and step
alignment of ``scripts/bench_all.py``; on the card one K-step kernel
launch a chunk) for ``--windows`` consecutive windows.  Each window chains
as many calls of ``--window-steps`` steps as two calls before the
windows say fill ``WINDOW_SECONDS``, between two CUDA events with one
synchronise at its end (the host clock on the CPU), so that a short
window's fixed costs do not set its rate.
Reports the min, p50, mean and max agent-steps/s of the windows and the
drift of the last third's mean from the first third's, so that
"sustained" is a measured claim.  The record goes to ``--out``, by default
``out/soak_<family>_torch.json``.  Runs on the current CUDA device, or on
the CPU with ``--cpu``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os

from gym_multigrid_tpu_torch.scripts.bench_all import align_steps, chained_calls, episode_rollout

#: Seconds of work a window holds, judged from two calls before the windows.
WINDOW_SECONDS = 2.0


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--family", default="ctf", choices=["collect", "ctf", "maze", "wildfire"])
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--windows", type=int, default=30)
    p.add_argument("--window-steps", type=int, default=400)
    p.add_argument("--cpu", action="store_true", help="run on the CPU, not the CUDA device")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from gym_multigrid_tpu_torch.scripts import out_path
    from gym_multigrid_tpu_torch.utils.profiling import card_label, timed

    out = out_path(args.out or os.path.join("out", f"soak_{args.family}_torch.json"))
    steps = align_steps(args.family, args.window_steps)
    roll, agents = episode_rollout(args.family, args.batch, "cpu" if args.cpu else None)
    dev, card = roll.slab.device, card_label(roll.slab.device)
    states, _ = roll.reset(0)
    states, m = roll(states, steps)  # untimed: kernels loaded, allocator warm
    float(m["reward_sum"])

    (states, _), seconds = timed(dev, lambda: chained_calls(roll, states, steps, 2))
    calls = max(2, int(WINDOW_SECONDS / max(seconds / 2, 1e-4)) + 1)
    rates = []
    for _ in range(args.windows):
        (states, _), seconds = timed(dev, lambda: chained_calls(roll, states, steps, calls))
        rates.append(args.batch * steps * calls * agents / seconds)
    total_s = args.batch * steps * calls * agents * sum(1 / r for r in rates)

    ordered = sorted(rates)
    third = max(1, len(rates) // 3)
    first_third = sum(rates[:third]) / third
    last_third = sum(rates[-third:]) / third
    rec = {
        "command": (
            f"{args.windows} consecutive timed windows ({calls} chained {steps}-step calls "
            f"each, one synchronise a window) of the {args.family} episode rollout (batch "
            f"{args.batch}) on {card}, {total_s:.0f} s of sustained load"),
        "run_date": datetime.date.today().isoformat(),
        "harness": "CUDA events around each window, one synchronise at its end (host clock "
        "on the CPU); python -m gym_multigrid_tpu_torch.scripts.soak",
        "device": card,
        "agent_steps_per_sec": {
            "min": ordered[0],
            "p50": ordered[len(rates) // 2],
            "mean": sum(rates) / len(rates),
            "max": ordered[-1],
        },
        "drift_first_vs_last_third_pct": 100 * (last_third - first_third) / first_third,
        "windows": rates,
        "calls_per_window": calls,
        "steps_per_call": steps,
    }
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=2)
        f.write("\n")
    print(json.dumps({k: rec[k] for k in
                      ("command", "agent_steps_per_sec", "drift_first_vs_last_third_pct")}))
    return rec


if __name__ == "__main__":
    main()
