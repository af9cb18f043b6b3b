"""The speed-of-light record of every family: ``out/sol_report_torch.json``
(the port's ``scripts/sol_record.py``).

Usage:
  python -m gym_multigrid_tpu_torch.scripts.sol_record [--batch 8192]
      [--families collect,ctf,maze,wildfire] [--out out/sol_report_torch.json] [--cpu]

Runs ``profile_rollout.py`` on each family's episode path (its K-step
kernels on the card) in a process of its own (a
host-bound rate depends on what ran before it in the process), with a
trace under ``<out dir>/sol_trace_torch/<family>``, and records each
record beside the resource that binds it, read from the trace: the host
where the device idles most of the wall, else the memory rate where the
path reaches 30% of its designed-traffic ceiling, else the device's
compute or latency.  The PPO learner's rooflines (JAX's
``scripts/profile_ppo.py``) are not part of this port.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from gym_multigrid_tpu_torch.scripts import out_path
from gym_multigrid_tpu_torch.scripts.bench_all import FAMILIES
from gym_multigrid_tpu_torch.scripts.multihost_dryrun import REPO


def binding_resource(rec: dict) -> str:
    """What bounds a profiled path (see the module docstring)."""
    obs = rec.get("observed_profile") or {}
    idle = obs.get("idle_share")
    if idle is None or rec["sol_fraction"] is None:
        return "not measured (no device in the trace)"
    if idle > 0.5:
        return f"host: the device idles {idle:.3f} of the wall"
    if rec["sol_fraction"] > 0.3:
        return f"memory rate: {rec['sol_fraction']:.3f} of the designed-traffic ceiling"
    return (f"device compute or latency: busy {1 - idle:.3f} of the wall at "
            f"{rec['sol_fraction']:.4f} of the designed-traffic ceiling")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--families", default=",".join(FAMILIES))
    p.add_argument("--out", default=os.path.join("out", "sol_report_torch.json"))
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    args.out = out_path(args.out)

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    trace_root = os.path.join(os.path.dirname(args.out), "sol_trace_torch")
    records = {}
    for family in args.families.split(","):
        cmd = [sys.executable, "-m", "gym_multigrid_tpu_torch.scripts.profile_rollout",
               "--family", family, "--batch", str(args.batch), "--steps", str(args.steps),
               "--json",
               "--trace", os.path.join(trace_root, family)] + (["--cpu"] if args.cpu else [])
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=900,
                             env=env, cwd=REPO)
        lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
        if out.returncode != 0 or not lines:
            sys.stderr.write(out.stdout[-2000:] + out.stderr[-2000:])
            raise RuntimeError(f"profile_rollout --family {family} failed "
                               f"(exit {out.returncode})")
        rec = json.loads(lines[-1])
        rec["binding_resource"] = binding_resource(rec)
        records[family] = rec
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"batch": args.batch, "path": "episode", "families": records}, f, indent=2)
        f.write("\n")
    for family, rec in records.items():
        print(f"{family}: {rec['agent_steps_per_s']:,.0f} agent-steps/s on {rec['device']}; "
              f"{rec['binding_resource']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
