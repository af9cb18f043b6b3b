"""The speed-of-light record of every family and of the PPO learner:
``out/sol_report_torch.json`` (the port's ``scripts/sol_record.py``).

Usage:
  python -m gym_multigrid_tpu_torch.scripts.sol_record [--batch 8192]
      [--families collect,ctf,maze,wildfire] [--out out/sol_report_torch.json]
      [--skip-ppo] [--cpu]

Runs ``profile_rollout.py`` on each family's episode path (its K-step
kernels on the card) in a process of its own (a
host-bound rate depends on what ran before it in the process), with a
trace under ``<out dir>/sol_trace_torch/<family>``, and records each
record beside the resource that binds it, read from the trace: the host
where the device idles most of the wall, else the memory rate where the
path reaches 30% of its designed-traffic ceiling, else the device's
compute or latency.

Then, unless ``--skip-ppo``, the PPO learner's roofline at JAX's two
points (:data:`PPO_POINTS`): ``profile_ppo.py`` in a process of its own
for each, traced under ``<out dir>/sol_trace_torch/ppo_<name>``, its
record written under ``ppo_train``.  A point runs when the family it
trains (``--family``, CtF for both) is among ``--families``.  A family or
a point whose process fails makes the run fail.  Without ``--cpu`` it
needs a card and exits nonzero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from gym_multigrid_tpu_torch.scripts import out_path
from gym_multigrid_tpu_torch.scripts.bench_all import FAMILIES, require_card
from gym_multigrid_tpu_torch.scripts.multihost_dryrun import REPO
from gym_multigrid_tpu_torch.scripts.profile_ppo import parse_args as ppo_args

#: The PPO learner's points, ``profile_ppo`` flags by name (JAX's): the
#: bench's training scale and the 1M-env record's config.
PPO_POINTS = {
    "bench_scale": ["--envs", "8192", "--rollout-len", "32", "--minibatches", "8"],
    "record_1m": ["--envs", str(1 << 20), "--rollout-len", "16", "--minibatches", "128",
                  "--shuffle-blocks", "64"],
}


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


def run_record(script: str, flags: list[str], env: dict) -> dict:
    """``python -m gym_multigrid_tpu_torch.scripts.<script> <flags>`` from
    the checkout: its last JSON line, or RuntimeError with its output's end
    on stderr when it exits nonzero or prints none."""
    cmd = [sys.executable, "-m", f"gym_multigrid_tpu_torch.scripts.{script}", *flags]
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=900, env=env, cwd=REPO)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    if out.returncode != 0 or not lines:
        sys.stderr.write(out.stdout[-2000:] + out.stderr[-2000:])
        raise RuntimeError(f"{script} {' '.join(flags)} failed (exit {out.returncode})")
    return json.loads(lines[-1])


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--families", default=",".join(FAMILIES))
    p.add_argument("--out", default=os.path.join("out", "sol_report_torch.json"))
    p.add_argument("--skip-ppo", action="store_true",
                   help="omit the PPO learner's rooflines (profile_ppo.py)")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    args.out = out_path(args.out)
    require_card(args.cpu, "sol_record")

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    trace_root = os.path.join(os.path.dirname(args.out), "sol_trace_torch")
    cpu = ["--cpu"] if args.cpu else []
    families = args.families.split(",")
    records = {}
    for family in families:
        rec = run_record("profile_rollout", [
            "--family", family, "--batch", str(args.batch), "--steps", str(args.steps),
            "--json", "--trace", os.path.join(trace_root, family), *cpu], env)
        rec["binding_resource"] = binding_resource(rec)
        records[family] = rec
    ppo = {}
    for name, flags in ({} if args.skip_ppo else PPO_POINTS).items():
        if ppo_args(flags).family in families:
            ppo[name] = run_record("profile_ppo", [
                *flags, "--json", "--trace", os.path.join(trace_root, f"ppo_{name}"), *cpu], env)
    payload = {"batch": args.batch, "path": "episode", "families": records}
    if ppo:
        payload["ppo_train"] = ppo
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")
    for family, rec in records.items():
        print(f"{family}: {rec['agent_steps_per_s']:,.0f} agent-steps/s on {rec['device']}; "
              f"{rec['binding_resource']}")
    for name, rec in ppo.items():
        print(f"ppo {name}: {rec['env_steps_per_s']:,.0f} env-steps/s, {rec['train_step_s']} s "
              f"a train step, {rec['achieved_model_tflops_per_s']} model TFLOP/s, "
              f"{rec['mfu_vs_bf16_dense_peak']} of the dense bf16 peak on {rec['device']}; "
              f"{rec['binding_resource']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
