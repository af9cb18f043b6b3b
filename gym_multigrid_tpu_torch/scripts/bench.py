"""Benchmark harness: Collect agent-steps/s on one card at batch 8192 (the
port's ``bench.py``).

Usage:
  python -m gym_multigrid_tpu_torch.scripts.bench                # on the CUDA device
  python -m gym_multigrid_tpu_torch.scripts.bench --cpu --batch 16 --steps 50

The config of the JAX package's ``bench.py``: Collect
``CollectConfig(layout="quadrants_respawn", respawn=True, max_steps=50)``
(2 agents, 50-step truncation), B = 8192 lockstep envs with auto-reset,
500 steps a call.  On the card it runs the episode rollout at chunk 25
(the hand kernel ``collect_steps_philox``, 20 launches a call, which makes
its draws and runs the truncation reset); with ``--cpu``
the ``step`` path (``BatchedEnv.rollout`` on the plain versions), as JAX
picks its per-step path on the CPU.  The warm-up and the three timed
windows are ``bench_all``'s (``bench_all.measure``).

Prints ONE JSON line: ``metric``, ``value``, ``unit``, ``vs_baseline``
(against the reference's 9,400 agent-steps/s on one CPU core), ``device``,
``windows`` and ``kernel_launches_per_call``, as ``bench_all``'s lines.
JAX's ``band_ok`` is not ported: its band is around a TPU rate.  Without
``--cpu`` the run needs a CUDA device and exits nonzero without one.
"""

from __future__ import annotations

import argparse
import json

from gym_multigrid_tpu_torch.scripts import bench_all

REFERENCE_AGENT_STEPS_PER_SEC = 9_400.0  # the reference on one CPU core
BATCH = 8192
#: Ten lockstep 50-step episodes a call.
STEPS_PER_CALL = 500


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true", help="run on the CPU, not the CUDA device")
    p.add_argument("--batch", type=int, default=BATCH)
    p.add_argument("--steps", type=int, default=STEPS_PER_CALL, help="steps a call")
    args = p.parse_args(argv)
    bench_all.require_card(args.cpu, "bench")
    m = bench_all.measure("collect", args.batch, bench_all.align_steps("collect", args.steps),
                          "step" if args.cpu else "episode", "cpu" if args.cpu else None)
    rec = bench_all.record(f"agent-steps/sec/chip (Collect, batch {args.batch})", m,
                           REFERENCE_AGENT_STEPS_PER_SEC)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
