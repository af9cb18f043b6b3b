"""Readings for the limits of a cell's compared numbers: on each seed, the
program's numbers (its checked call against the reference) and the
control's (the reference computed one precision lower, bfloat16 or
float8, in the program's place), and with ``--fault`` the numbers of a
program broken as named.

    python -m benchmark.control --workload <cell> --seeds 1,2,3 [--seconds 1]
        [--fault half|unchanged|altered] [--no-control]

One JSON line a seed: {"seed", "program", "control" or "fault"}.  Set-up
runs once a seed in one process; the window is short, long enough to
reach the checked call."""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import faults, harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--fault", choices=sorted(faults.FAULTS), default=None)
    p.add_argument("--no-control", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("benchmark.control: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.find_cell(args.workload)
    device = torch.device("cuda", 0)
    print(f"card: {harness.card_line(0)}", file=sys.stderr, flush=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        fault = faults.FAULTS[args.fault] if args.fault else None
        driver = harness.driver_module(cell.traffic["driver"]).Driver(cell, seed, device, fault)
        harness.run_window(driver.call, args.seconds, device)
        driver.free()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        line = {"seed": seed, "program" if not args.fault else "fault": driver.check()}
        t2 = time.perf_counter()
        if not args.no_control and not args.fault:
            line["control"] = driver.check(control=True)
        line["seconds"] = {"setup_and_window": t1 - t0, "check": t2 - t1,
                           "control": time.perf_counter() - t2}
        print(json.dumps(line), flush=True)
        del driver
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
