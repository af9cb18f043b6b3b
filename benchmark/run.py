"""Run one cell of BENCHMARK.json and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (the card, the kernels' build under ``build/kernels/`` of the
checkout, the program's states and weights made from the seed, warm-up
calls on the cell's own shapes), then a window of ``--seconds`` that
chains the cell's calls (``--trace 1``: a window of the traffic's
``trace_seconds`` at most, under ``torch.profiler``, after a window of
``--seconds`` without it where the traffic sets
``untraced_window_in_trace``), then the check of
one call of the window against the plain reference, then the lines: each
compared number beside its limit on standard error, the result as the
last line of standard output.  Exits nonzero, and prints no result, with
no CUDA card (or fewer than the cell asks for), without the program, or
with JAX or the JAX package loaded."""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Every cache a run may write lives at a fixed path inside the checkout.
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / "build" / "bench-cache" / sub)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(message: str, code: int = 2) -> int:
    print(f"benchmark: {message}", file=sys.stderr)
    return code


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.seed < 0:
        return fail(f"--seed must be a whole number >= 0, got {args.seed}")
    import torch

    from benchmark import harness

    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        return fail(f"{cell.name} needs {cell.chips} CUDA card(s); "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
    try:
        import gym_multigrid_tpu_torch  # noqa: F401
    except ImportError as err:
        return fail(f"the program gym_multigrid_tpu_torch is not importable here: {err}")
    # One process with few threads: the host's share of a call varies less.
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.reset_peak_memory_stats(device)
    print(f"card: {harness.card_line(0)}", file=sys.stderr, flush=True)
    line, checked = execute(cell, args.seed, args.seconds, bool(args.trace), device)
    loaded = harness.forbidden_loaded()
    if loaded:
        return fail(f"modules of JAX or of the JAX package are loaded: {loaded}", 3)
    for name, c in checked.items():
        print(f"checked {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0


def execute(cell, seed: int, seconds: float, trace: bool, device, fault=None):
    """Set-up, window and check of ``cell`` on ``device``: (the result
    line, the compared numbers with their limits).  ``fault``
    (``faults.py``) breaks the timed path underneath, for the tests."""
    import torch

    from benchmark import harness

    limits = harness.load_json(harness.HERE / "limits" / f"{cell.name}.json")["limits"]
    driver = harness.driver_module(cell.traffic["driver"]).Driver(cell, seed, device, fault)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T0

    tr = untraced = None
    if trace:
        if cell.traffic.get("untraced_window_in_trace"):
            # A rate read per layer (a host-paced one) from a window of its
            # own length, before the profiler is on.
            untraced = harness.run_window(driver.call, seconds, device)
        driver.traced = True
        window, tr = harness.traced_window(
            driver.call, min(seconds, cell.traffic["trace_seconds"]), device)
    else:
        window = harness.run_window(driver.call, seconds, device)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    counts = driver.counts()
    driver.free()
    if on_card:
        torch.cuda.empty_cache()
    checks = driver.check(count=counts if tr is not None else None)
    checked = {}
    for name, value in checks.items():
        if name not in limits:
            raise KeyError(f"no limit for the compared number {name!r} of {cell.name}")
        checked[name] = {"value": value, "limit": limits[name]}
    correct = all(c["value"] <= c["limit"] for c in checked.values())

    run = harness.Run(cell, setup_s, window, peak, driver.work, tr, counts, untraced)
    metrics = {}
    for entry in (cell.per_layer if tr is not None else cell.end_to_end):
        value = harness.metric_reader(entry["name"])(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": 1,
                   "memory_peak_bytes": peak}
    breakdown = None
    if tr is not None:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        breakdown = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    ms = sorted(window.call_ms)
    print(f"window: {window.calls} calls in {window.seconds} s, call ms min {ms[0]} median "
          f"{ms[len(ms) // 2]} max {ms[-1]}; set-up {setup_s} s; counts {counts}",
          file=sys.stderr)
    line = harness.result_line(correct, window.calls, 0, metrics, device_info, breakdown,
                               checked)
    return line, checked


if __name__ == "__main__":
    sys.exit(main())
