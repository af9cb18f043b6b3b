"""The parts of a run every cell shares: finding a cell's files by name,
the timed window, the reading of a profiler trace, the checks of the
environment, and the result line.  Imports no JAX and nothing of the
program: the drivers (``drivers/<kind>.py``) and the family modules
(``drivers/families/<family>.py``) are the only modules that import
``gym_multigrid_tpu_torch``."""

from __future__ import annotations

import importlib.util
import json
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Top-level module names that may not be loaded in a run's process: JAX,
#: its libraries and the JAX package this port stands beside.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "gym_multigrid_tpu")


@dataclass(frozen=True)
class Cell:
    """One entry of ``BENCHMARK.json``'s ``workloads`` with its files."""

    name: str
    chips: int
    config_name: str
    config: dict  # configs/<config>.json
    traffic_name: str
    traffic: dict  # traffic/<traffic>.json
    end_to_end: tuple  # the metric entries this cell reports with --trace 0
    per_layer: tuple  # ... and with --trace 1


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def find_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``), its
    configuration and traffic files loaded."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                       f"known: {[w['name'] for w in bench['workloads']]}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name, chips=entry["chips"], config_name=entry["config"],
        config=load_json(ROOT / conf["file"]), traffic_name=entry["traffic"],
        traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=tuple(m for m in bench["end_to_end"] if _reports(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _reports(m, name)),
    )


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module named ``name`` (metric files
    carry dots in their names, which ``import`` cannot take)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver_module(kind: str):
    return importlib.import_module(f"benchmark.drivers.{kind}")


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read(run) -> float | None``."""
    return load_module(HERE / "metrics" / f"{name}.py", f"benchmark_metric_{name}").read


def forbidden_loaded() -> list[str]:
    """Loaded modules whose top-level name (before the first dot),
    compared whole, is one of :data:`FORBIDDEN_MODULES`."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN_MODULES)


def card_line(index: int = 0) -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"{torch.cuda.get_device_name(index)}, nvidia-smi not read ({err})"


# ---------------------------------------------------------------------------
# The window
# ---------------------------------------------------------------------------


@dataclass
class Window:
    """What a timed window drove: ``calls`` calls in ``seconds`` of host
    clock (from its start to the synchronise after its last call), and each
    call's milliseconds on the card's stream, from the end of the call
    before it (the window's start for the first) to its own end."""

    calls: int
    seconds: float
    call_ms: list


def run_window(call, seconds: float, device) -> Window:
    """Chain ``call(i)`` for i = 0, 1, ... until ``seconds`` of host clock
    have passed, recording one CUDA event after each call; then one
    synchronise, and the events are read.  Nothing inside waits for the
    card unless ``call`` itself does.  (On the CPU, where the tests run,
    the host clock after each call stands in for the events.)"""
    on_card = torch.device(device).type == "cuda"
    stream = torch.cuda.current_stream(device) if on_card else None

    def mark():
        if not on_card:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    marks = [mark()]
    t0 = time.perf_counter()
    i = 0
    while True:
        call(i)
        marks.append(mark())
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    if on_card:
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    if on_card:
        ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return Window(i, elapsed, ms)


def p95(values) -> float:
    """The 95th percentile, by ``statistics.quantiles`` (exclusive method)."""
    return statistics.quantiles(values, n=100)[94] if len(values) > 1 else values[0]


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


@dataclass
class Trace:
    """A profiled window, read from the profiler's raw events: every
    operation on the card (kernels, copies, fills) as (name, start ns,
    duration ns); the host's ops on the window's thread; the window."""

    device_ops: list
    host_ops: list
    window_s: float
    calls: int
    _merged: list = field(default_factory=list)

    def kernels(self, *fragments: str, exclude: tuple = ()) -> list:
        """The kernel ops whose name holds every fragment and none of
        ``exclude``."""
        return [op for op in self.device_ops if _is_kernel(op[0])
                and all(f in op[0] for f in fragments) and not any(x in op[0] for x in exclude)]

    @property
    def kernel_count(self) -> int:
        return sum(1 for op in self.device_ops if _is_kernel(op[0]))

    @property
    def summed_s(self) -> float:
        """The device ops' summed seconds."""
        return sum(op[2] for op in self.device_ops) / 1e9

    def merged(self) -> list:
        """The device ops' busy intervals (start, end) ns, overlaps merged."""
        if not self._merged and self.device_ops:
            spans = sorted((s, s + d) for _, s, d in self.device_ops)
            out = [list(spans[0])]
            for s, e in spans[1:]:
                if s <= out[-1][1]:
                    out[-1][1] = max(out[-1][1], e)
                else:
                    out.append([s, e])
            self._merged = out
        return self._merged

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the card."""
        return sum(e - s for s, e in self.merged()) / 1e9

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for name, _, d in self.device_ops:
            by[name] = by.get(name, 0) + d
        return [[name[:160], ns / 1e9] for name, ns in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The card's idle time between its busy intervals, summed by the
        innermost host op under way on the window's thread where each gap
        begins; the ``n`` largest sums."""
        spans = self.merged()
        gaps = [(a[1], b[0]) for a, b in zip(spans, spans[1:]) if b[0] > a[1]]
        ops = sorted(self.host_ops, key=lambda op: op[1])
        by, stack, j = {}, [], 0
        for g0, g1 in gaps:
            while j < len(ops) and ops[j][1] <= g0:
                stack.append(ops[j])
                j += 1
            stack = [op for op in stack if op[1] + op[2] > g0]
            name = stack[-1][0] if stack else "(no host op)"
            by[name] = by.get(name, 0) + (g1 - g0)
        return [[name[:160], ns / 1e9] for name, ns in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


WINDOW_RANGE = "benchmark window"


def traced_window(call, seconds: float, device) -> tuple[Window, Trace]:
    """:func:`run_window` under ``torch.profiler`` (host and card), and the
    trace read from the profiler's raw events."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, acc_events=True) as prof:
        with torch.profiler.record_function(WINDOW_RANGE):
            win = run_window(call, seconds, device)
    events = prof.profiler.kineto_results.events()
    dev_ops, host = [], []
    thread = None
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():  # the window's own range is no device op
                dev_ops.append((e.name(), e.start_ns(), e.duration_ns()))
        else:
            if e.name() == WINDOW_RANGE:
                thread = e.start_thread_id()
            host.append((e.name(), e.start_ns(), e.duration_ns(), e.start_thread_id()))
    host = [op[:3] for op in host if op[3] == thread and op[0] != WINDOW_RANGE]
    return win, Trace(dev_ops, host, win.seconds, win.calls)


# ---------------------------------------------------------------------------
# The result
# ---------------------------------------------------------------------------


@dataclass
class Run:
    """Everything a metric reader may read (``metrics/<name>.py``)."""

    cell: Cell
    setup_s: float
    window: Window
    peak_bytes: int
    #: Work of one call of the window: ``agent_steps``, ``env_steps``.
    work: dict
    trace: Trace | None = None
    #: What the driver counted in the window, by name.
    counts: dict = field(default_factory=dict)
    #: A traced run's window of ``--seconds`` before the profiler, where
    #: the traffic asks for one (``untraced_window_in_trace``).
    untraced: Window | None = None


def result_line(correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                breakdown: dict | None, checks: dict) -> str:
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checked"] = checks
    return json.dumps(line)
