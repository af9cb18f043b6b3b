"""The work a traced window gave a cell's measured kernel: (bytes,
operations, the kernel's summed device seconds), from the cell's work
reader ``work/<driver>.<family>.py``, found by the cell's traffic driver
and configuration family.  Each reader holds ``KERNEL``, the kernel's
name, and ``read(run)``, which reads the run's trace and counts and the
configuration's own tables, and returns None where the run has no trace,
or the trace's launches of the kernel are not the launches the program's
wrapper counted (:func:`matched`)."""

from __future__ import annotations

import functools

from benchmark import harness
from benchmark.roofline import counts

WORK = harness.HERE / "roofline" / "work"


def matched(run, *fragments, exclude=()):
    """The summed device seconds of the trace's kernels whose names hold
    every fragment and none of ``exclude``; None without a trace, or where
    their count is not the wrapper's ``launches``."""
    if run.trace is None:
        return None
    ops = run.trace.kernels(*fragments, exclude=exclude)
    if not ops or len(ops) != run.counts.get("launches"):
        return None
    return sum(op[2] for op in ops) / 1e9


@functools.cache
def reader(driver: str, family: str):
    """``work/<driver>.<family>.py``, or None where the cell has none."""
    path = WORK / f"{driver}.{family}.py"
    return harness.load_module(path, f"benchmark_work_{driver}_{family}") if path.exists() else None


def work(run, kernel: str | None = None):
    """The cell's kernel work in the traced window, or None; with
    ``kernel``, None also where the cell measures another kernel."""
    module = reader(run.cell.traffic["driver"], run.cell.config["family"])
    if module is None or kernel not in (None, module.KERNEL):
        return None
    return module.read(run)


def share(work) -> float | None:
    """The kernel's roofline share in %, or None."""
    if work is None:
        return None
    nbytes, ops, seconds = work
    return 100.0 * counts.bound_s(nbytes, ops)[0] / seconds
