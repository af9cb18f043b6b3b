"""Tracing and profiling helpers (PyTorch port).

Counterpart of ``gym_multigrid_tpu/utils/profiling.py``, on
``torch.profiler``:

* :func:`trace`: profile a block and write a Chrome trace (Perfetto and
  ``chrome://tracing`` load it); the block's wall time is kept as a
  labelled range, which :func:`summarize_profile` reads.
* :func:`annotate`: ``record_function``, so that a phase shows up by name.
* :func:`sol_report`: speed-of-light accounting of a batched env step
  against the card's memory rate.
* :func:`summarize_profile`: device time by kernel and by class of
  kernel, launches, wall and the device's idle share of a profiled block
  (in place of JAX's ``summarize_xplane``).
* :func:`collective_events`: the collectives the block issued, which
  ``parallel/comm_audit.py`` reads.
* :func:`timed`, :func:`card_label` and :func:`card_chip`: the seconds a
  block of device work takes, the card it ran on, and that card's key in
  the tables of peak rates, for the measurement scripts.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch.autograd import DeviceType

from gym_multigrid_tpu_torch.utils.misc import tree_leaves

__all__ = ["MEM_BYTES_PER_S", "Collective", "SolEstimate", "annotate", "card_chip",
           "card_label", "collective_events", "sol_report", "state_nbytes",
           "summarize_profile", "timed", "trace"]

#: Peak memory rate of one card, bytes/s (NVIDIA's data sheet: the H100
#: SXM's 3.35 TB/s of HBM3).
MEM_BYTES_PER_S = {"h100-sxm": 3.35e12}

#: The range :func:`trace` wraps around its block.
WINDOW = "profiled block"
#: Name prefixes of the port's own CUDA kernels in a trace (a template
#: kernel's name starts with its return type).
PORT_KERNELS = ("void collect::", "void ctf::", "maze::", "void wildfire::")
#: The classes of ``summarize_profile``'s ``by_class`` after the port's own
#: kernels, each with the fragments of the kernel names it takes, tried in
#: this order: cuBLAS's and CUTLASS's products (``nvjet`` is cuBLAS's name
#: for its Hopper GEMMs), then PyTorch's copies, concatenations and
#: gathers.  A kernel that none names is ``other``.
KERNEL_CLASSES = (
    ("matmul", ("gemm", "cutlass", "xmma", "cublas", "nvjet")),
    ("copy", ("copy", "Copy", "cat", "Cat", "gather")),
)
#: Process-group backends whose collectives the profiler records as
#: ``<backend>:<op>``.
COLLECTIVE_BACKENDS = ("gloo", "nccl")


def card_chip(device) -> str | None:
    """The key of ``device``'s card in the tables of peak rates
    (:data:`MEM_BYTES_PER_S`): ``"h100-sxm"`` for an H100 SXM, whose name
    torch reports as ``NVIDIA H100 80GB HBM3`` (the PCIe and NVL parts
    carry their form in the name); None for any other device."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    if "H100" in name and ("HBM3" in name or "SXM" in name):
        return "h100-sxm"
    return None


def kernel_class(name: str) -> str:
    """The class of a kernel in ``summarize_profile``'s ``by_class``:
    ``port_kernels`` (:data:`PORT_KERNELS`), a class of
    :data:`KERNEL_CLASSES`, or ``other``."""
    if name.startswith(PORT_KERNELS):
        return "port_kernels"
    for cls, fragments in KERNEL_CLASSES:
        if any(f in name for f in fragments):
            return cls
    return "other"


def card_label(device) -> str:
    """What a measurement ran on: ``"cpu"``, or the card's name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them (the name alone, from torch,
    where ``nvidia-smi`` cannot be run)."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or f"{torch.cuda.get_device_name(index)}, power limit not read"


class Timed(NamedTuple):
    result: object
    seconds: float


def timed(device, fn) -> Timed:
    """``fn()`` and the seconds it took: on a card between two CUDA events
    recorded around it, with one synchronise after it; on the CPU by the
    host clock."""
    device = torch.device(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        result = fn()
        return Timed(result, time.perf_counter() - t0)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    end.synchronize()
    return Timed(result, start.elapsed_time(end) / 1e3)


@contextlib.contextmanager
def trace(log_dir: str | None = None, record_shapes: bool = False):
    """Profile a block: ``with trace("/tmp/trace") as prof: run(...)``.

    Records the host and, where CUDA is available, the device; the block
    ends with a synchronise, so its device work falls inside.  With
    ``log_dir`` the Chrome trace goes to ``<log_dir>/trace.json``.
    ``record_shapes`` keeps each op's input shapes and dtypes (the
    collectives' operands, for :func:`collective_events`)."""
    kinds = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        kinds.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=kinds, record_shapes=record_shapes) as prof:
        with torch.profiler.record_function(WINDOW):
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named range for a phase (shows up in profiler timelines)."""
    return torch.profiler.record_function(name)


@dataclass(frozen=True)
class SolEstimate:
    achieved_steps_per_s: float
    ceiling_steps_per_s: float
    sol_fraction: float
    bytes_per_step: int


def sol_report(
    env_steps_per_s: float,
    state_bytes: int,
    batch_size: int,
    chip: str = "h100-sxm",
    rw_factor: float = 2.0,
) -> SolEstimate:
    """Bandwidth-bound speed of light of a lockstep env batch.

    ``state_bytes`` is the WHOLE batched state; one batched step must read
    and write it once (``rw_factor = 2``).  The fraction compares measured
    batched steps/s (``env_steps_per_s / batch_size``) with
    ``bandwidth / (rw_factor * state_bytes)``.  ``chip`` names an entry of
    :data:`MEM_BYTES_PER_S`; any other raises."""
    if chip not in MEM_BYTES_PER_S:
        raise ValueError(f"unknown chip {chip!r}; known: {sorted(MEM_BYTES_PER_S)}")
    bw = MEM_BYTES_PER_S[chip]
    bytes_per_step = int(rw_factor * state_bytes)
    ceiling = bw / max(bytes_per_step, 1)
    batched_steps_per_s = env_steps_per_s / max(batch_size, 1)
    return SolEstimate(
        achieved_steps_per_s=batched_steps_per_s,
        ceiling_steps_per_s=ceiling,
        sol_fraction=batched_steps_per_s / ceiling,
        bytes_per_step=bytes_per_step,
    )


def state_nbytes(tree) -> int:
    """Total bytes of the tensors of a (batched) state tree."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def summarize_profile(prof, top: int = 12) -> dict:
    """Where the time of a :func:`trace` block went.

    - ``wall_us``: the block's wall time, synchronise included;
    - ``device``: ``"cuda"`` when the trace holds device kernels, else
      ``"cpu"``, and then every device field below is None (not measured);
    - ``device_us``: the kernels' summed device self time; ``launches``:
      their count; ``idle_share``: 1 - ``device_us / wall_us``;
    - ``kernels``: the ``top`` longest kernels as (name, us, count), and
      ``port_kernels``: the port's own kernels wherever they rank, as
      (rank, name, us, count);
    - ``by_class``, only where the trace holds device kernels (absent, so
      ``None`` to ``.get``, on the CPU): each class of :func:`kernel_class`
      (``matmul``, ``copy``, ``port_kernels``, ``other``) with its share
      of the device time of all kernels, not only of the ``top``;
    - ``host_ops``: the ``top`` host ops by self CPU time, (name, us, count).

    A device-side user range (the optimizer's step, this block's own)
    spans kernels already counted, so only kernels are summed."""
    averages = prof.key_averages()
    windows = [e for e in prof.events() if e.name == WINDOW and e.device_type == DeviceType.CPU]
    if not windows:
        raise ValueError("summarize_profile reads a profile taken with trace()")
    wall_us = windows[0].time_range.elapsed_us()
    rows = sorted(
        ((e.key, e.self_device_time_total, e.count) for e in averages
         if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)),
        key=lambda r: -r[1],
    )
    host = sorted(
        ((e.key, e.self_cpu_time_total, e.count) for e in averages
         if e.device_type == DeviceType.CPU and e.key != WINDOW),
        key=lambda r: -r[1],
    )
    busy_us = sum(r[1] for r in rows)
    on_device = busy_us > 0
    summary = {
        "wall_us": wall_us,
        "device": "cuda" if on_device else "cpu",
        "device_us": busy_us if on_device else None,
        "launches": sum(r[2] for r in rows) if on_device else None,
        "idle_share": 1 - busy_us / wall_us if on_device else None,
        "kernels": rows[:top],
        "port_kernels": [(i + 1, *r) for i, r in enumerate(rows) if r[0].startswith(PORT_KERNELS)],
        "host_ops": host[:top],
    }
    if on_device:
        by_class = dict.fromkeys(("matmul", "copy", "port_kernels", "other"), 0.0)
        for name, dev_us, _ in rows:
            by_class[kernel_class(name)] += dev_us / busy_us
        summary["by_class"] = by_class
    return summary


class Collective(NamedTuple):
    """A collective the profiler recorded: ``gloo:<op>`` or ``nccl:<op>``,
    its operands' shapes and dtype names (C++ names: ``float``,
    ``double``, ``unsigned char``), and when it was issued."""

    name: str
    shapes: list
    dtypes: list
    start_ns: int


def collective_events(prof) -> list[Collective]:
    """The collectives a profiled block issued, in issue order, read from
    the profiler's own event records (operand shapes and dtypes where the
    profile recorded shapes)."""
    events = [
        Collective(e.name(), list(e.shapes()), list(e.dtypes()), e.start_ns())
        for e in prof.profiler.kineto_results.events()
        if ":" in e.name() and e.name().split(":", 1)[0] in COLLECTIVE_BACKENDS
    ]
    return sorted(events, key=lambda e: e.start_ns)
