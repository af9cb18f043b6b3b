"""Build and load the port's CUDA kernels.

Each source in ``gym_multigrid_tpu_torch/csrc/`` is compiled by ``nvcc``
into a shared library with a plain C interface, under ``build/kernels/`` at
the root of the checkout (or a per-user cache directory when the package is
installed), and loaded with ``ctypes``.  A library's name
carries a hash of its source and the flags, so an edited source is rebuilt
and an unchanged one is not.  Nothing is built when the package is
imported: :func:`load` builds at first use, every missing library at once,
one ``nvcc`` process per source.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"


def _build_dir() -> Path:
    """``build/kernels/`` of the checkout the package runs from; for an
    installed package, a per-user cache directory."""
    root = Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").is_file():
        return root / "build" / "kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "gym_multigrid_tpu_torch" / "kernels"


BUILD_DIR = _build_dir()
# No --use_fast_math: the kernels must round their float32 products and
# sums (the respawn and move-order picks, the rewards) as the plain
# versions do.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: source file -> {C entry point: its argument types}.  Pointers and the
#: stream are c_void_p, so ctypes does not cut them to 32 bits; a Python
#: float passed as c_float is rounded to float32 once.
ENTRY_POINTS = {
    "collect_step.cu": {"collect_step": [_P] * 12 + [_I] * 9 + [_P]},
    "collect_steps.cu": {"collect_steps_philox": [_P] * 10 + [_I] * 20 + [_P]},
    "collect_reset.cu": {"collect_reset": [_P] * 8 + [_I] * 10 + [_P]},
    "ctf_step.cu": {
        "ctf_step": [_P] * 21 + [_I] * 17 + [_F] * 7 + [_P],
        "ctf_steps": [_P] * 21 + [_I] * 20 + [_F] * 7 + [_P],
    },
    "maze_step.cu": {
        "maze_step": [_P] * 9 + [_I] * 4 + [_F] * 3 + [_P],
        "maze_steps_philox": [_P] * 15 + [_I] * 8 + [_P],
    },
    "wildfire_step.cu": {
        "wildfire_step": [_P] * 9 + [_I] * 5 + [_F] * 8 + [_P],
        "wf_steps_philox": [_P] * 13 + [_I] * 10 + [_F] * 9 + [_P],
        "wf_autoreset": [_P] * 14 + [_I] * 13 + [_F] + [_P],
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME: the CUDA kernels of "
        "gym_multigrid_tpu_torch cannot be built"
    )


def library_path(source: str) -> Path:
    """Where ``source`` builds to: named by a hash of the source, the
    headers it may include and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / source, *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def build() -> dict[str, str]:
    """Compile every kernel library that is missing, in parallel.

    Returns {source: compiler output} for what was built (``-Xptxas -v``
    reports each kernel's registers and spills there).  Raises with the
    compiler's output if any source fails to compile."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for source in ENTRY_POINTS:
        out = library_path(source)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((source, proc, tmp, out))
    logs, failed = {}, []
    for source, proc, tmp, out in jobs:
        logs[source] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        else:
            failed.append(f"{source} (nvcc exit {proc.returncode}):\n{logs[source]}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def default_device(device, name: str):
    """``device``, or the current CUDA device when it is None; with no
    CUDA device and no explicit ``device`` this raises.  ``name`` is the
    caller, for the message."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{name} runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch version"
            )
        device = torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def check_arg(name, x, dtype, shape, device):
    """Raise unless tensor ``x`` is what a kernel argument must be: a
    contiguous ``dtype`` tensor of ``shape`` on ``device``."""
    if (
        x.device != device
        or x.dtype != dtype
        or tuple(x.shape) != tuple(shape)
        or not x.is_contiguous()
    ):
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}, got {x.dtype} {tuple(x.shape)} on "
            f"{x.device} (contiguous={x.is_contiguous()})"
        )


def call_on(device: torch.device, entry, *args) -> int:
    """``entry(*args, stream)`` with ``device`` current and its current
    stream last: a kernel entry's launch, for wrappers on a per-step path.
    The raw stream handle and the device index are read without building
    a ``torch.cuda.Stream`` or entering a device guard where ``device`` is
    current already; returns the entry's CUDA error code."""
    stream = torch._C._cuda_getCurrentRawStream(device.index)
    if device.index == torch.cuda.current_device():
        return entry(*args, stream)
    with torch.cuda.device(device):
        return entry(*args, stream)


@functools.cache
def load() -> SimpleNamespace:
    """Build what is missing and return the C entry points by name."""
    build()
    fns = {}
    for source, entries in ENTRY_POINTS.items():
        lib = ctypes.CDLL(str(library_path(source)))
        for name, argtypes in entries.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
    return SimpleNamespace(**fns)
