"""Probe the port's Collect reset and Maze K-step kernels on one NVIDIA GPU.

    python3 scripts/torch_kernel_probe.py [--reset-variant FILE.cu ...]
                                          [--maze-variant FILE.cu ...]

From the root of a checkout, with a CUDA device and ``nvcc``.  It

1. builds the kernels as ``chip_smoke.py`` does, and each ``collect_reset``
   source (the checkout's and every variant) once more with
   ``-DCOLLECT_RESET_STAMPS`` where it has that switch: it then sums
   per-phase ``clock64()`` stamps over blocks (staging, board fill, chain,
   unpack);
2. checks every build bit-equal to the plain versions at B = 8192 on the
   Collect main config and ``MAZE_MAIN``;
3. prints each stamped reset's phase cycles per block, all rows, B = 8192;
4. times the checkout's ``collect_reset`` and each variant in turns inside
   this process (checkout, variants, variants reversed, checkout, twice):
   all rows, and masked with no row done.  A variant may have the
   checkout's C interface or the one before ``ResetArrays.words`` (the
   wall and rects as bool rows);
5. times ``maze_steps`` (the checkout's and each variant with its C
   interface) at K in (1, 25, 100) and B in (64, 8192), and the one-step
   ``maze_step``, so the launch floor and the per-step latency of one
   env's chain can be read apart.

Times are CUDA events around windows of launches queued behind a device
sleep (``chip_smoke.time_ms``), each beside the card's name and power
limit.  Prints one JSON line of the numbers last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import MAIN, MAZE_MAIN, time_ms  # noqa: E402
from gym_multigrid_tpu_torch.ops import _build, collect_slab, maze_slab  # noqa: E402

B = 8192
DEV = torch.device("cuda", 0)
PHASES = ("staging", "board fill", "chain", "unpack")


def log(*args):
    print(*args, flush=True)


def nvcc_build(source: Path, out: Path, *defines: str) -> ctypes.CDLL:
    """``source`` built as ``_build`` builds it, plus ``defines``."""
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", *defines,
           "-o", str(out), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line:
            log(f"  {source.name} {' '.join(defines)}: {line.strip()}")
    return ctypes.CDLL(str(out))


def entry(lib, source: Path, name: str):
    """``name`` of ``lib`` with argtypes read from its C signature in
    ``source``: pointers c_void_p, ints c_int."""
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', source.read_text()).group(1)
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params.split(",")]
    fn.restype = ctypes.c_int
    return fn


class Reset:
    """One build of ``collect_reset``, called on the main config's slab."""

    def __init__(self, name, source, lib, slab):
        self.name, self.slab, self.lib = name, slab, lib
        self.fn = entry(lib, source, "collect_reset")
        self.bool_rows = len(self.fn.argtypes) == 20  # wall and rects as bool rows

    def __call__(self, rnd, done=None, out=None):
        rt, ra = self.slab.rt, self.slab.reset_arrays
        A, C, nb = 2, rt.n_cells, len(rt.ball_colors)
        if out is None:
            out = [torch.empty((B, C), dtype=torch.int32, device=DEV) for _ in range(3)]
            out.append(torch.empty((B, 2 * A), dtype=torch.int32, device=DEV))
        tables = (ra.wall, ra.ball_rects) if self.bool_rows else (ra.words,)
        err = self.fn(rnd.data_ptr(), *(x.data_ptr() for x in tables), ra.program.data_ptr(),
                      None if done is None else done.data_ptr(), *(o.data_ptr() for o in out),
                      B, rt.width, C, nb, A, int(rt.balls_before_agents), 0,
                      len(rt.agent_fixed), rt.agent_colors[0], rt.agent_colors[1],
                      torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"{self.name}: CUDA error {err}"
        return out

    def phases(self, rnd):
        sums = (ctypes.c_ulonglong * 5)()
        get = self.lib.collect_reset_stamps
        get.argtypes = [ctypes.c_void_p]
        assert get(ctypes.addressof(sums)) == 0
        for _ in range(20):
            self(rnd)
        torch.cuda.synchronize()
        assert get(ctypes.addressof(sums)) == 0
        return {p: sums[i] / sums[4] for i, p in enumerate(PHASES)}


def maze_runner(fn, slab):
    """``maze_steps`` through ``fn`` with ``maze_ms_slab``'s arguments."""
    def run(pos, dirs, sc, run_ret, acts, rnd):
        n, K = pos.shape[0], acts.shape[0]
        outs = (torch.empty_like(pos), torch.empty_like(dirs), torch.empty_like(sc),
                torch.empty_like(run_ret), torch.empty_like(run_ret), torch.empty_like(run_ret),
                torch.empty_like(sc))
        err = fn(pos.data_ptr(), dirs.data_ptr(), sc.data_ptr(), run_ret.data_ptr(),
                 acts.data_ptr(), rnd.data_ptr(), slab.ms_table.data_ptr(),
                 *(o.data_ptr() for o in outs), n, K, slab.t.s1, slab.t.n_cells * 5,
                 slab.bg.shape[1], slab.t.max_steps, torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"maze_steps: CUDA error {err}"
        return outs
    return run


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reset-variant", type=Path, action="append", default=[])
    parser.add_argument("--maze-variant", type=Path, action="append", default=[])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_kernel_probe.py: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log(f"card: {smi}")
    for source, text in _build.build().items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {source}: {line.strip()}")
    kernels = _build.load()
    probe_dir = _build.BUILD_DIR.parent / "probe"
    record = {"card": smi}
    gen = torch.Generator(device=DEV).manual_seed(0)

    # The resets: the checkout's, then the variants, each stamped if it can be.
    slab = collect_slab.make_collect_slab(MAIN, DEV)
    rt, ra = slab.rt, slab.reset_arrays
    rnd = torch.rand((B, slab.reset_draws), generator=gen, device=DEV)
    want = collect_slab.reset_spec(rt, ra.wall, ra.ball_rects, rnd)
    sources = [("checkout", _build.CSRC / "collect_reset.cu")]
    sources += [(path.stem, path) for path in args.reset_variant]
    resets = []
    for i, (name, source) in enumerate(sources):
        resets.append(Reset(name, source, nvcc_build(source, probe_dir / f"reset_{i}.so"), slab))
        builds = [resets[-1]]
        if "COLLECT_RESET_STAMPS" in source.read_text():
            builds.append(Reset(name, source, nvcc_build(
                source, probe_dir / f"reset_{i}_stamps.so", "-DCOLLECT_RESET_STAMPS"), slab))
        for r in builds:
            assert all(torch.equal(g, w) for g, w in zip(r(rnd), want)), f"{name} differs"
        if len(builds) > 1:
            cycles = builds[1].phases(rnd)
            record[f"reset_phase_cycles {name}"] = cycles
            log(f"collect_reset {name} phase cycles per block (all rows, B={B}): "
                + ", ".join(f"{p} {c:.0f}" for p, c in cycles.items()))
    log(f"every collect_reset build == reset_spec at B={B}: bit-equal")
    none_done = torch.zeros(B, dtype=torch.bool, device=DEV)
    outs = resets[0](rnd)
    times = {r.name: [] for r in resets}
    for order in (resets, resets[::-1]) * 2:
        for r in order:
            full, _ = time_ms(lambda: r(rnd), 200)
            masked, _ = time_ms(lambda: r(rnd, done=none_done, out=outs), 200)
            times[r.name].append((full * 1e3, masked * 1e3))
    for name, t in times.items():
        log(f"collect_reset {name}: all rows us {[round(x[0], 2) for x in t]}, masked with "
            f"no row done us {[round(x[1], 2) for x in t]} ({smi})")
    record["reset_us"] = times

    # maze_steps against the launch floor and the chain.
    mslab = maze_slab.make_maze_slab(MAZE_MAIN, DEV)
    mazes = [("checkout", maze_runner(kernels.maze_steps, mslab))]
    for i, path in enumerate(args.maze_variant):
        lib = nvcc_build(path, probe_dir / f"maze_{i}.so")
        mazes.append((path.stem, maze_runner(entry(lib, path, "maze_steps"), mslab)))
    maze = {}
    for n in (64, B):
        st = maze_slab.reset_batch(mslab, n, generator=gen)
        one = (mslab.t, st.pos, st.dir.reshape(n, 1),
               torch.zeros((n, 1), dtype=torch.int32, device=DEV), mslab.cells)
        maze[f"maze_step B={n}"] = time_ms(lambda: maze_slab.maze_step_slab(*one), 200)[0] * 1e3
        for K in (1, 25, 100):
            a = torch.randint(-1, 7, (K, n), generator=gen, device=DEV, dtype=torch.int32)
            r = torch.rand((K, n), generator=gen, device=DEV)
            ms = (st.pos, st.dir, st.step_count, torch.rand(n, generator=gen, device=DEV), a, r)
            ms_want = maze_slab.ms_spec(mslab.t, K, *ms, mslab.cells, mslab.bg)
            for name, run in mazes:
                assert all(torch.equal(g, w) for g, w in zip(run(*ms), ms_want)), name
                maze[f"maze_steps {name} K={K} B={n}"] = time_ms(lambda: run(*ms), 200)[0] * 1e3
    log(f"every maze_steps build == ms_spec at K in (1, 25, 100), B in (64, {B}): bit-equal")
    for key, t in maze.items():
        log(f"{key}: {t:.2f} us/launch ({smi})")
    record["maze_us"] = maze
    log(json.dumps(record))


if __name__ == "__main__":
    main()
