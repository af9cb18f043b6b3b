"""Probe the port's Collect reset and K-step kernels on one NVIDIA GPU.

    python3 scripts/torch_kernel_probe.py [--reset-variant FILE.cu ...]
                                          [--collect-variant FILE.cu ...]
                                          [--maze-variant FILE.cu ...]
                                          [--maze-philox-variant FILE.cu ...]
                                          [--ctf-variant FILE.cu ...]
                                          [--wf-variant FILE.cu ...]
                                          [--only reset|collect|maze|ctf|wildfire ...]
    python3 scripts/torch_kernel_probe.py --only isolated [--after-checks]
    python3 scripts/torch_kernel_probe.py --only rollouts
    python3 scripts/torch_kernel_probe.py --only collect_episode
    python3 scripts/torch_kernel_probe.py --only render

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
5. checks ``maze_steps_philox`` at each of its builds (Q = 1, 2 and 4
   draw threads an env at a window of W = 16 steps, and W = 8 and 32 at
   Q = 2: the checkout's source built with ``-DMAZE_STEPS_PRODUCERS=Q``
   and ``-DMAZE_STEPS_WINDOW=W``, the port's build where both are its
   defaults) bit-equal to ``ms_philox_spec`` on ``MAZE_MAIN`` (K in (1,
   25, 100) from an even and an odd step, B in (64, 8192)), times each
   there, then every build in turns at K = 100 and B = 8192 (in order,
   then reversed, twice) with each ``--maze-philox-variant`` (a source
   with the checkout's ``maze_steps_philox`` interface, checked the same
   way) and each
   ``--maze-variant`` (a source with the pre-drawn entry ``maze_steps``,
   such as an older checkout's ``maze_step.cu``: checked against
   ``ms_spec`` on pre-drawn draws and timed alone and with the chunk's two
   draws, ``torch.randint`` and ``torch.rand``, as its episode path made
   them); and checks the one-step ``maze_step`` at blocks of 64, 128 (the
   port's build) and 256 threads (``-DMAZE_STEP_THREADS``) and each
   variant's (its C interface without the table) bit-equal to
   ``step_spec`` with invalid ids mixed in, and times them in turns at
   B = 8192 beside the launch floor, so that the floor and the per-step
   latency of one env's chain can be read apart; and writes the SASS of
   ``maze_steps_philox``'s kernel in the port's build to ``chiprun_out/``
   with the static instructions of its largest loop (the chain's window);
6. checks ``collect_steps_philox`` at each of its lanes an env (G = 4,
   the checkout's build, and G = 1 and 8, the checkout's source built with
   ``-DCOLLECT_STEPS_GROUP=1`` or ``8``) bit-equal to ``ms_philox_spec``
   on the Collect main config (K in (1, 25, 50) from 25 steps before an
   episode's end, B in (64, 8192)),
   times each G there, then times every G and each ``--collect-variant``
   (a source with the pre-drawn entry ``collect_steps``, such as an older
   checkout's ``collect_step.cu``: checked against ``ms_spec`` on
   pre-drawn uniforms) in turns at K = 25 and B = 8192 (checkout G in
   order, variants, then reversed, twice; a timed call is two launches,
   the new entry's second ending an episode, and a launch is half of it),
   and prints the per-phase ``clock64()`` cycles of thread 0 of each block
   of a copy of the checkout's ``collect_steps.cu`` with stamps put in
   (staging, the boards and empty words, the step loop, the fresh boards
   inside it, the write-back), summed over blocks, at each G, and times
   copies that do one cost twice with the trajectory unchanged (the
   draws, the respawn pick, the read of the entered cell; the copy's
   result folded into a value never written), in turns with the
   checkout's build: the extra time is that cost;
   then does the same for ``ctf_steps`` at ``CTF_MAIN`` and at ``CTF_PATROL`` (K in
   (1, 50)) and ``wf_steps_philox`` at ``WF_MAIN`` (K in (1, 24)), each
   build checked bit-equal to its plain version (``ms_spec``;
   ``ms_philox_spec``, the same steps on ``ops/philox.py``'s draws), beside
   the one-step ``collect_step``, ``ctf_step`` and ``wildfire_step``; at
   B = 8192 and the full chunk the checkout's build and each variant are
   timed in turns (checkout, variants, variants reversed, checkout,
   twice).  A variant has the checkout's C interface; a ``ctf_steps``
   variant may have the one from before the slab's ``steps_table``.  The
   ``ctf_steps`` builds are the checkout's, the checkout's source in its
   lane-group layout (``-DCTF_STEPS_GROUP=1``) and the variants; for each,
   the static SASS instructions of the largest step loop of its 2v2
   instance (the chain's, where a warp decodes beside it; ``cuobjdump
   -sass``, that kernel's SASS written to ``chiprun_out/``).

``--only`` runs the named sections (default: all but ``isolated``).
``--only isolated`` times the host-bound paths of ``chip_smoke.py`` alone
in this fresh process, as its phase 3 times them: the Collect and Maze
episode paths, the Collect and CtF training paths, evaluation and
self-play, then the vector envs where the checkout has them
(``chip_smoke.run_vector_envs``).  ``--after-checks`` first runs the
gymnasium-facing checks of its phase 2 (the per-env functions, the
host-policy path, ``next_step_autoreset`` on each family).  The probe
reads ``chip_smoke.py`` and the package of the checkout it sits in, so a
copy of this file put in another checkout's ``scripts/`` times that one
(an older checkout without those checks takes no ``--after-checks``).
``--only rollouts`` times the four ``BatchedEnv`` rollouts, the Collect
and Wildfire episode paths and the vector envs the same way (a copy of the
probe in another checkout's ``scripts/`` times that one: same-call
parent/change pairs).  ``--only collect_episode`` times the Collect episode
path alone, at chunks of 25 and of 50 in turns (25, 50, 50, 25).  ``--only render`` times each family's batch render at B = 8192,
T = 32 (``chip_smoke.RENDER_CASES``) beside the gathers it was chosen
over, each checked equal to it: a gather indexed by a materialised
(B, H, T, W) row tensor (bytes, and 8-byte words), and a two-pass gather
(``bank[ids]``, then a permuted copy; its first pass alone too).

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

from chip_smoke import CTF_MAIN, CTF_PATROL, MAIN, MAZE_MAIN, WF_MAIN, time_ms  # noqa: E402
from gym_multigrid_tpu_torch.envs.wildfire import ignite_thresholds  # noqa: E402
from gym_multigrid_tpu_torch.ops import (  # noqa: E402
    _build,
    collect_slab,
    ctf_slab,
    maze_slab,
    philox,
    wildfire_slab,
)

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
    ``source``: pointers c_void_p, floats c_float, ints c_int."""
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', source.read_text()).group(1)
    fn = getattr(lib, name)
    fn.argtypes = [
        ctypes.c_void_p if "*" in p else ctypes.c_float if p.split()[0] == "float" else ctypes.c_int
        for p in params.split(",")
    ]
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
    """The pre-drawn entry ``maze_steps`` of an older ``maze_step.cu``
    through ``fn``, with ``ms_spec``'s arguments and results."""
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


def ctf_runner(fn, slab, source: Path):
    """``ctf_steps`` through ``fn`` with ``ctf_ms_slab``'s arguments, in the
    C interface of ``source``: the slab's ``steps_table``, or (a source from
    before it) the flag bytes, the border, the pool and the territories."""
    t = slab.t
    kinds, p_opt = ctf_slab._policy_arrays(t, DEV)
    params = re.search(r'extern "C" int ctf_steps\(([^)]*)\)', source.read_text()).group(1)
    packed = "table" in params

    def run(pos, dirs, term, coll, sc, run_ret, acts, rnd_step, rnd_reset):
        n, K = pos.shape[0], acts.shape[0]
        outs = (torch.empty_like(pos), torch.empty_like(dirs), torch.empty_like(term),
                torch.empty_like(coll), torch.empty_like(sc), torch.empty_like(run_ret),
                torch.empty_like(run_ret), torch.empty_like(run_ret), torch.empty_like(sc))
        if packed:
            tables, counts = (slab.steps_table, kinds, p_opt), (slab.pool.shape[1],)
        else:
            tables = (slab.flags, slab.border, slab.pool, slab.bterr, slab.rterr, kinds, p_opt)
            counts = (slab.border.shape[1], slab.pool.shape[1])
        err = fn(*(x.data_ptr() for x in (pos, dirs, term, coll, sc, run_ret, acts, rnd_step,
                                           rnd_reset, *tables)),
                 *(o.data_ptr() for o in outs), n, K, t.n_blue, t.n_red, int(t.mvn), t.s0, t.s1,
                 t.bound0, t.bound1, *t.blue_flag, *t.red_flag, *counts, ctf_slab.rnd_width(t),
                 int(t.mvn and t.obstacle_penalty != 0), int(not t.mvn and t.obstacle_penalty != 0),
                 slab.bterr.shape[1], slab.rterr.shape[1], t.max_steps,
                 t.battle_range * t.battle_range, t.randomness, 1.0 - t.randomness,
                 t.flag_reward, t.battle_reward, t.obstacle_penalty,
                 t.step_penalty * t.n_blue if t.mvn else t.step_penalty,
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"ctf_steps: CUDA error {err}"
        return outs
    return run


def sass_loop(lib: Path, kernel: str, out: Path) -> int | None:
    """Static SASS instructions of the largest loop of the kernel whose
    mangled name matches the regular expression ``kernel`` in ``lib``
    (``cuobjdump -sass``): for a K-step kernel, the body of its loop over
    the steps.  That kernel's SASS goes to ``out``.  None where the kernel
    or a loop is not found."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300).stdout
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        if not re.search(kernel, func.split("\n", 1)[0]):
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(func)
        addrs, labels, branches = [], {}, []
        pending = []
        for line in func.splitlines():
            label = re.match(r"\s*(\.L_x_\d+):", line)
            if label:
                pending.append(label.group(1))
                continue
            m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if not m:
                continue
            addr = int(m.group(1), 16)
            addrs.append(addr)
            for name in pending:
                labels[name] = addr
            pending = []
            target = re.search(r"\bBRA\b.*?(?:`\((\.L_x_\d+)\)|0x([0-9a-f]+))", m.group(2))
            if target:
                branches.append((addr, target.group(1) or int(target.group(2), 16)))
        loops = [(src, labels.get(dst, dst)) for src, dst in branches]
        loops = [(src, dst) for src, dst in loops if isinstance(dst, int) and dst < src]
        if not loops:
            return None
        src, dst = max(loops, key=lambda sd: sd[0] - sd[1])
        return sum(dst <= a <= src for a in addrs)
    return None


def collect_runner(fn, slab):
    """The pre-drawn entry ``collect_steps`` of an older ``collect_step.cu``
    through ``fn``, with ``ms_spec``'s arguments and results."""
    t = slab.t

    def run(go, gc, gs, pos, acts, rnd):
        n, K, A = go.shape[0], acts.shape[0], acts.shape[2]
        n_types = slab.info_ids.shape[0]
        outs = (torch.empty_like(go), torch.empty_like(gc), torch.empty_like(gs),
                torch.empty_like(pos), torch.empty((n, A), device=DEV),
                torch.empty((n, A * n_types), dtype=torch.int32, device=DEV))
        err = fn(*(x.data_ptr() for x in (go, gc, gs, pos, acts, rnd, slab.respawn_rects,
                                           slab.slot_rewards, slab.slot_info)),
                 *(o.data_ptr() for o in outs), n, K, t.width, t.height, A, int(t.respawn),
                 slab.respawn_rects.shape[0], t.respawn_slot_base, t.agent_colors[0],
                 t.agent_colors[1 % A], slab.slot_rewards.shape[0], n_types,
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"collect_steps: CUDA error {err}"
        return outs
    return run


def wf_philox_runner(fn, slab):
    """``wf_steps_philox`` through ``fn`` with ``wf_philox_slab``'s
    arguments."""
    t = slab.t

    def run(cells, pos, sc, ext, run_ret, key, step0, K):
        n = cells.shape[0]
        outs = (torch.empty_like(cells), torch.empty_like(pos), torch.empty_like(sc),
                torch.empty_like(ext), torch.empty_like(run_ret), torch.empty_like(run_ret),
                torch.empty_like(run_ret), torch.empty_like(sc))
        err = fn(*(x.data_ptr() for x in (cells, pos, sc, ext, run_ret)),
                 *(o.data_ptr() for o in outs), n, K, t.width, t.height, t.n_agents, t.n_fires,
                 t.max_steps, *(philox.signed(w) for w in (*key, step0)),
                 *ignite_thresholds(t)[1:], t.p_burnout, t.ext_reward,
                 t.burn_penalty, t.step_penalty, t.tree_density,
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"wf_steps_philox: CUDA error {err}"
        return outs
    return run


def probe_steps(family, runners, make_args, spec, one_step, ks, smi):
    """The K-step section of one family: every build bit-equal to ``spec``
    at each K in ``ks`` and B in (64, 8192), the checkout's build timed
    there beside ``one_step(n)``, then every build timed in turns at the
    largest K and B = 8192.  Returns {key: us}."""
    out = {}
    chunk = max(ks)
    for n in (64, B):
        out[f"{family} one step B={n}"] = time_ms(one_step(n), 200)[0] * 1e3
        for K in ks:
            args = make_args(n, K)
            want = spec(K, args)
            for name, run in runners:
                assert all(torch.equal(g, w) for g, w in zip(run(*args), want)), name
            out[f"{family} K-step checkout K={K} B={n}"] = (
                time_ms(lambda: runners[0][1](*args), 100)[0] * 1e3)
    log(f"every {family} K-step build == its plain version at K in {ks}, B in (64, {B}): "
        "bit-equal")
    args = make_args(B, chunk)
    turns = {name: [] for name, _ in runners}
    for order in (runners, runners[::-1]) * 2:
        for name, run in order:
            turns[name].append(time_ms(lambda: run(*args), 100)[0] * 1e3)
    for key, t in out.items():
        log(f"{key}: {t:.2f} us/launch ({smi})")
    for name, t in turns.items():
        log(f"{family} K-step {name}, K={chunk}, B={B}, in turns: us {[round(x, 2) for x in t]} "
            f"({smi})")
        out[f"{family} K-step {name} K={chunk} B={B} turns"] = t
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reset-variant", type=Path, action="append", default=[])
    parser.add_argument("--collect-variant", type=Path, action="append", default=[])
    parser.add_argument("--maze-variant", type=Path, action="append", default=[])
    parser.add_argument("--maze-philox-variant", type=Path, action="append", default=[])
    parser.add_argument("--ctf-variant", type=Path, action="append", default=[])
    parser.add_argument("--wf-variant", type=Path, action="append", default=[])
    parser.add_argument("--only", action="append", default=[],
                        choices=("reset", "collect", "maze", "ctf", "wildfire", "isolated",
                                 "rollouts", "collect_episode", "render"))
    parser.add_argument("--after-checks", action="store_true")
    args = parser.parse_args()
    sections = set(args.only or ("reset", "collect", "maze", "ctf", "wildfire"))
    if args.after_checks and "isolated" not in sections:
        parser.error("--after-checks goes with --only isolated")
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

    if "isolated" in sections:
        probe_isolated(args.after_checks)
    if "rollouts" in sections:
        probe_rollouts()
    if "collect_episode" in sections:
        probe_collect_episode(smi)
    if "render" in sections:
        record.update(probe_render(smi))
    if "reset" in sections:
        record.update(probe_resets(args.reset_variant, probe_dir, gen, smi))
    if "collect" in sections:
        record.update(probe_collect(args.collect_variant, probe_dir, gen, smi))
    if "maze" in sections:
        record.update(probe_maze(args.maze_variant, args.maze_philox_variant, kernels,
                                 probe_dir, gen, smi))
    if "ctf" in sections:
        record.update(probe_ctf(args.ctf_variant, kernels, probe_dir, gen, smi))
    if "wildfire" in sections:
        wslab = wildfire_slab.make_wildfire_slab(WF_MAIN, DEV)
        runners = [("checkout", wf_philox_runner(kernels.wf_steps_philox, wslab))]
        for i, path in enumerate(args.wf_variant):
            lib = nvcc_build(path, probe_dir / f"wf_{i}.so")
            runners.append((path.stem, wf_philox_runner(entry(lib, path, "wf_steps_philox"),
                                                        wslab)))

        def wf_one(n):
            st = wildfire_slab.reset_batch(wslab, n, generator=gen)
            acts = torch.randint(0, 5, (n, 2), generator=gen, device=DEV, dtype=torch.int32)
            rnd = torch.rand((n, wslab.step_draws), generator=gen, device=DEV)
            return lambda: wildfire_slab.wildfire_step_slab(
                wslab.t, st.cells.reshape(n, -1), st.agent_pos.reshape(n, -1), acts, rnd)

        def philox_args(n, K):
            key = philox.key_of(n + K)
            st = wildfire_slab.reset_batch(wslab, n, rnd=philox.first_reset_draws(
                key, n, wslab.t.n_cells, wildfire_slab.fresh_picks(wslab.t), DEV))
            return (st.cells.reshape(n, -1), st.agent_pos.reshape(n, -1), st.step_count,
                    st.extinguished, torch.zeros(n, device=DEV), key, 100, K)

        record.update(probe_steps(
            "wildfire philox", runners, philox_args,
            lambda K, a: wildfire_slab.ms_philox_spec(wslab.t, K, *a[:7]), wf_one, (1, 24), smi))
    log(json.dumps(record))


#: Lanes an env of ``collect_steps_philox``'s builds: the port's
#: (``COLLECT_STEPS_GROUP`` unset in ``collect_steps.cu``), then the others.
COLLECT_LANES = 4
COLLECT_GROUPS = (1, COLLECT_LANES, 8)
#: Phases of the stamped ``collect_steps.cu`` (:func:`stamped_collect_steps`).
COLLECT_PHASES = ("staging", "boards and empty words", "step loop", "fresh boards in it",
                  "write-back")


def stamped_collect_steps(text: str) -> str:
    """``collect_steps.cu`` with ``clock64()`` stamps of thread 0 of each
    block summed into a device array (COLLECT_PHASES, then the blocks),
    read and cleared by the added entry ``collect_steps_stamps(out)``.
    Raises where the source no longer has the marks the stamps go at."""
    def put(text, mark, new):
        if text.count(mark) != 1:
            raise ValueError(f"collect_steps.cu: no single {mark[:40]!r} to stamp at")
        return text.replace(mark, new)

    text = put(text, "template <int NK, int A>\n__global__",
               "__device__ unsigned long long g_st[6];\n\ntemplate <int NK, int A>\n__global__")
    text = put(text, "  extern __shared__ int smem[];\n",
               "  extern __shared__ int smem[];\n  long long st_s[5] = {0, 0, 0, 0, 0};\n"
               "  long long st_t = clock64();\n")
    text = put(text, "  copy_async::wait<0>();\n  __syncthreads();\n",
               "  copy_async::wait<0>();\n  __syncthreads();\n"
               "  st_s[0] = clock64() - st_t; st_t = clock64();\n")
    text = put(text, "  const int W = q.W, H = q.H;\n",
               "  st_s[1] = clock64() - st_t; st_t = clock64();\n  const int W = q.W, H = q.H;\n")
    call = "        fresh_board<NK, A>(sm, q, C, e, g, b, q.step0 + (unsigned)(k0 + j), empty, x, y);\n"
    text = put(text, call, "        const long long st_a = clock64();\n" + call
               + "        st_s[3] += clock64() - st_a;\n")
    text = put(text, "  if (live && g == 0) {\n    int* qp = q.pos_out",
               "  st_s[2] = clock64() - st_t; st_t = clock64();\n"
               "  if (live && g == 0) {\n    int* qp = q.pos_out")
    text = put(text, "    dst[i] = sm.stage[r * R + c];\n  }\n}\n",
               "    dst[i] = sm.stage[r * R + c];\n  }\n  __syncthreads();\n"
               "  st_s[4] = clock64() - st_t;\n  if (threadIdx.x == 0) {\n"
               "    for (int i = 0; i < 5; ++i) atomicAdd(&g_st[i], (unsigned long long)st_s[i]);\n"
               "    atomicAdd(&g_st[5], 1ull);\n  }\n}\n")
    return text + (
        '\nextern "C" int collect_steps_stamps(void* out) {\n'
        "  cudaError_t err = cudaMemcpyFromSymbol(out, collect::g_st, sizeof(collect::g_st));\n"
        "  if (err == cudaSuccess) {\n    const unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};\n"
        "    err = cudaMemcpyToSymbol(collect::g_st, zero, sizeof(zero));\n  }\n"
        "  return (int)err;\n}\n")


def twice_collect_steps(text: str) -> dict:
    """Copies of ``collect_steps.cu`` that do one cost twice, the second
    result folded into a value that is never written, so the trajectory
    and every output stay the checkout's: {name: source}."""
    def put(text, mark, new):
        if text.count(mark) != 1:
            raise ValueError(f"collect_steps.cu: no single {mark[:40]!r} to double")
        return text.replace(mark, new)

    text = put(text, "  int phase = q.phase0;  // the episode's step count before each step\n",
               "  int phase = q.phase0;  // the episode's step count before each step\n"
               "  unsigned sink = 0u;\n")
    text = put(text, "  if (live && g == 0) {\n    int* qp = q.pos_out",
               "  if (sink == 0x1234567u && threadIdx.x == 100000) q.ret_out[0] = 1.f;\n"
               "  if (live && g == 0) {\n    int* qp = q.pos_out")
    draw = "    const Draws next = draw(b, q.step0 + (unsigned)(k0 + kLanes + g), q);\n"
    pick = "            const int at = pick<NK>(m, s == 0 ? d.u1 : d.u2);\n"
    read = "        const int cell = *to;\n"
    return {
        "draws": put(text, draw, draw + (
            "    {\n      Params q2 = q;\n      q2.key0 ^= 0x5bd1e995u;\n"
            "      const Draws extra = draw(b, q.step0 + (unsigned)(k0 + kLanes + g), q2);\n"
            "      sink ^= (unsigned)extra.a0 ^ (unsigned)extra.a1 ^ __float_as_uint(extra.u0) ^\n"
            "              __float_as_uint(extra.u1) ^ __float_as_uint(extra.u2);\n    }\n")),
        "respawn pick": put(text, pick, pick + (
            "            sink ^= (unsigned)pick<NK>(m, 1.0f - (s == 0 ? d.u1 : d.u2) * 0.5f);\n")),
        "entered cell's read": put(text, read, read + (
            "        sink ^= (unsigned)sm.board[((nidx + 1) % (W * H)) * kEnvs + e];\n")),
    }


def collect_philox_call(fn, slab):
    """``collect_steps_philox`` of another build through ``fn``, with
    ``collect_philox_slab``'s arguments and results."""
    t, rt, ra, cfg = slab.t, slab.rt, slab.reset_arrays, slab.cfg
    coords = rt.agent_fixed or rt.agent_choice or ()

    def run(K, p, pos, ret, key, step0):
        outs = torch.empty_like(p), torch.empty_like(pos), torch.empty_like(ret)
        err = fn(p.data_ptr(), pos.data_ptr(), ret.data_ptr(), slab.respawn_words.data_ptr(),
                 ra.words.data_ptr(), ra.program.data_ptr(), slab.slot_rewards.data_ptr(),
                 *(o.data_ptr() for o in outs), p.shape[0], K, t.width, t.height,
                 pos.shape[1] // 2, int(t.respawn), len(t.respawn_rects), t.respawn_slot_base,
                 t.agent_colors[0], t.agent_colors[-1], slab.slot_rewards.shape[0],
                 len(rt.ball_colors), int(rt.balls_before_agents), collect_slab._agent_mode(rt),
                 len(coords), cfg.max_steps, step0 % cfg.max_steps,
                 *(philox.signed(w) for w in (*key, step0)),
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"collect_steps_philox: CUDA error {err}"
        return outs
    return run


def probe_collect(variants, probe_dir, gen, smi):
    """Section 6 for the Collect K steps: ``collect_steps_philox`` at each
    G against ``ms_philox_spec``, each G timed at K in (1, 25, 50) and B in
    (64, 8192); then every G and each pre-drawn variant in turns at K = 25,
    B = 8192, two launches a timed call."""
    slab = collect_slab.make_collect_slab(MAIN, DEV)
    lead = 25  # steps before an episode's end at the first step

    def start(n):
        key = philox.key_of(n)
        st = collect_slab.reset_batch(slab, n, rnd=philox.collect_first_reset_draws(
            key, n, slab.reset_draws, DEV))
        p = collect_slab.pack_planes(st.grid_obj, st.grid_color, st.grid_slot)
        return key, (p, st.agent_pos.reshape(n, -1), torch.zeros((n, 2), device=DEV)), st

    step0 = MAIN.max_steps - lead
    checkout = _build.CSRC / "collect_steps.cu"
    builds = {g: collect_philox_call(
        _build.load().collect_steps_philox if g == COLLECT_LANES else
        entry(nvcc_build(checkout, probe_dir / f"collect_steps_g{g}.so",
                         f"-DCOLLECT_STEPS_GROUP={g}"), checkout, "collect_steps_philox"), slab)
        for g in COLLECT_GROUPS}
    out, cycles = {}, {}
    for n in (64, B):
        key, state, _ = start(n)
        for K in (1, 25, 50):
            want = collect_slab.ms_philox_spec(slab, K, *state, key, step0)
            for g, run in builds.items():
                got = run(K, *state, key, step0)
                assert all(torch.equal(a, b) for a, b in zip(got, want)), (g, K, n)
                out[f"collect_steps_philox G={g} K={K} B={n} from {lead} before an end"] = (
                    time_ms(lambda: run(K, *state, key, step0), 100)[0] * 1e3)
    log(f"collect_steps_philox at every G == ms_philox_spec at K in (1, 25, 50), B in "
        f"(64, {B}): bit-equal")
    source = probe_dir / "collect_steps_stamped.cu"
    source.parent.mkdir(parents=True, exist_ok=True)
    source.write_text(stamped_collect_steps(checkout.read_text()))
    key, state, _ = start(B)
    for g in COLLECT_GROUPS:
        lib = nvcc_build(source, probe_dir / f"collect_steps_stamped_g{g}.so",
                         f"-DCOLLECT_STEPS_GROUP={g}")
        run = collect_philox_call(entry(lib, source, "collect_steps_philox"), slab)
        get = lib.collect_steps_stamps
        get.argtypes = [ctypes.c_void_p]
        for s0 in (0, lead):
            want = collect_slab.ms_philox_spec(slab, 25, *state, key, s0)
            assert all(torch.equal(a, b) for a, b in zip(run(25, *state, key, s0), want))
            sums = (ctypes.c_ulonglong * 6)()
            assert get(ctypes.addressof(sums)) == 0
            for _ in range(20):
                run(25, *state, key, s0)
            torch.cuda.synchronize()
            assert get(ctypes.addressof(sums)) == 0
            at = {ph: sums[i] / sums[5] for i, ph in enumerate(COLLECT_PHASES)}
            cycles[f"G={g} K=25 step0={s0}"] = at
            log(f"collect_steps_philox G={g}, K=25 from step {s0} "
                f"({'a fresh board at its end' if s0 else 'inside an episode'}), B={B}: "
                "thread 0's cycles per block: " + ", ".join(f"{ph} {c:.0f}" for ph, c in at.items()))
    key, state, st = start(B)
    runners = []
    for g, run in builds.items():
        def pair(run=run):
            for k0 in (0, 25):
                run(25, *state, key, k0)
        runners.append((f"collect_steps_philox G={g}", pair))
    want = collect_slab.ms_philox_spec(slab, 25, *state, key, lead)
    for i, (cost, body) in enumerate(twice_collect_steps(checkout.read_text()).items()):
        source = probe_dir / f"collect_steps_twice_{i}.cu"
        source.write_text(body)
        run = collect_philox_call(entry(nvcc_build(source, probe_dir / f"{source.stem}.so"),
                                        source, "collect_steps_philox"), slab)
        assert all(torch.equal(a, b) for a, b in zip(run(25, *state, key, lead), want)), cost
        runners.append((f"collect_steps_philox G={COLLECT_LANES}, {cost} twice",
                        lambda run=run: [run(25, *state, key, k0) for k0 in (0, 25)]))
    acts = torch.randint(0, 4, (25, B, 2), generator=gen, device=DEV, dtype=torch.int32)
    rnd = torch.rand((25, B, 3), generator=gen, device=DEV)
    planes = (st.grid_obj, st.grid_color, st.grid_slot, st.agent_pos.reshape(B, -1), acts, rnd)
    for i, path in enumerate(variants):
        lib = nvcc_build(path, probe_dir / f"collect_{i}.so")
        run = collect_runner(entry(lib, path, "collect_steps"), slab)
        assert all(torch.equal(a, b) for a, b in zip(
            run(*planes), collect_slab.ms_spec(slab, *planes))), path
        runners.append((f"{path.stem} collect_steps (pre-drawn)",
                        lambda run=run: (run(*planes), run(*planes))))
    turns = {name: [] for name, _ in runners}
    for order in (runners, runners[::-1]) * 2:
        for name, run in order:
            turns[name].append(time_ms(run, 100)[0] * 1e3 / 2)
    for key_, t in out.items():
        log(f"{key_}: {t:.2f} us/launch ({smi})")
    for name, t in turns.items():
        log(f"{name}, K=25, B={B}, in turns: us a launch {[round(x, 2) for x in t]} ({smi})")
        out[f"collect {name} K=25 B={B} turns"] = t
    out["collect_steps_philox phase cycles"] = cycles
    return out


def probe_ctf(variants, kernels, probe_dir, gen, smi):
    """Section 6 for ``ctf_steps``: the checkout's build (one thread an
    env), the checkout's source built in the lane-group layout
    (``-DCTF_STEPS_GROUP=1``) and each variant, on ``CTF_MAIN`` and on
    ``CTF_PATROL``; with each build's SASS loop count."""
    source = _build.CSRC / "ctf_step.cu"
    builds = [("checkout", source, _build.library_path("ctf_step.cu"), kernels.ctf_steps)]
    lanes = probe_dir / "ctf_lanes.so"
    builds.append(("lane groups", source, lanes,
                   entry(nvcc_build(source, lanes, "-DCTF_STEPS_GROUP=1"), source, "ctf_steps")))
    for i, path in enumerate(variants):
        lib = probe_dir / f"ctf_{i}.so"
        builds.append((path.stem, path, lib, entry(nvcc_build(path, lib), path, "ctf_steps")))
    out = {}
    for name, _, lib, _ in builds:
        # The 2v2 MvN instance: steps_kernel<2, 2, true>, or before it
        # steps_kernel<4> (templated on the agent count or the lanes an env).
        n = sass_loop(lib, "12steps_kernelILi(2ELi2ELb1|4)EE",
                      ROOT / "chiprun_out" / f"sass_{lib.stem}.txt")
        log(f"ctf_steps {name}: {n} SASS instructions in the largest step loop of its 2v2 "
            "instance")
        out[f"ctf {name} step loop SASS instructions"] = n
    for cfg_name, cfg in (("CTF_MAIN", CTF_MAIN), ("CTF_PATROL", CTF_PATROL)):
        cslab = ctf_slab.make_ctf_slab(cfg, DEV)
        runners = [(name, ctf_runner(fn, cslab, src)) for name, src, _, fn in builds]

        def ctf_args(n, K, cslab=cslab):
            st = ctf_slab.reset_batch(cslab, n, generator=gen)
            return (st.pos.reshape(n, -1), st.dir, st.terminated, st.collided, st.step_count,
                    torch.zeros(n, device=DEV),
                    torch.randint(0, 5, (K, n, cslab.t.n_blue), generator=gen, device=DEV,
                                  dtype=torch.int32),
                    torch.rand((K, n, cslab.step_draws), generator=gen, device=DEV),
                    torch.rand((K, n, cslab.reset_draws), generator=gen, device=DEV))

        def ctf_one(n, cslab=cslab, ctf_args=ctf_args):
            a = ctf_args(n, 1)
            one = (cslab.t, a[0], a[1], a[2], a[3], a[6][0], a[7][0], cslab.flags, cslab.border,
                   cslab.pool)
            return lambda: ctf_slab.ctf_step_slab(*one)

        out.update(probe_steps(
            f"ctf {cfg_name}", runners, ctf_args,
            lambda K, a, cslab=cslab: ctf_slab.ms_spec(
                cslab.t, K, *a, cslab.flags, cslab.border, cslab.pool, cslab.bterr, cslab.rterr),
            ctf_one, (1, 50), smi))
    return out


def probe_isolated(after_checks: bool):
    """The Collect and Maze episode paths, the learner paths and the
    vector envs, timed as ``chip_smoke.py``'s phase 3 times them, with
    nothing before them in the process but the build (and, with
    ``after_checks``, the gymnasium-facing checks of its phase 2)."""
    import chip_smoke as cs

    if after_checks:
        cs.check_per_env_functions(seed=27)
        cs.check_host_policy_path(seed=28)
        for i, (name, make, cfg) in enumerate((
                ("Collect", cs.make_collect_batch, cs.MAIN), ("CtF", cs.make_ctf_batch, cs.CTF_MAIN),
                ("Maze", cs.make_maze_batch, cs.MAZE_MAIN), ("Wildfire", cs.make_wildfire_batch,
                                                            cs.WF_MAIN))):
            cs.check_next_step(name, make, cfg, seed=90 + i)
    roll, states, *_ = cs.collect_episode_path()
    cs.time_rollout(roll, "Collect episode", states, cs.STEPS_PER_CALL, cs.MAIN.num_agents,
                    cs.COLLECT_WARMUP_MAX)
    roll, _, _, states, _ = cs.maze_episode_path()
    cs.time_rollout(roll, "Maze episode", states, cs.MAZE_STEPS_PER_CALL, 1, cs.MAZE_WARMUP_MAX)
    per_iter = cs.TRAIN_CFG.rollout_len
    cs.run_training("collect", {"collect_step": per_iter, "collect_reset": per_iter})
    cs.run_training("ctf", {"ctf_step": per_iter})
    cs.run_evaluations()
    cs.run_selfplay()
    if hasattr(cs, "run_vector_envs"):
        cs.run_vector_envs()


def probe_rollouts():
    """The four ``BatchedEnv`` rollouts, the Collect episode path and the
    vector envs, timed as ``chip_smoke.py``'s phase 3 times them, with
    nothing before them in the process but the build."""
    import chip_smoke as cs

    env, states, _, _ = cs.collect_main_path()
    cs.time_rollout(env.rollout, "CollectSlab", states, cs.STEPS_PER_CALL, cs.MAIN.num_agents,
                    cs.COLLECT_WARMUP_MAX)
    for name, path, steps, agents, warmup in (
            ("CtfSlab", cs.ctf_main_path, cs.CTF_STEPS_PER_CALL, CTF_MAIN.num_agents,
             cs.CTF_WARMUP_MAX),
            ("MazeSlab", cs.maze_main_path, cs.MAZE_STEPS_PER_CALL, 1, cs.MAZE_WARMUP_MAX),
            ("WildfireSlab", cs.wildfire_main_path, cs.WF_STEPS_PER_CALL, WF_MAIN.num_agents,
             cs.WF_WARMUP_MAX)):
        env, _, _, states, _ = path()
        cs.time_rollout(env.rollout, name, states, steps, agents, warmup)
    roll, states, _, _ = cs.collect_episode_path()
    cs.time_rollout(roll, "Collect episode", states, cs.STEPS_PER_CALL, MAIN.num_agents,
                    cs.COLLECT_WARMUP_MAX)
    roll, _, _, states, _ = cs.wildfire_episode_path()
    cs.time_rollout(roll, "Wildfire episode", states, cs.WF_STEPS_PER_CALL, WF_MAIN.num_agents,
                    cs.WF_WARMUP_MAX)
    cs.run_vector_envs()


def probe_collect_episode(smi):
    """The Collect episode call (the main config at B = 8192, 500 steps)
    at chunks of 25 and of 50, each timed as ``chip_smoke.py``'s phase 3
    times it, in turns (25, 50, 50, 25), with nothing before them in the
    process but the build."""
    import chip_smoke as cs

    rolls = {}
    for chunk in (25, 50):
        roll = collect_slab.make_collect_episode_rollout(MAIN, B, chunk=chunk)
        rolls[chunk] = [roll, roll.reset(seed=0)[0]]
    for chunk in (25, 50, 50, 25):
        roll, states = rolls[chunk]
        log(f"Collect episode at chunk {chunk} ({smi}):")
        rolls[chunk][1] = cs.time_rollout(roll, f"Collect episode, chunk {chunk}", states,
                                          cs.STEPS_PER_CALL, MAIN.num_agents,
                                          cs.COLLECT_WARMUP_MAX)


def probe_render(smi):
    """Each family's batch render at B = 8192 beside the gathers it was
    chosen over, each checked equal to it; CUDA events, median of 5 after
    2 untimed calls (``chip_smoke.time_events``)."""
    import chip_smoke as cs
    from gym_multigrid_tpu_torch.render import tiles

    record = {}
    t = cs.RENDER_T
    for name, make_batch, cfg, tile_ids, make_bank, render, _ in cs.RENDER_CASES:
        states, _ = make_batch(cfg, B).reset(0)
        ids = tile_ids(cfg, states)
        n, h, w = ids.shape
        bank = tiles._device_bank(make_bank, t, DEV)  # (K * T, T * 3) uint8
        rows = (ids.to(torch.int32)[:, :, None, :] * t
                + torch.arange(t, dtype=torch.int32, device=DEV)[None, None, :, None])
        tile_bank = bank.view(-1, t, t, 3)
        want = render(cfg, states)
        variants = {
            "renderer": lambda: render(cfg, states),
            "row-index gather, bytes": lambda: bank.index_select(
                0, rows.reshape(-1)).view(n, h * t, w * t, 3),
            "row-index gather, 8-byte words": lambda: bank.view(torch.int64).index_select(
                0, rows.reshape(-1)).view(torch.uint8).view(n, h * t, w * t, 3),
            "two-pass gather": lambda: tile_bank[ids].permute(0, 1, 3, 2, 4, 5).reshape(
                n, h * t, w * t, 3),
        }
        for variant, fn in variants.items():
            assert torch.equal(fn(), want), f"{name}: {variant} differs"
        variants["two-pass, the tile gather alone"] = lambda: tile_bank[ids]
        for variant, fn in variants.items():
            ms, all_ms = cs.time_events(fn)
            record[f"render {name} {variant} ms"] = ms
            log(f"render {name}, {variant}: {ms:.3f} ms {[round(x, 3) for x in all_ms]}, "
                f"{want.numel() / ms / 1e6:.1f} GB/s of frames ({want.numel()} B; {smi})")
    return record


def probe_resets(variants, probe_dir, gen, smi):
    """Sections 1-4: the resets, the checkout's, then the variants, each
    stamped if it can be.  Returns the record's entries."""
    record = {}
    slab = collect_slab.make_collect_slab(MAIN, DEV)
    rt, ra = slab.rt, slab.reset_arrays
    rnd = torch.rand((B, slab.reset_draws), generator=gen, device=DEV)
    want = collect_slab.reset_spec(rt, ra.wall, ra.ball_rects, rnd)
    sources = [("checkout", _build.CSRC / "collect_reset.cu")]
    sources += [(path.stem, path) for path in variants]
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
    return record


#: ``maze_steps_philox``'s builds as (draw threads an env, window steps),
#: and the thread counts of ``maze_step``'s blocks.
MAZE_BUILDS = ((1, 16), (2, 16), (4, 16), (2, 8), (2, 32))
MAZE_STEP_THREADS = (64, 128, 256)


def maze_philox_runner(fn, slab):
    """``maze_steps_philox`` of a build through ``fn``, with
    ``maze_philox_slab``'s arguments and results."""
    def run(K, cell, dirs, sc, run_ret, rew, ep, eps, key, step0):
        n = cell.shape[0]
        out = torch.empty((7, n), dtype=torch.int32, device=DEV)
        err = fn(*(x.data_ptr() for x in (cell, dirs, sc, run_ret, rew, ep, eps,
                                           slab.ms_table)),
                 *(row.data_ptr() for row in out), n, K, slab.t.n_cells * 5, slab.bg.shape[1],
                 slab.t.max_steps, *(philox.signed(w) for w in (*key, step0)),
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"maze_steps_philox: CUDA error {err}"
        floats = out[3:6].view(torch.float32)
        return out[0], out[1], out[2], floats[0], floats[1], floats[2], out[6]
    return run


def maze_step_runner(fn, slab, with_table):
    """``maze_step`` of a build through ``fn``: ``maze_step_slab``'s
    arguments and results; ``with_table`` False for the C interface from
    before the table (the cell rows only)."""
    t = slab.t

    def run(pos, dirs, acts):
        n = pos.shape[0]
        outs = (torch.empty_like(pos), torch.empty_like(dirs),
                torch.empty((n, 1), device=DEV), torch.empty_like(dirs))
        tables = (slab.cells, slab.ms_table) if with_table else (slab.cells,)
        err = fn(pos.data_ptr(), dirs.data_ptr(), acts.data_ptr(),
                 *(x.data_ptr() for x in tables), *(o.data_ptr() for o in outs), n, t.s0, t.s1,
                 int(t.obstacle_penalty != 0), t.flag_reward, t.obstacle_penalty,
                 t.step_penalty, torch.cuda.current_stream().cuda_stream)
        assert err == 0, f"maze_step: CUDA error {err}"
        return outs
    return run


def probe_maze(variants, philox_variants, kernels, probe_dir, gen, smi):
    """Section 5: ``maze_steps_philox`` at each build against the pre-drawn
    variants, and ``maze_step`` at each block size against the variants'
    one-step entry, each checked bit-equal to its plain version."""
    mslab = maze_slab.make_maze_slab(MAZE_MAIN, DEV)
    source = _build.CSRC / "maze_step.cu"
    text = source.read_text()
    default = tuple(int(re.search(rf"#define MAZE_STEPS_{k} (\d+)", text).group(1))
                    for k in ("PRODUCERS", "WINDOW"))
    builds = {f"Q={qn} W={w}": maze_philox_runner(
        kernels.maze_steps_philox if (qn, w) == default else
        entry(nvcc_build(source, probe_dir / f"maze_steps_q{qn}_w{w}.so",
                         f"-DMAZE_STEPS_PRODUCERS={qn}", f"-DMAZE_STEPS_WINDOW={w}"),
              source, "maze_steps_philox"), mslab)
        for qn, w in MAZE_BUILDS}
    for i, path in enumerate(philox_variants):
        lib = nvcc_build(path, probe_dir / f"maze_philox_{i}.so")
        builds[path.stem] = maze_philox_runner(entry(lib, path, "maze_steps_philox"), mslab)
    out_dir = ROOT / "chiprun_out"
    n_sass = sass_loop(_build.library_path("maze_step.cu"), "philox_steps_kernel",
                       out_dir / "maze_steps_philox.sass")
    log(f"maze_steps_philox (port's build): {n_sass} static SASS instructions in its largest loop")
    default_threads = int(re.search(r"#define MAZE_STEP_THREADS (\d+)", text).group(1))
    steps = {n_threads: maze_step_runner(
        kernels.maze_step if n_threads == default_threads else
        entry(nvcc_build(source, probe_dir / f"maze_step_t{n_threads}.so",
                         f"-DMAZE_STEP_THREADS={n_threads}"), source, "maze_step"), mslab, True)
        for n_threads in MAZE_STEP_THREADS}
    olds = []
    for i, path in enumerate(variants):
        lib = nvcc_build(path, probe_dir / f"maze_{i}.so")
        one = entry(lib, path, "maze_step")
        olds.append((path.stem, maze_runner(entry(lib, path, "maze_steps"), mslab),
                     maze_step_runner(one, mslab, len(one.argtypes) == 17)))

    def start(n, seed):
        key = philox.key_of(seed)
        st = maze_slab.reset_batch(mslab, n, rnd=philox.maze_first_reset_draws(key, n, DEV))
        zeros = torch.zeros((3, n), device=DEV)
        return key, (st.pos[:, 0] * mslab.t.s1 + st.pos[:, 1], st.dir, st.step_count, *zeros,
                     torch.zeros((n,), dtype=torch.int32, device=DEV)), st

    out = {}
    for n in (64, B):
        key, state, st = start(n, n)
        for K in (1, 25, 100):
            for step0 in (0, 37):
                want = maze_slab.ms_philox_spec(mslab, K, *state, key, step0)
                for g, run in builds.items():
                    assert all(torch.equal(a, b) for a, b in
                               zip(run(K, *state, key, step0), want)), (g, K, n, step0)
            for g, run in builds.items():
                out[f"maze_steps_philox {g} K={K} B={n}"] = (
                    time_ms(lambda: run(K, *state, key, 0), 200)[0] * 1e3)
        acts = torch.randint(-1, 10, (n, 1), generator=gen, device=DEV, dtype=torch.int32)
        one = (st.pos, st.dir.reshape(n, 1), acts)
        want = maze_slab.step_spec(mslab.t, *one, mslab.cells)
        for name, run in [(f"{t} threads", r) for t, r in steps.items()] + [
                (name, r) for name, _, r in olds]:
            assert all(torch.equal(a, b) for a, b in zip(run(*one), want)), (name, n)
        for name, ms_run, _ in olds:
            a = torch.randint(-1, 7, (100, n), generator=gen, device=DEV, dtype=torch.int32)
            r = torch.rand((100, n), generator=gen, device=DEV)
            ms = (st.pos, st.dir, st.step_count, torch.rand(n, generator=gen, device=DEV), a, r)
            want = maze_slab.ms_spec(mslab.t, 100, *ms, mslab.cells, mslab.bg)
            assert all(torch.equal(g, w) for g, w in zip(ms_run(*ms), want)), name
    log(f"maze_steps_philox at every build == ms_philox_spec at K in (1, 25, 100) from steps 0 "
        f"and 37, B in (64, {B}); maze_step at every block size and each variant's == "
        f"step_spec: bit-equal")

    # In turns at B = 8192: the K-step builds at K = 100, then maze_step.
    key, state, st = start(B, 5)
    runners = [(f"maze_steps_philox {g}", lambda run=run: run(100, *state, key, 0))
               for g, run in builds.items()]
    a = torch.randint(0, 5, (100, B), generator=gen, device=DEV, dtype=torch.int32)
    r = torch.rand((100, B), generator=gen, device=DEV)
    ms = (st.pos, st.dir, st.step_count, torch.zeros(B, device=DEV), a, r)
    for name, ms_run, _ in olds:
        runners.append((f"{name} maze_steps (pre-drawn)", lambda ms_run=ms_run: ms_run(*ms)))
        runners.append((f"{name} maze_steps with its two draws", lambda ms_run=ms_run: ms_run(
            *ms[:4], torch.randint(0, 5, (100, B), generator=gen, device=DEV, dtype=torch.int32),
            torch.rand((100, B), generator=gen, device=DEV))))
    one = (st.pos, st.dir.reshape(B, 1),
           torch.randint(0, 5, (B, 1), generator=gen, device=DEV, dtype=torch.int32))
    step_runners = [(f"maze_step {t} threads", lambda run=run: run(*one))
                    for t, run in steps.items()]
    step_runners += [(f"{name} maze_step", lambda run=run: run(*one)) for name, _, run in olds]
    step_runners.append(("launch floor (an empty kernel)", lambda: torch.cuda._sleep(0)))
    for group in (runners, step_runners):
        turns = {name: [] for name, _ in group}
        for order in (group, group[::-1]) * 2:
            for name, run in order:
                turns[name].append(time_ms(run, 200)[0] * 1e3)
        for name, t in turns.items():
            log(f"{name}, B={B}, in turns: us a launch {[round(x, 2) for x in t]} ({smi})")
            out[f"{name} B={B} turns"] = t
    for key_, t in out.items():
        if not key_.endswith("turns"):
            log(f"{key_}: {t:.2f} us/launch ({smi})")
    return {"maze_us": out}


if __name__ == "__main__":
    main()
