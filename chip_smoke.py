"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py        # from the root of a checkout

Needs one CUDA device and ``nvcc``; exits non-zero, printing no result,
without them.  Phases, each of which fails the run on any fault:

1. Build the CUDA kernels from ``gym_multigrid_tpu_torch/csrc/``.
2. Hold each kernel to its plain PyTorch version on the card, bit for bit:
   the step kernel over 100 chained steps at B = 8192 (the main config, the
   1-agent even config and the 15x15 quadrants config, with the invalid
   action ids -1, 4 and 7 mixed in), the reset kernel on every layout and
   under a random ``done`` mask.
3. Drive the main path: ``make_collect_batch`` of the respawn-clustered
   config at B = 8192, ``reset(seed=0)``, ``rollout`` of 500 steps with the
   launch counts set to 0 just before and read just after; check the
   rollout's invariants; then, after untimed calls until the time per call
   settles, time it, each kernel and its plain version.
4. Profile 50 steps of the rollout: device time by kernel and idle share.

Prints the timing lines, one JSON line of kernel records, the card's name
and power limit, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device")

from gym_multigrid_tpu_torch.envs.collect import AGENT, BALL, CollectConfig  # noqa: E402
from gym_multigrid_tpu_torch.ops import _build  # noqa: E402
from gym_multigrid_tpu_torch.ops.collect_slab import (  # noqa: E402
    collect_reset_slab,
    collect_step_slab,
    make_collect_slab,
    reset_batch,
    reset_spec,
    step_spec,
)
from gym_multigrid_tpu_torch.parallel.vector import make_collect_batch  # noqa: E402

B = 8192
STEPS_PER_CALL = 500  # ten lockstep 50-step episodes
MAIN = CollectConfig(layout="quadrants_respawn", respawn=True, max_steps=50)
SINGLE = CollectConfig(agents_index=(3,), layout="even", respawn=False)
QUADRANTS15 = CollectConfig(size=15, num_balls=30, layout="quadrants")

# H100 SXM peaks (NVIDIA data sheet and Hopper white paper): HBM3 rate, and
# int32 ALU ops on the CUDA cores (132 SMs x 64 int32 lanes x 1.98 GHz).
MEM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Integer operations each function needs, with its masks bit-packed, one
# bit per cell: a masked pick (a respawn, a ball placement, a uniform agent
# placement) is an AND, a popcount and a running sum per 32-cell word, plus
# a constant to find the chosen bit and write its cell; a move or a placement
# at a given cell is a constant (action to vector, clip, index, the entered
# cell's read and the writes).  Everything else either function does is
# moving bytes, which the byte term counts.
PICK_OPS_PER_WORD = 3
PICK_OPS = 8
MOVE_OPS = 16
WARMUP_MAX = 20  # untimed rollout calls at most before the timed ones
DEV = torch.device("cuda", 0)


def log(*args):
    print(*args, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def max_abs_err(got, want):
    """Max |got - want| over paired outputs; raises unless bit-equal."""
    err = 0.0
    for g, w in zip(got, want):
        check(g.dtype == w.dtype and g.shape == w.shape, f"{g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
        err = max(err, (g.double() - w.double()).abs().max().item())
        check(torch.equal(g, w), "kernel differs from its plain version")
    return err


def actions(gen, n_agents):
    """Moves 0..3 with the invalid ids -1, 4 and 7 mixed in (a fifth)."""
    acts = torch.randint(0, 4, (B, n_agents), generator=gen, device=DEV, dtype=torch.int32)
    bad = torch.rand((B, n_agents), generator=gen, device=DEV) < 0.2
    ids = torch.tensor([-1, 4, 7], dtype=torch.int32, device=DEV)
    pick = torch.randint(0, 3, (B, n_agents), generator=gen, device=DEV)
    return torch.where(bad, ids[pick], acts)


def check_step_kernel(cfg, steps, seed):
    slab = make_collect_slab(cfg, DEV)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    s = reset_batch(slab, B, generator=gen)
    go, gc, gs, pos = s.grid_obj, s.grid_color, s.grid_slot, s.agent_pos.reshape(B, -1)
    err, pickups, drops = 0.0, 0, 0
    for _ in range(steps):
        acts = actions(gen, cfg.num_agents)
        rnd = torch.rand((B, 3), generator=gen, device=DEV)
        args = (slab.t, go, gc, gs, pos, acts, rnd, slab.respawn_rects)
        got = collect_step_slab(*args)
        err = max(err, max_abs_err(got, step_spec(*args)))
        pickups += int((got[4] >= 0).sum())
        if cfg.respawn:  # a respawn on the vacated cell is stomped
            drops += int((go == BALL).sum() - (got[0] == BALL).sum())
        go, gc, gs, pos = got[:4]
    check(pickups > 0, "no pickups")
    check(not cfg.respawn or drops > 0, "no respawn stomps")
    log(f"step kernel == step_spec: size {cfg.size} layout {cfg.layout} agents "
        f"{cfg.num_agents}, {steps} steps at B={B}: {pickups} pickups, "
        f"{drops} stomped respawns, max_abs_err {err}")
    return err


def check_reset_kernel(cfg, seed):
    slab = make_collect_slab(cfg, DEV)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    rnd = torch.rand((B, slab.reset_draws), generator=gen, device=DEV)
    ra = slab.reset_arrays
    want = reset_spec(slab.rt, ra.wall, ra.ball_rects, rnd)
    err = max_abs_err(collect_reset_slab(slab.rt, rnd, ra), want)
    # Under a done mask: only done rows change, in place.
    done = torch.rand((B,), generator=gen, device=DEV) < 0.3
    old = [torch.randint(-5, 50, w.shape, generator=gen, device=DEV, dtype=torch.int32) for w in want]
    out = [o.clone() for o in old]
    collect_reset_slab(slab.rt, rnd, ra, done=done, out=out)
    err = max(err, max_abs_err(out, [torch.where(done[:, None], w, o) for w, o in zip(want, old)]))
    log(f"reset kernel == reset_spec: size {cfg.size} layout {cfg.layout} "
        f"(unmasked and {int(done.sum())}/{B} rows masked), max_abs_err {err}")
    return err


def time_ms(fn, iters, windows=5):
    """ms per call over ``windows`` windows of ``iters`` calls: CUDA events
    around each window, queued behind a device sleep so that host launch
    cost hides when the device is the slower side, one synchronise per
    window.  Returns the median window and all of them."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return sorted(per_call)[windows // 2], per_call


def gpu_clocks():
    """The card's SM and memory clocks, performance state, temperature and
    power draw, as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,pstate,temperature.gpu,power.draw",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def us(times):
    return "[" + ", ".join(f"{t * 1e3:.2f}" for t in times) + "]"


def pick_ops(n_picks, n_cells):
    """Operations of ``n_picks`` masked picks over boards of ``n_cells``."""
    return n_picks * (-(-n_cells // 32) * PICK_OPS_PER_WORD + PICK_OPS)


def bound(nbytes, ops):
    """(bound ms, what bounds it, the bytes' ms, the operations' ms)."""
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, t_bytes, t_ops


def main():
    # Phase 1: build.
    t0 = time.perf_counter()
    logs = _build.build()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(logs)} sources")
    for source, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"  {source}: {line.strip()}")

    # Phase 2: kernels against their plain versions on the card.
    step_err = max(
        check_step_kernel(MAIN, 100, seed=1),
        check_step_kernel(SINGLE, 100, seed=2),
        check_step_kernel(QUADRANTS15, 100, seed=3),
    )
    reset_err = max(
        check_reset_kernel(CollectConfig(layout=layout), seed=10 + i)
        for i, layout in enumerate(("even", "quadrants", "rooms", "quadrants_respawn"))
    )
    reset_err = max(reset_err, check_reset_kernel(QUADRANTS15, seed=20))

    # Phase 3: the main path, with the launch counts of this run.
    collect_step_slab.launches = collect_reset_slab.launches = 0
    env = make_collect_batch(MAIN, B)
    states, obs = env.reset(seed=0)
    states, metrics = env.rollout(states, STEPS_PER_CALL)
    torch.cuda.synchronize()
    launches = {"collect_step": collect_step_slab.launches,
                "collect_reset": collect_reset_slab.launches}
    log(f"main path launches: {launches}")
    check(launches["collect_step"] == STEPS_PER_CALL, "step kernel launches")
    check(launches["collect_reset"] == STEPS_PER_CALL + 1, "reset kernel launches")
    check(obs.shape == (B, 10, 10, 3) and obs.dtype == torch.uint8, "obs shape")
    episodes = int(metrics["episodes"])
    reward_sum = float(metrics["reward_sum"])
    ep_return_sum = float(metrics["ep_return_sum"])
    check(episodes == B * STEPS_PER_CALL // MAIN.max_steps, f"episodes {episodes}")
    check(reward_sum > 0, "no reward")
    # Rewards are integers summed below 2**24: float32 sums are exact.
    check(ep_return_sum == reward_sum, f"{ep_return_sum} != {reward_sum}")
    check(bool((metrics["run_return"] == 0).all()), "run_return after lockstep truncation")
    check(bool((states.step_count == 0).all()), "states not reset at the episode boundary")
    log(f"rollout: {episodes} episodes, reward_sum {reward_sum}, "
        f"reward per agent-step {reward_sum / (B * STEPS_PER_CALL * 2)}")
    for _ in range(25):  # mid-episode board invariants
        states, *_ = env.step(states, torch.randint(0, 4, (B, 2), device=DEV, dtype=torch.int32))
    balls = (states.grid_obj == BALL).sum(1)
    check(bool((balls <= MAIN.num_balls).all()), "more balls than placed")
    check(bool((balls >= MAIN.num_balls - states.collected).all()), "balls lost beyond pickups")
    check(bool(((states.grid_obj == AGENT).sum(1) == 2).all()), "agents per board")

    # Timing: the rollout (end to end), each kernel and its plain version.
    agent_steps = B * STEPS_PER_CALL * MAIN.num_agents

    def timed_rollout():
        """One rollout call: (device-event ms, host wall ms, host CPU ms)."""
        nonlocal states
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        w0, c0 = time.perf_counter(), time.process_time()
        start.record()
        states, _ = env.rollout(states, STEPS_PER_CALL)
        end.record()
        end.synchronize()
        return (start.elapsed_time(end), (time.perf_counter() - w0) * 1e3,
                (time.process_time() - c0) * 1e3)

    # Warm-up: untimed calls until three in a row lie within 5% of each
    # other, each logged with the host's share of it and the card's clocks.
    warm, settled = [], False
    while len(warm) < WARMUP_MAX and not settled:
        clocks = gpu_clocks()
        warm.append(timed_rollout())
        log(f"warm-up call {len(warm) - 1}: {warm[-1][0]:.1f} ms (host wall "
            f"{warm[-1][1]:.1f} ms, host CPU {warm[-1][2]:.1f} ms; before it: {clocks})")
        last = [w[0] for w in warm[-3:]]
        settled = len(last) == 3 and max(last) <= 1.05 * min(last)
    log(f"warm-up: {len(warm)} calls, settled: {settled}")
    calls = [timed_rollout() for _ in range(11)]
    windows = [c[0] for c in calls]
    median = sorted(windows)[len(windows) // 2]
    log(f"rollout of {STEPS_PER_CALL} steps at B={B}, {len(windows)} calls after the "
        f"warm-up: ms per call {windows}; host CPU ms {[round(c[2], 1) for c in calls]}; "
        f"agent-steps/s {agent_steps / (median / 1e3)} (median), "
        f"{agent_steps / (max(windows) / 1e3)} (slowest), "
        f"{agent_steps / (min(windows) / 1e3)} (fastest); after: {gpu_clocks()}")

    slab, C, A = env.slab, MAIN.num_cells, MAIN.num_agents
    pos = states.agent_pos.reshape(B, -1)
    acts = torch.randint(0, 4, (B, A), device=DEV, dtype=torch.int32)
    rnd3 = torch.rand((B, 3), device=DEV)
    step_args = (slab.t, states.grid_obj, states.grid_color, states.grid_slot,
                 pos, acts, rnd3, slab.respawn_rects)
    step_ms, step_all = time_ms(lambda: collect_step_slab(*step_args), 200)
    step_plain_ms, step_plain_all = time_ms(lambda: step_spec(*step_args), 20)
    step_bytes = sum(x.numel() * x.element_size() for x in step_args[1:]) + (
        3 * B * C * 4 + B * 2 * A * 4 + B * A * 4)
    # This call's data: a respawn pick for each pickup.
    respawns = int((collect_step_slab(*step_args)[4] >= 0).sum()) if MAIN.respawn else 0
    step_ops = B * A * MOVE_OPS + pick_ops(respawns, C)
    step_bound, step_by, *step_parts = bound(step_bytes, step_ops)

    ra = slab.reset_arrays
    rnd_r = torch.rand((B, slab.reset_draws), device=DEV)
    reset_ms, reset_all = time_ms(lambda: collect_reset_slab(slab.rt, rnd_r, ra), 200)
    reset_plain_ms, reset_plain_all = time_ms(
        lambda: reset_spec(slab.rt, ra.wall, ra.ball_rects, rnd_r), 20)
    none_done = torch.zeros((B,), dtype=torch.bool, device=DEV)
    out = collect_reset_slab(slab.rt, rnd_r, ra)
    masked_ms, masked_all = time_ms(
        lambda: collect_reset_slab(slab.rt, rnd_r, ra, done=none_done, out=out), 200)
    reset_bytes = sum(x.numel() * x.element_size() for x in (rnd_r, *ra)) + (
        3 * B * C * 4 + B * 2 * A * 4)
    # Every ball is a masked pick; agents are one only when placed uniformly.
    uniform_agents = 0 if slab.rt.agent_fixed or slab.rt.agent_choice else A
    n_balls = len(slab.rt.ball_colors)
    reset_ops = (pick_ops(B * (n_balls + uniform_agents), C)
                 + B * (A - uniform_agents) * MOVE_OPS)
    reset_bound, reset_by, *reset_parts = bound(reset_bytes, reset_ops)
    log(f"collect_step: {step_ms * 1e3:.2f} us/launch (median of windows {us(step_all)}), "
        f"bound {step_bound * 1e3:.2f} us ({step_by}; {step_bytes} bytes take "
        f"{step_parts[0] * 1e3:.2f} us, {step_ops} operations ({respawns} respawns) "
        f"{step_parts[1] * 1e3:.2f} us), step_spec {step_plain_ms * 1e3:.1f} us "
        f"{us(step_plain_all)}")
    log(f"collect_reset: {reset_ms * 1e3:.2f} us/launch, all rows {us(reset_all)}; "
        f"{masked_ms * 1e3:.2f} us/launch with the done mask and no row done "
        f"{us(masked_all)}; bound {reset_bound * 1e3:.2f} us ({reset_by}; "
        f"{reset_bytes} bytes take {reset_parts[0] * 1e3:.2f} us, {reset_ops} operations "
        f"{reset_parts[1] * 1e3:.2f} us), reset_spec {reset_plain_ms * 1e3:.1f} us "
        f"{us(reset_plain_all)}")
    log("library_ms: null for both kernels (no single PyTorch call computes either)")

    # Phase 4: where the rollout's time goes.
    torch.cuda.synchronize()
    acts_kinds = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts_kinds) as prof:
        t0 = time.perf_counter()
        states, _ = env.rollout(states, 50)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = sorted(
        ((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
         if e.device_type == DeviceType.CUDA),
        key=lambda r: -r[1],
    )
    busy_us = sum(r[1] for r in rows)
    if busy_us > 0:
        log(f"profile of 50 rollout steps (wall clock under the profiler): wall "
            f"{wall_us:.0f} us, device kernels {busy_us:.0f} us, idle share "
            f"{1 - busy_us / wall_us:.3f}")
        for key, dev_us, count in rows[:12]:
            log(f"  {dev_us:9.1f} us  {count:5d}x  {key[:90]}")
    else:
        log("profile: no device time recorded (device busy share not measured)")

    record = {"kernels": [
        {"name": "collect_step", "route": "cuda",
         "source": "gym_multigrid_tpu_torch/csrc/collect_step.cu",
         "replaces": "gym_multigrid_tpu/ops/pallas_collect.py:290",
         "launches": launches["collect_step"], "max_abs_err": step_err,
         "ms": step_ms, "plain_ms": step_plain_ms, "bound_ms": step_bound,
         "bound_by": step_by, "library_ms": None},
        {"name": "collect_reset", "route": "cuda",
         "source": "gym_multigrid_tpu_torch/csrc/collect_reset.cu",
         "replaces": "gym_multigrid_tpu/ops/pallas_collect.py:1127",
         "launches": launches["collect_reset"], "max_abs_err": reset_err,
         "ms": reset_ms, "plain_ms": reset_plain_ms, "bound_ms": reset_bound,
         "bound_by": reset_by, "library_ms": None},
    ]}
    log(json.dumps(record))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    log(smi.stdout.strip())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
