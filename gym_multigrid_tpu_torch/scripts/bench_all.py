"""Per-family benchmark harness: ONE JSON line per (family, path) (the
port's ``bench_all.py``; the single-metric harness is ``bench.py``).

Usage:
  python -m gym_multigrid_tpu_torch.scripts.bench_all            # all families, headline path
  python -m gym_multigrid_tpu_torch.scripts.bench_all --families collect,ctf --all-paths
  python -m gym_multigrid_tpu_torch.scripts.bench_all --families ctf --partial-obs 7
  python -m gym_multigrid_tpu_torch.scripts.bench_all --cpu --batch 16 --steps 50

Paths, each on the family's benchmark config (:func:`family_cfg`):

- ``episode``: the family's episode rollout, ``make_*_episode_rollout(cfg,
  B, chunk=CHUNKS[family])``: one K-step kernel launch a chunk on the
  card (Collect's ``collect_steps_philox`` runs the truncation reset
  too).  The headline on the card, in place of JAX's ``xla-ms``.
- ``step``: its ``BatchedEnv.rollout``: one step-kernel launch a step
  (Collect also its masked reset).  The headline on the CPU, as JAX's
  ``xla-step`` is there.  ``--partial-obs V`` runs only this path, on a
  batch built with ``partial_obs_view=V``; the rollout encodes no
  observation (nothing reads it), so the row times that batch's steps.

Timing, as JAX's ``_timed_windows``: reset, one untimed call (kernels
loaded, allocator warm), two calls that size a window, then three
windows of ``max(4, int(MIN_WINDOW_S / per_call) + 1)`` chained calls,
each between two CUDA events with one synchronise at its end
(``utils/profiling.timed``; the host clock on the CPU).  The value is the
best window.  Each line holds ``metric``, ``value``, ``unit``,
``vs_baseline`` (against :data:`BASELINES`), ``device`` (the card's name
and power limit, ``utils/profiling.card_label``), ``windows`` (the three
windows' agent-steps/s in run order) and ``kernel_launches_per_call``
(each kernel wrapper's ``launches`` over the windows, over their calls;
``{}`` on the CPU, where the wrappers run their plain versions).

With more than one family and no ``--no-isolate``, each family runs in a
fresh process and its lines are echoed: host-bound rates depend on what
ran before them in a process.  A family whose process exits nonzero makes
this one exit nonzero.  Without ``--cpu`` the run needs a CUDA device and
exits nonzero without one; on the card a config off its family's kernel
route raises: nothing falls back.

Not ported from JAX's ``bench_all.py``: ``EXPECTED_TPU`` and ``band_ok``
(TPU rates), ``MS_MODE``, ``PRNG``, ``MS_PREFIX`` and ``--prng`` (the
TPU's random-number and prefix-sum choices; the port draws with
``torch.Generator``, and Wildfire's episode kernel with Philox).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from gym_multigrid_tpu_torch.scripts.multihost_dryrun import REPO

FAMILIES = ("collect", "ctf", "maze", "wildfire")
PATHS = ("episode", "step")
#: Reference agent-steps/s on one CPU core (the JAX package's BASELINE.md;
#: CtF's is the 1v1 number).  Wildfire has no reference implementation:
#: its entry is the 10 M/chip north-star target of BASELINE.json.
BASELINES = {
    "collect": 9_400.0,
    "ctf": 1_614.0,
    "maze": 4_525.0,
    "wildfire": 10_000_000.0,
}
#: Steps a K-step launch of each family's episode rollout.
CHUNKS = {"collect": 25, "ctf": 50, "maze": 100, "wildfire": 24}
#: Steps a timed call of each family.
MS_STEPS = {"collect": 500, "ctf": 400, "maze": 1000, "wildfire": 400}
#: Shortest timed window, seconds: it sets the calls a window chains.
MIN_WINDOW_S = 1.0
WINDOWS = 3
#: Seconds a family's own process may take.
FAMILY_TIMEOUT_S = 3500


def family_cfg(family: str):
    """(config, make_*_batch, make_*_episode_rollout, agents an env): the
    benchmark config of each family, as JAX's ``bench_all._family_cfg``."""
    from gym_multigrid_tpu_torch.envs.collect import CollectConfig
    from gym_multigrid_tpu_torch.envs.maze import MazeConfig
    from gym_multigrid_tpu_torch.envs.wildfire import WildfireConfig
    from gym_multigrid_tpu_torch.ops import collect_slab, ctf_slab, maze_slab, wildfire_slab
    from gym_multigrid_tpu_torch.parallel import vector
    from gym_multigrid_tpu_torch.rl.families import make_ctf_cfg

    if family == "collect":
        cfg = CollectConfig(layout="quadrants_respawn", respawn=True, max_steps=50)
        return (cfg, vector.make_collect_batch, collect_slab.make_collect_episode_rollout,
                cfg.num_agents)
    if family == "ctf":
        cfg = make_ctf_cfg(opponents=("fight", "rw"))
        return cfg, vector.make_ctf_batch, ctf_slab.make_ctf_episode_rollout, cfg.num_agents
    if family == "maze":
        cfg = MazeConfig.from_map_path(os.path.join(REPO, "tests/assets/board_maze.txt"),
                                       max_steps=100)
        return cfg, vector.make_maze_batch, maze_slab.make_maze_episode_rollout, 1
    if family == "wildfire":
        cfg = WildfireConfig(size=16, max_steps=100)
        return (cfg, vector.make_wildfire_batch, wildfire_slab.make_wildfire_episode_rollout,
                cfg.num_agents)
    raise ValueError(f"unknown family {family!r}; expected one of {FAMILIES}")


def align_steps(family: str, steps: int) -> int:
    """Collect's episode rollout runs whole lockstep episodes: a multiple
    of its 50 steps.  Other families take any step count."""
    if family != "collect":
        return steps
    return max(50, steps // 50 * 50)


def kernel_wrappers() -> dict:
    """Each kernel's wrapper by kernel name; a wrapper's ``launches`` counts
    the launches of its kernel."""
    from gym_multigrid_tpu_torch.ops import collect_slab, ctf_slab, maze_slab, wildfire_slab

    return {"collect_step": collect_slab.collect_step_slab,
            "collect_reset": collect_slab.collect_reset_slab,
            "collect_steps_philox": collect_slab.collect_philox_slab,
            "ctf_step": ctf_slab.ctf_step_slab, "ctf_steps": ctf_slab.ctf_ms_slab,
            "maze_step": maze_slab.maze_step_slab,
            "maze_steps_philox": maze_slab.maze_philox_slab,
            "wildfire_step": wildfire_slab.wildfire_step_slab,
            "wf_autoreset": wildfire_slab.wf_autoreset_slab,
            "wf_steps_philox": wildfire_slab.wf_philox_slab}


def episode_rollout(family: str, batch: int, device):
    """(rollout, agents an env): the family's episode rollout at ``batch``
    envs, with its benchmark config and chunk."""
    cfg, _, make_episode, agents = family_cfg(family)
    roll = make_episode(cfg, batch, device=device, chunk=CHUNKS[family])
    if roll is None:
        raise ValueError(f"{family} has no episode rollout for its benchmark config")
    return roll, agents


def chained_calls(roll, states, steps: int, calls: int):
    """``calls`` consecutive rollout calls of ``steps`` steps; returns the
    states and the last call's metrics."""
    for _ in range(calls):
        states, metrics = roll(states, steps)
    return states, metrics


def make_runner(family: str, batch: int, path: str, device, partial_view: int | None = None):
    """(env, call, agents an env): the family's ``path`` at ``batch`` envs,
    ``env.reset(seed)`` giving states and ``call(states, steps)`` stepping
    them; None for ``episode`` with ``partial_view``, which only the
    ``step`` path takes.  On a card, raises for a config off the kernel
    route."""
    if path not in PATHS:
        raise ValueError(f"unknown path {path!r}; expected one of {PATHS}")
    if path == "episode":
        if partial_view is not None:
            return None
        env, agents = episode_rollout(family, batch, device)
        call = env
    else:
        cfg, make_batch, _, agents = family_cfg(family)
        env = make_batch(cfg, batch, device=device, partial_obs_view=partial_view)
        call = env.rollout
    if env.slab.device.type != "cpu" and not env.slab.kernel:
        raise ValueError(f"{family} {path}: the benchmark config is off the kernel route")
    return env, call, agents


def per_call(n: int, calls: int):
    """``n`` launches over ``calls`` calls, a whole number where it divides."""
    q = n / calls
    return int(q) if q == int(q) else q


def timed_windows(call, states, steps: int, device, work_per_call: int):
    """JAX's ``_timed_windows``: two calls size a window, then WINDOWS
    windows of chained calls, each timed by ``utils/profiling.timed``.
    Returns (each window's work a second, kernel launches a call over the
    windows)."""
    from gym_multigrid_tpu_torch.utils.profiling import timed

    (states, _), seconds = timed(device, lambda: chained_calls(call, states, steps, 2))
    reps = max(4, int(MIN_WINDOW_S / max(seconds / 2, 1e-4)) + 1)
    wrappers = kernel_wrappers()
    for wrapper in wrappers.values():
        wrapper.launches = 0
    rates = []
    for _ in range(WINDOWS):
        (states, _), seconds = timed(device, lambda: chained_calls(call, states, steps, reps))
        rates.append(work_per_call * reps / seconds)
    launches = {name: per_call(w.launches, WINDOWS * reps)
                for name, w in wrappers.items() if w.launches}
    return rates, launches


def measure(family: str, batch: int, steps: int, path: str, device,
            partial_view: int | None = None):
    """One (family, path) at ``batch`` envs and ``steps`` steps a call:
    {"value": the best window's agent-steps/s, "windows", "launches",
    "device": the card's label, "backend": "cuda" or "cpu"}, or None where
    the path does not take ``partial_view``."""
    from gym_multigrid_tpu_torch.utils.profiling import card_label

    made = make_runner(family, batch, path, device, partial_view)
    if made is None:
        return None
    env, call, agents = made
    dev = env.slab.device
    states, _ = env.reset(0)
    states, metrics = call(states, steps)  # untimed: kernels loaded, allocator warm
    float(metrics["reward_sum"])
    rates, launches = timed_windows(call, states, steps, dev, batch * steps * agents)
    return {"value": max(rates), "windows": rates, "launches": launches,
            "device": card_label(dev), "backend": dev.type}


def record(metric: str, m: dict, baseline: float) -> dict:
    """The JSON line of measurement ``m``."""
    value = round(m["value"], 1)
    return {"metric": metric, "value": value, "unit": "agent-steps/s",
            "vs_baseline": round(value / baseline, 2), "device": m["device"],
            "windows": m["windows"], "kernel_launches_per_call": m["launches"]}


def require_card(cpu: bool, name: str) -> None:
    """Exit nonzero, before any work, when the run needs a card and there
    is none."""
    if not cpu and not torch.cuda.is_available():
        sys.exit(f"{name}: no CUDA device; pass --cpu to run the plain versions on the CPU")


def run_isolated(families: list[str], args) -> list[dict]:
    """Each family in a fresh process; echoes and returns their lines, and
    exits nonzero after the last family if any process did."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    lines, failed = [], []
    for family in families:
        sub = [sys.executable, "-m", "gym_multigrid_tpu_torch.scripts.bench_all",
               "--families", family, "--batch", str(args.batch), "--reps", str(args.reps)]
        if args.steps is not None:
            sub += ["--steps", str(args.steps)]
        if args.all_paths:
            sub.append("--all-paths")
        if args.cpu:
            sub.append("--cpu")
        if args.partial_obs is not None:
            sub += ["--partial-obs", str(args.partial_obs)]
        out = subprocess.run(sub, capture_output=True, text=True, timeout=FAMILY_TIMEOUT_S,
                             env=env, cwd=REPO)
        for ln in out.stdout.splitlines():
            if ln.startswith("{"):
                print(ln, flush=True)
                lines.append(json.loads(ln))
        if out.returncode != 0:
            sys.stderr.write(out.stderr[-2000:] + "\n")
            failed.append(family)
    if failed:
        sys.exit(f"bench_all: the process of {', '.join(failed)} exited nonzero")
    return lines


def main(argv=None) -> list[dict]:
    p = argparse.ArgumentParser()
    p.add_argument("--families", default=",".join(FAMILIES))
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--steps", type=int, default=None,
                   help="steps a call (default: the family's MS_STEPS)")
    p.add_argument("--reps", type=int, default=4,
                   help="accepted and unused, as in JAX: the windows size themselves")
    p.add_argument("--all-paths", action="store_true",
                   help="measure both paths, not just the headline")
    p.add_argument("--cpu", action="store_true", help="run on the CPU, not the CUDA device")
    p.add_argument("--partial-obs", type=int, default=None, metavar="V",
                   help="measure the step path with partial_obs_view=V")
    p.add_argument("--no-isolate", action="store_true",
                   help="measure every family in this process")
    args = p.parse_args(argv)
    require_card(args.cpu, "bench_all")
    families = args.families.split(",")
    for family in families:
        if family not in FAMILIES:
            raise ValueError(f"unknown family {family!r}; expected one of {FAMILIES}")
    if len(families) > 1 and not args.no_isolate:
        return run_isolated(families, args)

    device = "cpu" if args.cpu else None
    pov = f", pov{args.partial_obs}" if args.partial_obs is not None else ""
    lines = []
    for family in families:
        steps = align_steps(family, args.steps or MS_STEPS[family])
        if args.partial_obs is not None:
            paths = ["step"]
        else:
            headline = "step" if args.cpu else "episode"
            paths = [headline] + ([q for q in PATHS if q != headline] if args.all_paths else [])
        for path in paths:
            m = measure(family, args.batch, steps, path, device, args.partial_obs)
            metric = (f"agent-steps/sec/chip ({family}, batch {args.batch}, {path}{pov}, "
                      f"{m['backend']})")
            lines.append(record(metric, m, BASELINES[family]))
            print(json.dumps(lines[-1]), flush=True)
    return lines


if __name__ == "__main__":
    main()
