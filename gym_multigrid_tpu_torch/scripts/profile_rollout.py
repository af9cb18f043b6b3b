"""Profile a family's batched rollout: throughput, its speed-of-light
fraction and, optionally, a Chrome trace (the port's
``scripts/profile_rollout.py``).

Usage:
  python -m gym_multigrid_tpu_torch.scripts.profile_rollout [--family collect]
      [--batch 8192] [--steps 200] [--path episode|step] [--trace DIR]
      [--cpu] [--json]

Paths: ``episode``, the family's episode rollout (one K-step kernel launch
a chunk on the card), and ``step``, its ``BatchedEnv`` (a step kernel
launch a step); configs and chunks as ``bench_all.py``'s.  Prints
agent-steps/s and the fraction of the designed-traffic ceiling: the bytes
the design must move an env step are the state read and written once (once
a chunk on the episode path) plus the stream of pre-drawn actions and
uniforms written once and read once (none on the Wildfire episode path,
whose kernel makes its own draws); the ceiling is the card's memory rate
over those bytes (``utils/profiling.py`` ``sol_report`` of the whole
batch's bytes, moved once).  Traffic
the implementation adds is not counted, so the fraction bounds from below
how far the path is from the roofline.  ``--trace DIR`` profiles one more
call, writes ``DIR/trace.json`` and adds ``summarize_profile``'s device
time by kernel and idle share.

On the CPU (``--cpu``) it times the plain versions: the record says so,
and leaves the device fields ("not measured") empty.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from gym_multigrid_tpu_torch.scripts.bench_all import CHUNKS, align_steps, family_cfg

#: The card whose memory rate sets the ceiling.
CHIP = "h100-sxm"


def draws_per_env_step(family: str, path: str, env, agents: int) -> float:
    """Pre-drawn numbers an env step reads: actions and uniforms."""
    slab, cfg = env.slab, env.cfg
    if path == "step":
        cols = env.action_cols or 1
        return cols + getattr(slab, "step_draws", 0) + slab.reset_draws
    if family == "collect":  # A actions and 3 uniforms a step, a reset an episode
        return agents + 3 + slab.reset_draws / cfg.max_steps
    if family == "ctf":
        return cfg.num_blue_agents + slab.step_draws + slab.reset_draws
    if family == "maze":
        return 2
    return 0  # Wildfire: the kernel draws its own


def designed_bytes_per_env_step(family: str, path: str, env, states, agents: int) -> int:
    """Bytes an env step must move (see the module docstring)."""
    from gym_multigrid_tpu_torch.utils.profiling import state_nbytes

    state = state_nbytes(states) / env.num_envs
    rand = 4 * draws_per_env_step(family, path, env, agents)
    chunk = CHUNKS[family] if path == "episode" else 1
    return int(2 * state / chunk + 2 * rand)


def profile(family: str, batch: int, steps: int, reps: int, path: str, trace_dir,
            device) -> dict:
    import torch

    from gym_multigrid_tpu_torch.utils import profiling

    cfg, make_batch, make_episode, agents = family_cfg(family)
    if path == "episode":
        steps = align_steps(family, steps)
        env = make_episode(cfg, batch, device=device, chunk=CHUNKS[family])
        run = env
    else:
        env = make_batch(cfg, batch, device=device)
        run = env.rollout
    dev = env.slab.device
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    states, _ = env.reset(0)
    states, m = run(states, steps)  # untimed: kernels loaded, allocator warm
    float(m["reward_sum"])
    observed = None
    if trace_dir:
        sync()
        with profiling.trace(trace_dir) as prof:
            states, m = run(states, steps)
        observed = profiling.summarize_profile(prof)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        states, m = run(states, steps)
    float(m["reward_sum"])
    sync()
    seconds = time.perf_counter() - t0
    env_steps_per_s = batch * steps * reps / seconds
    bytes_per_env_step = designed_bytes_per_env_step(family, path, env, states, agents)
    # sol_report's "state" read and written once a batched step, in this
    # path's bytes model: the designed bytes of the whole batch, moved once.
    sol = profiling.sol_report(env_steps_per_s, bytes_per_env_step * batch, batch,
                               chip=CHIP, rw_factor=1.0) if on_card else None
    rec = {
        "family": family,
        "path": path,
        "batch": batch,
        "steps": steps,
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "agent_steps_per_s": env_steps_per_s * agents,
        "env_steps_per_s": env_steps_per_s,
        "state_bytes_per_env": profiling.state_nbytes(states) / batch,
        "designed_bytes_per_env_step": bytes_per_env_step,
        "chip": CHIP if on_card else None,
        "mem_ceiling_env_steps_per_s": sol.ceiling_steps_per_s * batch if on_card else None,
        "sol_fraction": sol.sol_fraction if on_card else None,
    }
    if observed is not None:
        rec["observed_profile"] = observed
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--family", default="collect",
                   choices=("collect", "ctf", "maze", "wildfire"))
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--path", default="episode", choices=("episode", "step"))
    p.add_argument("--trace", default=None, help="write a Chrome trace of one call here")
    p.add_argument("--cpu", action="store_true", help="run the plain versions on the CPU")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    rec = profile(args.family, args.batch, args.steps, args.reps, args.path, args.trace,
                  "cpu" if args.cpu else None)
    if args.json:
        print(json.dumps(rec))
    elif rec["sol_fraction"] is None:
        print(f"{args.family} {args.path} batch={args.batch} on the CPU: "
              f"{rec['agent_steps_per_s']:,.0f} agent-steps/s (device fields not measured)")
    else:
        print(f"{args.family} {args.path} batch={args.batch} on {rec['device']}: "
              f"{rec['agent_steps_per_s']:,.0f} agent-steps/s, "
              f"{rec['env_steps_per_s']:,.0f} env-steps/s against a designed-traffic ceiling of "
              f"{rec['mem_ceiling_env_steps_per_s']:,.0f} ({100 * rec['sol_fraction']:.2f}% of "
              f"{rec['chip']}'s memory rate, {rec['designed_bytes_per_env_step']} B an env-step)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
