"""Self-play PPO on CtF MvN: both teams learn (the port's
``scripts/train_selfplay.py``, over ``rl/selfplay.py``).

Red is a second learned policy optimising the negated team reward.  After
training, blue is scored head to head against the final red, and against
the scripted red teams (rw, and fight + capture) to show transfer beyond
the self-play opponent; the results go to ``<out>/eval.json``.

League mode (``--pool-size N``) mixes in frozen past red snapshots: a
fraction of the batch plays a pool opponent drawn each iteration.

  python -m gym_multigrid_tpu_torch.scripts.train_selfplay --cpu --iters 8 --envs 32
  python -m gym_multigrid_tpu_torch.scripts.train_selfplay --iters 300 --envs 2048 \\
      --pool-size 8 --league-fraction 0.5 --snapshot-every 25

Writes ``<out>/logs/metrics.csv``, the full state (both nets, both
optimizers, the pool, the batch, the generators, the iteration) to
``<out>/models/selfplay_state`` for ``--resume``, and the policies to
``<out>/models/selfplay`` (``blue_params``, ``red_params`` and, in league
mode, the filled ``pool`` slots) for ``evaluate`` and ``league_matrix``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import fields

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LOG_KEYS = ("blue_loss", "red_loss", "blue_reward_per_step", "blue_entropy", "red_entropy",
            "ep_return_mean", "episodes")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--envs", type=int, default=512)
    p.add_argument("--rollout-len", type=int, default=32)
    p.add_argument("--minibatches", type=int, default=8)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ent-coef", type=float, default=0.01)
    p.add_argument("--map", default="tests/assets/board.txt")
    p.add_argument("--obs-buffer-dtype", default="int8")
    p.add_argument("--out", default="out/selfplay")
    p.add_argument("--eval-envs", type=int, default=512)
    p.add_argument("--eval-steps", type=int, default=400)
    p.add_argument("--pool-size", type=int, default=0,
                   help="league mode: frozen red snapshots to keep (0 = plain self-play)")
    p.add_argument("--league-fraction", type=float, default=0.5,
                   help="fraction of envs playing a pool opponent")
    p.add_argument("--snapshot-every", type=int, default=25,
                   help="iterations between red snapshots into the pool")
    p.add_argument("--resume", action="store_true",
                   help="continue from <out>/models/selfplay_state.npz (full state: both "
                        "nets, Adam moments, pool, env batch, generators, iteration)")
    p.add_argument("--checkpoint-every", type=int, default=50,
                   help="iterations between full-state checkpoints (0 = only at the end)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU, not the CUDA device")
    p.add_argument("--no-tensorboard", action="store_true")
    args = p.parse_args(argv)
    from gym_multigrid_tpu_torch.scripts import out_path

    args.out = out_path(args.out)

    import torch

    from gym_multigrid_tpu_torch.rl.evaluate import evaluate_ctf, evaluate_ctf_match
    from gym_multigrid_tpu_torch.rl.families import make_ctf_cfg
    from gym_multigrid_tpu_torch.rl.ppo import PPOConfig, RolloutCarry
    from gym_multigrid_tpu_torch.rl.selfplay import (
        make_ctf_selfplay_batch,
        make_league_ppo,
        make_selfplay_ppo,
    )
    from gym_multigrid_tpu_torch.utils.checkpoint import load_state, save_state
    from gym_multigrid_tpu_torch.utils.logging import MetricsLogger

    device = "cpu" if args.cpu else None
    map_path = args.map if os.path.isabs(args.map) else os.path.join(_ROOT, args.map)

    def ctf_cfg(opponents):
        return make_ctf_cfg(map_path, opponents)

    cfg = ctf_cfg(("rw", "rw"))  # enemy_policies unused in self-play
    env = make_ctf_selfplay_batch(cfg, args.envs, device=device)
    ppo_cfg = PPOConfig(
        lr=args.lr,
        ent_coef=args.ent_coef,
        rollout_len=args.rollout_len,
        num_epochs=args.epochs,
        num_minibatches=args.minibatches,
        obs_buffer_dtype=args.obs_buffer_dtype or None,
    )
    if args.pool_size:
        init_fn, train_step, snapshot_fn, (blue_net, red_net) = make_league_ppo(
            env, cfg, ppo_cfg, pool_size=args.pool_size, league_fraction=args.league_fraction)
        state = init_fn(0)
        sp = state.sp
    else:
        init_fn, train_step, (blue_net, red_net) = make_selfplay_ppo(env, cfg, ppo_cfg)
        snapshot_fn = None
        state = sp = init_fn(0)
    gen = torch.Generator(device=env.device).manual_seed(1)

    state_path = os.path.join(args.out, "models", "selfplay_state")
    run_flags = {"envs": args.envs, "pool_size": args.pool_size,
                 "league_fraction": args.league_fraction if args.pool_size else None}
    start_it = 0
    if args.resume and os.path.exists(state_path + ".npz"):
        snap = load_state(state_path)
        if snap["flags"] != run_flags:
            raise SystemExit(
                f"--resume: snapshot at {state_path}.npz was written with different "
                f"flags {snap['flags']} (now {run_flags}) — train with the same "
                "configuration or start fresh"
            )
        blue_net.load_state_dict(snap["blue_net"])
        red_net.load_state_dict(snap["red_net"])
        sp.blue_opt.load_state_dict(snap["blue_opt"])
        sp.red_opt.load_state_dict(snap["red_opt"])
        states = type(sp.states.env)(**{k: v.to(env.device) for k, v in snap["env"].items()})
        sp = sp._replace(states=RolloutCarry(states, snap["run_return"].to(env.device)))
        env.generator.set_state(snap["env_generator"])
        gen.set_state(snap["generator"])
        if args.pool_size:
            pool = [{k: v.to(env.device) for k, v in slot.items()} for slot in snap["pool"]]
            train_step.opponents.set_state(snap["opponents"])
            state = state._replace(sp=sp, pool=pool, filled=snap["filled"], slot=snap["slot"])
        else:
            state = sp
        start_it = snap["iter"]
        print(f"resumed full self-play state at iter {start_it} from {state_path}.npz")

    def save(it):
        sp = state.sp if args.pool_size else state
        snap = {
            "flags": run_flags, "iter": it,
            "blue_net": blue_net.state_dict(), "red_net": red_net.state_dict(),
            "blue_opt": sp.blue_opt.state_dict(), "red_opt": sp.red_opt.state_dict(),
            "env": {f.name: getattr(sp.states.env, f.name) for f in fields(sp.states.env)},
            "run_return": sp.states.run_return,
            "env_generator": env.generator.get_state(), "generator": gen.get_state(),
        }
        if args.pool_size:
            snap.update(pool=state.pool, filled=state.filled, slot=state.slot,
                        opponents=train_step.opponents.get_state())
        save_state(state_path, snap)

    logger = MetricsLogger(os.path.join(args.out, "logs"),
                           use_tensorboard=not args.no_tensorboard)
    steps_per_iter = args.envs * args.rollout_len
    for it in range(start_it, args.iters):
        t0 = time.perf_counter()
        state, metrics = train_step(state, gen)
        # one read of the device an iteration, for the log line
        row = dict(zip(LOG_KEYS, torch.stack([metrics[k].float() for k in LOG_KEYS]).tolist()))
        sps = steps_per_iter / (time.perf_counter() - t0)
        row["env_steps_per_sec"] = sps
        logger.log(it, row)
        if it % 10 == 0 or it == args.iters - 1:
            print(f"iter {it:4d}  blue_loss {row['blue_loss']:+.4f}  red_loss "
                  f"{row['red_loss']:+.4f}  blue r/step {row['blue_reward_per_step']:+.4f}  "
                  f"env-steps/s {sps:,.0f}")
        if snapshot_fn is not None and (it + 1) % args.snapshot_every == 0:
            state = snapshot_fn(state)
        if args.checkpoint_every and (it + 1) % args.checkpoint_every == 0:
            save(it + 1)
    logger.close()
    save(max(args.iters, start_it))

    snapshot = {"blue_params": blue_net.state_dict(), "red_params": red_net.state_dict()}
    if args.pool_size:
        # the filled pool slots: league_matrix scores blue against each
        snapshot["pool"] = state.pool[: state.filled]
    save_state(os.path.join(args.out, "models", "selfplay"), snapshot)

    # head to head: final blue against final red (learned, not scripted)
    results = {"final_red": evaluate_ctf_match(
        ctf_cfg(("rw", "rw")), args.eval_envs, blue_net, None, red_net, None,
        args.eval_steps, seed=11, device=env.device)}
    print("eval vs final_red: " + json.dumps(results["final_red"]))
    # transfer: the self-play blue against the scripted red teams
    for name, opp in (("rw", ("rw", "rw")), ("fight_capture", ("fight", "capture"))):
        results[name] = evaluate_ctf(ctf_cfg(opp), args.eval_envs, blue_net, args.eval_steps,
                                     seed=7, device=env.device)
        print(f"eval vs {name}: " + json.dumps(results[name]))
    with open(os.path.join(args.out, "eval.json"), "w") as f:
        json.dump(results, f, indent=1)
        f.write("\n")
    print(f"artifacts in {args.out}")


if __name__ == "__main__":
    main()
