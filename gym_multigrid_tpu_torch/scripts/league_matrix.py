"""Empirical game matrix of a league run: the final blue against every
red in the frozen-opponent pool and the final live red (the port's
``scripts/league_matrix.py``).

The pool is the opponents' history: scoring blue against each slot shows
whether it stayed strong against past strategies.  Uses one
``make_ctf_match_evaluator`` for every pairing (learned against learned,
through the all-agent CtF step) and writes ``<run_dir>/league_matrix.json``.

    python -m gym_multigrid_tpu_torch.scripts.league_matrix out/selfplay [--envs 256] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("run_dir", help="a train_selfplay --out directory")
    p.add_argument("--envs", type=int, default=256)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--map", default="tests/assets/board.txt")
    p.add_argument("--cpu", action="store_true", help="run on the CPU, not the CUDA device")
    args = p.parse_args(argv)

    from gym_multigrid_tpu_torch.envs.ctf import NUM_ACTIONS
    from gym_multigrid_tpu_torch.rl.evaluate import make_ctf_match_evaluator
    from gym_multigrid_tpu_torch.rl.families import make_ctf_cfg
    from gym_multigrid_tpu_torch.rl.networks import ActorCritic
    from gym_multigrid_tpu_torch.rl.selfplay import make_ctf_selfplay_batch
    from gym_multigrid_tpu_torch.utils.checkpoint import load_state

    map_path = args.map if os.path.isabs(args.map) else os.path.join(_ROOT, args.map)
    ck = load_state(os.path.join(args.run_dir, "models", "selfplay"))
    if "pool" not in ck:
        raise SystemExit(
            f"{args.run_dir} has no pool — train with --pool-size to get a league snapshot"
        )
    cfg = make_ctf_cfg(map_path)
    device = "cpu" if args.cpu else None
    obs_shape = tuple(make_ctf_selfplay_batch(cfg, 1, device=device).reset(0)[1].shape[1:])
    blue_net = ActorCritic(NUM_ACTIONS, cfg.num_blue_agents, obs_shape=obs_shape)
    red_net = ActorCritic(NUM_ACTIONS, cfg.num_red_agents, obs_shape=obs_shape)
    # one evaluator for every pairing: the params are call arguments
    match = make_ctf_match_evaluator(cfg, args.envs, blue_net, red_net, args.steps,
                                     device=device)
    opponents = [(f"pool_{i}", rp) for i, rp in enumerate(ck["pool"])]
    opponents.append(("final_red", ck["red_params"]))
    rows = {}
    for name, rp in opponents:
        r = match(ck["blue_params"], rp, 17)
        rows[name] = r
        print(f"{name:>10}: win {r['win_rate']:.3f}  loss {r['loss_rate']:.3f}  "
              f"draw {r['draw_rate']:.3f}  ({r['episodes']} episodes)")
    out = os.path.join(args.run_dir, "league_matrix.json")
    with open(out, "w") as f:
        json.dump(rows, f, indent=1)
        f.write("\n")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
