"""Empirical game matrix of a league run: the final blue against every
red in the frozen-opponent pool and the final live red (the port's
``scripts/league_matrix.py``).

The pool is the opponents' history: scoring blue against each slot shows
whether it stayed strong against past strategies.  Uses one
``make_ctf_match_evaluator`` for every pairing (learned against learned,
through the all-agent CtF step) and writes ``<run_dir>/league_matrix.json``;
``--gif`` also saves one greedy match of the final blue against the final
red as ``<run_dir>/match.gif`` (imageio).

    python -m gym_multigrid_tpu_torch.scripts.league_matrix out/selfplay [--envs 256] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def match_frames(cfg, blue_net, red_net, *, seed=0, device=None):
    """One greedy learned-against-learned match of one env, rendered: a
    self-play batch of one with no auto-reset, both nets reading the same
    obs, stepped until ``term | trunc`` or ``cfg.max_steps`` steps.
    Returns a list of (H*T, W*T, 3) uint8 numpy frames, one before the
    first step and one after each."""
    import torch

    from gym_multigrid_tpu_torch.render.tiles import render_ctf_batch
    from gym_multigrid_tpu_torch.rl.selfplay import make_ctf_selfplay_batch

    env = make_ctf_selfplay_batch(cfg, 1, auto_reset=False, device=device)
    blue_net.to(env.device)
    red_net.to(env.device)
    states, obs = env.reset(seed)
    frames = [render_ctf_batch(cfg, states)[0].cpu().numpy()]
    for _ in range(cfg.max_steps):
        with torch.no_grad():
            b_act = blue_net(obs)[0].argmax(dim=-1)
            r_act = red_net(obs)[0].argmax(dim=-1)
        actions = torch.cat([b_act, r_act], dim=1).to(torch.int32)
        states, obs, _, term, trunc = env.step(states, actions)
        frames.append(render_ctf_batch(cfg, states)[0].cpu().numpy())
        if bool(term[0] | trunc[0]):
            break
    return frames


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("run_dir", help="a train_selfplay --out directory")
    p.add_argument("--envs", type=int, default=256)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--map", default="tests/assets/board.txt")
    p.add_argument("--gif", action="store_true",
                   help="also save a blue-vs-final-red match gif into <run_dir>/match.gif")
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
    if args.gif:
        from gym_multigrid_tpu_torch.scripts.evaluate import save_gif

        blue_net.load_state_dict(ck["blue_params"])
        red_net.load_state_dict(ck["red_params"])
        frames = match_frames(cfg, blue_net, red_net, device=device)
        save_gif(frames, os.path.join(args.run_dir, "match.gif"), what="match rollout")


if __name__ == "__main__":
    main()
