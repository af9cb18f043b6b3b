"""Evaluate a trained PPO snapshot of the port on any env family (the
port's ``scripts/evaluate.py``).

Runs thousands of batched episodes of the greedy (or, with ``--sample``,
the sampled) policy and prints ONE JSON line: mean episode return and
reward per step, and for CtF the win, loss and draw rates against the
scripted red team, plus a ``--random`` baseline column when asked.

Usage:
  python -m gym_multigrid_tpu_torch.scripts.evaluate --family ctf \\
      --model out/models/ctf_ppo --envs 256 --cpu
  python -m gym_multigrid_tpu_torch.scripts.evaluate --family wildfire --random --cpu
  python -m gym_multigrid_tpu_torch.scripts.evaluate --family ctf \\
      --model out/models/ctf_ppo --gif out/animations/ctf_eval.gif --cpu

``--model`` names a snapshot the port wrote (``train``'s full state or
``train_selfplay``'s ``models/selfplay``), without ``.npz``; snapshots of
the JAX package are not supported.  ``--gif PATH`` also saves one greedy
episode of one env as a gif (imageio).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_MAKERS = {
    "collect": "make_collect_batch",
    "ctf": "make_ctf_batch",
    "maze": "make_maze_batch",
    "wildfire": "make_wildfire_batch",
}


def policy_frames(family, cfg, net, *, seed=0, device=None):
    """One greedy episode of one env, rendered: a batch of one with no
    auto-reset (the episode ends on screen), stepped until ``term | trunc``
    or ``cfg.max_steps`` steps, one frame before the first step and one
    after each.  Returns a list of (H*T, W*T, 3) uint8 numpy frames.  On a
    CUDA device each step launches the family's step kernel once."""
    from gym_multigrid_tpu_torch.parallel import vector
    from gym_multigrid_tpu_torch.render import tiles
    from gym_multigrid_tpu_torch.rl.evaluate import make_policy

    env = getattr(vector, _MAKERS[family])(cfg, 1, device=device, auto_reset=False)
    render = getattr(tiles, f"render_{family}_batch")
    net.to(env.device)
    policy = make_policy(env, net)
    states, _ = env.reset(seed)
    frames = [render(cfg, states)[0].cpu().numpy()]
    for _ in range(cfg.max_steps):
        states, _, _, term, trunc = env.step(states, policy(env.generator, states))
        frames.append(render(cfg, states)[0].cpu().numpy())
        if bool(term[0] | trunc[0]):
            break
    return frames


def save_gif(frames, path, *, fps=5, what="rollout"):
    """Write ``frames`` to ``path`` as a gif with imageio, imported here:
    the package runs without it."""
    import imageio

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    imageio.mimsave(path, frames, duration=1000 / fps)
    print(f"saved {what} to {path}", file=sys.stderr)


def save_policy_gif(family, cfg, net, path, *, fps=5, seed=0, device=None):
    """:func:`policy_frames` saved as a gif at ``path``."""
    save_gif(policy_frames(family, cfg, net, seed=seed, device=device), path, fps=fps)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--family", default="ctf", choices=("collect", "ctf", "maze", "wildfire"))
    p.add_argument("--model", default=None,
                   help="checkpoint path without .npz (default out/models/<family>_ppo)")
    p.add_argument("--envs", type=int, default=256)
    p.add_argument("--steps", type=int, default=0,
                   help="rollout length (default 2*max_steps so every env "
                   "completes at least one episode)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sample", action="store_true",
                   help="sample the policy instead of greedy argmax")
    p.add_argument("--random", action="store_true",
                   help="also report a random-policy baseline column")
    p.add_argument("--gif", default=None,
                   help="save a greedy single-episode gif to this path")
    p.add_argument("--map", default=None)
    p.add_argument("--opponents", default="rw,rw",
                   help="ctf: comma list of red PolicySpec kinds")
    p.add_argument("--wf-size", type=int, default=8)
    p.add_argument("--wf-fires", type=int, default=1)
    p.add_argument("--wf-spread", type=float, default=0.15)
    p.add_argument("--wf-max-steps", type=int, default=50)
    p.add_argument("--burn-penalty", type=float, default=1.0)
    p.add_argument("--cpu", action="store_true", help="run on the CPU, not the CUDA device")
    args = p.parse_args(argv)

    import torch

    from gym_multigrid_tpu_torch.rl.evaluate import evaluate, evaluate_ctf, load_params
    from gym_multigrid_tpu_torch.rl.families import make_family_batch
    from gym_multigrid_tpu_torch.rl.networks import ActorCritic

    device = "cpu" if args.cpu else None
    env, cfg, num_actions, policy_agents = make_family_batch(
        args.family,
        args.envs,
        device,
        map_path=args.map,
        opponents=tuple(args.opponents.split(",")),
        wf_size=args.wf_size,
        wf_fires=args.wf_fires,
        wf_spread=args.wf_spread,
        wf_max_steps=args.wf_max_steps,
        burn_penalty=args.burn_penalty,
    )
    obs_shape = tuple(env.reset(0)[1].shape[1:])
    net = ActorCritic(num_actions, policy_agents, obs_shape=obs_shape)

    model = args.model or os.path.join("out", "models", f"{args.family}_ppo")
    if not os.path.exists(model + ".npz"):
        p.error(f"no checkpoint at {model}.npz (train first, or --model)")
    net.load_state_dict(load_params(model))

    steps = args.steps or 2 * cfg.max_steps

    def run(net, deterministic):
        if args.family == "ctf":
            return evaluate_ctf(cfg, args.envs, net, steps, seed=args.seed,
                                deterministic=deterministic, device=env.device)
        return evaluate(env, net, steps, seed=args.seed, deterministic=deterministic)

    result = {
        "family": args.family,
        "model": model,
        "envs": args.envs,
        "steps": steps,
        "deterministic": not args.sample,
        **run(net, not args.sample),
    }
    if args.random:
        # A fresh init is an untrained, near-uniform policy: the baseline a
        # trained snapshot must beat.
        rand_net = ActorCritic(num_actions, policy_agents, obs_shape=obs_shape)
        rand_net.reset_parameters(torch.Generator().manual_seed(124))
        rand = run(rand_net, False)
        result["random_baseline"] = {
            k: rand[k] for k in ("ep_return_mean", "win_rate", "episodes") if k in rand
        }
    print(json.dumps(result))

    if args.gif:
        save_policy_gif(args.family, cfg, net, args.gif, seed=args.seed, device=env.device)


if __name__ == "__main__":
    main()
