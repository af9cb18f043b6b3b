"""PPO training on CtF MvN (the port's ``scripts/train_mvn_ctf_rl.py``),
the replacement for the reference's SB3 script
(``scripts/main_mvn_ctf_rl.py``).

Usage:
  python -m gym_multigrid_tpu_torch.scripts.train_mvn_ctf_rl [--iters N] [--envs B]
      [--map PATH] [--opponents rw,rw] [--out out] [--cpu]

Instead of one Python env and SB3's PPO, the rollout is a batch of CtF envs
with the scripted red team inside the step (``make_ctf_batch``: on the
card one ``ctf_step`` launch a rollout step), and the learner is the
port's PPO (``rl/ppo.py``) through the shared loop (``rl/trainer.py``
``train_loop``).  Runs on the current CUDA device, or on the CPU with
``--cpu``.

Outputs, as the reference script's: the full training state at
``<out>/models/ctf_ppo.npz`` (resumed when present), metrics under
``<out>/logs``, and one greedy episode of the trained blue team at
``<out>/animations/ctf_ppo.gif``, played through the per-env functions
that ``CtFMvNEnv`` wraps (``envs/ctf.py`` ``make_ctf``).  ``--out`` may
not lie under ``artifacts/``, which holds the JAX package's records.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--envs", type=int, default=512)
    p.add_argument("--rollout-len", type=int, default=64)
    p.add_argument("--minibatches", type=int, default=8)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ent-coef", type=float, default=0.01)
    p.add_argument("--map", default=None,
                   help="CtF map file (default: the checkout's tests/assets/board.txt)")
    p.add_argument(
        "--opponents",
        default="rw,rw",
        help="comma list of red PolicySpec kinds (rw/fight/capture/"
        "patrol/patrol_fight), one per red agent",
    )
    p.add_argument("--out", default="out")
    p.add_argument(
        "--obs-buffer-dtype",
        default=None,
        help="store rollout obs in this integer dtype (e.g. int8): a 4x "
        "smaller PPO buffer, numerically identical for these small-int obs",
    )
    p.add_argument("--cpu", action="store_true", help="run on the CPU, not the CUDA device")
    p.add_argument(
        "--no-tensorboard",
        action="store_true",
        help="CSV metrics only (skip TB event files)",
    )
    return p.parse_args(argv)


def train(args):
    """Build the CtF MvN batch and the learner from ``args`` and run
    ``train_loop``.  Returns (cfg, net, the last iteration's metrics)."""
    from gym_multigrid_tpu_torch.envs.ctf import NUM_ACTIONS
    from gym_multigrid_tpu_torch.parallel.vector import make_ctf_batch
    from gym_multigrid_tpu_torch.rl.families import make_ctf_cfg
    from gym_multigrid_tpu_torch.rl.networks import ActorCritic
    from gym_multigrid_tpu_torch.rl.ppo import PPOConfig
    from gym_multigrid_tpu_torch.rl.trainer import train_loop

    cfg = make_ctf_cfg(args.map, tuple(args.opponents.split(",")))
    env = make_ctf_batch(cfg, args.envs, "cpu" if args.cpu else None)
    obs_shape = tuple(env.encode(cfg, env.reset(0)[0]).shape[1:])
    net = ActorCritic(NUM_ACTIONS, cfg.num_blue_agents, obs_shape=obs_shape)
    ppo_cfg = PPOConfig(
        rollout_len=args.rollout_len,
        num_epochs=args.epochs,
        num_minibatches=args.minibatches,
        lr=args.lr,
        ent_coef=args.ent_coef,
        obs_buffer_dtype=args.obs_buffer_dtype,
    )
    # Shared loop: full-state resume (with the batch guard), CSV and
    # TensorBoard metrics with a step axis coupled to the resume (the
    # reference wires tensorboard_log through SB3, main_mvn_ctf_rl.py:31).
    *_, metrics = train_loop(
        env,
        net,
        ppo_cfg,
        iters=args.iters,
        out=args.out,
        model_name="ctf_ppo",
        use_tensorboard=not args.no_tensorboard,
    )
    return cfg, net, metrics


def _greedy_actions(net, obs) -> np.ndarray:
    """The blue team's argmax actions for one env's observation."""
    with torch.no_grad():
        logits, _ = net(torch.as_tensor(obs, device=next(net.parameters()).device)[None])
    return logits[0].argmax(dim=-1).to(torch.int32).cpu().numpy()


def greedy_episode_frames(cfg, net, *, seed: int = 0, device=None):
    """One greedy episode of one env of ``cfg``, rendered, through the
    gymnasium-free per-env functions that ``CtFMvNEnv`` wraps when every
    red policy is a stock one (``envs/ctf.py`` ``make_ctf``: the reds act
    inside the step).  One frame after the reset and one after each step,
    until ``terminated | truncated``.  Returns a list of (H*T, W*T, 3)
    uint8 numpy frames.  On a CUDA device each step launches ``ctf_step``
    once."""
    from gym_multigrid_tpu_torch.envs.ctf import make_ctf
    from gym_multigrid_tpu_torch.ops import _build
    from gym_multigrid_tpu_torch.render.tiles import render_ctf

    device = _build.default_device(device, "greedy_episode_frames")
    fns = make_ctf(cfg, device)
    net.to(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    state = fns.reset_fn(generator)
    frames = [render_ctf(cfg, state)]
    while True:
        state, _, _, terminated, truncated, _ = fns.step_fn(
            state, _greedy_actions(net, fns.obs_fn(state)), generator)
        frames.append(render_ctf(cfg, state))
        if bool(terminated | truncated):
            return frames


def main(argv=None) -> str:
    """Train, then save the greedy episode's gif; returns its path."""
    from gym_multigrid_tpu_torch.scripts import out_path
    from gym_multigrid_tpu_torch.scripts.evaluate import save_gif

    args = parse_args(argv)
    args.out = out_path(args.out)
    cfg, net, _ = train(args)
    frames = greedy_episode_frames(cfg, net, device="cpu" if args.cpu else None)
    gif = os.path.join(args.out, "animations", "ctf_ppo.gif")
    save_gif(frames, gif, fps=5)
    return gif

if __name__ == "__main__":
    main()
