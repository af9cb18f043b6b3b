"""PPO training for any env family (the port's ``scripts/train.py``).

Usage:
  python -m gym_multigrid_tpu_torch.scripts.train --family wildfire --iters 200 --envs 512
  python -m gym_multigrid_tpu_torch.scripts.train --family collect --cpu --iters 50 --envs 64

Runs on the current CUDA device, where each rollout step launches the
family's step kernel, or on the CPU with ``--cpu``.  Metrics stream to
``<out>/logs/<family>`` (CSV, and TensorBoard when it imports) and the
full training state goes to ``<out>/models/<family>_ppo.npz`` (and
``.json``), from which a second run resumes.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    from gym_multigrid_tpu_torch.rl.families import FAMILIES

    p = argparse.ArgumentParser()
    p.add_argument("--family", default="wildfire", choices=list(FAMILIES))
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--envs", type=int, default=512)
    p.add_argument("--rollout-len", type=int, default=32)
    p.add_argument("--minibatches", type=int, default=8)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ent-coef", type=float, default=0.01)
    p.add_argument("--out", default="out")
    p.add_argument(
        "--opponents",
        default="rw,rw",
        help="ctf only: comma list of red PolicySpec kinds "
        "(rw/fight/capture/patrol/patrol_fight)",
    )
    p.add_argument(
        "--obs-buffer-dtype",
        default=None,
        help="store rollout obs in this integer dtype (e.g. int8) — a "
        "smaller PPO buffer, numerically identical for these small-int obs",
    )
    p.add_argument(
        "--net",
        default="mlp",
        choices=("mlp", "conv"),
        help="policy torso: flattened MLP or ConvActorCritic (use with "
        "--obs-option map for CtF/Maze grid observations)",
    )
    p.add_argument(
        "--obs-option",
        default=None,
        help="ctf: flattened/map; maze: map (default: the family's "
        "trained-artifact option)",
    )
    p.add_argument("--cpu", action="store_true", help="run on the CPU, not the CUDA device")
    p.add_argument("--no-tensorboard", action="store_true")
    p.add_argument(
        "--burn-penalty",
        type=float,
        default=1.0,
        help="wildfire only: per-ignition penalty (>= ext_reward keeps "
        "containment optimal)",
    )
    # Wildfire defaults are the controllable config: at spread 0.3 on
    # 16x16 the fire outruns two agents and training goes nowhere.
    p.add_argument("--wf-size", type=int, default=8)
    p.add_argument("--wf-fires", type=int, default=1)
    p.add_argument("--wf-spread", type=float, default=0.15)
    p.add_argument("--wf-max-steps", type=int, default=50)
    args = p.parse_args(argv)

    from gym_multigrid_tpu_torch.rl.families import make_family_batch
    from gym_multigrid_tpu_torch.rl.networks import ActorCritic, ConvActorCritic
    from gym_multigrid_tpu_torch.rl.ppo import PPOConfig
    from gym_multigrid_tpu_torch.rl.trainer import train_loop
    from gym_multigrid_tpu_torch.scripts import out_path

    args.out = out_path(args.out)

    env, cfg, num_actions, policy_agents = make_family_batch(
        args.family,
        args.envs,
        "cpu" if args.cpu else None,
        opponents=tuple(args.opponents.split(",")),
        obs_option=args.obs_option,
        burn_penalty=args.burn_penalty,
        wf_size=args.wf_size,
        wf_fires=args.wf_fires,
        wf_spread=args.wf_spread,
        wf_max_steps=args.wf_max_steps,
    )
    obs_shape = tuple(env.reset(0)[1].shape[1:])
    net_cls = ConvActorCritic if args.net == "conv" else ActorCritic
    net = net_cls(num_actions, policy_agents, obs_shape=obs_shape)
    ppo_cfg = PPOConfig(
        rollout_len=args.rollout_len,
        num_epochs=args.epochs,
        num_minibatches=args.minibatches,
        lr=args.lr,
        ent_coef=args.ent_coef,
        obs_buffer_dtype=args.obs_buffer_dtype,
    )
    train_loop(
        env,
        net,
        ppo_cfg,
        iters=args.iters,
        out=args.out,
        model_name=f"{args.family}_ppo",
        log_subdir=args.family,
        use_tensorboard=not args.no_tensorboard,
        label=args.family,
    )


if __name__ == "__main__":
    main()
