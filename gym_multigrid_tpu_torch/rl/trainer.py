"""The shared PPO training loop: resume, metric logging, checkpointing
(PyTorch port of ``gym_multigrid_tpu/rl/trainer.py``).

* A full-state resume (module and optimizer state, env states, running
  returns, both generators) when the snapshot's env batch matches; the
  network's parameters only when it does not.
* The metrics step axis follows the model: a resumed model continues the
  existing CSV/TensorBoard axis; a fresh one rotates a stale log directory
  aside so that curves never interleave two runs.

The JAX trainer's legacy snapshot layouts and its ``iters_per_call`` (a
scan of iterations per remote dispatch, a TPU workaround) are not ported.
"""

from __future__ import annotations

import os
import time
from dataclasses import fields

import torch

from gym_multigrid_tpu_torch.rl.ppo import PPOConfig, RolloutCarry, make_ppo
from gym_multigrid_tpu_torch.utils.checkpoint import load_state, save_state
from gym_multigrid_tpu_torch.utils.logging import MetricsLogger

LOG_KEYS = (
    "loss", "pg_loss", "v_loss", "entropy", "reward_per_step",
    "ep_return_mean", "episodes", "approx_kl", "clip_fraction",
    "explained_variance",
)


def _rotate_stale_logs(logdir: str) -> None:
    """Move a non-empty log directory aside as ``<logdir>.oldN``, the whole
    of it: TensorBoard reads every event file in a directory as one run."""
    if not (os.path.isdir(logdir) and os.listdir(logdir)):
        return
    n = 1
    while os.path.exists(f"{logdir}.old{n}"):
        n += 1
    os.rename(logdir, f"{logdir}.old{n}")


def _snapshot(net, optimizer, carry: RolloutCarry, env, generator) -> dict:
    return {
        "net": net.state_dict(),
        "optimizer": optimizer.state_dict(),
        "env": {f.name: getattr(carry.env, f.name) for f in fields(carry.env)},
        "run_return": carry.run_return,
        "env_generator": env.generator.get_state(),
        "generator": generator.get_state(),
    }


def resume_or_init(init_fn, model_path: str, env, net):
    """(optimizer, carry, generator, resumed) from ``<model_path>.npz`` or a
    fresh init: ``init_fn(0)`` and the learner's generator seeded with 1
    on ``env.device``, then whatever the snapshot supplies loaded over
    them."""
    optimizer, carry = init_fn(0)
    generator = torch.Generator(device=env.device).manual_seed(1)
    if not os.path.exists(model_path + ".npz"):
        return optimizer, carry, generator, False
    ckpt = load_state(model_path)
    net.load_state_dict(ckpt["net"])
    ck_env = ckpt["env"]
    batch = next(iter(ck_env.values())).shape[0]
    if batch != env.num_envs:
        print(f"resumed params only from {model_path}.npz "
              f"(env batch {batch} != {env.num_envs})")
        return optimizer, carry, generator, True
    optimizer.load_state_dict(ckpt["optimizer"])
    states = type(carry.env)(**{k: v.to(env.device) for k, v in ck_env.items()})
    carry = RolloutCarry(states, ckpt["run_return"].to(env.device))
    env.generator.set_state(ckpt["env_generator"])
    generator.set_state(ckpt["generator"])
    print(f"resumed full state from {model_path}.npz")
    return optimizer, carry, generator, True


def train_loop(
    env,
    net,
    ppo_cfg: PPOConfig,
    *,
    iters: int,
    out: str,
    model_name: str,
    log_subdir: str = "",
    use_tensorboard: bool = True,
    label: str = "",
):
    """Run ``iters`` PPO iterations with resume and logging, then save the
    full training state to ``<out>/models/<model_name>``.  Returns
    (optimizer, carry, generator, the last iteration's metrics as floats);
    ``net`` holds the trained parameters.

    Each iteration waits for the device once, to read its metrics for the
    log line; ``env_steps_per_sec`` is measured around that."""
    init_fn, train_step = make_ppo(env, net, ppo_cfg)
    model_path = os.path.join(out, "models", model_name)
    optimizer, carry, generator, resumed = resume_or_init(init_fn, model_path, env, net)

    logdir = os.path.join(out, "logs", log_subdir) if log_subdir else os.path.join(out, "logs")
    if not resumed:
        # A fresh model never appends to a stale curve.
        _rotate_stale_logs(logdir)
    logger = MetricsLogger(logdir, use_tensorboard=use_tensorboard)
    it0 = logger.last_step + 1 if resumed else 0

    steps_per_iter = env.num_envs * ppo_cfg.rollout_len
    host = {}
    for it in range(it0, it0 + iters):
        t0 = time.perf_counter()
        carry, metrics = train_step(carry, generator)
        keys = sorted(metrics)
        host = dict(zip(keys, torch.stack([metrics[k].float() for k in keys]).tolist()))
        sps = steps_per_iter / (time.perf_counter() - t0)
        row = {k: host[k] for k in LOG_KEYS}
        row["env_steps_per_sec"] = sps
        logger.log(it, row)
        if it % 10 == 0 or it == it0 + iters - 1:
            tag = f"[{label}] " if label else ""
            print(
                f"{tag}iter {it:4d}  loss {host['loss']:+.4f}  "
                f"reward/step {host['reward_per_step']:+.4f}  "
                f"ep_return {host['ep_return_mean']:+.3f}  "
                f"entropy {host['entropy']:.3f}  env-steps/s {sps:,.0f}"
            )
    logger.close()
    tb = " + tensorboard)" if logger.has_tensorboard else ")"
    print(f"metrics logged to {logger.logdir} (csv{tb}")
    save_state(model_path, _snapshot(net, optimizer, carry, env, generator))
    print(f"saved full training state to {model_path}.npz")
    return optimizer, carry, generator, host
