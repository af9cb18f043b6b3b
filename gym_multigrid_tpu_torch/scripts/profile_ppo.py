"""The PPO learner's roofline (the port's ``scripts/profile_ppo.py``): the
whole train step (the rollout with the network's forwards, GAE, the
minibatched clipped update) timed, beside a FLOP model of the
``ActorCritic`` and, with ``--trace``, where its device time went.

Usage:
  python -m gym_multigrid_tpu_torch.scripts.profile_ppo [--family ctf] [--envs 1048576]
      [--rollout-len 16] [--minibatches 128] [--obs-buffer-dtype int8]
      [--shuffle-blocks 0] [--iters 4] [--trace DIR] [--json] [--cpu]

Builds the learner as ``bench_ppo_scale`` does (``build_learner``), runs one
untimed train step, then ``--iters`` train steps between two CUDA events.
Prints one JSON record with JAX's keys:

- the measured env-steps/s and seconds a train step;
- ``model_flops_per_train_step``, JAX's count of the model's work: a
  forward (``2 * a * b`` FLOPs a sample for each dense layer ``a -> b``:
  the torso, the policy head, the value head) for each of the ``B * T``
  rollout samples and the ``B`` last values, and a forward and backward
  (three forwards) for each sample in each of ``num_epochs`` epochs;
- ``executed_model_flops_per_train_step``, which JAX lacks: the forwards
  the port runs, one over ``B`` rows before the rollout and one over
  ``2 B`` rows a rollout step (the next obs and the step's pre-reset obs,
  whose value is the truncation bootstrap), with the same update;
- ``achieved_model_tflops_per_s`` (the model count over the measured
  time) and ``mfu_vs_bf16_dense_peak``, its share of the card's dense bf16
  tensor-core peak (:data:`TENSOR_BF16_DENSE_FLOPS`).  The hidden layers
  run in bf16 and the two heads, about 2% of the FLOPs, in float32; the
  share is stated against the bf16 peak, as JAX states its share.  Both
  are None on the CPU, which is no device measurement, and the share is
  None, with ``mfu_note`` saying why, on a card whose peak the table lacks;
- ``rollout_obs_buffer_gb``: the rollout's observation buffer;
- ``device``: the card's name and power limit (``card_label``).

``--trace DIR`` profiles one more train step into ``DIR/trace.json`` and
adds ``observed_profile`` (``summarize_profile``, with the device time by
class of kernel) and ``binding_resource``: the host where the device idles
more than half the wall, else the class of kernels that holds the most
device time.  Without ``--cpu`` it needs a card and exits nonzero without
one.
"""

from __future__ import annotations

import argparse
import json
import math

#: Dense bf16 tensor-core peak of one card, FLOP/s (NVIDIA's data sheet:
#: the H100 SXM at 700 W, without sparsity), by ``card_chip`` key.
TENSOR_BF16_DENSE_FLOPS = {"h100-sxm": 989e12}


def mlp_dims(obs_dim: int, hidden, num_agents: int, num_actions: int):
    """Dense layer (in, out) pairs of ``networks.ActorCritic``."""
    dims = []
    d = obs_dim
    for h in hidden:
        dims.append((d, h))
        d = h
    dims.append((d, num_agents * num_actions))  # policy head
    dims.append((d, 1))  # value head
    return dims


def flops_per_sample(dims) -> tuple[float, float]:
    """(forward, forward+backward) matmul FLOPs for one sample."""
    fwd = sum(2.0 * a * b for a, b in dims)
    # backward: grad wrt activations + grad wrt weights, each the same
    # matmul volume as the forward -> 3x forward in total.
    return fwd, 3.0 * fwd


def linear_dims(net) -> list[tuple[int, int]]:
    """(in, out) of each ``nn.Linear`` of ``net``, in the order it
    registers them (the torso, the policy head, the value head)."""
    from torch import nn

    return [(m.in_features, m.out_features) for m in net.modules() if isinstance(m, nn.Linear)]


def model_flops(envs: int, rollout_len: int, num_epochs: int, fwd: float) -> float:
    """JAX's model FLOPs of a train step: a forward for each of the
    ``envs * rollout_len`` rollout samples and the ``envs`` last values,
    three forwards for each sample in each epoch."""
    samples = envs * rollout_len
    return samples * fwd + num_epochs * samples * 3.0 * fwd + envs * fwd


def executed_flops(envs: int, rollout_len: int, num_epochs: int, fwd: float) -> float:
    """The model FLOPs the port's train step runs: ``envs`` rows before the
    rollout, ``2 * envs`` a rollout step, three forwards for each sample in
    each epoch: ``envs * (1 + 2T + 3TE)`` forwards."""
    return envs * (1 + 2 * rollout_len + 3 * rollout_len * num_epochs) * fwd


def binding_resource(prof: dict) -> str:
    """What bounds a profiled train step (see the module docstring)."""
    if prof["device"] != "cuda":
        return "not measured (no device in the trace)"
    if prof["idle_share"] > 0.5:
        return f"host: the device idles {prof['idle_share']:.3f} of the wall"
    cls, share = max(prof["by_class"].items(), key=lambda kv: kv[1])
    return f"{cls} kernels: {share:.3f} of the device time"


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="The PPO learner's roofline.")
    p.add_argument("--family", default="ctf")
    p.add_argument("--envs", type=int, default=1 << 20)
    p.add_argument("--rollout-len", type=int, default=16)
    p.add_argument("--minibatches", type=int, default=128)
    p.add_argument("--obs-buffer-dtype", default="int8")
    p.add_argument("--shuffle-blocks", type=int, default=0,
                   help="PPOConfig.shuffle_blocks (0 = global shuffle)")
    p.add_argument("--iters", type=int, default=4, help="timed train steps")
    p.add_argument("--trace", default=None, help="profile one more train step into this directory")
    p.add_argument("--json", action="store_true")
    p.add_argument("--cpu", action="store_true", help="run on the CPU, not the CUDA device")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)

    from gym_multigrid_tpu_torch.scripts.bench_all import require_card

    require_card(args.cpu, "profile_ppo")

    from gym_multigrid_tpu_torch.scripts.bench_ppo_scale import build_learner
    from gym_multigrid_tpu_torch.utils.profiling import (
        card_chip,
        card_label,
        summarize_profile,
        timed,
        trace,
    )

    learner = build_learner(args.family, args)
    net, train_step, carry, generator = (
        learner.net, learner.train_step, learner.carry, learner.generator)
    dev = learner.env.device
    carry, metrics = train_step(carry, generator)  # untimed: kernels loaded, allocator warm
    float(metrics["loss"])

    def iterations():
        nonlocal carry
        for _ in range(args.iters):
            carry, m = train_step(carry, generator)
        return m

    metrics, seconds = timed(dev, iterations)
    float(metrics["loss"])
    train_step_s = seconds / args.iters

    obs_dim = math.prod(learner.obs_shape)
    dims = linear_dims(net)
    model = mlp_dims(obs_dim, net.hidden, net.num_agents, net.num_actions)
    if dims != model:
        raise ValueError(f"the net's dense layers {dims} are not the model's {model}")
    fwd, _ = flops_per_sample(dims)
    epochs = learner.ppo_cfg.num_epochs
    flops = model_flops(args.envs, args.rollout_len, epochs, fwd)
    on_card = dev.type == "cuda"
    achieved = flops / train_step_s if on_card else None
    peak = TENSOR_BF16_DENSE_FLOPS.get(card_chip(dev))
    itemsize = 1 if args.obs_buffer_dtype == "int8" else 4

    rec = {
        "workload": "ppo_train",
        "family": args.family,
        "envs": args.envs,
        "rollout_len": args.rollout_len,
        "num_minibatches": args.minibatches,
        "obs_buffer_dtype": args.obs_buffer_dtype,
        "shuffle_blocks": args.shuffle_blocks or None,
        "backend": str(dev),
        "env_steps_per_s": args.envs * args.rollout_len / train_step_s,
        "train_step_s": train_step_s,
        "obs_dim": obs_dim,
        "model_flops_per_train_step": flops,
        "executed_model_flops_per_train_step": executed_flops(
            args.envs, args.rollout_len, epochs, fwd),
        "achieved_model_tflops_per_s": achieved / 1e12 if on_card else None,
        "mfu_vs_bf16_dense_peak": achieved / peak if on_card and peak else None,
        "rollout_obs_buffer_gb": args.envs * args.rollout_len * obs_dim * itemsize / 1e9,
        "device": card_label(dev),
    }
    if on_card and not peak:
        rec["mfu_note"] = (f"no dense bf16 peak of {rec['device']} in TENSOR_BF16_DENSE_FLOPS "
                           "(an H100 SXM only): share not stated")

    if args.trace:
        with trace(args.trace) as prof:
            carry, metrics = train_step(carry, generator)
        rec["observed_profile"] = summarize_profile(prof)
        rec["binding_resource"] = binding_resource(rec["observed_profile"])

    print(json.dumps(rec) if args.json else json.dumps(rec, indent=2))
    return rec


if __name__ == "__main__":
    main()
