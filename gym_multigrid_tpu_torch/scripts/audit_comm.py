"""What crosses processes: the collective inventory of the sharded rollout
and of the data-parallel PPO train step (the port's
``scripts/audit_comm.py``).

Usage:
  python -m gym_multigrid_tpu_torch.scripts.audit_comm [--num-processes 2]
      [--device cpu|cuda] [--per-device-envs 64] [--rollout 32]
      [--minibatches 8] [--epochs 1] [--out out/comm_audit_torch.json]
      [--train-step-time out/train_step_time_torch.json]

Starts ``--num-processes`` ranks (``multihost_dryrun.launch``).  Each runs,
under ``torch.profiler`` (``parallel/comm_audit.py`` ``audit_call``), one
call of ``sharded_rollout`` over Collect ``quadrants_respawn`` and one
``make_ppo(..., mesh)`` train step, at ``--per-device-envs`` envs a rank,
and, as the audit's canary, one ``all_gather`` of its rollout buffer's
observations, which the inventory must show.  Rank 0's inventory goes to
``--out``, beside the parameters' bytes and each call's totals: the rollout
should all-reduce only its packed scalar metrics, the train step only
gradient buckets no larger than the parameters and scalars.  The inventory
is dynamic: one entry a collective issued, so the train step's gradient
all-reduces appear once a minibatch and epoch.

The record also holds the pod efficiency model (:func:`pod_model`): the
train step's all-reduce bytes over an H100 cluster's links against the
train step's compute, as ``measure_train_step`` measured it on a card.
Without that measurement the model is skipped.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from gym_multigrid_tpu_torch.scripts.measure_train_step import (
    DEFAULT_OUT as DEFAULT_TRAIN_STEP_TIME,
)
from gym_multigrid_tpu_torch.scripts.multihost_dryrun import (
    add_worker_flags,
    launch,
    report,
    start_worker,
)


#: The H100 platform's published link rates, the pod model's stated
#: assumptions: NVLink 4 gives each GPU 900 GB/s, 450 GB/s each way, among
#: the 8 GPUs of a node (DGX H100); between nodes each GPU has one 400 Gb/s
#: InfiniBand NDR port, 50 GB/s each way.
NVLINK_BYTES_PER_S = 4.5e11
IB_BYTES_PER_S = 5.0e10
#: (devices, link rate, label) of each modelled cluster: one node, two
#: nodes and 32 nodes; a ring across nodes runs at the InfiniBand rate.
POD_POINTS = ((8, NVLINK_BYTES_PER_S, "nvlink"), (16, IB_BYTES_PER_S, "ib_2nodes"),
              (256, IB_BYTES_PER_S, "ib_32nodes"))


def pod_model(train_step_bytes: int, per_device_envs: int, rollout: int,
              measured: dict | None) -> dict:
    """JAX's pod efficiency model (its ``scripts/audit_comm.py``) on the
    H100 platform's links.  A ring all-reduce moves ``2 (n - 1) / n`` of
    the train step's all-reduced bytes through each device's link, so at
    ``n`` devices it takes ``2 (n - 1) / n * train_step_bytes / rate``;
    with no overlap the efficiency is ``compute / (compute + all_reduce)``.
    The compute is ``measured`` (``measure_train_step``'s record: its
    ``train_step_s`` at ``env_steps_per_train_step``), scaled by env-steps
    to ``per_device_envs * rollout``.  With no measurement the model is
    skipped rather than derived from a wrong compute term."""
    assumptions = {"nvlink_allreduce_bw_Bps": NVLINK_BYTES_PER_S,
                   "infiniband_bw_Bps": IB_BYTES_PER_S}
    if measured is None:
        assumptions["compute_from"] = (
            "NO MEASUREMENT — run python -m gym_multigrid_tpu_torch.scripts.measure_train_step "
            "on the card first")
        return {"assumptions": assumptions}
    scale = rollout * per_device_envs / measured["env_steps_per_train_step"]
    compute_s = measured["train_step_s"] * scale
    assumptions["compute_from"] = (
        f"measured full train step on {measured['backend']} ({measured['run_date']}): "
        f"{measured['train_step_s']:.2e} s at {measured['env_steps_per_train_step']} "
        "env-steps/step" + (f", scaled x{scale:.2f} to this config" if scale != 1 else ""))
    model = {}
    for n, rate, label in POD_POINTS:
        ar = 2 * (n - 1) / n * train_step_bytes / rate
        model[f"{label}_n{n}"] = {
            "all_reduce_s": ar,
            "compute_s_measured": compute_s,
            "efficiency_no_overlap": compute_s / (compute_s + ar),
        }
    return dict(model, assumptions=assumptions)


def read_measurement(path: str) -> dict | None:
    """``measure_train_step``'s record at ``path``, or None without one."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def describe(ops) -> dict:
    """An inventory as JSON: each op, and the totals by kind."""
    kinds = {}
    for o in ops:
        k = kinds.setdefault(o.kind, {"count": 0, "bytes": 0})
        k["count"] += 1
        k["bytes"] += o.bytes
    return {
        "ops": [{"kind": o.kind, "op_name": o.op_name, "bytes": o.bytes,
                 "shapes": [f"{dt}[{','.join(map(str, dims))}]" for dt, dims in o.shapes]}
                for o in ops],
        "by_kind": kinds,
        "bytes": sum(o.bytes for o in ops),
        "max_bytes": max((o.bytes for o in ops), default=0),
        "max_elems": max((o.max_elems for o in ops), default=0),
        "dtypes": sorted({dt for o in ops for dt, _ in o.shapes}),
    }


def audit(mesh, per_device_envs: int, rollout: int, minibatches: int, epochs: int) -> dict:
    """This rank's inventories of the three calls."""
    import torch
    import torch.distributed as dist

    from gym_multigrid_tpu_torch.envs.collect import CollectConfig
    from gym_multigrid_tpu_torch.parallel.comm_audit import audit_call
    from gym_multigrid_tpu_torch.parallel.mesh import fold_in_axis
    from gym_multigrid_tpu_torch.parallel.shard import sharded_rollout
    from gym_multigrid_tpu_torch.parallel.vector import make_collect_batch
    from gym_multigrid_tpu_torch.rl.networks import ActorCritic
    from gym_multigrid_tpu_torch.rl.ppo import PPOConfig, make_ppo

    W, device = mesh.world_size, mesh.device
    cfg = CollectConfig(layout="quadrants_respawn", respawn=True, max_steps=50)
    env = make_collect_batch(cfg, per_device_envs * W, device=device)
    roll = sharded_rollout(env, mesh)
    states, _ = roll.reset(0)
    roll(states, 1)  # untimed first call
    roll_ops = audit_call(roll, states, rollout)

    net = ActorCritic(4, cfg.num_agents, obs_shape=(cfg.size, cfg.size, 3))
    init_fn, train_step = make_ppo(env, net, PPOConfig(
        rollout_len=rollout, num_epochs=epochs, num_minibatches=minibatches), mesh)
    _, carry = init_fn(0)
    gen = torch.Generator(device=device).manual_seed(fold_in_axis(1, mesh))
    # The first step after the wrapper is built also settles its gradient
    # buckets (a broadcast of their layout from rank 0): audit the second.
    carry, _ = train_step(carry, gen)
    train_ops = audit_call(train_step, carry, gen)

    # The canary: the rollout buffer's observations gathered from every rank.
    _, traj, _, _ = train_step.rollout(carry, gen)
    gathered = [torch.empty_like(traj.obs) for _ in range(W)]
    canary_ops = audit_call(dist.all_gather, gathered, traj.obs, group=mesh.group)
    return {
        "world_size": W, "device": str(device), "backend": dist.get_backend(),
        "per_device_envs": per_device_envs, "rollout_len": rollout,
        "minibatches": minibatches, "epochs": epochs,
        "param_bytes": sum(p.numel() * p.element_size() for p in net.parameters()),
        "buffer_obs_elems": traj.obs.numel(),
        "rollout": describe(roll_ops), "train_step": describe(train_ops),
        "canary_all_gather": describe(canary_ops),
    }


def run_worker(args) -> None:
    import torch.distributed as dist

    mesh = start_worker(args)
    try:
        report(dict(audit(mesh, args.per_device_envs, args.rollout, args.minibatches,
                          args.epochs), rank=mesh.rank))
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--num-processes", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--per-device-envs", type=int, default=64)
    p.add_argument("--rollout", type=int, default=32)
    p.add_argument("--minibatches", type=int, default=8)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--timeout", type=float, default=300)
    p.add_argument("--out", default=os.path.join("out", "comm_audit_torch.json"))
    p.add_argument("--train-step-time", default=DEFAULT_TRAIN_STEP_TIME,
                   help="measure_train_step's record, the pod model's compute")
    add_worker_flags(p)
    args = p.parse_args(argv)
    if args.rank is not None:
        run_worker(args)
        return 0
    from gym_multigrid_tpu_torch.scripts import out_path

    args.out = out_path(args.out)
    records = launch([sys.executable, "-m", "gym_multigrid_tpu_torch.scripts.audit_comm",
                      "--device", args.device, "--per-device-envs", str(args.per_device_envs),
                      "--rollout", str(args.rollout), "--minibatches", str(args.minibatches),
                      "--epochs", str(args.epochs)], args.num_processes, args.timeout)
    records[0]["pod_model"] = pod_model(records[0]["train_step"]["bytes"], args.per_device_envs,
                                        args.rollout, read_measurement(args.train_step_time))
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(records[0], f, indent=2)
        f.write("\n")
    r = records[0]
    print(json.dumps({k: (r[k] if k not in ("rollout", "train_step", "canary_all_gather")
                          else r[k]["by_kind"]) for k in r}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
