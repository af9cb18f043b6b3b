"""A real multi-process run of the port's training stack over
``torch.distributed`` (the port's ``scripts/multihost_dryrun.py``).

Launcher (default):
  python -m gym_multigrid_tpu_torch.scripts.multihost_dryrun [--num-processes 2]
      [--device cpu|cuda] [--backend gloo|nccl] [--steps 2] [--rollout-steps 16]
      [--out FILE] [--timeout 300]

starts ``--num-processes`` workers on this host, which meet through a
``file://`` store in a temporary directory (no TCP port), and writes one
JSON record: ``ok``, ``num_processes``, ``workers_agree`` (the parameters
bit-equal across ranks after every train step), ``update_max_rel_err`` (the
W-rank update of a fixed global buffer against one process's update of the
whole buffer at ``shuffle_blocks = W``, largest relative parameter
difference) and ``rollout_episodes``.  When a worker fails or the run
outlasts ``--timeout``, it stops the others and exits non-zero.

Each worker runs the config of JAX's dryrun: Collect
``quadrants_respawn`` with ``max_steps=8``, ``num_envs = max(8 W, 16)``,
``PPOConfig(rollout_len=8, num_epochs=2, num_minibatches=2)`` (W shuffle blocks);
``--steps`` data-parallel train steps, then a sharded rollout of
``--rollout-steps`` steps.  The default device is CUDA (NCCL); ``--device
cpu`` runs the plain versions under gloo, and ``--device cuda --backend
gloo`` puts every rank on the card's device ``rank % device_count``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

RESULT = "MULTIHOST_RESULT "
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class WorkerError(RuntimeError):
    """A worker exited non-zero, printed no result, or the run timed out."""


def add_worker_flags(p: argparse.ArgumentParser) -> None:
    """The flags :func:`launch` gives each worker."""
    p.add_argument("--rank", type=int, default=None, help="worker mode (set by the launcher)")
    p.add_argument("--world-size", type=int, default=None)
    p.add_argument("--init-file", default=None, help="the file:// store of the rendezvous")


def launch(argv: list[str], num_processes: int, timeout: float) -> list[dict]:
    """Run ``num_processes`` workers ``argv + [--rank i --world-size W
    --init-file F]`` (``F`` a store in a fresh temporary directory) and
    return each rank's record, the JSON its line ``MULTIHOST_RESULT {...}``
    holds.  Polls them; when one exits non-zero or ``timeout`` seconds
    pass, kills the rest and raises :class:`WorkerError` with the tail of
    each output."""
    tmp = tempfile.mkdtemp(prefix="multihost_")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # Every rank runs on this host: gloo's transport goes over loopback.
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs, logs = [], []
    try:
        for rank in range(num_processes):
            logs.append(open(os.path.join(tmp, f"rank{rank}.log"), "w+"))
            procs.append(subprocess.Popen(
                [*argv, "--rank", str(rank), "--world-size", str(num_processes),
                 "--init-file", os.path.join(tmp, "store")],
                stdout=logs[-1], stderr=subprocess.STDOUT, env=env, cwd=REPO,
            ))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
        timed_out = any(p.poll() is None for p in procs)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outputs = []
        for log in logs:
            log.seek(0)
            outputs.append(log.read())
        rcs = [p.returncode for p in procs]
        records = [_scrape(out) for out in outputs]
        if timed_out or any(rcs) or None in records:
            tails = "\n".join(f"--- rank {i} (exit {rc}) ---\n{out[-3000:]}"
                              for i, (rc, out) in enumerate(zip(rcs, outputs)))
            why = f"timed out after {timeout} s" if timed_out else f"exit codes {rcs}"
            raise WorkerError(f"{why}\n{tails}")
        return records
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _scrape(output: str) -> dict | None:
    for line in output.splitlines():
        if line.startswith(RESULT):
            return json.loads(line[len(RESULT):])
    return None


def report(record: dict) -> None:
    """Print a worker's record as the line :func:`launch` reads."""
    print(RESULT + json.dumps(record), flush=True)


def start_worker(args, backend: str | None = None):
    """Join the run's process group (``backend`` by default NCCL on CUDA,
    gloo on the CPU) and return its mesh; torch single-threaded, as the
    ranks share the host's cores."""
    import torch

    from gym_multigrid_tpu_torch.parallel.mesh import distributed_initialize, make_mesh

    torch.set_num_threads(1)
    distributed_initialize(backend=backend, init_method=f"file://{args.init_file}",
                           rank=args.rank, world_size=args.world_size, device=args.device)
    return make_mesh()


def param_digest(net) -> str:
    """sha256 of the parameters' bytes: equal only where bit-equal."""
    h = hashlib.sha256()
    for p in net.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def global_buffer(T: int, B: int, seed: int, device):
    """A fixed (T, B) Collect rollout buffer made from a numpy seed: obs,
    actions, log-probabilities, values, rewards, terminations and
    truncations mixed, bootstrap values; and the last values (B,)."""
    import numpy as np
    import torch

    from gym_multigrid_tpu_torch.rl.ppo import Transition

    rng = np.random.default_rng(seed)
    u = rng.random((T, B))
    data = dict(
        obs=rng.integers(0, 11, (T, B, 10, 10, 3)).astype(np.uint8),
        actions=rng.integers(0, 4, (T, B, 2)).astype(np.int32),
        logp=rng.normal(-2.8, 0.3, (T, B)).astype(np.float32),
        value=rng.normal(size=(T, B)).astype(np.float32),
        reward=rng.integers(0, 2, (T, B)).astype(np.float32),
        terminated=(u < 0.15).astype(np.float32),
        truncated=((u >= 0.15) & (u < 0.3)).astype(np.float32),
        boot_value=rng.normal(size=(T, B)).astype(np.float32),
    )
    traj = Transition(**{k: torch.from_numpy(v).to(device) for k, v in data.items()})
    return traj, torch.from_numpy(rng.normal(size=B).astype(np.float32)).to(device)


def update_rel_err(mesh, device, num_minibatches: int, T: int = 8, B: int = 16) -> float:
    """The W-rank update of a fixed global buffer (this rank's envs) against
    one process's update of the whole buffer at ``shuffle_blocks = W``,
    both from the same params and shuffle generator, float32 activations:
    :func:`param_rel_err`."""
    import torch

    from gym_multigrid_tpu_torch.rl.networks import ActorCritic
    from gym_multigrid_tpu_torch.rl.ppo import PPOConfig, make_optimizer, make_update_fn

    W, r = mesh.world_size, mesh.rank
    B = B * W
    traj, last_value = global_buffer(T, B, seed=5, device=device)
    cfg = PPOConfig(rollout_len=T, num_epochs=2, num_minibatches=num_minibatches,
                    shuffle_blocks=W)
    nets = []
    for m in (None, mesh):
        net = ActorCritic(4, 2, (64, 64), activation_dtype=torch.float32,
                          obs_shape=(10, 10, 3)).to(device)
        net.reset_parameters(torch.Generator().manual_seed(3))
        update = make_update_fn(net, make_optimizer(net, cfg), cfg, m)
        k = B // W if m is not None else B
        rows = slice(r * k, (r + 1) * k) if m is not None else slice(None)
        update(type(traj)(*(x[:, rows] for x in traj)), last_value[rows],
               torch.Generator(device=device).manual_seed(7))
        nets.append(net)
    return param_rel_err(nets[1], nets[0])


def param_rel_err(net, ref) -> float:
    """The largest parameter difference of ``net`` from ``ref`` over the
    largest parameter of ``ref``."""
    pairs = [(a.detach(), b.detach()) for a, b in zip(net.parameters(), ref.parameters())]
    return max(float((a - b).abs().max()) for a, b in pairs) / max(
        float(b.abs().max()) for _, b in pairs)


def run_worker(args) -> None:
    import torch
    import torch.distributed as dist

    from gym_multigrid_tpu_torch.envs.collect import CollectConfig
    from gym_multigrid_tpu_torch.parallel.mesh import fold_in_axis
    from gym_multigrid_tpu_torch.parallel.shard import sharded_rollout
    from gym_multigrid_tpu_torch.parallel.vector import make_collect_batch
    from gym_multigrid_tpu_torch.rl.networks import ActorCritic
    from gym_multigrid_tpu_torch.rl.ppo import PPOConfig, make_ppo

    mesh = start_worker(args, args.backend)
    try:
        W, device = mesh.world_size, mesh.device
        # Short episodes, so every env truncates inside a rollout.
        cfg = CollectConfig(layout="quadrants_respawn", respawn=True, max_steps=8)
        num_envs = max(8 * W, 16)
        env = make_collect_batch(cfg, num_envs, device=device)
        net = ActorCritic(4, cfg.num_agents, obs_shape=(cfg.size, cfg.size, 3))
        ppo_cfg = PPOConfig(rollout_len=8, num_epochs=2, num_minibatches=2)
        init_fn, train_step = make_ppo(env, net, ppo_cfg, mesh)
        _, carry = init_fn(0)
        gen = torch.Generator(device=device).manual_seed(fold_in_axis(1, mesh))
        losses, episodes, digests = [], [], []
        t0 = time.perf_counter()
        for _ in range(args.steps):
            carry, metrics = train_step(carry, gen)
            losses.append(float(metrics["loss"]))
            episodes.append(int(metrics["episodes"]))
            digests.append(param_digest(net))
        train_s = time.perf_counter() - t0
        rollout = sharded_rollout(env, mesh)
        states, _ = rollout.reset(2)
        _, roll = rollout(states, args.rollout_steps)
        errs = {nm: update_rel_err(mesh, device, nm) for nm in (1, 2)}
        report({
            "rank": mesh.rank, "world_size": W, "device": str(device),
            "backend": dist.get_backend(), "num_envs": num_envs, "losses": losses,
            "train_episodes": episodes, "param_digests": digests,
            "rollout_episodes": int(roll["episodes"]),
            "rollout_reward_sum": float(roll["reward_sum"]),
            "update_rel_err": errs, "train_seconds": train_s,
        })
    finally:
        dist.destroy_process_group()


def run_launcher(args) -> int:
    argv = [sys.executable, "-m", "gym_multigrid_tpu_torch.scripts.multihost_dryrun",
            "--device", args.device, "--steps", str(args.steps),
            "--rollout-steps", str(args.rollout_steps)]
    if args.backend:
        argv += ["--backend", args.backend]
    try:
        results = launch(argv, args.num_processes, args.timeout)
    except WorkerError as e:
        sys.stderr.write(f"{e}\n")
        print(json.dumps({"ok": False, "num_processes": args.num_processes,
                          "error": str(e).splitlines()[0]}))
        return 1
    workers_agree = all(r["param_digests"] == results[0]["param_digests"]
                        and r["losses"] == results[0]["losses"] for r in results)
    update_err = max(max(r["update_rel_err"].values()) for r in results)
    episodes = results[0]["rollout_episodes"]
    ok = (workers_agree and update_err <= 1e-5 and episodes > 0
          and all(r["rollout_episodes"] == episodes for r in results))
    record = {
        "ok": ok,
        "num_processes": args.num_processes,
        "device": results[0]["device"],
        "backend": results[0]["backend"],
        "num_envs": results[0]["num_envs"],
        "train_steps": args.steps,
        "losses": results[0]["losses"],
        "train_episodes": results[0]["train_episodes"],
        "workers_agree": workers_agree,
        "update_rel_err": results[0]["update_rel_err"],
        "update_max_rel_err": update_err,
        "rollout_episodes": episodes,
        "rollout_reward_sum": results[0]["rollout_reward_sum"],
        "train_seconds_per_process": [r["train_seconds"] for r in results],
    }
    if args.out:
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=2)
            f.write("\n")
    print(json.dumps(record))
    return 0 if ok else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--num-processes", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    p.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                   help="default: NCCL on CUDA, gloo on the CPU")
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--rollout-steps", type=int, default=16)
    p.add_argument("--out", default=None)
    p.add_argument("--timeout", type=float, default=300)
    add_worker_flags(p)
    args = p.parse_args(argv)
    if args.rank is not None:
        run_worker(args)
        return 0
    if args.out:
        from gym_multigrid_tpu_torch.scripts import out_path

        args.out = out_path(args.out)
    return run_launcher(args)


if __name__ == "__main__":
    sys.exit(main())
