"""Multi-process runs of the port on the CPU, two ranks under gloo: the mesh
helpers, the sharded rollouts against unsharded ones with the ranks' seeds,
the data-parallel PPO update against one process's, the collective audits
(the counterparts of ``tests/test_shard_map.py``, ``tests/test_multihost.py``,
``tests/test_comm_audit.py`` and ``tests/test_bench_multichip.py``), and the
data-parallel update against JAX's ``make_update_fn``.

Each spawn of workers runs several checks and returns one record a rank;
every spawn has its own timeout, so a hang fails its tests and no more.
Run as a script (``--rank``, ``--world-size``, ``--init-file``), this file
is the worker of the sharded-rollout checks, and with ``--update-case DIR``
of the update against JAX (the workers import no JAX: the test process
runs JAX's update and hands the workers the starting parameters)."""

import argparse
import json
import os
import subprocess
import sys
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import pytest
import torch

from gym_multigrid_tpu_torch.envs.collect import CollectConfig
from gym_multigrid_tpu_torch.ops.collect_slab import make_collect_episode_rollout
from gym_multigrid_tpu_torch.parallel.mesh import (
    Mesh,
    distributed_initialize,
    fold_in_axis,
    make_mesh,
    shard_batch_tree,
)
from gym_multigrid_tpu_torch.parallel.shard import sharded_episode_rollout, sharded_rollout
from gym_multigrid_tpu_torch.parallel.vector import make_collect_batch
from gym_multigrid_tpu_torch.scripts import multihost_dryrun as dryrun
from gym_multigrid_tpu_torch.scripts.bench_multichip import run_weak_scaling

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Every spawn's limit, seconds.
TIMEOUT = 120
SEED = 4
#: The sums check: short episodes, so that some finish inside a call.
SUMS_CFG = CollectConfig(layout="quadrants_respawn", respawn=True, max_steps=10)
SUMS_ENVS, SUMS_STEPS = 16, 20
#: The distribution check, as tests/test_shard_map.py's.
DIST_CFG = CollectConfig(layout="quadrants_respawn", respawn=True, max_steps=50)
DIST_ENVS, DIST_STEPS = 256, 100
#: The update against JAX: a (T, B) global buffer, B / 2 envs a rank; one
#: minibatch of the whole buffer, where the shuffle only reorders sums.
UPD_T, UPD_B, UPD_SEED = 6, 16, 5
UPD_CFG = dict(num_minibatches=1, num_epochs=2)
UPD_HIDDEN = (32, 32)
UPD_METRICS = ("loss", "pg_loss", "v_loss", "entropy", "approx_kl", "clip_fraction",
               "reward_per_step", "explained_variance", "episodes", "ep_return_mean")


def cpu_mesh(rank: int, world_size: int = 2) -> Mesh:
    return Mesh(group=None, world_size=world_size, rank=rank, device=torch.device("cpu"))


def scalars(metrics) -> dict:
    return {k: v.item() for k, v in metrics.items() if v.ndim == 0}


# ---------------------------------------------------------------- worker


def worker(args) -> None:
    """Two sharded rollouts and an episode rollout of this rank's envs."""
    import torch.distributed as dist

    mesh = dryrun.start_worker(args)
    try:
        roll = sharded_rollout(make_collect_batch(SUMS_CFG, SUMS_ENVS, device="cpu"), mesh)
        states, _ = roll.reset(SEED)
        _, m = roll(states, SUMS_STEPS)
        ep = sharded_episode_rollout(
            make_collect_episode_rollout(SUMS_CFG, SUMS_ENVS, device="cpu"), mesh)
        states, _ = ep.reset(SEED)
        _, m_ep = ep(states, SUMS_STEPS)
        big = sharded_rollout(make_collect_batch(DIST_CFG, DIST_ENVS, device="cpu"), mesh)
        states, _ = big.reset(SEED)
        _, m_dist = big(states, DIST_STEPS)
        dryrun.report({"rank": mesh.rank, "rollout": scalars(m),
                       "run_return": m["run_return"].tolist(), "episode": scalars(m_ep),
                       "dist": scalars(m_dist)})
    finally:
        dist.destroy_process_group()


def update_case(rank: int, world_size: int):
    """The fixed global buffer (``multihost_dryrun.global_buffer``, a numpy
    seed) and last values, and the episodes (summed done rewards, done
    count) of rank ``rank``'s envs; ``world_size=1`` gives the whole
    buffer's."""
    traj, last_value = dryrun.global_buffer(UPD_T, UPD_B, UPD_SEED, "cpu")
    k = UPD_B // world_size
    rows = slice(rank * k, (rank + 1) * k)
    traj = type(traj)(*(x[:, rows] for x in traj))
    done = torch.maximum(traj.terminated, traj.truncated)
    episodes = ((traj.reward * done).sum(), done.sum().to(torch.int32))
    return traj, last_value[rows], episodes


def update_worker(args) -> None:
    """This rank's share of the data-parallel update from the parameters in
    ``args.update_case``: the updated parameters and the metrics."""
    import torch.distributed as dist

    from gym_multigrid_tpu_torch.rl.networks import ActorCritic
    from gym_multigrid_tpu_torch.rl.ppo import PPOConfig, make_optimizer, make_update_fn

    mesh = dryrun.start_worker(args)
    try:
        net = ActorCritic(4, 2, UPD_HIDDEN, torch.float32, obs_shape=(10, 10, 3))
        net.load_state_dict(torch.load(os.path.join(args.update_case, "params.pt"),
                                       weights_only=True))
        cfg = PPOConfig(**UPD_CFG)
        update = make_update_fn(net, make_optimizer(net, cfg), cfg, mesh)
        traj, last_value, episodes = update_case(mesh.rank, mesh.world_size)
        metrics = update(traj, last_value, torch.Generator().manual_seed(0), episodes=episodes)
        dryrun.report({"rank": mesh.rank, "metrics": {k: v.item() for k, v in metrics.items()},
                       "params": [p.detach().tolist() for p in net.parameters()]})
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- fixtures


@pytest.fixture(scope="module")
def rollout_ranks():
    return dryrun.launch([sys.executable, os.path.abspath(__file__)], 2, TIMEOUT)


@pytest.fixture(scope="module")
def jax_update(tmp_path_factory):
    """JAX's ``make_update_fn`` over the whole global buffer from a flax
    ActorCritic's params (float32 activations), and the two ranks' update
    of their halves from the same params (written for them as a torch
    state dict): (JAX's metrics, JAX's updated params as a torch net, the
    ranks' records)."""
    import jax
    import jax.numpy as jnp
    import optax

    from gym_multigrid_tpu.rl import networks as jnet
    from gym_multigrid_tpu.rl import ppo as jppo
    from gym_multigrid_tpu_torch.rl import networks as tnet

    traj, last_value, (ep_sum, ep_cnt) = update_case(0, 1)
    jn = jnet.ActorCritic(num_actions=4, num_agents=2, hidden=UPD_HIDDEN,
                          activation_dtype=jnp.float32)
    params = jn.init(jax.random.PRNGKey(UPD_SEED), jnp.asarray(traj.obs[0, :1].numpy()))
    jcfg = jppo.PPOConfig(**UPD_CFG)
    tx = optax.chain(optax.clip_by_global_norm(jcfg.max_grad_norm), optax.adam(jcfg.lr))
    jtraj = jppo.Transition(**{k: jnp.asarray(v.numpy()) for k, v in traj._asdict().items()})
    p2, _, jm = jppo.make_update_fn(jn, tx, jcfg)(
        params, tx.init(params), jtraj, jnp.asarray(last_value.numpy()), jax.random.PRNGKey(0))
    # The episode metrics as JAX's make_ppo forms them from the sums.
    ep_sum, ep_cnt = jnp.asarray(ep_sum.numpy()), jnp.asarray(ep_cnt.numpy())
    jm = dict(jm, episodes=ep_cnt, ep_return_mean=ep_sum / jnp.maximum(ep_cnt, 1))

    def torch_net(flax_params):
        net = tnet.ActorCritic(4, 2, UPD_HIDDEN, torch.float32, obs_shape=(10, 10, 3))
        tnet.load_flax_params(net, jax.tree_util.tree_map(np.asarray, flax_params))
        return net

    case = tmp_path_factory.mktemp("update_case")
    torch.save(torch_net(params).state_dict(), case / "params.pt")
    ranks = dryrun.launch([sys.executable, os.path.abspath(__file__), "--update-case",
                           str(case)], 2, TIMEOUT)
    return {k: float(v) for k, v in jm.items()}, torch_net(p2), ranks


@pytest.fixture(scope="module")
def dryrun_record(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun") / "multihost.json"
    proc = subprocess.run(
        [sys.executable, "-m", "gym_multigrid_tpu_torch.scripts.multihost_dryrun",
         "--num-processes", "2", "--device", "cpu", "--steps", "2",
         "--timeout", str(TIMEOUT), "--out", str(out)],
        capture_output=True, text=True, timeout=TIMEOUT + 10, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def audit_record(tmp_path_factory):
    out = tmp_path_factory.mktemp("audit") / "comm_audit.json"
    proc = subprocess.run(
        [sys.executable, "-m", "gym_multigrid_tpu_torch.scripts.audit_comm",
         "--num-processes", "2", "--device", "cpu", "--per-device-envs", "16",
         "--rollout", "8", "--minibatches", "2", "--epochs", "2",
         "--timeout", str(TIMEOUT), "--out", str(out)],
        capture_output=True, text=True, timeout=TIMEOUT + 10, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(out.read_text())


# ---------------------------------------------------------------- 1. mesh helpers


class _Pair(NamedTuple):
    a: torch.Tensor
    b: torch.Tensor


@dataclass(frozen=True)
class _State:
    pair: _Pair
    rows: torch.Tensor
    name: str


def test_shard_batch_tree_splits_rows_evenly():
    x = torch.arange(8 * 3).reshape(8, 3)
    tree = _State(_Pair(x, x[:, 0].clone()), torch.arange(8.0), "keep")
    parts = [shard_batch_tree(tree, cpu_mesh(r)) for r in range(2)]
    for r, part in enumerate(parts):
        assert part.name == "keep" and part.pair.a.shape == (4, 3)
        assert torch.equal(part.rows, torch.arange(4.0) + 4 * r)
    assert torch.equal(torch.cat([p.pair.a for p in parts]), x)
    assert torch.equal(torch.cat([p.pair.b for p in parts]), x[:, 0])
    parts[0].pair.a.zero_()  # new tensors: the global rows are untouched
    assert x.sum() > 0
    with pytest.raises(ValueError, match="does not split"):
        shard_batch_tree({"x": torch.zeros(7)}, cpu_mesh(0))


def test_fold_in_axis_gives_each_rank_its_own_reproducible_seed():
    seeds = [fold_in_axis(SEED, cpu_mesh(r, 4)) for r in range(4)]
    assert len(set(seeds)) == 4
    assert seeds == [fold_in_axis(SEED, cpu_mesh(r, 4)) for r in range(4)]
    assert fold_in_axis(SEED + 1, cpu_mesh(0)) != seeds[0]


def test_mesh_refuses_tensor_parallelism_and_a_missing_group():
    with pytest.raises(ValueError, match="no tensor parallelism"):
        make_mesh(model_parallel=2)
    with pytest.raises(RuntimeError, match="distributed_initialize"):
        make_mesh()


def test_make_mesh_reads_back_the_initialised_device(tmp_path, monkeypatch):
    """make_mesh takes the device distributed_initialize chose (here the CPU,
    asked for); for a group made by other means, the current CUDA device,
    so without one it raises."""
    import torch.distributed as dist

    distributed_initialize(init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1,
                           device="cpu")
    try:
        distributed_initialize(device="cuda:5")  # a group exists: nothing happens
        mesh = make_mesh(n_devices=1)
        assert (mesh.world_size, mesh.rank, mesh.device) == (1, 0, torch.device("cpu"))
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store2'}", rank=0,
                            world_size=1)
    try:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA device"):
            make_mesh()
    finally:
        dist.destroy_process_group()


def test_distributed_initialize_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        distributed_initialize(init_method="file:///nonexistent/store", rank=0, world_size=1)


# ---------------------------------------------------------------- 2-3. sharded rollouts


def _unsharded(make, cfg, n, steps, seed, rank, call):
    env = make(cfg, n, device="cpu")
    states, _ = env.reset(fold_in_axis(seed, cpu_mesh(rank)))
    return call(env, states, steps)


def _rank_sums(make, cfg, call):
    """Each rank's unsharded rollout of SUMS_ENVS / 2 envs from its seed."""
    return [_unsharded(make, cfg, SUMS_ENVS // 2, SUMS_STEPS, SEED, r, call)[1] for r in range(2)]


def _assert_sums(got, parts):
    a, b = parts
    assert got["episodes"] == int(a["episodes"]) + int(b["episodes"]) > 0
    for k in ("reward_sum", "ep_return_sum"):
        assert got[k] == (a[k] + b[k]).item(), k  # the float32 sum a + b
    assert got["reward_sum"] > 0


def test_sharded_rollout_sums_the_ranks_rollouts(rollout_ranks):
    parts = _rank_sums(make_collect_batch, SUMS_CFG, lambda env, s, n: env.rollout(s, n))
    for rec in rollout_ranks:
        _assert_sums(rec["rollout"], parts)
        # Per-env leaves stay with their rank.
        assert rec["run_return"] == parts[rec["rank"]]["run_return"].tolist()


def test_sharded_episode_rollout_sums_the_ranks_rollouts(rollout_ranks):
    parts = _rank_sums(make_collect_episode_rollout, SUMS_CFG, lambda roll, s, n: roll(s, n))
    for rec in rollout_ranks:
        _assert_sums(rec["episode"], parts)


def test_sharded_rollout_matches_unsharded_distribution(rollout_ranks):
    env = make_collect_batch(DIST_CFG, DIST_ENVS, device="cpu")
    states, _ = env.reset(SEED)
    _, un = env.rollout(states, DIST_STEPS)
    n = DIST_ENVS * DIST_STEPS
    un_rate = un["reward_sum"].item() / n
    for rec in rollout_ranks:
        sh = rec["dist"]
        sh_rate = sh["reward_sum"] / n
        assert un_rate > 0 and sh_rate > 0
        assert abs(un_rate - sh_rate) / un_rate < 0.15
        assert int(un["episodes"]) == sh["episodes"] == DIST_ENVS * 2
        un_ep = un["ep_return_sum"].item() / int(un["episodes"])
        assert abs(un_ep - sh["ep_return_sum"] / sh["episodes"]) / un_ep < 0.15


# ---------------------------------------------------------------- 4. the update against JAX


def test_two_rank_update_matches_jax(jax_update):
    """The 2-rank gloo update of the fixed global buffer against JAX's update
    of the whole buffer from the same flax params (two epochs of one
    minibatch): every parameter and every metric, the episode metrics of
    the whole batch among them, within rtol 1e-4 and atol 1e-5."""
    jm, want, ranks = jax_update
    assert 0 < jm["clip_fraction"] < 1 and jm["approx_kl"] > 0 and jm["episodes"] > 0
    for rec in ranks:
        got = rec["metrics"]
        assert set(got) == set(UPD_METRICS)
        for k in UPD_METRICS:
            np.testing.assert_allclose(got[k], jm[k], rtol=1e-4, atol=1e-5,
                                       err_msg=f"rank {rec['rank']} {k}")
        assert got["episodes"] == jm["episodes"]
        for (name, w), p in zip(want.named_parameters(), rec["params"]):
            np.testing.assert_allclose(np.asarray(p, np.float32), w.detach().numpy(),
                                       rtol=1e-4, atol=1e-5,
                                       err_msg=f"rank {rec['rank']} {name}")


# ---------------------------------------------------------------- 4-5, 7. the dryrun


@pytest.mark.parametrize("num_minibatches", ["1", "2"])
def test_two_rank_update_equals_one_process_update(dryrun_record, num_minibatches):
    """The 2-rank update of a fixed global buffer (numpy seed) against one
    process's at shuffle_blocks = 2, from the same params and the same
    shuffle generator: within 1e-5 relative."""
    assert dryrun_record["update_rel_err"][num_minibatches] <= 1e-5


def test_params_bit_equal_across_ranks_after_train_steps(dryrun_record):
    assert dryrun_record["train_steps"] == 2
    assert dryrun_record["workers_agree"] is True
    assert all(e > 0 for e in dryrun_record["train_episodes"])
    assert all(abs(x) < 1e3 for x in dryrun_record["losses"])


def test_dryrun_launcher_two_processes(dryrun_record):
    rec = dryrun_record
    assert rec["ok"] is True and rec["num_processes"] == 2
    assert rec["backend"] == "gloo" and rec["device"] == "cpu"
    assert rec["num_envs"] == 16 and rec["rollout_episodes"] > 0


@pytest.mark.parametrize("code", ["import sys; sys.exit(3)", "import time; time.sleep(60)"],
                         ids=["fails", "hangs"])
def test_launcher_stops_every_worker_when_one_fails_or_hangs(code):
    """One worker fails (or all hang): the launcher kills the rest and
    raises, well before the sleeping workers would end."""
    with pytest.raises(dryrun.WorkerError, match="exit codes|timed out"):
        dryrun.launch([sys.executable, "-c", code], 2, timeout=2)


# ---------------------------------------------------------------- 6. the audits


def test_sharded_rollout_collectives_are_one_scalar_all_reduce(audit_record):
    roll = audit_record["rollout"]
    assert roll["by_kind"] == {"all_reduce": {"count": 1, "bytes": 24}}
    # One packed float64 buffer of the three scalar metrics: no env state.
    assert roll["max_elems"] == 3 and roll["dtypes"] == ["float64"]


def test_dp_train_step_all_reduces_are_param_sized(audit_record):
    step = audit_record["train_step"]
    assert set(step["by_kind"]) == {"all_reduce"}, step["by_kind"]  # no broadcast
    assert step["max_bytes"] <= audit_record["param_bytes"]
    assert "uint8" not in step["dtypes"]
    # 2 epochs x 2 minibatches of (the advantages' two scalars and the
    # gradient bucket), then the metrics' one packed buffer.
    assert step["by_kind"]["all_reduce"]["count"] == 2 * 2 * 3 + 1


def test_audit_catches_a_gathered_buffer(audit_record):
    canary = audit_record["canary_all_gather"]
    assert set(canary["by_kind"]) == {"all_gather"}
    assert canary["dtypes"] == ["uint8"]
    assert canary["max_elems"] == audit_record["buffer_obs_elems"]


# ---------------------------------------------------------------- 8. weak scaling


def test_weak_scaling_instrument_runs_on_the_cpu():
    results, eff = run_weak_scaling(family="collect", per_device_envs=8, steps=8, reps=1,
                                    points=[1, 2], path="step", device="cpu", verbose=False,
                                    timeout=TIMEOUT)
    assert set(results) == {1, 2}
    for n, r in results.items():
        assert r["envs"] == 8 * n and r["backend"] == "gloo" and r["device"] == "cpu"
        assert r["agent_steps_per_sec"] > 0 and r["per_chip"] > 0
    assert results[1]["efficiency"] == 1.0
    assert eff == results[2]["efficiency"] > 0


def test_weak_scaling_on_cuda_needs_a_card_a_rank():
    with pytest.raises(ValueError, match="needs 2 cards"):
        run_weak_scaling(points=[1, 2], device="cuda")


def test_new_modules_import_no_jax():
    """The multi-process and profiling modules and scripts import nothing of
    JAX or the JAX package (a fresh interpreter)."""
    mods = ["gym_multigrid_tpu_torch.parallel." + m for m in ("mesh", "shard", "comm_audit")] + [
        "gym_multigrid_tpu_torch.utils.profiling"] + [
        "gym_multigrid_tpu_torch.scripts." + m for m in (
            "multihost_dryrun", "bench_multichip", "audit_comm", "profile_rollout",
            "sol_record")]
    code = (f"import sys, importlib; [importlib.import_module(m) for m in {mods!r}]; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'gym_multigrid_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=TIMEOUT, cwd=REPO)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--update-case", default=None)
    dryrun.add_worker_flags(parser)
    args = parser.parse_args()
    update_worker(args) if args.update_case else worker(args)
