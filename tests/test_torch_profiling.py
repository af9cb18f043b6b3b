"""The port's profiling layer on the CPU: ``sol_report`` held to the JAX
package's arithmetic at the same bandwidth, ``trace`` and
``summarize_profile`` over a small batch, the collective inventory of a
one-rank gloo group, and the two profiling scripts on the plain versions."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from gym_multigrid_tpu.utils import profiling as jprof
from gym_multigrid_tpu_torch.envs.collect import CollectConfig
from gym_multigrid_tpu_torch.parallel.comm_audit import audit_call
from gym_multigrid_tpu_torch.parallel.mesh import Mesh
from gym_multigrid_tpu_torch.parallel.shard import psum_scalars
from gym_multigrid_tpu_torch.parallel.vector import make_collect_batch
from gym_multigrid_tpu_torch.scripts import profile_rollout
from gym_multigrid_tpu_torch.utils import profiling

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAIN = CollectConfig(layout="quadrants_respawn", respawn=True, max_steps=50)


@pytest.mark.parametrize("rate, state_bytes, batch, rw", [
    (1.78e9, 8192 * 1212, 8192, 2.0), (3.5e7, 64 * 300, 64, 2.0), (1e6, 12345, 1, 3.5),
])
def test_sol_report_matches_jax_at_the_same_bandwidth(monkeypatch, rate, state_bytes, batch, rw):
    monkeypatch.setitem(jprof.HBM_BYTES_PER_S, "h100-sxm", profiling.MEM_BYTES_PER_S["h100-sxm"])
    want = jprof.sol_report(rate, state_bytes, batch, chip="h100-sxm", rw_factor=rw)
    got = profiling.sol_report(rate, state_bytes, batch, rw_factor=rw)
    assert got.__dict__ == want.__dict__
    assert profiling.MEM_BYTES_PER_S == {"h100-sxm": 3.35e12}


def test_sol_report_refuses_an_unknown_chip():
    with pytest.raises(ValueError, match="unknown chip"):
        profiling.sol_report(1e6, 100, 1, chip="v5e")


def test_state_nbytes_counts_every_tensor_leaf():
    env = make_collect_batch(MAIN, 8, device="cpu")
    states, _ = env.reset(0)
    want = sum(x.numel() * x.element_size()
               for x in (getattr(states, f.name) for f in dataclasses.fields(states)))
    assert profiling.state_nbytes(states) == want > 0
    assert profiling.state_nbytes({"a": [torch.zeros(3, dtype=torch.float64)], "b": 1}) == 24


def test_trace_writes_a_chrome_trace_and_summarize_profile_reads_it(tmp_path):
    env = make_collect_batch(MAIN, 8, device="cpu")
    states, _ = env.reset(0)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("five steps"):
            env.rollout(states, 5)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "five steps" for e in events)
    s = profiling.summarize_profile(prof, top=5)
    assert set(s) == {"wall_us", "device", "device_us", "launches", "idle_share", "kernels",
                      "port_kernels", "host_ops"}
    assert s["wall_us"] > 0 and s["device"] == "cpu"
    # No device in this trace: the device fields are not measured.
    assert s["device_us"] is s["launches"] is s["idle_share"] is None
    assert s["kernels"] == [] and s["port_kernels"] == []
    assert 0 < len(s["host_ops"]) <= 5 and all(us >= 0 and n > 0 for _, us, n in s["host_ops"])


def test_summarize_profile_refuses_a_profile_not_taken_by_trace():
    with torch.profiler.profile() as prof:
        torch.ones(3).sum()
    with pytest.raises(ValueError, match="trace"):
        profiling.summarize_profile(prof)


def test_collective_inventory_of_a_one_rank_group(tmp_path):
    """One gloo rank: an all_reduce of three floats and psum_scalars' packed
    buffer show up with their operands; psum_scalars keeps each dtype."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        mesh = Mesh(group=None, world_size=1, rank=0, device=torch.device("cpu"))
        ops = audit_call(dist.all_reduce, torch.ones(3))
        assert [(o.kind, o.shapes, o.bytes, o.op_name, o.max_elems) for o in ops] == [
            ("all_reduce", [("float32", (3,))], 12, "gloo:all_reduce", 3)]
        metrics = {"r": torch.tensor(1.5), "n": torch.tensor(7, dtype=torch.int32),
                   "per_env": torch.ones(4)}
        ops = audit_call(psum_scalars, metrics, mesh)
        assert [(o.kind, o.shapes) for o in ops] == [("all_reduce", [("float64", (2,))])]
        out = psum_scalars(metrics, mesh)
        assert out["r"].dtype == torch.float32 and out["r"].item() == 1.5
        assert out["n"].dtype == torch.int32 and out["n"].item() == 7
        assert out["per_env"] is metrics["per_env"]
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("path", ["episode", "step"])
def test_profile_rollout_on_the_cpu(tmp_path, path):
    rec = profile_rollout.profile("collect", 8, 50, 1, path, str(tmp_path), "cpu")
    assert rec["device"] == "cpu" and rec["agent_steps_per_s"] > 0
    assert rec["sol_fraction"] is None and rec["mem_ceiling_env_steps_per_s"] is None
    # The state read and written once (once a 25-step chunk on the episode
    # path) and 4-byte draws written and read once.
    env = make_collect_batch(MAIN, 8, device="cpu")
    draws = (2 + 3 + env.slab.reset_draws / 50) if path == "episode" else (
        2 + env.slab.step_draws + env.slab.reset_draws)
    chunk = 25 if path == "episode" else 1
    assert rec["designed_bytes_per_env_step"] == int(
        2 * rec["state_bytes_per_env"] / chunk + 2 * 4 * draws)
    assert rec["observed_profile"]["device"] == "cpu"
    assert (tmp_path / "trace.json").exists()


def test_sol_record_writes_its_own_file(tmp_path):
    out = tmp_path / "sol_report_torch.json"
    subprocess.run([sys.executable, "-m", "gym_multigrid_tpu_torch.scripts.sol_record", "--cpu",
                    "--families", "maze", "--batch", "8", "--steps", "20", "--out", str(out)],
                   check=True, timeout=120, cwd=REPO, capture_output=True)
    rec = json.loads(out.read_text())
    assert rec["path"] == "episode" and set(rec["families"]) == {"maze"}
    maze = rec["families"]["maze"]
    assert maze["device"] == "cpu" and maze["binding_resource"].startswith("not measured")
    assert (tmp_path / "sol_trace_torch" / "maze" / "trace.json").exists()
