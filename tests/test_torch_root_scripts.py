"""The port's counterparts of the JAX package's root scripts
(``gym_multigrid_tpu_torch/scripts/{train_mvn_ctf_rl,bench_ppo_scale,
measure_train_step,soak,sweep_batch,plot_learning_curve}.py`` and the pod
model of ``audit_comm.py``) on the CPU at a tiny size: each ``main(argv)``
runs in this process and writes what the JAX script writes, with the JAX
records' keys; nothing goes under ``artifacts/``; and, in a fresh
interpreter, none of them nor the worked example loads JAX."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from gym_multigrid_tpu_torch.scripts import (
    ARTIFACTS,
    audit_comm,
    bench_ppo_scale,
    measure_train_step,
    out_path,
    plot_learning_curve,
    soak,
    sweep_batch,
    train_mvn_ctf_rl,
)
from gym_multigrid_tpu_torch.utils.logging import MetricsLogger, read_metrics_csv

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_keys(name):
    """The keys of the JAX package's record ``artifacts/<name>.json``."""
    with open(os.path.join(ROOT, "artifacts", f"{name}.json")) as f:
        return set(json.load(f))


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_train_mvn_ctf_rl_resumes_and_writes_gif(tmp_path, capsys):
    out = str(tmp_path / "run")
    small = ["--cpu", "--envs", "8", "--rollout-len", "8", "--minibatches", "2",
             "--epochs", "1", "--no-tensorboard", "--out", out]
    gif = train_mvn_ctf_rl.main(["--iters", "2", *small])
    assert gif == os.path.join(out, "animations", "ctf_ppo.gif")
    assert os.path.getsize(gif) > 0
    model = os.path.join(out, "models", "ctf_ppo")
    assert os.path.exists(model + ".npz") and os.path.exists(model + ".json")
    capsys.readouterr()
    train_mvn_ctf_rl.main(["--iters", "1", *small])
    assert "resumed full state" in capsys.readouterr().out
    # The step axis continues across the resume.
    assert read_metrics_csv(os.path.join(out, "logs", "metrics.csv"))["step"] == [0.0, 1.0, 2.0]


def test_bench_ppo_scale_prints_the_record_keys(tmp_path, capsys):
    out = tmp_path / "ppo.json"
    rec = bench_ppo_scale.main(["--cpu", "--envs", "64", "--rollout-len", "4",
                                "--minibatches", "2", "--shuffle-blocks", "2", "--iters", "1",
                                "--out", str(out)])
    line = _last_json(capsys)
    assert _jax_keys("ppo_1m_envs") <= set(line)
    assert line == json.loads(out.read_text()) == json.loads(json.dumps(rec))
    assert line["backend"] == "cpu" and line["card"] == "cpu"
    assert line["envs"] == 64 and line["shuffle_blocks"] == 2
    assert line["finite"] and line["param_max_change"] > 0 and line["env_steps_per_sec"] > 0


def test_measure_train_step_writes_its_record(tmp_path):
    out = tmp_path / "sub" / "train_step_time_torch.json"
    measure_train_step.main(["--cpu", "--envs", "16", "--rollout", "4", "--minibatches", "2",
                             "--reps", "2", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert _jax_keys("train_step_time") <= set(rec)
    assert rec["env_steps_per_train_step"] == 64 and rec["backend"] == "cpu"
    assert rec["train_step_s"] == min(rec["train_step_s_all"]) > 0


def test_pod_model_formula():
    measured = {"train_step_s": 0.02, "env_steps_per_train_step": 512 * 32,
                "backend": "NVIDIA H100 80GB HBM3, 700.00 W", "run_date": "2026-01-01"}
    nbytes = 580_644 * 16
    model = audit_comm.pod_model(nbytes, 1024, 32, measured)  # twice the measured envs
    assert set(model) == {"nvlink_n8", "ib_2nodes_n16", "ib_32nodes_n256", "assumptions"}
    for n, rate, label in audit_comm.POD_POINTS:
        point = model[f"{label}_n{n}"]
        ar = 2 * (n - 1) / n * nbytes / rate
        assert math.isclose(point["all_reduce_s"], ar, rel_tol=1e-12)
        assert point["compute_s_measured"] == 0.04
        assert math.isclose(point["efficiency_no_overlap"], 0.04 / (0.04 + ar), rel_tol=1e-12)
    assert model["nvlink_n8"]["all_reduce_s"] == 2 * 7 / 8 * nbytes / 4.5e11
    assert model["ib_2nodes_n16"]["all_reduce_s"] == 2 * 15 / 16 * nbytes / 5e10
    assert "scaled x2.00" in model["assumptions"]["compute_from"]
    assert "H100" in model["assumptions"]["compute_from"]


def test_pod_model_skipped_without_a_measurement(tmp_path):
    model = audit_comm.pod_model(1000, 64, 32, None)
    assert list(model) == ["assumptions"]
    assert model["assumptions"]["compute_from"].startswith("NO MEASUREMENT")
    assert audit_comm.read_measurement(str(tmp_path / "missing.json")) is None


def test_soak_reports_windows_and_drift(tmp_path, capsys, monkeypatch):
    out = tmp_path / "soak.json"
    monkeypatch.setattr(soak, "WINDOW_SECONDS", 0.01)
    soak.main(["--cpu", "--family", "maze", "--batch", "8", "--windows", "3",
               "--window-steps", "20", "--out", str(out)])
    line = _last_json(capsys)
    rec = json.loads(out.read_text())
    assert _jax_keys("soak_ctf") <= set(rec)
    assert set(line) == {"command", "agent_steps_per_sec", "drift_first_vs_last_third_pct"}
    w = rec["windows"]
    assert len(w) == 3 and all(r > 0 for r in w)
    rates = rec["agent_steps_per_sec"]
    assert rates["min"] == min(w) and rates["max"] == max(w) and rates["p50"] == sorted(w)[1]
    assert math.isclose(rates["mean"], sum(w) / 3)
    assert math.isclose(rec["drift_first_vs_last_third_pct"], 100 * (w[2] - w[0]) / w[0])


def test_sweep_batch_prints_a_line_a_point(capsys):
    points = sweep_batch.main(["--cpu", "--families", "collect", "--batches", "4,8",
                               "--steps", "50", "--reps", "1"])
    lines = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert lines == json.loads(json.dumps(points))
    assert [(x["family"], x["batch"], x["path"]) for x in lines] == [
        ("collect", 4, "episode"), ("collect", 8, "episode")]
    assert all(x["agent_steps_per_sec"] > 0 and x["device"] == "cpu" for x in lines)


def test_plot_learning_curve_writes_a_png(tmp_path):
    logdir = str(tmp_path / "run" / "logs")
    logger = MetricsLogger(logdir, use_tensorboard=False)
    for it in range(12):
        logger.log(it, {"loss": 0.1, "reward_per_step": 0.01 * it, "entropy": 1.5 - 0.01 * it,
                        "ep_return_mean": 0.0 if it % 4 == 0 else 0.1 * it,
                        "episodes": float(it % 4 != 0)})
    logger.close()
    png = plot_learning_curve.main([logdir])
    assert png == str(tmp_path / "run" / "learning_curve.png")
    with open(png, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert os.path.getsize(png) > 1000


def test_nothing_is_written_under_artifacts():
    for path in (os.path.join(ARTIFACTS, "soak_ctf.json"),
                 os.path.join(ARTIFACTS, "ctf_train", "learning_curve.png")):
        with pytest.raises(ValueError, match="JAX package's records"):
            out_path(path)
    assert out_path("out/x.json") == os.path.abspath("out/x.json")
    with pytest.raises(ValueError):
        plot_learning_curve.main([os.path.join(ARTIFACTS, "ctf_train", "logs")])


@pytest.mark.parametrize("script, argv", [
    ("train", ["--cpu"]),
    ("train_mvn_ctf_rl", ["--cpu"]),
    ("train_selfplay", ["--cpu"]),
    ("multihost_dryrun", ["--device", "cpu"]),
    ("audit_comm", ["--device", "cpu"]),
    ("sol_record", ["--cpu"]),
    ("bench_ppo_scale", ["--cpu"]),
    ("measure_train_step", ["--cpu"]),
    ("soak", ["--cpu"]),
])
def test_every_out_flag_refuses_artifacts(script, argv):
    """Each script's ``--out`` goes through ``out_path``, before any work."""
    import importlib

    main = importlib.import_module(f"gym_multigrid_tpu_torch.scripts.{script}").main
    with pytest.raises(ValueError, match="JAX package's records"):
        main([*argv, "--out", os.path.join(ARTIFACTS, f"{script}_torch")])


def test_new_scripts_do_not_import_jax(tmp_path):
    """The new scripts and the example's functions, tiny, in a fresh
    interpreter, which then has no ``jax`` and no ``gym_multigrid_tpu``
    module loaded."""
    code = f"""
import sys
import torch
from gym_multigrid_tpu_torch.examples import custom_env
from gym_multigrid_tpu_torch.scripts import (audit_comm, bench_ppo_scale, measure_train_step,
    plot_learning_curve, soak, sweep_batch, train_mvn_ctf_rl)
out = {str(tmp_path)!r}
env = custom_env.make_pursuit_batch(custom_env.PursuitConfig(), 8, device="cpu")
states, obs = env.reset(seed=0)
env.rollout(states, 5)
custom_env.ENVS, custom_env.RANDOM_STEPS, custom_env.ITERS = 8, 5, 1
custom_env.main(["--cpu"])
train_mvn_ctf_rl.main(["--cpu", "--envs", "4", "--iters", "1", "--rollout-len", "4",
                       "--minibatches", "1", "--no-tensorboard", "--out", out])
bench_ppo_scale.main(["--cpu", "--envs", "16", "--rollout-len", "2", "--minibatches", "1",
                      "--shuffle-blocks", "1", "--iters", "1"])
measure_train_step.main(["--cpu", "--envs", "8", "--rollout", "2", "--minibatches", "1",
                         "--reps", "1", "--out", out + "/ts.json"])
audit_comm.pod_model(1000, 8, 2, audit_comm.read_measurement(out + "/ts.json"))
soak.WINDOW_SECONDS = 0
soak.main(["--cpu", "--family", "collect", "--batch", "4", "--windows", "1",
           "--window-steps", "50", "--out", out + "/soak.json"])
sweep_batch.main(["--cpu", "--families", "wildfire", "--batches", "4", "--steps", "8",
                  "--reps", "1"])
plot_learning_curve.main([out + "/logs", out + "/curve.png"])
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
assert not any(m.startswith("gym_multigrid_tpu.") or m == "gym_multigrid_tpu"
               for m in sys.modules)
print("NO_JAX_OK")
"""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
