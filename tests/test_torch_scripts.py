"""The port's four command-line entry points
(``gym_multigrid_tpu_torch/scripts/``) on the CPU at a small size: each
``main()`` runs and writes its CSV and snapshot or its JSON; a trained
snapshot round-trips through ``evaluate --model``; and none of the four
imports JAX (checked in a fresh interpreter, since this process has JAX
loaded for the other tests)."""

import json
import os
import subprocess
import sys

import torch

from gym_multigrid_tpu_torch.scripts import evaluate, league_matrix, train, train_selfplay
from gym_multigrid_tpu_torch.utils.logging import read_metrics_csv

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--cpu", "--envs", "8", "--iters", "2", "--rollout-len", "8", "--minibatches", "2",
         "--no-tensorboard"]


def test_train_then_evaluate_round_trip(tmp_path, capsys):
    out = str(tmp_path / "run")
    train.main(["--family", "ctf", "--out", out, *SMALL])
    csv = read_metrics_csv(os.path.join(out, "logs", "ctf", "metrics.csv"))
    assert csv["step"] == [0.0, 1.0] and "env_steps_per_sec" in csv
    model = os.path.join(out, "models", "ctf_ppo")
    assert os.path.exists(model + ".npz") and os.path.exists(model + ".json")
    capsys.readouterr()
    evaluate.main(["--family", "ctf", "--cpu", "--envs", "8", "--steps", "50",
                   "--model", model, "--random"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    res = json.loads(line)
    assert res["model"] == model and res["steps"] == 50 and res["deterministic"]
    assert res["wins"] + res["losses"] + res["draws"] == res["episodes"]
    assert "random_baseline" in res


def test_evaluate_generic_family(tmp_path, capsys):
    out = str(tmp_path / "run")
    train.main(["--family", "maze", "--out", out, *SMALL])
    capsys.readouterr()
    evaluate.main(["--family", "maze", "--cpu", "--envs", "8", "--steps", "50", "--sample",
                   "--model", os.path.join(out, "models", "maze_ppo")])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["family"] == "maze" and not res["deterministic"]
    assert {"episodes", "ep_return_mean", "reward_per_step"} <= set(res)


def test_train_selfplay_league_then_league_matrix(tmp_path):
    out = str(tmp_path / "sp")
    train_selfplay.main([*SMALL, "--pool-size", "2", "--snapshot-every", "1",
                         "--eval-envs", "8", "--eval-steps", "50", "--out", out])
    csv = read_metrics_csv(os.path.join(out, "logs", "metrics.csv"))
    assert csv["step"] == [0.0, 1.0] and "blue_loss" in csv and "red_loss" in csv
    with open(os.path.join(out, "eval.json")) as f:
        ev = json.load(f)
    assert sorted(ev) == ["fight_capture", "final_red", "rw"]
    for r in ev.values():
        assert r["wins"] + r["losses"] + r["draws"] == r["episodes"]
    for stem in ("selfplay", "selfplay_state"):
        assert os.path.exists(os.path.join(out, "models", stem + ".npz"))
    league_matrix.main([out, "--cpu", "--envs", "8", "--steps", "50"])
    with open(os.path.join(out, "league_matrix.json")) as f:
        rows = json.load(f)
    assert sorted(rows) == ["final_red", "pool_0", "pool_1"]


def test_train_selfplay_resumes(tmp_path, capsys):
    out = str(tmp_path / "sp")
    args = [*SMALL, "--eval-envs", "8", "--eval-steps", "20", "--out", out]
    train_selfplay.main(args)
    capsys.readouterr()
    train_selfplay.main([*args[:4], "3", *args[5:], "--resume"])
    assert "resumed full self-play state at iter 2" in capsys.readouterr().out
    csv = read_metrics_csv(os.path.join(out, "logs", "metrics.csv"))
    assert csv["step"] == [0.0, 1.0, 2.0]


def test_scripts_do_not_import_jax(tmp_path):
    """Each CLI runs a tiny job in a fresh interpreter, which then has no
    ``jax`` module loaded."""
    code = f"""
import sys
from gym_multigrid_tpu_torch.scripts import evaluate, league_matrix, train, train_selfplay
out = {str(tmp_path)!r}
small = ["--cpu", "--envs", "4", "--iters", "1", "--rollout-len", "4", "--minibatches", "1",
         "--no-tensorboard"]
train.main(["--family", "collect", "--out", out, *small])
evaluate.main(["--family", "collect", "--cpu", "--envs", "4", "--steps", "10",
               "--model", out + "/models/collect_ppo"])
train_selfplay.main([*small, "--pool-size", "1", "--eval-envs", "4", "--eval-steps", "10",
                     "--out", out + "/sp"])
league_matrix.main([out + "/sp", "--cpu", "--envs", "4", "--steps", "10"])
assert "jax" not in sys.modules, sorted(m for m in sys.modules if m.startswith("jax"))
assert not any(m.startswith("gym_multigrid_tpu.") or m == "gym_multigrid_tpu"
               for m in sys.modules)
print("NO_JAX_OK")
"""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
