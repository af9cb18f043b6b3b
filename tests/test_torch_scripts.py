"""The port's four command-line entry points
(``gym_multigrid_tpu_torch/scripts/``) on the CPU at a small size: each
``main()`` runs and writes its CSV and snapshot or its JSON; a trained
snapshot round-trips through ``evaluate --model``; ``evaluate --gif`` and
``league_matrix --gif`` write one greedy episode as a gif; and none of the
four imports JAX (checked in a fresh interpreter, since this process has
JAX loaded for the other tests)."""

import json
import os
import subprocess
import sys

import numpy as np
import torch
from PIL import Image

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


def _gif_frames(path):
    """(frames the gif holds, each frame's duration in ms)."""
    frames, durations = [], []
    with Image.open(path) as im:
        for k in range(im.n_frames):
            im.seek(k)
            frames.append(np.asarray(im.convert("RGB")))
            durations.append(im.info["duration"])
    return frames, durations


def _check_gif(path, frames, steps):
    """The gif at ``path`` holds the episode's ``steps`` + 1 frames, each
    shown for 200 ms (fps 5).  The gif writer (Pillow) stores a run of
    identical consecutive frames as one frame shown for the run's time, so
    the gif has one frame per run and its time is (steps + 1) * 200 ms."""
    assert len(frames) == steps + 1
    assert all(f.dtype == np.uint8 and f.shape == frames[0].shape for f in frames)
    runs = 1 + sum(not np.array_equal(a, b) for a, b in zip(frames, frames[1:]))
    got, durations = _gif_frames(path)
    assert len(got) == runs and sum(durations) == (steps + 1) * 200
    assert got[0].shape == frames[0].shape
    np.testing.assert_array_equal(got[0], frames[0])


def test_evaluate_gif(tmp_path):
    """``evaluate --cpu --gif`` saves one greedy CtF episode of the trained
    snapshot, stepped here again to count its steps."""
    from gym_multigrid_tpu_torch.parallel.vector import make_ctf_batch
    from gym_multigrid_tpu_torch.rl.evaluate import load_params
    from gym_multigrid_tpu_torch.rl.families import make_family_batch
    from gym_multigrid_tpu_torch.rl.networks import ActorCritic

    out = str(tmp_path / "run")
    train.main(["--family", "ctf", "--out", out, *SMALL[:4], "1", *SMALL[5:]])
    model = os.path.join(out, "models", "ctf_ppo")
    gif = str(tmp_path / "anim" / "ctf_eval.gif")
    evaluate.main(["--family", "ctf", "--cpu", "--envs", "8", "--steps", "20", "--model", model,
                   "--gif", gif])
    _, cfg, n_actions, agents = make_family_batch("ctf", 1, "cpu")
    env = make_ctf_batch(cfg, 1, device="cpu", auto_reset=False)
    states, obs = env.reset(0)
    net = ActorCritic(n_actions, agents, obs_shape=tuple(obs.shape[1:]))
    net.load_state_dict(load_params(model))
    for steps in range(1, cfg.max_steps + 1):
        with torch.no_grad():
            acts = net(obs)[0].argmax(dim=-1).to(torch.int32)
        states, obs, _, term, trunc = env.step(states, acts)
        if bool(term[0] | trunc[0]):
            break
    frames = evaluate.policy_frames("ctf", cfg, net, seed=0, device="cpu")
    _check_gif(gif, frames, steps)


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


def test_league_matrix_gif(tmp_path):
    """``league_matrix --cpu --gif`` saves one greedy match of the final
    blue against the final red as ``<run_dir>/match.gif``, stepped here
    again to count its steps."""
    from gym_multigrid_tpu_torch.envs.ctf import NUM_ACTIONS
    from gym_multigrid_tpu_torch.rl.families import make_ctf_cfg
    from gym_multigrid_tpu_torch.rl.networks import ActorCritic
    from gym_multigrid_tpu_torch.rl.selfplay import make_ctf_selfplay_batch
    from gym_multigrid_tpu_torch.utils.checkpoint import load_state

    out = str(tmp_path / "sp")
    train_selfplay.main([*SMALL[:4], "1", *SMALL[5:], "--pool-size", "1", "--eval-envs", "4",
                         "--eval-steps", "10", "--out", out])
    league_matrix.main([out, "--cpu", "--envs", "4", "--steps", "10", "--gif"])
    cfg = make_ctf_cfg(os.path.join(ROOT, "tests", "assets", "board.txt"))
    ck = load_state(os.path.join(out, "models", "selfplay"))
    env = make_ctf_selfplay_batch(cfg, 1, auto_reset=False, device="cpu")
    states, obs = env.reset(0)
    nets = []
    for key, n in (("blue_params", cfg.num_blue_agents), ("red_params", cfg.num_red_agents)):
        nets.append(ActorCritic(NUM_ACTIONS, n, obs_shape=tuple(obs.shape[1:])))
        nets[-1].load_state_dict(ck[key])
    for steps in range(1, cfg.max_steps + 1):
        with torch.no_grad():
            acts = torch.cat([net(obs)[0].argmax(dim=-1) for net in nets], dim=1)
        states, obs, _, term, trunc = env.step(states, acts.to(torch.int32))
        if bool(term[0] | trunc[0]):
            break
    frames = league_matrix.match_frames(cfg, *nets, seed=0, device="cpu")
    _check_gif(os.path.join(out, "match.gif"), frames, steps)


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
