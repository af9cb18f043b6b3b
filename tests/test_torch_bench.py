"""The port's bench entry points (``gym_multigrid_tpu_torch/scripts/
{bench,bench_all}.py``) on the CPU at a tiny size: the benchmark configs,
constants and step alignment equal the JAX harnesses'; each prints the
JAX line's keys with the port's ``device``, ``windows`` and
``kernel_launches_per_call``; the isolated run goes through one process a
family; without a card and without ``--cpu`` both exit nonzero before any
work; and, in a fresh interpreter, neither loads JAX."""

from __future__ import annotations

import ast
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gym_multigrid_tpu_torch.ops import collect_slab
from gym_multigrid_tpu_torch.scripts import bench, bench_all, bench_multichip

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"metric", "value", "unit", "vs_baseline", "device", "windows",
        "kernel_launches_per_call"}


def _jax_bench_all():
    """The JAX package's root ``bench_all.py``, which leaves a configured
    compilation cache as it is (``tests/conftest.py`` configures one)."""
    sys.path.insert(0, ROOT)
    try:
        import bench_all as jax_bench_all
    finally:
        sys.path.remove(ROOT)
    return jax_bench_all


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def _lines(capsys):
    return [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]


def _check_line(rec, baseline):
    assert set(rec) == KEYS
    assert rec["unit"] == "agent-steps/s"
    assert rec["device"] == "cpu" and rec["kernel_launches_per_call"] == {}
    assert len(rec["windows"]) == bench_all.WINDOWS
    assert all(math.isfinite(w) and w > 0 for w in rec["windows"])
    assert rec["value"] == round(max(rec["windows"]), 1)
    assert rec["vs_baseline"] == round(rec["value"] / baseline, 2)


@pytest.mark.parametrize("family", bench_all.FAMILIES)
def test_family_cfg_matches_jax(family):
    """Each family's benchmark config equals JAX's field by field (CtF's
    enemy policies as (kind, randomness): the packages' PolicySpec classes
    differ), with the same agents an env."""
    jcfg, _, jagents = _jax_bench_all()._family_cfg(family)
    tcfg, _, _, tagents = bench_all.family_cfg(family)
    assert type(tcfg).__name__ == type(jcfg).__name__ and tagents == jagents
    names = [f.name for f in dataclasses.fields(jcfg)]
    assert names == [f.name for f in dataclasses.fields(tcfg)]
    for name in names:
        a, b = getattr(jcfg, name), getattr(tcfg, name)
        if name == "enemy_policies":
            a = tuple((p.kind, p.randomness) for p in a)
            b = tuple((p.kind, p.randomness) for p in b)
        assert _same(a, b), (family, name, a, b)
    # bench_multichip's names are bench_all's.
    assert bench_multichip.family_cfg is bench_all.family_cfg


def test_constants_and_alignment_match_jax():
    jb = _jax_bench_all()
    assert bench_all.CHUNKS == jb.MS_CHUNKS["xla-ms"]
    assert bench_all.MS_STEPS == jb.MS_STEPS
    assert bench_all.BASELINES == jb.BASELINES
    assert bench_all.MIN_WINDOW_S == jb.MIN_WINDOW_S
    assert set(bench_all.FAMILIES) == set(jb.HEADLINE)
    for family in bench_all.FAMILIES:
        for steps in range(1, 601):
            assert bench_all.align_steps(family, steps) == jb.align_steps(family, steps)


def test_bench_constants_match_jax():
    """The root ``bench.py``'s constants, read with ``ast``: importing it
    would switch JAX's compilation cache to writes."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    consts = {t.id: ast.literal_eval(node.value) for node in tree.body
              if isinstance(node, ast.Assign) for t in node.targets
              if isinstance(t, ast.Name)
              and t.id in ("REFERENCE_AGENT_STEPS_PER_SEC", "BATCH", "STEPS_PER_CALL")}
    assert consts == {"REFERENCE_AGENT_STEPS_PER_SEC": bench.REFERENCE_AGENT_STEPS_PER_SEC,
                      "BATCH": bench.BATCH, "STEPS_PER_CALL": bench.STEPS_PER_CALL}
    assert bench.REFERENCE_AGENT_STEPS_PER_SEC == bench_all.BASELINES["collect"]


def test_bench_prints_one_line(monkeypatch, capsys):
    monkeypatch.setattr(bench_all, "MIN_WINDOW_S", 0.0)
    rec = bench.main(["--cpu", "--batch", "16", "--steps", "50"])
    lines = _lines(capsys)
    assert lines == [rec]
    _check_line(rec, 9_400.0)
    assert rec["metric"] == "agent-steps/sec/chip (Collect, batch 16)"


def test_bench_default_metric_is_jax_string(monkeypatch, capsys):
    """At the default batch the metric is JAX's letter for letter (the
    measurement itself is stubbed: B = 8192 is not run on the CPU)."""
    got = {}

    def fake_measure(family, batch, steps, path, device, partial_view=None):
        got.update(family=family, batch=batch, steps=steps, path=path, device=device)
        return {"value": 1.0, "windows": [1.0, 1.0, 1.0], "launches": {}, "device": "cpu",
                "backend": "cpu"}

    monkeypatch.setattr(bench_all, "measure", fake_measure)
    rec = bench.main(["--cpu"])
    assert rec["metric"] == "agent-steps/sec/chip (Collect, batch 8192)"
    assert got == {"family": "collect", "batch": 8192, "steps": 500, "path": "step",
                   "device": "cpu"}
    capsys.readouterr()


def test_bench_all_no_isolate_all_paths(monkeypatch, capsys):
    monkeypatch.setattr(bench_all, "MIN_WINDOW_S", 0.0)
    lines = bench_all.main(["--cpu", "--no-isolate", "--all-paths", "--families",
                            "collect,maze", "--batch", "16", "--steps", "50"])
    assert _lines(capsys) == lines
    assert [r["metric"] for r in lines] == [
        f"agent-steps/sec/chip ({f}, batch 16, {p}, cpu)"
        for f in ("collect", "maze") for p in ("step", "episode")]
    for rec, family in zip(lines, ("collect", "collect", "maze", "maze")):
        _check_line(rec, bench_all.BASELINES[family])


def test_bench_all_runners():
    """The Collect ``episode`` runner is the episode rollout at chunk 25
    that ``tests/test_torch_collect_episode.py`` holds to JAX; the
    ``step`` runner is the batch env's rollout; only ``step`` takes a
    partial view."""
    env, call, agents = bench_all.make_runner("collect", 16, "episode", "cpu")
    assert isinstance(env, collect_slab.CollectEpisodeRollout) and call is env
    assert env.chunk == 25 and env.num_envs == 16 and agents == 2
    assert env.cfg == bench_all.family_cfg("collect")[0]
    env, call, agents = bench_all.make_runner("ctf", 8, "step", "cpu", partial_view=7)
    assert call == env.rollout and agents == 4
    states, _ = env.reset(0)
    assert env.encode(env.cfg, states).shape == (8, 4, 7, 7, 3)
    assert bench_all.make_runner("ctf", 8, "episode", "cpu", partial_view=7) is None
    for family in bench_all.FAMILIES:
        env, _, _ = bench_all.make_runner(family, 4, "episode", "cpu")
        assert env.chunk == bench_all.CHUNKS[family]
    with pytest.raises(ValueError, match="unknown path"):
        bench_all.make_runner("maze", 4, "xla-ms", "cpu")


def test_bench_all_partial_obs_takes_step_path_only(monkeypatch, capsys):
    monkeypatch.setattr(bench_all, "MIN_WINDOW_S", 0.0)
    lines = bench_all.main(["--cpu", "--families", "maze", "--all-paths", "--partial-obs", "5",
                            "--batch", "8", "--steps", "10"])
    assert [r["metric"] for r in lines] == ["agent-steps/sec/chip (maze, batch 8, step, pov5, cpu)"]
    _check_line(lines[0], bench_all.BASELINES["maze"])
    capsys.readouterr()


def test_bench_all_isolated(capsys):
    """Two families, each in its own process (at the default 1 s windows),
    their lines echoed here."""
    lines = bench_all.main(["--cpu", "--families", "maze,wildfire", "--batch", "8",
                            "--steps", "8"])
    assert _lines(capsys) == lines
    assert [r["metric"] for r in lines] == [
        "agent-steps/sec/chip (maze, batch 8, step, cpu)",
        "agent-steps/sec/chip (wildfire, batch 8, step, cpu)"]
    for rec, family in zip(lines, ("maze", "wildfire")):
        _check_line(rec, bench_all.BASELINES[family])


def test_isolated_failure_exits_nonzero(monkeypatch, capsys):
    """A family's process that exits nonzero makes the parent exit
    nonzero, after the other families ran."""
    ran = []

    def fake_run(sub, **kw):
        family = sub[sub.index("--families") + 1]
        ran.append(family)
        out = "" if family == "maze" else '{"metric": "m"}\n'
        return subprocess.CompletedProcess(sub, 1 if family == "maze" else 0, out, "boom")

    monkeypatch.setattr(bench_all.subprocess, "run", fake_run)
    with pytest.raises(SystemExit) as e:
        bench_all.main(["--cpu", "--families", "maze,wildfire"])
    assert e.value.code and "maze" in str(e.value.code)
    assert ran == ["maze", "wildfire"]
    assert _lines(capsys) == [{"metric": "m"}]


@pytest.mark.parametrize("main, argv", [
    (bench.main, []),
    (bench_all.main, []),
    (bench_all.main, ["--families", "maze"]),
])
def test_no_card_exits_nonzero_without_work(monkeypatch, main, argv):
    """Without ``--cpu`` and without a card: a nonzero exit before any
    measurement or subprocess, never a run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def refuse(*args, **kwargs):
        raise AssertionError("ran work without a card")

    monkeypatch.setattr(bench_all, "measure", refuse)
    monkeypatch.setattr(bench_all, "run_isolated", refuse)
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code and "no CUDA device" in str(e.value.code)


def test_bench_scripts_do_not_import_jax(tmp_path):
    """Both entry points, tiny, in a fresh interpreter, which then has no
    ``jax`` and no ``gym_multigrid_tpu`` module loaded."""
    code = """
import sys
from gym_multigrid_tpu_torch.scripts import bench, bench_all
bench_all.MIN_WINDOW_S = 0.0
bench.main(["--cpu", "--batch", "4", "--steps", "50"])
bench_all.main(["--cpu", "--families", "ctf", "--all-paths", "--batch", "4", "--steps", "4"])
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
