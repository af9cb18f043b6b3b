"""The Maze cell's own pieces on the CPU: the plain reference against the
program's plain episode steps (``ops/maze_slab.py`` ``ms_philox_spec``)
over chunks that span flag terminations, truncations and respawns, the
reference's first reset against the rollout's, the cell's check with the
program, the control and each fault on three seeds, the reference's
independence of the program, and the span metrics of a traced run."""

import dataclasses
import json
import subprocess
import sys

import pytest
import torch

from benchmark import faults, harness, run
from benchmark.drivers import family
from benchmark.reference import maze as ref_mz
from benchmark.reference import philox
from benchmark.tests.conftest import tiny_cell

CELL = "maze-main.episode-b65536"
CPU = torch.device("cpu")
SEEDS = [2**31 + 505, 7 * 2**32 + 11, 2**40 + 3]


def limits() -> dict:
    return harness.load_json(harness.HERE / "limits" / f"{CELL}.json")["limits"]


@pytest.mark.parametrize("seed,step0,chunks", [(2**31 + 606, 0, (45, 45, 140)),
                                               (7 * 2**32 + 3, 101, (1, 99, 100, 30))])
def test_reference_follows_the_plain_episode_steps(seed, step0, chunks):
    """230 steps at B = 48 from the first reset, through two truncations and
    flag ends, as chunks of the program's plain K-step version started at
    ``step0`` (odd in the second case): the same first reset, position,
    direction, step count, running return and sums."""
    from gym_multigrid_tpu_torch.ops import maze_slab

    conf = harness.find_cell(CELL).config["config"]
    B, t, key = 48, ref_mz.tables(conf), philox.key_of(seed)
    rollout = family("maze").make(family("maze").config(conf), B, CPU, 50)
    states, _ = rollout.reset(seed)
    reset = ref_mz.first_reset(t, key, B, CPU)
    got_reset = family("maze").flat(states, B)
    assert all(torch.equal(g, w) for g, w in zip(got_reset, reset))

    slab, s1 = rollout.slab, rollout.slab.t.s1
    zeros = torch.zeros((B,))
    state = (states.pos[:, 0] * s1 + states.pos[:, 1], states.dir, states.step_count,
             zeros, zeros, zeros, torch.zeros((B,), dtype=torch.int32))
    s = step0
    for K in chunks:
        state = maze_slab.ms_philox_spec(slab, K, *state, key, s)
        s += K
    cell, dirs, sc, run_ret, rew, ep, eps = state
    pos = torch.stack([cell // s1, cell % s1], dim=1)
    (ref_cell, ref_dirs, ref_sc), ref_run, sums = ref_mz.episode_call(
        t, (states.pos, states.dir, states.step_count, zeros), key, step0, sum(chunks))
    assert torch.equal(ref_mz.pack(pos), ref_cell) and torch.equal(dirs, ref_dirs)
    assert torch.equal(sc, ref_sc) and torch.equal(run_ret, ref_run)
    assert float(rew.sum()) == float(sums["reward_sum"])
    assert float(ep.sum()) == float(sums["ep_return_sum"])
    assert int(eps.sum()) == int(sums["episodes"])
    flags = round(float(rew.double().sum()) + 0.01 * B * sum(chunks))
    assert 0 < flags < int(eps.sum()) - B  # flag ends, and truncations beside them


@pytest.mark.parametrize("seed", SEEDS)
def test_program_passes_the_check(seed):
    line, checked = run.execute(tiny_cell(CELL), seed, 0.2, False, CPU)
    assert json.loads(line)["correct"], checked
    assert all(c["value"] == 0 for c in checked.values()), checked


@pytest.mark.parametrize("seed", SEEDS)
def test_control_fails_the_check(seed):
    cell = tiny_cell(CELL)
    driver = harness.driver_module("episode").Driver(cell, seed, CPU)
    harness.run_window(driver.call, 0.1, CPU)
    driver.free()
    got, lim = driver.check(control=True), limits()
    assert any(v > lim[k] for k, v in got.items()), got


@pytest.mark.parametrize("fault", ["half", "unchanged", "altered"])
@pytest.mark.parametrize("seed", SEEDS)
def test_fault_fails_the_check(fault, seed):
    line, checked = run.execute(tiny_cell(CELL), seed, 0.2, False, CPU, faults.FAULTS[fault])
    assert not json.loads(line)["correct"], checked


def test_reference_imports_nothing_of_the_program():
    code = ("import sys\nimport benchmark.reference.maze\n"
            "print([m for m in sys.modules if m.split('.')[0] in "
            "('gym_multigrid_tpu_torch', 'gym_multigrid_tpu', 'jax')])\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def test_traced_cpu_run_reports_the_span_metrics():
    cell = tiny_cell(CELL)  # the first call checked, however slow the traced one
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, check_within=1))
    line, _ = run.execute(cell, 2**31 + 808, 0.2, True, CPU)
    metrics = json.loads(line)["metrics"]
    assert metrics["host_syncs_per_call.rollout"]["value"] == 0
    assert metrics["host_ms_per_call.rollout"]["value"] > 0

