"""A whole run of each cell on the CPU at the tests' size: the reference
agrees with the program's plain versions, the result line has the
contract's keys, the control fails the limits, and each fault planted
under the timed path makes ``correct`` false."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import faults, harness, run
from benchmark.tests.conftest import CELLS, tiny_cell

CPU = torch.device("cpu")
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checked"}


@pytest.mark.parametrize("name", CELLS)
def test_program_agrees_with_reference(name):
    line, checked = run.execute(tiny_cell(name), 2**31 + 101, 0.2, False, CPU)
    line = json.loads(line)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checked"]
    assert set(line) == LINE_KEYS and line["correct"], checked
    assert all(c["value"] == 0 or c["value"] < 1e-6 for c in checked.values()), checked
    assert "setup_s" in line["metrics"] and line["attempted"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_control_fails(name):
    cell = tiny_cell(name)
    limits = harness.load_json(harness.HERE / "limits" / f"{name}.json")["limits"]
    driver = harness.driver_module(cell.traffic["driver"]).Driver(cell, 2**31 + 202, CPU)
    harness.run_window(driver.call, 0.1, CPU)
    driver.free()
    got = driver.check(control=True)
    assert any(v > limits[k] for k, v in got.items()), got


FAULTS = [(n, f) for n in CELLS for f in faults.FAULTS
          if not (f == "altered" and harness.find_cell(n).traffic["driver"] == "train")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_fault_is_caught(name, fault):
    line, checked = run.execute(tiny_cell(name), 2**31 + 303, 0.2, False, CPU,
                                faults.FAULTS[fault])
    assert not json.loads(line)["correct"], checked


def test_no_card_no_result():
    """Without a card the run exits nonzero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=harness.ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_nothing_of_jax_is_loaded():
    """The harness, the drivers, the reference and every metric reader load
    no module named jax, jaxlib, flax or gym_multigrid_tpu (whole top-level
    names), and the reference loads nothing of the program."""
    code = (
        "import sys, pathlib\n"
        "import benchmark.reference.ctf, benchmark.reference.wildfire, benchmark.reference.ppo\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == 'gym_multigrid_tpu_torch']\n"
        "from benchmark import harness, run, control, faults\n"
        "import benchmark.drivers.episode, benchmark.drivers.step, benchmark.drivers.train\n"
        "for f in sorted((harness.HERE / 'metrics').glob('*.py')):\n"
        "    harness.metric_reader(f.stem)\n"
        "import gym_multigrid_tpu_torch.parallel.vector, gym_multigrid_tpu_torch.rl.ppo\n"
        "print(harness.forbidden_loaded())\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_card_run_is_correct(card, name):
    line, checked = run.execute(tiny_cell(name), 2**31 + 404, 0.5, False, card)
    assert json.loads(line)["correct"], checked
