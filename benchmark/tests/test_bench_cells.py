"""BENCHMARK.json against the contract's shape, and each cell against its
files: configuration, traffic, driver, limits and metric readers."""

import json
import re

import pytest

from benchmark import harness
from benchmark.roofline import counts
from benchmark.tests.conftest import CELLS

BENCH = harness.load_json(harness.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "layer", "moves",
                          "workloads"}
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = harness.find_cell(name)
    assert cell.chips == 1
    assert cell.config["name"] == cell.config_name
    harness.driver_module(cell.traffic["driver"])
    limits = harness.load_json(harness.HERE / "limits" / f"{name}.json")["limits"]
    assert limits and all(v >= 0 for v in limits.values())
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))
    for m in cell.per_layer:
        assert m["moves"] in reported, (m["name"], m["moves"])


def test_each_config_is_used_and_keeps_its_sizes():
    used = {w["config"] for w in BENCH["workloads"]}
    for conf in BENCH["configs"]:
        assert conf["name"] in used
        data = harness.load_json(harness.ROOT / conf["file"])
        assert data["reduced"] == conf["reduced"]


def test_frozen_flops_of_the_1m_step():
    dims = counts.mlp_dims(216, (256, 256), 2, 5)
    assert counts.model_flops(2**20, 16, 1, dims) == pytest.approx(1.6855e13, rel=1e-4)


def test_learner_rate_reads_the_window_before_the_trace():
    """The learner's per-layer rate is read from a traced run's window
    without the profiler, and from nothing where the run had none."""
    cell = harness.find_cell("ctf-main.train-1m")
    assert cell.traffic["untraced_window_in_trace"]
    assert "train_env_steps_per_s.host" in {m["name"] for m in cell.per_layer}
    read = harness.metric_reader("train_env_steps_per_s.host")
    window = harness.Window(calls=4, seconds=2.0, call_ms=[500.0] * 4)
    run = harness.Run(cell, 1.0, window, 0, {"env_steps": 10}, untraced=window)
    assert read(run) == 20.0
    run.untraced = None
    assert read(run) is None
