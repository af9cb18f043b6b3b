"""Shared helpers of the benchmark's tests: every cell of BENCHMARK.json
cut to a size the CPU runs in a second or two (the same files, fewer
envs, steps and calls), and the ``card`` marker of the tests that need a
CUDA card, which decide so inside a fixture."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from benchmark import harness

#: The traffic each kind of driver takes at the tests' size.
TINY = {
    "episode": {"num_envs": 48, "steps_per_call": {"ctf": 20, "wildfire": 12},
                "chunk": {"ctf": 7, "wildfire": 5}, "warmup_calls": 1, "check_within": 2},
    "step": {"num_envs": 48, "action_bank": 3, "warmup_calls": 1, "check_within": 2},
    "train": {"num_envs": 128, "checked_steps": 2},
}
CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


def tiny_cell(name: str):
    cell = harness.find_cell(name)
    traffic = dict(cell.traffic, **TINY[cell.traffic["driver"]])
    if "ppo" in traffic:
        traffic["ppo"] = dict(traffic["ppo"], rollout_len=3, num_minibatches=2,
                              shuffle_blocks=4)
    return dataclasses.replace(cell, traffic=traffic)


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
