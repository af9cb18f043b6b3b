"""Shared helpers of the benchmark's tests: every cell of BENCHMARK.json
cut to a size the CPU runs in a second or two (the same files, fewer
envs, steps and calls: the driver's ``TINY``, then the family module's
for that driver), and the ``card`` marker of the tests that need a CUDA
card, which decide so inside a fixture."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from benchmark import harness
from benchmark.drivers import family

CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


def merged(traffic: dict, tiny: dict) -> dict:
    """``traffic`` with ``tiny``'s values; a map in both is merged."""
    return dict(traffic, **{k: dict(traffic[k], **v) if isinstance(v, dict)
                            and isinstance(traffic.get(k), dict) else v for k, v in tiny.items()})


def tiny_cell(name: str):
    cell = harness.find_cell(name)
    kind = cell.traffic["driver"]
    traffic = merged(cell.traffic, harness.driver_module(kind).TINY)
    traffic = merged(traffic, family(cell.config["family"]).TINY.get(kind, {}))
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
