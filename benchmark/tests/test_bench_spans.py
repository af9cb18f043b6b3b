"""The readers of the program's spans on hand-built traces: each counts
only the synchronising runtime calls inside its own root spans, leaves
out the window's closing ``cudaDeviceSynchronize``, names each sync's
innermost span, and reads nothing from a trace without the program's
spans; and a traced run of the CPU-sized episode and step cells reports
them."""

import dataclasses
import json

import pytest
import torch

from benchmark import harness, run
from benchmark.tests.conftest import tiny_cell

MS = 1_000_000  # ns
spans = harness.load_module(harness.HERE / "metrics" / "host_syncs_per_call.rollout.py",
                            "benchmark_spans_test")


def ms(name, start, length):
    return (name, int(start * MS), int(length * MS))


#: Outside every root: a sync between calls and the window's closing one.
OUTSIDE = [ms("cudaStreamSynchronize", 1.5, 0.01), ms("cudaDeviceSynchronize", 90, 5)]

EPISODE = OUTSIDE + [
    ms("rollout.call", 0, 1), ms("rollout.chunk", 0.1, 0.4), ms("aten::copy_", 0.15, 0.1),
    ms("cudaMemcpyAsync", 0.16, 0.02), ms("cudaStreamSynchronize", 0.2, 0.05),
    ms("cudaLaunchKernel", 0.3, 0.005),
    ms("rollout.call", 2, 3), ms("cudaEventSynchronize_v3020", 4, 0.1),
    # Another layer's root: not the rollout's.
    ms("env.step", 7, 1), ms("cudaStreamSynchronize", 7.5, 0.1),
]
STEP = OUTSIDE + [
    ms("env.step", 10, 2), ms("env.transition", 10.1, 0.4),
    ms("env.encode", 10.6, 0.4), ms("cudaMemcpyAsync", 10.7, 0.1),
    ms("cudaStreamSynchronize", 10.8, 0.1),
    ms("env.reset", 11, 0.9), ms("cudaMemcpy", 11.5, 0.2),
    ms("env.step", 13, 1), ms("cudaLaunchKernel", 13.5, 0.01),
    ms("rollout.call", 15, 1), ms("cudaStreamSynchronize", 15.5, 0.1),
]
TRAIN = OUTSIDE + [
    ms("ppo.rollout", 20, 10), ms("ppo.rollout.step", 21, 4), ms("env.step", 22, 2),
    ms("env.encode", 22.5, 1), ms("cudaMemcpyAsync", 22.6, 0.3),
    ms("cudaStreamSynchronize", 23, 0.4), ms("ppo.forward", 25, 1),
    ms("ppo.update", 30, 20), ms("ppo.minibatch", 31, 9), ms("ppo.loss", 32, 3),
    ms("cudaStreamSynchronize", 33, 1), ms("cudaDeviceSynchronize", 45, 2),
    ms("ppo.rollout", 50, 5), ms("ppo.update", 55, 3),
    ms("env.step", 60, 1), ms("cudaStreamSynchronize", 60.5, 0.1),
]

#: (metric, the trace it reads, its value, the syncs' callers inside its roots)
CASES = [
    ("host_syncs_per_call.rollout", EPISODE, 1.0, {"rollout.chunk": 1, "rollout.call": 1}),
    ("host_ms_per_call.rollout", EPISODE, 2.0, None),
    ("host_syncs_per_call.step", STEP, 1.0, {"env.encode": 1, "env.reset": 1}),
    ("host_ms_per_call.step", STEP, 1.5, None),
    ("host_syncs_per_call.train", TRAIN, 1.5, {"env.encode": 1, "ppo.loss": 1,
                                               "ppo.update": 1}),
    ("rollout_host_ms.train", TRAIN, 7.5, None),
    ("update_host_ms.train", TRAIN, 11.5, None),
    # The syncs and every copy inside the roots: 0.3 + 0.4 + 1 + 2 ms over 2 steps.
    ("host_wait_ms.train", TRAIN, 1.85, None),
]
ROOTS = {"rollout": ("rollout.call",), "step": ("env.step",),
         "train": ("ppo.rollout", "ppo.update")}


def run_of(host_ops):
    trace = harness.Trace(device_ops=[], host_ops=list(host_ops), window_s=0.1, calls=2)
    window = harness.Window(calls=2, seconds=0.1, call_ms=[1.0, 1.0])
    return harness.Run(harness.find_cell("ctf-main.train-1m"), 1.0, window, 0, {}, trace)


@pytest.mark.parametrize("name,ops,want,callers", CASES, ids=[c[0] for c in CASES])
def test_reader_counts_inside_its_roots(name, ops, want, callers):
    read = harness.metric_reader(name)
    assert read(run_of(ops)) == pytest.approx(want, rel=1e-12)
    if callers is not None:
        assert spans.by_caller(run_of(ops).trace, ROOTS[name.rsplit(".", 1)[1]]) == callers


@pytest.mark.parametrize("name,ops", [(c[0], c[1]) for c in CASES], ids=[c[0] for c in CASES])
def test_reader_reads_nothing_without_spans(name, ops):
    """A program without spans and an untraced run give None, never 0."""
    read = harness.metric_reader(name)
    bare = [op for op in ops if not op[0].startswith(spans.SPAN_PREFIXES)]
    assert read(run_of(bare)) is None
    untraced = run_of(ops)
    untraced.trace = None
    assert read(untraced) is None


def test_runtime_names_and_innermost():
    assert spans.runtime_name("cudaMemcpyAsync_ptsz") == "cudaMemcpyAsync"
    assert spans.runtime_name("cudaStreamSynchronize") == "cudaStreamSynchronize"
    trace = run_of(TRAIN).trace
    # A sync, a gap in ppo.forward, one between the two roots, one after all.
    assert spans.innermost(trace, [int(23 * MS), int(25.5 * MS), int(26 * MS) + 1,
                                   int(95 * MS)]) == ["env.encode", "ppo.forward",
                                                      "ppo.rollout", None]


@pytest.mark.parametrize("name", ["ctf-main.episode-b65536", "wildfire-main.episode-b65536",
                                  "wildfire-main.step-b65536"])
def test_traced_cpu_run_reports_the_span_metrics(name):
    """A traced run of the CPU-sized cell reports every span metric of the
    cell, with no host synchronisation in the CPU's calls."""
    # The first call is the checked one, so that a slow traced first call
    # (the profiler's start) cannot end the window before it.
    cell = tiny_cell(name)
    cell = dataclasses.replace(cell, traffic=dict(cell.traffic, check_within=1))
    line, _ = run.execute(cell, 2**31 + 505, 0.2, True, torch.device("cpu"))
    metrics = json.loads(line)["metrics"]
    cell = harness.find_cell(name)
    want = {m["name"] for m in cell.per_layer if m["name"].startswith(("host_", "rollout_host",
                                                                        "update_host"))}
    assert len(want) == 2 and want <= set(metrics)
    assert all(metrics[n]["value"] == 0 for n in want if "syncs" in n)
    assert all(metrics[n]["value"] > 0 for n in want if "ms" in n)
