"""The Collect cell's own pieces on the CPU: the plain reference against
the program's plain episode steps (``ops/collect_slab.py``
``ms_philox_spec``) over two episode ends with respawns, the reference's
independence of the program, the span metrics of a traced run, and the
kernel work reader."""

import dataclasses
import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness, run
from benchmark.drivers import family
from benchmark.reference import collect as ref_co
from benchmark.reference import philox
from benchmark.roofline import window
from benchmark.tests.conftest import tiny_cell

CELL = "collect-main.episode-b65536"
CPU = torch.device("cpu")


@pytest.mark.parametrize("seed,step0", [(2**31 + 606, 0), (7 * 2**32 + 3, 25)])
def test_reference_follows_the_plain_episode_steps(seed, step0):
    """100 steps at B = 48 from the first reset, through the ends of two
    episodes (the second within them where ``step0`` is 25): the same
    first reset, packed board, positions, rewards and pickups."""
    from gym_multigrid_tpu_torch.ops import collect_slab

    conf = harness.find_cell(CELL).config["config"]
    B, K, t = 48, 100, ref_co.tables(conf)
    rollout = family("collect").make(family("collect").config(conf), B, CPU, 50)
    states, _ = rollout.reset(seed)
    key = philox.key_of(seed)
    reset = ref_co.first_reset(t, key, B, CPU)
    got_reset = (collect_slab.pack_planes(states.grid_obj, states.grid_color, states.grid_slot),
                 states.agent_pos.reshape(B, -1))
    assert all(torch.equal(g, w) for g, w in zip(got_reset, reset))

    slab = rollout.slab
    counts = torch.zeros((B, 2 * len(conf["balls_index"])), dtype=torch.int32)
    p, pos, ret = collect_slab.ms_philox_spec(
        slab, K, got_reset[0], got_reset[1], torch.zeros((B, 2)), key, step0, counts=counts)
    board = (states.grid_obj, states.grid_color, states.grid_slot, got_reset[1])
    need = {}
    (ref_p, ref_pos), sums = ref_co.episode_call(t, board, key, step0, K, count=need)
    assert torch.equal(p, ref_p) and torch.equal(pos, ref_pos)
    assert float(ret.sum()) == float(sums["reward_sum"])
    assert int(counts.sum()) == need["pickups"] > 0
    assert int(sums["episodes"]) == 2 * B


def test_control_differs_from_the_reference():
    """The reference in bfloat16 moves another board than in float32."""
    conf = harness.find_cell(CELL).config["config"]
    t, key, B = ref_co.tables(conf), philox.key_of(2**31 + 707), 48
    board = ref_co.fresh(t, philox.uniform(ref_co.words(key, 0, 1, B, t.n_uniforms,
                                                        ref_co.FIRST, CPU)[0]))
    got = ref_co.episode_call(t, board, key, 0, 50, torch.float32)[0]
    low = ref_co.episode_call(t, board, key, 0, 50, torch.bfloat16)[0]
    assert not torch.equal(got[0], low[0])


def test_reference_imports_nothing_of_the_program():
    code = ("import sys\nimport benchmark.reference.collect\n"
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


def test_work_reader_counts_the_traced_launches():
    """Bytes and operations for a window of 2 calls of 500 steps in chunks
    of 50 at 65,536 envs with 950,000 pickups a call; nothing where the
    trace's launches are not the wrapper's."""
    cell = harness.find_cell(CELL)
    B, calls = 65536, 2
    ops = [("void collect::(anonymous namespace)::steps_philox_kernel<4, 2>", i, 400_000)
           for i in range(10 * calls)]
    counts = {"episodes": 10 * B * calls, "launches": 10 * calls, "num_envs": B,
              "steps_per_call": 500, "chunk": 50, "pickups": 950_000}
    trace = harness.Trace(ops, [], 1.0, calls)
    win = harness.Window(calls, 1.0, [4.0] * calls)
    nbytes, n_ops, seconds = window.work(harness.Run(cell, 1.0, win, 0, {}, trace, counts))
    per_env_step = 2 * 16 + 2 * 78 + 5 * 3
    per_pickup = 6 + 4 * 3 + 8
    per_board = 5 * 78 + 17 * 3 + 100 + 15 * (4 * 3 + 8) + 2 * 16
    assert n_ops == (500 * B * per_env_step + 950_000 * per_pickup + 10 * B * per_board) * calls
    assert nbytes == 10 * calls * (2 * B * 4 * (100 + 4 + 2) + 4 * (3 * 4 + 16 * 4 + 15 + 4 + 18))
    assert seconds == pytest.approx(20 * 400e-6)
    counts["launches"] -= 1
    assert window.work(harness.Run(cell, 1.0, win, 0, {}, trace, counts)) is None
