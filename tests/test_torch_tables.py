"""The port's static tables and config checks equal the JAX package's.

Covers the color and action tables, the Collect world schema, and the
placement plan, wall mask and reward-slot tables of the configs behind
every registered Collect id.  Also checks that each C entry point's
signature in ``csrc/`` matches the ctypes argument types the loader
declares, and that the kernels' object, color, action and size constants
equal the Python tables, since no CUDA compiler runs with these tests.
"""

import dataclasses
import itertools
import math
import re
from pathlib import Path

import gymnasium as gym
import numpy as np
import pytest
import torch

import gym_multigrid_tpu  # noqa: F401  (registers the ids)
from gym_multigrid_tpu.core import constants as jconst
from gym_multigrid_tpu.core import world as jworld
from gym_multigrid_tpu.envs import collect as jcollect
from gym_multigrid_tpu_torch.core import constants as tconst
from gym_multigrid_tpu_torch.core import world as tworld
from gym_multigrid_tpu_torch.envs import collect as tcollect
from gym_multigrid_tpu_torch.ops import _build, collect_slab

torch.set_num_threads(1)

COLLECT_IDS = [
    "multigrid-collect-v0",
    "multigrid-collect-single-v0",
    "multigrid-collect-quadrants-v0",
    "multigrid-collect-rooms-v0",
    "multigrid-collect-rooms-fixed-horizon-v0",
    "multigrid-collect-rooms-respawn-v0",
    "multigrid-collect-respawn-v0",
    "multigrid-collect-respawn-clustered-v0",
    "multigrid-collect-quadrants15-v0",
]


def test_color_action_and_world_tables_equal_jax():
    assert tconst.COLOR_TO_IDX == jconst.COLOR_TO_IDX
    assert list(tconst.COLORS) == list(jconst.COLORS)
    for name, rgb in jconst.COLORS.items():
        np.testing.assert_array_equal(tconst.COLORS[name], rgb)
    for name in ("DIR_TO_VEC", "COLLECT_ACTION_TO_VEC"):
        got, want = getattr(tconst, name), getattr(jconst, name)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    tw, jw = tworld.CollectWorld, jworld.CollectWorld
    assert tw.OBJECT_TO_IDX == jw.OBJECT_TO_IDX
    assert tw.IDX_TO_OBJECT == jw.IDX_TO_OBJECT
    assert tw.COLOR_TO_IDX == jw.COLOR_TO_IDX
    assert (tw.encode_dim, tw.normalize_obs) == (jw.encode_dim, jw.normalize_obs)
    for name in ("EMPTY", "WALL", "BALL", "AGENT", "WALL_COLOR", "AGENT_DIR"):
        assert getattr(tcollect, name) == getattr(jcollect, name)


def test_every_registered_collect_id_is_covered():
    ids = sorted(k for k in gym.registry if k.startswith("multigrid-collect"))
    assert ids == sorted(COLLECT_IDS)


@pytest.mark.parametrize("env_id", COLLECT_IDS)
def test_plan_wall_and_slot_tables_equal_jax(env_id):
    env = gym.make(env_id)
    jcfg = env.unwrapped.cfg
    env.close()
    tcfg = tcollect.CollectConfig(**dataclasses.asdict(jcfg))
    assert dataclasses.astuple(tcfg) == dataclasses.astuple(jcfg)

    np.testing.assert_array_equal(tcollect._wall_mask(tcfg), jcollect._wall_mask(jcfg))
    tp, jp = tcollect.build_plan(tcfg), jcollect.build_plan(jcfg)
    for f in dataclasses.fields(jp):
        got, want = getattr(tp, f.name), getattr(jp, f.name)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
        else:
            assert got == want, f.name
    for got, want in zip(
        tcollect.reward_slot_tables(tcfg, tp), jcollect.reward_slot_tables(jcfg, jp)
    ):
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "kw",
    [
        dict(size=3),
        dict(agents_index=()),
        dict(balls_index=()),
        dict(balls_reward=(1.0,)),
        dict(max_steps=0),
        dict(layout="quadrants", num_balls=90),
        dict(size=5, num_balls=9),
        dict(layout="spiral"),
    ],
)
def test_config_checks_match_jax(kw):
    with pytest.raises(ValueError) as want:
        jcollect.CollectConfig(**kw)
    with pytest.raises(ValueError) as got:
        tcollect.CollectConfig(**kw)
    assert str(got.value) == str(want.value)


def _c_signature(source, name):
    text = (_build.CSRC / source).read_text()
    m = re.search(rf'extern "C" int {name}\(([^)]*)\)', text)
    assert m, f"no C entry point {name} in {source}"
    return [p.strip() for p in m.group(1).split(",")]


@pytest.mark.parametrize("source", sorted(_build.ENTRY_POINTS))
def test_ctypes_argtypes_match_c_entry_points(source):
    entries = _build.ENTRY_POINTS[source]
    assert entries
    for name, argtypes in entries.items():
        params = _c_signature(source, name)
        assert len(params) == len(argtypes), name
        for param, argtype in zip(params, argtypes):
            if "*" in param:
                want = _build._P
            else:
                want = _build._F if param.startswith("float ") else _build._I
                assert param.startswith(("int ", "float ")), param
            assert argtype is want, (name, param, argtype)


def _ternary_table(text, fn):
    """{A: value} of a ``constexpr int fn(int A)`` written as a chain of
    ``A == n ? value :`` tests, and its last value under key None."""
    body = re.search(rf"constexpr int {fn}\(int A\) \{{\s*return ([^;]*);", text).group(1)
    table = {int(a): int(v) for a, v in re.findall(r"A == (\d+) \? (\d+)", body)}
    table[None] = int(re.search(r": (\d+)\)*$", body).group(1))
    return table


def test_move_order_table_is_the_lexicographic_permutations():
    """csrc/move_order.cuh, which the CtF and Wildfire step kernels read the
    move order from: permutation j of A agents, in itertools.permutations
    order, packed 4 bits a slot at move_order_base(A) + j."""
    text = (_build.CSRC / "move_order.cuh").read_text()
    body = re.search(r"kMoveOrders\[kNumOrders\] = \{([^}]*)\}", text).group(1)
    table = [int(v, 16) for v in re.findall(r"0x[0-9a-f]+", body)]
    n = int(re.search(r"constexpr int kNumOrders = (\d+);", text).group(1))
    base = _ternary_table(text, "move_order_base")
    count = _ternary_table(text, "num_orders")
    assert len(table) == n == sum(math.factorial(a) for a in range(1, 5))
    for A in range(1, 5):
        perms = list(itertools.permutations(range(A)))
        start = base.get(A, base[None])
        assert start == sum(math.factorial(a) for a in range(1, A))
        assert count.get(A, count[None]) == len(perms)
        for j, perm in enumerate(perms):
            packed = table[start + j]
            assert [(packed >> (4 * s)) & 15 for s in range(A)] == list(perm), (A, j)
            assert packed >> (4 * A) == 0


def test_kernel_constants_equal_python_tables():
    text = (_build.CSRC / "collect_warp.cuh").read_text()
    consts = {
        name: int(value)
        for decl in re.findall(r"constexpr int ([^;]*);", text)
        for name, value in re.findall(r"(k\w+) = (-?\d+)", decl)
    }
    objects = tworld.CollectWorld.OBJECT_TO_IDX
    assert consts["kEmpty"] == objects["empty"] == tcollect.EMPTY
    assert consts["kWall"] == objects["wall"] == tcollect.WALL
    assert consts["kBall"] == objects["ball"] == tcollect.BALL
    assert consts["kAgent"] == objects["agent"] == tcollect.AGENT
    assert consts["kWallColor"] == tconst.COLOR_TO_IDX["grey"] == tcollect.WALL_COLOR
    assert consts["kOffBoard"] not in (tcollect.EMPTY, tcollect.BALL)
    assert consts["kMaxCells"] == collect_slab.MAX_CELLS
    vec = tconst.COLLECT_ACTION_TO_VEC
    assert len(vec) == 4
    for name, want in (("kNorth", (0, -1)), ("kEast", (1, 0)), ("kSouth", (0, 1)), ("kWest", (-1, 0))):
        assert tuple(vec[consts[name]]) == want, name


def test_library_name_follows_the_source():
    a = _build.library_path("collect_step.cu")
    b = _build.library_path("collect_reset.cu")
    assert a.parent == b.parent == _build.BUILD_DIR
    # Run from a checkout, the libraries go under its own build/ directory.
    assert _build.BUILD_DIR == Path(__file__).resolve().parents[1] / "build" / "kernels"
    assert a.name.startswith("collect_step-") and a != b
    assert a == _build.library_path("collect_step.cu")
