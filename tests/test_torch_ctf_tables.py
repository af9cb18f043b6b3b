"""The port's CtF tables and config checks equal the JAX package's.

Covers the CtF colour and action tables and world schema, the map loader,
the patrol border and pool lists, and, for the boards the repo ships (10x10
and 20x20), both variants, obstacle penalties of 0 and 0.5 and one
non-square board cut from board.txt: ``build_tables``, ``make_ctf_ktables``,
``ctf_static_inputs`` and ``ctf_reset_inputs``.  Also checks the CtF
kernel's policy, action and size constants against the Python tables,
since no CUDA compiler runs with these tests.
"""

import dataclasses
import re

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU before the JAX package)
import numpy as np
import pytest
import torch

from gym_multigrid_tpu.core import constants as jconst
from gym_multigrid_tpu.core import world as jworld
from gym_multigrid_tpu.envs import ctf as jctf
from gym_multigrid_tpu.ops import pallas_ctf as jpc
from gym_multigrid_tpu.policy.ctf.heuristic import PatrolPolicy
from gym_multigrid_tpu.utils.map import load_text_map as jax_load_text_map
from gym_multigrid_tpu_torch.core import constants as tconst
from gym_multigrid_tpu_torch.core import world as tworld
from gym_multigrid_tpu_torch.envs import ctf as tctf
from gym_multigrid_tpu_torch.ops import _build
from gym_multigrid_tpu_torch.ops import ctf_slab as tslab
from gym_multigrid_tpu_torch.policy.ctf.heuristic import locate_border, patrol_targets
from gym_multigrid_tpu_torch.utils.map import load_text_map

torch.set_num_threads(1)

BOARD = "tests/assets/board.txt"
BOARD_LARGE = "tests/assets/board_large.txt"


def non_square_map():
    """board.txt cut to 10 x 7: both flags kept, S0 != S1, so the swapped
    bounds check lets agents step off the board."""
    fm = jax_load_text_map(BOARD).astype(int)[:, :7]
    assert (fm == 4).sum() == 1 and (fm == 5).sum() == 1
    return tuple(tuple(int(v) for v in row) for row in fm)


def cfg_pair(board=BOARD, policies=("rw",), **kw):
    """The same config in both packages; ``board`` is a path or map data."""
    jkw = dict(kw, enemy_policies=tuple(jctf.PolicySpec(k) for k in policies))
    tkw = dict(kw, enemy_policies=tuple(tctf.PolicySpec(k) for k in policies))
    jkw.setdefault("num_red_agents", len(policies))
    tkw.setdefault("num_red_agents", len(policies))
    if isinstance(board, str):
        return jctf.CtfConfig.from_map_path(board, **jkw), tctf.CtfConfig.from_map_path(board, **tkw)
    return jctf.CtfConfig(map_data=board, **jkw), tctf.CtfConfig(map_data=board, **tkw)


CONFIGS = {
    "board_mvn": dict(num_blue_agents=2, policies=("patrol", "fight")),
    "board_mvn_penalty": dict(num_blue_agents=2, policies=("patrol_fight", "rw"),
                              obstacle_penalty_ratio=0.5),
    "board_1v1": dict(variant="1v1", policies=("patrol",)),
    "board_1v1_penalty": dict(variant="1v1", policies=("capture",), obstacle_penalty_ratio=0.5),
    "large_mvn": dict(board=BOARD_LARGE, num_blue_agents=3,
                      policies=("patrol", "patrol_fight", "capture")),
    "large_1v1_penalty": dict(board=BOARD_LARGE, variant="1v1", policies=("patrol_fight",),
                              obstacle_penalty_ratio=0.5),
    "non_square": dict(board=None, num_blue_agents=2, policies=("patrol", "rw"),
                       obstacle_penalty_ratio=0.5),
}


def _pair(name):
    kw = dict(CONFIGS[name])
    if kw.get("board", BOARD) is None:
        kw["board"] = non_square_map()
    return cfg_pair(**kw)


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def test_ctf_colour_action_and_world_tables_equal_jax():
    assert list(tconst.CTF_COLORS) == list(jconst.CTF_COLORS)
    for name, rgb in jconst.CTF_COLORS.items():
        np.testing.assert_array_equal(tconst.CTF_COLORS[name], rgb)
    _eq(tconst.CTF_ACTION_TO_VEC, jconst.CTF_ACTION_TO_VEC)
    tw, jw = tworld.CtfWorld, jworld.CtfWorld
    assert tw.OBJECT_TO_IDX == jw.OBJECT_TO_IDX
    assert tw.COLOR_TO_IDX == jw.COLOR_TO_IDX
    assert (tw.encode_dim, tw.normalize_obs) == (jw.encode_dim, jw.normalize_obs)
    for name in ("BLUE_TERRITORY", "RED_TERRITORY", "BLUE_AGENT", "RED_AGENT",
                 "BLUE_FLAG", "RED_FLAG", "OBSTACLE", "NUM_ACTIONS"):
        assert getattr(tctf, name) == getattr(jctf, name), name


@pytest.mark.parametrize("path", [BOARD, BOARD_LARGE, "tests/assets/board_maze.txt"])
def test_load_text_map_equals_jax(path):
    _eq(load_text_map(path), jax_load_text_map(path))


@pytest.mark.parametrize("ego", ["red", "blue"])
@pytest.mark.parametrize("board", ["board", "large", "non_square"])
def test_patrol_border_and_pool_equal_jax_in_order(board, ego):
    fm = {"board": lambda: jax_load_text_map(BOARD),
          "large": lambda: jax_load_text_map(BOARD_LARGE),
          "non_square": lambda: np.asarray(non_square_map())}[board]()
    pp = PatrolPolicy(field_map=fm, ego_agent=ego)
    border, obstacle = locate_border(fm, ego)
    assert border == [tuple(int(v) for v in p) for p in pp.border]
    assert obstacle == [tuple(int(v) for v in p) for p in pp.obstacle]
    want = [tuple(int(v) for v in p) for p in pp.patrol_targets()]
    assert patrol_targets(border) == want  # order and duplicates included


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tables_equal_jax(name):
    jcfg, tcfg = _pair(name)
    jt, tt = jctf.build_tables(jcfg), tctf.build_tables(tcfg)
    for f in dataclasses.fields(jt):
        _eq(getattr(tt, f.name), getattr(jt, f.name))
    assert tuple(tslab.make_ctf_ktables(tcfg)) == tuple(jpc.make_ctf_ktables(jcfg))
    for got, want in zip(tslab.ctf_static_inputs(tcfg), jpc.ctf_static_inputs(jcfg)):
        _eq(got, want)
    for got, want in zip(tslab.ctf_reset_inputs(tcfg), jpc.ctf_reset_inputs(jcfg)):
        _eq(got, want)
    t = tslab.make_ctf_ktables(tcfg)
    jt_k = jpc.make_ctf_ktables(jcfg)
    assert tslab.rnd_width(t) == jpc.rnd_width(jt_k)
    assert tslab.n_perm_draws(t) == jpc.n_perm_draws(jt_k)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cell_flag_bytes_equal_the_bits_of_the_four_planes(name):
    """The flag byte per cell that the step kernel reads, cached on the
    slab, holds bit ``CELL_FLAG_BITS[r]`` exactly where ``cells`` row r is
    positive, and unpacks back to the planes."""
    _, tcfg = _pair(name)
    slab = tslab.make_ctf_slab(tcfg, "cpu")
    cells, flags = slab.cells, slab.flags
    assert flags.dtype == torch.uint8 and tuple(flags.shape) == (cells.shape[1],)
    assert torch.equal(flags, tslab.cell_flags(tslab.ctf_static_inputs(tcfg)[0]))
    for r, bit in enumerate(tslab.CELL_FLAG_BITS):
        assert torch.equal((flags & bit) != 0, cells[r] > 0), r
    assert int(flags.max()) < 16
    assert torch.equal(tslab.cell_planes(flags), (cells > 0).to(torch.int32))


def test_static_inputs_without_patrol_are_the_dummy_lists():
    jcfg, tcfg = cfg_pair(num_blue_agents=2, policies=("fight", "rw"))
    cells, border, pool = tslab.ctf_static_inputs(tcfg)
    assert tuple(border.shape) == tuple(pool.shape) == (2, 1)
    for got, want in zip((cells, border, pool), jpc.ctf_static_inputs(jcfg)):
        _eq(got, want)


def test_reset_inputs_refuse_coordinates_above_255():
    fm = np.zeros((300, 2), dtype=int)
    fm[:, 1] = 1
    fm[0, 0], fm[299, 1] = 4, 5
    data = tuple(tuple(int(v) for v in row) for row in fm)
    jcfg, tcfg = cfg_pair(board=data)
    with pytest.raises(ValueError) as want:
        jpc.ctf_reset_inputs(jcfg)
    with pytest.raises(ValueError) as got:
        tslab.ctf_reset_inputs(tcfg)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize(
    "kw",
    [
        dict(variant="2v2"),
        dict(num_blue_agents=0),
        dict(num_red_agents=0, enemy_policies=()),
        dict(variant="1v1", num_blue_agents=2),
        dict(max_steps=0),
        dict(num_red_agents=2),
    ],
)
def test_config_checks_match_jax(kw):
    with pytest.raises(ValueError) as want:
        jctf.CtfConfig.from_map_path(BOARD, **kw)
    with pytest.raises(ValueError) as got:
        tctf.CtfConfig.from_map_path(BOARD, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(kind="sprint"), dict(randomness=1.5), dict(randomness=-0.1)])
def test_policy_spec_checks_match_jax(kw):
    with pytest.raises(ValueError) as want:
        jctf.PolicySpec(**kw)
    with pytest.raises(ValueError) as got:
        tctf.PolicySpec(**kw)
    assert str(got.value) == str(want.value)


def test_config_fields_and_derived_rewards_equal_jax():
    jcfg, tcfg = cfg_pair(num_blue_agents=2, policies=("fight", "rw"),
                          flag_reward=0.7, battle_reward_ratio=0.3,
                          obstacle_penalty_ratio=0.1, step_penalty_ratio=0.03)
    assert tcfg.map_data == jcfg.map_data
    for name in ("num_agents", "battle_reward", "obstacle_penalty", "step_penalty"):
        assert getattr(tcfg, name) == getattr(jcfg, name), name
    _eq(tcfg.field_map, jcfg.field_map)


def test_kernel_constants_equal_python_tables():
    text = (_build.CSRC / "ctf_step.cu").read_text()
    consts = {
        name: int(value)
        for decl in re.findall(r"constexpr (?:int|unsigned char) ([^;]*);", text)
        for name, value in re.findall(r"(k\w+) = (-?\d+)", decl)
    }
    kinds = {"kRw": "rw", "kFight": "fight", "kCapture": "capture",
             "kPatrol": "patrol", "kPatrolFight": "patrol_fight"}
    for name, kind in kinds.items():
        assert consts[name] == tctf.POLICY_KINDS.index(kind), name
    actions = {"kStay": tctf.A_STAY, "kLeft": tctf.A_LEFT, "kDown": tctf.A_DOWN,
               "kRight": tctf.A_RIGHT, "kUp": tctf.A_UP}
    for name, value in actions.items():
        assert consts[name] == value, name
    assert consts["kNumActions"] == tctf.NUM_ACTIONS
    assert consts["kMaxAgents"] == tslab.MAX_AGENTS
    assert consts["kMaxCells"] == tslab.MAX_CELLS
    flag_bits = [consts[n] for n in ("kCanEnter", "kBlueOwn", "kRedOwn", "kObstacle")]
    assert tuple(flag_bits) == tslab.CELL_FLAG_BITS
