"""The port's Maze tables, step, spawn draw and batch glue against the JAX
package, bit for bit.

Inputs are made with numpy from a fixed seed and handed to both sides.
JAX runs its eager (un-jitted) bodies ``maze_step_math`` and
``maze_reset_math`` and batch glue ``make_maze_step_batch``, so every
comparison with them is exact, rewards and info distances included.  The
Pallas step runs in interpret mode, as tests/test_pallas_maze.py runs it;
that is a compiled XLA program, so there the float reward may differ by at
most 1 ulp (XLA may contract a multiply and a subtract into one FMA), and
everything else is exact.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_multigrid_tpu.core import constants as jconst
from gym_multigrid_tpu.core import world as jworld
from gym_multigrid_tpu.envs import maze as jmaze
from gym_multigrid_tpu.ops import pallas_maze as jpm
from gym_multigrid_tpu_torch.core import constants as tconst
from gym_multigrid_tpu_torch.core import world as tworld
from gym_multigrid_tpu_torch.envs import maze as tmaze
from gym_multigrid_tpu_torch.ops import _build
from gym_multigrid_tpu_torch.ops import maze_slab as tslab

torch.set_num_threads(1)

MAZE = "tests/assets/board_maze.txt"


def open_map():
    """7 x 5 of background with one flag and no obstacle."""
    fm = np.zeros((7, 5), dtype=int)
    fm[6, 4] = jmaze.FLAG
    return tuple(tuple(int(v) for v in row) for row in fm)


CONFIGS = {
    # the config the family bench drives
    "main": dict(),
    "obstacle_penalty": dict(obstacle_penalty_ratio=0.5),
    "rewards": dict(flag_reward=0.7, obstacle_penalty_ratio=0.3, step_penalty_ratio=0.03),
    "open_non_square": dict(board=None, observation_option="positional"),
}


def cfg_pair(name, **over):
    """The named config in both packages."""
    kw = {**CONFIGS[name], **over}
    board = kw.pop("board", MAZE)
    if board is None:
        return jmaze.MazeConfig(map_data=open_map(), **kw), tmaze.MazeConfig(map_data=open_map(), **kw)
    return jmaze.MazeConfig.from_map_path(board, **kw), tmaze.MazeConfig.from_map_path(board, **kw)


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def test_maze_colour_and_world_tables_equal_jax():
    assert list(tconst.MAZE_COLORS) == list(jconst.MAZE_COLORS)
    for name, rgb in jconst.MAZE_COLORS.items():
        np.testing.assert_array_equal(tconst.MAZE_COLORS[name], rgb)
    tw, jw = tworld.MazeWorld, jworld.MazeWorld
    assert tw.OBJECT_TO_IDX == jw.OBJECT_TO_IDX
    assert tw.IDX_TO_OBJECT == jw.IDX_TO_OBJECT
    assert tw.COLOR_TO_IDX == jw.COLOR_TO_IDX
    assert (tw.encode_dim, tw.normalize_obs) == (jw.encode_dim, jw.normalize_obs)
    for name in ("BACKGROUND", "M_AGENT", "FLAG", "M_OBSTACLE", "NUM_ACTIONS"):
        assert getattr(tmaze, name) == getattr(jmaze, name), name


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tables_and_static_inputs_equal_jax(name):
    jcfg, tcfg = cfg_pair(name)
    assert tcfg.map_data == jcfg.map_data
    _eq(tcfg.field_map, jcfg.field_map)
    for attr in ("obstacle_penalty", "step_penalty"):
        assert getattr(tcfg, attr) == getattr(jcfg, attr), attr
    assert tuple(tslab.maze_tables(tcfg)) == tuple(jmaze.maze_tables(jcfg))
    for got, want in zip(tslab.maze_static_inputs(tcfg), jmaze.maze_static_inputs(jcfg)):
        _eq(got, want)


@pytest.mark.parametrize("kw", [dict(observation_option="pixels"), dict(max_steps=0)])
def test_config_checks_match_jax(kw):
    with pytest.raises(ValueError) as want:
        jmaze.MazeConfig.from_map_path(MAZE, **kw)
    with pytest.raises(ValueError) as got:
        tmaze.MazeConfig.from_map_path(MAZE, **kw)
    assert str(got.value) == str(want.value)


def _start(rng, t, n, flag):
    """(pos (n, 2), dirs (n, 1)) int32: random cells anywhere on the board,
    obstacles included; every fourth row starts next to the flag."""
    pos = np.stack([rng.integers(0, t.s0, n), rng.integers(0, t.s1, n)], axis=1)
    pos[::4] = (flag[0], flag[1] - 1 if flag[1] > 0 else flag[1] + 1)
    return pos.astype(np.int32), rng.integers(0, 4, (n, 1)).astype(np.int32)


def _actions(rng, n):
    """Ids -2..9: outside 0..4 they clip to stay or up."""
    return rng.integers(-2, 10, (n, 1)).astype(np.int32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_step_spec_matches_step_math_over_chained_steps(name):
    jcfg, tcfg = cfg_pair(name)
    jt, tt = jmaze.maze_tables(jcfg), tslab.maze_tables(tcfg)
    jcells, _ = jmaze.maze_static_inputs(jcfg)
    tcells, _ = tslab.maze_static_inputs(tcfg)
    flag = np.argwhere(tcfg.field_map == tmaze.FLAG)[0]
    n, steps = 64, 30
    rng = np.random.default_rng(sorted(CONFIGS).index(name))
    pos, dirs = _start(rng, tt, n, flag)
    flags = obstacles = 0
    for _ in range(steps):
        acts = _actions(rng, n)
        want = [np.asarray(w) for w in jmaze.maze_step_math(
            jt, jnp.asarray(pos), jnp.asarray(dirs), jnp.asarray(acts), jcells)]
        got = tslab.step_spec(tt, *(torch.from_numpy(x) for x in (pos, dirs, acts)), tcells)
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            _eq(g, w)
        at = tcfg.field_map[want[0][:, 0], want[0][:, 1]]
        flags += int((at == tmaze.FLAG).sum())
        obstacles += int((at == tmaze.M_OBSTACLE).sum())
        # Finished envs start again from fresh random cells.
        fresh = _start(rng, tt, n, flag)
        done = want[3][:, 0] == 1
        pos = np.where(done[:, None], fresh[0], want[0])
        dirs = np.where(done[:, None], fresh[1], want[1])
    assert flags > 0
    if tt.obstacle_penalty != 0:
        assert obstacles > 0


@pytest.mark.parametrize("name", ["main", "obstacle_penalty"])
def test_step_spec_matches_pallas_kernel_in_interpret_mode(name):
    """Positions, directions and terminations exact; the reward within 1
    ulp, since the interpret-mode kernel is a compiled XLA program that
    may contract the reward's multiply and subtract."""
    jcfg, tcfg = cfg_pair(name)
    jt, tt = jmaze.maze_tables(jcfg), tslab.maze_tables(tcfg)
    jcells, _ = jmaze.maze_static_inputs(jcfg)
    n = 48
    rng = np.random.default_rng(5)
    pos, dirs = _start(rng, tt, n, np.argwhere(tcfg.field_map == tmaze.FLAG)[0])
    acts = _actions(rng, n)
    want = jpm.maze_step_slab(jt, *(jnp.asarray(x) for x in (pos, dirs, acts)), jcells, True)
    # On CPU tensors the wrapper runs the plain version.
    got = tslab.maze_step_slab(tt, *(torch.from_numpy(x) for x in (pos, dirs, acts)),
                               tslab.maze_static_inputs(tcfg)[0])
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 2:
            assert g.dtype == torch.float32
            np.testing.assert_array_max_ulp(g.numpy(), np.asarray(w), maxulp=1)
        else:
            _eq(g, w)


@pytest.mark.parametrize("name", ["main", "open_non_square"])
def test_reset_spec_matches_reset_math(name):
    jcfg, tcfg = cfg_pair(name)
    jt, tt = jmaze.maze_tables(jcfg), tslab.maze_tables(tcfg)
    n = 64
    rng = np.random.default_rng(3)
    rnd = rng.random((n, 1), dtype=np.float32)
    rnd[0] = np.float32(1.0) - np.finfo(np.float32).epsneg  # largest u below 1
    rnd[1] = 0.0
    want = jmaze.maze_reset_math(jt, jnp.asarray(rnd), jmaze.maze_static_inputs(jcfg)[1])
    got = tslab.reset_spec(tt, torch.from_numpy(rnd), tslab.maze_static_inputs(tcfg)[1])
    for g, w in zip(got, want):
        _eq(g, w)


def _jax_states(jcfg, n, seed):
    fns = jmaze.make_maze(jcfg)
    return jax.vmap(fns.reset_fn)(jax.random.split(jax.random.PRNGKey(seed), n))


def _to_torch(jstates):
    return tmaze.maze_state_from_numpy({k: np.asarray(v) for k, v in vars(jstates).items()}, "cpu")


@pytest.mark.parametrize("name", ["main", "obstacle_penalty", "open_non_square"])
def test_step_batch_matches_jax_step_batch(name):
    """State, obs (map or positional), reward, terminated, truncated and
    both info distances exact against the eager JAX glue."""
    jcfg, tcfg = cfg_pair(name, max_steps=6)
    jstep = jmaze.make_maze_step_batch(jcfg)
    slab = tslab.make_maze_slab(tcfg, "cpu")
    n, steps = 32, 8
    js = _jax_states(jcfg, n, seed=9)
    rng = np.random.default_rng(13)
    truncated = 0
    for _ in range(steps):
        acts = rng.integers(-2, 10, n).astype(np.int32)
        got_states, got_obs, *got_rest, got_info = tslab.step_batch(
            slab, _to_torch(js), torch.from_numpy(acts))
        js, want_obs, *want_rest, want_info = jstep(js, jnp.asarray(acts))
        for field in ("pos", "dir", "step_count"):
            _eq(getattr(got_states, field), getattr(js, field))
        if tcfg.observation_option == "positional":
            assert sorted(got_obs) == sorted(want_obs)
            for key in want_obs:
                _eq(got_obs[key], want_obs[key])
        else:
            _eq(got_obs, want_obs)
        for g, w in zip(got_rest, want_rest):  # reward, terminated, truncated
            _eq(g, w)
        assert sorted(got_info) == sorted(want_info)
        for key in want_info:
            _eq(got_info[key], want_info[key])
        truncated += int(np.asarray(want_rest[2]).sum())
    assert truncated > 0
    if name == "open_non_square":
        assert torch.isinf(got_info["d_a_ob"]).all()


def test_step_batch_can_skip_obs_and_info():
    _, tcfg = cfg_pair("main")
    slab = tslab.make_maze_slab(tcfg, "cpu")
    states = tslab.reset_batch(slab, 8, generator=torch.Generator().manual_seed(0))
    acts = torch.arange(8, dtype=torch.int32) % 5
    full = tslab.step_batch(slab, states, acts)
    bare = tslab.step_batch(slab, states, acts, encode_obs=False, with_info=False)
    assert bare[1] is None and bare[5] is None
    for g, w in zip(bare[2:5], full[2:5]):
        assert torch.equal(g, w)
    assert torch.equal(bare[0].pos, full[0].pos)


def test_wrapper_refuses_other_devices():
    _, tcfg = cfg_pair("main")
    tt = tslab.maze_tables(tcfg)
    meta = torch.zeros((2, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        tslab.maze_step_slab(tt, meta, None, None, None)


def test_kernel_constants_equal_python_tables():
    text = (_build.CSRC / "maze_step.cu").read_text()
    consts = {
        name: int(value)
        for decl in re.findall(r"constexpr int ([^;]*);", text)
        for name, value in re.findall(r"(k\w+) = (-?\d+)", decl)
    }
    assert consts["kNumActions"] == tmaze.NUM_ACTIONS == len(tconst.CTF_ACTION_TO_VEC)
    vec = tconst.CTF_ACTION_TO_VEC
    for name, want in (("kStay", (0, 0)), ("kLeft", (0, -1)), ("kDown", (-1, 0)),
                       ("kRight", (0, 1)), ("kUp", (1, 0))):
        assert tuple(vec[consts[name]]) == want, name
    # rows of maze_static_inputs' cells: can_enter, flag, obstacle
    assert (consts["kCanEnterRow"], consts["kFlagRow"], consts["kObstacleRow"]) == (0, 1, 2)
