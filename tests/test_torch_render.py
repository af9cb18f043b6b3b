"""The port's sprite-bank renderer (``gym_multigrid_tpu_torch/render/tiles.py``)
and the constants and raster primitives it shares with the host object
model, on the CPU against the JAX package.

Banks byte for byte at T = 32 and 8; frames pixel for pixel against JAX's
host numpy renderers (``render_<family>``) on the port's own states after
a reset and a few steps of its CPU batch, and on hand-built CtF and
Wildfire states with stacked and terminated agents; every row of each
``render_<family>_batch`` against the port's per-env frame.
"""

import dataclasses
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import gym_multigrid_tpu.core.constants as jconst
import gym_multigrid_tpu.core.world as jworld
import gym_multigrid_tpu.utils.rendering as jr
from gym_multigrid_tpu.envs import collect as jcollect
from gym_multigrid_tpu.envs import ctf as jctf
from gym_multigrid_tpu.envs import maze as jmaze
from gym_multigrid_tpu.envs import wildfire as jwf
from gym_multigrid_tpu.render import tiles as jt
import gym_multigrid_tpu_torch.core.constants as tconst
import gym_multigrid_tpu_torch.core.world as tworld
import gym_multigrid_tpu_torch.utils.rendering as tr
from gym_multigrid_tpu_torch.envs import collect as tcollect
from gym_multigrid_tpu_torch.envs import ctf as tctf
from gym_multigrid_tpu_torch.envs import maze as tmaze
from gym_multigrid_tpu_torch.envs import wildfire as twf
from gym_multigrid_tpu_torch.parallel import vector
from gym_multigrid_tpu_torch.render import tiles as tt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAP = os.path.join(ROOT, "tests", "assets", "board.txt")
MAZE_MAP = os.path.join(ROOT, "tests", "assets", "board_maze.txt")
B = 4
FAMILIES = ["collect", "ctf", "maze", "wildfire"]


def _configs(family):
    """(port config, JAX config) built from the same arguments."""
    if family == "collect":
        kw = dict(layout="quadrants", max_steps=20)
        return tcollect.CollectConfig(**kw), jcollect.CollectConfig(**kw)
    if family == "ctf":
        kw = dict(num_blue_agents=2, num_red_agents=2, variant="mvn",
                  observation_option="flattened", max_steps=20)
        return (tctf.CtfConfig.from_map_path(
                    MAP, enemy_policies=(tctf.PolicySpec("rw"), tctf.PolicySpec("fight")), **kw),
                jctf.CtfConfig.from_map_path(
                    MAP, enemy_policies=(jctf.PolicySpec("rw"), jctf.PolicySpec("fight")), **kw))
    if family == "maze":
        return (tmaze.MazeConfig.from_map_path(MAZE_MAP, max_steps=20),
                jmaze.MazeConfig.from_map_path(MAZE_MAP, max_steps=20))
    kw = dict(size=8, max_steps=20, num_agents=3, agents_index=(4, 5, 1))
    return twf.WildfireConfig(**kw), jwf.WildfireConfig(**kw)


def _numpy_row(states, i):
    """Row ``i`` of a port batch state as numpy fields, what JAX's host
    renderers read (``np.asarray`` of each field)."""
    return types.SimpleNamespace(**{f.name: getattr(states, f.name)[i].numpy()
                                    for f in dataclasses.fields(states)})


def _stepped_states(family, cfg, seed=0, steps=5):
    env = getattr(vector, f"make_{family}_batch")(cfg, B, device="cpu")
    states, _ = env.reset(seed)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        acts = torch.randint(0, env.num_actions, env.actions_shape, generator=gen,
                             dtype=torch.int32)
        states, *_ = env.step(states, acts)
    return states


def test_constants_and_default_world_equal_jax():
    for name in ("TILE_PIXELS", "COLOR_NAMES", "IDX_TO_COLOR", "COLOR_TO_IDX", "STATE_TO_IDX",
                 "OBJECT_TO_STR", "OPENED_DOOR_IDS", "AGENT_DIR_TO_STR"):
        assert getattr(tconst, name) == getattr(jconst, name), name
    for table in ("COLORS", "CTF_COLORS", "MAZE_COLORS"):
        t, j = getattr(tconst, table), getattr(jconst, table)
        assert list(t) == list(j)
        got, want = tconst.color_matrix(t), jconst.color_matrix(j)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    for name in ("DefaultWorld", "CollectWorld", "CtfWorld", "MazeWorld", "WildfireWorld"):
        t, j = getattr(tworld, name), getattr(jworld, name)
        assert (t.encode_dim, t.normalize_obs, t.OBJECT_TO_IDX, t.COLOR_TO_IDX, t.IDX_TO_COLOR) \
            == (j.encode_dim, j.normalize_obs, j.OBJECT_TO_IDX, j.COLOR_TO_IDX, j.IDX_TO_COLOR)


@pytest.mark.parametrize("tile_size", [32, 8])
@pytest.mark.parametrize("family", FAMILIES)
def test_banks_are_byte_equal_to_jax(family, tile_size):
    got = getattr(tt, f"_{family}_bank")(tile_size)
    want = getattr(jt, f"_{family}_bank")(tile_size)
    assert got.dtype == want.dtype == np.uint8
    assert got.shape == want.shape and np.array_equal(got, want)
    dev = tt._device_bank(getattr(tt, f"_{family}_bank"), tile_size, torch.device("cpu"))
    assert dev.dtype == torch.uint8
    assert np.array_equal(dev.numpy().reshape(want.shape), want)


def test_rendering_primitives_equal_jax():
    rng = np.random.default_rng(0)
    xs, ys = rng.random(200), rng.random(200)
    preds = [
        ("point_in_rect", (0.1, 0.7, 0.2, 0.9)),
        ("point_in_circle", (0.5, 0.4, 0.3)),
        ("point_in_line", (0.1, 0.3, 0.8, 0.6, 0.05)),
        ("point_in_triangle", ((0.12, 0.19), (0.87, 0.50), (0.12, 0.81))),
    ]
    for name, args in preds:
        t, j = getattr(tr, name)(*args), getattr(jr, name)(*args)
        assert np.array_equal(t(xs, ys), j(xs, ys)), name
        for theta in (0.5 * np.pi, np.pi, 1.3):
            assert np.array_equal(tr.rotate_fn(t, 0.5, 0.5, theta)(xs, ys),
                                  jr.rotate_fn(j, 0.5, 0.5, theta)(xs, ys)), (name, theta)
    imgs = []
    for mod in (tr, jr):
        img = np.zeros((48, 48, 3), dtype=np.uint8)
        mod.fill_coords(img, mod.point_in_rect(0, 1, 0, 1), (10, 20, 30))
        mod.fill_coords(img, mod.point_in_circle(0.5, 0.5, 0.3), (255, 0, 0), bg_color=(1, 2, 3))
        mod.fill_coords(img, lambda x, y: bool(x < 0.25), (5, 5, 5))  # scalar-only predicate
        mod.highlight_img(img, color=(0, 77, 255))
        imgs.append((img, mod.downsample(img.astype(np.float64), 3)))
    (ti, td), (ji, jd) = imgs
    assert np.array_equal(ti, ji) and td.dtype == jd.dtype and np.array_equal(td, jd)


def test_assemble_takes_numpy_and_torch_alike():
    bank = jt._maze_bank(8)
    ids = np.random.default_rng(1).integers(0, len(bank), (5, 7))
    want = jt.assemble(bank, ids)
    assert np.array_equal(tt.assemble(bank, ids), want)
    assert np.array_equal(tt.assemble(torch.from_numpy(bank), torch.from_numpy(ids)).numpy(), want)


@pytest.mark.parametrize("family", FAMILIES)
def test_frames_are_pixel_equal_to_jax(family):
    """Each env of the port's CPU batch after a reset and 5 steps: the
    per-env frame equals JAX's ``render_<family>`` on the same state in
    numpy, and every row of the batch render equals the per-env frame."""
    cfg, jcfg = _configs(family)
    states = _stepped_states(family, cfg)
    frames = getattr(tt, f"render_{family}_batch")(cfg, states)
    h, w = jcfg.field_map.shape[::-1] if family in ("ctf", "maze") else (cfg.height, cfg.width)
    assert frames.shape == (B, h * 32, w * 32, 3) and frames.dtype == torch.uint8
    for i in range(B):
        one = _numpy_row(states, i)
        want = getattr(jt, f"render_{family}")(jcfg, one)
        got = getattr(tt, f"render_{family}")(cfg, one)
        assert isinstance(got, np.ndarray) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(frames[i].numpy(), got)
        # A batch of one renders the same frame as a state with no batch axis.
        one_batch = type(states)(**{f.name: getattr(states, f.name)[i:i + 1]
                                    for f in dataclasses.fields(states)})
        np.testing.assert_array_equal(getattr(tt, f"render_{family}")(cfg, one_batch), got)


def test_small_tiles_are_pixel_equal_to_jax():
    cfg, jcfg = _configs("collect")
    states = _stepped_states("collect", cfg, seed=3)
    frames = tt.render_collect_batch(cfg, states, tile_size=8)
    for i in range(B):
        np.testing.assert_array_equal(frames[i].numpy(),
                                      jt.render_collect(jcfg, _numpy_row(states, i), tile_size=8))


def test_ctf_stacked_and_terminated_agents_equal_jax():
    """Hand-built CtF states: agents stacked on one cell (the last one
    wins), terminated agents in grey, every direction, agents on both
    territories and on a flag."""
    cfg, jcfg = _configs("ctf")
    t = jctf.build_tables(jcfg)
    bf, rf = t.blue_flag, t.red_flag
    pos = np.array([
        [[2, 3], [2, 3], [2, 3], [7, 7]],  # three stacked, red last
        [bf, rf, rf, [5, 5]],  # red agents stacked on the red flag
        [[0, 0], [9, 9], [4, 6], [0, 0]],  # blue 0 under red 1
        [[1, 8], [8, 1], [3, 3], [6, 2]],
    ], dtype=np.int32)
    dirs = np.array([[0, 1, 2, 3], [3, 2, 1, 0], [1, 1, 5, 7], [2, 0, 3, 1]], dtype=np.int32)
    term = np.array([[True, False, True, False], [False, True, False, True],
                     [True, True, False, False], [False, False, False, False]])
    states = tctf.CtfState(pos=torch.from_numpy(pos), dir=torch.from_numpy(dirs),
                           terminated=torch.from_numpy(term),
                           collided=torch.zeros((4, 4), dtype=torch.bool),
                           step_count=torch.zeros(4, dtype=torch.int32))
    frames = tt.render_ctf_batch(cfg, states)
    for i in range(4):
        want = jt.render_ctf(jcfg, _numpy_row(states, i))
        np.testing.assert_array_equal(frames[i].numpy(), want)
        np.testing.assert_array_equal(tt.render_ctf(cfg, _numpy_row(states, i)), want)


def test_wildfire_stacked_agents_equal_jax():
    """Hand-built Wildfire boards with every cell kind and agents stacked
    (the last agent on a cell wins)."""
    cfg, jcfg = _configs("wildfire")
    rng = np.random.default_rng(7)
    cells = rng.integers(0, 4, (4, 8, 8)).astype(np.int32)
    pos = np.array([[[1, 2], [1, 2], [1, 2]], [[0, 0], [7, 7], [0, 0]],
                    [[3, 5], [5, 3], [5, 3]], [[6, 1], [2, 4], [7, 0]]], dtype=np.int32)
    states = twf.WildfireState(cells=torch.from_numpy(cells), agent_pos=torch.from_numpy(pos),
                               step_count=torch.zeros(4, dtype=torch.int32),
                               extinguished=torch.zeros(4, dtype=torch.int32))
    frames = tt.render_wildfire_batch(cfg, states)
    for i in range(4):
        want = jt.render_wildfire(jcfg, _numpy_row(states, i))
        np.testing.assert_array_equal(frames[i].numpy(), want)


def test_render_modules_import_no_gui_or_gym_packages():
    """Rendering, the toroidal obs, the object model and ``utils.misc``
    import without gymnasium, matplotlib or imageio (the card's machine
    has none of them)."""
    code = """
import sys
import gym_multigrid_tpu_torch.render.tiles, gym_multigrid_tpu_torch.render
import gym_multigrid_tpu_torch.wrappers.toroid, gym_multigrid_tpu_torch.wrappers
import gym_multigrid_tpu_torch.core, gym_multigrid_tpu_torch.utils.misc, gym_multigrid_tpu_torch.utils
import gym_multigrid_tpu_torch.scripts.evaluate, gym_multigrid_tpu_torch.scripts.league_matrix
print(sorted(m for m in sys.modules if m.split(".")[0] in ("gymnasium", "matplotlib", "imageio")))
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120, check=True).stdout
    assert out.strip() == "[]", out
