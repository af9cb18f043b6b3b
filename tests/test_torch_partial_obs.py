"""The port's partial observations (``envs/partial_obs.py``, the four
``make_*_partial_encode`` and ``partial_obs_view`` on each batch) against
the JAX package's, bit for bit.

``make_partial_obs_fn`` is compared with JAX's under ``vmap``, eagerly, on
random planes and sight masks in all four directions, and on the
occlusion board of ``tests/test_partial_obs.py`` against JAX's and the
host ``gen_obs`` pipeline.  Each family's encode is compared on states
carried across from a JAX reset and a few JAX steps, JAX's side jitted
(integer ops only: jitted and eager agree).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_multigrid_tpu.core.agent import Agent
from gym_multigrid_tpu.core.grid import Grid
from gym_multigrid_tpu.core.object import Ball, Wall
from gym_multigrid_tpu.core.world import CollectWorld
from gym_multigrid_tpu.envs import collect as jcollect
from gym_multigrid_tpu.envs import ctf as jctf
from gym_multigrid_tpu.envs import maze as jmaze
from gym_multigrid_tpu.envs import wildfire as jwf
from gym_multigrid_tpu.envs.partial_obs import make_partial_obs_fn as jax_obs_fn
from gym_multigrid_tpu_torch.envs import collect as tcollect
from gym_multigrid_tpu_torch.envs import ctf as tctf
from gym_multigrid_tpu_torch.envs import maze as tmaze
from gym_multigrid_tpu_torch.envs import wildfire as twf
from gym_multigrid_tpu_torch.envs.partial_obs import make_partial_obs_fn, rotation_maps
from gym_multigrid_tpu_torch.parallel import vector as tv

torch.set_num_threads(1)

ASSETS = os.path.join(os.path.dirname(__file__), "assets")


def test_rotation_maps_are_rotate_left():
    """d + 1 applications of JAX's ``m[::-1, :].T``, as index maps."""
    V = 5
    m = np.arange(V * V).reshape(V, V)
    r = m
    for d, (si, sj) in enumerate(rotation_maps(V)):
        r = r[::-1, :].T
        np.testing.assert_array_equal(m[si, sj], r, err_msg=f"dir {d}")


@pytest.mark.parametrize("see_through", [False, True])
@pytest.mark.parametrize("V", [3, 5, 7])
def test_partial_obs_fn_matches_jax(V, see_through):
    """Random (type, color, state) planes and sight masks on a 9x8 board,
    agents anywhere on it (so views run off every edge), every direction."""
    rng = np.random.default_rng(V + 10 * see_through)
    W, H, N = 9, 8, 96
    planes = rng.integers(0, 11, (N, 3, W, H)).astype(np.int32)
    opaque = rng.random((N, W, H)) < 0.3
    pos = np.stack([rng.integers(0, W, N), rng.integers(0, H, N)], 1).astype(np.int32)
    dirs = (np.arange(N) % 4).astype(np.int32)
    wall = (1, 5, 0)
    want = jax.vmap(jax_obs_fn(W, H, V, wall, see_through_walls=see_through))(
        jnp.asarray(planes), jnp.asarray(opaque), jnp.asarray(pos), jnp.asarray(dirs))
    got = make_partial_obs_fn(W, H, V, wall, see_through_walls=see_through)(
        torch.tensor(planes), torch.tensor(opaque), torch.tensor(pos), torch.tensor(dirs))
    assert got.dtype == torch.uint8 and got.shape == (N, V, V, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if not see_through:  # the shadow cast hid something
        assert (got.numpy() == 0).all(-1).any()


def _host_obs(grid, agent):
    """The host ``gen_obs`` pipeline for one agent (tests/test_partial_obs.py)."""
    topX, topY, _, _ = agent.get_view_exts()
    g = grid.slice(topX, topY, agent.view_size, agent.view_size)
    for _ in range(agent.dir + 1):
        g = g.rotate_left()
    vis = g.process_vis(agent_pos=(agent.view_size // 2, agent.view_size - 1))
    return g.encode_for_agents([g.width // 2, g.height - 1], vis)


def test_occlusion_board_matches_jax_and_host():
    """The 9x9 board with interior walls of tests/test_partial_obs.py:90-131,
    all four facings: occluded corners and the east/west spill."""
    V, w, h = 7, 9, 9
    grid = Grid(w, h, CollectWorld)
    grid.wall_rect(0, 0, w, h)
    for x, y in [(3, 3), (4, 3), (5, 5), (2, 6), (6, 2), (4, 6)]:
        grid.set(x, y, Wall(CollectWorld))
    grid.set(2, 2, Ball(CollectWorld, index=0))
    grid.set(6, 6, Ball(CollectWorld, index=2))
    obj = np.zeros((w, h), np.int32)
    col = np.zeros((w, h), np.int32)
    for x in range(w):
        for y in range(h):
            c = grid.get(x, y)
            if c is not None:
                obj[x, y] = CollectWorld.OBJECT_TO_IDX[c.type]
                col[x, y] = CollectWorld.COLOR_TO_IDX[c.color]
    a = Agent(CollectWorld, index=1, view_size=V)
    a.pos = (4, 4)
    obj[4, 4] = jcollect.AGENT
    col[4, 4] = CollectWorld.COLOR_TO_IDX[a.color]
    grid.set(4, 4, a)
    wall = (jcollect.WALL, jcollect.WALL_COLOR, 0)
    jfn = jax.jit(jax_obs_fn(w, h, V, wall))
    tfn = make_partial_obs_fn(w, h, V, wall)
    for d in range(4):
        a.dir = d
        planes = np.stack([obj, col, np.where(obj == jcollect.AGENT, d, 0)])
        want = np.asarray(jfn(jnp.asarray(planes), jnp.asarray(obj == jcollect.WALL),
                              jnp.asarray(a.pos), jnp.int32(d)))
        got = tfn(torch.tensor(planes)[None], torch.tensor(obj == jcollect.WALL)[None],
                  torch.tensor([a.pos]), torch.tensor([d]))[0].numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"dir {d}")
        np.testing.assert_array_equal(got, _host_obs(grid.copy(), a), err_msg=f"dir {d}")


def _np_state(js):
    return {k: np.asarray(v) for k, v in vars(js).items()}


def _jax_states(reset_fn, step_fn, n, n_act, act_shape, steps, seed=0):
    """n JAX states after a reset and ``steps`` steps of random actions."""
    states = jax.jit(jax.vmap(reset_fn))(jax.random.split(jax.random.PRNGKey(seed), n))
    step = jax.jit(jax.vmap(step_fn))
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        acts = jnp.asarray(rng.integers(0, n_act, (n, *act_shape)).astype(np.int32))
        states = step(states, acts)[0]
    return states


def _ctf_cfgs(**kw):
    pols = ("fight", "rw")
    return tuple(
        m.CtfConfig.from_map_path(os.path.join(ASSETS, "board.txt"), num_blue_agents=2,
                                  num_red_agents=2, obstacle_penalty_ratio=0.5,
                                  enemy_policies=tuple(m.PolicySpec(p) for p in pols), **kw)
        for m in (jctf, tctf))


@functools.cache
def _family_case(family):
    """(JAX states, port states, JAX encode, port encode) for ``family``."""
    if family == "collect":
        kw = dict(layout="quadrants_respawn", respawn=True, max_steps=50)
        jcfg, tcfg = jcollect.CollectConfig(**kw), tcollect.CollectConfig(**kw)
        reset_fn, step_fn, _ = jcollect.make_collect(jcfg)
        js = _jax_states(reset_fn, step_fn, 16, 4, (2,), 5)
        return (js, tcollect.state_from_numpy(_np_state(js), "cpu"),
                jcollect.make_collect_partial_encode(jcfg, 7),
                tcollect.make_collect_partial_encode(tcfg, 7))
    if family == "ctf":
        jcfg, tcfg = _ctf_cfgs()
        fns = jctf.make_ctf(jcfg)
        js = _jax_states(fns.reset_fn, fns.step_fn, 16, 5, (2,), 6)
        return (js, tctf.ctf_state_from_numpy(_np_state(js), "cpu"),
                jctf.make_ctf_partial_encode(jcfg, 5), tctf.make_ctf_partial_encode(tcfg, 5))
    if family == "maze":
        path = os.path.join(ASSETS, "board_maze.txt")
        jcfg, tcfg = jmaze.MazeConfig.from_map_path(path), tmaze.MazeConfig.from_map_path(path)
        fns = jmaze.make_maze(jcfg)
        js = _jax_states(fns.reset_fn, lambda s, a: fns.step_fn(s, a.reshape(())), 16, 5,
                         (), 6)
        return (js, tmaze.maze_state_from_numpy(_np_state(js), "cpu"),
                jmaze.make_maze_partial_encode(jcfg, 7, see_through_walls=False),
                tmaze.make_maze_partial_encode(tcfg, 7, see_through_walls=False))
    jcfg, tcfg = jwf.WildfireConfig(size=10), twf.WildfireConfig(size=10)
    fns = jwf.make_wildfire(jcfg)
    js = _jax_states(fns.reset_fn, fns.step_fn, 16, 5, (2,), 4)
    return (js, twf.wildfire_state_from_numpy(_np_state(js), "cpu"),
            jwf.make_wildfire_partial_encode(jcfg, 7), twf.make_wildfire_partial_encode(tcfg, 7))


@pytest.mark.parametrize("family", ["collect", "ctf", "maze", "wildfire"])
def test_partial_encode_matches_jax(family):
    """Each family's encode on states carried across from JAX (the CtF
    ones with agents defeated by battles and collisions)."""
    js, ts, jenc, tenc = _family_case(family)
    want = np.asarray(jax.jit(jax.vmap(jenc))(js))
    got = tenc(ts)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    if family == "ctf":
        assert ts.terminated.any()  # greyed agents are drawn


def test_ctf_partial_encode_default_and_see_through():
    """CtF's default is no see-through (the edge blocks sight), and the
    see-through variant matches JAX's too."""
    jcfg, tcfg = _ctf_cfgs()
    js, ts, _, _ = _family_case("ctf")
    for kw in ({}, {"see_through_walls": True}):
        want = np.asarray(jax.jit(jax.vmap(jctf.make_ctf_partial_encode(jcfg, 7, **kw)))(js))
        np.testing.assert_array_equal(tctf.make_ctf_partial_encode(tcfg, 7, **kw)(ts).numpy(),
                                      want)


def _batches(V):
    ctf_cfg = _ctf_cfgs(observation_option="flattened")[1]
    return {
        "collect": (tv.make_collect_batch(tcollect.CollectConfig(), 8, "cpu",
                                          partial_obs_view=V), 2),
        "ctf": (tv.make_ctf_batch(ctf_cfg, 8, "cpu", partial_obs_view=V), 4),
        "maze": (tv.make_maze_batch(tmaze.MazeConfig.from_map_path(
            os.path.join(ASSETS, "board_maze.txt")), 8, "cpu", partial_obs_view=V), 1),
        "wildfire": (tv.make_wildfire_batch(twf.WildfireConfig(size=8), 8, "cpu",
                                            partial_obs_view=V), 2),
    }


@pytest.mark.parametrize("family", ["collect", "ctf", "maze", "wildfire"])
def test_partial_obs_view_batches(family):
    """``partial_obs_view=V``: reset and step return (B, agents, V, V, 3)
    uint8, the step's obs taken from the post-step, pre-reset states; each
    agent sees itself at the bottom centre of its view."""
    V = 5
    env, agents = _batches(V)[family]
    states, obs = env.reset(0)
    assert obs.dtype == torch.uint8 and obs.shape == (8, agents, V, V, 3)
    gen = torch.Generator().manual_seed(1)
    for _ in range(3):
        acts = torch.randint(0, env.num_actions, env.actions_shape, generator=gen,
                             dtype=torch.int32)
        states, obs, *_ = env.step(states, acts)
        assert obs.dtype == torch.uint8 and obs.shape == (8, agents, V, V, 3)
    agent_type = {"collect": tcollect.AGENT, "maze": tmaze.M_AGENT, "wildfire": twf.W_AGENT}
    me = obs[:, :, V // 2, V - 1, 0]
    if family == "ctf":
        assert ((me == tctf.BLUE_AGENT) | (me == tctf.RED_AGENT)).all()
    else:
        assert (me == agent_type[family]).all()
    # without the option the configured observation comes back
    full = tv.make_collect_batch(tcollect.CollectConfig(), 8, "cpu")
    assert full.reset(0)[1].shape == (8, 10, 10, 3)


def test_partial_obs_step_obs_is_pre_reset():
    """The step's FOV obs is that of the finished states, not of the reset
    ones: with max_steps=1 every env resets every step."""
    cfg = tcollect.CollectConfig(max_steps=1)
    env = tv.make_collect_batch(cfg, 8, "cpu", partial_obs_view=5)
    held = tv.make_collect_batch(cfg, 8, "cpu", partial_obs_view=5, auto_reset=False)
    states, _ = env.reset(0)
    states2, _ = held.reset(0)
    acts = torch.ones((8, 2), dtype=torch.int32)
    _, obs, _, _, trunc = env.step(states, acts)
    after, obs2, *_ = held.step(states2, acts)
    assert trunc.all()
    assert torch.equal(obs, obs2)
    assert torch.equal(obs2, tcollect.make_collect_partial_encode(cfg, 5)(after))
