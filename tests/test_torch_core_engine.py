"""The port's host object model (``core/{object,agent,grid}.py``) and
``MultiGridEnv`` (``adapters/multigrid.py``) on the CPU against the JAX
package's, mirroring ``tests/test_core_engine.py``.

The same custom env (``FourWallsEnv`` with more objects and a second
agent) is subclassed from both packages' ``MultiGridEnv`` and run at the
same seeds.  ``step`` draws its agent order from global ``np.random`` and
``_rand_int`` from the standard library's ``random``, so both global
streams are reseeded before each side runs.
"""

import random

import numpy as np
import pytest
import torch

import gym_multigrid_tpu.core as J
import gym_multigrid_tpu_torch.core as T
from gym_multigrid_tpu.multigrid import MultiGridEnv as JMultiGridEnv
from gym_multigrid_tpu_torch.adapters.multigrid import MultiGridEnv as TMultiGridEnv

torch.set_num_threads(1)

SIDES = [(J, JMultiGridEnv), (T, TMultiGridEnv)]


def four_walls(C, base):
    """A FourWallsEnv of package ``C`` over ``base``: perimeter walls, a
    goal, a ball, a key and an inner wall placed by rejection sampling,
    one agent placed at random with a random direction and one fixed."""

    class FourWallsEnv(base):
        def __init__(self, partial_obs=False, **kw):
            self.collected = 0
            agents = [C.Agent(C.DefaultWorld, index=3, view_size=5),
                      C.Agent(C.DefaultWorld, index=1, view_size=5)]
            super().__init__(agents=agents, grid_size=8, max_steps=50, partial_obs=partial_obs,
                             agent_view_size=5, world=C.DefaultWorld, **kw)

        def _gen_grid(self, width, height):
            self.grid = C.Grid(width, height, self.world)
            self.grid.wall_rect(0, 0, width, height)
            self.put_obj(C.Goal(self.world, index=0), width - 2, height - 2)
            self.put_obj(C.Ball(self.world, index=1), 3, 3)
            self.place_obj(C.Key(self.world, "blue"))
            self.place_obj(C.Wall(self.world))
            self.place_agent(self.agents[0], rand_dir=True)
            self.place_agent(self.agents[1], pos=(1, 1))

        def _handle_pickup(self, i, rewards, fwd_pos, fwd_cell):
            if fwd_cell is not None and fwd_cell.can_pickup() and self.agents[i].carrying is None:
                self.agents[i].carrying = fwd_cell
                self.grid.set(*fwd_pos, None)
                self.collected += 1

    return FourWallsEnv


def _episode(C, base, partial_obs, seed):
    random.seed(seed)
    np.random.seed(seed)
    env = four_walls(C, base)(partial_obs=partial_obs)
    trace = [env.reset(seed=seed)]
    actions = np.random.default_rng(seed).integers(0, len(C.DefaultActions), (30, 2))
    for a in actions:
        trace.append(env.step([int(x) for x in a]))
    return env, trace


def _eq(got, want):
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for g, w in zip(got, want):
            _eq(g, w)
    elif isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _eq(got[k], want[k])
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want


@pytest.mark.parametrize("partial_obs,seed", [(False, 0), (False, 5), (True, 3)])
def test_custom_env_matches_jax_step_for_step(partial_obs, seed):
    """Reset obs, 30 steps of obs, rewards and flags, the agents, the
    ASCII dump and both renders, with both global streams reseeded."""
    (jenv, jtrace), (tenv, ttrace) = (_episode(C, base, partial_obs, seed) for C, base in SIDES)
    _eq(ttrace, jtrace)
    for a, b in zip(tenv.agents, jenv.agents):
        np.testing.assert_array_equal(a.pos, b.pos)
        assert (a.dir, a.carrying is None) == (b.dir, b.carrying is None)
    assert tenv.collected == jenv.collected and tenv.step_count == jenv.step_count
    assert str(tenv) == str(jenv)
    assert tenv.observation_space == jenv.observation_space
    assert tenv.action_space == jenv.action_space
    for kw in ({}, {"highlight": True}, {"tile_size": 8}):
        _eq(tenv.render(**kw), jenv.render(**kw))


def test_custom_env_human_render_runs_headless():
    env = four_walls(T, TMultiGridEnv)(render_mode="human")
    env.reset(seed=0)
    img = env.render()
    assert img.shape == (8 * 32, 8 * 32, 3) and env.window is not None
    env.render(close=True)


def _build_grid(C, w=7, h=6):
    """Every object kind on one grid, doors in all three states, an agent
    carrying a key."""
    W = C.DefaultWorld
    g = C.Grid(w, h, W)
    g.wall_rect(0, 0, w, h)
    g.set(1, 1, C.Ball(W, 1))
    g.set(2, 1, C.Door(W, "blue", is_locked=True))
    g.set(3, 1, C.Door(W, "red", is_open=True))
    g.set(4, 1, C.Door(W, "green"))
    g.set(5, 1, C.Key(W, "yellow"))
    g.set(1, 2, C.Box(W, "purple", contains=C.Ball(W, 2)))
    g.set(2, 2, C.Goal(W, index=0))
    g.set(3, 2, C.Floor(W, "blue"))
    g.set(4, 2, C.Lava(W))
    g.set(5, 2, C.ObjectGoal(W, index=4))
    g.set(1, 3, C.Switch(W))
    a = C.Agent(W, index=2)
    a.dir, a.pos, a.carrying = 1, np.array([3, 3]), C.Key(W, "blue")
    g.set(3, 3, a)
    b = C.Agent(W, index=5)
    b.dir, b.pos = 2, np.array([4, 4])
    g.set(4, 4, b)
    return g


def test_grid_encode_and_render_equal_jax():
    tg, jg = _build_grid(T), _build_grid(J)
    _eq(tg.encode(), jg.encode())
    for pos in ((3, 3), (4, 4), (1, 1)):
        _eq(tg.encode_for_agents(pos), jg.encode_for_agents(pos))
    mask = np.random.default_rng(0).random((7, 6)) < 0.6
    _eq(tg.encode(vis_mask=mask), jg.encode(vis_mask=mask))
    _eq(tg.rotate_left().encode(), jg.rotate_left().encode())
    _eq(tg.slice(-2, 1, 5, 5).encode(), jg.slice(-2, 1, 5, 5).encode())
    highlights = {(i, j): [k for k in range((i + j) % 3)] for i in range(7) for j in range(6)}
    for kw in ({}, {"highlight_masks": highlights}, {"uncached_object_types": ["agent"]}):
        _eq(tg.render(16, **kw), jg.render(16, **kw))
    assert (("blue", "door") in tg) == (("blue", "door") in jg)
    assert tg == tg.copy() and tg != T.Grid(7, 6, T.DefaultWorld)


def test_process_vis_equals_jax_on_random_walls():
    rng = np.random.default_rng(0)
    for trial in range(25):
        w, h = int(rng.integers(3, 9)), int(rng.integers(3, 9))
        walls = [(int(rng.integers(0, w)), int(rng.integers(0, h)))
                 for _ in range(int(rng.integers(0, w * h // 2)))]
        pos = (int(rng.integers(0, w)), int(rng.integers(0, h)))
        masks = []
        for C in (T, J):
            g = C.Grid(w, h, C.DefaultWorld)
            for i, j in walls:
                g.set(i, j, C.Wall(C.DefaultWorld))
            masks.append((g.process_vis(pos), g.encode()))
        _eq(masks[0], masks[1])


def test_behavior_tables_equal_jax():
    for name in ("DefaultWorld", "CollectWorld", "CtfWorld", "MazeWorld", "WildfireWorld"):
        for penalty in (0.0, 0.5):
            _eq(T.behavior_tables(getattr(T, name), penalty),
                J.behavior_tables(getattr(J, name), penalty))


def test_object_semantics_and_agent_geometry_equal_jax():
    def probe(C):
        W = C.DefaultWorld
        out = []
        for obj in (C.Door(W, "blue", is_locked=True), C.Door(W, "red"), C.Ball(W, 3),
                    C.Key(W), C.Box(W, "green"), C.Wall(W), C.Floor(W), C.Goal(W, 1),
                    C.Obstacle(C.MazeWorld, penalty=1.0),
                    C.Obstacle(C.CtfWorld, can_see_through=False),
                    C.Flag(C.MazeWorld, 0, color="red", bg_color="white")):
            out.append((obj.type, obj.color, obj.can_overlap(), obj.can_pickup(),
                        obj.can_contain(), obj.see_behind(), obj.encode()))

        class E:
            carrying = C.Key(W, "blue")
            grid = C.Grid(3, 3, W)

        d = C.Door(W, "blue", is_locked=True)
        out.append((d.toggle(E(), (1, 1)), d.is_open, d.encode()))
        a = C.Agent(W, index=4, view_size=5)
        a.pos = np.array([4, 3])
        for a.dir in range(4):
            out.append((tuple(a.dir_vec), tuple(a.right_vec), tuple(a.front_pos),
                        a.get_view_exts(), a.get_view_coords(2, 5), a.relative_coords(5, 2),
                        a.in_view(4, 1), a.encode(), a.encode(current_agent=True)))
        g = C.Grid(6, 6, W)
        a.move(np.array([4, 2]), g)
        out.append((a.dir, tuple(a.pos), tuple(a.north_pos()), tuple(a.west_pos())))
        return out

    _eq(probe(T), probe(J))
