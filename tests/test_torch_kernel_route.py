"""The route each slab takes, decided once when it is built from its config
and the device type (``kernel_route`` of each family): the kernels for
configs inside their envelope, the plain versions on the card's tensors for
the rest, as JAX's batch runs them as plain XLA.  Checked without a card:
the rule itself, the slab's field on the CPU and on the "meta" device (off
the CPU, like the card), the glue calling the plain versions and never a
kernel wrapper on the plain route, and the CPU build of each
out-of-envelope config stepping through the batch env, the per-env
functions and the episode rollouts."""

import dataclasses

import numpy as np
import pytest
import torch

from gym_multigrid_tpu_torch.envs.collect import CollectConfig, make_collect
from gym_multigrid_tpu_torch.envs.ctf import CtfConfig, PolicySpec, make_ctf
from gym_multigrid_tpu_torch.envs.maze import BACKGROUND, FLAG, MazeConfig, make_maze
from gym_multigrid_tpu_torch.envs.wildfire import WildfireConfig, make_wildfire, wf_tables
from gym_multigrid_tpu_torch.ops import collect_slab, ctf_slab, maze_slab, wildfire_slab
from gym_multigrid_tpu_torch.parallel.vector import (
    make_collect_batch,
    make_ctf_batch,
    make_maze_batch,
    make_wildfire_batch,
)

torch.set_num_threads(1)

ASSETS = "tests/assets"


def _ctf(board, blue, red, policies, **kw):
    return CtfConfig.from_map_path(f"{ASSETS}/{board}", num_blue_agents=blue, num_red_agents=red,
                                   enemy_policies=tuple(PolicySpec(p) for p in policies), **kw)


def _tiled_maze(cfg, reps):
    """``cfg``'s map as reps x reps copies with one flag."""
    fm = np.tile(cfg.field_map, (reps, reps))
    first = np.zeros(fm.shape, dtype=bool)
    first[:cfg.field_map.shape[0], :cfg.field_map.shape[1]] = True
    fm[(fm == FLAG) & ~first] = BACKGROUND
    return dataclasses.replace(cfg, map_data=tuple(tuple(int(v) for v in row) for row in fm))


# The configs of the fault (ROADMAP queue 3, part 3), each outside its
# family's kernel envelope, and the main configs, inside it.
COLLECT_LARGE = CollectConfig(size=20)
CTF_LARGE = _ctf("board_large.txt", 5, 5, ("rw",) * 5)
WF_LARGE = WildfireConfig(size=40)
MAZE_MAIN = MazeConfig.from_map_path(f"{ASSETS}/board_maze.txt", max_steps=100)
MAZE_LARGE = _tiled_maze(MAZE_MAIN, 6)
COLLECT_MAIN = CollectConfig(layout="quadrants_respawn", respawn=True, max_steps=50)
CTF_MAIN = _ctf("board.txt", 2, 2, ("fight", "rw"), observation_option="flattened")
WF_MAIN = WildfireConfig(size=16, max_steps=100)


def _collect_route(cfg, device_type):
    return collect_slab.kernel_route(cfg, device_type)


def _ctf_route(cfg, device_type):
    _, border, pool = ctf_slab.ctf_static_inputs(cfg)
    return ctf_slab.kernel_route(ctf_slab.make_ctf_ktables(cfg), device_type, border.shape[1],
                                 pool.shape[1])


def _maze_route(cfg, device_type):
    slab = maze_slab.make_maze_slab(cfg, "cpu")
    return maze_slab.kernel_route(slab.t, slab.bg.shape[1], device_type)


def _wf_route(cfg, device_type):
    return wildfire_slab.kernel_route(wf_tables(cfg), device_type)


ROUTES = {
    # name: (route rule, slab builder, config, route on the CPU, off it)
    "collect_main": (_collect_route, collect_slab.make_collect_slab, COLLECT_MAIN, True, True),
    "collect_20x20": (_collect_route, collect_slab.make_collect_slab, COLLECT_LARGE, True, False),
    "collect_three_agents": (_collect_route, collect_slab.make_collect_slab,
                             CollectConfig(agents_index=(3, 5, 1)), False, False),
    "ctf_main": (_ctf_route, ctf_slab.make_ctf_slab, CTF_MAIN, True, True),
    "ctf_5v5": (_ctf_route, ctf_slab.make_ctf_slab, CTF_LARGE, True, False),
    "ctf_4v4_large_board": (_ctf_route, ctf_slab.make_ctf_slab,
                            _ctf("board_large.txt", 4, 4, ("rw",) * 4), True, True),
    "maze_main": (_maze_route, maze_slab.make_maze_slab, MAZE_MAIN, True, True),
    "maze_over_the_table_limit": (_maze_route, maze_slab.make_maze_slab, MAZE_LARGE, True, False),
    "wildfire_main": (_wf_route, wildfire_slab.make_wildfire_slab, WF_MAIN, True, True),
    "wildfire_32x32": (_wf_route, wildfire_slab.make_wildfire_slab, WildfireConfig(size=32),
                       True, True),
    "wildfire_40x40": (_wf_route, wildfire_slab.make_wildfire_slab, WF_LARGE, True, False),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_kernel_route_of_config_and_device_type(name):
    """The rule as a function of (config, device type), and the slab's
    field: equal to the rule on the CPU and off it (the "meta" device,
    which builds without a card)."""
    rule, make, cfg, on_cpu, off_cpu = ROUTES[name]
    assert rule(cfg, "cpu") is on_cpu
    assert rule(cfg, "cuda") is off_cpu
    assert make(cfg, "cpu").kernel is on_cpu
    assert make(cfg, "meta").kernel is off_cpu


def test_the_kernels_still_refuse_what_their_slabs_route_around():
    """The wrappers' own checks stand: the route is chosen from the
    config, not by catching a refusal."""
    with pytest.raises(ValueError, match="at most 256 cells"):
        collect_slab._check_envelope(COLLECT_LARGE.num_cells, COLLECT_LARGE.num_agents)
    with pytest.raises(ValueError, match="2 to 8 agents"):
        ctf_slab.check_envelope(ctf_slab.make_ctf_ktables(CTF_LARGE))
    with pytest.raises(ValueError, match="at most 1024 cells"):
        wildfire_slab.check_envelope(wf_tables(WF_LARGE))
    slab = maze_slab.make_maze_slab(MAZE_LARGE, "cpu")
    assert maze_slab.ms_table_bytes(slab.t, slab.bg.shape[1]) == slab.ms_table.numel() * 4
    assert slab.ms_table.numel() * 4 > maze_slab.MS_MAX_TABLE_BYTES


def _refuse(monkeypatch, module, *names):
    """Make the named kernel wrappers raise if anything calls them."""
    def refuse(*args, **kwargs):
        raise AssertionError("a kernel wrapper was called on the plain route")

    for name in names:
        monkeypatch.setattr(module, name, refuse)


def test_the_plain_route_calls_no_kernel_wrapper(monkeypatch):
    """A slab on the plain route steps, resets and runs its episode chunks
    through the plain versions: here a CPU slab with its route set to the
    plain one, every wrapper replaced by one that raises, equal to the
    kernel route's results (whose wrappers run the same plain versions on
    the CPU)."""
    gen = torch.Generator().manual_seed(0)
    n = 6
    # CtF: step and episode chunk.
    slab = ctf_slab.make_ctf_slab(CTF_MAIN, "cpu")
    plain = dataclasses.replace(slab, kernel=False)
    states = ctf_slab.reset_batch(slab, n, generator=gen)
    acts = torch.randint(0, 5, (n, 2), generator=gen, dtype=torch.int32)
    rnd = torch.rand((n, slab.step_draws), generator=gen)
    want = ctf_slab.step_batch(slab, states, acts, rnd=rnd)
    roll = ctf_slab.make_ctf_episode_rollout(CTF_MAIN, n, device="cpu", chunk=5)
    roll_plain = dataclasses.replace(roll, slab=plain, generator=torch.Generator())
    s0, _ = roll.reset(3)
    roll_plain.reset(3)
    want_roll = roll(s0, 12)
    _refuse(monkeypatch, ctf_slab, "ctf_step_slab", "ctf_ms_slab")
    got = ctf_slab.step_batch(plain, states, acts, rnd=rnd)
    assert all(torch.equal(g, w) for g, w in zip(got[2:5], want[2:5]))
    got_roll = roll_plain(s0, 12)
    assert torch.equal(got_roll[0].pos, want_roll[0].pos)
    # Wildfire: step and episode chunk (the in-kernel-draws entry's plain
    # version).
    slab = wildfire_slab.make_wildfire_slab(WF_MAIN, "cpu")
    plain = dataclasses.replace(slab, kernel=False)
    states = wildfire_slab.reset_batch(slab, n, generator=gen)
    acts = torch.randint(0, 5, (n, 2), generator=gen, dtype=torch.int32)
    rnd = torch.rand((n, slab.step_draws), generator=gen)
    want = wildfire_slab.step_batch(slab, states, acts, rnd=rnd)
    roll = wildfire_slab.make_wildfire_episode_rollout(WF_MAIN, n, device="cpu", chunk=5)
    s0, _ = roll.reset(4)
    want_roll = roll(s0, 12)
    _refuse(monkeypatch, wildfire_slab, "wildfire_step_slab", "wf_philox_slab")
    got = wildfire_slab.step_batch(plain, states, acts, rnd=rnd)
    assert torch.equal(got[0].cells, want[0].cells) and torch.equal(got[2], want[2])
    roll_plain = dataclasses.replace(roll, slab=plain)
    s1, _ = roll_plain.reset(4)
    got_roll = roll_plain(s1, 12)
    assert torch.equal(got_roll[0].cells, want_roll[0].cells)
    # Maze: the episode chunk.
    mslab = maze_slab.make_maze_slab(MAZE_MAIN, "cpu")
    roll = maze_slab.make_maze_episode_rollout(MAZE_MAIN, n, device="cpu", chunk=5)
    s0, _ = roll.reset(5)
    want_roll = roll(s0, 12)
    _refuse(monkeypatch, maze_slab, "maze_philox_slab")
    roll_plain = dataclasses.replace(roll, slab=dataclasses.replace(mslab, kernel=False))
    roll_plain.reset(5)
    assert torch.equal(roll_plain(s0, 12)[0].pos, want_roll[0].pos)
    # Collect: the episode path's step and reset.
    cfg = dataclasses.replace(COLLECT_MAIN, max_steps=6)
    roll = collect_slab.make_collect_episode_rollout(cfg, n, device="cpu", chunk=4)
    s0, _ = roll.reset(6)
    want_roll = roll(s0, 12)
    _refuse(monkeypatch, collect_slab, "collect_step_slab", "collect_reset_slab",
            "collect_philox_slab")
    roll_plain = dataclasses.replace(roll, slab=dataclasses.replace(roll.slab, kernel=False))
    roll_plain.reset(6)
    got_roll = roll_plain(s0, 12)
    assert torch.equal(got_roll[0].grid_obj, want_roll[0].grid_obj)
    assert torch.equal(got_roll[1]["reward_sum"], want_roll[1]["reward_sum"])


@pytest.mark.parametrize("cfg, on_kernel", [(COLLECT_MAIN, True), (COLLECT_LARGE, True),
                                            (CollectConfig(agents_index=(3, 5, 1)), False)],
                         ids=["main", "20x20", "three_agents"])
def test_collect_per_env_functions_take_the_slab_route(monkeypatch, cfg, on_kernel):
    """``make_collect`` builds its slab through ``make_collect_slab``, so
    its route is ``kernel_route``'s: on the CPU a config of one or two
    agents steps and resets through the kernel wrappers (which run their
    plain versions here, and launch the kernels on the card), one call
    each a step or reset; three agents call neither.  The draws are the
    slab's own: ``step_spec``'s three uniforms for two agents, and a move
    order ``perm`` is refused for them."""
    calls = {"step": 0, "reset": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(collect_slab, "collect_step_slab",
                        counted("step", collect_slab.collect_step_slab))
    monkeypatch.setattr(collect_slab, "collect_reset_slab",
                        counted("reset", collect_slab.collect_reset_slab))
    reset_fn, step_fn, _ = make_collect(cfg, "cpu")
    gen = torch.Generator().manual_seed(2)
    state = reset_fn(gen)
    A = cfg.num_agents
    for _ in range(3):
        state, *_ = step_fn(state, torch.zeros(A, dtype=torch.int32), gen)
    assert calls == ({"step": 3, "reset": 1} if on_kernel else {"step": 0, "reset": 0})
    again, *_ = step_fn(state, torch.zeros(A, dtype=torch.int32),
                        rnd=torch.full((collect_slab.make_collect_slab(cfg, "cpu").step_draws,),
                                       0.25))
    assert int(again.step_count) == 4
    if on_kernel:
        with pytest.raises(ValueError, match="perm is taken for agent counts other than"):
            step_fn(state, torch.zeros(A, dtype=torch.int32), gen, perm=torch.arange(A))


def _step_batch_env(env, steps, gen):
    states, obs = env.reset(seed=0)
    for _ in range(steps):
        acts = torch.randint(0, env.num_actions, env.actions_shape, generator=gen,
                             dtype=torch.int32)
        states, obs, rewards, term, trunc = env.step(states, acts)
    return states, obs


@pytest.mark.parametrize("family", ["collect", "ctf", "maze", "wildfire"])
def test_the_out_of_envelope_configs_step_on_the_cpu(family):
    """The CPU build of each config of the fault steps through the batch
    env, the per-env functions and, where the family has one for it, the
    episode rollout."""
    gen = torch.Generator().manual_seed(1)
    n = 3
    if family == "collect":
        _, obs = _step_batch_env(make_collect_batch(COLLECT_LARGE, n, device="cpu"), 4, gen)
        assert obs.shape == (n, 20, 20, 3)
        reset_fn, step_fn, _ = make_collect(COLLECT_LARGE, "cpu")
        state = reset_fn(gen)
        state, obs, *_ = step_fn(state, torch.zeros(2, dtype=torch.int32), gen)
        assert obs.shape == (20, 20, 3)
        cfg = dataclasses.replace(COLLECT_LARGE, layout="quadrants_respawn", respawn=True,
                                  max_steps=5)
        roll = collect_slab.make_collect_episode_rollout(cfg, n, device="cpu")
        states, m = roll(roll.reset(0)[0], 10)
        assert int(m["episodes"]) == 2 * n
    elif family == "ctf":
        _step_batch_env(make_ctf_batch(CTF_LARGE, n, device="cpu"), 4, gen)
        fns = make_ctf(CTF_LARGE, "cpu")
        state = fns.reset_fn(generator=gen)
        state, *_ = fns.step_fn(state, torch.zeros(5, dtype=torch.int32), generator=gen)
        assert state.pos.shape == (10, 2)
        # As JAX's, the episode rollout has no form above eight agents.
        assert ctf_slab.make_ctf_episode_rollout(CTF_LARGE, n, device="cpu") is None
    elif family == "maze":
        _, obs = _step_batch_env(make_maze_batch(MAZE_LARGE, n, device="cpu"), 4, gen)
        assert obs.shape == (n, 78, 78)
        fns = make_maze(MAZE_LARGE, "cpu")
        state = fns.reset_fn(generator=gen)
        fns.step_fn(state, torch.tensor(1, dtype=torch.int32))
        roll = maze_slab.make_maze_episode_rollout(MAZE_LARGE, n, device="cpu", chunk=4)
        roll(roll.reset(0)[0], 10)
    else:
        _, obs = _step_batch_env(make_wildfire_batch(WF_LARGE, n, device="cpu"), 4, gen)
        assert obs.shape == (n, 40, 40, 3)
        fns = make_wildfire(WF_LARGE, "cpu")
        state = fns.reset_fn(generator=gen)
        fns.step_fn(state, torch.zeros(2, dtype=torch.int32), generator=gen)
        roll = wildfire_slab.make_wildfire_episode_rollout(WF_LARGE, n, device="cpu", chunk=4)
        states, m = roll(roll.reset(0)[0], 10)
        assert states.cells.shape == (n, 40, 40)
