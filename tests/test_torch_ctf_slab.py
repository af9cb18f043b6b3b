"""The port's CtF step, spawn draw and batch glue against the JAX package,
bit for bit.

Inputs are made once with numpy from a fixed seed and handed to both
sides.  JAX runs its plain bodies (``_ctf_step_math``,
``_ctf_reset_math``), the batch glue with ``use_kernel=False``, and the
Pallas step with ``interpret=True``, as tests/test_pallas_ctf.py runs them.
Every comparison is exact, the 11 info distances included: the port takes
``sqrt(dx*dx + dy*dy)`` in float32, whose squares and sum are exact for
board coordinates, as in JAX's float32 ``jnp.linalg.norm``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_multigrid_tpu.envs import ctf as jctf
from gym_multigrid_tpu.ops import pallas_ctf as jpc
from gym_multigrid_tpu.ops.sampling import PickState as JaxPickState
from gym_multigrid_tpu.utils.map import load_text_map as jax_load_text_map
from gym_multigrid_tpu_torch.envs import ctf as tctf
from gym_multigrid_tpu_torch.ops import ctf_slab as tslab
from gym_multigrid_tpu_torch.ops.sampling import PickState

torch.set_num_threads(1)

BOARD = "tests/assets/board.txt"


def non_square_map():
    """board.txt cut to 10 x 7, both flags kept: the swapped bounds check
    (row against S1, column against S0) lets agents step off the board."""
    fm = jax_load_text_map(BOARD).astype(int)[:, :7]
    return tuple(tuple(int(v) for v in row) for row in fm)


CONFIGS = {
    # (a) CTF_MAIN, the config the family bench drives
    "a_main": dict(num_blue_agents=2, policies=("fight", "rw"), observation_option="flattened"),
    # (b) both patrol kinds, with the sticky collided flag
    "b_patrol": dict(num_blue_agents=2, policies=("patrol", "patrol_fight"),
                     obstacle_penalty_ratio=0.5),
    # (c) 1v1, where a lost battle or an obstacle cell ends the episode
    "c_1v1": dict(variant="1v1", policies=("fight",), obstacle_penalty_ratio=0.5),
    # (d) 6 agents: the move order is drawn by Fisher-Yates
    "d_3v3": dict(num_blue_agents=3, policies=("capture", "patrol", "rw")),
    # (e) a non-square board
    "e_non_square": dict(board=None, num_blue_agents=2, policies=("patrol_fight", "fight"),
                         obstacle_penalty_ratio=0.5),
}


def cfg_pair(name, **over):
    """The named config in both packages."""
    kw = {**CONFIGS[name], **over}
    board = kw.pop("board", BOARD)
    policies = kw.pop("policies")
    kw["num_red_agents"] = len(policies)
    jkw = dict(kw, enemy_policies=tuple(jctf.PolicySpec(k) for k in policies))
    tkw = dict(kw, enemy_policies=tuple(tctf.PolicySpec(k) for k in policies))
    if not isinstance(board, str):  # map data; None is the non-square board
        data = board or non_square_map()
        return jctf.CtfConfig(map_data=data, **jkw), tctf.CtfConfig(map_data=data, **tkw)
    return jctf.CtfConfig.from_map_path(board, **jkw), tctf.CtfConfig.from_map_path(board, **tkw)


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _start(rng, t, n):
    """(pos, dirs, term, coll) int32: random cells over the board and over
    what the swapped bounds check admits, a tenth of the agents terminated
    and a tenth collided.  In every fourth row blue agent 0 starts next to
    the red flag and the last red agent next to the blue flag, so that
    flag captures happen in a short run."""
    A = t.n_blue + t.n_red
    rows = rng.integers(0, max(t.s0, t.bound0), (n, A))
    cols = rng.integers(0, max(t.s1, t.bound1), (n, A))
    for agent, (fr, fc) in ((0, t.red_flag), (A - 1, t.blue_flag)):
        rows[::4, agent] = fr
        cols[::4, agent] = fc - 1 if fc > 0 else fc + 1
    pos = np.stack([rows, cols], axis=2).reshape(n, 2 * A).astype(np.int32)
    dirs = rng.integers(0, 4, (n, A)).astype(np.int32)
    term = (rng.random((n, A)) < 0.1).astype(np.int32)
    coll = (rng.random((n, A)) < 0.1).astype(np.int32)
    return pos, dirs, term, coll


def _blue_actions(rng, n, n_blue):
    """Ids -2..6: the out-of-range ones clamp to 0 or 4."""
    return rng.integers(-2, 7, (n, n_blue)).astype(np.int32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_step_spec_matches_step_math_over_chained_steps(name):
    jcfg, tcfg = cfg_pair(name)
    jt, tt = jpc.make_ctf_ktables(jcfg), tslab.make_ctf_ktables(tcfg)
    assert tuple(tt) == tuple(jt)
    jstatic = jpc.ctf_static_inputs(jcfg)
    tstatic = tslab.ctf_static_inputs(tcfg)

    def step_math(*a):  # eager: compiling the unrolled step takes longer
        return jpc._ctf_step_math(jt, *(jnp.asarray(x) for x in a), *jstatic)

    n, steps = 64, 30
    rng = np.random.default_rng(sorted(CONFIGS).index(name))
    state = _start(rng, tt, n)
    battles = flags = bumps = 0
    for _ in range(steps):
        ba = _blue_actions(rng, n, tt.n_blue)
        rnd = rng.random((n, tslab.rnd_width(tt)), dtype=np.float32)
        want = [np.asarray(w) for w in step_math(*state, ba, rnd)]
        got = tslab.step_spec(tt, *(torch.from_numpy(x) for x in (*state, ba, rnd)), *tstatic)
        assert len(got) == len(want) == 10
        for g, w in zip(got, want):
            _eq(g, w)
        battles += int(want[8].sum() + want[9].sum())
        flags += int(want[6].sum() + want[7].sum())
        bumps += int((want[3] > state[3]).sum())
        # Finished envs start again from fresh random cells.
        done = want[5][:, 0] == 1
        fresh = _start(rng, tt, n)
        state = tuple(np.where(done[:, None], f, w) for f, w in zip(fresh, want[:4]))
    assert battles > 0 and flags > 0, (battles, flags)
    if name == "b_patrol":
        assert bumps > 0


@pytest.mark.parametrize("name", ["a_main", "c_1v1"])
def test_step_spec_matches_pallas_kernel_in_interpret_mode(name):
    jcfg, tcfg = cfg_pair(name)
    jt, tt = jpc.make_ctf_ktables(jcfg), tslab.make_ctf_ktables(tcfg)
    cells, border, pool = jpc.ctf_static_inputs(jcfg)
    n = 16
    rng = np.random.default_rng(5)
    state = _start(rng, tt, n)
    ba = _blue_actions(rng, n, tt.n_blue)
    rnd = rng.random((n, tslab.rnd_width(tt)), dtype=np.float32)
    want = jpc.ctf_step_slab(
        jt, *(jnp.asarray(x) for x in (*state, ba, rnd)), cells, (border, pool), True
    )
    # On CPU tensors the wrapper runs the plain version, with the kernel's
    # interface: bool term/coll and flags, one flag byte per cell.
    pos, dirs, term, coll = (torch.from_numpy(x) for x in state)
    tcells, tborder, tpool = tslab.ctf_static_inputs(tcfg)
    got = tslab.ctf_step_slab(
        tt, pos, dirs, term.bool(), coll.bool(), torch.from_numpy(ba), torch.from_numpy(rnd),
        tslab.cell_flags(tcells), tborder, tpool,
    )
    for i, (g, w) in enumerate(zip(got, want)):
        if i in (0, 1, 4):  # pos, dirs, reward
            _eq(g, w)
        else:
            assert g.dtype == torch.bool
            _eq(g.to(torch.int32), w)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_wrapper_on_bool_state_equals_step_spec_on_int32(name):
    """``ctf_step_slab`` on the CPU, given bool term/coll and the flag
    bytes, returns what ``step_spec`` returns on the int32 state and the
    four cell planes, its flags cast to bool; over chained steps, so that
    collided and terminated agents come in."""
    _, tcfg = cfg_pair(name)
    slab = tslab.make_ctf_slab(tcfg, "cpu")
    tt = slab.t
    rng = np.random.default_rng(40 + sorted(CONFIGS).index(name))
    n = 32
    pos, dirs, term, coll = (torch.from_numpy(x) for x in _start(rng, tt, n))
    for _ in range(4):
        ba = torch.from_numpy(_blue_actions(rng, n, tt.n_blue))
        rnd = torch.from_numpy(rng.random((n, slab.step_draws), dtype=np.float32))
        want = tslab.step_spec(tt, pos, dirs, term, coll, ba, rnd, slab.cells, slab.border,
                               slab.pool)
        got = tslab.ctf_step_slab(tt, pos, dirs, term.bool(), coll.bool(), ba, rnd, slab.flags,
                                  slab.border, slab.pool)
        assert len(got) == len(want) == 10
        for i, (g, w) in enumerate(zip(got, want)):
            if i in (0, 1, 4):  # pos, dirs, reward
                _eq(g, w)
            else:
                assert g.dtype == torch.bool and set(w.unique().tolist()) <= {0, 1}
                assert torch.equal(g, w.to(torch.bool))
        pos, dirs, term, coll = want[:4]


@pytest.mark.parametrize("name", ["a_main", "c_1v1", "d_3v3"])
def test_reset_spec_matches_reset_math(name):
    jcfg, tcfg = cfg_pair(name)
    jt, tt = jpc.make_ctf_ktables(jcfg), tslab.make_ctf_ktables(tcfg)
    n = 64
    rng = np.random.default_rng(3)
    rnd = rng.random((n, tcfg.num_agents), dtype=np.float32)
    rnd[0] = np.float32(1.0) - np.finfo(np.float32).epsneg  # largest u below 1
    rnd[1] = 0.0
    want = jpc._ctf_reset_math(jt, jnp.asarray(rnd), *jpc.ctf_reset_inputs(jcfg))
    got = tslab.reset_spec(tt, torch.from_numpy(rnd), *tslab.ctf_reset_inputs(tcfg))
    _eq(got, want)


@pytest.mark.parametrize("c", [3, 40])
def test_pick_state_matches_jax_through_four_picks(c):
    """From every cell free, as the spawn draw starts; with 3 cells every
    row runs out on the fourth pick and picks nothing."""
    n = 48
    rng = np.random.default_rng(c)
    jps = JaxPickState.full(n, c, jax.lax.broadcasted_iota(jnp.int32, (n, c), 1))
    tps = PickState.full(n, c, "cpu")
    for _ in range(4):
        u = rng.random((n, 1), dtype=np.float32)
        u[0] = np.float32(1.0) - np.finfo(np.float32).epsneg  # largest u below 1
        u[1] = 0.0
        jhit, jidx, jps = jps.pick(jnp.asarray(u))
        thit, tidx, tps = tps.pick(torch.from_numpy(u))
        _eq(thit, jhit)
        _eq(tidx, jidx)
        for field in ("mask", "cum", "count"):
            _eq(getattr(tps, field), getattr(jps, field))
    assert (tps.count == max(c - 4, 0)).all()


def _jax_states(jcfg, n, seed):
    fns = jctf.make_ctf(jcfg)
    return jax.vmap(fns.reset_fn)(jax.random.split(jax.random.PRNGKey(seed), n))


def _jax_step_rnd(jstates, width):
    """The uniforms make_ctf_step_batch draws from the state keys."""
    keys = jax.vmap(jax.random.split)(jstates.key)
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (width,)))(keys[:, 1]))


def _to_torch(jstates):
    return tctf.ctf_state_from_numpy({k: np.asarray(v) for k, v in vars(jstates).items()}, "cpu")


@pytest.mark.parametrize(
    "name, obs",
    [("a_main", "flattened"), ("c_1v1", "positional"), ("e_non_square", "map")],
)
def test_step_batch_matches_jax_step_batch(name, obs):
    jcfg, tcfg = cfg_pair(name, observation_option=obs, max_steps=6)
    jstep = jax.jit(jpc.make_ctf_step_batch(jcfg, use_kernel=False))
    slab = tslab.make_ctf_slab(tcfg, "cpu")
    n, steps = 32, 8
    js = _jax_states(jcfg, n, seed=9)
    rng = np.random.default_rng(13)
    truncated = 0
    for _ in range(steps):
        ba = _blue_actions(rng, n, tcfg.num_blue_agents)
        rnd = _jax_step_rnd(js, slab.step_draws)
        got_states, got_obs, *got_rest, got_info = tslab.step_batch(
            slab, _to_torch(js), torch.from_numpy(ba), rnd=torch.tensor(rnd)
        )
        js, want_obs, *want_rest, want_info = jstep(js, jnp.asarray(ba))
        for f in dataclasses.fields(got_states):
            _eq(getattr(got_states, f.name), getattr(js, f.name))
        if obs == "positional":
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


def test_info_distances_equal_jax_and_are_inf_without_obstacles():
    """On a map with no obstacle cell ``d_ba_ob`` is inf."""
    jcfg, tcfg = cfg_pair("a_main", board=_no_border_map(), num_blue_agents=1, policies=("rw",))
    js = _jax_states(jcfg, 16, seed=4)
    want = jax.vmap(jctf.make_ctf(jcfg).info_fn)(js)
    got = tctf.info(tcfg, _to_torch(js))
    assert sorted(got) == sorted(want)
    for key in want:
        _eq(got[key], want[key])
    assert torch.isinf(got["d_ba_ob"]).all()


def test_step_batch_can_skip_obs_and_info():
    _, tcfg = cfg_pair("a_main")
    slab = tslab.make_ctf_slab(tcfg, "cpu")
    gen = torch.Generator().manual_seed(0)
    states = tslab.reset_batch(slab, 8, generator=gen)
    acts = torch.zeros((8, 2), dtype=torch.int32)
    full = tslab.step_batch(slab, states, acts, generator=torch.Generator().manual_seed(1))
    bare = tslab.step_batch(slab, states, acts, generator=torch.Generator().manual_seed(1),
                            encode_obs=False, with_info=False)
    assert bare[1] is None and bare[5] is None
    for g, w in zip(bare[2:5], full[2:5]):
        assert torch.equal(g, w)
    assert torch.equal(bare[0].pos, full[0].pos)


def test_wrapper_refuses_other_devices():
    _, tcfg = cfg_pair("a_main")
    tt = tslab.make_ctf_ktables(tcfg)
    meta = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        tslab.ctf_step_slab(tt, meta, None, None, None, None, None, None, None, None)


def _no_border_map():
    """Red territory everywhere but the two flags: no red border."""
    fm = np.ones((6, 6), dtype=int)
    fm[0, 0], fm[5, 5] = 4, 5
    return tuple(tuple(int(v) for v in row) for row in fm)


def _wide_map():
    """40 x 30 = 1200 cells, above the kernel's limit."""
    fm = np.zeros((40, 30), dtype=int)
    fm[20:] = 1
    fm[0, 0], fm[39, 29] = 4, 5
    return tuple(tuple(int(v) for v in row) for row in fm)


OUTSIDE_THE_ENVELOPE = dict(
    nine_agents=dict(num_blue_agents=5, policies=("rw",) * 4),
    board_above_1024_cells=dict(board=_wide_map()),
)


@pytest.mark.parametrize(
    "kw",
    [*OUTSIDE_THE_ENVELOPE.values(), dict(board=_no_border_map(), policies=("patrol",))],
    ids=[*OUTSIDE_THE_ENVELOPE, "patrol_without_a_red_border"],
)
def test_configs_outside_the_kernel_envelope_are_refused(kw):
    """The step kernels refuse these configs, so a CUDA slab of them takes
    the plain route (decided without a card); a patrol policy with no red
    border is refused before anything reaches the card, so this runs
    without one."""
    _, tcfg = cfg_pair("b_patrol", **kw)
    if kw.get("policies") == ("patrol",):
        with pytest.raises(ValueError, match="patrol policy needs"):
            tslab.make_ctf_slab(tcfg, "cuda")
        return
    t = tslab.make_ctf_ktables(tcfg)
    _, border, pool = tslab.ctf_static_inputs(tcfg)
    with pytest.raises(ValueError, match="CtF step kernel takes"):
        tslab.check_envelope(t, border.shape[1], pool.shape[1])
    assert not tslab.kernel_route(t, "cuda", border.shape[1], pool.shape[1])


def test_patrol_without_a_red_border_is_refused_on_the_cpu_too():
    """JAX's step math has no closest border cell to fall back on either."""
    _, tcfg = cfg_pair("b_patrol", board=_no_border_map(), policies=("patrol",))
    with pytest.raises(ValueError, match="patrol policy needs"):
        tslab.make_ctf_slab(tcfg, "cpu")


@pytest.mark.parametrize("name", sorted(OUTSIDE_THE_ENVELOPE))
def test_plain_version_takes_configs_outside_the_kernel_envelope(name):
    """On the CPU the step has no envelope: it equals ``_ctf_step_math``
    on configs the kernel refuses."""
    jcfg, tcfg = cfg_pair("b_patrol", **OUTSIDE_THE_ENVELOPE[name])
    slab = tslab.make_ctf_slab(tcfg, "cpu")
    jt = jpc.make_ctf_ktables(jcfg)
    jstatic = jpc.ctf_static_inputs(jcfg)
    n = 16
    rng = np.random.default_rng(11)
    state = _start(rng, slab.t, n)
    for _ in range(3):
        ba = _blue_actions(rng, n, slab.t.n_blue)
        rnd = rng.random((n, slab.step_draws), dtype=np.float32)
        want = jpc._ctf_step_math(jt, *(jnp.asarray(x) for x in (*state, ba, rnd)), *jstatic)
        got = tslab.step_spec(slab.t, *(torch.from_numpy(x) for x in (*state, ba, rnd)),
                              slab.cells, slab.border, slab.pool)
        for g, w in zip(got, want):
            _eq(g, w)
        state = tuple(np.array(w) for w in want[:4])
