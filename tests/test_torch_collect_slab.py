"""The port's Collect slab math against the JAX package, bit for bit.

Inputs are made once with numpy from a fixed seed and handed to both
sides.  JAX runs its plain bodies (``_step_math``, ``_reset_math``), the
batch glue with ``use_kernel=False``, and one interpret-mode call of each
Pallas kernel, as tests/test_pallas.py runs them.  Every comparison is
exact: planes, positions and picks are integers, and rewards are single
table entries summed over at most two agents.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_multigrid_tpu.envs import collect as jcollect
from gym_multigrid_tpu.ops import pallas_collect as jpc
from gym_multigrid_tpu_torch.envs import collect as tcollect
from gym_multigrid_tpu_torch.ops import collect_slab as tslab
from gym_multigrid_tpu_torch.ops.sampling import masked_pick

torch.set_num_threads(1)

MAIN = dict(layout="quadrants_respawn", respawn=True, max_steps=50)
SINGLE = dict(agents_index=(3,), layout="even", respawn=False, max_steps=100)
LAYOUTS = ("even", "quadrants", "rooms", "quadrants_respawn")
# A small board where episodes both terminate (all 3 balls collected) and
# truncate within a few steps.
TINY = dict(size=5, num_balls=3, layout="even", respawn=False, max_steps=8)


def _cfgs(**kw):
    return jcollect.CollectConfig(**kw), tcollect.CollectConfig(**kw)


def _jax_states(jcfg, n, seed):
    reset_one, _, _ = jcollect.make_collect(jcfg)
    return jax.vmap(reset_one)(jax.random.split(jax.random.PRNGKey(seed), n))


def _to_torch(jstates):
    arrays = {k: np.asarray(v) for k, v in vars(jstates).items()}
    return tcollect.state_from_numpy(arrays, "cpu")


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _actions(rng, n, a):
    """Valid moves with the invalid ids -1, 4 and 7 mixed in."""
    acts = rng.integers(0, 4, size=(n, a))
    bad = rng.random((n, a)) < 0.2
    return np.where(bad, rng.choice([-1, 4, 7], size=(n, a)), acts).astype(np.int32)


def _tril(c):
    return jnp.asarray(np.tril(np.ones((c, c), dtype=np.float32)).T)


@pytest.mark.parametrize("kw", [MAIN, SINGLE], ids=["main", "single"])
def test_step_spec_matches_step_math_over_chained_steps(kw):
    jcfg, tcfg = _cfgs(**kw)
    n, steps = 32, 60
    jt, tt = jpc.make_tables(jcfg), tslab.make_tables(tcfg)
    assert tuple(tt) == tuple(jt)
    s = _jax_states(jcfg, n, seed=3)
    go, gc, gs = (np.asarray(x) for x in (s.grid_obj, s.grid_color, s.grid_slot))
    pos = np.asarray(s.agent_pos).reshape(n, -1)
    rects = np.array(jt.respawn_rects, dtype=bool)
    rng = np.random.default_rng(11)
    picks = respawned = 0
    for _ in range(steps):
        acts = _actions(rng, n, tcfg.num_agents)
        rnd = rng.random((n, 3), dtype=np.float32)
        want = jpc._step_math(
            jt, go, gc, gs, pos, jnp.asarray(acts), jnp.asarray(rnd),
            jnp.asarray(rects), _tril(tcfg.num_cells),
        )
        got = tslab.step_spec(
            tt, *(torch.tensor(x) for x in (go, gc, gs, pos, acts, rnd, rects))
        )
        for g, w in zip(got, want):
            _eq(g, w)
        picks += int((np.asarray(want[4]) >= 0).sum())
        respawned += int((np.asarray(want[2]) >= tt.respawn_slot_base).sum())
        go, gc, gs, pos = (np.asarray(x) for x in want[:4])
    assert picks > 0
    assert respawned > 0 or not tcfg.respawn


def test_step_spec_matches_pallas_kernel_in_interpret_mode():
    jcfg, tcfg = _cfgs(**MAIN)
    n = 16
    jt, tt = jpc.make_tables(jcfg), tslab.make_tables(tcfg)
    s = _jax_states(jcfg, n, seed=1)
    rng = np.random.default_rng(5)
    acts = _actions(rng, n, 2)
    rnd = rng.random((n, 3), dtype=np.float32)
    pos = np.asarray(s.agent_pos).reshape(n, -1)
    want = jpc.collect_step_slab(
        jt, s.grid_obj, s.grid_color, s.grid_slot, jnp.asarray(pos),
        jnp.asarray(acts), jnp.asarray(rnd), True,
    )
    got = tslab.collect_step_slab(
        tt,
        *(torch.tensor(np.asarray(x))
          for x in (s.grid_obj, s.grid_color, s.grid_slot, pos, acts, rnd)),
        torch.from_numpy(np.array(jt.respawn_rects, dtype=bool)),
    )
    for g, w in zip(got, want):
        _eq(g, w)


def _reset_inputs(jcfg, n, seed):
    rt, plan = jpc.make_reset_tables(jcfg)
    wall = jcollect._wall_mask(jcfg)
    rects = plan.ball_rects & ~wall[None, :]
    rng = np.random.default_rng(seed)
    rnd = rng.random((n, len(rt.ball_colors) + jcfg.num_agents), dtype=np.float32)
    return rt, wall, rects, rnd


@pytest.mark.parametrize("layout", LAYOUTS)
def test_reset_spec_matches_reset_math(layout):
    jcfg, tcfg = _cfgs(layout=layout)
    n = 32
    rt, wall, rects, rnd = _reset_inputs(jcfg, n, seed=7)
    trt, _ = tslab.make_reset_tables(tcfg)
    assert tuple(trt) == tuple(rt)
    ra = tslab.make_reset_arrays(tcfg, "cpu")
    _eq(ra.wall, wall)
    _eq(ra.ball_rects, rects)
    want = jpc._reset_math(
        rt, jnp.asarray(wall)[None, :], jnp.asarray(rects), jnp.asarray(rnd),
        _tril(jcfg.num_cells),
    )
    got = tslab.reset_spec(trt, ra.wall, ra.ball_rects, torch.from_numpy(rnd))
    for g, w in zip(got, want):
        _eq(g, w)


def test_uniform_agent_placement_matches_reset_math():
    """The even layout with agents placed uniformly over the empty cells
    (the third placement mode; every registered even id has it)."""
    jcfg, tcfg = _cfgs(layout="even", size=6, num_balls=12)
    rt, wall, rects, rnd = _reset_inputs(jcfg, 64, seed=2)
    assert rt.agent_fixed is None and rt.agent_choice is None
    trt, _ = tslab.make_reset_tables(tcfg)
    want = jpc._reset_math(
        rt, jnp.asarray(wall)[None, :], jnp.asarray(rects), jnp.asarray(rnd),
        _tril(jcfg.num_cells),
    )
    got = tslab.reset_spec(
        trt, torch.from_numpy(wall), torch.from_numpy(rects), torch.from_numpy(rnd)
    )
    for g, w in zip(got, want):
        _eq(g, w)


def test_reset_spec_matches_pallas_kernel_in_interpret_mode():
    jcfg, tcfg = _cfgs(**MAIN)
    rt, wall, rects, rnd = _reset_inputs(jcfg, 16, seed=4)
    want = jpc.collect_reset_slab(
        rt, jnp.asarray(rnd), tuple(bool(b) for b in wall), jnp.asarray(rects),
        _tril(jcfg.num_cells), True,
    )
    trt, _ = tslab.make_reset_tables(tcfg)
    ra = tslab.make_reset_arrays(tcfg, "cpu")
    got = tslab.collect_reset_slab(trt, torch.from_numpy(rnd), ra)
    for g, w in zip(got, want):
        _eq(g, w)


def test_masked_reset_touches_only_done_rows():
    _, tcfg = _cfgs(**MAIN)
    n = 16
    trt, _ = tslab.make_reset_tables(tcfg)
    ra = tslab.make_reset_arrays(tcfg, "cpu")
    rng = np.random.default_rng(8)
    rnd = torch.from_numpy(rng.random((n, 17), dtype=np.float32))
    done = torch.from_numpy(rng.random(n) < 0.5)
    old = [torch.from_numpy(rng.integers(0, 9, size=s, dtype=np.int32))
           for s in ((n, 100),) * 3 + ((n, 4),)]
    out = [o.clone() for o in old]
    got = tslab.collect_reset_slab(trt, rnd, ra, done=done, out=out)
    fresh = tslab.reset_spec(trt, ra.wall, ra.ball_rects, rnd)
    for g, o, f, old_x in zip(got, out, fresh, old):
        assert g is o  # written in place
        _eq(g, torch.where(done[:, None], f, old_x))


def test_masked_pick_matches_jax_including_empty_rows():
    rng = np.random.default_rng(0)
    mask = rng.random((64, 100)) < 0.1
    mask[:5] = False  # rows with nothing to pick
    mask[5] = True
    u = rng.random((64, 1), dtype=np.float32)
    u[6] = np.float32(1.0) - np.finfo(np.float32).epsneg  # largest u below 1
    want = jpc._masked_pick(jnp.asarray(mask), jnp.asarray(u), None)
    got = masked_pick(torch.from_numpy(mask), torch.from_numpy(u))
    _eq(got, want)
    assert not got[:5].any() and (got[5:].sum(1) == mask[5:].any(1)).all()


def _jax_step_rnd(states):
    """The uniforms make_collect_step_batch draws from the state keys."""
    keys = jax.vmap(jax.random.split)(states.key)
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (3,)))(keys[:, 1]))


@pytest.mark.parametrize("kw", [MAIN, SINGLE, TINY], ids=["main", "single", "tiny"])
def test_step_batch_matches_jax_step_batch(kw):
    jcfg, tcfg = _cfgs(**kw)
    n, steps = 32, 12
    jstep = jax.jit(jpc.make_collect_step_batch(jcfg, use_kernel=False))
    slab = tslab.make_collect_slab(tcfg, "cpu")
    js = _jax_states(jcfg, n, seed=9)
    rng = np.random.default_rng(13)
    ended = 0
    for _ in range(steps):
        acts = _actions(rng, n, tcfg.num_agents)
        rnd = _jax_step_rnd(js)
        ts = _to_torch(js)
        got = tslab.step_batch(slab, ts, torch.from_numpy(acts), rnd=torch.tensor(rnd))
        js, *want = jstep(js, jnp.asarray(acts))
        got_states, *got_rest = got
        for name, arr in tcollect.state_to_numpy(got_states).items():
            _eq(arr, getattr(js, name))
        for g, w in zip(got_rest, want):
            _eq(g, w)
        ended += int(np.asarray(want[2]).sum())  # terminated
    if kw is TINY:
        assert ended > 0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_reset_batch_matches_jax_reset_batch(layout):
    jcfg, tcfg = _cfgs(layout=layout)
    n = 24
    keys = jax.random.split(jax.random.PRNGKey(17), n)
    want = jax.jit(jpc.make_collect_reset_batch(jcfg, use_kernel=False))(keys)
    slab = tslab.make_collect_slab(tcfg, "cpu")
    rnd = jax.vmap(
        lambda k: jax.random.uniform(jax.random.split(k)[1], (slab.reset_draws,))
    )(keys)
    got = tslab.reset_batch(slab, n, rnd=torch.tensor(np.asarray(rnd)))
    for f in dataclasses.fields(tcollect.CollectState):
        _eq(getattr(got, f.name), getattr(want, f.name))


def test_wrappers_refuse_other_devices():
    _, tcfg = _cfgs(**MAIN)
    tt = tslab.make_tables(tcfg)
    meta = torch.zeros((2, 100), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        tslab.collect_step_slab(tt, meta, meta, meta, None, None, None, None)
    trt, _ = tslab.make_reset_tables(tcfg)
    with pytest.raises(ValueError, match="meta"):
        tslab.collect_reset_slab(trt, torch.zeros((2, 17), device="meta"), None)


@pytest.mark.parametrize(
    "kw, device",
    [(dict(size=17), "meta"), (dict(agents_index=(3, 5, 1)), "cpu")],
    ids=["board_above_256_cells", "three_agents"],
)
def test_configs_outside_the_kernel_envelope_are_refused(kw, device):
    """The board bound holds off the CPU, where the kernels run (the plain
    versions on the CPU take any board): the kernels refuse it there, and
    the slab takes the plain route instead.  Three agents are refused by
    the kernel wrapper on the CPU too, since its plain version moves one or
    two; the slab sends them to the any-agent plain step instead."""
    _, tcfg = _cfgs(**kw)
    if tcfg.num_agents in tslab.AGENT_COUNTS:
        with pytest.raises(ValueError, match="the Collect kernels take"):
            tslab._check_envelope(tcfg.num_cells, tcfg.num_agents)
        assert not tslab.make_collect_slab(tcfg, device).kernel
        return
    slab = tslab.make_collect_slab(tcfg, device)
    assert not slab.kernel
    go = torch.zeros((2, tcfg.num_cells), dtype=torch.int32)
    with pytest.raises(ValueError, match="the Collect kernels take"):
        tslab.collect_step_slab(slab.t, go, go, go, torch.zeros((2, 6), dtype=torch.int32),
                                torch.zeros((2, 3), dtype=torch.int32), torch.rand((2, 3)),
                                slab.respawn_rects)
