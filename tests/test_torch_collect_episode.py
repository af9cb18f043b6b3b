"""The port's Collect episode path on the CPU: ``ms_spec`` against the JAX
package's K-step episode math bit for bit, the boundary reset against its
packed-plane reset, and ``make_collect_episode_rollout``'s invariants, its
counter-based draws and the configs it refuses."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_multigrid_tpu.envs import collect as jcollect
from gym_multigrid_tpu.ops import pallas_collect as jpc
from gym_multigrid_tpu_torch.envs import collect as tcollect
from gym_multigrid_tpu_torch.ops import collect_slab as tslab

torch.set_num_threads(1)

MAIN = dict(layout="quadrants_respawn", respawn=True, max_steps=50)
SINGLE = dict(agents_index=(3,), layout="even", respawn=False, max_steps=100)
FIXED = dict(layout="even", fixed_horizon=True, max_steps=50)
BOARD16 = dict(size=16, num_balls=45, layout="quadrants_respawn", respawn=True, max_steps=50)
LAYOUTS = ("even", "quadrants", "rooms", "quadrants_respawn")


def _cfgs(**kw):
    return jcollect.CollectConfig(**kw), tcollect.CollectConfig(**kw)


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [MAIN, SINGLE, FIXED, BOARD16],
                         ids=["main", "single", "fixed_horizon", "16x16"])
def test_ms_steps_match_jax_episode_math(kw):
    """K steps from fresh boards on one packed (B, K * (A + 3)) float buffer
    [actions as floats, move-order and respawn uniforms]: planes, positions,
    summed rewards and info counters bit for bit.  The ids include -1, 4
    and 7, which are a no-op."""
    jcfg, tcfg = _cfgs(**kw)
    slab = tslab.make_collect_slab(tcfg, "cpu")
    # The 16x16 board's agents start further from its balls.
    B, K = (64, 24) if kw is BOARD16 else (32, 12)
    A = tcfg.num_agents
    rt, plan = jpc.make_reset_tables(jcfg)
    wall = jcollect._wall_mask(jcfg)
    rng = np.random.default_rng(A)
    rnd0 = rng.random((B, len(rt.ball_colors) + A), dtype=np.float32)
    go, gc, gs, pos = (np.asarray(x) for x in jpc._reset_math(
        rt, jnp.asarray(wall)[None, :], jnp.asarray(plan.ball_rects & ~wall[None, :]),
        jnp.asarray(rnd0), None))
    acts = rng.integers(0, 4, (B, K, A))
    acts = np.where(rng.random((B, K, A)) < 0.2, rng.choice([-1, 4, 7], (B, K, A)), acts)
    rnd = rng.random((B, K, 3), dtype=np.float32)
    packed = np.concatenate([acts.astype(np.float32), rnd], axis=2).reshape(B, K * (A + 3))
    jt = jpc.make_tables(jcfg)
    rwd, slot, _ = jcollect.reward_slot_tables(jcfg, jcollect.build_plan(jcfg))
    want = jpc._collect_ms_math(
        jt, K, *(jnp.asarray(x) for x in (go, gc, gs, pos, packed)),
        jnp.asarray(np.array(jt.respawn_rects, dtype=bool)), None,
        jnp.asarray(np.asarray(rwd, np.float32)), jnp.asarray(np.asarray(slot, np.int32)),
        jcfg.num_ball_types,
    )
    got = tslab.ms_spec(
        slab, *(torch.from_numpy(x.copy()) for x in (go, gc, gs, pos)),
        torch.from_numpy(acts.astype(np.int32).transpose(1, 0, 2).copy()),
        torch.from_numpy(rnd.transpose(1, 0, 2).copy()),
    )
    for g, w in zip(got, want):
        _eq(g, w)
    assert int(got[5].sum()) > 0  # balls were picked up


def _reset_inputs(jcfg, n, seed):
    rt, plan = jpc.make_reset_tables(jcfg)
    wall = jcollect._wall_mask(jcfg)
    rects = plan.ball_rects & ~wall[None, :]
    rnd = np.random.default_rng(seed).random((n, len(rt.ball_colors) + jcfg.num_agents),
                                             dtype=np.float32)
    return rt, wall, rects, rnd


@pytest.mark.parametrize("kw", [dict(layout=layout) for layout in LAYOUTS]
                         + [dict(layout="even", size=6, num_balls=12)],
                         ids=[*LAYOUTS, "even-uniform-agents"])
def test_boundary_reset_matches_packed_reset_math(kw):
    """The rollout's all-rows reset against ``_reset_math_packed``, the JAX
    episode path's boundary reset, unpacked."""
    jcfg, tcfg = _cfgs(**kw)
    n = 32
    rt, wall, rects, rnd = _reset_inputs(jcfg, n, seed=len(kw))
    p, want_pos = jpc._reset_math_packed(
        rt, jnp.asarray(wall)[None, :], jnp.asarray(rects), jnp.asarray(rnd), None)
    slab = tslab.make_collect_slab(tcfg, "cpu")
    got = tslab.collect_reset_slab(slab.rt, torch.from_numpy(rnd), slab.reset_arrays)
    for g, w in zip(got, (*jpc.unpack_planes(p), want_pos)):
        _eq(g, w)


def _rollout(n, chunk=25, **kw):
    return tslab.make_collect_episode_rollout(tcollect.CollectConfig(**{**MAIN, **kw}), n,
                                              device="cpu", chunk=chunk)


def test_episode_rollout_invariants():
    """Two calls of two and one 50-step episodes: fresh boards after each
    (every ball back, two agents a board, counters zero), every env's
    episodes counted, and all reward in finished episodes."""
    n = 24
    roll = _rollout(n, chunk=20)
    states, obs = roll.reset(seed=0)
    assert obs.shape == (n, 10, 10, 3) and obs.dtype == torch.uint8
    total = 0.0
    for n_eps in (2, 1):
        states, m = roll(states, n_eps * 50)
        assert int(m["episodes"]) == n * n_eps and m["episodes"].dtype == torch.int32
        assert float(m["reward_sum"]) > 0
        assert torch.equal(m["ep_return_sum"], m["reward_sum"])
        assert torch.equal(m["run_return"], torch.zeros(n))
        total += float(m["reward_sum"])
        assert ((states.grid_obj == tcollect.BALL).sum(1) == 15).all()
        assert ((states.grid_obj == tcollect.AGENT).sum(1) == 2).all()
        for f in ("collected", "step_count", "info_counts"):
            assert not getattr(states, f).any(), f
        assert states.info_counts.shape == (n, 2, 3)
    # A random walk picks up a ball now and then: about 0.06 a step an agent
    # on this board.
    assert 0.02 < total / (n * 150 * 2) < 0.2


def test_episode_rollout_draws_chunks_and_resets_from_the_counters():
    """A 100-step call at chunk 20 equals the first reset on the
    ``COLLECT_FIRST`` uniforms of the seed's key, then ``ms_philox_spec``
    chunks of 20 at the running step count on the packed board (whose
    resets take the ``COLLECT_FRESH`` uniforms), the rewards summed once at
    the end."""
    n = 8
    roll = _rollout(n, chunk=20)
    start, _ = roll.reset(seed=3)
    key = tslab.philox.key_of(3)
    assert roll.key == key and roll.step == 0
    fresh = tslab.collect_reset_slab(
        roll.slab.rt, tslab.philox.collect_first_reset_draws(key, n, 17, "cpu"),
        roll.slab.reset_arrays)
    for g, w in zip((start.grid_obj, start.grid_color, start.grid_slot,
                     start.agent_pos.reshape(n, 4)), fresh):
        assert torch.equal(g, w)
    states, m = roll(start, 100)
    assert roll.step == 100
    state = (tslab.pack_planes(*fresh[:3]), fresh[3], torch.zeros((n, 2)))
    for step in range(0, 100, 20):
        state = tslab.ms_philox_spec(roll.slab, 20, *state, key, step)
    assert torch.equal(m["reward_sum"], state[2].sum())
    for g, w in zip((states.grid_obj, states.grid_color, states.grid_slot,
                     states.agent_pos.reshape(n, 4)), (*tslab.unpack_planes(state[0]), state[1])):
        assert torch.equal(g, w)


def test_configs_and_step_counts_it_refuses():
    with pytest.raises(ValueError, match="only truncates"):
        tslab.make_collect_episode_rollout(tcollect.CollectConfig(**SINGLE), 4, device="cpu")
    roll = _rollout(4)
    states, _ = roll.reset(seed=0)
    with pytest.raises(ValueError, match="multiple of max_steps"):
        roll(states, 75)
    with pytest.raises(ValueError, match="chunk"):
        _rollout(4, chunk=0)
    # fixed_horizon configs never terminate early either.
    fixed = tcollect.CollectConfig(layout="even", fixed_horizon=True, max_steps=10)
    roll = tslab.make_collect_episode_rollout(fixed, 4, device="cpu")
    states, _ = roll.reset(seed=0)
    assert int(roll(states, 20)[1]["episodes"]) == 8


def test_no_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tslab.make_collect_episode_rollout(tcollect.CollectConfig(**MAIN), 8)


@pytest.mark.parametrize("kw", [MAIN, dict(size=15, num_balls=30, layout="quadrants")],
                         ids=["main", "15x15"])
def test_reset_words_are_the_rect_and_wall_rows(kw):
    """``ResetArrays.words``, which the reset kernel reads: bit c % 32 of
    word c // 32 of each row is cell c of that ball rect, then of the wall."""
    slab = tslab.make_collect_slab(tcollect.CollectConfig(**kw), "cpu")
    ra = slab.reset_arrays
    C, nw = slab.rt.n_cells, -(-slab.rt.n_cells // 32)
    rows = torch.cat([ra.ball_rects, ra.wall[None, :]]).numpy()
    words = ra.words.numpy().view(np.uint32).reshape(len(rows), nw)
    cells = np.arange(C)
    bits = (words[:, cells // 32] >> (cells % 32).astype(np.uint32)) & 1
    np.testing.assert_array_equal(bits.astype(bool), rows)
    # No bit past the last cell.
    assert not (words[:, -1] >> np.uint32(C - 32 * (nw - 1)) if C % 32 else words[:, :0]).any()
