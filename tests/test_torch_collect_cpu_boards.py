"""Collect boards beyond the kernels' 256 cells on the CPU: the plain step
and reset against the JAX package's bodies bit for bit at 400 cells, the
reset's bit words at that size, and the batch env and the episode rollout
building and stepping such a board (the kernels' envelope binds only off
the CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_multigrid_tpu.envs import collect as jcollect
from gym_multigrid_tpu.ops import pallas_collect as jpc
from gym_multigrid_tpu_torch.envs import collect as tcollect
from gym_multigrid_tpu_torch.ops import collect_slab as tslab
from gym_multigrid_tpu_torch.parallel.vector import make_collect_batch

torch.set_num_threads(1)

# 20x20: 400 cells, past the kernels' 256.
BIG = dict(size=20)
BIG_RESPAWN = dict(size=20, num_balls=60, layout="even", respawn=True, max_steps=10)


def _cfgs(**kw):
    return jcollect.CollectConfig(**kw), tcollect.CollectConfig(**kw)


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _tril(c):
    return jnp.asarray(np.tril(np.ones((c, c), dtype=np.float32)).T)


def _reset(jcfg, tcfg, n, seed):
    """(JAX reset, port reset) of the same uniforms: (go, gc, gs, pos)."""
    rt, plan = jpc.make_reset_tables(jcfg)
    wall = jcollect._wall_mask(jcfg)
    rects = plan.ball_rects & ~wall[None, :]
    rng = np.random.default_rng(seed)
    rnd = rng.random((n, len(rt.ball_colors) + jcfg.num_agents), dtype=np.float32)
    want = jpc._reset_math(rt, jnp.asarray(wall)[None, :], jnp.asarray(rects),
                           jnp.asarray(rnd), _tril(jcfg.num_cells))
    trt, _ = tslab.make_reset_tables(tcfg)
    ra = tslab.make_reset_arrays(tcfg, "cpu")
    return want, tslab.reset_spec(trt, ra.wall, ra.ball_rects, torch.from_numpy(rnd))


@pytest.mark.parametrize("kw", [BIG, BIG_RESPAWN], ids=["even", "even_respawn"])
def test_reset_and_steps_match_jax_at_400_cells(kw):
    """``reset_spec`` equals ``_reset_math``, then ``step_spec`` equals
    ``_step_math`` over chained steps from that board, every plane,
    position and pick bit for bit."""
    jcfg, tcfg = _cfgs(**kw)
    assert tcfg.num_cells == 400
    n, steps = 32, 30
    want, got = _reset(jcfg, tcfg, n, seed=3)
    for g, w in zip(got, want):
        _eq(g, w)
    jt, tt = jpc.make_tables(jcfg), tslab.make_tables(tcfg)
    rects = np.array(jt.respawn_rects, dtype=bool)
    go, gc, gs, pos = (np.asarray(x) for x in want)
    rng = np.random.default_rng(4)
    picks = respawned = 0
    for _ in range(steps):
        acts = rng.integers(-1, 5, (n, tcfg.num_agents)).astype(np.int32)
        rnd = rng.random((n, 3), dtype=np.float32)
        want = jpc._step_math(jt, go, gc, gs, pos, jnp.asarray(acts), jnp.asarray(rnd),
                              jnp.asarray(rects), _tril(tcfg.num_cells))
        got = tslab.step_spec(tt, *(torch.tensor(x) for x in (go, gc, gs, pos, acts, rnd, rects)))
        for g, w in zip(got, want):
            _eq(g, w)
        picks += int((np.asarray(want[4]) >= 0).sum())
        respawned += int((np.asarray(want[2]) >= tt.respawn_slot_base).sum())
        go, gc, gs, pos = (np.asarray(x) for x in want[:4])
    assert picks > 0
    assert respawned > 0 or not tcfg.respawn


def test_reset_words_cover_400_cells():
    """The reset kernel's bit words at 400 cells: 13 words a row, cell c at
    bit c % 32 of word c // 32, the ball rects then the wall."""
    _, tcfg = _cfgs(**BIG_RESPAWN)
    ra = tslab.make_reset_arrays(tcfg, "cpu")
    rows = torch.cat([ra.ball_rects, ra.wall[None, :]]).numpy()
    words = ra.words.numpy().reshape(len(rows), -1)
    assert words.shape[1] == 13
    bits = (words.view(np.uint32)[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    _eq(bits.reshape(len(rows), -1)[:, :400].astype(bool), rows)
    assert rows[:, 256:].any()  # the words past the kernels' 256 cells are used


def test_batch_env_builds_and_steps_a_400_cell_board():
    """``make_collect_batch(CollectConfig(size=20), 4, device="cpu")`` resets
    and steps, with the JAX batch env's obs shape (4, 20, 20, 3); the episode
    rollout runs such a board too, with every ball of its plan on each fresh
    board."""
    _, tcfg = _cfgs(**BIG)
    env = make_collect_batch(tcfg, 4, device="cpu")
    states, obs = env.reset(seed=0)
    assert obs.shape == (4, 20, 20, 3) and obs.dtype == torch.uint8
    states, obs, rewards, term, trunc = env.step(states, torch.zeros((4, 2), dtype=torch.int32))
    assert obs.shape == (4, 20, 20, 3) and rewards.shape == (4, 2)
    assert ((states.grid_obj == tcollect.AGENT).sum(1) == 2).all()
    _, rcfg = _cfgs(**BIG_RESPAWN)
    roll = tslab.make_collect_episode_rollout(rcfg, 4, device="cpu", chunk=4)
    states, _ = roll.reset(seed=1)
    states, m = roll(states, 20)
    assert int(m["episodes"]) == 8
    assert ((states.grid_obj == tcollect.BALL).sum(1) == rcfg.num_balls).all()
