"""Collect with any number of agents on the CPU: the per-env functions
(``make_collect``) and the batch env's plain route beyond the kernels' one
or two agents, held to JAX's ``make_collect`` bit for bit given its own
move order, to ``step_spec`` bit for bit at one and two agents, and in
distribution where the two packages draw their own randomness."""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from gym_multigrid_tpu.envs import collect as jcollect
from gym_multigrid_tpu.parallel.vector import make_collect_batch as jax_make_batch
from gym_multigrid_tpu_torch.envs import collect as tcollect
from gym_multigrid_tpu_torch.envs.collect import AGENT, BALL, WALL
from gym_multigrid_tpu_torch.ops import collect_slab as tslab
from gym_multigrid_tpu_torch.parallel.vector import make_collect_batch

torch.set_num_threads(1)

THREE = dict(agents_index=(3, 5, 1))
RESPAWN3 = dict(agents_index=(3, 5, 1), layout="quadrants_respawn", respawn=True, max_steps=50)
# Small boards with many balls: pickups, blocked moves and (without
# respawn) the terminal step all happen within a few steps.
SMALL = {
    3: dict(size=7, num_balls=9, agents_index=(3, 5, 1), max_steps=40),
    4: dict(size=7, num_balls=9, agents_index=(3, 5, 1, 2), layout="even", max_steps=40),
}
FIELDS = ("grid_obj", "grid_color", "grid_slot", "agent_pos", "collected",
          "step_count", "info_counts")


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def test_three_agents_build_reset_and_step_on_the_cpu():
    """The fault's input: three agents, four envs, on the CPU.  The obs has
    JAX's shape, and a step returns per-agent rewards."""
    env = make_collect_batch(tcollect.CollectConfig(**THREE), 4, device="cpu")
    assert not env.slab.kernel
    jenv = jax_make_batch(jcollect.CollectConfig(**THREE), 4)
    _, jobs = jax.eval_shape(jenv.reset, jax.random.PRNGKey(0))
    states, obs = env.reset(seed=0)
    assert tuple(obs.shape) == tuple(jobs.shape) == (4, 10, 10, 3)
    states, obs, rewards, term, trunc = env.step(states, torch.zeros((4, 3), dtype=torch.int32))
    assert tuple(obs.shape) == (4, 10, 10, 3) and obs.dtype == torch.uint8
    assert tuple(rewards.shape) == (4, 3) and term.shape == trunc.shape == (4,)
    assert ((states.grid_obj == AGENT).sum(1) == 3).all()


@pytest.mark.parametrize("n_agents", [3, 4])
def test_step_fn_equals_jax_given_its_permutation(n_agents):
    """From JAX's reset, each step of the port's ``step_fn`` given the
    permutation JAX's ``step_fn`` draws from the state's key
    (``split(state.key)``, then ``permutation``) equals JAX's step: planes,
    positions, counters, rewards, flags and the obs, bit for bit, until
    the episode terminates.  The ids include -1, 4 and 7 (a no-op)."""
    kw = SMALL[n_agents]
    j_reset, j_step, _ = jcollect.make_collect(jcollect.CollectConfig(**kw))
    j_step = jax.jit(j_step)
    _, t_step, t_encode = tcollect.make_collect(tcollect.CollectConfig(**kw), device="cpu")
    rng = np.random.default_rng(n_agents)
    js = j_reset(jax.random.PRNGKey(n_agents))
    ts = tcollect.CollectState(**{f: torch.tensor(np.asarray(getattr(js, f))) for f in FIELDS})
    _eq(t_encode(ts), jcollect.make_collect(jcollect.CollectConfig(**kw))[2](js))
    picked, terminated = 0, False
    for _ in range(150):
        acts = rng.choice(np.array([0, 1, 2, 3, 0, 1, 2, 3, -1, 4, 7], np.int32), n_agents)
        perm = np.asarray(jax.random.permutation(jax.random.split(js.key)[1], n_agents))
        js, jobs, jrew, jterm, jtrunc, jinfo = j_step(js, jnp.asarray(acts))
        ts, tobs, trew, tterm, ttrunc, tinfo = t_step(ts, torch.tensor(acts), perm=torch.tensor(perm))
        for f in FIELDS:
            _eq(getattr(ts, f), getattr(js, f))
        _eq(tobs, jobs)
        _eq(trew, jrew)
        _eq(tinfo, jinfo)
        assert bool(tterm) == bool(jterm) and bool(ttrunc) == bool(jtrunc)
        picked = int(ts.collected)
        if bool(jterm):
            terminated = True
            break
    assert picked > 3 and terminated


@pytest.mark.parametrize(
    "kw",
    [dict(layout="quadrants_respawn", respawn=True, max_steps=50),
     dict(agents_index=(3,), layout="even", respawn=True, max_steps=30)],
    ids=["two_agents_respawn", "one_agent_respawn"],
)
def test_any_agent_route_equals_the_kernel_route(kw):
    """With one or two agents, the plain route of the batch glue
    (``step_spec`` and ``reset_rows``, no kernel wrapper) equals the kernel
    route (the wrappers, ``step_spec`` on the CPU) on the same uniforms,
    and the any-agent ``step_perm`` given the order ``step_spec`` takes from
    ``rnd[:, 0] < 0.5`` (agent 1 first) and its respawn uniforms
    ``rnd[:, 1:]`` equals both, over chained steps with masked resets:
    states, obs, rewards, flags and counters bit for bit, respawns
    included.  A move order ``perm`` is refused for these agent counts."""
    cfg = tcollect.CollectConfig(**kw)
    kernel = tslab.make_collect_slab(cfg, "cpu")
    plain = dataclasses.replace(kernel, kernel=False)
    assert kernel.kernel and kernel.step_draws == plain.step_draws == 3
    A, B = cfg.num_agents, 64
    g = torch.Generator().manual_seed(A)
    rnd = torch.rand((B, kernel.reset_draws), generator=g)
    s, p = tslab.reset_batch(kernel, B, rnd=rnd), tslab.reset_batch(plain, B, rnd=rnd)
    respawned = 0
    for _ in range(40):
        acts = torch.randint(-1, 8, (B, A), generator=g, dtype=torch.int32)
        rnd = torch.rand((B, 3), generator=g)
        perm = torch.arange(A).expand(B, A)
        if A == 2:
            perm = torch.where(rnd[:, :1] < 0.5, perm.flip(1), perm)
        want = tslab.step_batch(kernel, s, acts, rnd=rnd)
        got = tslab.step_batch(plain, p, acts, rnd=rnd)
        for f in FIELDS:
            _eq(getattr(got[0], f), getattr(want[0], f))
        for x, y in zip(got[1:], want[1:]):
            _eq(x, y)
        planes = (p.grid_obj, p.grid_color, p.grid_slot, p.agent_pos.reshape(B, -1))
        by_perm = tslab.step_perm(kernel.t, *planes, acts, perm, rnd[:, 1:1 + A],
                                  kernel.respawn_rects)
        for x, y in zip(by_perm, (want[0].grid_obj, want[0].grid_color, want[0].grid_slot,
                                  want[0].agent_pos.reshape(B, -1))):
            _eq(x, y)
        done = want[3] | want[4]
        rnd = torch.rand((B, kernel.reset_draws), generator=g)
        s = tslab.reset_batch(kernel, B, rnd=rnd, done=done, states=want[0])
        p = tslab.reset_batch(plain, B, rnd=rnd, done=done, states=got[0])
        respawned += int((s.grid_slot >= kernel.t.respawn_slot_base).sum())
    assert respawned > 0
    for f in FIELDS:
        _eq(getattr(p, f), getattr(s, f))
    with pytest.raises(ValueError, match="perm is taken for agent counts other than"):
        tslab.step_batch(plain, p, acts, rnd=rnd[:, :3], perm=perm)


def test_move_order_is_a_fair_permutation_like_jax():
    """Every one of the 3! orders is equally likely: chi-square over the
    orders of the port's ``move_order`` on uniform keys, and of JAX's
    ``permutation`` as its ``step_fn`` draws it; and the two agree with
    each other (a two-sample chi-square)."""
    n, A = 12000, 3
    orders = {p: i for i, p in enumerate(itertools.permutations(range(A)))}
    g = torch.Generator().manual_seed(0)
    port = tslab.move_order(torch.rand((n, A), generator=g)).numpy()
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    jax_perm = np.asarray(jax.vmap(lambda k: jax.random.permutation(jax.random.split(k)[1], A))(keys))
    counts = []
    for perms in (port, jax_perm):
        c = np.bincount([orders[tuple(p)] for p in perms], minlength=len(orders))
        assert stats.chisquare(c).pvalue > 1e-3, c
        counts.append(c)
    assert stats.chi2_contingency(np.array(counts)).pvalue > 1e-3, counts


def test_batch_step_draws_its_order_from_the_keys():
    """On the plain route ``step_batch`` takes the move order from the
    first A uniforms (``move_order``) and the respawns from the last A:
    the same uniforms through ``step_perm`` give the same step."""
    cfg = tcollect.CollectConfig(**RESPAWN3)
    slab = tslab.make_collect_slab(cfg, "cpu")
    g = torch.Generator().manual_seed(3)
    s = tslab.reset_batch(slab, 32, generator=g)
    acts = torch.randint(0, 4, (32, 3), generator=g, dtype=torch.int32)
    rnd = torch.rand((32, slab.step_draws), generator=g)
    assert slab.step_draws == 6
    planes = (s.grid_obj, s.grid_color, s.grid_slot, s.agent_pos.reshape(32, -1))
    want = tslab.step_perm(slab.t, *planes, acts, tslab.move_order(rnd[:, :3]), rnd[:, 3:],
                           slab.respawn_rects)
    got, *_ = tslab.step_batch(slab, s, acts, rnd=rnd)
    for x, y in zip((got.grid_obj, got.grid_color, got.grid_slot,
                     got.agent_pos.reshape(32, -1)), want):
        _eq(x, y)


def test_respawn_conserves_balls_in_their_partitions():
    """Three agents on the respawn config: a pickup's ball comes back in
    its colour's partition, so the count only drops by a respawn landing
    on the vacated cell, never by more than the step's pickups, and every
    ball lies in its colour's rect."""
    env = make_collect_batch(tcollect.CollectConfig(**RESPAWN3), 64, device="cpu")
    states, _ = env.reset(seed=1)
    rects = env.slab.respawn_rects
    balls = (states.grid_obj == BALL).sum(1)
    assert (balls == 15).all()
    respawns = 0
    for _ in range(45):
        acts = torch.randint(0, 4, (64, 3), generator=env.generator, dtype=torch.int32)
        states, _, rewards, term, _ = env.step(states, acts)
        assert not term.any()
        now = (states.grid_obj == BALL).sum(1)
        pickups = (rewards > 0).sum(1)
        assert ((now <= balls) & (now >= balls - pickups)).all()
        balls = now
        for c in range(rects.shape[0]):
            of_c = (states.grid_obj == BALL) & (states.grid_color == c)
            assert not (of_c & ~rects[c]).any()
        respawns += int((states.grid_slot >= env.slab.t.respawn_slot_base).sum())
    assert respawns > 0


@pytest.mark.parametrize("layout", ["even", "quadrants", "rooms"])
def test_reset_places_balls_in_rects_and_agents_on_free_cells(layout):
    """Four agents: each planned ball in its placement rect, off the walls;
    each agent on a non-wall cell that holds an agent; on distinct cells
    with their colours where they are placed uniformly or fixed (the rooms
    layout draws from a five-cell pool with replacement, as JAX's does);
    and, placed uniformly, on empty cells: every ball still on the board.
    (Fixed agents overwrite what is there, as JAX's ``put_obj`` does.)"""
    cfg = tcollect.CollectConfig(agents_index=(3, 5, 1, 2), layout=layout)
    slab = tslab.make_collect_slab(cfg, "cpu")
    s = tslab.reset_batch(slab, 256, generator=torch.Generator().manual_seed(4))
    rects = slab.reset_arrays.ball_rects
    wall = slab.reset_arrays.wall
    ball = s.grid_obj == BALL
    assert not (ball & wall).any()
    for b in range(rects.shape[0]):
        at = ball & (s.grid_slot == b)
        assert not (at & ~rects[b]).any()
    pos = s.agent_pos.long()
    cell = pos[..., 1] * cfg.width + pos[..., 0]
    assert not wall[cell].any()
    assert (s.grid_obj.gather(1, cell) == AGENT).all()
    assert ((s.grid_obj == WALL) == wall).all()
    if layout != "rooms":
        assert (s.grid_color.gather(1, cell) == torch.tensor([3, 5, 1, 2])).all()
        assert ((s.grid_obj == AGENT).sum(1) == 4).all()
    if layout == "even":  # uniform agents take empty cells: no ball is lost
        assert (ball.sum(1) == len(slab.rt.ball_colors)).all()


def test_reward_rate_and_stomps_agree_with_jax_three_agents():
    """Random play on the three-agent respawn config, 45 steps: the port's
    reward per agent-step agrees with JAX's batch env (its
    ``vmap(step_one)`` route) within 0.03, and so does the mean count of
    balls left on a board (respawns stomped on the vacated cell lose
    theirs) within 0.4, over four standard errors of the difference."""
    n, steps = 128, 45
    jenv = jax_make_batch(jcollect.CollectConfig(**RESPAWN3), n)
    run = jax.jit(lambda s, k: jenv.rollout(s, k, steps))
    states, _ = jenv.reset(jax.random.PRNGKey(0))
    jstates, jm = run(states, jax.random.PRNGKey(100))
    env = make_collect_batch(tcollect.CollectConfig(**RESPAWN3), n, device="cpu")
    states, _ = env.reset(seed=0)
    states, m = env.rollout(states, steps)
    per = n * steps * 3
    rate = float(jm["reward_sum"]) / per, float(m["reward_sum"]) / per
    assert abs(rate[0] - rate[1]) < 0.03, rate
    balls = ((np.asarray(jstates.grid_obj) == jcollect.BALL).sum(1).mean(),
             float((states.grid_obj == BALL).sum(1).float().mean()))
    assert abs(balls[0] - balls[1]) < 0.4, balls
    assert balls[1] < 15  # stomps happen


def test_episode_rollout_returns_none_beyond_two_agents():
    assert tslab.make_collect_episode_rollout(
        tcollect.CollectConfig(**RESPAWN3), 4, device="cpu") is None
    assert tslab.make_collect_episode_rollout(
        tcollect.CollectConfig(agents_index=(3,), respawn=True), 4, device="cpu") is not None


def test_route_is_the_agent_count_and_kernels_still_refuse_three():
    """One or two agents take the kernel route; three take the plain one,
    also for a device off the CPU, where the kernel wrapper itself still
    refuses them."""
    assert tslab.make_collect_slab(tcollect.CollectConfig(), "cpu").kernel
    assert not tslab.make_collect_slab(tcollect.CollectConfig(**THREE), "meta").kernel
    slab = tslab.make_collect_slab(tcollect.CollectConfig(**THREE), "cpu")
    s = tslab.reset_batch(slab, 2, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="the Collect kernels take"):
        tslab.collect_step_slab(slab.t, s.grid_obj, s.grid_color, s.grid_slot,
                                s.agent_pos.reshape(2, -1), torch.zeros((2, 3), dtype=torch.int32),
                                torch.rand((2, 3)), slab.respawn_rects)


def test_per_env_functions_run_one_env():
    """``make_collect``/``cached_collect``: a reset of one env has no batch
    axis, the step returns per-agent rewards and a (W, H, 3) obs, the same
    seed gives the same episode, and the memo returns one object."""
    cfg = tcollect.CollectConfig(**SMALL[4])
    reset_fn, step_fn, encode_fn = tcollect.make_collect(cfg, device="cpu")
    runs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(7)
        s = reset_fn(g)
        assert tuple(s.grid_obj.shape) == (49,) and tuple(s.agent_pos.shape) == (4, 2)
        for _ in range(5):
            s, obs, rew, term, trunc, info = step_fn(s, torch.tensor([0, 1, 2, 3]), g)
        assert tuple(obs.shape) == (7, 7, 3) and tuple(rew.shape) == (4,)
        assert int(s.step_count) == 5
        runs.append(encode_fn(s))
    _eq(runs[0], runs[1])
    assert tcollect.cached_collect(cfg, "cpu") is tcollect.cached_collect(cfg, "cpu")
