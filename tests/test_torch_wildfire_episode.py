"""The port's Wildfire episode path on the CPU: ``ms_spec`` (K steps with
the auto-reset) against the eager JAX episode math (``_ms_math`` in its
pre-drawn tuple form, adj = tril = None) bit for bit, K steps at once
against K one-step chunks, the kernel's fresh board walked as the kernel
walks it, and ``make_wildfire_episode_rollout``'s
counter-based draws, invariants and statistics against the JAX episode
rollout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_multigrid_tpu.envs import wildfire as jwf
from gym_multigrid_tpu.ops import pallas_wildfire as jpw
from gym_multigrid_tpu_torch.envs import wildfire as twf
from gym_multigrid_tpu_torch.ops import philox
from gym_multigrid_tpu_torch.ops import wildfire_slab as tslab

torch.set_num_threads(1)

MAIN = dict(size=16, max_steps=100)
FOUR = dict(size=10, num_agents=4, agents_index=(1, 2, 4, 5), step_penalty=0.01)


def _cfgs(kw=MAIN, **over):
    kw = {**kw, **over}
    return jwf.WildfireConfig(**kw), twf.WildfireConfig(**kw)


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _inputs(t, B, K, seed):
    """Fresh start boards, step and extinguished counts, running returns,
    action ids -2..6 and the step's and the fresh boards' uniforms, all
    made with numpy."""
    rng = np.random.default_rng(seed)
    A = t.n_agents
    cells, pos = (x.numpy() for x in tslab.reset_spec(
        t, torch.from_numpy(rng.random((B, twf.reset_rnd_width(t)), dtype=np.float32))))
    sc = rng.integers(0, t.max_steps, B).astype(np.int32)
    ext = rng.integers(0, 5, B).astype(np.int32)
    run = (rng.random(B, dtype=np.float32) - np.float32(0.5)).astype(np.float32)
    acts = rng.integers(-2, 7, (K, B, A)).astype(np.int32)
    rnd_step = rng.random((K, B, twf.step_rnd_width(t)), dtype=np.float32)
    rnd_reset = rng.random((K, B, twf.reset_rnd_width(t)), dtype=np.float32)
    return cells, pos, sc, ext, run, acts, rnd_step, rnd_reset


def _torch(args):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in args]


@pytest.mark.parametrize("kw", [MAIN, FOUR], ids=["main", "four_agents"])
def test_ms_spec_matches_jax_episode_math(kw):
    """The eager ``_ms_math`` on the tuple form of the same draws (the
    actions as floats, then per step the step's and the fresh board's
    uniforms): state, running returns and the per-env sums bit for bit.
    The eager JAX ops round every product and sum on its own, so the team
    reward needs no FMA bound here.  Episodes end inside K (max_steps 4),
    so the auto-reset runs."""
    jcfg, tcfg = _cfgs(kw, max_steps=4)
    t = tslab.make_wildfire_slab(tcfg, "cpu").t
    B, K = 12, 10
    args = _inputs(t, B, K, seed=t.n_agents)
    cells, pos, sc, ext, run, acts, rnd_step, rnd_reset = args
    draws = (jnp.asarray(acts.transpose(1, 0, 2).astype(np.float32)),
             jnp.asarray(np.concatenate([rnd_step, rnd_reset], axis=2).transpose(1, 0, 2)))
    want = jpw._ms_math(
        jwf.wf_tables(jcfg), K, *(jnp.asarray(x) for x in (cells, pos, sc[:, None], ext[:, None],
                                                           run[:, None])),
        draws, None, None,
    )
    got = tslab.ms_spec(t, K, *_torch(args))
    w_cells, w_pos, *w_rows = want
    _eq(got[0], w_cells)
    _eq(got[1], w_pos)
    for g, w in zip(got[2:], w_rows):
        assert g.shape == (B,)
        _eq(g, np.asarray(w)[:, 0])
    assert int(got[7].sum()) > B  # every env ended an episode, most more than one


def test_k_steps_equal_k_one_step_chunks():
    """One call of K steps and K chained calls of one step give the same
    state bit for bit, and the same sums: a one-step chunk's sums are its
    step's terms, added to the running totals in the same order."""
    _, tcfg = _cfgs(FOUR, max_steps=3)
    t = tslab.make_wildfire_slab(tcfg, "cpu").t
    B, K = 12, 8
    args = _torch(_inputs(t, B, K, seed=5))
    want = tslab.ms_spec(t, K, *args)
    state = args[:5]
    rew, ep = torch.zeros(B), torch.zeros(B)
    eps = torch.zeros(B, dtype=torch.int32)
    for k in range(K):
        out = tslab.ms_spec(t, 1, *state, *(x[k:k + 1] for x in args[5:]))
        state = out[:5]
        rew, ep, eps = rew + out[5], ep + out[6], eps + out[7]
    for g, w in zip((*state, rew, ep, eps), want):
        assert torch.equal(g, w)


def _kernel_fresh_board(t, u):
    """The kernel's fresh_board (csrc/wildfire_step.cu) for one env, in
    float32: trees by one compare a cell, each fire in the word where the
    running popcount over the 32-cell words passes its pick and at the
    n-th set bit of that word, the agents by picks::pick_untaken."""
    f32, C = np.float32, t.n_cells

    def floor_pick(v, m):
        return min(int(f32(v) * f32(m)), m - 1)

    def nth_set_bit(m, n):  # the binary search the kernel runs
        at = 0
        for half in (16, 8, 4, 2, 1):
            c = bin(m & ((1 << half) - 1)).count("1")
            if n >= c:
                n, m, at = n - c, m >> half, at + half
        return at

    tree = [bool(u[c] < f32(t.tree_density)) for c in range(C)]
    cells = [twf.TREE if x else twf.EMPTY for x in tree]
    words = [sum(1 << b for b in range(32) if 32 * k + b < C and tree[32 * k + b])
             for k in range(-(-C // 32))]
    for j in range(t.n_fires):
        counts = [bin(w).count("1") for w in words]
        if sum(counts) == 0:
            break
        r = floor_pick(u[C + j], sum(counts))
        k = next(i for i in range(len(words)) if r < sum(counts[:i + 1]))
        bit = nth_set_bit(words[k], r - sum(counts[:k]))
        cells[32 * k + bit] = twf.FIRE
        words[k] &= ~(1 << bit)
    pos, taken = [], []
    for i in range(t.n_agents):
        x = floor_pick(u[C + t.n_fires + i], C - i) if C - i > 0 else 0
        for c in sorted(taken):
            if c <= x:
                x += 1
        taken.append(x)
        pos += [x % t.width, x // t.width]
    return cells, pos


@pytest.mark.parametrize("kw", [dict(size=10, num_agents=4, agents_index=(1, 2, 4, 5)),
                                dict(size=20, num_initial_fires=5, tree_density=0.05)],
                         ids=["10x10_four_agents", "20x20_few_trees"])
def test_kernel_fresh_board_equals_reset_spec(kw):
    """The fresh board as the kernel forms it equals ``reset_spec`` on the
    same uniforms, boards with fewer trees than fires included."""
    _, tcfg = _cfgs(kw)
    t = tslab.make_wildfire_slab(tcfg, "cpu").t
    rng = np.random.default_rng(3)
    u = rng.random((64, twf.reset_rnd_width(t)), dtype=np.float32)
    u[:8, :t.n_cells] = np.where(rng.random((8, t.n_cells)) < 0.99, 0.99, 0.01)
    cells, pos = tslab.reset_spec(t, torch.from_numpy(u))
    for b in range(len(u)):
        got_cells, got_pos = _kernel_fresh_board(t, u[b])
        assert got_cells == cells[b].tolist(), b
        assert got_pos == pos[b].tolist(), b
    assert ((cells == twf.TREE).sum(1) + (cells == twf.FIRE).sum(1) < t.n_fires).any()


def _rollout(n, kw=MAIN, chunk=8, **over):
    return tslab.make_wildfire_episode_rollout(_cfgs(kw, **over)[1], n, device="cpu",
                                               chunk=chunk)


def test_episode_rollout_draws_one_chunk_at_a_time_from_the_generator():
    """The rollout equals ``ms_spec`` on the draws of its counter-based
    generator (``ops/philox.py``) in the rollout's order: the first reset
    from its own counters, then chunk by chunk at the running step count,
    with a partial last chunk."""
    n, steps, chunk = 6, 11, 4
    roll = _rollout(n, chunk=chunk, max_steps=5)
    start, _ = roll.reset(seed=5)
    states, m = roll(start, steps)
    slab, t = roll.slab, roll.slab.t
    key, picks = philox.key_of(5), t.n_fires + t.n_agents
    first = tslab.reset_batch(slab, n, rnd=philox.first_reset_draws(key, n, t.n_cells, picks,
                                                                      "cpu"))
    assert torch.equal(first.cells, start.cells) and torch.equal(first.agent_pos, start.agent_pos)
    state = (start.cells.reshape(n, -1), start.agent_pos.reshape(n, -1), start.step_count,
             start.extinguished, torch.zeros(n))
    rew, ep, eps = torch.zeros(()), torch.zeros(()), torch.zeros((), dtype=torch.int32)
    for k0 in range(0, steps, chunk):
        K = min(chunk, steps - k0)
        draws = philox.episode_draws(key, torch.arange(k0, k0 + K), n, t.n_agents, t.n_cells,
                                     picks, "cpu")
        out = tslab.ms_spec(t, K, *state, *draws)
        state = out[:5]
        rew, ep, eps = rew + out[5].sum(), ep + out[6].sum(), eps + out[7].sum(dtype=torch.int32)
    assert roll.step == steps
    assert torch.equal(states.cells.reshape(n, -1), state[0])
    assert torch.equal(states.extinguished, state[3])
    for got, want in ((m["run_return"], state[4]), (m["reward_sum"], rew),
                      (m["ep_return_sum"], ep), (m["episodes"], eps)):
        assert torch.equal(got, want)


def test_episode_rollout_invariants():
    """Cells stay empty, tree, fire or burnt, agents on the board and
    apart, fresh boards where the step count is 0 hold their fires, and
    the metrics are consistent across two calls."""
    n = 16
    roll = _rollout(n, FOUR, chunk=6, max_steps=10)
    states, obs = roll.reset(seed=2)
    assert obs.shape == (n, 10, 10, 3) and obs.dtype == torch.uint8
    runs = []
    for _ in range(2):
        states, m = roll(states, 15, run_return=runs[-1]["run_return"] if runs else None)
        runs.append(m)
        assert ((states.cells >= 0) & (states.cells <= 3)).all()
        pos = states.agent_pos
        assert ((pos >= 0) & (pos < 10)).all()
        key = pos[:, :, 0] * 16 + pos[:, :, 1]
        assert not (key[:, :, None] == key[:, None, :]).triu(diagonal=1).any()
        assert (states.step_count < roll.cfg.max_steps).all()
        fresh = states.step_count == 0
        assert (states.extinguished[fresh] == 0).all()
        assert int(m["episodes"]) > n and m["episodes"].dtype == torch.int32
    reward = float(runs[0]["reward_sum"]) + float(runs[1]["reward_sum"])
    finished = float(runs[0]["ep_return_sum"]) + float(runs[1]["ep_return_sum"])
    # The same rewards summed in another order: float32 rounding only.
    assert finished + float(runs[1]["run_return"].sum()) == pytest.approx(reward, rel=1e-5)


def test_episode_length_and_reward_agree_with_jax_episode_rollout():
    """Mean episode length and team reward per env-step over eight
    independent runs a side, against JAX's
    ``make_wildfire_episode_rollout(rnd_mode="packed")`` (exact float32
    thresholds, as the port's): the two draw their own numbers, so they
    agree in distribution; each mean within 5 standard errors of the
    other."""
    n, steps, runs = 32, 60, 8
    jcfg, tcfg = _cfgs(MAIN, max_steps=25)
    # One step a JAX chunk: the chunk's steps unroll, and compiling them is
    # most of the test's time.
    jroll = jax.jit(lambda s, k: jpw.make_wildfire_episode_rollout(
        jcfg, chunk=1, rnd_mode="packed")(s, k, steps))
    roll = tslab.make_wildfire_episode_rollout(tcfg, n, device="cpu", chunk=30)
    want, got = [], []
    for seed in range(runs):
        states, _ = roll.reset(seed=seed)
        # JAX starts from the same fresh states (its own batch reset costs
        # more to compile than the rest of the test).
        jstates = jwf.WildfireState(
            **{f: jnp.asarray(getattr(states, f).numpy())
               for f in ('cells', 'agent_pos', 'step_count', 'extinguished')},
            key=jax.random.split(jax.random.PRNGKey(seed), n))
        jstates, jm = jroll(jstates, jax.random.PRNGKey(100 + seed))
        states, m = roll(states, steps)
        for out, sc, metrics in ((want, jstates.step_count, jm), (got, states.step_count, m)):
            # From fresh states every step not in a running episode belongs
            # to a finished one.
            length = float((steps - np.asarray(sc)).sum()) / int(metrics["episodes"])
            out.append((length, float(metrics["reward_sum"]) / (n * steps)))
    want, got = np.asarray(want), np.asarray(got)
    for i, name in enumerate(("episode length", "reward per env-step")):
        se = np.sqrt(want[:, i].var(ddof=1) / runs + got[:, i].var(ddof=1) / runs)
        assert abs(want[:, i].mean() - got[:, i].mean()) < 5 * se, (name, want[:, i], got[:, i])


def test_no_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tslab.make_wildfire_episode_rollout(_cfgs()[1], 8)
    with pytest.raises(ValueError, match="chunk"):
        tslab.make_wildfire_episode_rollout(_cfgs()[1], 8, device="cpu", chunk=0)
