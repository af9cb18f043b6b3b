"""The counter-based draws of the port's Wildfire episode path on the CPU:
``ops/philox.py``'s Philox4x32-10 against the Random123 known-answer
vectors, its counter layout walked as ``csrc/wildfire_step.cu`` walks it,
the header's constants against the module's, ``ms_philox_spec`` against
the eager JAX episode math (``_ms_math``, pre-drawn tuple form) fed the same
uniforms, chunking, and the rollout's reproducibility from a seed."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_multigrid_tpu.envs import wildfire as jwf
from gym_multigrid_tpu.ops import pallas_wildfire as jpw
from gym_multigrid_tpu_torch.envs import wildfire as twf
from gym_multigrid_tpu_torch.ops import _build, philox
from gym_multigrid_tpu_torch.ops import wildfire_slab as tslab

torch.set_num_threads(1)

MAIN = dict(size=16, max_steps=100)
FOUR = dict(size=10, num_agents=4, agents_index=(1, 2, 4, 5), step_penalty=0.01)
# 5x5: one partial word of 32 cells, three initial fires.
NARROW = dict(size=5, num_initial_fires=3)

# Random123's known-answer vectors of Philox4x32-10 (kat_vectors):
# (counter, key, output).
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


def _cfgs(kw, **over):
    kw = {**kw, **over}
    return jwf.WildfireConfig(**kw), twf.WildfireConfig(**kw)


@pytest.mark.parametrize("case", range(len(KAT)))
def test_philox_matches_the_known_answer_vectors(case):
    ctr, key, want = KAT[case]
    got = philox.philox(*ctr, key)
    assert [int(w) for w in got] == list(want)
    # The same words from a batch of counters, on every element.
    batch = philox.philox(*(torch.full((3, 2), c, dtype=torch.int64) for c in ctr), key)
    for g, w in zip(batch, want):
        assert bool((g == w).all())


def test_words_become_exact_uniforms_and_action_ids():
    x = torch.tensor([0, 255, 256, 0x80000000, 0xFFFFFFFF], dtype=torch.int64)
    u = philox.uniform(x)
    assert u.dtype == torch.float32
    assert u.tolist() == [0.0, 0.0, 2.0 ** -24, 0.5, 1.0 - 2.0 ** -24]
    a = philox.action(torch.tensor([0, 0x33333333, 0x33333334, 0xFFFFFFFF], dtype=torch.int64))
    assert a.dtype == torch.int32 and a.tolist() == [0, 0, 1, 4]
    assert [philox.signed(w) for w in (0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF)] == [
        0, 0x7FFFFFFF, -0x80000000, -1]
    assert philox.key_of(7) == (7, 0) and philox.key_of(5 << 32 | 9) == (9, 5)
    with pytest.raises(ValueError, match="seed"):
        philox.key_of(-1)


def test_the_counter_layout_is_the_kernels():
    """Walked one scalar call at a time as the kernel makes them: lane l of
    env b's warp draws its cells l + 32 k, k = 4 g .. 4 g + 3, from word
    k % 4 of counter (32 g + l, b, s, CELLS); the actions are the words of
    (0, b, s, ACTIONS), the move order word 0 of (0, b, s, ORDER), pick i
    word i % 4 of (i // 4, b, s, PICKS); all at the global step s."""
    key, B, A, C, picks = (123, 456), 3, 4, 300, 6
    steps = torch.tensor([7, 2**32 + 9])  # the step counter wraps at 2**32
    acts, rnd_step, rnd_reset = philox.episode_draws(key, steps, B, A, C, picks, "cpu")
    for si, s in enumerate(steps.tolist()):
        s &= philox.MASK32
        for b in range(B):
            words = [int(w) for w in philox.philox(0, b, s, philox.ACTIONS, key)]
            assert acts[si, b].tolist() == [(w * 5) >> 32 for w in words[:A]]
            order = int(philox.philox(0, b, s, philox.ORDER, key)[0])
            assert rnd_step[si, b, 0] == (order >> 8) * 2.0 ** -24
            for c in (0, 31, 32, 127, 128, 200, C - 1):
                lane, k = c % 32, c // 32
                for stream, row, base in ((philox.CELLS, rnd_step, 1), (philox.TREES, rnd_reset, 0)):
                    w = int(philox.philox(32 * (k // 4) + lane, b, s, stream, key)[k % 4])
                    assert row[si, b, base + c] == (w >> 8) * 2.0 ** -24, (c, stream)
            for i in range(picks):
                w = int(philox.philox(i // 4, b, s, philox.PICKS, key)[i % 4])
                assert rnd_reset[si, b, C + i] == (w >> 8) * 2.0 ** -24


def test_the_first_reset_has_streams_of_its_own():
    key, B, C = (5, 0), 2, 40
    first = philox.first_reset_draws(key, B, C, 3, "cpu")
    _, _, at_step0 = philox.episode_draws(key, torch.tensor([0]), B, 1, C, 3, "cpu")
    assert first.shape == (B, C + 3) and not torch.equal(first, at_step0[0])
    w = int(philox.philox(1, 1, 0, philox.FIRST_TREES, key)[0])
    assert first[1, 1] == (w >> 8) * 2.0 ** -24


def test_the_kernel_header_holds_the_same_constants():
    text = (_build.CSRC / "philox.cuh").read_text()
    consts = {name: int(v, 16 if v.startswith("0x") else 10)
              for name, v in re.findall(r"(k\w+) = (0x[0-9A-Fa-f]+|\d+)u?", text)}
    assert (consts["kM0"], consts["kM1"]) == (philox.M0, philox.M1)
    assert (consts["kW0"], consts["kW1"]) == (philox.W0, philox.W1)
    assert consts["kRounds"] == philox.ROUNDS
    for name in ("ACTIONS", "ORDER", "CELLS", "TREES", "PICKS"):
        assert consts["k" + name.title()] == getattr(philox, name), name


def _start(t, B, seed):
    """Fresh boards from a numpy draw, random step and extinguished counts
    and running returns."""
    rng = np.random.default_rng(seed)
    cells, pos = tslab.reset_spec(t, torch.from_numpy(
        rng.random((B, twf.reset_rnd_width(t)), dtype=np.float32)))
    sc = torch.from_numpy(rng.integers(0, t.max_steps, B).astype(np.int32))
    ext = torch.from_numpy(rng.integers(0, 5, B).astype(np.int32))
    run = torch.from_numpy((rng.random(B, dtype=np.float32) - np.float32(0.5)).astype(np.float32))
    return cells, pos, sc, ext, run


@pytest.mark.parametrize("kw", [MAIN, FOUR, NARROW], ids=["main", "four_agents", "narrow"])
def test_ms_philox_spec_matches_jax_episode_math_on_its_draws(kw):
    """``ms_philox_spec`` against the eager ``_ms_math`` fed the uniforms
    that ``ops/philox.py`` forms for the same steps: state, running returns
    and per-env sums bit for bit (the eager JAX ops round every product on
    its own, so the reward needs no FMA bound).  Episodes end inside K
    (max_steps 4), so the fresh boards are drawn."""
    jcfg, tcfg = _cfgs(kw, max_steps=4)
    t = tslab.make_wildfire_slab(tcfg, "cpu").t
    B, K, key, step0 = 8, 9, philox.key_of(2024), 40
    state = _start(t, B, seed=t.n_agents)
    acts, rnd_step, rnd_reset = philox.episode_draws(
        key, torch.arange(step0, step0 + K), B, t.n_agents, t.n_cells, tslab.fresh_picks(t), "cpu")
    draws = (jnp.asarray(acts.numpy().transpose(1, 0, 2).astype(np.float32)),
             jnp.asarray(np.concatenate([rnd_step.numpy(), rnd_reset.numpy()], axis=2)
                         .transpose(1, 0, 2)))
    cells, pos, sc, ext, run = (x.numpy() for x in state)
    want = jpw._ms_math(jwf.wf_tables(jcfg), K,
                        *(jnp.asarray(x) for x in (cells, pos, sc[:, None], ext[:, None],
                                                   run[:, None])), draws, None, None)
    got = tslab.ms_philox_spec(t, K, *state, key, step0)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in zip(got[2:], want[2:]):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:, 0])
    assert int(got[7].sum()) > B


def test_three_chunks_of_8_equal_one_of_24():
    """The draws follow the global step, not the chunk: three chunks of 8
    from steps 0, 8 and 16 give one chunk of 24's state and, summed, its
    per-env sums bit for bit (a chunk's sums add its steps' terms in
    order, and the running return carries over)."""
    _, tcfg = _cfgs(FOUR, max_steps=5)
    t = tslab.make_wildfire_slab(tcfg, "cpu").t
    B, key = 6, philox.key_of(77)
    start = _start(t, B, seed=3)
    want = tslab.ms_philox_spec(t, 24, *start, key, 0)
    state, sums = start, [torch.zeros(B), torch.zeros(B), torch.zeros(B, dtype=torch.int32)]
    for k0 in (0, 8, 16):
        out = tslab.ms_philox_spec(t, 8, *state, key, k0)
        state = out[:5]
        sums = [s + o for s, o in zip(sums, out[5:])]
    for g, w in zip((*state, sums[2]), (*want[:5], want[7])):
        assert torch.equal(g, w)
    # The float sums of three chunks are the same terms added from 0 three
    # times; an episode's return is summed in one chunk or carried over.
    for g, w in zip(sums[:2], want[5:7]):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)


def test_rollout_chunking_changes_nothing():
    _, tcfg = _cfgs(MAIN, max_steps=10)
    n = 5
    out = []
    for chunk in (8, 24):
        roll = tslab.make_wildfire_episode_rollout(tcfg, n, device="cpu", chunk=chunk)
        states, _ = roll.reset(seed=11)
        states, m = roll(states, 24)
        out.append((states, m))
        assert roll.step == 24
    (s8, m8), (s24, m24) = out
    for f in ("cells", "agent_pos", "step_count", "extinguished"):
        assert torch.equal(getattr(s8, f), getattr(s24, f))
    assert torch.equal(m8["run_return"], m24["run_return"])
    assert torch.equal(m8["episodes"], m24["episodes"])


def test_the_cpu_rollout_is_reproducible_from_a_seed():
    """``reset(seed)`` fixes the whole trajectory: the same seed gives the
    same fresh boards, states and metrics over two calls, another seed
    other boards."""
    _, tcfg = _cfgs(FOUR, max_steps=10)
    roll = tslab.make_wildfire_episode_rollout(tcfg, 6, device="cpu", chunk=7)
    runs = []
    for seed in (3, 3, 4):
        states, obs = roll.reset(seed)
        first = states.cells.clone()
        states, m1 = roll(states, 20)
        states, m2 = roll(states, 20, run_return=m1["run_return"])
        runs.append((first, states, m2))
    (f0, s0, m0), (f1, s1, m1), (f2, _, _) = runs
    assert torch.equal(f0, f1) and not torch.equal(f0, f2)
    for f in ("cells", "agent_pos", "step_count", "extinguished"):
        assert torch.equal(getattr(s0, f), getattr(s1, f))
    for k in m0:
        assert torch.equal(m0[k], m1[k])
