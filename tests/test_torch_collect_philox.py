"""The Collect episode path on counter-based draws, on the CPU:
``ms_philox_spec`` (the plain version of the kernel entry
``collect_steps_philox``) against ``ms_spec`` and ``reset_spec`` on the
uniforms ``ops/philox.py`` forms, chunkings, the counters walked as the
kernel walks them, the header's stream constants, the packed board, the
wrapper's device rule, and the episode rollout against JAX's in
distribution."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_multigrid_tpu.envs import collect as jcollect
from gym_multigrid_tpu.ops import pallas_collect as jpc
from gym_multigrid_tpu_torch.envs import collect as tcollect
from gym_multigrid_tpu_torch.envs.collect import CollectConfig
from gym_multigrid_tpu_torch.ops import _build, philox
from gym_multigrid_tpu_torch.ops import collect_slab as tslab

torch.set_num_threads(1)

MAIN = dict(layout="quadrants_respawn", respawn=True, max_steps=50)
CONFIGS = {
    "main": MAIN,
    "single": dict(agents_index=(3,), layout="even", respawn=False, max_steps=100),
    "fixed_horizon": dict(layout="even", fixed_horizon=True, max_steps=50),
    "16x16": dict(size=16, num_balls=45, layout="quadrants_respawn", respawn=True,
                  max_steps=50),
    # 17 ball types: more reward slots and colors than the others.
    "17_types": dict(balls_index=tuple(range(17)), balls_reward=(1.0,) * 17, num_balls=17,
                     layout="even", respawn=True, max_steps=50),
}
# Agents from the pool, placed before the balls; short episodes.
ROOMS = dict(layout="rooms", respawn=True, max_steps=30)


def _start(kw, B, seed):
    """(slab, key, (p, pos, ret)): fresh boards from the first reset's
    counters, packed, and zero running rewards."""
    slab = tslab.make_collect_slab(CollectConfig(**kw), "cpu")
    key = philox.key_of(seed)
    s = tslab.reset_batch(slab, B, rnd=philox.collect_first_reset_draws(
        key, B, slab.reset_draws, "cpu"))
    A = slab.cfg.num_agents
    p = tslab.pack_planes(s.grid_obj, s.grid_color, s.grid_slot)
    return slab, key, (p, s.agent_pos.reshape(B, 2 * A), torch.zeros((B, A)))


def _reference(slab, K, state, key, step0, counts=None):
    """K steps by ``ms_spec`` one step at a time, each fed the step's
    ``COLLECT_ACTIONS`` and ``COLLECT_RND`` uniforms, and ``reset_spec`` on
    the ``COLLECT_FRESH`` uniforms after each step that ends an episode;
    each step's info counters added to ``counts`` where given."""
    p, pos, ret = state
    go, gc, gs = tslab.unpack_planes(p)
    B, A = ret.shape
    ra, max_steps = slab.reset_arrays, slab.cfg.max_steps
    for s in range(step0, step0 + K):
        acts, rnd = philox.collect_step_draws(key, torch.tensor([s]), B, A, "cpu")
        go, gc, gs, pos, ret, cnt = tslab.ms_spec(slab, go, gc, gs, pos, acts, rnd, ret)
        if counts is not None:
            counts += cnt
        if (s + 1) % max_steps == 0:
            u = philox.collect_fresh_draws(key, torch.tensor([s]), B, slab.reset_draws, "cpu")
            go, gc, gs, pos = tslab.reset_spec(slab.rt, ra.wall, ra.ball_rects, u[0])
    return tslab.pack_planes(go, gc, gs), pos, ret


@pytest.mark.parametrize("name", [*CONFIGS, "rooms"])
def test_ms_philox_spec_is_ms_spec_and_reset_spec_on_the_counters(name):
    """110 steps from step 20 (an episode end at steps 49 and 99, or 99 for
    the 100-step config, and for the rooms config 29, 59 and 89) as one
    ``ms_philox_spec`` call: bit-equal to the step-by-step reference."""
    kw = CONFIGS.get(name, ROOMS)
    slab, key, state = _start(kw, 24, seed=len(name))
    got = tslab.ms_philox_spec(slab, 110, *state, key, 20)
    want = _reference(slab, 110, state, key, 20)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert float(got[2].sum()) > 0, "no pickups"


@pytest.mark.parametrize("name", [*CONFIGS, "rooms"])
def test_ms_philox_spec_adds_ms_specs_info_counters(name):
    """``counts`` given to ``ms_philox_spec`` over 110 steps from step 20
    gains the step-by-step reference's info counters, added to what it
    held; the state is the one without ``counts``."""
    kw = CONFIGS.get(name, ROOMS)
    slab, key, state = _start(kw, 24, seed=len(name))
    width = slab.cfg.num_agents * slab.info_ids.shape[0]
    held = torch.arange(24 * width, dtype=torch.int32).reshape(24, width)
    got, want = held.clone(), held.clone()
    out = tslab.ms_philox_spec(slab, 110, *state, key, 20, counts=got)
    _reference(slab, 110, state, key, 20, counts=want)
    assert torch.equal(got, want) and int((got - held).sum()) > 0
    for g, w in zip(out, tslab.ms_philox_spec(slab, 110, *state, key, 20)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_chunkings_change_nothing(name):
    """100 steps from step 0 as 25 + 25 + 50, 50 + 50, 10 + 40 + 50 and
    30 + 70 (chunks that span an episode's end): equal boards, positions
    and reward sums, the step count passed on from chunk to chunk."""
    slab, key, start = _start(CONFIGS[name], 16, seed=3)
    results = []
    for chunks in ((25, 25, 50), (50, 50), (10, 40, 50), (30, 70)):
        state, step = start, 0
        for K in chunks:
            state = tslab.ms_philox_spec(slab, K, *state, key, step)
            step += K
        results.append(state)
    for other in results[1:]:
        for g, w in zip(other, results[0]):
            assert torch.equal(g, w)
    assert float(results[0][2].sum()) > 0


def test_counter_layout_is_the_kernels():
    """The draws of ``collect_step_draws`` and ``collect_fresh_draws``,
    walked word by word as ``collect_steps_philox`` forms them: actions
    from words 0 and 1 of index 0 of COLLECT_ACTIONS as ``x >> 30``, the
    three uniforms from words 0..2 of index 0 of COLLECT_RND, reset
    uniform i from word i % 4 of index i // 4 of COLLECT_FRESH (the first
    reset's of COLLECT_FIRST at step 0)."""
    key, B, A, n = philox.key_of(2026), 3, 2, 17
    steps = torch.tensor([0, 5, (1 << 32) + 7])
    acts, rnd = philox.collect_step_draws(key, steps, B, A, "cpu")
    fresh = philox.collect_fresh_draws(key, steps, B, n, "cpu")
    first = philox.collect_first_reset_draws(key, B, n, "cpu")
    for si, s in enumerate(steps.tolist()):
        s &= philox.MASK32
        for b in range(B):
            a = [int(w) for w in philox.philox(0, b, s, philox.COLLECT_ACTIONS, key)]
            assert acts[si, b].tolist() == [a[i] >> 30 for i in range(A)]
            u = [int(w) for w in philox.philox(0, b, s, philox.COLLECT_RND, key)]
            assert rnd[si, b].tolist() == [(u[j] >> 8) / (1 << 24) for j in range(3)]
            for i in range(n):
                w = int(philox.philox(i // 4, b, s, philox.COLLECT_FRESH, key)[i % 4])
                assert float(fresh[si, b, i]) == (w >> 8) / (1 << 24)
                if si == 0:
                    w = int(philox.philox(i // 4, b, 0, philox.COLLECT_FIRST, key)[i % 4])
                    assert float(first[b, i]) == (w >> 8) / (1 << 24)
    assert acts.dtype == torch.int32 and set(acts.unique().tolist()) <= {0, 1, 2, 3}


def test_kernel_header_holds_the_collect_streams():
    """``csrc/philox.cuh``'s Collect streams equal ``ops/philox.py``'s, come
    after Wildfire's seven and share none; its action map is ``x >> 30``."""
    text = (_build.CSRC / "philox.cuh").read_text()
    consts = dict((k, int(v)) for k, v in re.findall(r"(k\w+) = (\d+)u?\b", text))
    names = ("COLLECT_ACTIONS", "COLLECT_RND", "COLLECT_FRESH", "COLLECT_FIRST")
    for name in names:
        assert consts["k" + name.title().replace("_", "")] == getattr(philox, name), name
    streams = [getattr(philox, n) for n in names]
    assert min(streams) == 7 and len(set(streams)) == 4
    assert re.search(r"collect_action\(unsigned x\) \{ return \(int\)\(x >> 30\); \}", text)
    assert philox.NUM_COLLECT_ACTIONS == 4


def _packing(source):
    """(object mask, color shift, slot shift, slot mask) of a source's packed
    cell."""
    text = (_build.CSRC / source).read_text()
    consts = dict(re.findall(r"(k\w+) = ([^;,]+)[;,]", text))
    return (int(consts["kObjBits"], 0), int(consts["kColorShift"]), int(consts["kSlotShift"]),
            ~int(consts["kSlotBits"].lstrip("~"), 0))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_pack_round_trip_holds_every_cell_an_env_makes(name):
    """Every board of a reset and of 60 episode steps (a truncation reset
    among them) round-trips through ``pack_planes`` / ``unpack_planes``,
    which pack as ``csrc/collect_steps.cu`` (and ``collect_step.cu``)
    does."""
    for source in ("collect_steps.cu", "collect_step.cu"):
        assert _packing(source) == (0xFF, 8, 16, ~0xFFFF)
    slab, key, state = _start(CONFIGS[name], 12, seed=9)
    step = 0
    for K in (1,) * 5 + (55,):
        p = state[0]
        go, gc, gs = tslab.unpack_planes(p)
        assert int(go.min()) >= 0 and int(go.max()) <= 3
        assert int(gc.min()) >= 0 and int(gc.max()) <= 255
        assert int(gs.min()) >= -(1 << 15) and int(gs.max()) < (1 << 15)
        assert torch.equal(tslab.pack_planes(go, gc, gs), p)
        # The bitwise form: obj | color << 8 | slot << 16.
        assert torch.equal(go | gc << 8 | gs << 16, p)
        state = tslab.ms_philox_spec(slab, K, *state, key, step)
        step += K


class _OnCard:
    """A stand-in with a CUDA tensor's device and shape: the wrapper checks
    the envelope before it touches the data."""

    def __init__(self, t):
        self.shape, self.device = t.shape, torch.device("cuda", 0)


def test_wrapper_runs_the_plain_version_on_the_cpu_and_refuses_the_rest():
    """``collect_philox_slab`` runs ``ms_philox_spec`` on CPU tensors and
    launches nothing; it refuses "meta" tensors and, off the CPU, configs
    outside the kernel's envelope (a board past 256 cells, three agents),
    before any build or launch."""
    slab, key, state = _start(MAIN, 6, seed=1)
    before = tslab.collect_philox_slab.launches
    got = tslab.collect_philox_slab(slab, 30, *state, key, 40)
    assert tslab.collect_philox_slab.launches == before
    for g, w in zip(got, tslab.ms_philox_spec(slab, 30, *state, key, 40)):
        assert torch.equal(g, w)
    meta = tuple(x.to("meta") for x in state)
    with pytest.raises(ValueError, match="no Collect steps"):
        tslab.collect_philox_slab(slab, 5, *meta, key, 0)
    big, bkey, (bp, bpos, bret) = _start(dict(MAIN, size=20), 2, seed=2)
    with pytest.raises(ValueError, match="at most 256 cells"):
        tslab.collect_philox_slab(big, 5, _OnCard(bp), _OnCard(bpos), bret, bkey, 0)
    single, skey, (sp, spos, sret) = _start(CONFIGS["single"], 2, seed=2)
    three = tslab.make_collect_slab(CollectConfig(agents_index=(3, 5, 1)), "cpu")
    with pytest.raises(ValueError, match="agents"):
        tslab.collect_philox_slab(three, 5, _OnCard(sp), _OnCard(torch.zeros(2, 6)), sret,
                                  skey, 0)
    assert tslab.collect_philox_slab.launches == before


def _counted(monkeypatch, *names):
    calls = dict.fromkeys(names, 0)

    def wrap(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name in names:
        monkeypatch.setattr(tslab, name, wrap(name, getattr(tslab, name)))
    return calls


def test_rollout_makes_one_wrapper_call_a_chunk_and_no_reset(monkeypatch):
    """On the kernel route a 200-step call at chunk 30 makes seven
    ``collect_philox_slab`` calls (six of 30, one of 20) at the running
    step count, none of ``collect_reset_slab`` or ``collect_step_slab``;
    on the plain route it calls no wrapper, with the same result."""
    import dataclasses

    roll = tslab.make_collect_episode_rollout(CollectConfig(**MAIN), 4, device="cpu", chunk=30)
    assert roll.slab.kernel
    states, _ = roll.reset(seed=5)
    names = ("collect_philox_slab", "collect_reset_slab", "collect_step_slab")
    calls = _counted(monkeypatch, *names)
    got, m = roll(states, 200)
    assert calls == {"collect_philox_slab": 7, "collect_reset_slab": 0, "collect_step_slab": 0}
    assert roll.step == 200
    plain = dataclasses.replace(roll, slab=dataclasses.replace(roll.slab, kernel=False))
    plain.reset(seed=5)
    calls.update(dict.fromkeys(calls, 0))
    want, wm = plain(states, 200)
    assert calls == dict.fromkeys(names, 0)
    for f in ("grid_obj", "grid_color", "grid_slot", "agent_pos"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(m["reward_sum"], wm["reward_sum"])


def test_rollout_is_reproducible_from_a_seed():
    """Two rollouts reset with one seed give the same states and metrics
    over two calls; another seed gives other boards."""
    cfg = CollectConfig(**MAIN)
    runs = []
    for seed in (4, 4, 5):
        roll = tslab.make_collect_episode_rollout(cfg, 8, device="cpu", chunk=25)
        states, obs = roll.reset(seed=seed)
        out = [states.grid_obj.clone(), obs]
        for _ in range(2):
            states, m = roll(states, 100)
            out += [states.grid_obj, states.grid_color, states.grid_slot, states.agent_pos,
                    m["reward_sum"]]
        runs.append(out)
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert not torch.equal(runs[0][0], runs[2][0])


def test_episode_reward_agrees_with_jax_episode_rollout():
    """Mean reward per agent-step over 4 episodes of 256 envs, against JAX's
    ``make_collect_episode_rollout(rnd_mode="packed")`` on its plain XLA
    path, started from the same fresh boards: the two draw their own
    numbers, so they agree in distribution.  Tolerance: 4 standard errors
    of the difference of the two means, each over 1024 env-episodes, the
    spread of one env-episode's reward taken from the port's.  10-step
    episodes keep JAX's compile short (it unrolls an episode's steps and
    its reset program) and put a fresh board every 10 steps."""
    kw = dict(MAIN, max_steps=10)
    n, eps = 256, 4
    jcfg, tcfg = jcollect.CollectConfig(**kw), tcollect.CollectConfig(**kw)
    roll = tslab.make_collect_episode_rollout(tcfg, n, device="cpu", chunk=10)
    states, _ = roll.reset(seed=0)
    jstates = jcollect.CollectState(
        **{f: jnp.asarray(getattr(states, f).numpy())
           for f in ("grid_obj", "grid_color", "grid_slot", "agent_pos", "collected",
                     "step_count", "info_counts")},
        key=jax.random.split(jax.random.PRNGKey(0), n))
    jroll = jax.jit(lambda s, k: jpc.make_collect_episode_rollout(
        jcfg, chunk=10, rnd_mode="packed")(s, k, eps * 10))
    _, jm = jroll(jstates, jax.random.PRNGKey(1))
    # The port, an episode at a time: each env-episode's summed reward.
    p = tslab.pack_planes(states.grid_obj, states.grid_color, states.grid_slot)
    state, per_episode = (p, states.agent_pos.reshape(n, 4)), []
    for e in range(eps):
        p, pos, ret = tslab.ms_philox_spec(roll.slab, 10, *state, torch.zeros((n, 2)),
                                           roll.key, 10 * e)
        state = (p, pos)
        per_episode.append(ret.sum(1).numpy())
    _, m = roll(states, eps * 10)
    samples = np.concatenate(per_episode) / 20.0  # reward per agent-step of each env-episode
    assert float(m["reward_sum"]) == pytest.approx(samples.sum() * 20.0)
    got, want = samples.mean(), float(jm["reward_sum"]) / (n * eps * 20)
    se = np.sqrt(2 * samples.var(ddof=1) / samples.size)
    assert got > 0 and want > 0
    assert abs(got - want) < 4 * se, (got, want, se)
