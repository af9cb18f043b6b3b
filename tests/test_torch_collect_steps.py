"""The Collect K steps on the CPU: the K-step wrapper
``collect_philox_slab`` runs its plain version ``ms_philox_spec`` there
and launches nothing, ``ms_spec`` equals K single ``step_spec`` steps with
the rewards and counters summed, a chunking of the steps changes nothing,
the episode rollout goes through the wrapper once a chunk (and through
``ms_philox_spec`` on the plain route of a config outside the kernel's
envelope), and the kernels' packed cell holds every value an env makes.
``ms_spec`` against JAX's ``_collect_ms_math`` is in
``tests/test_torch_collect_episode.py``; ``ms_philox_spec`` against
``ms_spec`` and ``reset_spec`` in ``tests/test_torch_collect_philox.py``."""

import dataclasses
import re

import numpy as np
import pytest
import torch

from gym_multigrid_tpu_torch.envs.collect import CollectConfig
from gym_multigrid_tpu_torch.ops import _build, philox
from gym_multigrid_tpu_torch.ops import collect_slab as tslab

torch.set_num_threads(1)

MAIN = CollectConfig(layout="quadrants_respawn", respawn=True, max_steps=50)
CONFIGS = {
    "main": MAIN,
    "single": CollectConfig(agents_index=(3,), layout="even", respawn=False, max_steps=100),
    "fixed_horizon": CollectConfig(layout="even", fixed_horizon=True, max_steps=50),
    "16x16": CollectConfig(size=16, num_balls=45, layout="quadrants_respawn", respawn=True,
                           max_steps=50),
    # 17 ball types: two agents' counters (34) outrun a warp's lanes.
    "17_types": CollectConfig(balls_index=tuple(range(17)), balls_reward=(1.0,) * 17,
                              num_balls=17, layout="even", respawn=True, max_steps=50),
}
# A board above the kernels' 256 cells: the plain route off the CPU.
LARGE_RESPAWN = CollectConfig(size=20, layout="quadrants_respawn", respawn=True, max_steps=50)


def _inputs(cfg, B, K, seed):
    """A fresh batch's planes and positions, and K steps of draws: ids
    0..3 with the no-op ids -1, 4 and 7 mixed in, and uniforms."""
    slab = tslab.make_collect_slab(cfg, "cpu")
    gen = torch.Generator().manual_seed(seed)
    s = tslab.reset_batch(slab, B, generator=gen)
    A = cfg.num_agents
    acts = torch.randint(0, 4, (K, B, A), generator=gen, dtype=torch.int32)
    bad = torch.rand((K, B, A), generator=gen) < 0.2
    ids = torch.tensor([-1, 4, 7], dtype=torch.int32)
    acts = torch.where(bad, ids[torch.randint(0, 3, (K, B, A), generator=gen)], acts)
    rnd = torch.rand((K, B, 3), generator=gen)
    state = (s.grid_obj, s.grid_color, s.grid_slot, s.agent_pos.reshape(B, 2 * A))
    return slab, state, acts, rnd


def test_collect_philox_slab_runs_ms_philox_spec_on_the_cpu():
    """The K-step wrapper on CPU tensors is its plain version and launches
    nothing; it refuses "meta" tensors."""
    slab, state, _, _ = _inputs(MAIN, 6, 1, seed=1)
    key = philox.key_of(1)
    packed = (tslab.pack_planes(*state[:3]), state[3], torch.zeros((6, 2)))
    before = tslab.collect_philox_slab.launches
    got = tslab.collect_philox_slab(slab, 9, *packed, key, 45)
    assert tslab.collect_philox_slab.launches == before  # the plain version launches nothing
    for g, w in zip(got, tslab.ms_philox_spec(slab, 9, *packed, key, 45)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="no Collect steps"):
        tslab.collect_philox_slab(slab, 9, *(x.to("meta") for x in packed), key, 45)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_k_steps_equal_k_single_steps(name):
    """K steps of ``ms_spec`` equal K applications of ``step_spec`` on the
    same draws, the rewards summed in float32 step by step and each pickup
    counted under its slot's info counter (as JAX's
    ``test_multistep_math_matches_repeated_single_steps``)."""
    cfg = CONFIGS[name]
    B, K = 32, 30
    slab, state, acts, rnd = _inputs(cfg, B, K, seed=2)
    got = tslab.ms_spec(slab, *state, acts, rnd)
    A, nt = cfg.num_agents, cfg.num_ball_types
    rewards, info = slab.slot_rewards.numpy(), slab.slot_info.numpy()
    rew = np.zeros((B, A), dtype=np.float32)
    cnt = np.zeros((B, A, nt), dtype=np.int32)
    cur = state
    for k in range(K):
        *cur, picked = tslab.step_spec(slab.t, *cur, acts[k], rnd[k], slab.respawn_rects)
        for b, i in zip(*np.nonzero(picked.numpy() >= 0)):
            ps = min(int(picked[b, i]), len(rewards) - 1)
            rew[b, i] = np.float32(rew[b, i] + rewards[ps])
            cnt[b, i, info[ps]] += 1
    for g, w in zip(got, (*cur, torch.from_numpy(rew), torch.from_numpy(cnt.reshape(B, -1)))):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert cnt.sum() > 0, "no pickups"


@pytest.mark.parametrize("name", ["main", "16x16"])
def test_chunking_changes_nothing(name):
    """25 + 25 steps equal 50: the planes and positions, the counters
    summed, and the reward sums (each slot pays a whole number, so every
    float32 sum here is exact whatever its order)."""
    cfg = CONFIGS[name]
    slab, state, acts, rnd = _inputs(cfg, 12, 50, seed=3)
    assert bool((slab.slot_rewards == slab.slot_rewards.round()).all())
    whole = tslab.ms_spec(slab, *state, acts, rnd)
    first = tslab.ms_spec(slab, *state, acts[:25], rnd[:25])
    second = tslab.ms_spec(slab, *first[:4], acts[25:], rnd[25:])
    for g, w in zip(second[:4], whole[:4]):
        assert torch.equal(g, w)
    assert torch.equal(first[4] + second[4], whole[4])
    assert torch.equal(first[5] + second[5], whole[5])
    assert int(whole[5].sum()) > 0


def _counted(monkeypatch, *names):
    """Count the calls of the named wrappers of ``collect_slab``."""
    calls = dict.fromkeys(names, 0)

    def wrap(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name in names:
        monkeypatch.setattr(tslab, name, wrap(name, getattr(tslab, name)))
    return calls


def test_episode_rollout_calls_the_k_step_wrapper_once_a_chunk(monkeypatch):
    """On the kernel route a 100-step call of 50-step episodes at chunk 20
    runs five ``collect_philox_slab`` chunks (the third spans the first
    episode's end, whose reset it runs), and neither the one-step wrapper
    nor the reset's."""
    calls = _counted(monkeypatch, "collect_philox_slab", "collect_step_slab",
                     "collect_reset_slab")
    roll = tslab.make_collect_episode_rollout(MAIN, 4, device="cpu", chunk=20)
    assert roll.slab.kernel
    states, _ = roll.reset(seed=0)
    calls.update(dict.fromkeys(calls, 0))
    roll(states, 100)
    assert calls == {"collect_philox_slab": 5, "collect_step_slab": 0, "collect_reset_slab": 0}


def test_out_of_envelope_rollout_takes_the_plain_route(monkeypatch):
    """The 20x20 respawn config is outside the kernels' 256 cells: off the
    CPU its slab takes the plain route, and a rollout on that route runs
    ``ms_philox_spec``, calling no kernel wrapper, with the same result as
    the CPU's kernel route (whose wrapper runs the same plain version)."""
    assert not tslab.kernel_route(LARGE_RESPAWN, "cuda")
    assert not tslab.make_collect_slab(LARGE_RESPAWN, "meta").kernel
    # 8 envs over two episodes: pickups are sparse on this board.
    roll = tslab.make_collect_episode_rollout(LARGE_RESPAWN, 8, device="cpu", chunk=20)
    assert roll.slab.kernel  # the CPU takes any board
    start, _ = roll.reset(seed=4)
    want, want_m = roll(start, 100)
    plain = dataclasses.replace(roll, slab=dataclasses.replace(roll.slab, kernel=False))
    plain.reset(seed=4)
    calls = _counted(monkeypatch, "collect_philox_slab", "collect_step_slab",
                     "collect_reset_slab")
    got, got_m = plain(start, 100)
    assert calls == {"collect_philox_slab": 0, "collect_step_slab": 0, "collect_reset_slab": 0}
    for f in ("grid_obj", "grid_color", "grid_slot", "agent_pos"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(got_m["reward_sum"], want_m["reward_sum"])
    assert float(got_m["reward_sum"]) > 0


def _packing():
    """(object mask, color shift, slot shift, slot mask) of
    ``csrc/collect_step.cu``'s packed cell."""
    text = (_build.CSRC / "collect_step.cu").read_text()
    consts = dict(re.findall(r"(k\w+) = ([^;,]+)[;,]", text))
    return (int(consts["kObjBits"], 0), int(consts["kColorShift"]), int(consts["kSlotShift"]),
            ~int(consts["kSlotBits"].lstrip("~"), 0))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_packed_cell_holds_every_value_an_env_makes(name):
    """The kernels pack a cell as obj | color << 8 | slot << 16: every
    cell of a reset and of 40 steps' boards round-trips through that word,
    and the move-out mask clears the object and color and keeps the
    slot."""
    obj_bits, color_shift, slot_shift, slot_bits = _packing()
    assert (obj_bits, color_shift, slot_shift) == (0xFF, 8, 16)
    assert slot_bits & 0xFFFFFFFF == 0xFFFF0000
    cfg = CONFIGS[name]
    slab, state, acts, rnd = _inputs(cfg, 16, 40, seed=5)
    boards = [state[:3]]
    cur = state
    for k in range(40):
        *cur, _ = tslab.step_spec(slab.t, *cur, acts[k], rnd[k], slab.respawn_rects)
        boards.append(cur[:3])
    for go, gc, gs in boards:
        go, gc, gs = (x.numpy().astype(np.int64) for x in (go, gc, gs))
        assert go.min() >= 0 and go.max() <= obj_bits
        assert gc.min() >= 0 and gc.max() <= obj_bits
        assert gs.min() >= -(1 << 15) and gs.max() < (1 << 15)
        word = (go | gc << color_shift | gs << slot_shift).astype(np.int32)
        assert np.array_equal(word & obj_bits, go)
        assert np.array_equal((word >> color_shift) & obj_bits, gc)
        assert np.array_equal(word >> slot_shift, gs)
        assert np.array_equal((word & np.int32(slot_bits)) >> slot_shift, gs)
        assert not (word & np.int32(slot_bits) & obj_bits).any()
