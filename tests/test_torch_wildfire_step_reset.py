"""The Wildfire per-step path with the auto-reset in one function
(``ops/wildfire_slab.py`` ``step_reset``: the step kernel, then the
auto-reset kernel ``wf_autoreset``, plain version ``autoreset_spec``).

On the CPU: the plain version, and ``make_wildfire_batch(...).step``
through it, against the composition it replaces (``step_batch``,
``encode``, ``reset_batch(done=...)``) bit for bit, on three configs and
three patterns of finished rows, with and without the observation; the
caller's states left as they were; which batches take the fused step,
and that a batch with replaced glue drops it.  Marked ``card`` (skipped
without a CUDA card): the kernel against its plain version on the card,
over batches with ragged tiles and 100 chained steps, its launch count,
the caller's counts checked, the step kernel's name in the profiler's
trace, and the old glue kept outside the kernels' envelope."""

import dataclasses
import re

import numpy as np
import pytest
import torch

from gym_multigrid_tpu_torch.envs import wildfire as twf
from gym_multigrid_tpu_torch.envs.wildfire import FIRE, TREE, WildfireConfig
from gym_multigrid_tpu_torch.ops import _build
from gym_multigrid_tpu_torch.ops import wildfire_slab as tslab
from gym_multigrid_tpu_torch.parallel.vector import make_wildfire_batch

torch.set_num_threads(1)

#: The benchmark's 16x16 with two agents; one agent; four agents on 576
#: cells (above 512: the kernels' widest variant, four envs a tile).
CONFIGS = {
    "main": WildfireConfig(size=16, max_steps=100),
    "one_agent": WildfireConfig(size=8, num_agents=1, agents_index=(3,), max_steps=12),
    "four_wide": WildfireConfig(size=24, num_agents=4, agents_index=(1, 2, 4, 5),
                                step_penalty=0.01, max_steps=12),
}
PATTERNS = ("none", "all", "mixed")
STATE_FIELDS = ("cells", "agent_pos", "step_count", "extinguished")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def pattern_states(slab, B, pattern, seed=0, device="cpu"):
    """States whose next step finishes no row ("none": every cell on fire,
    counts 0), every row ("all": no fire in the even rows, which terminate;
    the odd rows at ``max_steps - 1``, which are truncated) or some of them
    ("mixed": fresh boards with counts anywhere below ``max_steps``, every
    third row with no fire, every fourth from row 1 at ``max_steps - 1``)."""
    t = slab.t
    rng = np.random.default_rng(seed)
    u = torch.from_numpy(rng.random((B, slab.reset_draws), dtype=np.float32))
    cells, pos = tslab.reset_spec(t, u)
    sc = torch.from_numpy(rng.integers(0, t.max_steps, B).astype(np.int32))
    ext = torch.from_numpy(rng.integers(0, 9, B).astype(np.int32))
    rows = torch.arange(B)
    no_fire = torch.where(cells == FIRE, TREE, cells)
    if pattern == "none":
        cells, sc = torch.full_like(cells, FIRE), torch.zeros_like(sc)
    elif pattern == "all":
        cells = torch.where((rows % 2 == 0)[:, None], no_fire, cells)
        sc = torch.where(rows % 2 == 1, t.max_steps - 1, sc).to(torch.int32)
    else:
        cells = torch.where((rows % 3 == 0)[:, None], no_fire, cells)
        sc = torch.where(rows % 4 == 1, t.max_steps - 1, sc).to(torch.int32)
    cfg = slab.cfg
    return twf.WildfireState(
        cells=cells.reshape(B, cfg.height, cfg.width).to(device),
        agent_pos=pos.reshape(B, t.n_agents, 2).to(device),
        step_count=sc.to(device), extinguished=ext.to(device))


def check_pattern(pattern, term, trunc):
    done = term | trunc
    if pattern == "none":
        assert not done.any()
    elif pattern == "all":
        assert done.all() and term.any() and trunc.any()
    else:
        assert done.any() and not done.all() and term.any() and trunc.any()


def assert_same(got, want, what=""):
    """Tensors (or None) equal bit for bit, of one dtype and shape."""
    if want is None:
        assert got is None, what
        return
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert torch.equal(got, want), what


def old_glue(slab, states, acts, rnd, rnd_reset, encode_obs=True):
    """The composition the fused step replaces, on given draws: (states',
    obs, rewards, terminated, truncated)."""
    new_states, _, rewards, term, trunc, _ = tslab.step_batch(
        slab, states, acts, rnd=rnd, encode_obs=False, with_info=False)
    obs = twf.encode(slab.cfg, new_states) if encode_obs else None
    B = states.cells.shape[0]
    states = tslab.reset_batch(slab, B, rnd=rnd_reset, done=term | trunc, states=new_states)
    return states, obs, rewards, term, trunc


def new_path(slab, states, acts, rnd, rnd_reset, encode_obs=True, autoreset=None):
    """The step, then ``autoreset`` (default the plain version) on the
    same draws, in ``old_glue``'s form."""
    autoreset = autoreset or tslab.autoreset_spec
    B, C, A = states.cells.shape[0], slab.t.n_cells, slab.t.n_agents
    step = tslab.wildfire_step_slab(slab.t, states.cells.reshape(B, C),
                                    states.agent_pos.reshape(B, 2 * A), acts, rnd)
    cells, pos, sc, ext, obs, rewards, term, trunc = autoreset(
        slab, *step, states.step_count, states.extinguished, rnd_reset, encode_obs)
    cfg = slab.cfg
    return (twf.WildfireState(cells.reshape(B, cfg.height, cfg.width), pos.reshape(B, A, 2),
                              sc, ext), obs, rewards, term, trunc)


def assert_same_step(got, want):
    for f in STATE_FIELDS:
        assert_same(getattr(got[0], f), getattr(want[0], f), f)
    for name, g, w in zip(("obs", "rewards", "terminated", "truncated"), got[1:], want[1:]):
        assert_same(g, w, name)


def draws(slab, B, seed, device="cpu"):
    """(actions with ids outside 0..4, the step's uniforms, the reset's)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    acts = torch.randint(-1, 7, (B, slab.t.n_agents), generator=gen, device=device,
                         dtype=torch.int32)
    rnd = torch.rand((B, slab.step_draws), generator=gen, device=device)
    rnd_reset = torch.rand((B, slab.reset_draws), generator=gen, device=device)
    return acts, rnd, rnd_reset


def clone_states(states):
    return twf.WildfireState(**{f: getattr(states, f).clone() for f in STATE_FIELDS})


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plain_version_matches_old_glue(name, pattern):
    """``autoreset_spec`` after the step equals ``step_batch``, ``encode``
    and ``reset_batch(done=...)`` on the same ``rnd`` tensors, and the
    wrapper on the CPU is the plain version."""
    slab = tslab.make_wildfire_slab(CONFIGS[name], "cpu")
    B = 40
    states = pattern_states(slab, B, pattern, seed=len(name))
    acts, rnd, rnd_reset = draws(slab, B, seed=3)
    want = old_glue(slab, states, acts, rnd, rnd_reset)
    check_pattern(pattern, want[3], want[4])
    assert_same_step(new_path(slab, states, acts, rnd, rnd_reset), want)
    assert_same_step(new_path(slab, states, acts, rnd, rnd_reset,
                              autoreset=tslab.wf_autoreset_slab), want)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_batch_step_matches_old_glue(name, pattern):
    """``make_wildfire_batch(...).step`` takes ``step_reset`` and equals
    the same batch with the old glue, from generators in one state: the
    same draws in the same order, and the same results bit for bit."""
    env = make_wildfire_batch(CONFIGS[name], 36, device="cpu")
    assert env.step_reset.fn is tslab.step_reset
    old = dataclasses.replace(env, step_reset=None, generator=torch.Generator())
    states = pattern_states(env.slab, env.num_envs, pattern, seed=7)
    acts = draws(env.slab, env.num_envs, seed=5)[0]
    env.generator.manual_seed(11)
    old.generator.manual_seed(11)
    want = old.step(states, acts)
    got = env.step(states, acts)
    check_pattern(pattern, want[3], want[4])
    assert_same_step(got, want)
    # The generators stand where they would after the old glue's draws.
    assert torch.equal(env.generator.get_state(), old.generator.get_state())


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_without_observation(name):
    """``encode_obs=False`` (the path of ``rollout``) returns no obs and
    the same rest, and a rollout over episode ends equals the old glue's."""
    cfg = dataclasses.replace(CONFIGS[name], max_steps=5)
    env = make_wildfire_batch(cfg, 24, device="cpu")
    old = dataclasses.replace(env, step_reset=None, generator=torch.Generator())
    slab = env.slab
    states = pattern_states(slab, 24, "mixed", seed=2)
    acts, rnd, rnd_reset = draws(slab, 24, seed=9)
    got = new_path(slab, states, acts, rnd, rnd_reset, encode_obs=False)
    assert got[1] is None
    assert_same_step(got, old_glue(slab, states, acts, rnd, rnd_reset, encode_obs=False))
    s_new, _ = env.reset(4)
    s_old, _ = old.reset(4)
    s_new, m_new = env.rollout(s_new, 12)
    s_old, m_old = old.rollout(s_old, 12)
    assert int(m_new["episodes"]) > 0
    for f in STATE_FIELDS:
        assert_same(getattr(s_new, f), getattr(s_old, f), f)
    for k in m_old:
        assert_same(m_new[k], m_old[k], k)


@pytest.mark.parametrize("pattern", PATTERNS)
def test_caller_states_unchanged(pattern):
    """The fused step writes new tensors, never the states it is given."""
    env = make_wildfire_batch(CONFIGS["main"], 16, device="cpu")
    states = pattern_states(env.slab, 16, pattern, seed=1)
    kept = clone_states(states)
    env.reset(0)
    acts = draws(env.slab, 16, seed=1)[0]
    out = env.step(states, acts)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(states, f), getattr(kept, f)), f
        assert getattr(out[0], f).data_ptr() != getattr(states, f).data_ptr(), f


def test_fused_step_only_on_the_kernel_route_with_the_full_observation(monkeypatch):
    """``make_wildfire_batch`` sets ``step_reset`` from what it observes: a
    slab on the kernel route and no ``partial_obs_view``; the other batch
    families never set it; with ``auto_reset=False`` ``step`` keeps the
    old glue."""
    from gym_multigrid_tpu_torch.parallel import vector

    cfg = CONFIGS["main"]
    assert make_wildfire_batch(cfg, 4, device="cpu").step_reset.fn is tslab.step_reset
    assert make_wildfire_batch(cfg, 4, device="cpu", partial_obs_view=5).step_reset is None
    for family in ("collect", "ctf", "maze"):
        assert vector.make_vector_batch(family, 4, "cpu").step_reset is None
    called = []
    env = make_wildfire_batch(cfg, 4, device="cpu", auto_reset=False)
    env = dataclasses.replace(env, step_reset=vector.StepReset(
        lambda *a: called.append(a), (env.step_batch, env.encode, env.reset_batch)))
    assert env.step_reset is not None
    states, _ = env.reset(0)
    out = env.step(states, torch.zeros(env.actions_shape, dtype=torch.int32))
    assert not called and torch.equal(out[0].step_count, states.step_count + 1)
    monkeypatch.setattr(tslab, "kernel_route", lambda t, device_type: False)
    assert make_wildfire_batch(cfg, 4, device="cpu").step_reset is None


@pytest.mark.parametrize("field", ["step_batch", "encode", "reset_batch"])
def test_replaced_glue_drops_the_fused_step(field):
    """A batch whose ``step_batch``, ``encode`` or ``reset_batch`` is
    replaced drops ``step_reset`` and steps through its own glue: a
    replaced ``encode`` gives its obs, not the full observation."""
    env = make_wildfire_batch(CONFIGS["main"], 8, device="cpu")
    seen = []

    def spy(*args, **kwargs):
        seen.append(field)
        return getattr(env, field)(*args, **kwargs)

    mine = dataclasses.replace(env, **{field: spy})
    assert mine.step_reset is None
    assert dataclasses.replace(env, num_envs=8).step_reset is env.step_reset
    states, _ = mine.reset(0)
    seen.clear()
    mine.step(states, torch.zeros(mine.actions_shape, dtype=torch.int32))
    assert seen == [field]


def test_kernel_agent_type_and_name():
    """The kernel's agent type is WildfireWorld's, and its name keeps the
    benchmark's reading of the step kernel whole."""
    text = (_build.CSRC / "wildfire_step.cu").read_text()
    assert int(re.search(r"constexpr int kAgent = (\d+);", text).group(1)) == twf.W_AGENT
    assert "wf_autoreset" in _build.ENTRY_POINTS["wildfire_step.cu"]
    # The benchmark reads the step kernel as the one kernel whose name holds
    # "wildfire::" and "step_kernel" but not "philox": no other kernel of
    # the file, nor a type in its signature, may hold "step_kernel".
    kernels = re.findall(r"__global__ void __launch_bounds__\(.*\)\n(\w+)\(", text)
    assert sorted(kernels) == ["autoreset_kernel", "philox_steps_kernel", "step_kernel"]
    assert not any("step_kernel" in n for n in re.findall(r"struct (\w+)", text))


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


@pytest.mark.card
@pytest.mark.parametrize("B", [1, 7, 8, 9, 4096, 65536])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernel_matches_plain_version_on_card(card, name, B):
    """``wf_autoreset_slab`` (the kernel) against ``autoreset_spec`` on the
    card, on the step kernel's own outputs, with and without the obs;
    ragged tiles included (tiles of 8 envs, 4 on the widest boards)."""
    slab = tslab.make_wildfire_slab(CONFIGS[name], card)
    states = pattern_states(slab, B, "mixed", seed=B, device=card)
    acts, rnd, rnd_reset = draws(slab, B, seed=B + 1, device=card)
    want = new_path(slab, states, acts, rnd, rnd_reset)
    for encode_obs in (True, False):
        before = tslab.wf_autoreset_slab.launches
        got = new_path(slab, states, acts, rnd, rnd_reset, encode_obs=encode_obs,
                       autoreset=tslab.wf_autoreset_slab)
        torch.cuda.synchronize()
        assert tslab.wf_autoreset_slab.launches == before + 1
        assert_same_step(got, want if encode_obs else (*want[:1], None, *want[2:]))


@pytest.mark.card
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_chained_steps_on_card(card, name):
    """100 steps of ``make_wildfire_batch(...).step`` from one seed on the
    card against the step kernel and the plain auto-reset on the same
    draws, episodes ending and restarting; one auto-reset launch a step."""
    cfg = dataclasses.replace(CONFIGS[name], max_steps=30)
    B = 4099
    env = make_wildfire_batch(cfg, B)
    assert env.step_reset.fn is tslab.step_reset
    states, _ = env.reset(21)
    mine = clone_states(states)
    gen = torch.Generator(device=card).manual_seed(21)
    torch.rand((B, env.slab.reset_draws), generator=gen, device=card)  # the reset's draw
    acts = torch.randint(0, 5, (100, B, cfg.num_agents), device=card, dtype=torch.int32,
                         generator=torch.Generator(device=card).manual_seed(3))
    done = 0
    for s in range(100):
        before = tslab.wf_autoreset_slab.launches
        got = env.step(states, acts[s])
        assert tslab.wf_autoreset_slab.launches == before + 1
        rnd = torch.rand((B, env.slab.step_draws), generator=gen, device=card)
        rnd_reset = torch.rand((B, env.slab.reset_draws), generator=gen, device=card)
        want = new_path(env.slab, mine, acts[s], rnd, rnd_reset)
        assert_same_step(got, want)
        done += int((got[3] | got[4]).sum())
        states, mine = got[0], want[0]
    assert done > B


@pytest.mark.card
@pytest.mark.parametrize("field", ["step_count", "extinguished"])
def test_step_checks_the_callers_counts_on_card(card, field):
    """The fused step skips the wrapper's checks of the step kernel's own
    outputs, not of the caller's counts: an int64 count is refused before
    the auto-reset launch."""
    env = make_wildfire_batch(CONFIGS["main"], 64)
    states, _ = env.reset(0)
    states = dataclasses.replace(states, **{field: getattr(states, field).long()})
    before = tslab.wf_autoreset_slab.launches
    with pytest.raises(ValueError, match=field):
        env.step(states, torch.zeros(env.actions_shape, dtype=torch.int32, device=card))
    assert tslab.wf_autoreset_slab.launches == before


@pytest.mark.card
def test_profiled_step_has_one_step_kernel(card):
    """Under ``torch.profiler`` each step runs exactly one kernel named
    ``wildfire::`` ... ``step_kernel`` (the benchmark's reading of the step
    kernel) and one auto-reset kernel, and at most eight kernels in all."""
    from torch.profiler import ProfilerActivity, profile

    env = make_wildfire_batch(CONFIGS["main"], 8192)
    states, _ = env.reset(0)
    acts = torch.zeros(env.actions_shape, dtype=torch.int32, device=card)
    states = env.step(states, acts)[0]
    torch.cuda.synchronize()
    steps = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            states = env.step(states, acts)[0]
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA
             and not e.name().startswith(("Memcpy", "Memset")) and not e.is_user_annotation()]
    step_kernels = [n for n in names if "wildfire::" in n and "step_kernel" in n
                    and "philox" not in n]
    assert len(step_kernels) == steps, step_kernels
    assert sum("autoreset_kernel" in n for n in names) == steps, names
    assert len(names) <= 8 * steps, names


@pytest.mark.card
def test_out_of_envelope_keeps_old_glue_on_card(card):
    """A 40x40 board is outside the kernels' envelope: its batch keeps the
    plain step, encode and masked reset on the card, launching neither
    kernel, and equals the CPU batch from the same states and draws."""
    cfg = WildfireConfig(size=40, max_steps=3)
    env = make_wildfire_batch(cfg, 64)
    assert env.step_reset is None and not env.slab.kernel
    cpu = make_wildfire_batch(cfg, 64, device="cpu")
    states = pattern_states(cpu.slab, 64, "mixed", seed=5)
    acts, rnd, rnd_reset = draws(cpu.slab, 64, seed=6)
    launches = (tslab.wf_autoreset_slab.launches, tslab.wildfire_step_slab.launches)
    s = twf.WildfireState(**{f: getattr(states, f).to(card) for f in STATE_FIELDS})
    got = old_glue(env.slab, s, acts.to(card), rnd.to(card), rnd_reset.to(card))
    torch.cuda.synchronize()
    assert (tslab.wf_autoreset_slab.launches, tslab.wildfire_step_slab.launches) == launches
    env.generator.manual_seed(0)
    env.step(s, acts.to(card))
    torch.cuda.synchronize()
    assert (tslab.wf_autoreset_slab.launches, tslab.wildfire_step_slab.launches) == launches
    want = old_glue(cpu.slab, states, acts, rnd, rnd_reset)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(got[0], f).cpu(), getattr(want[0], f)), f
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[3].cpu(), want[3]) and torch.equal(got[4].cpu(), want[4])
    assert torch.equal(got[2].cpu(), want[2])

