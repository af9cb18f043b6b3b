"""The port's Wildfire tables, step, fresh boards and batch glue against the
JAX package, bit for bit.

Inputs are made with numpy from a fixed seed and handed to both sides.
JAX runs its eager (un-jitted) bodies ``wf_step_math`` (with the
lane-shift stencil, ``adj=None``), ``wf_reset_math`` (``tril=None``) and
batch glue ``make_wildfire_step_batch``, so every comparison with them is
exact, rewards included.  The Pallas step runs in interpret mode, as
tests/test_pallas_wildfire.py runs it; that is a compiled XLA program, so
there the float reward may differ by at most 1 ulp (XLA contracts the
reward's multiplies and subtracts into FMAs), and everything else is exact.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_multigrid_tpu.core import world as jworld
from gym_multigrid_tpu.envs import wildfire as jwf
from gym_multigrid_tpu.ops import pallas_wildfire as jpw
from gym_multigrid_tpu_torch.core import constants as tconst
from gym_multigrid_tpu_torch.core import world as tworld
from gym_multigrid_tpu_torch.envs import wildfire as twf
from gym_multigrid_tpu_torch.ops import _build
from gym_multigrid_tpu_torch.ops import wildfire_slab as tslab

torch.set_num_threads(1)

CONFIGS = {
    # the config the family bench drives: 2 agents on 16x16
    "main": dict(size=16, max_steps=100),
    # 4 agents (24 move orders) with a step penalty on 100 cells, off the
    # TPU kernel's 128-cell envelope
    "four_agents": dict(size=10, num_agents=4, agents_index=(1, 2, 4, 5), step_penalty=0.01),
    # every burning neighbour ignites, nothing burns out
    "spread_all": dict(size=32, p_spread=1.0, p_burnout=0.0),
    "three_agents": dict(size=11, num_agents=3, agents_index=(4, 5, 6), num_initial_fires=3,
                         p_spread=0.55, burn_penalty=0.37),
    "one_agent": dict(size=5, num_agents=1, agents_index=(4,), tree_density=0.9),
}


def cfg_pair(name, **over):
    kw = {**CONFIGS[name], **over}
    return jwf.WildfireConfig(**kw), twf.WildfireConfig(**kw)


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def test_world_and_constants_equal_jax():
    tw, jw = tworld.WildfireWorld, jworld.WildfireWorld
    assert tw.OBJECT_TO_IDX == jw.OBJECT_TO_IDX
    assert tw.IDX_TO_OBJECT == jw.IDX_TO_OBJECT
    assert tw.COLOR_TO_IDX == jw.COLOR_TO_IDX
    assert (tw.encode_dim, tw.normalize_obs) == (jw.encode_dim, jw.normalize_obs)
    for name in ("EMPTY", "TREE", "FIRE", "BURNT", "W_AGENT", "TREE_COLOR", "FIRE_COLOR",
                 "BURNT_COLOR", "NUM_ACTIONS"):
        assert getattr(twf, name) == getattr(jwf, name), name
    assert list(tworld.WildfireWorld.COLORS) == list(tconst.COLORS)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_tables_equal_jax(name):
    """Every field the port keeps, the survival table as numpy float32."""
    jcfg, tcfg = cfg_pair(name)
    jt, tt = jwf.wf_tables(jcfg), twf.wf_tables(tcfg)
    for field in twf.WfTables._fields:
        assert getattr(tt, field) == getattr(jt, field), field
    for got, want in zip(tt.survival, jt.survival):
        assert type(got) is type(want) is np.float32
    assert twf.step_rnd_width(tt) == jwf.step_rnd_width(jt)
    assert twf.reset_rnd_width(tt) == jwf.reset_rnd_width(jt)


@pytest.mark.parametrize(
    "kw",
    [
        dict(num_agents=0, agents_index=()),
        dict(num_agents=3),
        dict(size=2),
        dict(num_initial_fires=0),
        dict(tree_density=1.5),
        dict(p_spread=-0.1),
        dict(p_burnout=2.0),
    ],
)
def test_config_checks_match_jax(kw):
    with pytest.raises(ValueError) as want:
        jwf.WildfireConfig(**kw)
    with pytest.raises(ValueError) as got:
        twf.WildfireConfig(**kw)
    assert str(got.value) == str(want.value)


def test_five_agents_are_refused_as_by_jax():
    kw = dict(num_agents=5, agents_index=(1, 2, 3, 4, 5))
    with pytest.raises(AssertionError):
        jwf.wf_tables(jwf.WildfireConfig(**kw))
    with pytest.raises(ValueError, match="at most 4 agents"):
        twf.wf_tables(twf.WildfireConfig(**kw))


@pytest.mark.parametrize("size", [3, 10, 16])
def test_neighbor_fires_equal_jax(size):
    """Every cell type at random, no wrap at the edges."""
    jcfg, tcfg = jwf.WildfireConfig(size=size), twf.WildfireConfig(size=size)
    cells = np.random.default_rng(size).integers(0, 4, (24, size * size)).astype(np.int32)
    want = jwf._neighbor_fires(jwf.wf_tables(jcfg), jnp.asarray(cells))
    got = tslab.neighbor_fires(twf.wf_tables(tcfg), torch.from_numpy(cells))
    _eq(got, want)


def _start(rng, t, n):
    """(cells (n, C), pos (n, 2A)) int32: every cell type at random; agents
    at random cells, and in every third row all agents on one cell."""
    cells = rng.integers(0, 4, (n, t.n_cells)).astype(np.int32)
    pos = np.stack([rng.integers(0, t.width, (n, t.n_agents)),
                    rng.integers(0, t.height, (n, t.n_agents))], axis=2)
    pos[::3] = pos[::3, :1]
    return cells, pos.reshape(n, 2 * t.n_agents).astype(np.int32)


def _actions(rng, n, A):
    """Ids -2..8: outside 0..4 they clip to stay or up."""
    return rng.integers(-2, 9, (n, A)).astype(np.int32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_step_spec_matches_step_math_over_chained_steps(name):
    jcfg, tcfg = cfg_pair(name)
    jt, tt = jwf.wf_tables(jcfg), twf.wf_tables(tcfg)
    n, steps = 24, 16
    rng = np.random.default_rng(sorted(CONFIGS).index(name))
    cells, pos = _start(rng, tt, n)
    put_out = ignited = 0
    for _ in range(steps):
        acts = _actions(rng, n, tt.n_agents)
        rnd = rng.random((n, twf.step_rnd_width(tt)), dtype=np.float32)
        want = [np.asarray(w) for w in jwf.wf_step_math(
            jt, *(jnp.asarray(x) for x in (cells, pos, acts, rnd)), None)]
        got = tslab.step_spec(tt, *(torch.from_numpy(x) for x in (cells, pos, acts, rnd)))
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            _eq(g, w)
        put_out += int(want[3].sum())
        ignited += int(((want[0] == jwf.FIRE) & (cells == jwf.TREE)).sum())
        # Finished envs start again from a fresh random board.
        fresh = _start(rng, tt, n)
        done = want[4][:, 0] == 1
        cells = np.where(done[:, None], fresh[0], want[0])
        pos = np.where(done[:, None], fresh[1], want[1])
    assert put_out > 0 and ignited > 0


def test_extinguish_counts_cells_not_agents():
    """Agents stacked on one burning cell put out one fire."""
    _, tcfg = cfg_pair("four_agents")
    tt = twf.wf_tables(tcfg)
    cells = torch.zeros((1, tt.n_cells), dtype=torch.int32)
    cells[0, 3 * tt.width + 2] = twf.FIRE
    pos = torch.tensor([[2, 3] * 4], dtype=torch.int32)
    acts = torch.zeros((1, 4), dtype=torch.int32)
    rnd = torch.ones((1, twf.step_rnd_width(tt))) * 0.5
    new, _, reward, n_ext, term = tslab.step_spec(tt, cells, pos, acts, rnd)
    assert int(n_ext) == 1 and int(term) == 1
    assert int(new[0, 3 * tt.width + 2]) == twf.BURNT
    assert float(reward) == np.float32(1.0) - np.float32(0.01)


def test_step_spec_matches_pallas_kernel_in_interpret_mode():
    """The TPU kernel's envelope takes boards of a multiple of 128 cells
    (16x16).  Ints exact; the reward within 1 ulp of its larger product
    term (ext_reward * n_ext or burn_penalty * n_ignited), since the
    interpret-mode kernel is a compiled XLA program that contracts the
    reward's multiply and subtract into an FMA, which skips that product's
    rounding.  Where the two terms nearly cancel, that one rounding is
    several ulps of the small result."""
    jcfg, tcfg = cfg_pair("main")
    jt, tt = jwf.wf_tables(jcfg), twf.wf_tables(tcfg)
    n = 32
    rng = np.random.default_rng(5)
    cells, pos = _start(rng, tt, n)
    acts = _actions(rng, n, tt.n_agents)
    rnd = rng.random((n, twf.step_rnd_width(tt)), dtype=np.float32)
    adj = jnp.asarray(jwf.adjacency(jcfg))
    want = jpw.wildfire_step_slab(jt, *(jnp.asarray(x) for x in (cells, pos, acts, rnd)), adj, True)
    # On CPU tensors the wrapper runs the plain version.
    got = tslab.wildfire_step_slab(tt, *(torch.from_numpy(x) for x in (cells, pos, acts, rnd)))
    for i, (g, w) in enumerate(zip(got, want)):
        if i != 2:
            _eq(g, w)
    n_ignited = ((cells == twf.TREE) & (got[0].numpy() == twf.FIRE)).sum(axis=1, keepdims=True)
    terms = np.maximum(np.float32(tt.ext_reward) * got[3].numpy().astype(np.float32),
                       np.float32(tt.burn_penalty) * n_ignited.astype(np.float32))
    reward, want_reward = got[2].numpy(), np.asarray(want[2])
    assert reward.dtype == want_reward.dtype == np.float32
    diff = np.abs(reward.astype(np.float64) - want_reward.astype(np.float64))
    assert (diff <= np.spacing(terms)).all(), diff.max()
    assert (reward == want_reward).mean() > 0.5  # most rows are not contracted differently


@pytest.mark.parametrize("name, over", [
    ("main", {}), ("four_agents", {}), ("one_agent", {}),
    # 9 cells, mostly empty: many rows hold fewer trees than fires
    ("three_agents", dict(size=3, tree_density=0.2)),
])
def test_reset_spec_matches_reset_math(name, over):
    jcfg, tcfg = cfg_pair(name, **over)
    jt, tt = jwf.wf_tables(jcfg), twf.wf_tables(tcfg)
    n = 64
    rng = np.random.default_rng(3)
    rnd = rng.random((n, twf.reset_rnd_width(tt)), dtype=np.float32)
    rnd[0, tt.n_cells:] = np.float32(1.0) - np.finfo(np.float32).epsneg  # largest u below 1
    rnd[1, tt.n_cells:] = 0.0
    want = jwf.wf_reset_math(jt, jnp.asarray(rnd), None)
    got = tslab.reset_spec(tt, torch.from_numpy(rnd))
    for g, w in zip(got, want):
        _eq(g, w)


def _jax_states(jcfg, n, seed):
    fns = jwf.make_wildfire(jcfg)
    return jax.vmap(fns.reset_fn)(jax.random.split(jax.random.PRNGKey(seed), n))


def _jax_step_rnd(jstates, width):
    """The uniforms make_wildfire_step_batch draws from the state keys."""
    keys = jax.vmap(jax.random.split)(jstates.key)
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (width,)))(keys[:, 1]))


def _to_torch(jstates):
    return twf.wildfire_state_from_numpy(
        {k: np.asarray(v) for k, v in vars(jstates).items()}, "cpu")


@pytest.mark.parametrize("name", ["main", "four_agents"])
def test_step_batch_matches_jax_step_batch(name):
    """State, obs, per-agent rewards, terminated, truncated and info exact
    against the eager JAX glue, on the uniforms it draws from its keys."""
    jcfg, tcfg = cfg_pair(name, max_steps=4)
    jstep = jwf.make_wildfire_step_batch(jcfg)
    slab = tslab.make_wildfire_slab(tcfg, "cpu")
    n, steps, A = 16, 6, tcfg.num_agents
    js = _jax_states(jcfg, n, seed=9)
    rng = np.random.default_rng(13)
    truncated = 0
    for _ in range(steps):
        acts = _actions(rng, n, A)
        rnd = _jax_step_rnd(js, slab.step_draws)
        got_states, got_obs, *got_rest, got_info = tslab.step_batch(
            slab, _to_torch(js), torch.from_numpy(acts), rnd=torch.from_numpy(rnd))
        js, want_obs, *want_rest, want_info = jstep(js, jnp.asarray(acts))
        for field in ("cells", "agent_pos", "step_count", "extinguished"):
            _eq(getattr(got_states, field), getattr(js, field))
        _eq(got_obs, want_obs)
        for g, w in zip(got_rest, want_rest):  # rewards (B, A), terminated, truncated
            _eq(g, w)
        assert sorted(got_info) == sorted(want_info)
        for key in want_info:
            _eq(got_info[key], want_info[key])
        truncated += int(np.asarray(want_rest[2]).sum())
    assert truncated > 0


def test_step_batch_can_skip_obs_and_info():
    _, tcfg = cfg_pair("main")
    slab = tslab.make_wildfire_slab(tcfg, "cpu")
    states = tslab.reset_batch(slab, 8, generator=torch.Generator().manual_seed(0))
    acts = torch.zeros((8, 2), dtype=torch.int32)
    full = tslab.step_batch(slab, states, acts, generator=torch.Generator().manual_seed(1))
    bare = tslab.step_batch(slab, states, acts, generator=torch.Generator().manual_seed(1),
                            encode_obs=False, with_info=False)
    assert bare[1] is None and bare[5] is None
    for g, w in zip(bare[2:5], full[2:5]):
        assert torch.equal(g, w)
    assert torch.equal(bare[0].cells, full[0].cells)


def test_wrapper_refuses_other_devices():
    _, tcfg = cfg_pair("main")
    tt = twf.wf_tables(tcfg)
    meta = torch.zeros((2, tt.n_cells), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        tslab.wildfire_step_slab(tt, meta, None, None, None)


def test_a_board_above_1024_cells_is_refused_on_cuda_only():
    """The kernels refuse the board (checked without a card), so a CUDA
    slab of it takes the plain route; on the CPU the plain version takes the
    board and equals ``wf_step_math``."""
    jcfg, tcfg = jwf.WildfireConfig(size=33), twf.WildfireConfig(size=33)
    with pytest.raises(ValueError, match="at most 1024 cells"):
        tslab.check_envelope(twf.wf_tables(tcfg))
    assert not tslab.kernel_route(twf.wf_tables(tcfg), "cuda")
    slab = tslab.make_wildfire_slab(tcfg, "cpu")
    jt = jwf.wf_tables(jcfg)
    rng = np.random.default_rng(11)
    cells, pos = _start(rng, slab.t, 4)
    acts = _actions(rng, 4, 2)
    rnd = rng.random((4, slab.step_draws), dtype=np.float32)
    want = jwf.wf_step_math(jt, *(jnp.asarray(x) for x in (cells, pos, acts, rnd)), None)
    got = tslab.step_spec(slab.t, *(torch.from_numpy(x) for x in (cells, pos, acts, rnd)))
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("size", [10, 16, 32])
@pytest.mark.parametrize("B", [1, 5, 8, 12, 8189, 8192])
def test_tile_spans_are_aligned_and_cover_the_batch(size, B):
    """The step kernel's bulk copies for the boards its checks use (10x10,
    16x16, 32x32), on batches that are and are not a multiple of the tile:
    every span's offset and size a multiple of 16 bytes, the spans
    back to back over the full tiles' rows of both tensors, the rest a
    ragged tail under one tile, and two stages within shared memory."""
    C = size * size
    T = tslab.tile_envs(C)
    assert T % 4 == 0 and T * 32 <= 1024
    spans, tail = tslab.tile_spans(C, B)
    assert len(spans) == B // T and tail == B % T and 0 <= tail < T
    cells_end = rnd_end = 0
    for cells_off, cells_bytes, rnd_off, rnd_bytes in spans:
        for v in (cells_off, cells_bytes, rnd_off, rnd_bytes):
            assert v % 16 == 0, (size, B, v)
        assert (cells_off, cells_bytes) == (cells_end, 4 * T * C)
        assert (rnd_off, rnd_bytes) == (rnd_end, 4 * T * (C + 1))
        cells_end, rnd_end = cells_off + cells_bytes, rnd_off + rnd_bytes
    # The tail starts where the last span ends, in both tensors.
    assert cells_end == 4 * (B - tail) * C and rnd_end == 4 * (B - tail) * (C + 1)
    assert tslab.ring_bytes(C) == 2 * (4 * T * C + 4 * T * (C + 1)) <= 227 * 1024


def test_tile_size_follows_the_kernel_variants():
    """8 envs a tile up to 512 cells (the NK <= 16 variants), 4 above, in
    Python as in the kernel's tile_envs<NK>."""
    assert [tslab.tile_envs(c) for c in (1, 100, 256, 512, 513, 1024)] == [8, 8, 8, 8, 4, 4]
    text = (_build.CSRC / "wildfire_step.cu").read_text()
    nk_above, wide, narrow = map(int, re.search(
        r"constexpr int tile_envs\(\) \{\s*return NK > (\d+) \? (\d+) : (\d+);", text).groups())
    for words in (1, 2, 4, 8, 16, 32):  # the kernel's NK variants, words of 32 cells
        assert tslab.tile_envs(32 * words) == (wide if words > nk_above else narrow), words


def test_kernel_constants_equal_python_tables():
    text = (_build.CSRC / "wildfire_step.cu").read_text()
    consts = {
        name: int(value)
        for decl in re.findall(r"constexpr int ([^;]*);", text)
        for name, value in re.findall(r"(k\w+) = (-?\d+)", decl)
    }
    objects = tworld.WildfireWorld.OBJECT_TO_IDX
    for name, kind in (("kEmpty", "empty"), ("kTree", "tree"), ("kFire", "fire"),
                       ("kBurnt", "burnt")):
        assert consts[name] == objects[kind], name
    assert consts["kNumActions"] == twf.NUM_ACTIONS
    assert consts["kMaxAgents"] == twf.MAX_AGENTS
    assert consts["kMaxCells"] == tslab.MAX_CELLS
    # (dx, dy) = (vec[1], vec[0]) of CTF_ACTION_TO_VEC
    vec = tconst.CTF_ACTION_TO_VEC
    for name, want in (("kLeft", (-1, 0)), ("kDown", (0, -1)), ("kRight", (1, 0)), ("kUp", (0, 1))):
        assert (vec[consts[name]][1], vec[consts[name]][0]) == want, name
