"""The port's per-env functions (``make_ctf``, ``make_maze``,
``make_wildfire`` in ``envs/``) on the CPU against JAX's.

Tolerances: positions, directions, flags, integer obs, step counts and
infos of counts are bit-equal; float32 rewards and the float32 distance
infos are equal bit for bit too (each reward term and distance is formed
as JAX forms it, in float32).  JAX's Maze and Wildfire steps run eagerly
(jitted, XLA may contract the Wildfire reward into an FMA).  Where JAX
splits its own keys and the port draws from a ``torch.Generator`` (the
CtF step's scripted reds, the CtF and Maze spawns) the two agree in
distribution: means within 5 standard errors.
"""

import os
from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_multigrid_tpu.envs import ctf as jctf
from gym_multigrid_tpu.envs import maze as jmaze
from gym_multigrid_tpu.envs import wildfire as jwf
from gym_multigrid_tpu_torch.envs import ctf as tctf
from gym_multigrid_tpu_torch.envs import maze as tmaze
from gym_multigrid_tpu_torch.envs import wildfire as twf

torch.set_num_threads(1)

ASSETS = os.path.join(os.path.dirname(__file__), "assets")
MAP = os.path.join(ASSETS, "board.txt")
MAZE_MAP = os.path.join(ASSETS, "board_maze.txt")

CTF_CONFIGS = {
    "1v1_positional": dict(variant="1v1", policies=("fight",), observation_option="positional"),
    "1v1_flattened_penalty": dict(variant="1v1", policies=("capture",),
                                  observation_option="flattened", obstacle_penalty_ratio=0.5),
    "1v1_map": dict(variant="1v1", policies=("rw",), observation_option="map"),
    "2v2_positional": dict(num_blue_agents=2, num_red_agents=2, policies=("fight", "patrol"),
                           observation_option="positional"),
    "2v2_flattened_penalty": dict(num_blue_agents=2, num_red_agents=2,
                                  policies=("patrol_fight", "rw"),
                                  observation_option="flattened", obstacle_penalty_ratio=0.5),
    "3v2_map": dict(num_blue_agents=3, num_red_agents=2, policies=("rw", "capture"),
                    observation_option="map"),
}


def _ctf_cfgs(kw, **over):
    kw = dict(kw, **over)
    policies = kw.pop("policies")
    return tuple(
        mod.CtfConfig.from_map_path(
            MAP, enemy_policies=tuple(mod.PolicySpec(k) for k in policies), **kw)
        for mod in (jctf, tctf)
    )


def _carry(jstate, state_cls, i=None):
    """A JAX state (row ``i`` of a batch) as the port's state of one env."""
    return state_cls(**{
        f.name: torch.tensor(np.asarray(getattr(jstate, f.name) if i is None
                                        else getattr(jstate, f.name)[i]))
        for f in fields(state_cls)
    })


def _eq(got, want, what=""):
    """Exact equality of a port result (tensor, dict or number) and JAX's."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _eq(got[k], want[k], f"{what}.{k}")
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(got, want.astype(got.dtype) if want.dtype == bool else want,
                                  err_msg=what)
    assert got.dtype == want.dtype or (got.dtype, want.dtype) in (
        (np.int32, np.int64), (np.float32, np.float64)), (what, got.dtype, want.dtype)


def _state_eq(state, jstate, i=None, what="state"):
    for f in fields(state):
        want = getattr(jstate, f.name)
        _eq(getattr(state, f.name), want if i is None else want[i], f"{what}.{f.name}")


def _random_ctf_states(jcfg, n, seed):
    """``n`` JAX CtF states with agents anywhere on the board (stacked on
    one cell, some), random directions and defeated and collided flags."""
    rng = np.random.default_rng(seed)
    A = jcfg.num_agents
    S = np.asarray(jcfg.field_map.shape)
    return jctf.CtfState(
        pos=jnp.asarray(rng.integers(0, S, (n, A, 2)).astype(np.int32)),
        dir=jnp.asarray(rng.integers(0, 4, (n, A)).astype(np.int32)),
        terminated=jnp.asarray(rng.random((n, A)) < 0.3),
        collided=jnp.asarray(rng.random((n, A)) < 0.2),
        step_count=jnp.asarray(rng.integers(0, 50, n).astype(np.int32)),
        key=jax.random.split(jax.random.PRNGKey(seed), n),
    )


@pytest.mark.parametrize("name", sorted(CTF_CONFIGS))
def test_ctf_obs_and_info_of_a_carried_state_equal_jax(name):
    jcfg, tcfg = _ctf_cfgs(CTF_CONFIGS[name])
    jf, tf = jctf.make_ctf(jcfg), tctf.make_ctf(tcfg, device="cpu")
    n = 12
    js = _random_ctf_states(jcfg, n, seed=len(name))
    jobs, jinfo = jax.jit(jax.vmap(lambda s: (jf.obs_fn(s), jf.info_fn(s))))(js)
    for i in range(n):
        s = _carry(js, tctf.CtfState, i)
        want_obs = jax.tree.map(lambda x: x[i], jobs)
        _eq(tf.obs_fn(s), want_obs, f"obs[{i}]")
        _eq(tf.info_fn(s), {k: v[i] for k, v in jinfo.items()}, f"info[{i}]")


def _jax_step_actions_draws(jcfg):
    """JAX's move order and battle uniforms of ``step_actions_fn`` from a
    state's key (the keys it splits), for the port's ``order`` and
    ``battle_u``."""
    A, mvn = jcfg.num_agents, jcfg.variant == "mvn"
    n_battles = jcfg.num_blue_agents * jcfg.num_red_agents if mvn else 1

    def one(key):
        _, k_step = jax.random.split(key)
        k_perm, k_bat = jax.random.split(k_step)
        perm = jax.random.permutation(k_perm, A) if mvn else jnp.arange(A)
        u = jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float32))(
            jax.random.split(k_bat, n_battles))
        return perm.astype(jnp.int32), u

    return jax.jit(jax.vmap(one))


@pytest.mark.parametrize("name", ["1v1_positional", "2v2_flattened_penalty"])
def test_ctf_step_actions_fn_equals_jax_given_its_draws(name):
    """Chained all-agent steps from JAX's reset, every output compared
    (state, obs, reward, flags and the info's 16 entries), with JAX's own
    move order and battle uniforms handed to the port."""
    jcfg, tcfg = _ctf_cfgs(CTF_CONFIGS[name], max_steps=12)
    jf, tf = jctf.make_ctf(jcfg), tctf.make_ctf(tcfg, device="cpu")
    n, A = 6, jcfg.num_agents
    js = jax.vmap(jf.reset_fn)(jax.random.split(jax.random.PRNGKey(1), n))
    states = [_carry(js, tctf.CtfState, i) for i in range(n)]
    jstep, draws = jax.jit(jax.vmap(jf.step_actions_fn)), _jax_step_actions_draws(jcfg)
    rng = np.random.default_rng(4)
    ended = 0
    for t in range(13):
        acts = rng.integers(-1, 7, (n, A)).astype(np.int32)
        order, bu = (np.array(x) for x in draws(js.key))
        js, jobs, jrew, jterm, jtrunc, jinfo = jstep(js, jnp.asarray(acts))
        for i in range(n):
            out = tf.step_actions_fn(states[i], acts[i], order=order[i], battle_u=bu[i])
            states[i] = out[0]
            _state_eq(out[0], js, i, f"step {t} env {i}")
            _eq(out[1], jax.tree.map(lambda x: x[i], jobs), f"obs {t} {i}")
            for got, want in zip(out[2:5], (jrew, jterm, jtrunc)):
                _eq(got, want[i], f"step {t} env {i}")
            _eq(out[5], {k: v[i] for k, v in jinfo.items()}, f"info {t} {i}")
        ended += int(np.asarray(jterm | jtrunc).sum())
    assert ended > 0


def _ctf_episode_stats(step, reset, steps):
    """(mean episode length, reward per step) of one env chain that
    resets when an episode ends."""
    s, lengths, total, t0 = reset(), [], 0.0, 0
    for t in range(steps):
        s, rew, done = step(s)
        total += rew
        if done:
            lengths.append(t + 1 - t0)
            t0, s = t + 1, reset()
    return np.mean(lengths), total / steps


def test_ctf_step_fn_agrees_with_jax_in_distribution():
    """The scripted reds draw their own numbers on each side (JAX splits
    keys, the port reads a generator), so ``step_fn`` is held to JAX's in
    distribution: mean episode length and reward per step over 5 chains a
    side (60 steps, episodes of at most 15), within 5 standard errors."""
    jcfg, tcfg = _ctf_cfgs(CTF_CONFIGS["2v2_positional"], max_steps=15)
    jf, tf = jctf.make_ctf(jcfg), tctf.make_ctf(tcfg, device="cpu")
    jstep = jax.jit(jf.step_fn)
    jreset = jax.jit(jf.reset_fn)
    want, got = [], []
    runs = 5
    for run in range(runs):
        rng = np.random.default_rng(run)
        keys = iter(jax.random.split(jax.random.PRNGKey(run), 100))

        def jax_step(s):
            s, _, r, term, trunc, _ = jstep(s, jnp.asarray(rng.integers(0, 5, 2), jnp.int32))
            return s, float(r), bool(term | trunc)

        want.append(_ctf_episode_stats(jax_step, lambda: jreset(next(keys)), 60))
        gen = torch.Generator().manual_seed(run)

        def port_step(s):
            s, _, r, term, trunc, _ = tf.step_fn(s, rng.integers(0, 5, 2), gen)
            return s, float(r), bool(term | trunc)

        got.append(_ctf_episode_stats(port_step, lambda: tf.reset_fn(gen), 60))
    want, got = np.asarray(want), np.asarray(got)
    for i, what in enumerate(("episode length", "reward per step")):
        se = np.sqrt(want[:, i].var(ddof=1) / runs + got[:, i].var(ddof=1) / runs)
        assert abs(want[:, i].mean() - got[:, i].mean()) < 5 * se + 1e-9, (what, want, got)


def test_ctf_red_actions_fn_reads_the_step_uniforms():
    """``red_actions_fn(state, rnd=r)`` is what ``step_fn(state, a, rnd=r)``
    moves the reds by: with every blue staying, the move order cannot
    matter to a lone red that is not blocked."""
    _, tcfg = _ctf_cfgs(CTF_CONFIGS["1v1_positional"], max_steps=50)
    tf = tctf.make_ctf(tcfg, device="cpu")
    gen = torch.Generator().manual_seed(3)
    s = tf.reset_fn(gen)
    for _ in range(20):
        r = torch.rand(9, generator=gen)
        red = tf.red_actions_fn(s, rnd=r)
        assert red.shape == (1,) and red.dtype == torch.int32
        out = tf.step_fn(s, [0], rnd=r)
        want = tf.step_actions_fn(s, torch.cat([torch.zeros(1, dtype=torch.int32), red]),
                                  order=[0, 1], battle_u=r[-1:])
        _state_eq(out[0], want[0])
        s = out[0]


@pytest.mark.parametrize("variant", ["1v1", "mvn"])
def test_ctf_spawns_agree_with_jax_in_distribution(variant):
    """Each agent's spawn cell over 400 resets a side: per-cell frequencies
    within 5 standard errors of each other; MvN teammates never share a
    cell."""
    kw = dict(variant=variant, policies=("rw",)) if variant == "1v1" else dict(
        num_blue_agents=2, num_red_agents=2, policies=("rw", "rw"))
    jcfg, tcfg = _ctf_cfgs(kw)
    jf, tf = jctf.make_ctf(jcfg), tctf.make_ctf(tcfg, device="cpu")
    n = 400
    jpos = np.asarray(jax.jit(jax.vmap(jf.reset_fn))(
        jax.random.split(jax.random.PRNGKey(0), n)).pos)
    gen = torch.Generator().manual_seed(0)
    tpos = np.stack([tf.reset_fn(gen).pos.numpy() for _ in range(n)])
    S1 = jcfg.field_map.shape[1]
    for a in range(jcfg.num_agents):
        fj = np.bincount(jpos[:, a, 0] * S1 + jpos[:, a, 1], minlength=jcfg.field_map.size) / n
        ft = np.bincount(tpos[:, a, 0] * S1 + tpos[:, a, 1], minlength=jcfg.field_map.size) / n
        p = (fj + ft) / 2
        assert (np.abs(fj - ft) <= 5 * np.sqrt(2 * p * (1 - p) / n) + 1e-12).all(), a
        assert set(np.flatnonzero(ft)) <= set(np.flatnonzero(p))
    if variant == "mvn":
        for team in (slice(0, 2), slice(2, 4)):
            cells = tpos[:, team, 0] * S1 + tpos[:, team, 1]
            assert (cells[:, 0] != cells[:, 1]).all()


@pytest.mark.parametrize("option,penalty", [("map", 0.0), ("positional", 0.5)])
def test_maze_episodes_are_bit_equal_to_jax(option, penalty):
    """The Maze step draws nothing: from JAX's own reset, step for step
    with the same actions (ids -1 and 7 mixed in), state, obs, reward,
    flags and info are equal; a finished episode restarts both from the
    next JAX reset."""
    kw = dict(max_steps=25, obstacle_penalty_ratio=penalty, observation_option=option)
    jcfg = jmaze.MazeConfig.from_map_path(MAZE_MAP, **kw)
    tcfg = tmaze.MazeConfig.from_map_path(MAZE_MAP, **kw)
    jf, tf = jmaze.make_maze(jcfg), tmaze.make_maze(tcfg, device="cpu")
    jreset = jax.jit(jf.reset_fn)
    keys = iter(jax.random.split(jax.random.PRNGKey(7), 50))
    js = jreset(next(keys))
    s = _carry(js, tmaze.MazeState)
    _eq(tf.obs_fn(s), jf.obs_fn(js), "reset obs")
    _eq(tf.info_fn(s), jf.info_fn(js), "reset info")
    rng = np.random.default_rng(2)
    episodes = 0
    for t in range(70):
        a = int(rng.integers(-1, 8))
        js, jobs, jrew, jterm, jtrunc, jinfo = jf.step_fn(js, a)
        s, obs, rew, term, trunc, info = tf.step_fn(s, a)
        _state_eq(s, js, what=f"step {t}")
        for got, want in ((obs, jobs), (rew, jrew), (term, jterm), (trunc, jtrunc),
                          (info, jinfo)):
            _eq(got, want, f"step {t}")
        if bool(jterm | jtrunc):
            episodes += 1
            js = jreset(next(keys))
            s = _carry(js, tmaze.MazeState)
    assert episodes >= 2


def test_maze_spawns_agree_with_jax_in_distribution():
    jcfg = jmaze.MazeConfig.from_map_path(MAZE_MAP)
    tf = tmaze.make_maze(tmaze.MazeConfig.from_map_path(MAZE_MAP), device="cpu")
    n = 600
    jpos = np.asarray(jax.jit(jax.vmap(jmaze.make_maze(jcfg).reset_fn))(
        jax.random.split(jax.random.PRNGKey(0), n)).pos)
    gen = torch.Generator().manual_seed(0)
    states = [tf.reset_fn(gen) for _ in range(n)]
    tpos = np.stack([s.pos.numpy() for s in states])
    assert all(int(s.dir) == 3 and int(s.step_count) == 0 for s in states)
    S1 = jcfg.field_map.shape[1]
    fj = np.bincount(jpos[:, 0] * S1 + jpos[:, 1], minlength=jcfg.field_map.size) / n
    ft = np.bincount(tpos[:, 0] * S1 + tpos[:, 1], minlength=jcfg.field_map.size) / n
    p = (fj + ft) / 2
    assert (np.abs(fj - ft) <= 5 * np.sqrt(2 * p * (1 - p) / n) + 1e-12).all()
    assert (jcfg.field_map.reshape(-1)[ft > 0] == jmaze.BACKGROUND).all()


def _wf_cfgs(**kw):
    return jwf.WildfireConfig(**kw), twf.WildfireConfig(**kw)


def test_wildfire_reset_and_step_fn_equal_jax_given_its_draws():
    """JAX's ``reset_fn`` and eager ``step_fn`` draw their uniforms from the
    keys they split; handed those uniforms as ``rnd``, the port's reset and
    chained steps are equal: board, positions, counts, obs, rewards
    (each agent's share of the team reward, a float32 division) and
    info.  Three agents with a step penalty on a 6x6 board that spreads
    fast."""
    jcfg, tcfg = _wf_cfgs(size=6, num_agents=3, agents_index=(1, 2, 4), step_penalty=0.01,
                          p_spread=0.6, max_steps=30)
    jf, tf = jwf.make_wildfire(jcfg), twf.make_wildfire(tcfg, device="cpu")
    t = jwf.wf_tables(jcfg)
    key = jax.random.PRNGKey(11)
    js = jax.jit(jf.reset_fn)(key)
    _, k = jax.random.split(key)
    s = tf.reset_fn(rnd=np.array(jax.random.uniform(k, (1, jwf.reset_rnd_width(t))))[0])
    _state_eq(s, js, what="reset")
    _eq(tf.encode_fn(s), jf.encode_fn(js), "reset obs")
    rng = np.random.default_rng(5)
    for step in range(10):
        acts = rng.integers(-1, 7, jcfg.num_agents).astype(np.int32)
        _, k = jax.random.split(js.key)
        rnd = np.array(jax.random.uniform(k, (1, jwf.step_rnd_width(t))))[0]
        js, jobs, jrew, jterm, jtrunc, jinfo = jf.step_fn(js, jnp.asarray(acts))
        s, obs, rew, term, trunc, info = tf.step_fn(s, acts, rnd=rnd)
        _state_eq(s, js, what=f"step {step}")
        for got, want in ((obs, jobs), (rew, jrew), (term, jterm), (trunc, jtrunc),
                          (info, jinfo)):
            _eq(got, want, f"step {step}")


def test_per_env_functions_draw_from_the_generator_and_cache():
    tf = twf.make_wildfire(twf.WildfireConfig(size=8), device="cpu")
    a = tf.reset_fn(torch.Generator().manual_seed(4))
    b = tf.reset_fn(torch.Generator().manual_seed(4))
    _state_eq(a, b)
    assert a.cells.shape == (8, 8) and a.agent_pos.shape == (2, 2) and a.step_count.ndim == 0
    cfg = tmaze.MazeConfig.from_map_path(MAZE_MAP)
    assert tmaze.cached_maze(cfg, "cpu") is tmaze.cached_maze(cfg, torch.device("cpu"))
    _, tcfg = _ctf_cfgs(CTF_CONFIGS["1v1_map"])
    assert tctf.cached_ctf(tcfg, "cpu") is tctf.cached_ctf(tcfg, "cpu")
    assert twf.cached_wildfire(twf.WildfireConfig(), "cpu").encode_fn is not None


def test_per_env_functions_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make, cfg in ((tmaze.make_maze, tmaze.MazeConfig.from_map_path(MAZE_MAP)),
                      (twf.make_wildfire, twf.WildfireConfig()),
                      (tctf.make_ctf, _ctf_cfgs(CTF_CONFIGS["1v1_map"])[1])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(cfg)
