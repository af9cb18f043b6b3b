"""The port's CtF episode path on the CPU: ``ms_spec`` (K steps with the
auto-reset) against the eager JAX episode math bit for bit, K steps at once
against K one-step chunks, the kernel's spawn picks walked as the kernel
walks them, ``ctf_ms_slab``'s CPU rule, and ``make_ctf_episode_rollout``'s
draws, invariants and statistics against the JAX episode rollout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_multigrid_tpu.envs import ctf as jctf
from gym_multigrid_tpu.ops import pallas_ctf as jpc
from gym_multigrid_tpu_torch.envs import ctf as tctf
from gym_multigrid_tpu_torch.ops import ctf_slab as tslab
from gym_multigrid_tpu_torch.ops.sampling import PickState

torch.set_num_threads(1)

BOARD = "tests/assets/board.txt"
# The config the family bench drives: 2v2 on the 10x10 board.
MAIN = dict(num_blue_agents=2, num_red_agents=2, variant="mvn",
            policies=("fight", "rw"), observation_option="flattened")
ONE_V_ONE = dict(num_blue_agents=1, num_red_agents=1, variant="1v1",
                 policies=("fight",), obstacle_penalty_ratio=0.5)
THREE_V_THREE = dict(num_blue_agents=3, num_red_agents=3, variant="mvn",
                     policies=("capture", "patrol", "rw"))


def _cfgs(kw, **over):
    kw = {**kw, **over}
    policies = kw.pop("policies")
    return (
        jctf.CtfConfig.from_map_path(
            BOARD, enemy_policies=tuple(jctf.PolicySpec(k) for k in policies), **kw),
        tctf.CtfConfig.from_map_path(
            BOARD, enemy_policies=tuple(tctf.PolicySpec(k) for k in policies), **kw),
    )


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _inputs(slab, B, K, seed):
    """Spawned start states with a tenth of the agents terminated and a
    tenth collided, step counts and running returns, blue ids -2..6 and
    the step's and the spawn's uniforms, all made with numpy."""
    rng = np.random.default_rng(seed)
    A, nb = slab.cfg.num_agents, slab.cfg.num_blue_agents
    pos = tslab.reset_spec(slab.t, torch.from_numpy(rng.random((B, A), dtype=np.float32)),
                           slab.bterr, slab.rterr).numpy()
    dirs = rng.integers(0, 4, (B, A)).astype(np.int32)
    term, coll = rng.random((B, A)) < 0.1, rng.random((B, A)) < 0.1
    sc = rng.integers(0, slab.t.max_steps, B).astype(np.int32)
    run = (rng.random(B, dtype=np.float32) - np.float32(0.5)).astype(np.float32)
    acts = rng.integers(-2, 7, (K, B, nb)).astype(np.int32)
    rnd_step = rng.random((K, B, tslab.rnd_width(slab.t)), dtype=np.float32)
    rnd_reset = rng.random((K, B, A), dtype=np.float32)
    return pos, dirs, term, coll, sc, run, acts, rnd_step, rnd_reset


def _torch(args):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in args]


def _ms(slab, K, args):
    return tslab.ms_spec(slab.t, K, *args, slab.flags, slab.border, slab.pool,
                         slab.bterr, slab.rterr)


@pytest.mark.parametrize("kw", [MAIN, ONE_V_ONE, THREE_V_THREE], ids=["main", "1v1", "3v3"])
def test_ms_spec_matches_jax_episode_math(kw):
    """The eager ``_ctf_ms_math`` on the packed buffer built from the same
    draws (per step the blue ids as floats, the step's uniforms, the
    spawn's): state, running returns and the per-env sums bit for bit.
    Episodes end inside K (max_steps 5), so the auto-reset runs."""
    jcfg, tcfg = _cfgs(kw, max_steps=5)
    slab = tslab.make_ctf_slab(tcfg, "cpu")
    jt = jpc.make_ctf_ktables(jcfg)
    B, K = 16, 12
    args = _inputs(slab, B, K, seed=len(kw))
    pos, dirs, term, coll, sc, run, acts, rnd_step, rnd_reset = args
    packed = np.concatenate([acts.astype(np.float32), rnd_step, rnd_reset], axis=2)
    assert packed.shape[2] == jpc.ms_stride(jt)
    # Eager: compiling the K unrolled steps takes minutes on the CPU.
    want = jpc._ctf_ms_math(
        jt, K, *(jnp.asarray(x) for x in (pos, dirs, term.astype(np.int32),
                                          coll.astype(np.int32), sc[:, None], run[:, None])),
        jnp.asarray(packed.transpose(1, 0, 2).reshape(B, -1)),
        *jpc.ctf_static_inputs(jcfg), *jpc.ctf_reset_inputs(jcfg),
    )
    got = _ms(slab, K, _torch(args))
    w_pos, w_dirs, w_term, w_coll, w_sc, w_run, w_rew, w_ep, w_eps = want
    _eq(got[0], w_pos)
    _eq(got[1], w_dirs)
    _eq(got[2].to(torch.int32), w_term)
    _eq(got[3].to(torch.int32), w_coll)
    assert got[2].dtype == got[3].dtype == torch.bool
    for g, w in zip(got[4:], (w_sc, w_run, w_rew, w_ep, w_eps)):
        assert g.shape == (B,)
        _eq(g, np.asarray(w)[:, 0])
    assert int(got[8].sum()) > B  # every env ended an episode, most more than one


@pytest.mark.parametrize("kw", [MAIN, THREE_V_THREE], ids=["main", "3v3"])
def test_k_steps_equal_k_one_step_chunks(kw):
    """One call of K steps and K chained calls of one step give the same
    state bit for bit, and the same sums: a one-step chunk's sums are its
    step's terms, added to the running totals in the same order."""
    _, tcfg = _cfgs(kw, max_steps=4)
    slab = tslab.make_ctf_slab(tcfg, "cpu")
    B, K = 16, 10
    args = _torch(_inputs(slab, B, K, seed=11))
    want = _ms(slab, K, args)
    state = args[:6]
    rew, ep = torch.zeros(B), torch.zeros(B)
    eps = torch.zeros(B, dtype=torch.int32)
    for k in range(K):
        out = _ms(slab, 1, (*state, *(x[k:k + 1] for x in args[6:])))
        state = out[:6]
        rew, ep, eps = rew + out[6], ep + out[7], eps + out[8]
    for g, w in zip((*state, rew, ep, eps), want):
        assert torch.equal(g, w)


def _kernel_spawn(u, a, n, mvn):
    """The kernel's spawn picks (csrc/ctf_step.cu ms::decode) with
    picks::pick_untaken (csrc/picks.cuh), in float32: pick j takes r = floor_pick(u_j, n - j)
    and moves it up by one for each taken cell at or below it, the taken
    cells in ascending order; cell 0 once the territory is used up."""
    f32 = np.float32

    def floor_pick(v, m):
        return min(int(f32(v) * f32(m)), m - 1)

    if not mvn:
        return floor_pick(u[a], n)
    taken = []
    for j in range(a + 1):
        x = 0
        if n - j > 0:
            x = floor_pick(u[j], n - j)
            for t in taken:
                if t <= x:
                    x += 1
        cell = x
        taken = sorted(taken + [x])
    return cell


@pytest.mark.parametrize("n", [1, 3, 9, 30])
def test_kernel_spawn_picks_equal_pick_state(n):
    """The spawn picks as the kernel forms them equal ``PickState``'s picks
    without replacement (and 1v1's floor picks), the territory used up
    (more agents than cells) included."""
    rng = np.random.default_rng(n)
    B, agents = 200, 7
    u = rng.random((B, agents), dtype=np.float32)
    u[:4] = np.float32(1) - np.float32(2) ** -24  # the largest uniform below 1
    ps = PickState.full(B, n, "cpu")
    for a in range(agents):
        _, idx, ps = ps.pick(torch.from_numpy(u[:, a:a + 1].copy()))
        got = [_kernel_spawn(u[b], a, n, mvn=True) for b in range(B)]
        assert got == idx[:, 0].tolist(), a
        floor = np.minimum((u[:, a] * np.float32(n)).astype(np.int32), n - 1)
        assert [_kernel_spawn(u[b], a, n, mvn=False) for b in range(B)] == floor.tolist()


def test_ctf_ms_slab_runs_ms_spec_on_the_cpu():
    _, tcfg = _cfgs(MAIN, max_steps=4)
    slab = tslab.make_ctf_slab(tcfg, "cpu")
    K, B = 6, 8
    args = _torch(_inputs(slab, B, K, seed=1))
    before = tslab.ctf_ms_slab.launches
    got = tslab.ctf_ms_slab(slab, *args)
    assert tslab.ctf_ms_slab.launches == before  # the plain version launches nothing
    for g, w in zip(got, _ms(slab, K, args)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="no CtF steps"):
        tslab.ctf_ms_slab(slab, *(x.to("meta") for x in args))


def _rollout(n, kw=MAIN, chunk=25, **over):
    return tslab.make_ctf_episode_rollout(_cfgs(kw, **over)[1], n, device="cpu", chunk=chunk)


def _distinct_cells(pos):
    """(B,) bool: no two agents of an env share a cell."""
    key = pos[:, :, 0] * 1024 + pos[:, :, 1]
    return ~(key[:, :, None] == key[:, None, :]).triu(diagonal=1).any(dim=(1, 2))


def test_episode_rollout_draws_one_chunk_at_a_time_from_the_generator():
    """The rollout equals ``ms_spec`` on the generator's draws, in the
    rollout's order: blue ids, step uniforms, spawn uniforms, chunk by
    chunk, with a partial last chunk."""
    n, steps, chunk = 8, 17, 7
    roll = _rollout(n, chunk=chunk, max_steps=6)
    start, _ = roll.reset(seed=5)
    states, m = roll(start, steps)
    slab, gen = roll.slab, roll.generator
    gen.manual_seed(5)
    tslab.reset_batch(slab, n, generator=gen)
    state = (start.pos.reshape(n, -1), start.dir, start.terminated, start.collided,
             start.step_count, torch.zeros(n))
    rew, ep, eps = torch.zeros(()), torch.zeros(()), torch.zeros((), dtype=torch.int32)
    for k0 in range(0, steps, chunk):
        K = min(chunk, steps - k0)
        draws = (torch.randint(0, 5, (K, n, 2), generator=gen, dtype=torch.int32),
                 torch.rand((K, n, slab.step_draws), generator=gen),
                 torch.rand((K, n, slab.reset_draws), generator=gen))
        out = _ms(slab, K, (*state, *draws))
        state = out[:6]
        rew, ep, eps = rew + out[6].sum(), ep + out[7].sum(), eps + out[8].sum(dtype=torch.int32)
    assert torch.equal(states.pos.reshape(n, -1), state[0])
    for got, want in ((m["run_return"], state[5]), (m["reward_sum"], rew),
                      (m["ep_return_sum"], ep), (m["episodes"], eps)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("kw", [MAIN, THREE_V_THREE], ids=["main", "3v3"])
def test_episode_rollout_invariants(kw):
    """Spawns in their own territory and never shared, agents on the board
    and apart after every call, fresh spawns where the step count is 0,
    and the metrics consistent across two calls."""
    n = 32
    roll = _rollout(n, kw, chunk=10, max_steps=12)
    states, obs = roll.reset(seed=2)
    nb = roll.cfg.num_blue_agents
    for agent in range(roll.cfg.num_agents):
        terr = roll.slab.bterr if agent < nb else roll.slab.rterr
        at = (states.pos[:, agent, :1] == terr[0]) & (states.pos[:, agent, 1:] == terr[1])
        assert at.any(dim=1).all(), agent
    assert _distinct_cells(states.pos).all()
    runs = []
    for _ in range(2):
        states, m = roll(states, 25, run_return=runs[-1]["run_return"] if runs else None)
        runs.append(m)
        assert _distinct_cells(states.pos).all()
        assert ((states.pos >= 0) & (states.pos < 10)).all()
        assert (states.step_count < roll.cfg.max_steps).all()
        fresh = states.step_count == 0
        assert (states.dir[fresh] == tctf.SPAWN_DIR).all()
        assert not states.terminated[fresh].any() and not states.collided[fresh].any()
        assert int(m["episodes"]) > n and m["episodes"].dtype == torch.int32
    reward = float(runs[0]["reward_sum"]) + float(runs[1]["reward_sum"])
    finished = float(runs[0]["ep_return_sum"]) + float(runs[1]["ep_return_sum"])
    # The same rewards summed in another order: float32 rounding only.
    assert finished + float(runs[1]["run_return"].sum()) == pytest.approx(reward, rel=1e-5)


def test_episode_length_and_reward_agree_with_jax_episode_rollout():
    """Mean episode length and reward per env-step over eight independent
    runs a side, against JAX's ``make_ctf_episode_rollout(rnd_mode=
    "packed")``: the two draw their own numbers, so they agree in
    distribution; each mean within 5 standard errors of the other."""
    n, steps, runs = 64, 60, 8
    jcfg, tcfg = _cfgs(MAIN, max_steps=20)
    # One step a JAX chunk: the chunk's steps unroll, and compiling them is
    # most of the test's time.
    jroll = jax.jit(lambda s, k: jpc.make_ctf_episode_rollout(
        jcfg, chunk=1, rnd_mode="packed")(s, k, steps))
    roll = tslab.make_ctf_episode_rollout(tcfg, n, device="cpu", chunk=30)
    want, got = [], []
    for seed in range(runs):
        states, _ = roll.reset(seed=seed)
        # JAX starts from the same fresh states (its own batch reset costs
        # more to compile than the rest of the test).
        jstates = jctf.CtfState(
            **{f: jnp.asarray(getattr(states, f).numpy())
               for f in ('pos', 'dir', 'terminated', 'collided', 'step_count')},
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


def test_configs_jax_refuses_give_none():
    kw = dict(num_blue_agents=5, num_red_agents=4, policies=("rw",) * 4)
    jcfg, tcfg = _cfgs(kw)
    assert jpc.make_ctf_episode_rollout(jcfg) is None
    assert tslab.make_ctf_episode_rollout(tcfg, 8, device="cpu") is None


def test_no_device_and_no_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tslab.make_ctf_episode_rollout(_cfgs(MAIN)[1], 8)
    with pytest.raises(ValueError, match="chunk"):
        tslab.make_ctf_episode_rollout(_cfgs(MAIN)[1], 8, device="cpu", chunk=0)
