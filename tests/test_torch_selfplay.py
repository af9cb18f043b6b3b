"""Self-play and league PPO of the port (``rl/selfplay.py``) and the CtF
all-agent step under it (``ops/ctf_slab.py`` ``step_actions_spec``).

The all-agent step is held to JAX's ``step_actions_fn`` bit for bit,
given JAX's own move order (``jax.random.permutation``) and battle
uniforms, taken from the keys it splits: positions, directions, flags and
rewards are compared exactly (every reward term of these configs is a
multiple of 1/4 and 1/100 summed in an order that rounds the same way in
both: the test asserts the reward bit for bit).  The learner's tests
mirror ``tests/test_selfplay.py`` (its mesh test aside) on the CPU, at a
small size: float32 activations, 8 envs, rollouts of 8.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_multigrid_tpu.envs import ctf as jctf
from gym_multigrid_tpu.rl import networks as jnet
from gym_multigrid_tpu_torch.envs import ctf as tctf
from gym_multigrid_tpu_torch.ops import ctf_slab as tslab
from gym_multigrid_tpu_torch.rl import networks as tnet
from gym_multigrid_tpu_torch.rl.evaluate import evaluate_ctf_match
from gym_multigrid_tpu_torch.rl.ppo import PPOConfig
from gym_multigrid_tpu_torch.rl.selfplay import (
    make_ctf_selfplay_batch,
    make_league_ppo,
    make_selfplay_ppo,
)

torch.set_num_threads(1)

MAP = os.path.join(os.path.dirname(__file__), "assets/board.txt")
F32 = torch.float32

STEP_CONFIGS = {
    # 2v2 MvN with the sticky collided flag and its per-step penalty
    "mvn_2v2_penalty": dict(num_blue_agents=2, num_red_agents=2, obstacle_penalty_ratio=0.5),
    # 6 agents
    "mvn_3v3": dict(num_blue_agents=3, num_red_agents=3),
    # 1v1: a lost battle or an obstacle cell ends the episode
    "1v1_penalty": dict(variant="1v1", obstacle_penalty_ratio=0.5),
}


def _cfg_pair(**kw):
    n_red = kw.get("num_red_agents", 1)
    kw = dict(kw, max_steps=40)
    j = jctf.CtfConfig.from_map_path(
        MAP, enemy_policies=(jctf.PolicySpec("rw"),) * n_red, **kw)
    t = tctf.CtfConfig.from_map_path(
        MAP, enemy_policies=(tctf.PolicySpec("rw"),) * n_red, **kw)
    return j, t


def _jax_draws(jcfg):
    """``draws(keys)``: JAX's move order and battle uniforms of
    ``step_actions_fn`` from the states' keys, (B, A) int32 and
    (B, n_battles) float32."""
    A = jcfg.num_agents
    mvn = jcfg.variant == "mvn"
    n_battles = jcfg.num_blue_agents * jcfg.num_red_agents if mvn else 1

    def one(key):
        _, k_step = jax.random.split(key)
        k_perm, k_bat = jax.random.split(k_step)
        perm = jax.random.permutation(k_perm, A) if mvn else jnp.arange(A)
        u = jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float32))(
            jax.random.split(k_bat, n_battles))
        return perm.astype(jnp.int32), u

    draws = jax.jit(jax.vmap(one))
    return lambda keys: tuple(np.asarray(x) for x in draws(keys))


@pytest.mark.parametrize("name", sorted(STEP_CONFIGS))
def test_step_actions_spec_matches_jax_step_actions_fn(name):
    """Chained steps from JAX's reset, random actions for every agent (ids
    -1 and 7 mixed in: JAX clips them), each step compared in full.  No
    env resets, so terminated agents and finished episodes keep
    stepping, as ``step_actions_fn`` lets them."""
    jcfg, tcfg = _cfg_pair(**STEP_CONFIGS[name])
    fns = jctf.make_ctf(jcfg)
    B, A, steps = 48, jcfg.num_agents, 25
    jstates = jax.vmap(fns.reset_fn)(jax.random.split(jax.random.PRNGKey(3), B))
    jstep = jax.jit(jax.vmap(fns.step_actions_fn))
    slab = tslab.make_ctf_slab(tcfg, "cpu")
    t = slab.t
    pos = torch.tensor(np.asarray(jstates.pos)).reshape(B, 2 * A)
    dirs = torch.tensor(np.asarray(jstates.dir))
    term = torch.zeros((B, A), dtype=torch.int32)
    coll = torch.zeros((B, A), dtype=torch.int32)
    draws = _jax_draws(jcfg)
    rng = np.random.default_rng(7)
    seen = np.zeros(3, bool)  # a battle, a collision, an episode's end
    for _ in range(steps):
        acts = rng.integers(-1, 8, (B, A)).astype(np.int32)
        perm, u = draws(jstates.key)
        jstates, _, jrew, jterm, _, jinfo = jstep(jstates, jnp.asarray(acts))
        out = tslab.step_actions_spec(t, pos, dirs, term, coll, torch.tensor(acts),
                                      torch.tensor(perm), torch.tensor(u), slab.cells)
        pos, dirs, term, coll, rew, ep_term, rfc, bfc, bbl, brl = out
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jstates.pos).reshape(B, 2 * A))
        np.testing.assert_array_equal(dirs.numpy(), np.asarray(jstates.dir))
        np.testing.assert_array_equal(term.numpy().astype(bool), np.asarray(jstates.terminated))
        np.testing.assert_array_equal(coll.numpy().astype(bool), np.asarray(jstates.collided))
        np.testing.assert_array_equal(rew[:, 0].numpy(), np.asarray(jrew))
        np.testing.assert_array_equal(ep_term[:, 0].numpy().astype(bool), np.asarray(jterm))
        for got, key in ((rfc[:, 0], "red_flag_captured"), (bfc[:, 0], "blue_flag_captured"),
                         (bbl, "battle_blue_lost"), (brl, "battle_red_lost")):
            np.testing.assert_array_equal(got.numpy().astype(bool), np.asarray(jinfo[key]))
        seen |= [bool((bbl | brl).any()), bool(coll.any()), bool(ep_term.any())]
    # what each config is there for happened
    assert seen[2] and seen[1] == (name == "mvn_2v2_penalty"), seen
    assert seen[0] or name == "mvn_2v2_penalty", seen


def test_step_batch_is_red_actions_then_step_actions_spec():
    """``step_spec`` is the scripted reds' actions, the move order and the
    battle uniforms of ``rnd``, then ``step_actions_spec``: the two agree
    bit for bit when the all-agent step is handed the same."""
    _, tcfg = _cfg_pair(num_blue_agents=2, num_red_agents=2, obstacle_penalty_ratio=0.5)
    slab = tslab.make_ctf_slab(tcfg, "cpu")
    t = slab.t
    gen = torch.Generator().manual_seed(0)
    states = tslab.reset_batch(slab, 64, generator=gen)
    pos = states.pos.reshape(64, -1)
    z = torch.zeros((64, 4), dtype=torch.int32)
    blue = torch.randint(0, 5, (64, 2), generator=gen, dtype=torch.int32)
    rnd = torch.rand((64, tslab.rnd_width(t)), generator=gen)
    want = tslab.step_spec(t, pos, states.dir, z, z, blue, rnd, slab.cells, slab.border,
                           slab.pool)
    red = tslab._red_actions(t, pos[:, 0::2], pos[:, 1::2], rnd, slab.cells, slab.border,
                             slab.pool)
    ub = tslab.n_perm_draws(t) + 3 * t.n_red
    got = tslab.step_actions_spec(t, pos, states.dir, z, z, torch.cat([blue, red], 1),
                                  tslab._move_order(t, rnd), rnd[:, ub:ub + 4], slab.cells)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _cfg(**kw):
    return tctf.CtfConfig.from_map_path(
        MAP, num_blue_agents=2, num_red_agents=2, variant="mvn",
        enemy_policies=(tctf.PolicySpec("rw"), tctf.PolicySpec("rw")),
        observation_option="flattened", **kw)


def _setup(num_envs=8, **ppo_kwargs):
    cfg = _cfg()
    env = make_ctf_selfplay_batch(cfg, num_envs, device="cpu")
    init_fn, train_step, nets = make_selfplay_ppo(
        env, cfg, PPOConfig(rollout_len=8, **ppo_kwargs), hidden=(32, 32),
        activation_dtype=F32)
    return env, cfg, init_fn, train_step, nets


def _params(net):
    return [p.detach().clone() for p in net.parameters()]


def _delta(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def test_selfplay_env_steps_all_agents():
    cfg = _cfg()
    env = make_ctf_selfplay_batch(cfg, 4, device="cpu")
    states, obs = env.reset(0)
    gen = torch.Generator().manual_seed(1)
    moved_red = False
    for _ in range(6):
        acts = torch.randint(0, 5, (4, 4), generator=gen, dtype=torch.int32)
        nxt, obs2, rew, term, trunc = env.step(states, acts)
        assert obs2.shape == obs.shape and rew.shape == (4,)
        moved_red |= bool((nxt.pos[:, 2:] != states.pos[:, 2:]).any())
        states = nxt
    assert moved_red  # red moved under external control
    with pytest.raises(ValueError, match="actions must have shape"):
        env.step(states, torch.zeros((4, 2), dtype=torch.int32))


def test_selfplay_train_step_updates_both_sides():
    env, cfg, init_fn, train_step, (blue, red) = _setup(num_epochs=1, num_minibatches=2)
    sp = init_fn(0)
    b0, r0 = _params(blue), _params(red)
    sp2, m = train_step(sp, torch.Generator().manual_seed(1))
    for k in ("blue_loss", "red_loss", "blue_entropy", "red_entropy", "ep_return_mean"):
        assert np.isfinite(float(m[k])), k
    assert _delta(b0, _params(blue)) > 0 and _delta(r0, _params(red)) > 0
    # adversarial objective: red's rollout reward is minus blue's
    assert float(m["red_reward_per_step"]) == pytest.approx(
        -float(m["blue_reward_per_step"]), abs=1e-6)
    assert sp2.states is not sp.states


def test_selfplay_deterministic():
    env, cfg, init_fn, train_step, (blue, red) = _setup(num_epochs=1, num_minibatches=2)
    _, ma = train_step(init_fn(0), torch.Generator().manual_seed(1))
    a = _params(blue) + _params(red)
    _, mb = train_step(init_fn(0), torch.Generator().manual_seed(1))
    assert _delta(a, _params(blue) + _params(red)) == 0
    assert float(ma["blue_loss"]) == float(mb["blue_loss"])


def test_red_net_takes_carried_over_flax_params():
    """A flax ``ActorCritic``'s params drawn from a seed load into the
    self-play red net, which then computes flax's forward on the batch's
    observations."""
    env, cfg, init_fn, train_step, (blue, red) = _setup()
    init_fn(0)
    obs = env.encode(env.cfg, env.reset(2)[0])
    fnet = jnet.ActorCritic(num_actions=5, num_agents=2, hidden=(32, 32),
                            activation_dtype=jnp.float32)
    params = fnet.init(jax.random.PRNGKey(4), jnp.asarray(obs[:1].numpy()))
    tnet.load_flax_params(red, params)
    want_logits, want_value = fnet.apply(params, jnp.asarray(obs.numpy()))
    with torch.no_grad():
        logits, value = red(obs)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(want_value), rtol=1e-5, atol=1e-5)


def _league(num_envs=8, pool_size=3, league_fraction=0.5, **ppo_kwargs):
    cfg = _cfg()
    env = make_ctf_selfplay_batch(cfg, num_envs, device="cpu")
    return make_league_ppo(env, cfg, PPOConfig(rollout_len=8, **ppo_kwargs),
                           pool_size=pool_size, league_fraction=league_fraction,
                           hidden=(32, 32), activation_dtype=F32)


def test_league_train_step_and_snapshot():
    init_fn, train_step, snapshot_fn, (blue, red) = _league(num_epochs=1, num_minibatches=2)
    ls = init_fn(0)
    assert ls.filled == 1 and ls.slot == 1
    pool0 = [{k: v.clone() for k, v in slot.items()} for slot in ls.pool]
    b0, r0 = _params(blue), _params(red)
    ls2, m = train_step(ls, torch.Generator().manual_seed(1))
    for k in ("blue_loss", "red_loss", "blue_reward_selfplay", "blue_reward_league",
              "league_opponent"):
        assert np.isfinite(float(m[k])), k
    assert int(m["league_opponent"]) == 0  # one slot filled
    # both sides updated; a train step leaves the pool alone
    assert _delta(b0, _params(blue)) > 0 and _delta(r0, _params(red)) > 0
    for a, b in zip(pool0, ls2.pool):
        assert all(torch.equal(a[k], b[k]) for k in a)
    # the snapshot writes the live red into the ring slot and advances it
    ls3 = snapshot_fn(ls2)
    assert (ls3.filled, ls3.slot) == (2, 2)
    assert all(torch.equal(ls3.pool[1][k], v) for k, v in red.named_parameters())
    ls4 = snapshot_fn(snapshot_fn(ls3))
    assert (ls4.filled, ls4.slot) == (3, 1)  # the ring wrapped over slot 0
    # the opponent is drawn over the filled slots
    opps = {int(train_step(ls4, torch.Generator().manual_seed(s))[1]["league_opponent"])
            for s in range(12)}
    assert opps <= {0, 1, 2} and len(opps) > 1


def test_league_red_trains_only_on_selfplay_slice():
    """Changing only the pool opponent changes nothing of red's update
    (red trains on the self-play slice; envs are independent), while the
    league slice does see another opponent."""
    init_fn, train_step, snapshot_fn, (blue, red) = _league(num_epochs=1, num_minibatches=2)
    ls = init_fn(0)
    _, ma = train_step(ls, torch.Generator().manual_seed(1))
    ra, ba = _params(red), _params(blue)
    ls = init_fn(0)
    perturbed = ls._replace(pool=[{k: v + 0.05 for k, v in slot.items()} for slot in ls.pool])
    _, mb = train_step(perturbed, torch.Generator().manual_seed(1))
    assert _delta(ra, _params(red)) == 0
    assert float(ma["red_loss"]) == float(mb["red_loss"])
    assert (float(ma["blue_reward_league"]) != float(mb["blue_reward_league"])
            or _delta(ba, _params(blue)) > 0)


def test_league_validation():
    cfg = _cfg()
    env = make_ctf_selfplay_batch(cfg, 8, device="cpu")
    with pytest.raises(ValueError, match="league_fraction"):
        make_league_ppo(env, cfg, PPOConfig(rollout_len=8), pool_size=2, league_fraction=1.0)
    with pytest.raises(ValueError, match="pool_size"):
        make_league_ppo(env, cfg, PPOConfig(rollout_len=8), pool_size=0)
    with pytest.raises(ValueError, match="num_minibatches"):
        make_league_ppo(env, cfg, PPOConfig(rollout_len=3, num_minibatches=8), pool_size=2)


def test_selfplay_1v1_variant():
    cfg = tctf.CtfConfig.from_map_path(
        MAP, num_blue_agents=1, num_red_agents=1, variant="1v1",
        enemy_policies=(tctf.PolicySpec("rw"),), observation_option="flattened")
    env = make_ctf_selfplay_batch(cfg, 8, device="cpu")
    init_fn, train_step, (blue, red) = make_selfplay_ppo(
        env, cfg, PPOConfig(rollout_len=8, num_minibatches=2), hidden=(16, 16),
        activation_dtype=F32)
    sp = init_fn(0)
    b0 = _params(blue)
    _, m = train_step(sp, torch.Generator().manual_seed(1))
    assert np.isfinite(float(m["blue_loss"])) and np.isfinite(float(m["red_loss"]))
    assert _delta(b0, _params(blue)) > 0


def test_selfplay_obs_buffer_dtype_guard():
    """Self-play shares ``make_ppo``'s obs-store guard: a non-integer buffer
    dtype fails when the learner is built."""
    cfg = _cfg()
    env = make_ctf_selfplay_batch(cfg, 4, device="cpu")
    with pytest.raises(ValueError, match="integer dtype"):
        make_selfplay_ppo(env, cfg, PPOConfig(rollout_len=4, obs_buffer_dtype="float16"),
                          hidden=(16, 16))


def test_evaluate_ctf_match_outcomes():
    cfg = _cfg(max_steps=30)
    obs_shape = tuple(make_ctf_selfplay_batch(cfg, 1, device="cpu").reset(0)[1].shape[1:])
    net = tnet.ActorCritic(5, 2, (16, 16), F32, obs_shape=obs_shape)
    bp = {k: v.clone() for k, v in net.named_parameters()}
    net.reset_parameters(torch.Generator().manual_seed(2))
    rp = {k: v.clone() for k, v in net.named_parameters()}
    r = evaluate_ctf_match(cfg, 16, net, bp, net, rp, 70, seed=3, deterministic=False,
                           device="cpu")
    assert r["episodes"] > 0
    assert r["wins"] + r["losses"] + r["draws"] == r["episodes"]
    assert 0.0 <= r["win_rate"] <= 1.0
    assert np.isfinite(r["ep_return_mean"])
    # the nets are not changed by a match
    assert all(torch.equal(v, rp[k]) for k, v in net.named_parameters())
