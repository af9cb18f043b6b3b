"""Self-play and league PPO for CtF: both teams are learned policies
(PyTorch port of ``gym_multigrid_tpu/rl/selfplay.py``).

One train step rolls out BOTH nets on the same batch through the
all-agent CtF step (``ctf_slab.step_actions_batch``), computes GAE per
side (red's reward is minus the blue-centric team reward) and applies the
single-sided learner's update (``rl/ppo.py`` ``make_update_fn``) to each.
No kernel computes the all-agent step, in either package, so self-play
runs plain PyTorch on the batch's device.

League mode (:func:`make_league_ppo`) keeps a ring of frozen past red
snapshots: a fixed fraction of the batch plays one opponent drawn from the
filled slots each train step, and the live red trains only on the rest.
The pool lives on the device as ``state_dict``s; which slots are filled
is kept on the host, since only ``snapshot_fn`` changes it, and the
opponent is drawn on the host from the league's own CPU generator, so no
step waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import functional_call

from gym_multigrid_tpu_torch.envs.ctf import NUM_ACTIONS, encode
from gym_multigrid_tpu_torch.ops import _build, ctf_slab
from gym_multigrid_tpu_torch.parallel.vector import BatchedEnv
from gym_multigrid_tpu_torch.rl.networks import ActorCritic, sample_actions
from gym_multigrid_tpu_torch.rl.ppo import (
    PPOConfig,
    RolloutCarry,
    Transition,
    make_obs_store,
    make_optimizer,
    make_update_fn,
)

__all__ = [
    "make_ctf_selfplay_batch", "SelfPlayState", "LeagueState", "make_selfplay_ppo",
    "make_league_ppo",
]


def make_ctf_selfplay_batch(cfg, num_envs: int, auto_reset: bool = True,
                            device=None) -> BatchedEnv:
    """A ``BatchedEnv`` over the all-agent CtF step: actions are
    (num_envs, n_blue + n_red) ids for every agent, blue first (the order
    of ``CtfState.pos``); rewards stay the blue-centric team reward.  The
    config's scripted red policies are not used.  ``device`` as for
    ``make_ctf_batch``."""
    device = _build.default_device(device, "make_ctf_selfplay_batch")
    return BatchedEnv(
        slab=ctf_slab.make_ctf_slab(cfg, device),
        num_envs=num_envs,
        generator=torch.Generator(device=device),
        step_batch=lambda slab, states, actions, **kw: ctf_slab.step_actions_batch(
            slab, states, actions, with_info=False, **kw),
        reset_batch=ctf_slab.reset_batch,
        encode=encode,
        num_actions=NUM_ACTIONS,
        action_cols=cfg.num_blue_agents + cfg.num_red_agents,
        auto_reset=auto_reset,
    )


class SelfPlayState(NamedTuple):
    """The nets hold their parameters and the optimizers their moments;
    ``states`` is the batch and the running returns."""

    blue_net: torch.nn.Module
    red_net: torch.nn.Module
    blue_opt: torch.optim.Optimizer
    red_opt: torch.optim.Optimizer
    states: RolloutCarry


class LeagueState(NamedTuple):
    sp: SelfPlayState
    #: pool_size red ``state_dict``s on the device, slot 0 the initial red.
    pool: list
    #: Slots holding a snapshot, and the next ring slot to write (host ints).
    filled: int
    slot: int


def _seeds(seed: int, n: int) -> list[int]:
    return [int(s) for s in np.random.SeedSequence(seed).generate_state(n)]


def make_selfplay_ppo(env: BatchedEnv, cfg, ppo_cfg: PPOConfig, hidden=(256, 256),
                      activation_dtype: torch.dtype = torch.bfloat16):
    """(init_fn, train_step, (blue_net, red_net)) for simultaneous,
    independent PPO on both CtF teams.

    - ``init_fn(seed) -> SelfPlayState``: both nets re-initialised as flax
      does, both optimizers cleared, the batch reset.
    - ``train_step(sp, generator) -> (sp', metrics)``: the rollout of
      ``ppo_cfg.rollout_len`` steps, then one update of each side, the
      draws from ``generator`` (on ``env.device``); 0-d device tensors
      with ``blue_`` and ``red_`` prefixes, ``episodes`` and
      ``ep_return_mean``.

    ``activation_dtype`` is the nets' (the port's ``ActorCritic``)."""
    n_blue, n_red = cfg.num_blue_agents, cfg.num_red_agents
    store = make_obs_store(ppo_cfg)  # raises now for a non-integer dtype
    dev, B = env.device, env.num_envs
    obs_shape = tuple(env.reset(0)[1].shape[1:])
    blue_net = ActorCritic(NUM_ACTIONS, n_blue, hidden, activation_dtype,
                           obs_shape=obs_shape).to(dev)
    red_net = ActorCritic(NUM_ACTIONS, n_red, hidden, activation_dtype,
                          obs_shape=obs_shape).to(dev)
    blue_opt, red_opt = make_optimizer(blue_net, ppo_cfg), make_optimizer(red_net, ppo_cfg)
    # the single-sided learner's update, once per side
    update_blue = make_update_fn(blue_net, blue_opt, ppo_cfg)
    update_red = make_update_fn(red_net, red_opt, ppo_cfg)

    def init_fn(seed: int) -> SelfPlayState:
        env_seed, b_seed, r_seed = _seeds(seed, 3)
        blue_net.reset_parameters(torch.Generator().manual_seed(b_seed))
        red_net.reset_parameters(torch.Generator().manual_seed(r_seed))
        blue_opt.state.clear()
        red_opt.state.clear()
        states, _ = env.reset(env_seed)
        run = torch.zeros((B,), dtype=torch.float32, device=dev)
        return SelfPlayState(blue_net, red_net, blue_opt, red_opt, RolloutCarry(states, run))

    def rollout(carry: RolloutCarry, league_params, n_sp: int, generator):
        """Roll the batch with blue on every env, the live red on envs
        [0, n_sp) and red with ``league_params`` on [n_sp, B) (plain
        self-play: n_sp = B).  Each red forwards only its own slice; the
        live red's transitions cover exactly its slice.  As in ``make_ppo``
        each step runs one forward a net over the next obs and this step's
        pre-reset obs (the truncation bootstrap), so nothing waits for the
        device."""
        states, run_ret = carry
        ep_sum = torch.zeros((), dtype=torch.float32, device=dev)
        ep_cnt = torch.zeros((), dtype=torch.int32, device=dev)

        def league(obs):
            return functional_call(red_net, league_params, (obs,))[0]

        obs = env.encode(env.cfg, states)
        with torch.no_grad():
            b_logits, b_value = blue_net(obs)
            r_logits, r_value = red_net(obs[:n_sp])
            lg_logits = league(obs[n_sp:]) if n_sp < B else None
        tb, tr = [], []
        for _ in range(ppo_cfg.rollout_len):
            b_act, b_logp = sample_actions(b_logits, generator)
            r_act, r_logp = sample_actions(r_logits, generator)
            red_play = r_act
            if lg_logits is not None:
                red_play = torch.cat([r_act, sample_actions(lg_logits, generator)[0]])
            states, step_obs, reward, term, trunc = env.step(
                states, torch.cat([b_act, red_play], dim=1))
            done = term | trunc
            run_ret = run_ret + reward
            ep_sum = ep_sum + torch.where(done, run_ret, 0.0).sum()
            ep_cnt = ep_cnt + done.sum(dtype=torch.int32)
            run_ret = torch.where(done, 0.0, run_ret)
            next_obs = env.encode(env.cfg, states)
            with torch.no_grad():
                b_logits2, b_value2 = blue_net(torch.cat([next_obs, step_obs]))
                r_logits2, r_value2 = red_net(torch.cat([next_obs[:n_sp], step_obs[:n_sp]]))
                lg_logits = league(next_obs[n_sp:]) if n_sp < B else None
            so = store(obs)
            term_f, trunc_f = term.to(torch.float32), trunc.to(torch.float32)
            tb.append(Transition(so, b_act, b_logp, b_value, reward, term_f, trunc_f,
                                 b_value2[B:]))
            # red plays the adversarial objective: minus the blue-centric
            # team reward, over its self-play slice only
            tr.append(Transition(so[:n_sp], r_act, r_logp, r_value, -reward[:n_sp],
                                 term_f[:n_sp], trunc_f[:n_sp], r_value2[n_sp:]))
            obs = next_obs
            b_logits, b_value = b_logits2[:B], b_value2[:B]
            r_logits, r_value = r_logits2[:n_sp], r_value2[:n_sp]
        stats = {"episodes": ep_cnt, "ep_return_mean": ep_sum / ep_cnt.clamp(min=1)}
        tb = Transition(*(torch.stack(xs) for xs in zip(*tb)))
        tr = Transition(*(torch.stack(xs) for xs in zip(*tr)))
        return RolloutCarry(states, run_ret), (tb, b_value), (tr, r_value), stats

    def update(sp: SelfPlayState, carry, blue, red, stats, generator):
        mb = update_blue(*blue, generator)
        mr = update_red(*red, generator)
        metrics = {f"blue_{k}": v for k, v in mb.items()}
        metrics.update({f"red_{k}": v for k, v in mr.items()})
        metrics.update(stats)
        return sp._replace(states=carry), metrics

    def train_step(sp: SelfPlayState, generator):
        carry, blue, red, stats = rollout(sp.states, None, B, generator)
        return update(sp, carry, blue, red, stats, generator)

    # the internals the league composes
    train_step.rollout, train_step.update = rollout, update
    return init_fn, train_step, (blue_net, red_net)


def make_league_ppo(env: BatchedEnv, cfg, ppo_cfg: PPOConfig, pool_size: int,
                    league_fraction: float = 0.5, hidden=(256, 256),
                    activation_dtype: torch.dtype = torch.bfloat16):
    """Self-play PPO with a league of frozen red snapshots.

    ``int(num_envs * league_fraction)`` envs, the last ones, play a red
    snapshot drawn uniformly from the filled pool slots each train step;
    the rest is live self-play.  Blue updates on the whole batch, red on
    its self-play slice.

    Returns (init_fn, train_step, snapshot_fn, (blue_net, red_net)):
    ``init_fn(seed) -> LeagueState`` (every pool slot the initial red, one
    filled); ``train_step(ls, generator) -> (ls', metrics)``, which adds
    ``league_opponent`` (a host int in a CPU tensor), ``blue_reward_
    selfplay`` and, with a league slice, ``blue_reward_league``;
    ``snapshot_fn(ls) -> ls'`` writes the live red into the next ring slot
    (call it every ``snapshot_every`` iterations)."""
    if not 0.0 <= league_fraction < 1.0:
        raise ValueError(
            f"league_fraction must be in [0, 1) — red needs a non-empty "
            f"self-play slice to train on (got {league_fraction})"
        )
    if pool_size < 1:
        raise ValueError(f"pool_size must be >= 1 (got {pool_size})")
    n_league = int(env.num_envs * league_fraction)
    n_sp = env.num_envs - n_league
    if (ppo_cfg.rollout_len * n_sp) % ppo_cfg.num_minibatches:
        raise ValueError(
            f"num_minibatches={ppo_cfg.num_minibatches} must divide the "
            f"red buffer rollout_len*self-play-envs="
            f"{ppo_cfg.rollout_len * n_sp}"
        )
    sp_init, sp_step, nets = make_selfplay_ppo(env, cfg, ppo_cfg, hidden, activation_dtype)
    red_net = nets[1]
    # The opponent draw: on the host, from the league's own generator.
    opponents = torch.Generator()

    def frozen_red():
        return {k: v.detach().clone() for k, v in red_net.named_parameters()}

    def init_fn(seed: int) -> LeagueState:
        sp_seed, opp_seed = _seeds(seed, 2)
        sp = sp_init(sp_seed)
        opponents.manual_seed(opp_seed)
        return LeagueState(sp, [frozen_red() for _ in range(pool_size)], 1, 1 % pool_size)

    def snapshot_fn(ls: LeagueState) -> LeagueState:
        pool = list(ls.pool)
        pool[ls.slot] = frozen_red()
        return LeagueState(ls.sp, pool, min(ls.filled + 1, pool_size), (ls.slot + 1) % pool_size)

    def train_step(ls: LeagueState, generator):
        opp = int(torch.randint(0, ls.filled, (), generator=opponents))
        carry, blue, red, stats = sp_step.rollout(ls.sp.states, ls.pool[opp], n_sp, generator)
        sp, metrics = sp_step.update(ls.sp, carry, blue, red, stats, generator)
        metrics["league_opponent"] = torch.tensor(opp)
        # blue's reward split by opponent kind: live red against the pool
        reward = blue[0].reward
        metrics["blue_reward_selfplay"] = reward[:, :n_sp].mean()
        if n_league:
            metrics["blue_reward_league"] = reward[:, n_sp:].mean()
        return ls._replace(sp=sp), metrics

    # The opponent draw's generator, for a caller that saves and restores it.
    train_step.opponents = opponents
    return init_fn, train_step, snapshot_fn, nets
