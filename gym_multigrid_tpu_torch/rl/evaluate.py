"""Policy evaluation over the batched envs (PyTorch port of
``gym_multigrid_tpu/rl/evaluate.py``).

Evaluation is the learner's own lockstep rollout under the trained
policy: mean episode return across the auto-reset for any family
(:func:`evaluate`), and the CtF game outcomes, win, loss and draw against
the scripted red team (:func:`evaluate_ctf`) or a second learned policy
(:func:`make_ctf_match_evaluator`).  On a CUDA device each step launches
the family's step kernel; the loops never wait for the device, and each
call reads its results back once, at the end.

The nets hold their parameters: :func:`evaluate` and :func:`evaluate_ctf`
run ``net`` as it stands, and the match evaluator runs ``blue_net`` and
``red_net`` with the parameter dicts it is called with
(``torch.func.functional_call``), so one evaluator scores many pairings.
"""

from __future__ import annotations

from typing import Any

import torch
from torch.func import functional_call

from gym_multigrid_tpu_torch.envs.ctf import encode as ctf_encode
from gym_multigrid_tpu_torch.ops import _build, ctf_slab
from gym_multigrid_tpu_torch.rl.networks import sample_actions
from gym_multigrid_tpu_torch.utils.checkpoint import load_state

__all__ = [
    "make_policy", "evaluate", "evaluate_ctf", "make_ctf_match_evaluator",
    "evaluate_ctf_match", "load_params",
]


def _act(logits, generator, deterministic):
    """(B, A) int32 actions from (B, A, n) logits: the greedy argmax, or a
    draw as the learner samples."""
    if deterministic:
        return logits.argmax(dim=-1).to(torch.int32)
    return sample_actions(logits, generator)[0]


def make_policy(env, net, *, deterministic: bool = True):
    """``policy(generator, states) -> actions`` of ``env.actions_shape``
    for :meth:`BatchedEnv.rollout`: the greedy argmax of ``net``'s logits
    by default (evaluation wants the policy's mode), or the learner's
    categorical draw with ``deterministic=False``."""

    def policy(generator, states):
        with torch.no_grad():
            logits, _ = net(env.encode(env.cfg, states))
        return _act(logits, generator, deterministic).reshape(env.actions_shape)

    return policy


def evaluate(env, net, num_steps: int, *, seed: int, deterministic: bool = True) -> dict:
    """``num_steps`` lockstep steps of ``net``'s policy from ``env.reset(
    seed)``; returns host scalars: ``episodes`` (completed ones),
    ``ep_return_mean`` (exact across the auto-reset) and
    ``reward_per_step``.  Every family works; pick ``num_steps`` above
    ``max_steps`` so that every env finishes an episode.  ``net`` moves to
    ``env.device``."""
    net.to(env.device)
    states, _ = env.reset(seed)
    _, m = env.rollout(states, num_steps, policy=make_policy(env, net, deterministic=deterministic))
    episodes, ep_sum, reward_sum = torch.stack(
        [m["episodes"].double(), m["ep_return_sum"].double(), m["reward_sum"].double()]).tolist()
    episodes = int(episodes)
    return {
        "episodes": episodes,
        "ep_return_mean": ep_sum / max(episodes, 1),
        "reward_per_step": reward_sum / (num_steps * env.num_envs),
    }


def _outcome_acc0(num_envs: int, device) -> dict[str, torch.Tensor]:
    def zeros(dtype, *shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "episodes": zeros(torch.int32),
        "wins": zeros(torch.int32),
        "losses": zeros(torch.int32),
        "draws": zeros(torch.int32),
        "ep_return_sum": zeros(torch.float32),
        "ep_len_sum": zeros(torch.int32),
        "reward_sum": zeros(torch.float32),
        "run_return": zeros(torch.float32, num_envs),
        "run_len": zeros(torch.int32, num_envs),
    }


def _outcome_update(acc, rew, term, trunc, info):
    """Blue-centric outcome of each finished episode, and the episode
    accounting: (done, acc').

    A win is blue capturing the red flag (and not red the blue flag the
    same step); a loss is red capturing the blue flag, or an episode that
    terminated with no capture (every such end is a blue failure); a
    draw is the rest, truncation at ``max_steps`` or both flags taken at
    once."""
    done = term | trunc
    rf = info["red_flag_captured"]
    bf = info["blue_flag_captured"]
    term_only = term & ~rf & ~bf
    win = done & rf & ~bf
    loss = done & ~win & (bf | term_only)
    draw = done & ~win & ~loss

    def count(x):
        return x.sum(dtype=torch.int32)

    run_ret = acc["run_return"] + rew.to(torch.float32)
    run_len = acc["run_len"] + 1
    return done, {
        "episodes": acc["episodes"] + count(done),
        "wins": acc["wins"] + count(win),
        "losses": acc["losses"] + count(loss),
        "draws": acc["draws"] + count(draw),
        "ep_return_sum": acc["ep_return_sum"] + torch.where(done, run_ret, 0.0).sum(),
        "ep_len_sum": acc["ep_len_sum"] + torch.where(done, run_len, 0).sum(dtype=torch.int32),
        "reward_sum": acc["reward_sum"] + rew.sum(),
        "run_return": torch.where(done, 0.0, run_ret),
        "run_len": torch.where(done, 0, run_len),
    }


def _outcome_summary(acc, num_steps: int, num_envs: int) -> dict[str, Any]:
    """Host scalars of the accumulated outcomes: one read of the device."""
    keys = ("episodes", "wins", "losses", "draws", "ep_len_sum", "ep_return_sum", "reward_sum")
    v = dict(zip(keys, torch.stack([acc[k].double() for k in keys]).tolist()))
    episodes = int(v["episodes"])
    d = max(episodes, 1)
    wins, losses, draws = int(v["wins"]), int(v["losses"]), int(v["draws"])
    return {
        "episodes": episodes,
        "wins": wins,
        "losses": losses,
        "draws": draws,
        "win_rate": wins / d,
        "loss_rate": losses / d,
        "draw_rate": draws / d,
        "ep_return_mean": v["ep_return_sum"] / d,
        "ep_len_mean": int(v["ep_len_sum"]) / d,
        "reward_per_step": v["reward_sum"] / (num_steps * num_envs),
    }


def _ctf_outcomes(slab, num_envs, num_steps, seed, choose_actions, step):
    """Run ``num_steps`` steps of CtF from a fresh reset and accumulate the
    outcomes.  ``choose_actions(generator, obs)`` gives the step's actions
    and ``step(states, actions, generator)`` the batch step's results with
    the info; finished envs respawn under the ``done`` mask."""
    gen = torch.Generator(device=slab.device).manual_seed(seed)
    states = ctf_slab.reset_batch(slab, num_envs, generator=gen)
    acc = _outcome_acc0(num_envs, slab.device)
    for _ in range(num_steps):
        actions = choose_actions(gen, ctf_encode(slab.cfg, states))
        new_states, _, rew, term, trunc, info = step(states, actions, gen)
        done, acc = _outcome_update(acc, rew, term, trunc, info)
        states = ctf_slab.reset_batch(slab, num_envs, generator=gen, done=done, states=new_states)
    return _outcome_summary(acc, num_steps, num_envs)


def evaluate_ctf(cfg, num_envs: int, net, num_steps: int, *, seed: int,
                 deterministic: bool = True, device=None) -> dict[str, Any]:
    """CtF evaluation against the config's scripted red team, with game
    outcomes: episodes, wins, losses, draws and their rates, mean episode
    return and length, reward per step (JAX's ``evaluate_ctf``).

    Steps through the kernel-backed :func:`ctf_slab.step_batch` with its
    info (one ``ctf_step`` launch a step on a CUDA device) and respawns
    finished envs with the masked ``reset_batch``, whose spawns are
    ``PickState`` draws (JAX's reset: ``choice(replace=False)``; the two
    agree in distribution).  ``device`` as for ``make_ctf_batch``; ``net``
    moves there."""
    device = _build.default_device(device, "evaluate_ctf")
    slab = ctf_slab.make_ctf_slab(cfg, device)
    net.to(device)

    def choose(gen, obs):
        with torch.no_grad():
            return _act(net(obs)[0], gen, deterministic)

    def step(states, actions, gen):
        return ctf_slab.step_batch(slab, states, actions, generator=gen, encode_obs=False)

    return _ctf_outcomes(slab, num_envs, num_steps, seed, choose, step)


def make_ctf_match_evaluator(cfg, num_envs: int, blue_net, red_net, num_steps: int, *,
                             deterministic: bool = True, device=None):
    """``match(blue_params, red_params, seed) -> outcome dict`` for
    head-to-head CtF between two learned policies, through the all-agent
    step (:func:`ctf_slab.step_actions_batch`, no kernel: it is plain
    PyTorch on ``device``).  The params are ``state_dict``s of the nets
    (None runs the net's own); the nets are not changed, so one evaluator
    scores every pairing.  Outcomes are blue-centric, as in
    :func:`evaluate_ctf`."""
    device = _build.default_device(device, "make_ctf_match_evaluator")
    slab = ctf_slab.make_ctf_slab(cfg, device)
    blue_net.to(device)
    red_net.to(device)

    def params_on(net, params):
        if params is None:
            return dict(net.named_parameters())
        return {k: v.to(device) for k, v in params.items()}

    def match(blue_params, red_params, seed: int) -> dict[str, Any]:
        bp, rp = params_on(blue_net, blue_params), params_on(red_net, red_params)

        def choose(gen, obs):
            with torch.no_grad():
                b = _act(functional_call(blue_net, bp, (obs,))[0], gen, deterministic)
                r = _act(functional_call(red_net, rp, (obs,))[0], gen, deterministic)
            return torch.cat([b, r], dim=1)

        def step(states, actions, gen):
            return ctf_slab.step_actions_batch(slab, states, actions, generator=gen,
                                               encode_obs=False)

        return _ctf_outcomes(slab, num_envs, num_steps, seed, choose, step)

    return match


def evaluate_ctf_match(cfg, num_envs: int, blue_net, blue_params, red_net, red_params,
                       num_steps: int, *, seed: int, deterministic: bool = True,
                       device=None) -> dict[str, Any]:
    """One head-to-head CtF evaluation (:func:`make_ctf_match_evaluator`;
    build the evaluator once to score many pairings)."""
    match = make_ctf_match_evaluator(cfg, num_envs, blue_net, red_net, num_steps,
                                     deterministic=deterministic, device=device)
    return match(blue_params, red_params, seed)


def load_params(model_path: str) -> dict[str, torch.Tensor]:
    """A policy's ``state_dict`` from a snapshot of the port
    (``utils/checkpoint.py``, ``<model_path>.npz`` and ``.json``).

    Takes both layouts the port writes: the trainer's full state (its
    ``"net"``) and the self-play script's ``{"blue_params", "red_params",
    "pool"}`` file (the blue policy); a bare ``state_dict`` is returned as
    it is.  JAX snapshots hold a pickled JAX tree and are not read."""
    ckpt = load_state(model_path)
    if "net" in ckpt and "optimizer" in ckpt:
        return ckpt["net"]
    if "blue_params" in ckpt:
        return ckpt["blue_params"]
    return ckpt
