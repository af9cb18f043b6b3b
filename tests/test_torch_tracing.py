"""The port's spans (``utils/profiling.annotate``) on the CPU: under
``torch.profiler`` the per-step batch env (the Wildfire batch's fused
step and the other families' step, encode and reset), the four episode
rollouts and a PPO train step record exactly the spans of their layers,
each inside its parent; with no profiler running the helper never enters
``record_function``; and the spans change no result."""

from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gym_multigrid_tpu_torch.envs.collect import CollectConfig
from gym_multigrid_tpu_torch.envs.wildfire import WildfireConfig
from gym_multigrid_tpu_torch.ops import collect_slab, ctf_slab, maze_slab, wildfire_slab
from gym_multigrid_tpu_torch.parallel import vector
from gym_multigrid_tpu_torch.rl.networks import ActorCritic
from gym_multigrid_tpu_torch.rl.ppo import PPOConfig, make_ppo
from gym_multigrid_tpu_torch.utils import profiling
from gym_multigrid_tpu_torch.utils.misc import tree_leaves

torch.set_num_threads(1)

#: Every span of the program starts with one of these.
PREFIXES = ("ppo.", "env.", "rollout.")
N = 8
T, MINIBATCHES, EPOCHS = 3, 2, 2


def profiled(fn):
    """``fn()`` under the CPU profiler: (its result, the program's spans as
    (name, start ns, end ns))."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events() if e.name().startswith(PREFIXES)]
    return out, spans


def with_parents(spans) -> Counter:
    """(name, innermost enclosing span's name or None) of each span, counted;
    nesting by time containment."""
    out = Counter()
    for i, (name, s, e) in enumerate(spans):
        around = [(ps, -(pe - ps), pn) for j, (pn, ps, pe) in enumerate(spans)
                  if j != i and ps <= s and e <= pe]
        out[name, max(around)[2] if around else None] += 1
    return out


def env_step_spans(parent, n=1) -> Counter:
    """A step of the old glue (step, encode, masked reset), as the CtF
    batch takes it."""
    return Counter({("env.step", parent): n, ("env.transition", "env.step"): n,
                    ("env.encode", "env.step"): n, ("env.reset", "env.step"): n})


def fused_step_spans(parent, n=1) -> Counter:
    """A step of the Wildfire batch on the kernel route
    (``wildfire_slab.step_reset``): the draws and the step, then the
    auto-reset with the observation."""
    return Counter({("env.step", parent): n, ("env.transition", "env.step"): n,
                    ("env.autoreset", "env.step"): n})


def rollout_spans() -> Counter:
    """A train step's rollout: one encode and forward before the steps;
    each step's sample, env.step, encode of the next obs and forward."""
    want = Counter({("ppo.rollout", None): 1, ("env.encode", "ppo.rollout"): 1,
                    ("ppo.forward", "ppo.rollout"): 1, ("ppo.rollout.step", "ppo.rollout"): T,
                    ("ppo.sample", "ppo.rollout.step"): T,
                    ("env.encode", "ppo.rollout.step"): T,
                    ("ppo.forward", "ppo.rollout.step"): T})
    return want + env_step_spans("ppo.rollout.step", T)


def update_spans() -> Counter:
    mbs = MINIBATCHES * EPOCHS
    return Counter({("ppo.update", None): 1, ("ppo.gae", "ppo.update"): 1,
                    ("ppo.minibatch", "ppo.update"): mbs, ("ppo.loss", "ppo.minibatch"): mbs,
                    ("ppo.backward", "ppo.minibatch"): mbs, ("ppo.clip", "ppo.minibatch"): mbs})


def learner(seed=5):
    """A CtF learner on the flattened observation (the benchmark's), tiny:
    (net, carry, train_step)."""
    env = vector.make_vector_batch("ctf", N, "cpu")
    states, obs = env.reset(0)
    net = ActorCritic(5, 2, (16, 16), obs_shape=obs.shape[1:])
    cfg = PPOConfig(rollout_len=T, num_minibatches=MINIBATCHES, num_epochs=EPOCHS,
                    obs_buffer_dtype="int8")
    init_fn, train_step = make_ppo(env, net, cfg)
    _, carry = init_fn(seed)
    return net, carry, train_step


def episode(family):
    """(rollout, states, steps) of a tiny episode rollout of two chunks."""
    if family == "ctf":
        roll = ctf_slab.make_ctf_episode_rollout(vector.make_vector_batch("ctf", N, "cpu").cfg,
                                                 N, device="cpu", chunk=3)
        steps = 5
    elif family == "wildfire":
        roll = wildfire_slab.make_wildfire_episode_rollout(WildfireConfig(), N, device="cpu",
                                                           chunk=3)
        steps = 5
    elif family == "collect":
        cfg = CollectConfig(layout="quadrants_respawn", respawn=True, max_steps=6)
        roll = collect_slab.make_collect_episode_rollout(cfg, N, device="cpu", chunk=3)
        steps = 6
    else:
        roll = maze_slab.make_maze_episode_rollout(vector.make_vector_batch("maze", N, "cpu").cfg,
                                                   N, device="cpu", chunk=3)
        steps = 5
    states, _ = roll.reset(11)
    return roll, states, steps


def two_step_spans(family):
    env = vector.make_vector_batch(family, N, "cpu")
    states, _ = env.reset(3)
    acts = torch.zeros(env.actions_shape, dtype=torch.int32)

    def two_steps():
        s = states
        for _ in range(2):
            s = env.step(s, acts)[0]

    return profiled(two_steps)[1]


def test_batch_env_step_spans():
    assert with_parents(two_step_spans("wildfire")) == fused_step_spans(None, 2)


def test_batch_env_step_spans_of_the_old_glue():
    assert with_parents(two_step_spans("ctf")) == env_step_spans(None, 2)


@pytest.mark.parametrize("family", ["ctf", "wildfire", "collect", "maze"])
def test_episode_rollout_spans(family):
    roll, states, steps = episode(family)
    _, spans = profiled(lambda: roll(states, steps))
    assert with_parents(spans) == Counter({("rollout.call", None): 1,
                                           ("rollout.chunk", "rollout.call"): 2})


def test_train_step_spans():
    _, carry, train_step = learner()
    gen = torch.Generator().manual_seed(1)
    _, spans = profiled(lambda: train_step(carry, gen))
    assert with_parents(spans) == rollout_spans() + update_spans()


def test_train_step_halves_spans():
    """The two halves a caller times apart each carry their root: the
    rollout's span is in ``collect`` and the update's in ``update``."""
    _, carry, train_step = learner()
    gen = torch.Generator().manual_seed(1)
    (_, traj, last_value, _), spans = profiled(lambda: train_step.rollout(carry, gen))
    assert with_parents(spans) == rollout_spans()
    _, spans = profiled(lambda: train_step.update(traj, last_value, gen))
    assert with_parents(spans) == update_spans()


def test_no_profiler_no_record_function(monkeypatch):
    """With no profiler running, no span enters ``record_function``: every
    ``annotate`` gives the one shared no-op context."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert profiling.annotate("ppo.update") is profiling.annotate("env.step")
    env = vector.make_vector_batch("wildfire", N, "cpu")
    states, _ = env.reset(3)
    env.step(states, torch.zeros(env.actions_shape, dtype=torch.int32))
    for family in ("ctf", "wildfire", "collect", "maze"):
        roll, states, steps = episode(family)
        roll(states, steps)
    _, carry, train_step = learner()
    train_step(carry, torch.Generator().manual_seed(1))


def test_spans_change_no_result():
    """A train step's parameters and an episode call's states and sums are
    the same to the bit with the profiler on and off."""
    runs = []
    for on in (False, True):
        net, carry, train_step = learner()
        gen = torch.Generator().manual_seed(1)
        (carry, _), _ = profiled(lambda: train_step(carry, gen)) if on else (
            train_step(carry, gen), None)
        runs.append([p.detach().clone() for p in net.parameters()] + tree_leaves(carry))
    assert len(runs[0]) == len(runs[1]) and all(torch.equal(a, b) for a, b in zip(*runs))
    for family in ("ctf", "wildfire"):
        runs = []
        for on in (False, True):
            roll, states, steps = episode(family)
            (states, metrics), _ = profiled(lambda: roll(states, steps)) if on else (
                roll(states, steps), None)
            runs.append(tree_leaves((states, metrics)))
        assert len(runs[0]) == len(runs[1]) and all(torch.equal(a, b) for a, b in zip(*runs))
