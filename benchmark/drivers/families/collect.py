"""Collect in the episode driver: the program's ``CollectConfig``, the
episode rollout (``ops/collect_slab.py``) with its K-step wrapper, and
the reference's replay of a checked call on the Philox counters
(``reference/collect.py``), which also counts the pickups the roofline
needs.  The rollout runs whole lockstep episodes, takes no running return
and gives 0 for it, and its finished episodes' returns are its reward
sum: the check compares the packed board and the positions after the
call, the first reset and ``reward_sum``.  Its ``episodes`` is B times the
call's episodes by construction, as the reference counts them, so no run
could fail it: it is not compared, and only the roofline reads it."""

from __future__ import annotations

from benchmark.reference import collect as ref_co
from benchmark.reference import philox

#: Steps and chunk of an episode call at the CPU tests' size: two
#: episodes, with chunks that span an episode's end.
TINY = {"episode": {"steps_per_call": 100, "chunk": 30}}


def config(c: dict):
    from gym_multigrid_tpu_torch.envs.collect import CollectConfig

    tuples = ("agents_index", "balls_index", "balls_reward")
    return CollectConfig(**dict(c, **{k: tuple(c[k]) for k in tuples}))


def make(cfg, B: int, device, chunk: int):
    from gym_multigrid_tpu_torch.ops import collect_slab

    return collect_slab.make_collect_episode_rollout(cfg, B, device=device, chunk=chunk)


def wrapper():
    from gym_multigrid_tpu_torch.ops import collect_slab

    return collect_slab.collect_philox_slab


def call(rollout, states, steps: int, run_ret):
    """``rollout(states, steps)``; ``run_ret`` is passed by unchanged."""
    return rollout(states, steps)


def flat(state, B: int):
    return (ref_co.pack(state.grid_obj, state.grid_color, state.grid_slot),
            state.agent_pos.reshape(B, -1))


def reference(conf: dict, seed: int, state, run_ret, index: int, steps: int, chunk: int, fdt,
              count=None):
    """The reference's first reset and its run of call ``index`` from the
    program's state before it: (reset board, board after, None for the
    running return, the reward sum).  ``count``, a dict, gets
    ``pickups``."""
    B, dev = run_ret.shape[0], run_ret.device
    t = ref_co.tables(conf)
    key = philox.key_of(seed)
    board = (state.grid_obj, state.grid_color, state.grid_slot, state.agent_pos.reshape(B, -1))
    out, sums = ref_co.episode_call(t, board, key, index * steps, steps, fdt, count)
    return ref_co.first_reset(t, key, B, dev, fdt), out, None, {"reward_sum": sums["reward_sum"]}
