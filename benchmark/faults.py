"""Faults planted under a cell's timed path, for the test that sees
``correct`` come out false and for the readings of ``control.py``: each
takes the entry a driver calls and returns a broken one.

- ``unchanged``: the call returns the state it was given (the learner:
  its parameters as they were before the step);
- ``half``: half of the batch left out (the episode and step paths: the
  second half of the rows keep their state; the learner: its update
  takes the first half of the envs, the means over them);
- ``altered``: one answer altered where it is produced (one env's state
  element moved by one)."""

from __future__ import annotations

import dataclasses

import torch


def _rows(new, old, keep: int):
    """``new``'s state with rows from ``keep`` on taken from ``old``."""
    return type(new)(**{f.name: torch.cat([getattr(new, f.name)[:keep],
                                           getattr(old, f.name)[keep:]])
                        for f in dataclasses.fields(new)})


def _altered(state):
    first = dataclasses.fields(state)[0].name
    x = getattr(state, first).clone()
    x.view(-1)[0] += 1
    return dataclasses.replace(state, **{first: x})


def unchanged(kind, entry):
    if kind == "episode":
        return lambda states, steps, run_ret: (states, entry(states, steps, run_ret)[1])
    if kind == "step":
        return lambda states, actions: (states, *entry(states, actions)[1:])
    params = list(entry.net.parameters())

    def step(carry, gen):
        before = [p.detach().clone() for p in params]
        out = entry(carry, gen)
        with torch.no_grad():
            for p, b in zip(params, before):
                p.copy_(b)
        return out
    return step


def half(kind, entry):
    if kind == "episode":
        def call(states, steps, run_ret):
            new, m = entry(states, steps, run_ret)
            return _rows(new, states, run_ret.shape[0] // 2), m
        return call
    if kind == "step":
        def step(states, actions):
            new, *rest = entry(states, actions)
            return (_rows(new, states, actions.shape[0] // 2), *rest)
        return step

    def train(carry, gen):
        carry, traj, last_value, _ = entry.rollout(carry, gen)
        B = last_value.shape[0] // 2
        return carry, entry.update(type(traj)(*(x[:, :B] for x in traj)), last_value[:B], gen)
    return train


def altered(kind, entry):
    if kind == "episode":
        return lambda states, steps, run_ret: (lambda out: (_altered(out[0]), out[1]))(
            entry(states, steps, run_ret))
    if kind == "step":
        return lambda states, actions: (lambda out: (_altered(out[0]), *out[1:]))(
            entry(states, actions))
    raise ValueError("the learner's answers are its losses and parameters: see half, unchanged")


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered}
