"""Drivers: one module a kind of traffic (``traffic/<name>.json``'s
``driver``), each a ``Driver(cell, seed, device)`` that sets the cell up
and warms it up, drives one call of the window at a time (``call(i)``),
and checks the call it kept against the reference (``check(control)``),
and each with ``TINY``, the traffic it takes at the CPU tests' size.
What belongs to one env family lives in ``families/<family>.py``, found
by the configuration file's ``family``.  The drivers and the family
modules are the only modules of the benchmark that import
``gym_multigrid_tpu_torch``; each config file becomes the program's own
config object in its family module."""

from __future__ import annotations

import functools

import numpy as np

from benchmark import harness


@functools.cache
def family(name: str):
    """``families/<name>.py``, loaded once a process."""
    path = harness.HERE / "drivers" / "families" / f"{name}.py"
    if not path.exists():
        raise ValueError(f"no family module {path.name} under drivers/families/")
    return harness.load_module(path, f"benchmark_family_{name}")


def port_config(conf: dict):
    """The program's config object of a configuration file."""
    return family(conf["family"]).config(conf["config"])


def by_family(value, name: str):
    """A traffic value: a number, or a map by family (``name``'s entry)."""
    return value[name] if isinstance(value, dict) else value


def sub_seeds(seed: int, n: int) -> list[int]:
    """``n`` seeds of 63 bits drawn from ``seed``."""
    words = np.random.SeedSequence(seed).generate_state(2 * n, dtype=np.uint32)
    return [int(words[2 * i]) | (int(words[2 * i + 1]) & 0x7FFFFFFF) << 32 for i in range(n)]


def check_index(seed: int, within: int) -> int:
    """The window's call whose output is checked, drawn from ``seed``."""
    return int(np.random.default_rng(seed).integers(0, within))


def mismatches(got, want) -> int:
    """Elements that differ between two tuples of integer or bool tensors
    (a shape that differs counts every element)."""
    n = 0
    for g, w in zip(got, want):
        g, w = g.reshape(-1), w.reshape(-1).to(g.device)
        n += int((g != w.to(g.dtype)).sum()) if g.shape == w.shape else max(g.numel(), w.numel())
    return n


def gap(got, want) -> float:
    """Largest absolute difference of two float tensors, in float64."""
    return float((got.double() - want.double().to(got.device)).abs().max())


def rel_gap(got, want) -> float:
    """|got - want| / max(1, |want|) of two scalars, in float64."""
    g, w = float(got), float(want)
    return abs(g - w) / max(1.0, abs(w))
