"""Base class of the scripted agent policies (PyTorch port).

Counterpart of ``gym_multigrid_tpu/policy/base.py``.
"""

from __future__ import annotations

import enum
from abc import ABC, abstractmethod
from typing import TypeVar

import numpy as np
from numpy.random import Generator

ObservationT = TypeVar("ObservationT")


class BaseAgentPolicy(ABC):
    """A scripted agent policy that acts on the host.

    ``name``, ``action_set`` and ``random_generator`` (a fresh
    ``np.random.default_rng()`` by default; the env rebinds it to its own
    ``np_random``).  ``spec_kind`` names the policy's counterpart that the
    CtF step computes for a whole batch (``PolicySpec.kind``); None means
    the env calls :meth:`act` on the host every step."""

    spec_kind: str | None = None

    def __init__(
        self,
        action_set: type[enum.IntEnum] | None = None,
        random_generator: Generator | None = None,
    ) -> None:
        super().__init__()
        self.name: str = "base"
        self.action_set: type[enum.IntEnum] | None = action_set
        self.random_generator: Generator = (
            random_generator if random_generator is not None else np.random.default_rng()
        )

    @abstractmethod
    def act(self, observation: ObservationT, curr_pos=None) -> int: ...
