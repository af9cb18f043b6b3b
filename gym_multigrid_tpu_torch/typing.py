"""Shared type aliases (PyTorch port).

Counterpart of ``gym_multigrid_tpu/typing.py`` without the JAX key alias:
the port draws its randomness from ``torch.Generator``s.
"""

from __future__ import annotations

from typing import Any, TypeAlias

import numpy as np
from numpy.typing import NDArray

Position: TypeAlias = tuple[int, int] | NDArray[np.int_]
PyTree: TypeAlias = Any
