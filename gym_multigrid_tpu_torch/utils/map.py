"""Map loading (PyTorch port).

Counterpart of ``load_text_map`` in ``gym_multigrid_tpu/utils/map.py``.
"""

from __future__ import annotations

import numpy as np


def load_text_map(map_path: str) -> np.ndarray:
    """Load a whitespace text map and transpose it, so that positions read
    (i, j) = (text column, text row)."""
    return np.loadtxt(map_path).T
