"""Masked uniform picks over (B, C) cell planes (PyTorch port).

Counterpart of ``gym_multigrid_tpu/ops/sampling.py`` and of
``_masked_pick`` in ``gym_multigrid_tpu/ops/pallas_collect.py``.  The JAX
package forms its inclusive prefix sum with shifted adds or a tril matmul
(TPU workarounds); here it is ``torch.cumsum``.  These plain forms are what
the slab specs use; the CUDA kernels pick with warp ballots instead and
are held bit-equal to them.
"""

from __future__ import annotations

import torch


def prefix_sum(mask: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 prefix sum of a (B, C) mask along the cells.

    ``torch.cumsum`` of an int32 tensor returns int64 unless asked, and the
    JAX side is int32 throughout, hence the explicit dtype."""
    return torch.cumsum(mask.to(torch.int32), dim=1, dtype=torch.int32)


def masked_pick(mask: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One-hot (B, C) bool of the ``min(floor(u*count), count-1)``-th set
    cell of each row of ``mask``: exactly uniform over the set cells.

    ``u`` is (B, 1) float32; the product is taken in float32 and truncated,
    as the JAX package does.  A row with no set cell picks nothing."""
    cum = prefix_sum(mask)
    count = cum[:, -1:]
    r = torch.minimum((u * count.to(torch.float32)).to(torch.int32), count - 1)
    return (cum == r + 1) & mask
