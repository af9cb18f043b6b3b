"""Masked uniform picks over (B, C) cell planes, and a weighted choice
(PyTorch port).

Counterpart of ``gym_multigrid_tpu/ops/sampling.py`` (``PickState``,
``masked_uniform_choice_weighted``) and of ``_masked_pick`` in
``gym_multigrid_tpu/ops/pallas_collect.py``.  The JAX
package forms its inclusive prefix sum with shifted adds or a tril matmul
(TPU workarounds); here it is ``torch.cumsum``.  These plain forms are what
the slab specs use; the CUDA kernels pick with warp ballots instead and
are held bit-equal to them.
"""

from __future__ import annotations

from typing import NamedTuple

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


class PickState(NamedTuple):
    """Picks without replacement from one shrinking (B, C) mask.

    Removing the set cell at ``idx`` turns the prefix sum of the mask into
    ``cum - (lane >= idx)``, so a pick after the first costs one
    element-wise pass instead of a new prefix sum, with the same result."""

    mask: torch.Tensor  # (B, C) bool: the cells still free
    cum: torch.Tensor  # (B, C) int32: inclusive prefix sum of mask
    count: torch.Tensor  # (B, 1) int32: set cells in mask
    lane: torch.Tensor  # (1, C) int32: the cell index

    @classmethod
    def make(cls, mask: torch.Tensor) -> "PickState":
        """The cells set in the (B, C) bool ``mask`` free: one prefix sum."""
        cum = prefix_sum(mask)
        lane = torch.arange(mask.shape[1], dtype=torch.int32, device=mask.device)[None, :]
        return cls(mask, cum, cum[:, -1:], lane)

    @classmethod
    def full(cls, B: int, C: int, device) -> "PickState":
        """Every cell free: the prefix sum is ``lane + 1``."""
        lane = torch.arange(C, dtype=torch.int32, device=device)[None, :]
        return cls(
            torch.ones((B, C), dtype=torch.bool, device=device),
            (lane + 1).expand(B, C),
            torch.full((B, 1), C, dtype=torch.int32, device=device),
            lane,
        )

    def pick(self, u: torch.Tensor):
        """Uniform pick among the free cells, ``u`` (B, 1) float32; a row
        with none picks nothing.  Returns (one-hot hit (B, C), cell index
        (B, 1) int32, 0 where nothing was picked, the next state)."""
        r = torch.minimum(
            (u * self.count.to(torch.float32)).to(torch.int32), self.count - 1
        )
        hit = (self.cum == r + 1) & self.mask
        picked = hit.any(dim=1, keepdim=True)
        idx = torch.where(hit, self.lane, 0).sum(dim=1, keepdim=True, dtype=torch.int32)
        dec = ((self.lane >= idx) & picked).to(torch.int32)
        nxt = PickState(
            self.mask & ~hit, self.cum - dec, self.count - picked.to(torch.int32), self.lane
        )
        return hit, idx, nxt


def masked_uniform_choice_weighted(weights: torch.Tensor,
                                   generator: torch.Generator | None = None) -> torch.Tensor:
    """An index of the last axis of ``weights`` (>= 0) drawn with
    probability proportional to its weight: Gumbel-max over the log
    weights, the Gumbel noise drawn from ``generator`` (on the weights'
    device) as JAX's ``jax.random.gumbel`` draws it, from uniforms in
    [tiny, 1).  A weight <= 0 is never drawn; a row of such weights gives
    0.  Returns int32 of ``weights.shape[:-1]``."""
    w = weights.to(torch.float32)
    u = torch.rand(w.shape, generator=generator, device=w.device)
    g = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    logw = torch.where(w > 0, torch.log(w), float("-inf"))
    return torch.argmax(logw + g, dim=-1).to(torch.int32)
