"""Slab math of the port: plain PyTorch versions and their CUDA kernels.

Exports the weighted choice of ``ops/sampling.py`` and
:func:`kernels_available`; the slabs and their kernels are imported from
their own modules (``ops/<family>_slab.py``), and nothing here builds a
kernel.
"""

from gym_multigrid_tpu_torch.ops.sampling import masked_uniform_choice_weighted

#: The env families with CUDA kernels (``csrc/<family>_step.cu``).
_KERNEL_FAMILIES = frozenset({"collect", "ctf", "maze", "wildfire"})


def kernels_available(family: str) -> bool:
    """True if ``family`` has CUDA kernels, which its batches launch on a card."""
    return family in _KERNEL_FAMILIES


__all__ = ["kernels_available", "masked_uniform_choice_weighted"]
