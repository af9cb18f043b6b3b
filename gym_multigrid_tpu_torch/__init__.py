"""gym_multigrid_tpu_torch: the PyTorch and CUDA port of gym_multigrid_tpu.

The batched Collect env family runs on an NVIDIA GPU (Hopper, sm_90a):
one hand-written CUDA kernel per transition and per reset of the whole
batch, each with a plain PyTorch version beside it that the CPU runs.
The package imports torch, numpy and the standard library only; the JAX
package ``gym_multigrid_tpu`` is its reference and is tested against it.

Entry point: ``gym_multigrid_tpu_torch.parallel.vector.make_collect_batch``.
"""

__version__ = "0.1.0"
