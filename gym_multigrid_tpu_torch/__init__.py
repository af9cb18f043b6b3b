"""gym_multigrid_tpu_torch: the PyTorch and CUDA port of gym_multigrid_tpu.

The batched Collect, Capture-the-Flag, Maze and Wildfire env families run
on an NVIDIA GPU (Hopper, sm_90a): one hand-written CUDA kernel per
transition of the whole batch (and per reset, for Collect), each with a
plain PyTorch version beside it that the CPU runs.  The package imports
torch, numpy and the standard library only; the JAX package
``gym_multigrid_tpu`` is its reference and is tested against it.

Entry points: ``make_collect_batch``, ``make_ctf_batch``,
``make_maze_batch`` and ``make_wildfire_batch`` in
``gym_multigrid_tpu_torch.parallel.vector``; the PPO learner over them,
``make_family_batch`` in ``rl/families.py`` and ``train_loop`` in
``rl/trainer.py``.
"""

__version__ = "0.1.0"
