"""gym_multigrid_tpu_torch: the PyTorch and CUDA port of gym_multigrid_tpu.

The batched Collect, Capture-the-Flag, Maze and Wildfire env families run
on an NVIDIA GPU (Hopper, sm_90a): one hand-written CUDA kernel per
transition of the whole batch (and per reset, for Collect), each with a
plain PyTorch version beside it that the CPU runs.  The package imports
torch, numpy and the standard library only (``adapters/`` and
``envs/collect_game.py`` also gymnasium, ``render/window.py`` matplotlib,
the gif writers imageio); the JAX package ``gym_multigrid_tpu`` is its
reference and is tested against it.

Entry points: ``make_collect_batch``, ``make_ctf_batch``,
``make_maze_batch`` and ``make_wildfire_batch`` in
``gym_multigrid_tpu_torch.parallel.vector``; the PPO learner over them,
``make_family_batch`` in ``rl/families.py`` and ``train_loop`` in
``rl/trainer.py``; the sprite-bank renderer ``render/tiles.py``; the
reference's gymnasium classes, ``MultiGridEnv`` and a ``VectorEnv`` in
``adapters/``, registered by :func:`register_envs`.
"""

__version__ = "0.1.0"


def register_envs() -> None:
    """Register the gymnasium ids ``MultiGridTorch/<id>`` (the JAX
    package's 10 ids, same kwargs and time limits).

    Unlike the JAX package, which registers its ids when it is imported,
    this is not called at import: registering imports gymnasium, and the
    rest of the package runs without it."""
    from gym_multigrid_tpu_torch.adapters import register_envs as register

    register()
