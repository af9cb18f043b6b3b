"""The reference's import path of ``Window``, which lives with the rest of
the rendering stack in ``render/window.py``."""

from gym_multigrid_tpu_torch.render.window import Window

__all__ = ["Window"]
