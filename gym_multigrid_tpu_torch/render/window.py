"""Matplotlib display window (PyTorch port).

Counterpart of ``gym_multigrid_tpu/render/window.py``.  Falls back to the
Agg backend when no display is available, so the "human" render mode
works headless.
"""

from __future__ import annotations

import os
import sys
from typing import Callable

import numpy as np
from numpy.typing import NDArray

try:
    import matplotlib

    if not os.environ.get("DISPLAY") and sys.platform != "darwin":
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
except ImportError:  # pragma: no cover
    print("To display the environment in a window, please install matplotlib")
    raise


class Window:
    """Window to draw a gridworld instance using Matplotlib."""

    def __init__(self, title: str) -> None:
        self.fig, self.ax = plt.subplots()
        try:
            self.fig.canvas.manager.set_window_title(title)
        except Exception:
            pass
        self.ax.set_xticks([])
        self.ax.set_yticks([])
        self.closed = False
        self.imshow_obj = None

        def close_handler(evt):
            self.closed = True

        self.fig.canvas.mpl_connect("close_event", close_handler)

    def show_img(self, img: NDArray) -> None:
        if self.imshow_obj is None:
            self.imshow_obj = self.ax.imshow(img, interpolation="bilinear")
        self.imshow_obj.set_data(img)
        self.fig.canvas.draw_idle()
        if matplotlib.get_backend().lower() != "agg":
            plt.pause(0.001)

    def set_caption(self, text: str) -> None:
        plt.xlabel(text)

    def reg_key_handler(self, key_handler: Callable) -> None:
        self.fig.canvas.mpl_connect("key_press_event", key_handler)

    def show(self, block: bool = True) -> None:
        if matplotlib.get_backend().lower() == "agg":
            return
        if not block:
            plt.ion()
        plt.show()

    def close(self) -> None:
        plt.close(self.fig)
