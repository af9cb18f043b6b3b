"""Raster helpers with the reference's function-level API (PyTorch port).

Counterpart of ``gym_multigrid_tpu/utils/rendering.py``, host numpy as
there: predicates are ``fn(x, y) -> bool`` callables and ``fill_coords``
paints them onto an image, evaluating a predicate over the whole pixel
grid at once when it broadcasts and pixel by pixel when it takes scalars
only.  The host object model (``core/grid.py``, ``core/object.py``,
``core/agent.py``) draws its tiles with them.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
from numpy.typing import NDArray


def downsample(img: NDArray, factor: int) -> NDArray:
    """Mean-pool both spatial dims by ``factor``."""
    assert img.shape[0] % factor == 0 and img.shape[1] % factor == 0
    img = img.reshape(
        img.shape[0] // factor, factor, img.shape[1] // factor, factor, 3
    )
    return img.mean(axis=(1, 3))


def fill_coords(
    img: NDArray,
    fn: Callable[[float, float], bool],
    color,
    bg_color=None,
) -> NDArray:
    """Fill pixels whose center satisfies ``fn`` with color, the rest with
    bg_color if given."""
    ys, xs = np.mgrid[0 : img.shape[0], 0 : img.shape[1]]
    xf = (xs + 0.5) / img.shape[1]
    yf = (ys + 0.5) / img.shape[0]
    try:
        mask = np.asarray(fn(xf, yf), dtype=bool)
        if mask.shape != xf.shape:
            raise TypeError
    except Exception:
        mask = np.zeros(img.shape[:2], dtype=bool)
        for y in range(img.shape[0]):
            for x in range(img.shape[1]):
                mask[y, x] = bool(fn(xf[y, x], yf[y, x]))
    img[mask] = color
    if bg_color is not None:
        img[~mask] = bg_color
    return img


def rotate_fn(fin: Callable, cx: float, cy: float, theta: float) -> Callable:
    """Rotate a predicate about (cx, cy) by ``theta``."""

    def fout(x, y):
        x = x - cx
        y = y - cy
        x2 = cx + x * math.cos(-theta) - y * math.sin(-theta)
        y2 = cy + y * math.cos(-theta) + x * math.sin(-theta)
        return fin(x2, y2)

    return fout


def point_in_line(x0: float, y0: float, x1: float, y1: float, r: float) -> Callable:
    """Within ``r`` of the segment (x0, y0)-(x1, y1)."""
    d = np.array([x1 - x0, y1 - y0], dtype=float)
    dist = float(np.linalg.norm(d))
    d = d / dist

    def fn(x, y):
        a = np.clip((x - x0) * d[0] + (y - y0) * d[1], 0, dist)
        px = x0 + a * d[0]
        py = y0 + a * d[1]
        return (x - px) ** 2 + (y - py) ** 2 <= r * r

    return fn


def point_in_circle(cx: float, cy: float, r: float) -> Callable:
    """Within ``r`` of (cx, cy)."""

    def fn(x, y):
        return (x - cx) ** 2 + (y - cy) ** 2 <= r * r

    return fn


def point_in_rect(xmin: float, xmax: float, ymin: float, ymax: float) -> Callable:
    """Inside the closed rectangle."""

    def fn(x, y):
        return (x >= xmin) & (x <= xmax) & (y >= ymin) & (y <= ymax)

    return fn


def point_in_triangle(a, b, c) -> Callable:
    """Inside the triangle abc, by barycentric coordinates."""
    a = np.array(a, dtype=float)
    b = np.array(b, dtype=float)
    c = np.array(c, dtype=float)

    def fn(x, y):
        v0 = c - a
        v1 = b - a
        v2x = x - a[0]
        v2y = y - a[1]
        dot00 = v0 @ v0
        dot01 = v0 @ v1
        dot11 = v1 @ v1
        dot02 = v0[0] * v2x + v0[1] * v2y
        dot12 = v1[0] * v2x + v1[1] * v2y
        inv = 1.0 / (dot00 * dot11 - dot01 * dot01)
        u = (dot11 * dot02 - dot01 * dot12) * inv
        v = (dot00 * dot12 - dot01 * dot02) * inv
        return (u >= 0) & (v >= 0) & ((u + v) < 1)

    return fn


def highlight_img(img: NDArray, color=(255, 255, 255), alpha: float = 0.30) -> None:
    """Alpha-blend a highlight over an image in place."""
    blend = img + alpha * (np.array(color, dtype=np.float64) - img)
    img[:, :, :] = blend.clip(0, 255).astype(img.dtype)
