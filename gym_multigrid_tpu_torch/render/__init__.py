"""Sprite-bank renderer and matplotlib window (PyTorch port).

``Window`` is imported on first use, not with the package: matplotlib is
not needed to render frames."""

from gym_multigrid_tpu_torch.render.tiles import (
    assemble,
    render_collect,
    render_collect_batch,
    render_ctf,
    render_ctf_batch,
    render_maze,
    render_maze_batch,
    render_tile,
    render_wildfire,
    render_wildfire_batch,
)

__all__ = [
    "assemble",
    "render_collect",
    "render_collect_batch",
    "render_ctf",
    "render_ctf_batch",
    "render_maze",
    "render_maze_batch",
    "render_tile",
    "render_wildfire",
    "render_wildfire_batch",
    "Window",
]


def __getattr__(name):
    if name == "Window":
        from gym_multigrid_tpu_torch.render.window import Window

        return Window
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
