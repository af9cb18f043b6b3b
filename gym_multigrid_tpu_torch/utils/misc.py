"""Host utilities (PyTorch port of ``gym_multigrid_tpu/utils/misc.py``)."""

from __future__ import annotations

import dataclasses
import os
import random

import numpy as np
import torch


def set_seed(seed: int = 42) -> None:
    """Seed every host RNG the package may touch: numpy's and the standard
    library's global streams, torch's (CUDA's too where present, with
    cuDNN made deterministic), and ``PYTHONHASHSEED``."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
    if torch.cuda.is_available():
        torch.cuda.manual_seed(seed)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    os.environ["PYTHONHASHSEED"] = str(seed)
    print(f"Random seed set as {seed}")


def save_frames_as_gif(frames, path: str = "./", filename: str = "collect-", ep: int = 0) -> None:
    """Write an episode's frames to ``<path><filename><ep>.gif`` with
    imageio, imported here: the package runs without it."""
    import imageio

    out = os.path.join(path, f"{filename}{ep}.gif")
    imageio.mimsave(out, [np.asarray(f, dtype=np.uint8) for f in frames], duration=1000 / 60)


def tree_map(fn, tree):
    """``fn`` applied to every tensor leaf of ``tree`` (NamedTuples,
    dataclasses, dicts, lists and tuples, nested); other leaves are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init
        })
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return tree


def tree_leaves(tree) -> list:
    """The tensor leaves of ``tree``, in :func:`tree_map`'s order."""
    leaves = []
    tree_map(leaves.append, tree)
    return leaves
