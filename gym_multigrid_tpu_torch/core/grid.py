"""Grid container of the host object model (PyTorch port).

Counterpart of ``gym_multigrid_tpu/core/grid.py``: set/get, wall
builders, rotate_left/slice, encode/encode_for_agents, the shadow cast
``process_vis`` (vectorised row sweeps) and ``render`` (tiles drawn with
``utils/rendering.py``, cached per encode) over the flat ``j * width + i``
cell list, host numpy.  The batched engines bypass this class: their grid
is the encoded tensor (``envs/*.py``).
"""

from __future__ import annotations

import numpy as np

from gym_multigrid_tpu_torch.core.constants import TILE_PIXELS
from gym_multigrid_tpu_torch.core.object import Wall, WorldObj
from gym_multigrid_tpu_torch.core.world import World


class Grid:
    """W x H cell container, cell = WorldObj | None."""

    #: class-level cache of rasterized tiles, keyed like the reference
    #: (obj.encode() + highlights + tile_size; grid.py:146-149)
    tile_cache: dict = {}

    def __init__(self, width: int, height: int, world: World):
        assert width >= 3 and height >= 3
        self.width = width
        self.height = height
        self.world = world
        self.grid: list[WorldObj | None] = [None] * (width * height)

    # -- basic access ------------------------------------------------------
    def set(self, i: int, j: int, v: WorldObj | None) -> None:
        assert 0 <= i < self.width and 0 <= j < self.height
        self.grid[j * self.width + i] = v

    def get(self, i: int, j: int) -> WorldObj | None:
        assert 0 <= i < self.width and 0 <= j < self.height
        return self.grid[j * self.width + i]

    def __contains__(self, key) -> bool:
        if isinstance(key, WorldObj):
            return any(e is key for e in self.grid)
        if isinstance(key, tuple):
            for e in self.grid:
                if e is None:
                    continue
                if (e.color, e.type) == key:
                    return True
                if key[0] is None and key[1] == e.type:
                    return True
        return False

    def __eq__(self, other: "Grid") -> bool:
        return np.array_equal(self.encode(), other.encode())

    def __ne__(self, other: "Grid") -> bool:
        return not self == other

    def copy(self) -> "Grid":
        from copy import deepcopy

        return deepcopy(self)

    # -- construction helpers ----------------------------------------------
    def horz_wall(self, x: int, y: int, length: int | None = None, obj_type=Wall):
        length = self.width - x if length is None else length
        for i in range(length):
            self.set(x + i, y, obj_type(self.world))

    def vert_wall(self, x: int, y: int, length: int | None = None, obj_type=Wall):
        length = self.height - y if length is None else length
        for j in range(length):
            self.set(x, y + j, obj_type(self.world))

    def wall_rect(self, x: int, y: int, w: int, h: int) -> None:
        self.horz_wall(x, y, w)
        self.horz_wall(x, y + h - 1, w)
        self.vert_wall(x, y, h)
        self.vert_wall(x + w - 1, y, h)

    # -- view transforms ----------------------------------------------------
    def rotate_left(self) -> "Grid":
        """Counter-clockwise rotation."""
        out = Grid(self.height, self.width, self.world)
        for i in range(self.width):
            for j in range(self.height):
                out.set(j, out.height - 1 - i, self.get(i, j))
        return out

    def slice(self, topX: int, topY: int, width: int, height: int) -> "Grid":
        """Sub-grid; out-of-bounds cells become walls (grid.py:111-130).

        Worlds without a "wall" type (CtF, Maze) use their canonical
        impassable object instead — a sight-blocking grey Obstacle.  The
        reference would KeyError here (its partial-obs pipeline is dead
        code upstream, SURVEY.md §2.2); this choice makes gen_obs total
        for every shipped world and is mirrored by the in-graph pipeline
        (envs/partial_obs.py wall_encode per family)."""
        out = Grid(width, height, self.world)
        if "wall" in self.world.OBJECT_TO_IDX:
            def boundary():
                return Wall(self.world)
        elif "obstacle" in self.world.OBJECT_TO_IDX:
            from gym_multigrid_tpu_torch.core.object import Obstacle

            def boundary():
                return Obstacle(self.world, can_see_through=False)
        else:
            def boundary():
                raise KeyError(
                    f"world {self.world!r} has neither 'wall' nor "
                    "'obstacle'; cannot fill out-of-bounds view cells"
                )
        for j in range(height):
            for i in range(width):
                x, y = topX + i, topY + j
                if 0 <= x < self.width and 0 <= y < self.height:
                    out.set(i, j, self.get(x, y))
                else:
                    out.set(i, j, boundary())
        return out

    # -- encoding ----------------------------------------------------------
    def _encode_with(self, encode_cell, vis_mask=None) -> np.ndarray:
        dim = self.world.encode_dim
        # Worlds without an "empty" type (CtF/Maze boards are fully
        # painted, so no cell is ever None) background to 0.
        empty_idx = self.world.OBJECT_TO_IDX.get("empty", 0)
        array = np.zeros((self.width, self.height, dim), dtype=np.uint8)
        array[:, :, 0] = empty_idx
        if vis_mask is None:
            vis_mask = np.ones((self.width, self.height), dtype=bool)
        for i in range(self.width):
            for j in range(self.height):
                if not vis_mask[i, j]:
                    array[i, j, 0] = 0
                    continue
                v = self.get(i, j)
                if v is not None:
                    array[i, j, :] = encode_cell(v, i, j)
        return array

    def encode(self, vis_mask=None) -> np.ndarray:
        """(W, H, encode_dim) uint8, empty cells = OBJECT_TO_IDX['empty'].

        Parity quirk: the reference passes the world object as the
        ``current_agent`` flag (grid.py:241 ``v.encode(self.world)``), which
        is truthy — so 6-dim agent encodes set the current-agent bit for
        every agent.  Reproduced.
        """
        return self._encode_with(lambda v, i, j: v.encode(True), vis_mask)

    def encode_for_agents(self, agent_pos, vis_mask=None) -> np.ndarray:
        """Like encode, with the current-agent bit set only at agent_pos."""
        return self._encode_with(
            lambda v, i, j: v.encode(
                current_agent=np.array_equal(agent_pos, (i, j))
            ),
            vis_mask,
        )

    # -- visibility ---------------------------------------------------------
    def process_vis(self, agent_pos) -> np.ndarray:
        """Shadow-casting visibility from the agent cell (observable
        behavior of reference grid.py:286-323), computed with vectorized
        row sweeps instead of the reference's per-cell loops.

        Per row (bottom-up), light propagates sideways through runs of
        see-through cells and spills one row up (straight + diagonal).  A
        sideways pass has the closed form: cell i is lit iff some already
        lit cell sits between it and the nearest opaque cell on the
        propagation side — one running-maximum (nearest-blocker index) and
        one prefix-sum (any-lit-in-window) per pass.
        """
        w, h = self.width, self.height
        see = np.ones((w, h), dtype=bool)
        for j in range(h):
            for i in range(w):
                cell = self.get(i, j)
                if cell is not None and not cell.see_behind():
                    see[i, j] = False

        mask = np.zeros((w, h), dtype=bool)
        mask[agent_pos[0], agent_pos[1]] = True
        idx = np.arange(w)

        def sweep(row, s):
            """One left-to-right pass: lit[i] |= any lit j < i with
            see[j..i-1] all True (the transitive propagation chain)."""
            # nearest blocker strictly left of i (-1 if none)
            r = np.concatenate(
                ([-1], np.maximum.accumulate(np.where(~s, idx, -1))[:-1])
            )
            # prefix sums of lit cells: any lit in (r[i], i) ?
            P = np.concatenate(([0], np.cumsum(row)))
            return row | (P[idx] - P[r + 1] > 0)

        for j in reversed(range(h)):
            s = see[:, j]
            lit1 = sweep(mask[:, j], s)  # eastward pass
            lit2 = sweep(lit1[::-1], s[::-1])[::-1]  # westward pass
            mask[:, j] = lit2
            if j > 0:
                # Spill-up: every processed (lit, see-through) cell lights
                # its straight-up and pass-direction diagonal neighbors.
                p1 = lit1 & s
                p1[w - 1] = False  # east pass visits i <= w-2
                p2 = lit2 & s
                p2[0] = False  # west pass visits i >= 1
                below = mask[:, j - 1]
                below |= p1 | p2
                below[1:] |= p1[:-1]  # (i+1, j-1) from the east pass
                below[:-1] |= p2[1:]  # (i-1, j-1) from the west pass

        for j in range(h):
            for i in range(w):
                if not mask[i, j]:
                    self.set(i, j, None)
        return mask

    # -- rendering ----------------------------------------------------------
    @classmethod
    def render_tile(
        cls,
        world: World,
        obj: WorldObj | None,
        highlights: list = [],
        tile_size: int = TILE_PIXELS,
        subdivs: int = 3,
        cache: bool = True,
    ) -> np.ndarray:
        """Rasterize one tile with the reference's cache key and grid lines,
        using the vectorized raster helpers."""
        from gym_multigrid_tpu_torch.utils.rendering import (
            downsample,
            fill_coords,
            highlight_img,
            point_in_rect,
        )

        key = (*highlights, tile_size)
        key = obj.encode() + key if obj else key
        if cache and key in cls.tile_cache:
            return cls.tile_cache[key]

        img = np.zeros((tile_size * subdivs, tile_size * subdivs, 3), dtype=np.uint8)
        if obj is not None:
            obj.render(img)
        fill_coords(img, point_in_rect(0, 0.031, 0, 1), (100, 100, 100))
        fill_coords(img, point_in_rect(0, 1, 0, 0.031), (100, 100, 100))
        for h in highlights:
            highlight_img(
                img,
                color=world.COLORS[world.IDX_TO_COLOR[h % len(world.IDX_TO_COLOR)]],
            )
        img = downsample(img, subdivs).astype(np.uint8)
        if cache:
            cls.tile_cache[key] = img
        return img

    def render(
        self,
        tile_size: int,
        highlight_masks=None,
        uncached_object_types: list[str] = [],
    ) -> np.ndarray:
        """Full-grid rgb frame."""
        img = np.zeros(
            (self.height * tile_size, self.width * tile_size, 3), dtype=np.uint8
        )
        for j in range(self.height):
            for i in range(self.width):
                cell = self.get(i, j)
                cache = not (cell is not None and cell.type in uncached_object_types)
                tile = Grid.render_tile(
                    self.world,
                    cell,
                    highlights=[]
                    if highlight_masks is None
                    else highlight_masks[i, j],
                    tile_size=tile_size,
                    cache=cache,
                )
                img[
                    j * tile_size : (j + 1) * tile_size,
                    i * tile_size : (i + 1) * tile_size,
                ] = tile
        return img
