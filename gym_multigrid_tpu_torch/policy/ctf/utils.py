"""Grid shortest paths with the reference A*'s tie order (PyTorch port).

Counterpart of ``gym_multigrid_tpu/policy/ctf/utils.py``.  The reference
``a_star`` is a 4-neighbour A* with a Manhattan heuristic over a heap of
``(f, g, h, parent, loc)`` tuples.  Two consequences can be observed:

1. A cell blocks the path only when its map value is 8; CtF maps hold
   0-6, so on every shipped map the search ignores obstacles (the env
   still blocks the move).
2. The heap pops equal-(f, g) nodes in lexicographic order of their
   paths' cell sequences, so the path returned is the lexicographically
   smallest shortest path under (row, col) order.

:func:`a_star` computes that path in closed form on a map with no blocked
cell (a BFS distance field, then a greedy walk that takes the smallest
neighbour one step closer) and runs the faithful best-first search,
:func:`_a_star_heap`, on a map with one.
"""

from __future__ import annotations

from collections import deque
from heapq import heappop, heappush
from typing import NamedTuple, Union

import numpy as np

from gym_multigrid_tpu_torch.utils.map import Position

#: Map value that blocks a path.
BLOCKED_VALUE = 8

_DIRS = ((0, 1), (0, -1), (1, 0), (-1, 0))


class AStarNode(NamedTuple):
    """A search node, as the reference's heap holds it."""

    f: int
    g: int
    h: int
    parent: Union["AStarNode", None]
    loc: Position


def manhattan_distance(p1: Position, p2: Position) -> int:
    """|dx| + |dy|."""
    return abs(int(p1[0]) - int(p2[0])) + abs(int(p1[1]) - int(p2[1]))


def distance_field(map: np.ndarray, end: Position) -> np.ndarray:
    """BFS 4-neighbour distance from every passable cell to ``end``, int32.

    Unreachable and blocked cells hold ``rows * cols + 1``; so does every
    cell when ``end`` itself is off the map or blocked."""
    rows, cols = map.shape
    blocked = np.asarray(map) == BLOCKED_VALUE
    INF = rows * cols + 1
    dist = np.full((rows, cols), INF, dtype=np.int32)
    er, ec = int(end[0]), int(end[1])
    if not (0 <= er < rows and 0 <= ec < cols) or blocked[er, ec]:
        return dist
    dist[er, ec] = 0
    q: deque[tuple[int, int]] = deque([(er, ec)])
    while q:
        r, c = q.popleft()
        d = dist[r, c] + 1
        for dr, dc in _DIRS:
            nr, nc = r + dr, c + dc
            if 0 <= nr < rows and 0 <= nc < cols and not blocked[nr, nc]:
                if d < dist[nr, nc]:
                    dist[nr, nc] = d
                    q.append((nr, nc))
    return dist


def a_star(start: Position, end: Position, map: np.ndarray) -> list[Position]:
    """The reference A*'s path from ``start`` to ``end``; [] if there is
    none.  Closed form (:func:`_lex_shortest`) on a map with no blocked
    cell, where f is constant along every shortest path; the best-first
    search (:func:`_a_star_heap`) on a map with one."""
    fm = np.asarray(map)
    start_t = (int(start[0]), int(start[1]))
    end_t = (int(end[0]), int(end[1]))
    if start_t == end_t:
        return [start_t]
    if (fm == BLOCKED_VALUE).any():
        return _a_star_heap(start_t, end_t, fm)
    return _lex_shortest(start_t, end_t, fm)


def _lex_shortest(start_t, end_t, map: np.ndarray) -> list[Position]:
    """The lexicographically smallest shortest path: from the start, the
    smallest (row, col) neighbour one step closer to the end, until the
    end."""
    rows, cols = np.asarray(map).shape
    dist = distance_field(map, end_t)
    INF = rows * cols + 1
    # The reference expands the start whatever its own map value; its
    # neighbours must be passable.
    r, c = start_t
    d_start = dist[r, c]
    if np.asarray(map)[r, c] == BLOCKED_VALUE:
        best = INF
        for dr, dc in _DIRS:
            nr, nc = r + dr, c + dc
            if 0 <= nr < rows and 0 <= nc < cols:
                best = min(best, dist[nr, nc] + 1)
        d_start = best
    if d_start >= INF:
        return []

    path: list[Position] = [start_t]
    cur, d = start_t, int(d_start)
    while cur != end_t:
        candidates = []
        for dr, dc in _DIRS:
            nr, nc = cur[0] + dr, cur[1] + dc
            if 0 <= nr < rows and 0 <= nc < cols and dist[nr, nc] == d - 1:
                candidates.append((nr, nc))
        nxt = min(candidates)
        path.append(nxt)
        cur, d = nxt, d - 1
    return path


def _a_star_heap(start_t, end_t, fm: np.ndarray) -> list[Position]:
    """Best-first search with the reference's node order: heap entries
    compare as (f, g, h, parent chain, loc), and the open and closed sets
    keep at most one node a cell with the reference's improve-or-skip
    rules, so the pops and the path are the reference's."""
    rows, cols = fm.shape
    h0 = manhattan_distance(start_t, end_t)
    start_node = AStarNode(h0, 0, h0, None, start_t)
    open_heap: list[AStarNode] = [start_node]
    open_by_loc: dict = {start_t: start_node}
    closed_by_loc: dict = {}

    while open_heap:
        current = heappop(open_heap)
        if open_by_loc.get(current.loc) is not current:
            continue  # superseded entry (the reference removes it at once)
        del open_by_loc[current.loc]
        closed_by_loc[current.loc] = current

        if current.loc == end_t:
            path: list[Position] = []
            node: AStarNode | None = current
            while node is not None:
                path.append(node.loc)
                node = node.parent
            path.reverse()
            return path

        for dr, dc in _DIRS:
            new_loc = (current.loc[0] + dr, current.loc[1] + dc)
            if not (0 <= new_loc[0] < rows and 0 <= new_loc[1] < cols):
                continue
            if fm[new_loc] == BLOCKED_VALUE:
                continue
            g = current.g + 1
            h = manhattan_distance(new_loc, end_t)
            node = AStarNode(g + h, g, h, current, new_loc)
            if new_loc in closed_by_loc:
                if node.f < closed_by_loc[new_loc].f:
                    del closed_by_loc[new_loc]
                    open_by_loc[new_loc] = node
                    heappush(open_heap, node)
            elif new_loc in open_by_loc:
                if node.f < open_by_loc[new_loc].f:
                    open_by_loc[new_loc] = node
                    heappush(open_heap, node)
            else:
                open_by_loc[new_loc] = node
                heappush(open_heap, node)

    return []
