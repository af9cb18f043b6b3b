"""The port's host policies and map helpers (``policy/``, ``utils/map.py``)
against the JAX package's, mirroring ``tests/test_policy.py``.

Everything here is integer or numpy float64 arithmetic on the host, the
same code in both packages, so every comparison is exact: paths, distance
fields, targets and actions are equal, and the map helpers' float64
distances are equal bit for bit.  The policies draw from
``np.random.Generator``s seeded alike on both sides.
"""

import os

import numpy as np
import pytest
import torch

from gym_multigrid_tpu.policy.ctf import heuristic as jh
from gym_multigrid_tpu.policy.ctf import utils as ju
from gym_multigrid_tpu.utils import map as jmap
from gym_multigrid_tpu_torch.ops.ctf_slab import _optimal_action
from gym_multigrid_tpu_torch.policy.ctf import heuristic as th
from gym_multigrid_tpu_torch.policy.ctf import utils as tu
from gym_multigrid_tpu_torch.utils import map as tmap

torch.set_num_threads(1)

ASSETS = os.path.join(os.path.dirname(__file__), "assets")
BOARDS = ("board.txt", "board_large.txt", "board_maze.txt")
CTF_BOARDS = ("board.txt", "board_large.txt")
POLICIES = ("RwPolicy", "FightPolicy", "CapturePolicy", "PatrolPolicy", "PatrolFightPolicy")


def _map(name):
    return tmap.load_text_map(os.path.join(ASSETS, name))


def _cells(fm):
    return [(r, c) for r in range(fm.shape[0]) for c in range(fm.shape[1])]


def _blocked(fm, seed, n):
    """``fm`` with ``n`` random cells set to the blocking value 8."""
    fm = fm.copy()
    rng = np.random.default_rng(seed)
    fm.flat[rng.choice(fm.size, size=n, replace=False)] = tu.BLOCKED_VALUE
    return fm


@pytest.mark.parametrize("board", BOARDS)
@pytest.mark.parametrize("blocked", [0, 1], ids=["open", "blocked"])
def test_a_star_and_distance_field_equal_jax(board, blocked):
    """Paths and BFS fields on the three boards, as shipped and with a
    tenth of the cells blocked (value 8: the best-first search with the
    reference's node order), from random starts to random ends."""
    fm = _map(board)
    if blocked:
        fm = _blocked(fm, seed=len(board), n=fm.size // 10)
    assert np.array_equal(tmap.load_text_map(os.path.join(ASSETS, board)),
                          jmap.load_text_map(os.path.join(ASSETS, board)))
    cells = _cells(fm)
    rng = np.random.default_rng(0)
    for _ in range(40 if blocked else 150):
        s, e = cells[rng.integers(len(cells))], cells[rng.integers(len(cells))]
        got = tu.a_star(s, e, fm)
        assert got == ju.a_star(s, e, fm), (s, e)
        if got and not blocked:
            assert len(got) == tu.manhattan_distance(s, e) + 1
    for e in cells[:: max(1, len(cells) // 12)]:
        np.testing.assert_array_equal(tu.distance_field(fm, e), ju.distance_field(fm, e))


def test_a_star_is_shortest_and_valid():
    fm = _map("board.txt")
    cells = _cells(fm)
    for start in cells[::3]:
        for end in cells[::4]:
            path = tu.a_star(start, end, fm)
            assert path[0] == tuple(start) and path[-1] == tuple(end)
            assert len(path) == tu.manhattan_distance(start, end) + 1
            for a, b in zip(path, path[1:]):
                assert tu.manhattan_distance(a, b) == 1


def test_optimal_action_matches_a_star_next_step():
    """The step's closed-form rule (``ctf_slab._optimal_action``) is the
    first move of the port's ``a_star`` path for every (start, target) on
    the board."""
    fm = _map("board.txt")
    act_of_dir = {(0, 0): 0, (0, -1): 1, (-1, 0): 2, (0, 1): 3, (1, 0): 4}
    pairs = [(s, e) for s in _cells(fm)[::2] for e in _cells(fm)]
    want = []
    for s, e in pairs:
        path = tu.a_star(s, e, fm)
        nxt = path[1] if len(path) > 1 else e
        want.append(act_of_dir[(nxt[0] - s[0], nxt[1] - s[1])])
    st, en = (torch.tensor([p[i] for p in pairs], dtype=torch.int32) for i in (0, 1))
    got = _optimal_action(st[:, 0], st[:, 1], en[:, 0], en[:, 1])
    assert got.tolist() == want


def test_search_nodes_and_manhattan():
    assert tu.AStarNode._fields == ju.AStarNode._fields
    rng = np.random.default_rng(1)
    for _ in range(50):
        p, q = rng.integers(-5, 30, 2), rng.integers(-5, 30, 2)
        assert tu.manhattan_distance(p, q) == ju.manhattan_distance(p, q)


def test_map_helpers_equal_jax():
    rng = np.random.default_rng(2)
    for _ in range(50):
        p, q = tuple(rng.integers(0, 20, 2)), tuple(rng.integers(0, 20, 2))
        area = [tuple(x) for x in rng.integers(0, 20, (int(rng.integers(1, 9)), 2))]
        assert tmap.distance_points(p, q) == jmap.distance_points(p, q)
        assert tmap.distance_points(p, q, True) == jmap.distance_points(p, q, True)
        assert tmap.distance_area_point(p, area) == jmap.distance_area_point(p, area)
        assert tmap.position_in_positions(p, area) == jmap.position_in_positions(p, area)
        assert tmap.position_in_positions(area[-1], area)
        assert tmap.closest_area_pos(p, area) == jmap.closest_area_pos(p, area)


@pytest.mark.parametrize("board", CTF_BOARDS)
@pytest.mark.parametrize("ego", ["red", "blue"])
def test_patrol_tables_equal_jax(board, ego):
    """The class's border, obstacles and pool, order and duplicates
    included, and the module functions the step reads."""
    fm = _map(board)
    tp, jp = th.PatrolPolicy(field_map=fm, ego_agent=ego), jh.PatrolPolicy(field_map=fm, ego_agent=ego)
    as_int = lambda cells: [tuple(int(v) for v in p) for p in cells]  # noqa: E731
    assert as_int(tp.border) == as_int(jp.border)
    assert as_int(tp.obstacle) == as_int(jp.obstacle)
    assert as_int(tp.patrol_targets()) == as_int(jp.patrol_targets())
    assert th.locate_border(fm, ego) == (tp.border, tp.obstacle)
    # Built without a map, the border appears once the env gives one.
    late = th.PatrolPolicy(ego_agent=ego)
    late.field_map = fm
    assert late.patrol_targets() == tp.patrol_targets()


def _observations(fm, n, seed, mvn):
    """``n`` positional dict obs with random agents, int64 like the
    adapters' (the fields the policies read), and the acting agent's cell:
    a red agent's, a border cell (the patrol pool's draw), or any."""
    rng = np.random.default_rng(seed)
    border = th.locate_border(fm, "red")[0] + th.locate_border(fm, "blue")[0]
    idx = {"blue_territory": 0, "red_territory": 1, "blue_flag": 4, "red_flag": 5}
    cells = {k: np.argwhere(fm == v) for k, v in idx.items()}
    out = []
    nb, nr = (2, 3) if mvn else (1, 1)
    for _ in range(n):
        agents = rng.integers(0, fm.shape, (nb + nr, 2)).astype(np.int64)
        obs = {
            "blue_agent": agents[:nb].reshape(-1),
            "red_agent": agents[nb:].reshape(-1),
            "blue_flag": cells["blue_flag"][0].astype(np.int64),
            "red_flag": cells["red_flag"][0].astype(np.int64),
            "blue_territory": np.concatenate([cells["blue_territory"], cells["blue_flag"]])
            .astype(np.int64).reshape(-1),
            "red_territory": np.concatenate([cells["red_territory"], cells["red_flag"]])
            .astype(np.int64).reshape(-1),
        }
        u = rng.random()
        curr = (agents[nb] if u < 0.4 else np.asarray(border[rng.integers(len(border))])
                if u < 0.8 else rng.integers(0, fm.shape, 2))
        out.append((obs, curr))
    return out


@pytest.mark.parametrize("board", CTF_BOARDS)
@pytest.mark.parametrize("name", POLICIES)
@pytest.mark.parametrize("ego", ["red", "blue"])
def test_policy_act_equals_jax(board, name, ego):
    """``act`` (and ``get_target`` where there is one) on 50 random
    observations, MvN and 1v1 shaped, with equal-seeded generators: the
    same actions and the same draws, so the generators stay in step."""
    fm = _map(board)
    kw = {} if name == "RwPolicy" else dict(field_map=fm, randomness=0.6)
    if name != "RwPolicy":
        kw["ego_agent"] = ego
    tp = getattr(th, name)(random_generator=np.random.default_rng(5), **kw)
    jp = getattr(jh, name)(random_generator=np.random.default_rng(5), **kw)
    assert (tp.name, tp.spec_kind, tp.action_set.__name__) == (jp.name, jp.spec_kind,
                                                               jp.action_set.__name__)
    for i, (obs, curr) in enumerate(_observations(fm, 50, seed=len(board) + len(name),
                                                  mvn=True) +
                                    _observations(fm, 10, seed=3, mvn=False)):
        if name != "RwPolicy":
            state = tp.random_generator.bit_generator.state
            want_t = jp.get_target(obs, curr)
            got_t = tp.get_target(obs, curr)
            assert tuple(int(v) for v in got_t) == tuple(int(v) for v in want_t), i
            # get_target may draw (the patrol pool): rewind both alike
            tp.random_generator.bit_generator.state = state
            jp.random_generator.bit_generator.state = state
        assert tp.act(obs, curr) == jp.act(obs, curr), i
    assert tp.random_generator.random() == jp.random_generator.random()


def test_action_sets_equal_jax():
    from gym_multigrid_tpu.core import actions as ja
    from gym_multigrid_tpu_torch.core import actions as ta

    names = [n for n in dir(ja) if n.endswith("Actions")]
    assert len(names) == 7
    for n in names:
        assert [(m.name, m.value) for m in getattr(ta, n)] == [
            (m.name, m.value) for m in getattr(ja, n)]
