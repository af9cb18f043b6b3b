"""Maze slab math: one transition and one spawn draw for a batch of envs
(PyTorch port).

Counterpart of the slab functions of ``gym_multigrid_tpu/envs/maze.py``
and of ``gym_multigrid_tpu/ops/pallas_maze.py``: the Pallas kernel
``maze_step_slab`` is the hand-written CUDA kernel
``gym_multigrid_tpu_torch/csrc/maze_step.cu``, its plain body
``maze_step_math`` is :func:`step_spec` here, and ``maze_reset_math`` is
:func:`reset_spec`.

* :func:`maze_step_slab` takes the plain version for tensors on the CPU and
  launches the kernel for CUDA tensors, which reads the move from the
  step tabulated by :func:`ms_table`; it takes every map.  The K-step
  entry holds that table in shared memory, and a slab whose table does
  not fit takes the plain route on the episode path instead
  (:func:`kernel_route`, decided when the slab is built): never a
  fallback.
* The reset has no kernel, here as in the JAX package: :func:`reset_spec`
  runs as PyTorch tensor ops on whatever device its inputs are on.  It
  reads the spawn cell with a gather; JAX's one-hot reduce over a packed
  ``row | col << 8`` word is a TPU workaround and is not carried over.
* :func:`step_batch` / :func:`reset_batch` are the batch glue of
  ``make_maze_step_batch`` and of the auto-reset in ``_maze_ms_math``.
  The step draws no randomness; the reset's uniforms come from a
  ``torch.Generator``, or from an ``rnd`` tensor used as is (which is how
  the tests hold it to JAX bit for bit).
* :func:`ms_spec` is ``_maze_ms_math``: K steps with the per-env auto-reset
  and the return accounting, on pre-drawn actions and uniforms.
  :func:`ms_philox_spec` is the same on the draws of ``ops/philox.py``'s
  ``MAZE`` counters, with the per-env sums carried in and the position
  packed as one cell index; :func:`maze_philox_slab` runs it, or for CUDA
  tensors the kernel entry ``maze_steps_philox`` of ``csrc/maze_step.cu``,
  which makes its draws and runs all K steps in one launch.
  :func:`make_maze_episode_rollout` drives it chunk by chunk, the
  counterpart of JAX's ``make_maze_episode_rollout``.

Every float constant of the step is a double rounded to float32 once,
where the JAX package's weakly typed Python floats meet a float32 array.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from gym_multigrid_tpu_torch.core.constants import CTF_ACTION_TO_VEC
from gym_multigrid_tpu_torch.envs.maze import (
    BACKGROUND,
    FLAG,
    M_OBSTACLE,
    NUM_ACTIONS,
    SPAWN_DIR,
    MazeConfig,
    MazeState,
    encode,
    info,
)
from gym_multigrid_tpu_torch.ops import _build, philox
from gym_multigrid_tpu_torch.utils.profiling import annotate

# The render direction of each action: stay/left/down/right/up.
_A2DIR = (3, 3, 2, 1, 0)
# A direction no action gives: in the K-step table it means "unchanged".
_KEEP_DIR = 4
#: Shared memory a block of the K-step kernel can hold its table in: the
#: card's 232,448 bytes a block less its ring of draws, two windows of 16
#: steps of 64 envs' packed draws (8,192 bytes).
MS_MAX_TABLE_BYTES = 232_448 - 2 * 16 * 64 * 4


class MazeTables(NamedTuple):
    """Static per-config tables of the step (the JAX ``MazeTables``)."""

    s0: int
    s1: int
    n_cells: int
    flag_reward: float
    obstacle_penalty: float
    step_penalty: float
    max_steps: int
    action_d0: tuple[int, ...]  # row (pos[0]) deltas per action
    action_d1: tuple[int, ...]


def maze_tables(cfg: MazeConfig) -> MazeTables:
    fm = cfg.field_map
    return MazeTables(
        s0=int(fm.shape[0]),
        s1=int(fm.shape[1]),
        n_cells=int(fm.size),
        flag_reward=float(cfg.flag_reward),
        obstacle_penalty=float(cfg.obstacle_penalty),
        step_penalty=float(cfg.step_penalty),
        max_steps=int(cfg.max_steps),
        action_d0=tuple(int(v[0]) for v in CTF_ACTION_TO_VEC),
        action_d1=tuple(int(v[1]) for v in CTF_ACTION_TO_VEC),
    )


def maze_static_inputs(cfg: MazeConfig, device="cpu"):
    """(cells (3, N), bg (2, n_bg)) int32 on ``device``.

    cells rows: can_enter, flag, obstacle, flat index ``row * S1 + col``;
    every cell can be entered when the obstacle penalty is on.  bg is the
    background cells as (row; col) rows, row-major."""
    fm = cfg.field_map
    cells = np.zeros((3, fm.size), dtype=np.int32)
    if cfg.obstacle_penalty != 0:
        cells[0] = 1
    else:
        cells[0] = (fm != M_OBSTACLE).reshape(-1)
    cells[1] = (fm == FLAG).reshape(-1)
    cells[2] = (fm == M_OBSTACLE).reshape(-1)
    bg = np.argwhere(fm == BACKGROUND).astype(np.int32).T.copy()
    return torch.as_tensor(cells, device=device), torch.as_tensor(bg, device=device)


# ---------------------------------------------------------------------------
# Step
# ---------------------------------------------------------------------------


def step_spec(t: MazeTables, pos, dirs, acts, cells):
    """One Maze transition for a batch, in plain PyTorch.

    pos: (B, 2) int32; dirs, acts: (B, 1) int32 (ids outside 0..4 are
    clipped); cells: (3, N) int32 rows of :func:`maze_static_inputs`.
    Returns (pos, dirs, reward (B, 1) float32, terminated (B, 1) int32).
    """
    dev = pos.device

    def f32(v):
        """A double rounded to float32 once, kept as a Python float: a
        float32 tensor op takes it without another rounding."""
        return float(np.float32(v))

    def cell_flag(row, c0, c1):  # static cell flag at the clipped position
        q = c0.clamp(0, t.s0 - 1) * t.s1 + c1.clamp(0, t.s1 - 1)
        return cells[row][q.long()] > 0

    p0, p1 = pos[:, 0:1], pos[:, 1:2]
    acts = acts.clamp(0, NUM_ACTIONS - 1).long()
    n0 = p0 + torch.tensor(t.action_d0, dtype=torch.int32, device=dev)[acts]
    n1 = p1 + torch.tensor(t.action_d1, dtype=torch.int32, device=dev)[acts]
    inb = (n0 >= 0) & (n1 >= 0) & (n0 < t.s0) & (n1 < t.s1)
    # stay never moves; a blocked move keeps position and direction
    can_move = inb & cell_flag(0, n0, n1) & (acts != 0)
    p0 = torch.where(can_move, n0, p0)
    p1 = torch.where(can_move, n1, p1)
    new_dir = torch.tensor(_A2DIR, dtype=torch.int32, device=dev)[acts]
    dirs = torch.where(can_move, new_dir, dirs)

    on_flag = cell_flag(1, p0, p1)
    reward = f32(t.flag_reward) * on_flag.to(torch.float32)
    terminated = on_flag
    if t.obstacle_penalty != 0:
        on_obs = cell_flag(2, p0, p1)
        reward = reward - f32(t.obstacle_penalty) * on_obs.to(torch.float32)
        terminated = terminated | on_obs
    reward = reward - f32(t.step_penalty)
    return torch.cat([p0, p1], dim=1), dirs, reward, terminated.to(torch.int32)


def maze_step_slab(t: MazeTables, pos, dirs, acts, cells, table=None):
    """One transition of the batch: :func:`step_spec` for CPU tensors, the
    CUDA kernel ``csrc/maze_step.cu`` for CUDA tensors (new output tensors;
    the inputs are not changed).  Same arguments and results as
    :func:`step_spec`; the kernel also reads ``table``, the map's
    :func:`ms_table` on the same device (``MazeSlab.ms_table``), which the
    plain version does not need."""
    if pos.device.type == "cpu":
        return step_spec(t, pos, dirs, acts, cells)
    if pos.device.type != "cuda":
        raise ValueError(f"no Maze step for tensors on {pos.device}")
    B = pos.shape[0]
    if B < 1:
        raise ValueError("an empty batch has nothing to step")
    if table is None:
        raise ValueError("the Maze step kernel reads the map's ms_table: pass table")
    dev = pos.device
    for name, x, dtype, shape in (
        ("pos", pos, torch.int32, (B, 2)),
        ("dirs", dirs, torch.int32, (B, 1)),
        ("acts", acts, torch.int32, (B, 1)),
        ("cells", cells, torch.int32, (3, t.n_cells)),
        ("table", table, torch.int32, (table.numel(),)),
    ):
        _build.check_arg(name, x, dtype, shape, dev)
    if table.numel() < 2 * NUM_ACTIONS * t.n_cells:
        raise ValueError(f"table: {table.numel()} entries, fewer than the map's "
                         f"{2 * NUM_ACTIONS * t.n_cells} moves and rewards")
    outs = (
        torch.empty_like(pos), torch.empty_like(dirs),
        torch.empty((B, 1), dtype=torch.float32, device=dev),
        torch.empty((B, 1), dtype=torch.int32, device=dev),
    )
    # Float constants: doubles rounded to float32 once, as the plain
    # version's f32() does; ctypes passes each as a C float.
    kernels = _build.load()
    with torch.cuda.device(dev):
        err = kernels.maze_step(
            pos.data_ptr(), dirs.data_ptr(), acts.data_ptr(), cells.data_ptr(),
            table.data_ptr(), *(o.data_ptr() for o in outs),
            B, t.s0, t.s1, int(t.obstacle_penalty != 0),
            t.flag_reward, t.obstacle_penalty, t.step_penalty,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"maze_step kernel launch failed: CUDA error {err}")
    maze_step_slab.launches += 1
    return outs


#: Launches of the step kernel since the count was last set to 0.
maze_step_slab.launches = 0


# ---------------------------------------------------------------------------
# Reset (no kernel: plain PyTorch on the batch's device)
# ---------------------------------------------------------------------------


def reset_spec(t: MazeTables, rnd, bg):
    """Spawn cells uniform over the background: the
    ``min(floor(u * n_bg), n_bg - 1)``-th background cell, float32 product
    truncated.  rnd: (B, 1) float32; bg: (2, n_bg) int32.  Returns
    (pos (B, 2) int32, dirs (B, 1) int32, all ``SPAWN_DIR``)."""
    n_bg = bg.shape[1]
    j = ((rnd * n_bg).to(torch.int32)).clamp(max=n_bg - 1)
    pos = bg[:, j[:, 0].long()].T.contiguous()
    return pos, torch.full_like(j, SPAWN_DIR)


# ---------------------------------------------------------------------------
# K steps with the auto-reset
# ---------------------------------------------------------------------------


def ms_spec(t: MazeTables, K: int, pos, dirs, sc, run_ret, acts, rnd, cells, bg):
    """K Maze steps with the per-env auto-reset and the return accounting,
    in plain PyTorch: ``_maze_ms_math`` with one row of draws a step.

    pos (B, 2) int32; dirs, sc (B,) int32; run_ret (B,) float32, the return
    of each episode in progress; acts (K, B) int32 ids (clipped as by
    :func:`step_spec`); rnd (K, B) float32 spawn uniforms, one an env a step,
    read by every env whether it finished or not; cells and bg as for
    :func:`step_spec` and :func:`reset_spec`.  Returns (pos, dirs, sc,
    run_ret, rew_sum, ep_sum, eps): the state after the K steps and, per
    env, the sum of its rewards, the summed returns of the episodes it
    finished (float32) and how many it finished (int32), all (B,).  Every
    sum is taken one step at a time in JAX's order."""
    zeros = torch.zeros((pos.shape[0],), dtype=torch.float32, device=pos.device)
    return _ms_steps(t, K, pos, dirs, sc, run_ret, zeros, zeros,
                     torch.zeros_like(zeros, dtype=torch.int32), acts, rnd, cells, bg)


def _ms_steps(t: MazeTables, K: int, pos, dirs, sc, run_ret, rew_sum, ep_sum, eps, acts, rnd,
              cells, bg):
    """:func:`ms_spec` with its three sums started at ``rew_sum``,
    ``ep_sum`` and ``eps`` (B,) instead of at 0: each step's terms are
    added to them one step at a time."""
    for k in range(K):
        pos2, dirs2, reward, term = step_spec(t, pos, dirs[:, None], acts[k][:, None], cells)
        reward, sc2 = reward[:, 0], sc + 1
        done = (term[:, 0] == 1) | (sc2 >= t.max_steps)
        run2 = run_ret + reward
        rew_sum = rew_sum + reward
        ep_sum = ep_sum + torch.where(done, run2, 0.0)
        eps = eps + done.to(torch.int32)
        run_ret = torch.where(done, 0.0, run2)
        spawn, _ = reset_spec(t, rnd[k][:, None], bg)
        pos = torch.where(done[:, None], spawn, pos2)
        dirs = torch.where(done, SPAWN_DIR, dirs2[:, 0])
        sc = torch.where(done, 0, sc2)
    return pos, dirs, sc, run_ret, rew_sum, ep_sum, eps


def ms_table(t: MazeTables, cells, bg):
    """The K-step kernel's table, (10 N + n_bg) int32 padded with zeros to a
    multiple of 4, on the device of ``cells``.

    :func:`step_spec` tabulated over every (cell, action): entry
    ``cell * 5 + a`` of the first 5 N holds ``(next * 5) << 4 | dir << 1 |
    terminated``, with ``next`` the cell the move ends on and ``dir`` its
    direction after the move, or 4 where the move leaves it as it was;
    the next 5 N hold the move's reward as float32 bits; the last n_bg hold
    ``cell * 5`` of each background cell, in :func:`reset_spec`'s order.
    So a move is one table read, and the kernel does the same arithmetic as
    the plain version by reading its results."""
    N, dev = t.n_cells, cells.device
    cell = torch.arange(N, dtype=torch.int32, device=dev).repeat_interleave(NUM_ACTIONS)
    acts = torch.arange(NUM_ACTIONS, dtype=torch.int32, device=dev).repeat(N)
    pos = torch.stack([cell // t.s1, cell % t.s1], dim=1)
    keep = torch.full((N * NUM_ACTIONS, 1), _KEEP_DIR, dtype=torch.int32, device=dev)
    npos, ndir, reward, term = step_spec(t, pos, keep, acts[:, None], cells)
    nxt = npos[:, 0] * t.s1 + npos[:, 1]
    moves = ((nxt * NUM_ACTIONS) << 4) | (ndir[:, 0] << 1) | term[:, 0]
    spawns = (bg[0] * t.s1 + bg[1]) * NUM_ACTIONS
    table = torch.cat([moves, reward[:, 0].view(torch.int32), spawns])
    return torch.nn.functional.pad(table, (0, -table.numel() % 4))


def ms_table_bytes(t: MazeTables, n_bg: int) -> int:
    """The bytes of :func:`ms_table` for a map of ``t`` with ``n_bg``
    background cells."""
    n = 2 * NUM_ACTIONS * t.n_cells + n_bg
    return 4 * (n + -n % 4)


def kernel_route(t: MazeTables, n_bg: int, device_type: str) -> bool:
    """The route of the episode path of a slab of ``t`` (``n_bg``
    background cells) on a device of this type, decided once when the slab
    is built: True for :func:`maze_philox_slab`, which launches the K-step
    kernel on the card and runs :func:`ms_philox_spec` on the CPU; False
    for :func:`ms_philox_spec` on the device's tensors directly.  The CPU takes every
    map on the first route; off the CPU only a map whose table fits the
    kernel's shared memory (``MS_MAX_TABLE_BYTES``) does.  The one-step
    kernel takes every map, so the batch path always launches it."""
    return device_type == "cpu" or ms_table_bytes(t, n_bg) <= MS_MAX_TABLE_BYTES


def ms_philox_spec(slab: "MazeSlab", K: int, cell, dirs, sc, run_ret, rew_sum, ep_sum, eps,
                   key, step0: int):
    """K Maze steps of the episode path in plain PyTorch, on the draws of
    ``ops/philox.py``'s ``MAZE`` counters: the global steps ``step0 ..
    step0 + K - 1`` of the rollout keyed by ``key``.  The plain version of
    :func:`maze_philox_slab`.

    cell (B,) int32, each position packed as ``row * S1 + col``; dirs, sc
    (B,) int32; run_ret (B,) float32; rew_sum, ep_sum (B,) float32 and eps
    (B,) int32, the sums so far, to which each step's terms are added one
    step at a time in ``_maze_ms_math``'s order.  Forms the actions and the
    spawn uniforms from the counters (``philox.maze_draws``) and runs
    :func:`ms_spec`'s steps on them.  Returns (cell, dirs, sc, run_ret,
    rew_sum, ep_sum, eps) after the K steps."""
    t, s1 = slab.t, slab.t.s1
    acts, rnd = philox.maze_draws(key, step0, K, cell.shape[0], cell.device)
    pos = torch.stack([cell // s1, cell % s1], dim=1)
    pos, *rest = _ms_steps(t, K, pos, dirs, sc, run_ret, rew_sum, ep_sum, eps, acts, rnd,
                           slab.cells, slab.bg)
    return (pos[:, 0] * s1 + pos[:, 1], *rest)


def maze_philox_slab(slab: "MazeSlab", K: int, cell, dirs, sc, run_ret, rew_sum, ep_sum, eps,
                     key, step0: int):
    """K steps of the Maze episode path: :func:`ms_philox_spec` for CPU
    tensors, the CUDA kernel entry ``maze_steps_philox`` of
    ``csrc/maze_step.cu`` for CUDA tensors, one launch for all K steps that
    makes each draw where it is read and reads no action or uniform from
    memory (new output tensors; the inputs are not changed).  Same
    arguments and results as :func:`ms_philox_spec`.  The kernel holds
    ``slab.ms_table`` in shared memory: a map whose table does not fit
    takes :func:`ms_philox_spec` on its device by the slab's route
    (:func:`kernel_route`), and this wrapper refuses it.  Cells must lie
    on the board, as every reset and step leaves them."""
    if cell.device.type == "cpu":
        return ms_philox_spec(slab, K, cell, dirs, sc, run_ret, rew_sum, ep_sum, eps, key, step0)
    if cell.device.type != "cuda":
        raise ValueError(f"no Maze steps for tensors on {cell.device}")
    B = cell.shape[0]
    if B < 1 or K < 1:
        raise ValueError(f"nothing to step: {B} envs, {K} steps")
    table = slab.ms_table
    if table.numel() * 4 > MS_MAX_TABLE_BYTES:
        raise ValueError(
            f"the Maze K-step kernel holds its table in at most {MS_MAX_TABLE_BYTES} "
            f"bytes of shared memory; this map needs {table.numel() * 4}"
        )
    dev = cell.device
    ints, floats = (cell, dirs, sc, eps), (run_ret, rew_sum, ep_sum)
    for name, x in zip(("cell", "dirs", "sc", "eps"), ints):
        _build.check_arg(name, x, torch.int32, (B,), dev)
    for name, x in zip(("run_ret", "rew_sum", "ep_sum"), floats):
        _build.check_arg(name, x, torch.float32, (B,), dev)
    _build.check_arg("table", table, torch.int32, (table.numel(),), dev)
    # One allocation for the seven outputs, the float rows viewed as such.
    out = torch.empty((7, B), dtype=torch.int32, device=dev)
    kernels = _build.load()
    with torch.cuda.device(dev):
        err = kernels.maze_steps_philox(
            cell.data_ptr(), dirs.data_ptr(), sc.data_ptr(), run_ret.data_ptr(),
            rew_sum.data_ptr(), ep_sum.data_ptr(), eps.data_ptr(), table.data_ptr(),
            *(row.data_ptr() for row in out),
            B, K, slab.t.n_cells * NUM_ACTIONS, slab.bg.shape[1], slab.t.max_steps,
            *(philox.signed(w) for w in (*key, step0)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"maze_steps_philox kernel launch failed: CUDA error {err}")
    maze_philox_slab.launches += 1
    as_float = out[3:6].view(torch.float32)
    return out[0], out[1], out[2], as_float[0], as_float[1], as_float[2], out[6]


#: Launches of the K-step kernel since the count was last set to 0.
maze_philox_slab.launches = 0


# ---------------------------------------------------------------------------
# Batch glue
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class MazeSlab:
    """Everything the batch glue needs for one config on one device."""

    cfg: MazeConfig
    device: torch.device
    t: MazeTables
    cells: torch.Tensor  # (3, N) int32
    bg: torch.Tensor  # (2, n_bg) int32
    ms_table: torch.Tensor  # the kernels' table (:func:`ms_table`)
    #: The episode path's route (:func:`kernel_route`): the K-step kernel
    #: wrapper, or :func:`ms_philox_spec` on the slab's device.
    kernel: bool
    #: (N, 2) int32: the (row, col) of each cell index, one gather to
    #: unpack the episode path's packed positions.
    cell_pos: torch.Tensor

    #: Uniforms one env's reset takes; the step takes none.
    reset_draws = 1


def make_maze_slab(cfg: MazeConfig, device) -> MazeSlab:
    """The slab of ``cfg`` on ``device``.  The one-step kernel takes any
    map: it reads :func:`ms_table` through the read-only cache.  The K-step
    kernel holds that table in shared memory, and the episode path of a
    map whose table does not fit runs :func:`ms_philox_spec` on the card
    (:func:`kernel_route`)."""
    device = torch.device(device)
    cells, bg = maze_static_inputs(cfg, device)
    if bg.shape[1] == 0:
        raise ValueError("the map has no background cell to spawn on")
    t = maze_tables(cfg)
    cell = torch.arange(t.n_cells, dtype=torch.int32, device=device)
    return MazeSlab(cfg, device, t, cells, bg, ms_table(t, cells, bg),
                    kernel_route(t, bg.shape[1], device.type),
                    torch.stack([cell // t.s1, cell % t.s1], dim=1))


def step_batch(
    slab: MazeSlab,
    states: MazeState,
    actions: torch.Tensor,
    *,
    generator: torch.Generator | None = None,
    encode_obs: bool = True,
    with_info: bool = True,
):
    """Batch-level Maze step.  ``actions`` (B,) ids; the step draws no
    randomness, so ``generator`` is not used (it is taken for the batch
    env's common step interface).

    Returns (states', obs, reward (B,) float32, terminated (B,),
    truncated (B,), info).  ``encode_obs=False`` and ``with_info=False``
    return None for the obs and the info."""
    B = states.pos.shape[0]
    pos, dirs, reward, term = maze_step_slab(
        slab.t,
        states.pos,
        states.dir.reshape(B, 1),
        actions.reshape(B, 1).to(torch.int32).contiguous(),
        slab.cells,
        slab.ms_table,
    )
    step_count = states.step_count + 1
    new_states = MazeState(pos=pos, dir=dirs.reshape(B), step_count=step_count)
    obs = encode(slab.cfg, new_states) if encode_obs else None
    step_info = info(slab.cfg, new_states) if with_info else None
    return (
        new_states, obs, reward[:, 0], term[:, 0].to(torch.bool),
        step_count >= slab.t.max_steps, step_info,
    )


def reset_batch(
    slab: MazeSlab,
    num_envs: int,
    *,
    generator: torch.Generator | None = None,
    rnd: torch.Tensor | None = None,
    done: torch.Tensor | None = None,
    states: MazeState | None = None,
) -> MazeState:
    """Batch reset: a spawn cell from :func:`reset_spec`, direction
    ``SPAWN_DIR``, step count 0.

    ``rnd`` (num_envs, 1) is used as is when given, else drawn from
    ``generator``.  With ``done`` (num_envs,) bool, the result is
    ``states`` with the rows where it is True reset, in new tensors:
    ``states`` itself is not changed."""
    if rnd is None:
        rnd = torch.rand((num_envs, slab.reset_draws), generator=generator, device=slab.device)
    pos, dirs = reset_spec(slab.t, rnd, slab.bg)
    if done is None:
        return MazeState(
            pos=pos, dir=dirs[:, 0],
            step_count=torch.zeros((num_envs,), dtype=torch.int32, device=slab.device),
        )
    return MazeState(
        pos=torch.where(done[:, None], pos, states.pos),
        dir=states.dir.masked_fill(done, SPAWN_DIR),
        step_count=states.step_count.masked_fill(done, 0),
    )


# ---------------------------------------------------------------------------
# Episode rollout
# ---------------------------------------------------------------------------


@dataclass(eq=False)
class MazeEpisodeRollout:
    """``rollout(states, num_steps)`` of a batch of Maze envs, ``chunk``
    steps a kernel launch (:func:`make_maze_episode_rollout`).  Its draws
    come from the counters of ``ops/philox.py``: ``key``, set by
    :meth:`reset`, and ``step``, the running count of the steps taken since
    then, kept on the host."""

    slab: MazeSlab
    num_envs: int
    chunk: int
    key: tuple[int, int] = (0, 0)
    step: int = 0

    @property
    def cfg(self) -> MazeConfig:
        return self.slab.cfg

    def reset(self, seed: int):
        """Key the draws by ``seed``, set the step count to 0 and reset
        every env from the first reset's counters (``MAZE_FIRST``):
        (states, obs)."""
        self.key, self.step = philox.key_of(seed), 0
        rnd = philox.maze_first_reset_draws(self.key, self.num_envs, self.slab.device)
        states = reset_batch(self.slab, self.num_envs, rnd=rnd)
        return states, encode(self.cfg, states)

    def __call__(self, states: MazeState, num_steps: int, run_return=None):
        """``num_steps`` steps with uniform random actions and the auto-reset;
        returns (states, metrics) with ``BatchedEnv.rollout``'s metrics.

        The sums start at 0 in one fill and the positions are packed once
        (``row * S1 + col``); each chunk of K steps is then one
        :func:`maze_philox_slab` (one ``maze_steps_philox`` launch on the
        card; on the plain route :func:`ms_philox_spec`) at the running
        step count, which then grows by K, carrying each env's sums; a
        last chunk covers ``num_steps % chunk``.  The sums are reduced and
        the positions unpacked once at the end.  How the steps are cut into
        chunks changes nothing, and nothing in the loop waits for the
        device."""
        with annotate("rollout.call"):
            slab, B, dev, t = self.slab, self.num_envs, self.slab.device, self.slab.t
            # One fill: run_return, the reward and episode-return sums, and the
            # episode counts (zero bits are 0.0).
            zeros = torch.zeros((4, B), dtype=torch.int32, device=dev)
            floats = zeros[:3].view(torch.float32)
            run_ret = floats[0] if run_return is None else run_return
            cell = torch.add(states.pos[:, 1], states.pos[:, 0], alpha=t.s1)
            state = (cell, states.dir, states.step_count, run_ret, floats[1], floats[2], zeros[3])
            steps = maze_philox_slab if slab.kernel else ms_philox_spec
            for start in range(0, num_steps, self.chunk):
                with annotate("rollout.chunk"):
                    K = min(self.chunk, num_steps - start)
                    state = steps(slab, K, *state, self.key, self.step)
                    self.step += K
            cell, dirs, sc, run_ret, rew, ep, eps = state
            return MazeState(pos=slab.cell_pos.index_select(0, cell), dir=dirs, step_count=sc), {
                "reward_sum": rew.sum(),
                "episodes": eps.sum(dtype=torch.int32),
                "ep_return_sum": ep.sum(),
                "run_return": run_ret,
            }


def make_maze_episode_rollout(
    cfg: MazeConfig, num_envs: int, device=None, chunk: int = 25
) -> MazeEpisodeRollout:
    """The Maze episode rollout: the counterpart of JAX's
    ``make_maze_episode_rollout`` (``ops/pallas_maze.py``), one kernel
    launch a chunk of steps, which makes its own draws and keeps the sums,
    instead of ``BatchedEnv``'s one a step.  The draws are counter-based
    (``ops/philox.py``), so a seed gives the same trajectory on the CPU and
    on the card.

    ``reset(seed)`` gives fresh states; ``rollout(states, num_steps)`` (the
    object is callable) steps them.  The default device is the current
    CUDA device; with no CUDA device and no explicit ``device`` this
    raises, and ``device="cpu"`` runs :func:`ms_philox_spec`."""
    device = _build.default_device(device, "make_maze_episode_rollout")
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")
    return MazeEpisodeRollout(make_maze_slab(cfg, device), num_envs, chunk)
