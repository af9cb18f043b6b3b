"""Collect slab math: one transition and one whole-board reset for a batch
of (B, C) int32 planes (PyTorch port).

Counterpart of ``gym_multigrid_tpu/ops/pallas_collect.py``: its Pallas
kernels ``collect_step_slab`` and ``collect_reset_slab`` are the hand-written
CUDA kernels in ``gym_multigrid_tpu_torch/csrc/``, and its plain bodies
``_step_math`` and ``_reset_math`` are :func:`step_spec` and
:func:`reset_spec` here.

* :func:`collect_step_slab` / :func:`collect_reset_slab` take the plain
  version for tensors on the CPU and launch the kernel for CUDA tensors.
  They are never a fallback: a slab whose config the kernels do not take
  calls plain versions itself.
* The kernels take one or two agents, as JAX's do, and off the CPU boards
  of at most ``MAX_CELLS`` cells.  Any other config takes the plain route
  on the slab's device, as JAX runs ``vmap(step_one)`` or plain XLA there:
  :func:`reset_rows`, and for one or two agents the step kernel's own
  plain version :func:`step_spec` (so a seed draws alike on either route),
  for any other count :func:`step_perm` (JAX's ``step_fn`` loop over a
  move-order tensor).  :func:`kernel_route` picks the route once, when
  the slab is built (``CollectSlab.kernel``), for every path.
* :func:`step_batch` / :func:`reset_batch` are the batch glue of
  ``make_collect_step_batch`` / ``make_collect_reset_batch``: reward-slot
  tables, info counters, terminated/truncated and the obs.  Their uniforms
  come from a ``torch.Generator``, or from an ``rnd`` tensor used as is
  (which is how the tests hold them to JAX bit for bit).

The reset also takes a ``done`` mask, so the batch env resets finished
rows in place without asking the host whether any row finished.

* :func:`ms_spec` is ``_collect_ms_math``: K steps with the rewards and
  info counters summed.  :func:`ms_philox_spec` runs K steps of the
  episode path on the draws of ``ops/philox.py``'s counters, with the
  truncation reset at each episode's end, on a packed board
  (:func:`pack_planes`); :func:`collect_philox_slab` runs it, or for CUDA
  tensors the kernel entry ``collect_steps_philox`` of
  ``csrc/collect_steps.cu`` (the counterpart of the K-step Collect kernel
  that JAX pruned on the TPU), one launch for all K steps that makes its
  own draws.  :func:`make_collect_episode_rollout` runs whole lockstep
  episodes of truncation-only configs with it, the counterpart of JAX's
  ``make_collect_episode_rollout``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from gym_multigrid_tpu_torch.core.constants import (
    COLLECT_ACTION_TO_VEC,
    COLOR_TO_IDX,
)
from gym_multigrid_tpu_torch.core.world import CollectWorld
from gym_multigrid_tpu_torch.envs.collect import (
    CollectConfig,
    CollectState,
    _wall_mask,
    build_plan,
    encode,
    reward_slot_tables,
)
from gym_multigrid_tpu_torch.ops import _build, philox
from gym_multigrid_tpu_torch.ops.sampling import masked_pick
from gym_multigrid_tpu_torch.utils.profiling import annotate

#: Largest board the kernels take: a lane holds 8 cells of each plane.
MAX_CELLS = 256
#: Agent counts the kernels take (the JAX kernels' envelope).
AGENT_COUNTS = (1, 2)

# Agent placement modes of the reset kernel.
_AGENTS_FIXED, _AGENTS_CHOICE, _AGENTS_UNIFORM = 0, 1, 2


class _Tables(NamedTuple):
    """Static per-config tables of the step."""

    width: int
    height: int
    n_cells: int
    empty: int
    ball: int
    agent: int
    agent_colors: tuple[int, ...]
    respawn: bool
    respawn_rects: tuple[tuple[bool, ...], ...]  # (n_colors, n_cells)
    action_dx: tuple[int, ...]
    action_dy: tuple[int, ...]
    #: first reward-table slot of respawned balls (= number of planned
    #: placements); a respawned ball of color c carries slot base + c
    respawn_slot_base: int


def make_tables(cfg: CollectConfig) -> _Tables:
    plan = build_plan(cfg)
    idx = CollectWorld.OBJECT_TO_IDX
    return _Tables(
        width=cfg.width,
        height=cfg.height,
        n_cells=cfg.num_cells,
        empty=idx["empty"],
        ball=idx["ball"],
        agent=idx["agent"],
        agent_colors=tuple(int(c) for c in cfg.agents_index),
        respawn=cfg.respawn,
        respawn_rects=tuple(
            tuple(bool(b) for b in row) for row in plan.respawn_rects
        ),
        action_dx=tuple(int(v[0]) for v in COLLECT_ACTION_TO_VEC),
        action_dy=tuple(int(v[1]) for v in COLLECT_ACTION_TO_VEC),
        respawn_slot_base=len(plan.ball_colors),
    )


class _ResetTables(NamedTuple):
    """Static reset program (from ``build_plan``)."""

    n_cells: int
    empty: int
    wall: int
    ball: int
    agent: int
    wall_color: int
    ball_colors: tuple[int, ...]  # per placement
    agent_colors: tuple[int, ...]
    balls_before_agents: bool
    agent_fixed: tuple[tuple[int, int], ...] | None
    agent_choice: tuple[tuple[int, int], ...] | None  # static coord pool
    width: int


def make_reset_tables(cfg: CollectConfig):
    plan = build_plan(cfg)
    idx = CollectWorld.OBJECT_TO_IDX
    rt = _ResetTables(
        n_cells=cfg.num_cells,
        empty=idx["empty"],
        wall=idx["wall"],
        ball=idx["ball"],
        agent=idx["agent"],
        wall_color=COLOR_TO_IDX["grey"],
        ball_colors=tuple(int(c) for c in plan.ball_colors),
        agent_colors=tuple(int(c) for c in cfg.agents_index),
        balls_before_agents=plan.balls_before_agents,
        agent_fixed=plan.agent_fixed,
        agent_choice=(
            tuple((int(x), int(y)) for x, y in plan.agent_choice_coords)
            if plan.agent_choice_coords is not None
            else None
        ),
        width=cfg.width,
    )
    return rt, plan


class ResetArrays(NamedTuple):
    """The reset program's tables as tensors on one device."""

    wall: torch.Tensor  # (C,) bool
    ball_rects: torch.Tensor  # (n_balls, C) bool, walls excluded
    #: (n_balls + 2 * n_coords,) int32: each placement's ball color, then
    #: the agents' fixed (x, y) or the coordinate pool, flattened
    program: torch.Tensor
    #: ((n_balls + 1) * ceil(C / 32),) int32: the rows of ``ball_rects``,
    #: then ``wall``, as bit words (cell c is bit c % 32 of word c // 32),
    #: which the reset kernel reads
    words: torch.Tensor


def cell_words(rows: np.ndarray) -> np.ndarray:
    """(R, C) bool rows as (R, ceil(C / 32)) int32 bit words: cell c is bit
    ``c % 32`` of word ``c // 32``."""
    R, C = rows.shape
    padded = np.zeros((R, -(-C // 32) * 32), dtype=bool)
    padded[:, :C] = rows
    return np.packbits(padded, axis=1, bitorder="little").view("<u4").view(np.int32)


def make_reset_arrays(cfg: CollectConfig, device) -> ResetArrays:
    rt, plan = make_reset_tables(cfg)
    wall = _wall_mask(cfg)
    # Placement masks exclude walls: a placement only takes empty cells.
    ball_rects = plan.ball_rects & ~wall[None, :]
    coords = rt.agent_fixed or rt.agent_choice or ()
    program = np.array(
        list(rt.ball_colors) + [v for xy in coords for v in xy], dtype=np.int32
    )
    words = cell_words(np.concatenate([ball_rects, wall[None, :]])).reshape(-1)
    return ResetArrays(
        wall=torch.as_tensor(wall, device=device),
        ball_rects=torch.as_tensor(ball_rects, device=device),
        program=torch.as_tensor(program, device=device),
        words=torch.as_tensor(words, device=device),
    )


# ---------------------------------------------------------------------------
# Step
# ---------------------------------------------------------------------------


def step_spec(t: _Tables, go, gc, gs, pos, acts, rnd, rects):
    """One Collect transition for a (B, C) slab of one or two agents, in
    plain PyTorch, with the kernel's interface: :func:`step_perm` with
    the order and respawn uniforms taken from ``rnd``.

    go/gc/gs: (B, C) int32 object, color and reward-slot planes
    pos:      (B, 2*n_agents) int32 [a0x, a0y, a1x, a1y]
    acts:     (B, n_agents) int32; ids outside 0..3 are a no-op
    rnd:      (B, 3) float32 uniforms [move order, respawn of the first
              mover, respawn of the second mover]
    rects:    (n_colors, C) bool respawn rect of each ball color

    Returns (go, gc, gs, pos, picked) with picked (B, n_agents) int32: the
    reward-table slot of the ball each agent picked up, or -1.
    """
    B, A = acts.shape
    # Move order: for 2 agents a fair coin; agent 1 moves first when
    # rnd[:, 0] < 0.5.
    perm = torch.arange(A, device=go.device).expand(B, A)
    if A == 2:
        perm = torch.where(rnd[:, 0:1] < 0.5, perm.flip(1), perm)
    return step_perm(t, go, gc, gs, pos, acts, perm, rnd[:, 1 : 1 + A], rects)


def move_order(keys):
    """The move order of each row from (B, A) float32 uniform keys: the
    agents sorted by key, a uniform permutation of any number of agents
    (as JAX's ``step_fn`` draws with ``jax.random.permutation``).  Returns
    (B, A) int64: ``order[:, s]`` is the agent that moves ``s``-th."""
    return keys.argsort(dim=1)


def step_perm(t: _Tables, go, gc, gs, pos, acts, perm, rnd, rects):
    """One Collect transition for a (B, C) slab of any number of agents A,
    in plain PyTorch: the sequential loop of JAX's ``step_fn``
    (``envs/collect.py``), every row at once.

    pos:  (B, 2A) int32 [a0x, a0y, a1x, a1y, ...]
    acts: (B, A) int32; ids outside 0..3 are a no-op
    perm: (B, A) integer move order: agent ``perm[:, s]`` moves s-th
    rnd:  (B, A) float32 respawn uniform of the s-th mover

    go/gc/gs and rects as in :func:`step_spec`, which is this step for one
    or two agents with ``perm`` from ``rnd[:, 0] < 0.5`` and the respawn
    uniforms ``rnd[:, 1:]``.  Returns (go, gc, gs, pos, picked) with
    picked (B, A) int32: the reward-table slot of the ball each agent
    picked up, or -1."""
    B, C = go.shape
    A = acts.shape[1]
    dev = go.device
    lane = torch.arange(C, dtype=torch.int32, device=dev)[None, :]
    w = t.width
    colors = torch.tensor(t.agent_colors, dtype=torch.int32, device=dev)
    perm = perm.long()
    xs, ys = pos[:, 0::2], pos[:, 1::2]
    picked = torch.full((B, A), -1, dtype=torch.int32, device=dev)
    dx_of = torch.tensor(t.action_dx, dtype=torch.int32, device=dev)
    dy_of = torch.tensor(t.action_dy, dtype=torch.int32, device=dev)

    for s in range(A):
        i = perm[:, s : s + 1]  # (B, 1) the mover
        act = acts.gather(1, i)
        px, py = xs.gather(1, i), ys.gather(1, i)
        valid = (act >= 0) & (act < 4)
        a = act.clamp(0, 3).long()
        nx = (px + torch.where(valid, dx_of[a], 0)).clamp(0, t.width - 1)
        ny = (py + torch.where(valid, dy_of[a], 0)).clamp(0, t.height - 1)
        nidx = ny * w + nx
        hit_n = lane == nidx
        hit_o = lane == py * w + px

        cell = go.gather(1, nidx.long())
        is_ball = cell == t.ball
        do_move = is_ball | (cell == t.empty)
        ball_color = gc.gather(1, nidx.long())
        ball_slot = gs.gather(1, nidx.long())

        # pickup: clear the ball cell
        clear = hit_n & is_ball
        go = torch.where(clear, t.empty, go)
        gc = torch.where(clear, 0, gc)
        gs = torch.where(clear, 0, gs)

        if t.respawn:
            # Respawn before the agent moves in: uniform over the empty
            # cells of the ball color's rect, the vacated cell included.
            bc = ball_color.clamp(0, rects.shape[0] - 1)
            mask = rects[bc[:, 0].long()] & (go == t.empty)
            hit_r = masked_pick(mask, rnd[:, s : s + 1]) & is_ball
            go = torch.where(hit_r, t.ball, go)
            gc = torch.where(hit_r, ball_color, gc)
            gs = torch.where(hit_r, t.respawn_slot_base + ball_color, gs)

        # move; a respawn on the vacated ball cell is overwritten (stomped)
        into = hit_n & do_move
        go = torch.where(into, t.agent, go)
        gc = torch.where(into, colors[i], gc)
        gs = torch.where(into, 0, gs)
        out = hit_o & do_move
        go = torch.where(out, t.empty, go)
        gc = torch.where(out, 0, gc)

        xs = xs.scatter(1, i, torch.where(do_move, nx, px))
        ys = ys.scatter(1, i, torch.where(do_move, ny, py))
        picked = picked.scatter(1, i, torch.where(is_ball, ball_slot, -1))

    return go, gc, gs, torch.stack([xs, ys], dim=2).reshape(B, 2 * A), picked


def _envelope_fault(n_cells, n_agents) -> str | None:
    """Why the kernels do not take ``n_agents`` agents on ``n_cells``
    cells, or None where they do; ``n_cells`` None checks the agents
    only."""
    if n_agents not in AGENT_COUNTS:
        return f"the Collect kernels take {AGENT_COUNTS} agents, got {n_agents}"
    if n_cells is not None and n_cells > MAX_CELLS:
        return f"the Collect kernels take boards of at most {MAX_CELLS} cells, got {n_cells}"
    return None


def _check_envelope(n_cells, n_agents):
    """Raise unless the kernels take this config (:func:`_envelope_fault`)."""
    fault = _envelope_fault(n_cells, n_agents)
    if fault:
        raise ValueError(fault)


def kernel_route(cfg: CollectConfig, device_type: str) -> bool:
    """The route of a slab of ``cfg`` on a device of this type, decided
    once when the slab is built: True for the kernel wrappers
    (:func:`collect_step_slab`, :func:`collect_reset_slab`,
    :func:`collect_philox_slab`), which launch
    the kernels on the card and run their plain versions on the CPU; False
    for the plain route on the device's tensors.  One or two
    agents take the kernels, on the CPU on any board (its "kernels" are the
    plain versions) and off it within ``MAX_CELLS`` cells, as JAX's batch
    runs the rest as plain XLA.  Not a fallback: nothing is tried and
    caught."""
    cells = None if device_type == "cpu" else cfg.num_cells
    return _envelope_fault(cells, cfg.num_agents) is None


def collect_step_slab(t: _Tables, go, gc, gs, pos, acts, rnd, rects):
    """One transition of the batch: :func:`step_spec` for CPU tensors, the
    CUDA kernel ``csrc/collect_step.cu`` for CUDA tensors (new output
    tensors; the inputs are not changed).  Same arguments and results as
    :func:`step_spec`, which moves one or two agents: more raise on every
    device (:func:`step_perm` moves any number).  The kernel takes the cell
    values an env makes, as :func:`collect_philox_slab` does."""
    if go.device.type == "cpu":
        _check_envelope(None, acts.shape[-1])
        return step_spec(t, go, gc, gs, pos, acts, rnd, rects)
    if go.device.type != "cuda":
        raise ValueError(f"no Collect step for tensors on {go.device}")
    B, C = go.shape
    A = acts.shape[-1]
    _check_envelope(C, A)
    if C != t.n_cells or B < 1:
        raise ValueError(f"planes of shape {(B, C)} for a {t.n_cells}-cell board")
    dev = go.device
    for name, x, dtype, shape in (
        ("go", go, torch.int32, (B, C)),
        ("gc", gc, torch.int32, (B, C)),
        ("gs", gs, torch.int32, (B, C)),
        ("pos", pos, torch.int32, (B, 2 * A)),
        ("acts", acts, torch.int32, (B, A)),
        ("rnd", rnd, torch.float32, (B, 3)),
        ("rects", rects, torch.bool, (len(t.respawn_rects), C)),
    ):
        _build.check_arg(name, x, dtype, shape, dev)
    kernels = _build.load()
    go_o, gc_o, gs_o = (torch.empty_like(go) for _ in range(3))
    pos_o = torch.empty_like(pos)
    picked = torch.empty_like(acts)
    with torch.cuda.device(dev):
        err = kernels.collect_step(
            go.data_ptr(), gc.data_ptr(), gs.data_ptr(), pos.data_ptr(),
            acts.data_ptr(), rnd.data_ptr(), rects.data_ptr(),
            go_o.data_ptr(), gc_o.data_ptr(), gs_o.data_ptr(),
            pos_o.data_ptr(), picked.data_ptr(),
            B, t.width, t.height, A, int(t.respawn), rects.shape[0],
            t.respawn_slot_base, t.agent_colors[0],
            t.agent_colors[1 % len(t.agent_colors)],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"collect_step kernel launch failed: CUDA error {err}")
    collect_step_slab.launches += 1
    return go_o, gc_o, gs_o, pos_o, picked


#: Launches of the step kernel since the count was last set to 0.
collect_step_slab.launches = 0


# ---------------------------------------------------------------------------
# Reset
# ---------------------------------------------------------------------------


def _agent_mode(rt: _ResetTables) -> int:
    """How the kernels place the agents: fixed, from the pool or uniform."""
    if rt.agent_fixed is not None:
        return _AGENTS_FIXED
    if rt.agent_choice is not None:
        return _AGENTS_CHOICE
    return _AGENTS_UNIFORM


def reset_spec(rt: _ResetTables, wall, ball_rects, rnd):
    """Sequential placement program for a (B, C) slab, in plain PyTorch.

    wall:       (C,) bool static wall mask
    ball_rects: (n_balls, C) bool placement rects, walls excluded
    rnd:        (B, n_balls + n_agents) float32 uniforms
    Returns (go, gc, gs, pos) with pos (B, 2*A); gs holds each placed
    ball's reward-table slot (its placement index).
    """
    B = rnd.shape[0]
    C = rt.n_cells
    dev = rnd.device
    lane = torch.arange(C, dtype=torch.int32, device=dev)[None, :]
    go = torch.where(wall, rt.wall, rt.empty).to(torch.int32).repeat(B, 1)
    gc = torch.where(wall, rt.wall_color, 0).to(torch.int32).repeat(B, 1)
    gs = torch.zeros((B, C), dtype=torch.int32, device=dev)
    A = len(rt.agent_colors)
    w = rt.width

    def place_balls(go, gc, gs, base):
        for b, color in enumerate(rt.ball_colors):
            mask = ball_rects[b][None, :] & (go == rt.empty)
            hit = masked_pick(mask, rnd[:, base + b : base + b + 1])
            go = torch.where(hit, rt.ball, go)
            gc = torch.where(hit, color, gc)
            gs = torch.where(hit, b, gs)
        return go, gc, gs

    def place_agents(go, gc, gs, base):
        cols = []
        for i, color in enumerate(rt.agent_colors):
            if rt.agent_fixed is not None:
                x, y = rt.agent_fixed[i]
                idx = torch.full((B, 1), y * w + x, dtype=torch.int32, device=dev)
            elif rt.agent_choice is not None:
                u = rnd[:, base + i : base + i + 1]
                n = len(rt.agent_choice)
                j = (u * n).to(torch.int32).clamp(max=n - 1)
                idx = torch.zeros((B, 1), dtype=torch.int32, device=dev)
                for k, (x, y) in enumerate(rt.agent_choice):
                    idx = torch.where(j == k, y * w + x, idx)
            else:
                hit = masked_pick(go == rt.empty, rnd[:, base + i : base + i + 1])
                idx = torch.where(hit, lane, 0).sum(1, keepdim=True, dtype=torch.int32)
            hit = lane == idx
            go = torch.where(hit, rt.agent, go)
            gc = torch.where(hit, color, gc)
            gs = torch.where(hit, 0, gs)
            cols.append(torch.cat([idx % w, idx // w], dim=1))
        return go, gc, gs, cols

    nb = len(rt.ball_colors)
    if rt.balls_before_agents:
        go, gc, gs = place_balls(go, gc, gs, 0)
        go, gc, gs, pos_cols = place_agents(go, gc, gs, nb)
    else:
        go, gc, gs, pos_cols = place_agents(go, gc, gs, 0)
        go, gc, gs = place_balls(go, gc, gs, A)
    return go, gc, gs, torch.cat(pos_cols, dim=1)


def reset_rows(rt: _ResetTables, rnd, ra: ResetArrays, done=None, out=None):
    """:func:`reset_spec` with the interface of :func:`collect_reset_slab`
    (``done`` None: new tensors; else the done rows of ``out`` in place),
    on any device and for any number of agents."""
    new = reset_spec(rt, ra.wall, ra.ball_rects, rnd)
    if done is None:
        return new
    for o, n in zip(out, new):
        o.copy_(torch.where(done[:, None], n, o))
    return out


def collect_reset_slab(rt: _ResetTables, rnd, ra: ResetArrays, done=None, out=None):
    """Whole-board reset: :func:`reset_spec` for CPU tensors, the CUDA
    kernel ``csrc/collect_reset.cu`` for CUDA tensors.

    With ``done`` None every row is reset into new tensors.  With a (B,)
    bool ``done`` only the rows where it is True are reset, in place in
    ``out = (go, gc, gs, pos)``; the other rows are left as they are, so
    the result is ``where(done, reset_spec(...), out)``.  Returns
    (go, gc, gs, pos)."""
    if rnd.device.type == "cpu":
        return reset_rows(rt, rnd, ra, done, out)
    if rnd.device.type != "cuda":
        raise ValueError(f"no Collect reset for tensors on {rnd.device}")
    B, C, A, nb = rnd.shape[0], rt.n_cells, len(rt.agent_colors), len(rt.ball_colors)
    _check_envelope(C, A)
    if B < 1:
        raise ValueError("an empty batch has nothing to reset")
    dev = rnd.device
    if done is None:
        out = tuple(
            torch.empty((B, C), dtype=torch.int32, device=dev) for _ in range(3)
        ) + (torch.empty((B, 2 * A), dtype=torch.int32, device=dev),)
    else:
        _build.check_arg("done", done, torch.bool, (B,), dev)
    coords = rt.agent_fixed or rt.agent_choice or ()
    for name, x, dtype, shape in (
        ("rnd", rnd, torch.float32, (B, nb + A)),
        ("words", ra.words, torch.int32, ((nb + 1) * -(-C // 32),)),
        ("program", ra.program, torch.int32, (nb + 2 * len(coords),)),
        ("go", out[0], torch.int32, (B, C)),
        ("gc", out[1], torch.int32, (B, C)),
        ("gs", out[2], torch.int32, (B, C)),
        ("pos", out[3], torch.int32, (B, 2 * A)),
    ):
        _build.check_arg(name, x, dtype, shape, dev)
    kernels = _build.load()
    with torch.cuda.device(dev):
        err = kernels.collect_reset(
            rnd.data_ptr(), ra.words.data_ptr(), ra.program.data_ptr(),
            None if done is None else done.data_ptr(),
            *(o.data_ptr() for o in out),
            B, rt.width, C, nb, A, int(rt.balls_before_agents), _agent_mode(rt),
            len(coords), rt.agent_colors[0],
            rt.agent_colors[1 % len(rt.agent_colors)],
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"collect_reset kernel launch failed: CUDA error {err}")
    collect_reset_slab.launches += 1
    return out


#: Launches of the reset kernel since the count was last set to 0.
collect_reset_slab.launches = 0


# ---------------------------------------------------------------------------
# Batch glue
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class CollectSlab:
    """Everything the batch glue needs for one config on one device."""

    cfg: CollectConfig
    device: torch.device
    t: _Tables
    rt: _ResetTables
    respawn_rects: torch.Tensor  # (n_colors, C) bool
    #: (n_colors * ceil(C / 32),) int32: the rows of ``respawn_rects`` as
    #: bit words (:func:`cell_words`), which ``collect_steps_philox`` reads
    respawn_words: torch.Tensor
    reset_arrays: ResetArrays
    slot_rewards: torch.Tensor  # (n_slots,) float32
    slot_info: torch.Tensor  # (n_slots,) int32
    info_ids: torch.Tensor  # (num_ball_types,) int32: 0, 1, ...
    #: The route (:func:`kernel_route`): the kernels
    #: (:func:`collect_step_slab`, :func:`collect_reset_slab`,
    #: :func:`collect_philox_slab`, their plain versions on the CPU) for
    #: the configs they take, else :func:`reset_rows` and :func:`step_spec`
    #: / :func:`ms_philox_spec` (one or two agents) or :func:`step_perm`
    #: (any other count) in plain PyTorch on the slab's device.
    kernel: bool

    @property
    def reset_draws(self) -> int:
        """Uniforms one env's reset takes: one per ball and per agent."""
        return len(self.rt.ball_colors) + self.cfg.num_agents

    @property
    def step_draws(self) -> int:
        """Uniforms one env's step takes: for one or two agents
        :func:`step_spec`'s move order and two respawns, for any other
        count a move-order key and a respawn per agent."""
        return 3 if self.cfg.num_agents in AGENT_COUNTS else 2 * self.cfg.num_agents


def make_collect_slab(cfg: CollectConfig, device) -> CollectSlab:
    """The slab of ``cfg`` on ``device``, its route picked by
    :func:`kernel_route`: one or two agents take the kernels, as JAX's
    ``make_collect_step_batch`` does, where they fit the card's cell bound;
    any other config takes the plain step and reset on the slab's
    device.  Every path builds its slab here: the batch env, the per-env
    functions and the episode rollout."""
    device = torch.device(device)
    t = make_tables(cfg)
    rt, plan = make_reset_tables(cfg)
    slot_rewards, slot_info, _ = reward_slot_tables(cfg, plan)
    return CollectSlab(
        cfg=cfg,
        device=device,
        t=t,
        rt=rt,
        respawn_rects=torch.as_tensor(plan.respawn_rects, device=device),
        respawn_words=torch.as_tensor(
            cell_words(np.asarray(plan.respawn_rects, dtype=bool)).reshape(-1), device=device),
        reset_arrays=make_reset_arrays(cfg, device),
        slot_rewards=torch.as_tensor(slot_rewards, device=device),
        slot_info=torch.as_tensor(slot_info, device=device),
        info_ids=torch.arange(cfg.num_ball_types, dtype=torch.int32, device=device),
        kernel=kernel_route(cfg, device.type),
    )


def step_batch(
    slab: CollectSlab,
    states: CollectState,
    actions: torch.Tensor,
    *,
    generator: torch.Generator | None = None,
    rnd: torch.Tensor | None = None,
    perm: torch.Tensor | None = None,
    encode_obs: bool = True,
):
    """Batch-level Collect step.

    Returns (states', obs, rewards (B, A) float32, terminated (B,),
    truncated (B,), info_counts).  ``rnd`` (B, ``slab.step_draws``) is
    used as is when given, else drawn from ``generator``.  For one or two
    agents it is :func:`step_spec`'s (B, 3) on either route; for any other
    count its first A columns are the move-order keys (:func:`move_order`),
    unless ``perm`` (B, A) gives the order itself, and its last A the
    respawn uniforms.  ``perm`` is refused for one or two agents, whose
    order is ``rnd[:, 0]``.  ``encode_obs=False`` returns None for the obs, for callers that would
    throw it away."""
    cfg = slab.cfg
    B, A = states.grid_obj.shape[0], cfg.num_agents
    if perm is not None and A in AGENT_COUNTS:
        raise ValueError(
            f"perm is taken for agent counts other than {AGENT_COUNTS}; {A} agents "
            "take their move order from rnd[:, 0]"
        )
    if rnd is None:
        rnd = torch.rand((B, slab.step_draws), generator=generator, device=slab.device)
    args = (
        states.grid_obj,
        states.grid_color,
        states.grid_slot,
        states.agent_pos.reshape(B, -1),
        actions.to(torch.int32).contiguous(),
    )
    if slab.kernel:
        go, gc, gs, pos, picked = collect_step_slab(slab.t, *args, rnd, slab.respawn_rects)
    elif A in AGENT_COUNTS:
        go, gc, gs, pos, picked = step_spec(slab.t, *args, rnd, slab.respawn_rects)
    else:
        if perm is None:
            perm = move_order(rnd[:, :A])
        go, gc, gs, pos, picked = step_perm(
            slab.t, *args, perm, rnd[:, A:], slab.respawn_rects
        )
    got_ball = picked >= 0  # (B, A); picked is the reward-table slot
    ps = picked.clamp(0, slab.slot_rewards.shape[0] - 1)
    rewards = torch.where(got_ball, slab.slot_rewards[ps], 0.0)
    collected = states.collected + got_ball.sum(1, dtype=torch.int32)
    # info counters: one-hot (agent, info-slot) bumps
    bump = (slab.slot_info[ps][..., None] == slab.info_ids) & got_ball[..., None]
    info_counts = states.info_counts + bump.to(torch.int32)

    step_count = states.step_count + 1
    if cfg.respawn or cfg.fixed_horizon:
        terminated = torch.zeros((B,), dtype=torch.bool, device=slab.device)
    else:
        terminated = collected == cfg.num_balls
    truncated = step_count >= cfg.max_steps

    new_states = CollectState(
        grid_obj=go,
        grid_color=gc,
        grid_slot=gs,
        agent_pos=pos.reshape(B, -1, 2),
        collected=collected,
        step_count=step_count,
        info_counts=info_counts,
    )
    obs = encode(cfg, new_states) if encode_obs else None
    return new_states, obs, rewards, terminated, truncated, info_counts


def reset_batch(
    slab: CollectSlab,
    num_envs: int,
    *,
    generator: torch.Generator | None = None,
    rnd: torch.Tensor | None = None,
    done: torch.Tensor | None = None,
    states: CollectState | None = None,
) -> CollectState:
    """Batch reset through the whole-board placement program.

    ``rnd`` (num_envs, ``slab.reset_draws``) is used as is when given, else
    drawn from ``generator``.  With ``done`` (num_envs,) bool, the rows of
    ``states`` where it is True are reset IN PLACE (planes, positions and
    counters) and ``states`` is returned; the other rows keep their
    values."""
    if rnd is None:
        rnd = torch.rand(
            (num_envs, slab.reset_draws), generator=generator, device=slab.device
        )
    A, nt = slab.cfg.num_agents, slab.cfg.num_ball_types
    reset = collect_reset_slab if slab.kernel else reset_rows
    if done is None:
        go, gc, gs, pos = reset(slab.rt, rnd, slab.reset_arrays)

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=slab.device)

        return CollectState(
            grid_obj=go,
            grid_color=gc,
            grid_slot=gs,
            agent_pos=pos.reshape(num_envs, A, 2),
            collected=zeros(num_envs),
            step_count=zeros(num_envs),
            info_counts=zeros(num_envs, A, nt),
        )
    reset(
        slab.rt,
        rnd,
        slab.reset_arrays,
        done=done,
        out=(
            states.grid_obj,
            states.grid_color,
            states.grid_slot,
            states.agent_pos.view(num_envs, 2 * A),
        ),
    )
    states.collected.masked_fill_(done, 0)
    states.step_count.masked_fill_(done, 0)
    states.info_counts.masked_fill_(done[:, None, None], 0)
    return states


# ---------------------------------------------------------------------------
# Episode rollout
# ---------------------------------------------------------------------------


def ms_spec(slab: CollectSlab, go, gc, gs, pos, acts, rnd, rew=None):
    """K = ``acts.shape[0]`` Collect steps of :func:`step_spec` in plain
    PyTorch, with the rewards and the info counters summed step by step as
    ``_collect_ms_math`` sums them.

    go/gc/gs (B, C) int32 planes; pos (B, 2A) int32; acts (K, B, A) int32;
    rnd (K, B, 3) float32; ``rew`` (B, A) float32 the sums to add to (zero
    when None).  Returns (go, gc, gs, pos, rew (B, A) float32, cnt (B, A *
    num_ball_types) int32): each agent's summed reward and its pickups by
    info slot."""
    B, A = go.shape[0], acts.shape[2]
    n_types = slab.info_ids.shape[0]
    if rew is None:
        rew = torch.zeros((B, A), dtype=torch.float32, device=go.device)
    cnt = torch.zeros((B, A, n_types), dtype=torch.int32, device=go.device)
    for k in range(acts.shape[0]):
        go, gc, gs, pos, picked = step_spec(slab.t, go, gc, gs, pos, acts[k], rnd[k], slab.respawn_rects)
        got = picked >= 0
        ps = picked.clamp(0, slab.slot_rewards.shape[0] - 1)
        rew = rew + torch.where(got, slab.slot_rewards[ps], 0.0)
        cnt = cnt + ((slab.slot_info[ps][..., None] == slab.info_ids) & got[..., None]).to(torch.int32)
    return go, gc, gs, pos, rew, cnt.reshape(B, A * n_types)


def pack_planes(go, gc, gs):
    """The (B, C) int32 packed board of three planes: a cell is ``obj |
    color << 8 | slot << 16`` (object ids and colors in 0..255, reward
    slots in -32768..32767, which holds every cell an env makes), formed
    as ``obj + 256 color + 65536 slot``, equal for those values; JAX's
    episode math packs the planes the same way (``pack_planes``,
    ``pallas_collect.py:630``)."""
    return torch.add(torch.add(go, gc, alpha=1 << 8), gs, alpha=1 << 16)


def unpack_planes(p):
    """The three (B, C) int32 planes of a packed board (:func:`pack_planes`)."""
    return p & 0xFF, (p >> 8) & 0xFF, p >> 16


def ms_philox_spec(slab: CollectSlab, K: int, p, pos, ret, key, step0: int, counts=None):
    """K steps of the Collect episode path in plain PyTorch, on the draws
    of ``ops/philox.py``'s counters: the global steps ``step0 .. step0 + K
    - 1`` of the rollout keyed by ``key``.  The plain version of
    :func:`collect_philox_slab`.

    p (B, C) int32 packed board (:func:`pack_planes`); pos (B, 2A) int32;
    ret (B, A) float32 each agent's running reward.  Forms each step's
    actions and uniforms from the counters and runs :func:`ms_spec` on
    them, the rewards added to ``ret`` one step at a time; after global
    step s with ``(s + 1) % max_steps == 0`` every env takes a fresh board
    from :func:`reset_spec` on that step's ``COLLECT_FRESH`` uniforms.
    The episode path discards the info counters; ``counts`` (B, A *
    num_ball_types) int32, when given, has :func:`ms_spec`'s added to it
    in place.  Returns (p, pos, ret) after the K steps."""
    B, dev, A = p.shape[0], p.device, pos.shape[1] // 2
    max_steps = slab.cfg.max_steps
    steps = torch.arange(step0, step0 + K, dtype=torch.int64, device=dev)
    acts, rnd = philox.collect_step_draws(key, steps, B, A, dev)
    go, gc, gs = unpack_planes(p)
    ra = slab.reset_arrays
    k = 0
    while k < K:
        # Up to and with the step that ends an episode.
        n = min(K - k, max_steps - (step0 + k) % max_steps)
        go, gc, gs, pos, ret, cnt = ms_spec(slab, go, gc, gs, pos, acts[k:k + n], rnd[k:k + n], ret)
        if counts is not None:
            counts += cnt
        k += n
        s = step0 + k - 1
        if (s + 1) % max_steps == 0:
            fresh = philox.collect_fresh_draws(key, steps[k - 1:k], B, slab.reset_draws, dev)[0]
            go, gc, gs, pos = reset_spec(slab.rt, ra.wall, ra.ball_rects, fresh)
    return pack_planes(go, gc, gs), pos, ret


def collect_philox_slab(slab: CollectSlab, K: int, p, pos, ret, key, step0: int):
    """K steps of the Collect episode path: :func:`ms_philox_spec` for CPU
    tensors, the CUDA kernel entry ``collect_steps_philox`` of
    ``csrc/collect_steps.cu`` for CUDA tensors, one launch for all K steps
    that makes each draw where it is read, runs the truncation reset at
    each episode's end and sums the rewards, reading no uniform from memory
    (new output tensors; the inputs are not changed).  Same arguments and
    results as :func:`ms_philox_spec`.  The kernel takes boards of at most
    ``MAX_CELLS`` cells, one or two agents and the cell values an env
    makes; configs outside that take :func:`ms_philox_spec` on their
    device by the slab's route (:func:`kernel_route`), and this wrapper
    refuses them."""
    if p.device.type == "cpu":
        return ms_philox_spec(slab, K, p, pos, ret, key, step0)
    if p.device.type != "cuda":
        raise ValueError(f"no Collect steps for tensors on {p.device}")
    t, rt, cfg = slab.t, slab.rt, slab.cfg
    B, C = p.shape
    A = pos.shape[-1] // 2
    _check_envelope(C, A)
    if C != t.n_cells or B < 1 or K < 1:
        raise ValueError(f"nothing to step: a board of shape {(B, C)} for a {t.n_cells}-cell "
                         f"board, {K} steps")
    dev = p.device
    ra = slab.reset_arrays
    nb, nw = len(rt.ball_colors), -(-C // 32)
    coords = rt.agent_fixed or rt.agent_choice or ()
    n_slots = slab.slot_rewards.shape[0]
    for name, x, dtype, shape in (
        ("p", p, torch.int32, (B, C)),
        ("pos", pos, torch.int32, (B, 2 * A)),
        ("ret", ret, torch.float32, (B, A)),
        ("respawn_words", slab.respawn_words, torch.int32, (len(t.respawn_rects) * nw,)),
        ("words", ra.words, torch.int32, ((nb + 1) * nw,)),
        ("program", ra.program, torch.int32, (nb + 2 * len(coords),)),
        ("slot_rewards", slab.slot_rewards, torch.float32, (n_slots,)),
    ):
        _build.check_arg(name, x, dtype, shape, dev)
    kernels = _build.load()
    p_o, pos_o, ret_o = torch.empty_like(p), torch.empty_like(pos), torch.empty_like(ret)
    with torch.cuda.device(dev):
        err = kernels.collect_steps_philox(
            p.data_ptr(), pos.data_ptr(), ret.data_ptr(), slab.respawn_words.data_ptr(),
            ra.words.data_ptr(), ra.program.data_ptr(), slab.slot_rewards.data_ptr(),
            p_o.data_ptr(), pos_o.data_ptr(), ret_o.data_ptr(),
            B, K, t.width, t.height, A, int(t.respawn), len(t.respawn_rects),
            t.respawn_slot_base, t.agent_colors[0], t.agent_colors[1 % len(t.agent_colors)],
            n_slots, nb, int(rt.balls_before_agents), _agent_mode(rt), len(coords),
            cfg.max_steps, step0 % cfg.max_steps,
            *(philox.signed(w) for w in (*key, step0)),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"collect_steps_philox kernel launch failed: CUDA error {err}")
    collect_philox_slab.launches += 1
    return p_o, pos_o, ret_o


#: Launches of the K-step kernel since the count was last set to 0.
collect_philox_slab.launches = 0


@dataclass(eq=False)
class CollectEpisodeRollout:
    """``rollout(states, num_steps)`` of a batch of Collect envs in whole
    lockstep episodes (:func:`make_collect_episode_rollout`).  Its draws
    come from the counters of ``ops/philox.py``: ``key``, set by
    :meth:`reset`, and ``step``, the running count of the steps taken
    since then, kept on the host."""

    slab: CollectSlab
    num_envs: int
    chunk: int
    key: tuple[int, int] = (0, 0)
    step: int = 0

    @property
    def cfg(self) -> CollectConfig:
        return self.slab.cfg

    def reset(self, seed: int):
        """Key the draws by ``seed``, set the step count to 0 and reset
        every env from the first reset's counters: (states, obs)."""
        self.key, self.step = philox.key_of(seed), 0
        rnd = philox.collect_first_reset_draws(self.key, self.num_envs, self.slab.reset_draws,
                                               self.slab.device)
        states = reset_batch(self.slab, self.num_envs, rnd=rnd)
        return states, encode(self.cfg, states)

    def __call__(self, states: CollectState, num_steps: int):
        """``num_steps`` steps, a multiple of ``max_steps``, with uniform
        random actions; returns (states, metrics) with
        ``BatchedEnv.rollout``'s metrics.

        ``states`` must come fresh from :meth:`reset` or from this rollout:
        every env at step 0 of an episode, as lockstep truncation leaves
        them.  Nothing checks it, since that would wait for the device.
        The board is packed once (:func:`pack_planes`), then each chunk of
        K steps is one :func:`collect_philox_slab` (one
        ``collect_steps_philox`` launch on the card; on the plain route
        :func:`ms_philox_spec`) at the running step count, which then grows
        by K; a chunk may span an episode's end, whose truncation reset
        the chunk runs.  The rewards are summed once at the end and the
        board unpacked once.  Every env finishes every episode, so
        ``episodes`` is B times their number, ``ep_return_sum`` is
        ``reward_sum``, ``run_return`` is 0, and the counters the reset
        zeroes are not summed."""
        with annotate("rollout.call"):
            cfg, B, dev, slab = self.cfg, self.num_envs, self.slab.device, self.slab
            if num_steps % cfg.max_steps:
                raise ValueError(
                    f"num_steps ({num_steps}) must be a multiple of max_steps ({cfg.max_steps})"
                )
            A, nt = cfg.num_agents, cfg.num_ball_types
            p = pack_planes(states.grid_obj, states.grid_color, states.grid_slot)
            pos = states.agent_pos.reshape(B, 2 * A)
            # One fill for the running rewards and run_return, one for the
            # counters the episode boundary leaves at 0.
            floats = torch.zeros((B * (A + 1),), dtype=torch.float32, device=dev)
            ret, run_return = floats[:B * A].view(B, A), floats[B * A:]
            ints = torch.zeros((B * (2 + A * nt),), dtype=torch.int32, device=dev)
            steps = collect_philox_slab if slab.kernel else ms_philox_spec
            for start in range(0, num_steps, self.chunk):
                with annotate("rollout.chunk"):
                    K = min(self.chunk, num_steps - start)
                    p, pos, ret = steps(slab, K, p, pos, ret, self.key, self.step)
                    self.step += K
            reward_sum = ret.sum()
            go, gc, gs = unpack_planes(p)
            states = CollectState(
                grid_obj=go, grid_color=gc, grid_slot=gs, agent_pos=pos.reshape(B, A, 2),
                collected=ints[:B], step_count=ints[B:2 * B],
                info_counts=ints[2 * B:].view(B, A, nt),
            )
            return states, {
                "reward_sum": reward_sum,
                "episodes": torch.full((), B * (num_steps // cfg.max_steps), dtype=torch.int32,
                                       device=dev),
                "ep_return_sum": reward_sum,
                "run_return": run_return,
            }


def make_collect_episode_rollout(
    cfg: CollectConfig, num_envs: int, device=None, chunk: int = 25
) -> CollectEpisodeRollout | None:
    """The Collect episode rollout of a truncation-only config (``respawn``
    or ``fixed_horizon``, so that lockstep envs truncate together): the
    counterpart of JAX's ``make_collect_episode_rollout``
    (``ops/pallas_collect.py``), one kernel launch a chunk of steps, which
    makes its own draws and runs the truncation reset, where
    ``BatchedEnv`` runs a step and a masked reset launch every step.  The
    draws are counter-based (``ops/philox.py``), so a seed gives the same
    trajectory on the CPU and on the card.

    ``reset(seed)`` gives fresh states; ``rollout(states, num_steps)`` (the
    object is callable) steps them.  Device as for ``make_collect_batch``:
    the current CUDA device by default, ``device="cpu"`` for the plain
    versions.  Returns None for agent counts other than the kernels' one
    or two, as JAX's does: ``make_collect_batch`` runs those."""
    if not (cfg.respawn or cfg.fixed_horizon):
        raise ValueError(
            "the episode rollout needs a config that only truncates (respawn or "
            "fixed_horizon): early termination breaks lockstep episodes"
        )
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")
    if cfg.num_agents not in AGENT_COUNTS:
        return None
    device = _build.default_device(device, "make_collect_episode_rollout")
    return CollectEpisodeRollout(make_collect_slab(cfg, device), num_envs, chunk)
