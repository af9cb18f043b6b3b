"""Wildfire slab math: one transition and one fresh board for a batch of
envs (PyTorch port).

Counterpart of the slab functions of ``gym_multigrid_tpu/envs/wildfire.py``
and of ``gym_multigrid_tpu/ops/pallas_wildfire.py``: the Pallas kernel
``wildfire_step_slab`` is the hand-written CUDA kernel
``gym_multigrid_tpu_torch/csrc/wildfire_step.cu``, its plain body
``wf_step_math`` is :func:`step_spec` here, and ``wf_reset_math`` is
:func:`reset_spec`.

* :func:`wildfire_step_slab` takes the plain version for tensors on the
  CPU and launches the kernel for CUDA tensors.  It is never a fallback:
  a slab whose config the kernel does not take calls the plain version
  itself (:func:`kernel_route`).  The kernel copies tiles
  of :func:`tile_envs` consecutive envs into shared memory in bulk
  (:func:`tile_spans`), so ``cells`` and ``rnd`` must be 16-byte aligned;
  the wrapper raises on a tensor that is not.
* The spread counts burning neighbours with four shifted copies of the
  board (:func:`neighbor_fires`, JAX's ``_neighbor_fires``).  JAX's other
  form, a (C, C) adjacency matmul, exists for the TPU's matrix unit and is
  not carried over: the step takes no ``adj``.
* The reset has no kernel, here as in the JAX package: :func:`reset_spec`
  runs as PyTorch tensor ops (``PickState``) on whatever device its inputs
  are on.
* :func:`step_batch` / :func:`reset_batch` are the batch glue of
  ``make_wildfire_step_batch`` and of the auto-reset in ``_ms_math``.
  Their uniforms come from a ``torch.Generator``, or from an ``rnd`` tensor
  used as is (which is how the tests hold them to JAX bit for bit).
* :func:`step_reset` is ``BatchedEnv.step`` with the auto-reset in two
  launches on the card: the step kernel, then the kernel entry
  ``wf_autoreset`` (:func:`wf_autoreset_slab`, plain version
  :func:`autoreset_spec`), which does the observation, the rewards, the
  flags, the counts and the fresh boards of the finished envs, the same
  results as :func:`step_batch`, ``encode`` and :func:`reset_batch` on the
  same draws.
* :func:`ms_spec` is ``_ms_math`` in its pre-drawn form: K steps with the
  per-env auto-reset and the return accounting, the form JAX is held
  against.  :func:`ms_philox_spec` is ``ms_spec`` on the draws of the
  counters of ``ops/philox.py``, and :func:`wf_philox_slab` runs it, or for
  CUDA tensors the kernel entry ``wf_steps_philox`` of
  ``csrc/wildfire_step.cu``, which runs all K steps and the fresh boards in
  one launch with each board kept on chip and makes those draws in the
  kernel where they are read;
  :func:`make_wildfire_episode_rollout` drives it chunk by chunk, the
  counterpart of JAX's ``make_wildfire_episode_rollout``.  JAX's default
  episode chunk, ``wf_compact_ms``, compares uniforms quantized to 1/256
  against u8 thresholds, because XLA on the TPU could not fuse its random
  draws into the compares; the port keeps ``_ms_math``'s exact float32
  thresholds and does not carry that form (nor ``compact_supported``)
  over.
* :func:`kernel_route` picks a slab's route once, from its config and
  device type: a config outside the kernels' envelope runs the plain
  versions on the card.

Every float constant of the step is a double rounded to float32 once,
where the JAX package's weakly typed Python floats meet a float32 array;
the ignition thresholds are formed on the host from the numpy float32
survival table, as JAX forms them (:func:`ignite_thresholds`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from gym_multigrid_tpu_torch.envs.wildfire import (
    BURNT,
    BURNT_COLOR,
    EMPTY,
    FIRE,
    FIRE_COLOR,
    MAX_AGENTS,
    NUM_ACTIONS,
    TREE,
    TREE_COLOR,
    WfTables,
    WildfireConfig,
    WildfireState,
    encode,
    ignite_thresholds,
    reset_rnd_width,
    step_rnd_width,
    wf_tables,
)
from gym_multigrid_tpu_torch.ops import _build, philox
from gym_multigrid_tpu_torch.ops.sampling import PickState
from gym_multigrid_tpu_torch.utils.profiling import annotate

#: Largest board the step kernel takes: a lane of the env's warp holds 32
#: cells.  32x32 is 1024 cells.
MAX_CELLS = 1024


def _f32(v) -> float:
    """A double rounded to float32 once, kept as a Python float: a float32
    tensor op takes it without another rounding, and no tensor is copied to
    the device (a copy from the host would wait for the device)."""
    return float(np.float32(v))


# ---------------------------------------------------------------------------
# Step
# ---------------------------------------------------------------------------


def neighbor_fires(t: WfTables, cells):
    """Per-cell count of burning 4-neighbours of a (B, C) flat board
    (``y * width + x``), with no wrap at the edges; in the cells' dtype."""
    C, w = cells.shape[1], t.width
    f = (cells == FIRE).to(cells.dtype)
    col = torch.arange(C, device=cells.device) % w
    pad = torch.nn.functional.pad
    north = pad(f, (w, 0))[:, :C]
    south = pad(f, (0, w))[:, w:]
    west = pad(f, (1, 0))[:, :C] * (col != 0)
    east = pad(f, (0, 1))[:, 1:] * (col != w - 1)
    return north + south + west + east


def move_agents(t: WfTables, pos, acts, u_perm):
    """Sequential moves in a random order for a (B, 2A) position slab.

    The order is ``perms[min(floor(u_perm * A!), A! - 1)]`` (every agent
    is slot 0's mover where that index is negative, as JAX's select chain
    gives).  A mover's target is clipped to the board and is blocked when
    any agent stands on it, earlier movers at their new cells.  Returns
    (xs, ys), each (B, A) int32."""
    A, dev = t.n_agents, pos.device
    n_perms = len(t.perms)
    pidx = (u_perm * n_perms).to(torch.int32).clamp(max=n_perms - 1)
    perms = torch.tensor(t.perms, dtype=torch.int32, device=dev)
    order = torch.where(pidx >= 0, perms[pidx[:, 0].clamp(min=0).long()], 0)  # (B, A)
    xs, ys = pos[:, 0::2].clone(), pos[:, 1::2].clone()
    acts = acts.clamp(0, NUM_ACTIONS - 1).long()
    dx_of = torch.tensor(t.action_dx, dtype=torch.int32, device=dev)
    dy_of = torch.tensor(t.action_dy, dtype=torch.int32, device=dev)
    agent = torch.arange(A, device=dev)[None, :]
    for slot in range(A):
        i_vec = order[:, slot : slot + 1].long()
        mine = agent == i_vec
        act = acts.gather(1, i_vec)
        px, py = xs.gather(1, i_vec), ys.gather(1, i_vec)
        nx = (px + dx_of[act]).clamp(0, t.width - 1)
        ny = (py + dy_of[act]).clamp(0, t.height - 1)
        occupied = ((xs == nx) & (ys == ny)).any(dim=1, keepdim=True)
        moved = ~occupied & ((nx != px) | (ny != py))
        xs = torch.where(mine, torch.where(moved, nx, px), xs)
        ys = torch.where(mine, torch.where(moved, ny, py), ys)
    return xs, ys


def step_spec(t: WfTables, cells, pos, acts, rnd):
    """One Wildfire transition for a batch, in plain PyTorch.

    cells: (B, C) int32 flat board (``y * width + x``)
    pos:   (B, 2A) int32 [a0 x, a0 y, a1 x, ...]
    acts:  (B, A) int32; ids outside 0..4 are clipped
    rnd:   (B, 1 + C) float32 uniforms [move order, one per cell]

    Returns (cells, pos, reward (B, 1) float32 team reward, extinguished
    (B, 1) int32, terminated (B, 1) int32).
    """
    B, C = cells.shape
    dev = cells.device
    w = t.width
    u_perm, field = rnd[:, 0:1], rnd[:, 1:]
    xs, ys = move_agents(t, pos, acts, u_perm)

    # Extinguish: a fire cell under any agent (a cell, not an agent, counts).
    lane = torch.arange(C, dtype=torch.int32, device=dev)[None, :]
    occ = (lane[:, :, None] == (ys * w + xs)[:, None, :]).any(dim=2)
    put_out = occ & (cells == FIRE)
    n_ext = put_out.sum(dim=1, keepdim=True, dtype=torch.int32)
    cells = torch.where(put_out, BURNT, cells)

    # Spread on the post-extinguish board, then burnout on the same field.
    p_ig = torch.tensor(ignite_thresholds(t), dtype=torch.float32, device=dev)
    p_ig = p_ig[neighbor_fires(t, cells).long()]
    ignite = (cells == TREE) & (field < p_ig)
    n_ignited = ignite.sum(dim=1, keepdim=True, dtype=torch.int32)
    burnout = (cells == FIRE) & (field < _f32(t.p_burnout))
    cells = torch.where(burnout, BURNT, torch.where(ignite, FIRE, cells))

    reward = (
        _f32(t.ext_reward) * n_ext.to(torch.float32)
        - _f32(t.burn_penalty) * n_ignited.to(torch.float32)
        - _f32(t.step_penalty)
    )
    terminated = ~(cells == FIRE).any(dim=1, keepdim=True)
    pos_out = torch.stack([xs, ys], dim=2).reshape(B, 2 * t.n_agents)
    return cells, pos_out, reward, n_ext, terminated.to(torch.int32)


def tile_envs(n_cells: int) -> int:
    """Envs in one tile of the step kernel (its ``tile_envs<NK>``): 8, or 4
    for boards above 512 cells, so that two stages of a 32x32 tile fit in
    64 KB of shared memory.  A multiple of 4, so that every span of
    :func:`tile_spans` is a multiple of 16 bytes."""
    return 4 if n_cells > 512 else 8


def ring_bytes(n_cells: int) -> int:
    """Shared memory of the kernel's two-stage ring: per stage, a tile's
    boards (int32) and its uniforms (float32, ``1 + C`` per env)."""
    return 2 * 4 * tile_envs(n_cells) * (2 * n_cells + 1)


def tile_spans(n_cells: int, B: int):
    """The step kernel's bulk copies for a batch of ``B`` boards of
    ``n_cells`` cells: ``(spans, tail)``, where ``spans[i]`` is full tile
    i's ``(cells byte offset, cells bytes, rnd byte offset, rnd bytes)``
    into the ``(B, C)`` int32 boards and the ``(B, 1 + C)`` float32
    uniforms, and ``tail`` the envs past the last full tile, which the
    kernel reads with plain loads."""
    T, C = tile_envs(n_cells), n_cells
    full = B // T
    spans = [(4 * i * T * C, 4 * T * C, 4 * i * T * (C + 1), 4 * T * (C + 1)) for i in range(full)]
    return spans, B - full * T


def _envelope_fault(t: WfTables) -> str | None:
    """Why the kernels do not take this config, or None where they do: at
    most ``MAX_AGENTS`` agents and ``MAX_CELLS`` cells."""
    if t.n_agents > MAX_AGENTS:
        return f"the Wildfire step kernel takes at most {MAX_AGENTS} agents, got {t.n_agents}"
    if t.n_cells > MAX_CELLS:
        return (f"the Wildfire step kernel takes boards of at most {MAX_CELLS} cells, "
                f"got {t.width}x{t.height}")
    return None


def check_envelope(t: WfTables):
    """Raise unless the kernels take this config (:func:`_envelope_fault`)."""
    fault = _envelope_fault(t)
    if fault:
        raise ValueError(fault)


def kernel_route(t: WfTables, device_type: str) -> bool:
    """The route of a slab of ``t`` on a device of this type, decided once
    when the slab is built: True for the kernel wrappers
    (:func:`wildfire_step_slab`, :func:`wf_philox_slab`), which launch the
    kernels on the card and run their plain versions on the CPU; False for
    the plain versions called on the device's tensors directly.  The CPU
    takes every config on the first route, since its "kernels" are the
    plain versions; off the CPU only a config inside the kernels' envelope
    does (:func:`_envelope_fault`), as JAX's batch runs the rest as plain
    XLA.  Not a fallback: nothing is tried and caught."""
    return device_type == "cpu" or _envelope_fault(t) is None


def wildfire_step_slab(t: WfTables, cells, pos, acts, rnd):
    """One transition of the batch: :func:`step_spec` for CPU tensors, the
    CUDA kernel ``csrc/wildfire_step.cu`` for CUDA tensors (new output
    tensors; the inputs are not changed).  Same arguments and results as
    :func:`step_spec`; on the card ``cells`` and ``rnd`` must be 16-byte
    aligned, as every tensor PyTorch allocates is."""
    if cells.device.type == "cpu":
        return step_spec(t, cells, pos, acts, rnd)
    if cells.device.type != "cuda":
        raise ValueError(f"no Wildfire step for tensors on {cells.device}")
    check_envelope(t)
    B, C, A = cells.shape[0], t.n_cells, t.n_agents
    if B < 1:
        raise ValueError("an empty batch has nothing to step")
    dev = cells.device
    for name, x, dtype, shape in (
        ("cells", cells, torch.int32, (B, C)),
        ("pos", pos, torch.int32, (B, 2 * A)),
        ("acts", acts, torch.int32, (B, A)),
        ("rnd", rnd, torch.float32, (B, step_rnd_width(t))),
    ):
        _build.check_arg(name, x, dtype, shape, dev)
    for name, x in (("cells", cells), ("rnd", rnd)):
        if x.data_ptr() % 16:
            raise ValueError(
                f"{name}: the Wildfire step kernel copies tiles in bulk and needs a "
                f"16-byte aligned tensor, got address {x.data_ptr():#x}"
            )
    outs = (
        torch.empty_like(cells), torch.empty_like(pos),
        torch.empty((B, 1), dtype=torch.float32, device=dev),
        torch.empty((B, 1), dtype=torch.int32, device=dev),
        torch.empty((B, 1), dtype=torch.int32, device=dev),
    )
    # Float constants: the ignition thresholds are float32 values already;
    # the rest are doubles rounded to float32 once, as _f32 does.  ctypes
    # passes each as a C float.
    kernels = _build.load()
    with torch.cuda.device(dev):
        err = kernels.wildfire_step(
            cells.data_ptr(), pos.data_ptr(), acts.data_ptr(), rnd.data_ptr(),
            *(o.data_ptr() for o in outs),
            B, t.width, t.height, A, tile_envs(C),
            *ignite_thresholds(t)[1:], t.p_burnout,
            t.ext_reward, t.burn_penalty, t.step_penalty,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"wildfire_step kernel launch failed: CUDA error {err}")
    wildfire_step_slab.launches += 1
    return outs


#: Launches of the step kernel since the count was last set to 0.
wildfire_step_slab.launches = 0


# ---------------------------------------------------------------------------
# Reset (no kernel: plain PyTorch on the batch's device)
# ---------------------------------------------------------------------------


def reset_spec(t: WfTables, rnd):
    """Fresh boards from (B, C + n_fires + A) float32 uniforms: a tree on
    each cell whose draw is below ``tree_density``, then the initial fires
    uniform among the trees without replacement (fewer where there are
    fewer trees), then the agents uniform among all cells without
    replacement.  Returns (cells (B, C) int32, pos (B, 2A) int32)."""
    B, C, dev = rnd.shape[0], t.n_cells, rnd.device
    trees = rnd[:, :C] < _f32(t.tree_density)
    picks = rnd[:, C:]
    cells = torch.where(trees, TREE, EMPTY).to(torch.int32)
    ps = PickState.make(trees)
    for j in range(t.n_fires):
        hit, _, ps = ps.pick(picks[:, j : j + 1])
        cells = torch.where(hit, FIRE, cells)
    ps = PickState.full(B, C, dev)
    cols = []
    for i in range(t.n_agents):
        _, idx, ps = ps.pick(picks[:, t.n_fires + i : t.n_fires + i + 1])
        cols += [idx % t.width, idx // t.width]
    return cells, torch.cat(cols, dim=1)


# ---------------------------------------------------------------------------
# K steps with the auto-reset
# ---------------------------------------------------------------------------


def ms_spec(t: WfTables, K: int, cells, pos, sc, ext, run_ret, acts, rnd_step, rnd_reset):
    """K Wildfire steps with the per-env auto-reset and the return
    accounting, in plain PyTorch: ``_ms_math`` with one slice of draws a
    step.

    cells (B, C), pos (B, 2A), sc and ext (B,) int32; run_ret (B,) float32,
    the team return of each episode in progress; acts (K, B, A) int32 ids
    (clipped as by :func:`step_spec`); rnd_step (K, B, 1 + C) and rnd_reset
    (K, B, C + n_fires + A) float32, the step's and the fresh board's
    uniforms, the fresh board's drawn for every env whether it finished or
    not.  Returns (cells, pos, sc, ext, run_ret, rew_sum, ep_sum, eps): the
    state after the K steps and, per env, the sum of its team rewards, the
    summed returns of the episodes it finished (float32) and how many it
    finished (int32), all (B,) but the state's planes.  Every sum is taken
    one step at a time in JAX's order.  A finished env gets a fresh board
    from :func:`reset_spec` and step and extinguished counts 0."""
    B = cells.shape[0]
    rew_sum = torch.zeros((B,), dtype=torch.float32, device=cells.device)
    ep_sum = torch.zeros_like(rew_sum)
    eps = torch.zeros((B,), dtype=torch.int32, device=cells.device)
    for k in range(K):
        cells2, pos2, reward, n_ext, term = step_spec(t, cells, pos, acts[k], rnd_step[k])
        reward, sc2 = reward[:, 0], sc + 1
        done = (term[:, 0] == 1) | (sc2 >= t.max_steps)
        run2 = run_ret + reward
        rew_sum = rew_sum + reward
        ep_sum = ep_sum + torch.where(done, run2, 0.0)
        eps = eps + done.to(torch.int32)
        run_ret = torch.where(done, 0.0, run2)
        rcells, rpos = reset_spec(t, rnd_reset[k])
        rows = done[:, None]
        cells = torch.where(rows, rcells, cells2)
        pos = torch.where(rows, rpos, pos2)
        sc = torch.where(done, 0, sc2)
        ext = torch.where(done, 0, ext + n_ext[:, 0])
    return cells, pos, sc, ext, run_ret, rew_sum, ep_sum, eps


def ms_philox_spec(t: WfTables, K: int, cells, pos, sc, ext, run_ret, key, step0: int):
    """K Wildfire steps with the auto-reset on the draws of the counters of
    ``ops/philox.py``: the global steps ``step0 .. step0 + K - 1`` of the
    rollout keyed by ``key``.  Forms the actions, the step's uniforms and
    the fresh boards' uniforms from the counters and runs :func:`ms_spec`
    on them, so it is held to JAX's ``_ms_math`` as ``ms_spec`` is.  Same
    state arguments and results as :func:`ms_spec`."""
    B, dev = cells.shape[0], cells.device
    steps = torch.arange(step0, step0 + K, dtype=torch.int64, device=dev)
    draws = philox.episode_draws(key, steps, B, t.n_agents, t.n_cells, fresh_picks(t), dev)
    return ms_spec(t, K, cells, pos, sc, ext, run_ret, *draws)


def fresh_picks(t: WfTables) -> int:
    """The pick uniforms of a fresh board: one a fire, then one an agent."""
    return t.n_fires + t.n_agents


def wf_philox_slab(slab: "WildfireSlab", cells, pos, sc, ext, run_ret, key, step0: int, K: int):
    """K steps of the batch with the auto-reset on ``ops/philox.py``'s
    draws: :func:`ms_philox_spec` for CPU tensors, the CUDA kernel entry
    ``wf_steps_philox`` of ``csrc/wildfire_step.cu`` for CUDA tensors, one
    launch for all K steps that makes each draw where it is read and reads
    no uniform from memory (new output tensors; the inputs are not
    changed).  Same results as :func:`ms_spec`."""
    t = slab.t
    if cells.device.type == "cpu":
        return ms_philox_spec(t, K, cells, pos, sc, ext, run_ret, key, step0)
    if cells.device.type != "cuda":
        raise ValueError(f"no Wildfire steps for tensors on {cells.device}")
    check_envelope(t)
    B, C, A = cells.shape[0], t.n_cells, t.n_agents
    if B < 1 or K < 1:
        raise ValueError(f"nothing to step: {B} envs, {K} steps")
    dev = cells.device
    for name, x, dtype, shape in (
        ("cells", cells, torch.int32, (B, C)),
        ("pos", pos, torch.int32, (B, 2 * A)),
        ("sc", sc, torch.int32, (B,)),
        ("ext", ext, torch.int32, (B,)),
        ("run_ret", run_ret, torch.float32, (B,)),
    ):
        _build.check_arg(name, x, dtype, shape, dev)
    outs = (
        torch.empty_like(cells), torch.empty_like(pos), torch.empty_like(sc),
        torch.empty_like(ext), torch.empty_like(run_ret), torch.empty_like(run_ret),
        torch.empty_like(run_ret), torch.empty_like(sc),
    )
    kernels = _build.load()
    with torch.cuda.device(dev):
        err = kernels.wf_steps_philox(
            cells.data_ptr(), pos.data_ptr(), sc.data_ptr(), ext.data_ptr(),
            run_ret.data_ptr(), *(o.data_ptr() for o in outs),
            B, K, t.width, t.height, A, t.n_fires, t.max_steps,
            *(philox.signed(w) for w in (*key, step0)),
            *ignite_thresholds(t)[1:], t.p_burnout,
            t.ext_reward, t.burn_penalty, t.step_penalty, t.tree_density,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err:
        raise RuntimeError(f"wf_steps_philox kernel launch failed: CUDA error {err}")
    wf_philox_slab.launches += 1
    return outs


#: Launches of the in-kernel-draws K-step kernel since the count was last set to 0.
wf_philox_slab.launches = 0


# ---------------------------------------------------------------------------
# Batch glue
# ---------------------------------------------------------------------------


@dataclass(frozen=True, eq=False)
class WildfireSlab:
    """Everything the batch glue needs for one config on one device."""

    cfg: WildfireConfig
    device: torch.device
    t: WfTables
    #: The route (:func:`kernel_route`): the kernel wrappers, or the plain
    #: versions on the slab's device.
    kernel: bool

    @property
    def step_draws(self) -> int:
        """Uniforms one env's step takes."""
        return step_rnd_width(self.t)

    @property
    def reset_draws(self) -> int:
        """Uniforms one env's reset takes."""
        return reset_rnd_width(self.t)

    @functools.cached_property
    def autoreset_args(self) -> tuple:
        """The config's arguments of the kernel entry ``wf_autoreset``, after
        the batch size: formed once, not on every step."""
        t = self.t
        colors = (*self.cfg.agents_index, 0, 0, 0)[:MAX_AGENTS]
        return (t.width, t.height, t.n_agents, t.n_fires, t.max_steps,
                TREE_COLOR, FIRE_COLOR, BURNT_COLOR, *colors, t.tree_density)


def make_wildfire_slab(cfg: WildfireConfig, device) -> WildfireSlab:
    """The slab of ``cfg`` on ``device``, its route picked by
    :func:`kernel_route`: a CUDA slab of a config outside the kernels'
    envelope runs the plain versions on the card."""
    device = torch.device(device)
    t = wf_tables(cfg)
    return WildfireSlab(cfg, device, t, kernel_route(t, device.type))


def step_batch(
    slab: WildfireSlab,
    states: WildfireState,
    actions: torch.Tensor,
    *,
    generator: torch.Generator | None = None,
    rnd: torch.Tensor | None = None,
    encode_obs: bool = True,
    with_info: bool = True,
):
    """Batch-level Wildfire step.

    Returns (states', obs, rewards (B, A) float32, terminated (B,),
    truncated (B,), info): every agent gets the team reward divided by A.
    ``rnd`` (B, ``slab.step_draws``) is used as is when given, else drawn
    from ``generator``.  ``encode_obs=False`` and ``with_info=False`` return
    None for the obs and the info."""
    t, cfg = slab.t, slab.cfg
    B, C, A = states.cells.shape[0], t.n_cells, t.n_agents
    if rnd is None:
        rnd = torch.rand((B, slab.step_draws), generator=generator, device=slab.device)
    step = wildfire_step_slab if slab.kernel else step_spec
    cells, pos, reward, n_ext, term = step(
        t,
        states.cells.reshape(B, C),
        states.agent_pos.reshape(B, 2 * A),
        actions.reshape(B, A).to(torch.int32).contiguous(),
        rnd,
    )
    new_states, rewards, terminated, truncated = _step_tail(
        slab, cells, pos, reward, n_ext, term, states.step_count, states.extinguished)
    obs = encode(cfg, new_states) if encode_obs else None
    step_info = None
    if with_info:
        step_info = {
            "extinguished": new_states.extinguished,
            "burning": (cells == FIRE).sum(dim=1, dtype=torch.int32),
            "burnt": (cells == BURNT).sum(dim=1, dtype=torch.int32),
        }
    return new_states, obs, rewards, terminated, truncated, step_info


def _step_tail(slab: WildfireSlab, cells, pos, reward, n_ext, term, step_count, extinguished):
    """A batch step's results past the transition (:func:`step_spec`'s
    outputs, the counts before it): (states', rewards (B, A) float32,
    terminated (B,), truncated (B,)).  Every agent gets the team reward
    divided by A, a float32 division on every device (a division by a
    Python number is a multiply by its reciprocal on the card)."""
    cfg, t = slab.cfg, slab.t
    B, A = cells.shape[0], t.n_agents
    step_count = step_count + 1
    new_states = WildfireState(
        cells=cells.reshape(B, cfg.height, cfg.width),
        agent_pos=pos.reshape(B, A, 2),
        step_count=step_count,
        extinguished=extinguished + n_ext[:, 0],
    )
    return (new_states, (reward / torch.full_like(reward, A)).repeat(1, A),
            term[:, 0].to(torch.bool), step_count >= t.max_steps)


def reset_batch(
    slab: WildfireSlab,
    num_envs: int,
    *,
    generator: torch.Generator | None = None,
    rnd: torch.Tensor | None = None,
    done: torch.Tensor | None = None,
    states: WildfireState | None = None,
) -> WildfireState:
    """Batch reset: fresh boards and spawns from :func:`reset_spec`, step
    count and extinguished count 0.

    ``rnd`` (num_envs, ``slab.reset_draws``) is used as is when given, else
    drawn from ``generator``.  With ``done`` (num_envs,) bool, the result is
    ``states`` with the rows where it is True reset, in new tensors:
    ``states`` itself is not changed."""
    cfg, A = slab.cfg, slab.t.n_agents
    if rnd is None:
        rnd = torch.rand((num_envs, slab.reset_draws), generator=generator, device=slab.device)
    cells, pos = reset_spec(slab.t, rnd)
    cells = cells.reshape(num_envs, cfg.height, cfg.width)
    pos = pos.reshape(num_envs, A, 2)
    if done is None:
        zeros = torch.zeros((num_envs,), dtype=torch.int32, device=slab.device)
        return WildfireState(cells=cells, agent_pos=pos, step_count=zeros,
                             extinguished=zeros.clone())
    rows = done[:, None, None]
    return WildfireState(
        cells=torch.where(rows, cells, states.cells),
        agent_pos=torch.where(rows, pos, states.agent_pos),
        step_count=states.step_count.masked_fill(done, 0),
        extinguished=states.extinguished.masked_fill(done, 0),
    )


# ---------------------------------------------------------------------------
# The per-step auto-reset
# ---------------------------------------------------------------------------


def autoreset_spec(slab: WildfireSlab, cells, pos, reward, n_ext, term, sc, ext, rnd_reset,
                   encode_obs: bool = True):
    """The rest of a batch step after the transition, with the auto-reset,
    in plain PyTorch: :func:`step_batch`'s results past the step
    (``_step_tail``), ``encode`` of its states, and :func:`reset_batch` of
    the finished rows on ``rnd_reset``.

    cells (B, C), pos (B, 2A), reward (B, 1), n_ext and term (B, 1): a
    step's results (:func:`step_spec`); sc and ext (B,) int32: the step
    and put-out counts before it; rnd_reset (B, ``slab.reset_draws``): the
    fresh boards' uniforms, of which the finished rows' are read.  Returns
    (cells, pos, sc, ext, obs, rewards (B, A) float32, terminated (B,),
    truncated (B,)): the next state's planes and counts, the obs of the
    stepped boards before the reset (None with ``encode_obs=False``), and
    the step's flags.  A row is finished where it terminated or its count
    reaches ``max_steps``; it gets a fresh board and counts 0, the others
    their counts plus one step and the fires put out."""
    B = cells.shape[0]
    states, rewards, terminated, truncated = _step_tail(
        slab, cells, pos, reward, n_ext, term, sc, ext)
    obs = encode(slab.cfg, states) if encode_obs else None
    states = reset_batch(slab, B, rnd=rnd_reset, done=terminated | truncated, states=states)
    return (states.cells.reshape(B, -1), states.agent_pos.reshape(B, -1), states.step_count,
            states.extinguished, obs, rewards, terminated, truncated)


def wf_autoreset_slab(slab: WildfireSlab, cells, pos, reward, n_ext, term, sc, ext, rnd_reset,
                      encode_obs: bool = True):
    """:func:`autoreset_spec` for CPU tensors; for CUDA tensors the kernel
    entry ``wf_autoreset`` of ``csrc/wildfire_step.cu``, one launch, which
    writes the fresh boards of the finished rows into ``cells`` and ``pos``
    in place (they are :func:`wildfire_step_slab`'s own outputs) and
    returns them; every other result is a new tensor.  Same arguments and
    results as :func:`autoreset_spec`."""
    t = slab.t
    if cells.device.type == "cpu":
        return autoreset_spec(slab, cells, pos, reward, n_ext, term, sc, ext, rnd_reset,
                              encode_obs)
    if cells.device.type != "cuda":
        raise ValueError(f"no Wildfire auto-reset for tensors on {cells.device}")
    check_envelope(t)
    B, C, A = cells.shape[0], t.n_cells, t.n_agents
    if B < 1:
        raise ValueError("an empty batch has nothing to reset")
    for name, x, dtype, shape in (
        ("cells", cells, torch.int32, (B, C)),
        ("pos", pos, torch.int32, (B, 2 * A)),
        ("reward", reward, torch.float32, (B, 1)),
        ("n_ext", n_ext, torch.int32, (B, 1)),
        ("term", term, torch.int32, (B, 1)),
        ("sc", sc, torch.int32, (B,)),
        ("ext", ext, torch.int32, (B,)),
        ("rnd_reset", rnd_reset, torch.float32, (B, reset_rnd_width(t))),
    ):
        _build.check_arg(name, x, dtype, shape, cells.device)
    return _autoreset_launch(slab, cells, pos, reward, n_ext, term, sc, ext, rnd_reset,
                             encode_obs)


#: Launches of the auto-reset kernel since the count was last set to 0.
wf_autoreset_slab.launches = 0


def _autoreset_launch(slab: WildfireSlab, cells, pos, reward, n_ext, term, sc, ext, rnd_reset,
                      encode_obs):
    """:func:`wf_autoreset_slab`'s launch on checked arguments, with the
    config's arguments formed once a slab and no stream object built.  One
    ``torch.empty`` an output (one a dtype, split into views, costs the
    host as much)."""
    B, dev = cells.shape[0], cells.device
    cfg = slab.cfg
    obs = (torch.empty((B, cfg.width, cfg.height, 3), dtype=torch.uint8, device=dev)
           if encode_obs else None)
    rewards = torch.empty((B, slab.t.n_agents), dtype=torch.float32, device=dev)
    sc_out = torch.empty((B,), dtype=torch.int32, device=dev)
    ext_out = torch.empty((B,), dtype=torch.int32, device=dev)
    terminated = torch.empty((B,), dtype=torch.bool, device=dev)
    truncated = torch.empty((B,), dtype=torch.bool, device=dev)
    err = _build.call_on(
        dev, _build.load().wf_autoreset,
        cells.data_ptr(), pos.data_ptr(), reward.data_ptr(), n_ext.data_ptr(),
        term.data_ptr(), sc.data_ptr(), ext.data_ptr(), rnd_reset.data_ptr(),
        None if obs is None else obs.data_ptr(), rewards.data_ptr(), sc_out.data_ptr(),
        ext_out.data_ptr(), terminated.data_ptr(), truncated.data_ptr(), B,
        *slab.autoreset_args,
    )
    if err:
        raise RuntimeError(f"wf_autoreset kernel launch failed: CUDA error {err}")
    wf_autoreset_slab.launches += 1
    return cells, pos, sc_out, ext_out, obs, rewards, terminated, truncated


def step_reset(slab: WildfireSlab, states: WildfireState, actions: torch.Tensor,
               generator: torch.Generator | None, encode_obs: bool):
    """``BatchedEnv.step`` with the auto-reset for a slab on the kernel
    route: (states', obs, rewards (B, A), terminated, truncated), as
    :func:`step_batch`, ``encode`` of its states and :func:`reset_batch`
    of the finished rows give them.  The draws are theirs, from
    ``generator`` in their order: the step's (B, ``slab.step_draws``),
    then the fresh boards' (B, ``slab.reset_draws``).  Then one
    :func:`wildfire_step_slab` and one :func:`wf_autoreset_slab`; nothing
    waits for the device, and ``states`` is not written."""
    t, cfg = slab.t, slab.cfg
    B, C, A = states.cells.shape[0], t.n_cells, t.n_agents
    sc, ext = states.step_count, states.extinguished
    if actions.dtype != torch.int32 or actions.shape != (B, A) or not actions.is_contiguous():
        actions = actions.reshape(B, A).to(torch.int32).contiguous()
    with annotate("env.transition"):
        rnd = torch.rand((B, slab.step_draws), generator=generator, device=slab.device)
        rnd_reset = torch.rand((B, slab.reset_draws), generator=generator, device=slab.device)
        step = wildfire_step_slab(
            t, states.cells.reshape(B, C), states.agent_pos.reshape(B, 2 * A), actions, rnd)
    with annotate("env.autoreset"):
        if step[0].device.type == "cuda":
            # The step kernel's outputs and the reset's uniforms have the
            # shapes the launch needs by construction: only the caller's
            # counts are checked.
            for name, x in (("step_count", sc), ("extinguished", ext)):
                _build.check_arg(name, x, torch.int32, (B,), step[0].device)
            out = _autoreset_launch(slab, *step, sc, ext, rnd_reset, encode_obs)
        else:
            out = wf_autoreset_slab(slab, *step, sc, ext, rnd_reset, encode_obs)
    cells, pos, sc, ext, obs, rewards, term, trunc = out
    return (WildfireState(cells.reshape(B, cfg.height, cfg.width), pos.reshape(B, A, 2), sc, ext),
            obs, rewards, term, trunc)


# ---------------------------------------------------------------------------
# Episode rollout
# ---------------------------------------------------------------------------


@dataclass(eq=False)
class WildfireEpisodeRollout:
    """``rollout(states, num_steps)`` of a batch of Wildfire envs, ``chunk``
    steps a kernel launch (:func:`make_wildfire_episode_rollout`).  Its
    draws come from the counters of ``ops/philox.py``: ``key``, set by
    :meth:`reset`, and ``step``, the running count of the steps taken since
    then, kept on the host."""

    slab: WildfireSlab
    num_envs: int
    chunk: int
    key: tuple[int, int] = (0, 0)
    step: int = 0

    @property
    def cfg(self) -> WildfireConfig:
        return self.slab.cfg

    def reset(self, seed: int):
        """Key the draws by ``seed``, set the step count to 0 and reset
        every env from the first reset's counters: (states, obs)."""
        t, dev = self.slab.t, self.slab.device
        self.key, self.step = philox.key_of(seed), 0
        rnd = philox.first_reset_draws(self.key, self.num_envs, t.n_cells, fresh_picks(t), dev)
        states = reset_batch(self.slab, self.num_envs, rnd=rnd)
        return states, encode(self.cfg, states)

    def __call__(self, states: WildfireState, num_steps: int, run_return=None):
        """``num_steps`` steps with uniform random actions and the
        auto-reset; returns (states, metrics) with ``BatchedEnv.rollout``'s
        metrics, the team reward summed once per env and step, as JAX's
        episode rollout sums it.  Each chunk of K steps is one
        :func:`wf_philox_slab` (on the plain route, :func:`ms_philox_spec`)
        at the running step count, which then grows by K; a last chunk
        covers ``num_steps % chunk``.  How the steps are cut into chunks
        changes nothing, and nothing in the loop waits for the device."""
        with annotate("rollout.call"):
            slab, B, dev = self.slab, self.num_envs, self.slab.device
            cfg, t = self.cfg, slab.t
            run_ret = (torch.zeros((B,), dtype=torch.float32, device=dev)
                       if run_return is None else run_return)
            reward_sum = torch.zeros((), dtype=torch.float32, device=dev)
            ep_ret_sum = torch.zeros_like(reward_sum)
            episodes = torch.zeros((), dtype=torch.int32, device=dev)
            state = (states.cells.reshape(B, t.n_cells),
                     states.agent_pos.reshape(B, 2 * t.n_agents), states.step_count,
                     states.extinguished)
            for start in range(0, num_steps, self.chunk):
                with annotate("rollout.chunk"):
                    K = min(self.chunk, num_steps - start)
                    if slab.kernel:
                        out = wf_philox_slab(slab, *state, run_ret, self.key, self.step, K)
                    else:
                        out = ms_philox_spec(t, K, *state, run_ret, self.key, self.step)
                    *state, run_ret, rew, ep, eps = out
                    self.step += K
                    reward_sum = reward_sum + rew.sum()
                    ep_ret_sum = ep_ret_sum + ep.sum()
                    episodes = episodes + eps.sum(dtype=torch.int32)
            cells, pos, sc, ext = state
            return WildfireState(cells.reshape(B, cfg.height, cfg.width),
                                 pos.reshape(B, t.n_agents, 2), sc, ext), {
                "reward_sum": reward_sum,
                "episodes": episodes,
                "ep_return_sum": ep_ret_sum,
                "run_return": run_ret,
            }


def make_wildfire_episode_rollout(
    cfg: WildfireConfig, num_envs: int, device=None, chunk: int = 8
) -> WildfireEpisodeRollout:
    """The Wildfire episode rollout: the counterpart of JAX's
    ``make_wildfire_episode_rollout`` (``ops/pallas_wildfire.py``) on its
    ``_ms_math`` form, one kernel launch a chunk of steps, which draws its
    own numbers, instead of ``BatchedEnv``'s step launch and plain masked
    fresh-board draw a step.  The draws are counter-based (``ops/philox.py``),
    so a seed gives the same trajectory on the CPU and on the card.

    ``reset(seed)`` gives fresh states; ``rollout(states, num_steps)`` (the
    object is callable) steps them.  The default device is the current
    CUDA device; with no CUDA device and no explicit ``device`` this
    raises, and ``device="cpu"`` runs :func:`ms_spec`."""
    device = _build.default_device(device, "make_wildfire_episode_rollout")
    if chunk < 1:
        raise ValueError(f"chunk must be at least 1, got {chunk}")
    return WildfireEpisodeRollout(make_wildfire_slab(cfg, device), num_envs, chunk)
