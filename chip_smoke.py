"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py        # from the root of a checkout

Needs one CUDA device and ``nvcc``; exits non-zero, printing no result,
without them.  Phases, each of which fails the run on any fault:

1. Build the CUDA kernels from ``gym_multigrid_tpu_torch/csrc/``, one
   ``nvcc`` per source, all at once; print each variant's registers, shared
   memory and spills, and the Wildfire ring's dynamic shared memory.
2. Hold each kernel to its plain PyTorch version on the card, bit for bit:
   the Collect step kernel over 100 chained steps at B = 8192 (the main
   config, the 1-agent even config and the 15x15 quadrants config, with the
   invalid action ids -1, 4 and 7 mixed in), the Collect reset kernel on
   every layout and under a random ``done`` mask, the CtF step kernel over
   100 chained steps at B = 8192 on four configs (CTF_MAIN; 2v2
   patrol/patrol_fight with an obstacle penalty; 1v1 fight; 3v3
   capture/patrol/rw), the Maze step kernel over 100 chained steps at
   B = 8192 on MAZE_MAIN and on the same map with an obstacle penalty (the
   ids -1, 5 and 9 mixed in), and the Wildfire step kernel over 100 chained
   steps at B = 8192 on WF_MAIN, on a 10x10 4-agent config with a step
   penalty and on a 32x32 config that spreads to every neighbour and never
   burns out, plus one call on random boards with stacked agents.  Both
   CtF and Wildfire also run on the ragged batches B = 8189 and B = 5,
   neither a multiple of the Wildfire tile nor of the CtF lane group, and
   the Collect reset on them too.  The Maze K-step entry
   ``maze_steps_philox``, which makes its draws and keeps each env's sums
   in the kernel, is held to ``ms_philox_spec`` (``ms_spec`` on the draws
   of ``ops/philox.py``'s ``MAZE`` counters, the sums carried) over 100
   steps from the first reset with the auto-reset, as four chunks of 25,
   as one of 100 and as chunks of 33, 33 and 34 (odd starting steps),
   every launch compared, on both Maze configs at B = 8192, 8189 and 5;
   the Maze episode rollout at B = 64 on the card equals the same seed's
   rollout on the CPU bit for bit.  The Collect K-step entry ``collect_steps_philox``,
   which makes its draws and runs the truncation reset in the kernel, is
   held to ``ms_philox_spec`` (``ms_spec`` and ``reset_spec`` on the draws
   of ``ops/philox.py``'s counters) over 60 steps from the first reset's
   boards, an episode's end 30 steps in, as launches of 1, 25, 50 and 30
   steps (the packed boards, positions and running rewards) on the main
   config, the one-agent config, a fixed-horizon config, a 16x16 board and
   a config of 17 ball types, at B = 8192, 8189 and 5; the Collect episode
   rollout at B = 64 on the card equals the same seed's rollout on the CPU
   bit for bit.  The CtF K-step entry ``ctf_steps`` is held to its
   ``ms_spec`` over 100 steps as chunks of 25 and of 50 on the four CtF
   configs and a non-square patrol board, and as launches of one step on
   CTF_MAIN, at a ``max_steps`` of 30 so that every env resets at least
   twice, at B = 8192, 8189 and 5.  The Wildfire K-step entry, which makes
   its draws in the kernel, ``wf_steps_philox``, is held to
   ``ms_philox_spec`` (``ms_spec`` on the draws of ``ops/philox.py``'s
   counters) on the three Wildfire configs, chunks of 24 and of 8 starting
   at their running step, at ``max_steps`` 30 and B = 8192, 8189 and 5;
   the Wildfire episode rollout
   at B = 64 on the card equals the same seed's rollout on the CPU bit for
   bit.  Configs outside a kernel's envelope take the plain route on the
   card and launch no kernel, bit-equal to the CPU on the same draws:
   Collect on a 20x20 board (``step_spec`` and ``reset_rows`` on the
   card against ``make_collect_slab(cfg, "cpu")``), CtF 5 v 5 on
   ``board_large.txt`` and a 40x40 Wildfire board (batch envs at
   max_steps 10; their per-env functions), the 40x40 Wildfire episode
   rollout from one seed, and the episode rollout of a Maze map whose
   K-step table does not fit (6 x 6 copies of ``board_maze.txt``) from one
   seed; the Collect
   20x20 respawn and Wildfire 40x40 episode rollouts are driven on the
   card, and the per-env functions of the Collect 20x20, CtF 5 v 5 and
   Wildfire 40x40 configs are held to the CPU.  Finished envs are respawned
   by each family's ``reset_batch`` under the ``done`` mask.  Misaligned Wildfire uniforms
   are refused, not copied.  Collect with three agents, which no kernel
   takes, runs its plain route (``step_perm``, ``reset_rows``) on the
   card at B = 8192 for 60 chained steps with masked resets, bit-equal to
   the same functions on the CPU given the same move orders and uniforms,
   and launching no kernel.  Each family's partial encode (V = 7) on the
   card at B = 8192, after a reset and 20 steps of the batch built with
   ``partial_obs_view``, bit-equal to the same function on the CPU for 512
   of its rows.  The CtF all-agent step (``step_actions_batch``, plain
   PyTorch) on the card, on CTF_MAIN and the 2v2 patrol config, bit-equal
   to the CPU over 60 chained steps with masked resets given the same
   actions, move orders and battle uniforms, launching no kernel.  The
   per-env functions (``make_collect``, ``make_ctf``, ``make_maze``,
   ``make_wildfire``: the batch functions at B = 1, so one step-kernel
   launch a step on the card) on the card against the plain versions on
   the CPU over 60 chained steps of MAIN, CTF_MAIN, MAZE_MAIN and WF_MAIN
   at a max_steps of 30, given the same actions and explicit draws,
   exactly 60 launches of each step kernel and one ``collect_reset``
   launch a Collect reset; the adapters' host-policy path (a subclass of each stock CtF
   policy class acting on the host, then ``step_actions_fn``) on the card
   against the CPU over 60 steps, launching no kernel.  ``next_step_autoreset`` (the gymnasium NEXT_STEP
   step of the vector env) at B = 8192 on each family's main config at a
   max_steps of 30, 200 steps: the rows not masked bit-equal to
   ``BatchedEnv.step`` of a second env seeded alike on the same states,
   the masked rows held with ``encode`` of their states, reward 0 and no
   flag.
3. Drive each path, with every launch count set to 0 just before it and
   read just after: Collect (``make_collect_batch`` of the
   respawn-clustered config at B = 8192, ``reset(seed=0)``, ``rollout`` of
   500 steps), CtF (``make_ctf_batch(CTF_MAIN, 8192)``, ``reset(seed=0)``,
   ``rollout`` of 400 steps), Maze (``make_maze_batch(MAZE_MAIN, 8192)``,
   ``rollout`` of 1000 steps) and Wildfire
   (``make_wildfire_batch(WF_MAIN, 8192)``, ``rollout`` of 400 steps), each
   of which launches its own step kernel once a step and no other kernel of
   the port; then the episode paths, the Collect one
   (``make_collect_episode_rollout`` of the same config, ``reset(seed=0)``
   and 500 steps: twenty 25-step ``collect_steps_philox`` launches, the
   one all-rows ``collect_reset`` of ``reset`` and no ``collect_step``) and
   the Maze one (``make_maze_episode_rollout(MAZE_MAIN, 8192,
   chunk=100)``, ``reset(seed=0)`` and 1000 steps: ten
   ``maze_steps_philox`` launches, no ``maze_step``, at most 16 kernels in
   its profile and no draw kernel), the CtF one (``make_ctf_episode_rollout(CTF_MAIN, 8192,
   chunk=50)``, ``reset(seed=0)`` and 400 steps: eight ``ctf_steps``
   launches) and the Wildfire one (``make_wildfire_episode_rollout(WF_MAIN,
   8192, chunk=24)``, ``reset(seed=0)`` and 400 steps: seventeen
   ``wf_steps_philox`` launches, no draw).  Check each rollout's invariants;
   then, after untimed calls until the time per call settles, time it,
   each kernel and its plain version (the bound of ``wf_steps_philox``
   counts the Philox calls and words that its inputs need, replayed with
   the plain version), and the launch floor (an empty kernel's device time
   a launch, beside ``maze_step``'s bound).  Then the two training paths, Collect and CtF:
   ``make_family_batch(family, 8192)``, ``ActorCritic(hidden=(256,
   256))``, ``PPOConfig(rollout_len=32, num_epochs=2, num_minibatches=8)``,
   the card's forward within 3e-2 of the CPU's on the same params and obs,
   then 2 untimed and 5 timed iterations, each counted alone: 32
   ``collect_step`` and 32 ``collect_reset`` an iteration, or 32
   ``ctf_step``, and no other kernel; finite losses, moved params;
   env-steps/s, the rollout and update ms by CUDA events and
   ``reward_per_step`` of each iteration.  Then evaluation with the same
   net, greedy, 200 steps a call, each call counted: ``evaluate`` on the
   Collect family batch (200 ``collect_step``, 200 masked and one all-rows
   ``collect_reset``) and on the CtF one (200 ``ctf_step``), and
   ``evaluate_ctf(CTF_MAIN, 8192)`` (200 ``ctf_step``; wins, losses and
   draws partition the episodes); agent-steps/s of three timed calls each.
   Self-play (``make_selfplay_ppo`` on ``make_ctf_selfplay_batch(CTF_MAIN,
   8192)``, both nets at that width, int8 obs buffer): 2 untimed and 5
   timed iterations launching no kernel, finite losses, red's reward minus
   blue's, both nets moved, env-steps/s; one league iteration
   (``make_league_ppo``, pool_size 2) and ``snapshot_fn``.  The
   partial-obs CtF path (``make_ctf_batch(CTF_MAIN, 8192,
   partial_obs_view=7)``, ``reset(seed=0)``, 50 steps of random blue
   actions): 50 ``ctf_step``, obs (8192, 4, 7, 7, 3) uint8, the encode's
   and the step's µs.  The vector envs: ``make_vector_env(family, 8192)``
   drives ``NextStepEnv(make_vector_batch(family, 8192))`` (gymnasium is
   not installed on the card's machine, so the gymnasium shell is left
   out), ``reset(seed=0)`` and 200 steps of host numpy actions for each
   family: one step-kernel launch a step (and one masked
   ``collect_reset``), no other kernel; agent-steps/s of 50-step calls,
   timed as the rollouts.  One env's steps/s through ``make_collect`` and
   ``make_ctf`` on the card (what the single-env adapters step).  The
   render phase (no kernel of the port): each family's
   ``render_<family>_batch`` at B = 8192 and T = 32 (Collect main,
   CTF_MAIN, MAZE_MAIN, WF_MAIN after a reset and 20 steps), 64 rows
   spread over the batch pixel-equal to the CPU's render of the same
   states and the whole batch equal to a two-pass gather, timed (ms, GB/s,
   the byte bound, peak memory) beside it; hand-built CtF and Wildfire
   batches with stacked agents card against CPU; ``toroid_obs_fn``
   batched on Collect main, 512 rows against the CPU; and the ``evaluate
   --gif`` frame function (``policy_frames``) of Collect main and CTF_MAIN
   at B = 1 for 50 steps with an untrained full-width net, counted: one
   step-kernel launch a frame after the first reset, uint8 frames.
4. Profile 50 steps of each ``BatchedEnv`` rollout, 100 of each episode
   path (of the Collect one a whole 500-step call, which must launch at
   most 32 kernels in all), one iteration of each training path, one self-play iteration and
   one Collect evaluation call and one Collect vector-env step: device time
   by kernel, device time a step and idle share (``utils/profiling.py``
   ``trace`` and ``summarize_profile``).
5. Multi-process runs.  In this process, a process group of world size 1
   under NCCL (a ``file://`` store in a temporary directory): the Collect
   episode rollout at B = 8192 under ``sharded_episode_rollout``,
   ``reset(seed=0)`` and 500 steps, counted (20 ``collect_steps_philox``,
   one ``collect_reset``), its metrics and states bit-equal to the unsharded
   rollout reset from the rank's seed, one all-reduce of three float64
   scalars a call (``comm_audit.audit_call``), timed in turns with the
   unsharded call; the Collect training cell under ``make_ppo(...,
   mesh)`` against the plain learner from the same seeds (net seed, env
   states and generator, the action generator): 2 counted iterations
   each, then the parameters within 1e-5 of the plain ones (the largest
   difference over the largest parameter); the audit of a further
   iteration (all-reduces only, none larger than the parameters' bytes, no
   uint8 operand); env-steps/s with and without DDP in turns; the group
   is then destroyed.  Then ``scripts/multihost_dryrun.py`` with two gloo
   ranks both on cuda:0: exit 0, the parameters bit-equal across ranks
   after each train step (no rate: the ranks share the card).
6. The worked example and the root scripts, each run counted.  First the
   kernels of its largest paths against their plain versions at the
   batch those paths give them: ``ctf_step`` at the 1M-env run's 2**20
   rows, with that run's masked CtF reset there card == CPU, and each
   K-step kernel and ``collect_reset`` at the sweeps' 65536.  Pursuit
   (``examples/custom_env.py``): the batch step at B = 8192 on the card
   bit-equal to the CPU for 50 steps from one state and action set, then
   the example's ``main`` (256 envs, a 120-step random rollout, 60 PPO
   iterations; no kernel of the port), finite losses, iterations/s.
   ``train_mvn_ctf_rl`` at its defaults for 3 iterations, then resumed
   for 1 (64 ``ctf_step`` an iteration, the metrics' step axis
   continuing), and its greedy episode through the gymnasium-free per-env
   functions (one ``ctf_step`` a frame, uint8 frames).  ``bench_ppo_scale
   --profile`` at the JAX record's config, 2**20 CtF envs (16 ``ctf_step``
   an iteration), finite losses, moved parameters, env-steps/s, the
   rollout/update split, a profile, and the peak memory beside
   ``reckon_ppo_peak``.  ``measure_train_step`` at its defaults (32
   ``collect_step`` and ``collect_reset`` a step), then ``audit_comm``'s
   audit of the same config at world size 1 under NCCL and the pod model
   on the card's own measurement.  ``soak`` (4 windows) and
   ``sweep_batch`` (B = 1024, 4096, 16384, 65536) on the four families'
   episode paths, each call's K-step launches counted.
7. The bench entry points, each in processes of its own:
   ``scripts/bench.py`` (Collect episode rollout, B = 8192, 500-step
   calls), ``scripts/bench_all.py --all-paths`` (each family's episode
   and step paths, a fresh process a family) and ``bench_all --families
   ctf --partial-obs 7``.  Each must exit 0 and print its lines, each
   with every key, three finite positive windows, the best of them as
   its value, ``vs_baseline`` from the value, the card's name and power
   limit as ``device``, and the launches a call that its path must make
   (a 500-step Collect episode call 20 ``collect_steps_philox``; CtF 8
   ``ctf_steps``, Maze 10 ``maze_steps_philox``,
   Wildfire 17 ``wf_steps_philox``; a step-path call its step kernel once
   a step, and Collect's masked reset once a step).
8. The learner's roofline: ``scripts/profile_ppo.py`` at ``sol_record``'s
   ``bench_scale`` point (8192 CtF envs, rollout 32, 8 minibatches) in
   this process with a trace, counted (32 ``ctf_step`` launches a train
   step over one untimed, four timed and one traced step, no other
   kernel), then ``sol_record --families ctf`` as a process, which must
   exit 0 and write both PPO points (``bench_scale`` and ``record_1m``,
   2**20 envs).  Each record's model and executed FLOPs must equal the
   closed forms computed here from the net's parameters, its share of
   the dense bf16 peak lie in (0, 1], its device be the card's name and
   power limit, its profile be the card's with class shares summing to 1,
   and its binding resource be named.

Prints the timing lines, one JSON line of the render phase's readings,
one JSON line of phase 5's readings, one of phase 6's, one of phase 7's,
one of phase 8's, one JSON line of kernel records (with each kernel's
launches in one evaluation call, in the four 200-step vector env runs, on
phase 6's paths, in a call of each bench line and, for ``ctf_step``, in
phase 8's ``profile_ppo`` run, as counted there, and its max_abs_err at
phase 6's largest batches), the card's name and power limit, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import functools
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py: no CUDA device")

from gym_multigrid_tpu_torch.envs.collect import (  # noqa: E402
    AGENT,
    BALL,
    CollectConfig,
    make_collect,
    make_collect_partial_encode,
)
from gym_multigrid_tpu_torch.envs.ctf import (  # noqa: E402
    CtfConfig,
    CtfState,
    PolicySpec,
    host_red_actions,
    make_ctf,
    make_ctf_partial_encode,
)
from gym_multigrid_tpu_torch.envs.maze import (  # noqa: E402
    BACKGROUND,
    FLAG,
    M_OBSTACLE,
    MazeConfig,
    MazeState,
    make_maze,
    make_maze_partial_encode,
)
from gym_multigrid_tpu_torch.envs.wildfire import (  # noqa: E402
    BURNT,
    FIRE,
    TREE,
    WildfireConfig,
    WildfireState,
    make_wildfire,
    make_wildfire_partial_encode,
)
from gym_multigrid_tpu_torch.ops import (  # noqa: E402
    _build,
    collect_slab,
    ctf_slab,
    maze_slab,
    philox,
    wildfire_slab,
)
from gym_multigrid_tpu_torch.ops.collect_slab import (  # noqa: E402
    AGENT_COUNTS,
    collect_philox_slab,
    collect_reset_slab,
    collect_step_slab,
    make_collect_episode_rollout,
    make_collect_slab,
    move_order,
    reset_batch,
    reset_spec,
    step_batch,
    step_spec,
)
from gym_multigrid_tpu_torch.ops.ctf_slab import (  # noqa: E402
    ctf_ms_slab,
    ctf_step_slab,
    make_ctf_episode_rollout,
)
from gym_multigrid_tpu_torch.ops.maze_slab import (  # noqa: E402
    make_maze_episode_rollout,
    maze_philox_slab,
    maze_step_slab,
)
from gym_multigrid_tpu_torch.ops.wildfire_slab import (  # noqa: E402
    make_wildfire_episode_rollout,
    ms_philox_spec,
    wf_autoreset_slab,
    wf_philox_slab,
    wildfire_step_slab,
)
from gym_multigrid_tpu_torch.parallel.comm_audit import audit_call  # noqa: E402
from gym_multigrid_tpu_torch.parallel.mesh import (  # noqa: E402
    distributed_initialize,
    fold_in_axis,
    make_mesh,
)
from gym_multigrid_tpu_torch.parallel.shard import sharded_episode_rollout  # noqa: E402
from gym_multigrid_tpu_torch.parallel.vector import (  # noqa: E402
    NextStepEnv,
    make_collect_batch,
    make_ctf_batch,
    make_maze_batch,
    make_vector_batch,
    make_wildfire_batch,
    next_step_autoreset,
)
from gym_multigrid_tpu_torch.policy.ctf.heuristic import (  # noqa: E402
    CapturePolicy,
    FightPolicy,
    PatrolFightPolicy,
    PatrolPolicy,
    RwPolicy,
)
from gym_multigrid_tpu_torch.rl.evaluate import evaluate, evaluate_ctf  # noqa: E402
from gym_multigrid_tpu_torch.rl.families import make_family_batch  # noqa: E402
from gym_multigrid_tpu_torch.rl.networks import ActorCritic  # noqa: E402
from gym_multigrid_tpu_torch.rl.ppo import PPOConfig, make_ppo  # noqa: E402
from gym_multigrid_tpu_torch.rl.selfplay import (  # noqa: E402
    make_ctf_selfplay_batch,
    make_league_ppo,
    make_selfplay_ppo,
)
from gym_multigrid_tpu_torch.render import tiles  # noqa: E402
from gym_multigrid_tpu_torch.render.tiles import (  # noqa: E402
    render_collect_batch,
    render_ctf_batch,
    render_maze_batch,
    render_wildfire_batch,
)
from gym_multigrid_tpu_torch.examples import custom_env  # noqa: E402
from gym_multigrid_tpu_torch.scripts import (  # noqa: E402
    audit_comm,
    bench_ppo_scale,
    measure_train_step,
    profile_ppo,
    soak,
    sol_record,
    sweep_batch,
    train_mvn_ctf_rl,
)
from gym_multigrid_tpu_torch.scripts.bench_all import (  # noqa: E402
    BASELINES,
    CHUNKS,
    FAMILIES,
    MS_STEPS,
    align_steps,
    family_cfg,
    kernel_wrappers,
)
from gym_multigrid_tpu_torch.scripts.evaluate import policy_frames  # noqa: E402
from gym_multigrid_tpu_torch.scripts.multihost_dryrun import param_rel_err  # noqa: E402
from gym_multigrid_tpu_torch.utils import profiling  # noqa: E402
from gym_multigrid_tpu_torch.utils.misc import tree_map  # noqa: E402
from gym_multigrid_tpu_torch.wrappers.toroid import toroid_obs_fn  # noqa: E402

B = 8192
# Batches that are no multiple of the Wildfire tile (8, or 4 at 32x32) nor
# of the CtF envs per block (64, or 32 above 4 agents).
RAGGED = (8189, 5)
STEPS_PER_CALL = 500  # ten lockstep 50-step episodes
MAIN = CollectConfig(layout="quadrants_respawn", respawn=True, max_steps=50)
SINGLE = CollectConfig(agents_index=(3,), layout="even", respawn=False)
# Three agents: outside the kernels' one or two, so plain PyTorch on the card.
THREE = CollectConfig(agents_index=(3, 5, 1), layout="quadrants_respawn", respawn=True,
                      max_steps=50)
QUADRANTS15 = CollectConfig(size=15, num_balls=30, layout="quadrants")
# The Collect K-step entry's checks beside MAIN and SINGLE: a fixed-horizon
# board, a 16x16 board (8 bit words of cells an env) and 17 ball types (17
# colors and reward slots); its episode chunk (make_collect_episode_rollout's
# default) and the launch sizes it is checked in: the 25- and 50-step
# launches span an episode's end, the 30-step one ends on it.
FIXED = CollectConfig(layout="even", fixed_horizon=True, max_steps=50)
BOARD16 = CollectConfig(size=16, num_balls=45, layout="quadrants_respawn", respawn=True,
                        max_steps=50)
TYPES17 = CollectConfig(balls_index=tuple(range(17)), balls_reward=(1.0,) * 17, num_balls=17,
                        layout="even", respawn=True, max_steps=50)
COLLECT_CHUNK = 25
COLLECT_MS_CHUNKS = (1, COLLECT_CHUNK, 2 * COLLECT_CHUNK, 30)
# Kernels a 500-step Collect episode call may launch in all, the port's and
# PyTorch's: 20 collect_steps_philox, the pack and unpack, the fills and
# the sum.
COLLECT_CALL_LAUNCHES = 32
# Steps of each check, from COLLECT_MS_LEAD steps before an episode's end.
COLLECT_MS_STEPS, COLLECT_MS_LEAD = 60, 30

# CtF: the config the repo's family bench drives (bench_all.py), 2v2 on
# the 10x10 board, 400 steps per rollout call.
MAP = str(Path(__file__).resolve().parent / "tests" / "assets" / "board.txt")
CTF_STEPS_PER_CALL = 400
CTF_MAIN = CtfConfig.from_map_path(
    MAP, num_blue_agents=2, num_red_agents=2, variant="mvn",
    enemy_policies=(PolicySpec("fight"), PolicySpec("rw")),
    observation_option="flattened",
)
CTF_PATROL = CtfConfig.from_map_path(
    MAP, num_blue_agents=2, num_red_agents=2,
    enemy_policies=(PolicySpec("patrol"), PolicySpec("patrol_fight")),
    obstacle_penalty_ratio=0.5,
)
CTF_1V1 = CtfConfig.from_map_path(
    MAP, variant="1v1", enemy_policies=(PolicySpec("fight"),),
    obstacle_penalty_ratio=0.5,
)
CTF_3V3 = CtfConfig.from_map_path(
    MAP, num_blue_agents=3, num_red_agents=3,
    enemy_policies=(PolicySpec("capture"), PolicySpec("patrol"), PolicySpec("rw")),
)


def non_square_map():
    """board.txt cut to 10 x 7, both flags kept: the swapped bounds check
    (row against S1, column against S0) lets agents step off the board."""
    from gym_multigrid_tpu_torch.utils.map import load_text_map

    fm = load_text_map(MAP).astype(int)[:, :7]
    return tuple(tuple(int(v) for v in row) for row in fm)


CTF_NON_SQUARE = CtfConfig(
    map_data=non_square_map(), num_blue_agents=2, num_red_agents=2,
    enemy_policies=(PolicySpec("patrol_fight"), PolicySpec("fight")),
    obstacle_penalty_ratio=0.5,
)

# Maze and Wildfire: the configs the repo's family bench drives
# (bench_all.py:165-178), 1000 and 400 steps per rollout call
# (bench_all.py:84).
MAZE_MAP = str(Path(__file__).resolve().parent / "tests" / "assets" / "board_maze.txt")
MAZE_STEPS_PER_CALL = 1000
MAZE_MAIN = MazeConfig.from_map_path(MAZE_MAP, max_steps=100)
MAZE_PENALTY = MazeConfig.from_map_path(MAZE_MAP, max_steps=100, obstacle_penalty_ratio=0.5)


def tiled_maze(cfg, reps):
    """``cfg``'s map as reps x reps copies, the flag of the first copy kept
    and the others cleared to background."""
    fm = np.tile(cfg.field_map, (reps, reps))
    first = np.zeros(fm.shape, dtype=bool)
    first[:cfg.field_map.shape[0], :cfg.field_map.shape[1]] = True
    fm[(fm == FLAG) & ~first] = BACKGROUND
    return dataclasses.replace(cfg, map_data=tuple(tuple(int(v) for v in row) for row in fm))


MAZE_LARGE = tiled_maze(MAZE_MAIN, 6)
WF_STEPS_PER_CALL = 400
WF_MAIN = WildfireConfig(size=16, max_steps=100)
WF_FOUR = WildfireConfig(size=10, num_agents=4, agents_index=(1, 2, 4, 5), step_penalty=0.01)
WF_SPREAD = WildfireConfig(size=32, p_spread=1.0, p_burnout=0.0)
# Configs outside a kernel's envelope, which JAX runs as plain XLA: on the
# card their slabs take the plain route.  A board above the Collect
# kernels' 256 cells and the Wildfire kernels' 1024, ten CtF agents (the
# kernels take 2 to 8), and a Maze map whose K-step table does not fit the
# kernel's shared memory (6 x 6 copies of board_maze.txt, one flag).
COLLECT_LARGE = CollectConfig(size=20)
COLLECT_LARGE_RESPAWN = CollectConfig(size=20, layout="quadrants_respawn", respawn=True,
                                      max_steps=50)
WF_LARGE = WildfireConfig(size=40)
CTF_LARGE = CtfConfig.from_map_path(
    str(Path(__file__).resolve().parent / "tests" / "assets" / "board_large.txt"),
    num_blue_agents=5, num_red_agents=5, enemy_policies=(PolicySpec("rw"),) * 5)
# Envs and chained steps of the out-of-envelope checks (the CPU steps them
# too); the Wildfire episode rollout card against CPU at B = 64.
OUT_ROWS = 1024
OUT_STEPS = 30
ROLLOUT_CHECK_ROWS = 64

# H100 SXM peaks (NVIDIA data sheet and Hopper white paper): HBM3 rate (the
# port's one table, utils/profiling.py), and int32 ALU ops on the CUDA cores
# (132 SMs x 64 int32 lanes x 1.98 GHz).
MEM_BYTES_PER_S = profiling.MEM_BYTES_PER_S["h100-sxm"]
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Integer operations each function needs, with its masks bit-packed, one
# bit per cell: a masked pick (a respawn, a ball placement, a uniform agent
# placement) is an AND, a popcount and a running sum per 32-cell word, plus
# a constant to find the chosen bit and write its cell; a move or a placement
# at a given cell is a constant (action to vector, clip, index, the entered
# cell's read and the writes).  Everything else either function does is
# moving bytes, which the byte term counts.
PICK_OPS_PER_WORD = 3
PICK_OPS = 8
MOVE_OPS = 16
# A Collect pickup on the K-step entry: the slot's clamp, its reward's and
# info slot's reads, the reward's add, the counter's range test and
# increment.
PICKUP_OPS = 6
# The CtF step, per env, counting each 32-bit integer or float operation
# it needs: a squared distance is 6 (two subtracts, two converts, two
# multiplies and the add folded into the compare: 7 with it), a red
# policy's random action and gate 4, the closed-form A* step 6, a border
# cell of a patrol scan 9 (the on-border test and the distance), a mover
# 16 plus 2 per agent it checks for occupancy, a flag check 4, a battle 16
# (distance, eligibility, the truth table, the draw, the reward and the
# outcome updates).  The float operations are counted at the int32 rate,
# the lower of the two.
CTF_DIST_OPS = 7
CTF_POLICY_OPS = 4
CTF_ASTAR_OPS = 6
CTF_BORDER_OPS = 9
CTF_BATTLE_OPS = 16
# The Maze step, per env: the action's clip and deltas 4, the bounds 4, a
# cell lookup (clip both coordinates, index, read) 6 and the move's
# selects 4, then two lookups for the flag and the obstacle and 4 for the
# reward: 36.
MAZE_OPS = 36
# The Maze K-step entry, per env and step, with the move tabulated (the
# table is built once per config): the action's clip 2, the entry's index
# and read 2, the direction's decode and selects 3, the reward's read 1,
# the step count and done 4, the three sums and the episode count 5, the
# running return's select 1, and the spawn (multiply, convert, clip, read
# and three selects) 7: 25.
MAZE_MS_OPS = 25
# Steps a Maze episode-path launch runs (bench_all.py's chunk), and the
# kernels a whole 1000-step call may make: its ten maze_steps_philox
# launches, the fill of the sums, the packing of the positions, their
# unpacking and the three sums.
MAZE_CHUNK = 100
MAZE_CALL_LAUNCHES = 16
# Name fragments of PyTorch's random-number kernels, which the Maze episode
# call must not launch (its draws are made in the kernel).
DRAW_KERNELS = ("distribution", "random", "philox_engine")
# The Wildfire step: per cell, the extinguish test (1 compare per agent
# and the fire test), the neighbour count (4 edge tests, 4 bit reads, 3
# adds), the threshold's select 4, the ignite and burnout compares 4, the
# new cell's select 2 and the counts' ballots 3: 25 + A.  Per env, the
# move order's decode 8 and per mover MOVE_OPS plus 2 per agent it checks.
WF_CELL_OPS = 25
# The K-step entries, per env and step on top of the step itself: the step
# count, done, the three sums, the episode count and the running return's
# select, 10.  Per env that finished, the respawn: CtF, per agent a floor
# pick (multiply, convert, clip: 3) and, MvN, a compare and an increment
# per teammate picked before it and a compare and swap to keep them sorted
# (4 per teammate), then the cell's two reads and four writes (6);
# Wildfire, per cell the tree compare, the select and the ballot (3), per
# fire the popcount prefix over the lanes (5 shuffles and adds, 10), the
# pick (3), the word and bit search (16) and the two writes, and per agent
# the CtF MvN pick over the board and the cell's divide (2).
MS_STEP_OPS = 10
CTF_SPAWN_OPS = 9
CTF_SPAWN_PAIR_OPS = 4
WF_FRESH_CELL_OPS = 3
WF_FRESH_FIRE_OPS = 31
# The in-kernel draws of wf_steps_philox: a Philox4x32-10 call is 10 rounds
# of two 32 x 32 -> 64-bit products (a high and a low half each: 4 int32
# operations) and two three-input XORs (one LOP3 each on sm_90: 2), and the
# key's two adds in the 9 rounds after the first (18): 78; each word it
# gives that is read then costs its shift, convert and scale (an action id
# its high product): 3.
PHILOX_CALL_OPS = 78
PHILOX_WORD_OPS = 3
# Steps a CtF and a Wildfire episode-path launch runs (bench_all.py's
# MS_CHUNKS), and the max_steps of their phase-2 configs: every env resets
# at least three times in 100 steps.
CTF_CHUNK = 50
CTF_MS_CHUNKS = (25, CTF_CHUNK)
# Envs of the ctf_steps launch timed for one env's chain of steps.
CHAIN_ROWS = 64
WF_CHUNK = 24
MS_CHECK_MAX_STEPS = 30
# Untimed rollout calls at most before the timed ones: Collect's, Maze's
# and Wildfire's are cut to 10 to keep the whole run near two and a half
# minutes.
COLLECT_WARMUP_MAX = 10
CTF_WARMUP_MAX = 20
MAZE_WARMUP_MAX = 10
WF_WARMUP_MAX = 10
#: The benchmark's per-step batch, at which wf_autoreset is timed too.
AUTORESET_BIG = 65536
# The training paths: the width of the repo's trained model and
# scripts/train.py's PPO settings, two untimed and five timed iterations.
TRAIN_HIDDEN = (256, 256)
TRAIN_CFG = PPOConfig(rollout_len=32, num_epochs=2, num_minibatches=8)
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
# bf16 activations: the card's forward against the CPU's, same params.
FORWARD_ATOL = 3e-2
# Evaluation: 200 lockstep steps a call (four Collect episodes, two CtF
# ones at most), the greedy policy of the full-width net.
EVAL_STEPS = 200
# Self-play: train_selfplay's PPO settings (int8 obs buffer), the same
# width, two untimed and five timed iterations.
SELFPLAY_CFG = PPOConfig(rollout_len=32, num_epochs=2, num_minibatches=8, obs_buffer_dtype="int8")
SELFPLAY_WARMUP, SELFPLAY_TIMED = 2, 5
# Partial observations: the view size of the JAX package's encodes, the
# rows held to the CPU, and the steps of the partial-obs CtF path.
VIEW = 7
PARTIAL_ROWS = 512
PARTIAL_STEPS = 50
# The gymnasium-facing layer: the per-env functions and the host-policy
# path, PER_ENV_STEPS chained steps card against CPU; the NEXT_STEP vector
# step, VEC_STEPS steps a family, at a max_steps of VEC_MAX_STEPS in phase 2
# (every row resets several times) and with make_vector_env's configs in
# phase 3, timed as calls of VEC_STEPS_PER_CALL steps.
PER_ENV_STEPS = 60
# The render phase: T-pixel tiles on states after a reset and RENDER_STEPS
# kernel-stepped steps; RENDER_ROWS rows spread over the batch, the last
# included, held to the CPU, and TOROID_ROWS of the toroidal obs; the gif
# frame path at B = 1 for GIF_STEPS steps.
RENDER_T = 32
RENDER_STEPS = 20
RENDER_ROWS = 64
TOROID_ROWS = 512
GIF_STEPS = 50
VEC_STEPS = 200
VEC_MAX_STEPS = 30
VEC_STEPS_PER_CALL = 50
VEC_WARMUP_MAX = 10
# Five reds, each a subclass of one stock policy class: the adapters act
# them on the host and step with every action given.
HOST_POLICY_CFG = CtfConfig.from_map_path(
    MAP, num_blue_agents=2, num_red_agents=5, enemy_policies=(PolicySpec("rw"),) * 5,
    observation_option="flattened", max_steps=VEC_MAX_STEPS,
)
DEV = torch.device("cuda", 0)


def log(*args):
    print(*args, flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def max_abs_err(got, want):
    """Max |got - want| over paired outputs; raises unless bit-equal."""
    err = 0.0
    for g, w in zip(got, want):
        check(g.dtype == w.dtype and g.shape == w.shape, f"{g.dtype}{tuple(g.shape)} vs {w.dtype}{tuple(w.shape)}")
        err = max(err, (g.double() - w.double()).abs().max().item())
        check(torch.equal(g, w), "kernel differs from its plain version")
    return err


def actions(gen, n_agents, n=B):
    """Moves 0..3 with the invalid ids -1, 4 and 7 mixed in (a fifth)."""
    acts = torch.randint(0, 4, (n, n_agents), generator=gen, device=DEV, dtype=torch.int32)
    bad = torch.rand((n, n_agents), generator=gen, device=DEV) < 0.2
    ids = torch.tensor([-1, 4, 7], dtype=torch.int32, device=DEV)
    pick = torch.randint(0, 3, (n, n_agents), generator=gen, device=DEV)
    return torch.where(bad, ids[pick], acts)


def check_step_kernel(cfg, steps, seed):
    slab = make_collect_slab(cfg, DEV)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    s = reset_batch(slab, B, generator=gen)
    go, gc, gs, pos = s.grid_obj, s.grid_color, s.grid_slot, s.agent_pos.reshape(B, -1)
    err, pickups, drops = 0.0, 0, 0
    for _ in range(steps):
        acts = actions(gen, cfg.num_agents)
        rnd = torch.rand((B, 3), generator=gen, device=DEV)
        args = (slab.t, go, gc, gs, pos, acts, rnd, slab.respawn_rects)
        got = collect_step_slab(*args)
        err = max(err, max_abs_err(got, step_spec(*args)))
        pickups += int((got[4] >= 0).sum())
        if cfg.respawn:  # a respawn on the vacated cell is stomped
            drops += int((go == BALL).sum() - (got[0] == BALL).sum())
        go, gc, gs, pos = got[:4]
    check(pickups > 0, "no pickups")
    check(not cfg.respawn or drops > 0, "no respawn stomps")
    log(f"step kernel == step_spec: size {cfg.size} layout {cfg.layout} agents "
        f"{cfg.num_agents}, {steps} steps at B={B}: {pickups} pickups, "
        f"{drops} stomped respawns, max_abs_err {err}")
    return err


def check_reset_kernel(cfg, seed, n=B):
    slab = make_collect_slab(cfg, DEV)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    rnd = torch.rand((n, slab.reset_draws), generator=gen, device=DEV)
    ra = slab.reset_arrays
    want = reset_spec(slab.rt, ra.wall, ra.ball_rects, rnd)
    err = max_abs_err(collect_reset_slab(slab.rt, rnd, ra), want)
    # Under a done mask: only done rows change, in place.
    done = torch.rand((n,), generator=gen, device=DEV) < 0.3
    old = [torch.randint(-5, 50, w.shape, generator=gen, device=DEV, dtype=torch.int32) for w in want]
    out = [o.clone() for o in old]
    collect_reset_slab(slab.rt, rnd, ra, done=done, out=out)
    err = max(err, max_abs_err(out, [torch.where(done[:, None], w, o) for w, o in zip(want, old)]))
    log(f"reset kernel == reset_spec: size {cfg.size} layout {cfg.layout} at B={n} "
        f"(unmasked and {int(done.sum())}/{n} rows masked), max_abs_err {err}")
    return err


def check_collect_steps_kernel(cfg, name, seed, n=B, steps=COLLECT_MS_STEPS,
                               chunks=COLLECT_MS_CHUNKS):
    """``collect_philox_slab`` (the kernel entry ``collect_steps_philox``)
    against ``ms_philox_spec`` over ``steps`` steps from fresh boards,
    starting COLLECT_MS_LEAD steps before an episode's end, as launches of
    each size in ``chunks``: the packed boards, positions and running
    rewards bit for bit at every multiple of 5 steps the launches reach
    (the plain version runs once, in 5-step chunks) and at the end.  At
    B = 8192 fails unless balls were picked up."""
    slab = make_collect_slab(cfg, DEV)
    check(slab.kernel, f"{name}: not on the kernel route")
    key = philox.key_of(seed)
    step0 = cfg.max_steps - COLLECT_MS_LEAD
    s = reset_batch(slab, n, rnd=philox.collect_first_reset_draws(key, n, slab.reset_draws, DEV))
    start = (collect_slab.pack_planes(s.grid_obj, s.grid_color, s.grid_slot),
             s.agent_pos.reshape(n, -1), torch.zeros((n, cfg.num_agents), device=DEV))
    want, cur = {0: start}, start
    for k0 in range(0, steps, 5):
        cur = collect_slab.ms_philox_spec(slab, min(5, steps - k0), *cur, key, step0 + k0)
        want[min(k0 + 5, steps)] = cur
    err = 0.0
    for chunk in chunks:
        cur, k0 = start, 0
        while k0 < steps:
            K = min(chunk, steps - k0)
            cur = collect_philox_slab(slab, K, *cur, key, step0 + k0)
            k0 += K
            if k0 in want:
                err = max(err, max_abs_err(cur, want[k0]))
    reward = float(want[steps][2].sum())
    if n == B:
        check(reward > 0, f"{name}: no pickups")
    log(f"collect_steps_philox kernel == ms_philox_spec: {name}, {steps} steps from step "
        f"{step0} (an episode's end after step {cfg.max_steps - 1}) at B={n} as launches of "
        f"{', '.join(map(str, chunks))}: reward {reward}, max_abs_err {err}")
    return err


def card_equals_cpu(got, want):
    """max_abs_err of card tensors against their CPU counterparts."""
    return max_abs_err([g.cpu() for g in got], list(want))


def state_fields(states):
    """A batch state's tensors, in field order."""
    return [getattr(states, f.name) for f in dataclasses.fields(states)]


def check_any_agent_route(cfg, steps, seed, n=B, what="three-agent Collect"):
    """The plain route on the card (``reset_rows``, and ``step_perm`` for
    three agents or ``step_spec`` for one or two) against the slab the
    public API builds on the CPU at B = ``n``, given the same uniforms and,
    for three agents, the same move orders (drawn on the CPU, copied to
    the card): states, obs, rewards and flags bit for bit over chained
    steps, finished and a twentieth of other rows reset under the mask.
    No kernel launches; the card's ``move_order`` gives permutations."""
    slab, cpu = make_collect_slab(cfg, DEV), make_collect_slab(cfg, "cpu")
    check(not slab.kernel, f"{what} took the kernel route")
    gen = torch.Generator(device=DEV).manual_seed(seed)
    A = cfg.num_agents
    same, fields = card_equals_cpu, state_fields

    def run():
        rnd = torch.rand((n, slab.reset_draws), generator=gen, device=DEV)
        s, sc = reset_batch(slab, n, rnd=rnd), reset_batch(cpu, n, rnd=rnd.cpu())
        err, resets = same(fields(s), fields(sc)), 0
        for _ in range(steps):
            acts = actions(gen, A)[:n]
            rnd = torch.rand((n, slab.step_draws), generator=gen, device=DEV)
            perm = (None if A in AGENT_COUNTS
                    else move_order(torch.rand((n, A), generator=gen, device=DEV).cpu()))
            got = step_batch(slab, s, acts, rnd=rnd, perm=None if perm is None else perm.to(DEV))
            want = step_batch(cpu, sc, acts.cpu(), rnd=rnd.cpu(), perm=perm)
            err = max(err, same(fields(got[0]) + list(got[1:5]), fields(want[0]) + list(want[1:5])))
            done = got[3] | got[4] | (torch.rand((n,), generator=gen, device=DEV) < 0.05)
            rnd = torch.rand((n, slab.reset_draws), generator=gen, device=DEV)
            s = reset_batch(slab, n, rnd=rnd, done=done, states=got[0])
            sc = reset_batch(cpu, n, rnd=rnd.cpu(), done=done.cpu(), states=want[0])
            err = max(err, same(fields(s), fields(sc)))
            resets += int(done.sum())
        return err, resets

    counts, (err, resets) = run_counted(run)
    check_launches(counts, {}, what)
    order = move_order(torch.rand((n, A), generator=gen, device=DEV))
    check(bool((order.sort(dim=1).values == torch.arange(A, device=DEV)).all()),
          "move_order on the card is no permutation")
    log(f"{what}, plain route on the card == the CPU: {steps} steps at B={n}, {resets} rows "
        f"reset, max_abs_err {err}")
    return err


def state_rows(states, n, device):
    """The first ``n`` rows of a batch state, on ``device``."""
    return type(states)(**{f.name: getattr(states, f.name)[:n].to(device)
                           for f in dataclasses.fields(states)})


def check_partial_encodes(seed):
    """Each family's partial encode (V = 7) on the card at B = 8192 against
    the same function on the CPU for the first PARTIAL_ROWS rows of the
    same states: the batch built with ``partial_obs_view``, reset and 20
    steps of random actions on the card (CtF's with agents defeated).
    Times each encode on the card.  Returns the max abs error."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    cases = (
        ("Collect MAIN", make_collect_batch, MAIN, make_collect_partial_encode, 2),
        ("CTF_MAIN", make_ctf_batch, CTF_MAIN, make_ctf_partial_encode, 4),
        ("MAZE_MAIN", make_maze_batch, MAZE_MAIN, make_maze_partial_encode, 1),
        ("WF_MAIN", make_wildfire_batch, WF_MAIN, make_wildfire_partial_encode, 2),
    )
    err = 0.0
    for name, make_batch, cfg, make_encode, agents in cases:
        env = make_batch(cfg, B, partial_obs_view=VIEW)
        states, obs = env.reset(seed)
        for _ in range(20):
            acts = torch.randint(0, env.num_actions, env.actions_shape, generator=gen,
                                 device=DEV, dtype=torch.int32)
            states, obs, *_ = env.step(states, acts)
        check(obs.dtype == torch.uint8 and tuple(obs.shape) == (B, agents, VIEW, VIEW, 3),
              f"{name}: partial obs {obs.dtype} {tuple(obs.shape)}")
        got = env.encode(env.cfg, states)
        want = make_encode(cfg, VIEW)(state_rows(states, PARTIAL_ROWS, "cpu"))
        err = max(err, max_abs_err([got[:PARTIAL_ROWS].cpu()], [want]))
        enc_ms, enc_all = time_ms(lambda: env.encode(env.cfg, states), 20)
        log(f"partial encode {name}, V={VIEW}: card == CPU on {PARTIAL_ROWS} rows of B={B}; "
            f"{enc_ms * 1e3:.1f} us a call at B={B} {us(enc_all)}")
    return err


def check_step_actions(cfg, name, steps, seed):
    """The CtF all-agent step (``step_actions_batch``, plain PyTorch, no
    kernel) on the card against the CPU at B = 8192, given the same
    actions (ids -1 and 7 mixed in), move orders and battle uniforms:
    states, obs, rewards, flags and info bit for bit over chained steps,
    finished and a twentieth of other rows reset under the mask with the
    same spawn uniforms."""
    slab, cpu = ctf_slab.make_ctf_slab(cfg, DEV), ctf_slab.make_ctf_slab(cfg, "cpu")
    gen = torch.Generator(device=DEV).manual_seed(seed)
    A, n_battles = cfg.num_agents, cfg.num_blue_agents * cfg.num_red_agents
    same, fields = card_equals_cpu, state_fields

    def out(step):
        states, obs, rew, term, trunc, info = step
        obs = [obs[k] for k in sorted(obs)] if isinstance(obs, dict) else [obs]
        return fields(states) + obs + [rew, term, trunc] + [info[k] for k in sorted(info)]

    def run():
        rnd = torch.rand((B, A), generator=gen, device=DEV)
        s, sc = (ctf_slab.reset_batch(slab, B, rnd=rnd),
                 ctf_slab.reset_batch(cpu, B, rnd=rnd.cpu()))
        err, resets = same(fields(s), fields(sc)), 0
        for _ in range(steps):
            acts = torch.randint(-1, 8, (B, A), generator=gen, device=DEV, dtype=torch.int32)
            order = torch.rand((B, A), generator=gen, device=DEV).argsort(dim=1).to(torch.int32)
            bu = torch.rand((B, n_battles), generator=gen, device=DEV)
            got = ctf_slab.step_actions_batch(slab, s, acts, order=order, battle_u=bu)
            want = ctf_slab.step_actions_batch(cpu, sc, acts.cpu(), order=order.cpu(),
                                               battle_u=bu.cpu())
            err = max(err, same(out(got), out(want)))
            done = got[3] | got[4] | (torch.rand((B,), generator=gen, device=DEV) < 0.05)
            rnd = torch.rand((B, A), generator=gen, device=DEV)
            s = ctf_slab.reset_batch(slab, B, rnd=rnd, done=done, states=got[0])
            sc = ctf_slab.reset_batch(cpu, B, rnd=rnd.cpu(), done=done.cpu(), states=want[0])
            err = max(err, same(fields(s), fields(sc)))
            resets += int(done.sum())
        return err, resets

    counts, (err, resets) = run_counted(run)
    check_launches(counts, {}, f"CtF all-agent step, {name}")
    log(f"CtF all-agent step on the card == the CPU, {name}: {steps} steps at B={B}, "
        f"{resets} rows reset, max_abs_err {err}")
    return err


def ctf_step_args(slab, states, blue_actions, rnd):
    """The step's inputs from a batch state, as ``step_batch`` passes them:
    bool terminated/collided and the slab's flag byte per cell."""
    B = states.pos.shape[0]
    return (slab.t, states.pos.reshape(B, -1), states.dir, states.terminated,
            states.collided, blue_actions, rnd, slab.flags, slab.border, slab.pool)


def flat_step(out):
    """A per-env step's (state, obs, reward, terminated, truncated, info)
    as a list of tensors: the state's fields, the obs (a dict by key), the
    scalars, the info by key."""
    state, obs, *scalars, info = out
    obs = [obs[k] for k in sorted(obs)] if isinstance(obs, dict) else [obs]
    info = [info[k] for k in sorted(info)] if isinstance(info, dict) else [info]
    return state_fields(state) + obs + scalars + info


def per_env_draws(name, cfg, gen):
    """(reset_kwargs(), step_args()) of a family's per-env functions: each
    draws its actions and uniforms on the CPU from ``gen``."""
    if name == "Collect":
        slab = make_collect_slab(cfg, "cpu")
        return (lambda: {"rnd": torch.rand(slab.reset_draws, generator=gen)},
                lambda: ((torch.randint(-1, 8, (cfg.num_agents,), generator=gen,
                                        dtype=torch.int32),),
                         {"rnd": torch.rand(slab.step_draws, generator=gen)}))
    if name == "CtF":
        nb, width = cfg.num_blue_agents, ctf_slab.rnd_width(ctf_slab.make_ctf_ktables(cfg))
        return (lambda: {"rnd": torch.rand(cfg.num_agents, generator=gen)},
                lambda: ((torch.randint(-1, 7, (nb,), generator=gen, dtype=torch.int32),),
                         {"rnd": torch.rand(width, generator=gen)}))
    if name == "Maze":
        return (lambda: {"rnd": torch.rand(1, generator=gen)},
                lambda: ((torch.randint(-1, 8, (), generator=gen, dtype=torch.int32),), {}))
    t = wildfire_slab.wf_tables(cfg)
    return (lambda: {"rnd": torch.rand(t.n_cells + t.n_fires + t.n_agents, generator=gen)},
            lambda: ((torch.randint(-1, 7, (t.n_agents,), generator=gen, dtype=torch.int32),),
                     {"rnd": torch.rand(1 + t.n_cells, generator=gen)}))


def on_card(args, kwargs):
    return (tuple(a.to(DEV) for a in args), {k: v.to(DEV) for k, v in kwargs.items()})


def collect_fns(cfg, device):
    """``make_collect``'s (reset_fn, step_fn, encode_fn) by the names the
    other families' per-env functions use."""
    reset_fn, step_fn, encode_fn = make_collect(cfg, device)
    return types.SimpleNamespace(reset_fn=reset_fn, step_fn=step_fn, encode_fn=encode_fn)


def check_per_env_functions(seed):
    """``make_collect``, ``make_ctf``, ``make_maze`` and ``make_wildfire``
    on the card against the same functions on the CPU: PER_ENV_STEPS
    chained steps each on MAIN, CTF_MAIN, MAZE_MAIN and WF_MAIN at a
    max_steps of VEC_MAX_STEPS from one spawn, with the same actions and
    explicit draws (made on the CPU, copied to the card), a finished
    episode restarting both from the same spawn draws: states, obs,
    rewards, flags and infos bit for bit.  The per-env functions take the
    batch functions' route at B = 1: on the card each step launches the
    family's step kernel once (``collect_step``, ``ctf_step``,
    ``maze_step``, ``wildfire_step``) and each Collect reset the reset
    kernel once (MAIN is truncation-only, so it resets every
    VEC_MAX_STEPS steps); on the CPU the plain versions run."""
    cases = [(name, make, dataclasses.replace(cfg, max_steps=VEC_MAX_STEPS))
             for name, make, cfg in (("Collect", collect_fns, MAIN), ("CtF", make_ctf, CTF_MAIN),
                                     ("Maze", make_maze, MAZE_MAIN),
                                     ("Wildfire", make_wildfire, WF_MAIN))]
    want = {k: PER_ENV_STEPS for k in ("collect_step", "ctf_step", "maze_step", "wildfire_step")}
    want["collect_reset"] = 1 + PER_ENV_STEPS // VEC_MAX_STEPS
    err, episodes = run_per_env(cases, PER_ENV_STEPS, seed, want, "per-env functions")
    check(all(n > 0 for n in episodes.values()), f"episodes ended: {episodes}")
    log(f"per-env functions on the card == the CPU: {PER_ENV_STEPS} steps each of MAIN, "
        f"CTF_MAIN, MAZE_MAIN and WF_MAIN, episodes ended {episodes}, max_abs_err {err}")
    return err


def run_per_env(cases, steps, seed, want_launches, what):
    """The per-env functions of each (name, make, cfg) of ``cases`` on the
    card against the same on the CPU over ``steps`` chained steps, counted
    and checked against ``want_launches``: (max_abs_err, episodes ended by
    name)."""
    gen = torch.Generator().manual_seed(seed)

    def run():
        err, episodes = 0.0, {}
        for name, make, cfg in cases:
            card, cpu = make(cfg, DEV), make(cfg, "cpu")
            reset_kw, step_args = per_env_draws(name, cfg, gen)
            episodes[name] = 0
            for step in range(steps + 1):
                if step == 0 or bool(want[3] | want[4]):
                    kw = reset_kw()
                    s_cpu, s_card = cpu.reset_fn(**kw), card.reset_fn(**on_card((), kw)[1])
                    err = max(err, card_equals_cpu(state_fields(s_card), state_fields(s_cpu)))
                    episodes[name] += step > 0
                if step == steps:
                    break
                args, kw = step_args()
                want = cpu.step_fn(s_cpu, *args, **kw)
                got = card.step_fn(s_card, *on_card(args, kw)[0], **on_card(args, kw)[1])
                err = max(err, card_equals_cpu(flat_step(got), flat_step(want)))
                s_cpu, s_card = want[0], got[0]
        return err, episodes

    counts, result = run_counted(run)
    check_launches(counts, want_launches, what)
    return result


def custom_policies(seed):
    """A subclass of each stock policy class, on the board's map, drawing
    from one numpy generator seeded ``seed``."""
    from gym_multigrid_tpu_torch.utils.map import load_text_map

    rng, fm = np.random.default_rng(seed), load_text_map(MAP)
    out = []
    for cls in (RwPolicy, FightPolicy, CapturePolicy, PatrolPolicy, PatrolFightPolicy):
        sub = type(f"Custom{cls.__name__}", (cls,), {})
        out.append(sub(random_generator=rng) if cls is RwPolicy
                   else sub(field_map=fm, random_generator=rng))
    return out


def check_host_policy_path(seed):
    """The adapters' host-policy path on HOST_POLICY_CFG, the card against
    the CPU: each side's five custom policies (equal-seeded generators)
    act on ``host_observation`` of its own state, and ``make_ctf``'s
    ``step_actions_fn`` takes the blue actions and theirs, with the same
    move order and battle uniforms; PER_ENV_STEPS chained steps, the
    reds' actions, states, obs, rewards, flags and infos bit for bit; no
    kernel launches."""
    cfg = HOST_POLICY_CFG
    gen = torch.Generator().manual_seed(seed)
    card, cpu = make_ctf(cfg, DEV), make_ctf(cfg, "cpu")
    pol_card, pol_cpu = custom_policies(seed), custom_policies(seed)
    A, nb, nr = cfg.num_agents, cfg.num_blue_agents, cfg.num_red_agents

    def run():
        err, episodes, moves = 0.0, 0, 0
        for step in range(PER_ENV_STEPS + 1):
            if step == 0 or bool(want[3] | want[4]):
                rnd = torch.rand(A, generator=gen)
                s_cpu, s_card = cpu.reset_fn(rnd=rnd), card.reset_fn(rnd=rnd.to(DEV))
                episodes += step > 0
            if step == PER_ENV_STEPS:
                break
            red_cpu = host_red_actions(cfg, pol_cpu, s_cpu)
            red_card = host_red_actions(cfg, pol_card, s_card)
            check(np.array_equal(red_card, red_cpu), f"host reds {red_card} vs {red_cpu}")
            moves += int((red_cpu != 0).sum())
            acts = torch.cat([torch.randint(0, 5, (nb,), generator=gen, dtype=torch.int32),
                              torch.from_numpy(red_cpu)])
            order = torch.rand(A, generator=gen).argsort().to(torch.int32)
            bu = torch.rand(nb * nr, generator=gen)
            want = cpu.step_actions_fn(s_cpu, acts, order=order, battle_u=bu)
            got = card.step_actions_fn(s_card, acts.to(DEV), order=order.to(DEV),
                                       battle_u=bu.to(DEV))
            err = max(err, card_equals_cpu(flat_step(got), flat_step(want)))
            s_cpu, s_card = want[0], got[0]
        return err, episodes, moves

    counts, (err, episodes, moves) = run_counted(run)
    check_launches(counts, {}, "host-policy path")
    check(moves > 0, "the host reds never moved")
    log(f"host-policy path on the card == the CPU: {PER_ENV_STEPS} steps of 2 blue against "
        f"{[type(p).__name__ for p in pol_card]}, {episodes} episodes ended, {moves} red "
        f"moves, max_abs_err {err}")
    return err


def clone_state(states):
    return type(states)(*(x.clone() for x in state_fields(states)))


def flat_obs(obs):
    return [obs[k] for k in sorted(obs)] if isinstance(obs, dict) else [obs]


def check_next_step(name, make, cfg, seed):
    """``next_step_autoreset`` at B = 8192 on a family's main config at a
    max_steps of VEC_MAX_STEPS, VEC_STEPS steps, against ``BatchedEnv.step``
    of a second env seeded alike and handed the same states each step:
    the rows not masked bit-equal (states, obs, rewards, flags); the
    masked rows (finished on the step before) keep their states and report
    ``encode`` of them with reward 0 and no flag; the input states never
    written.  Launches: the step kernel twice a step (both envs),
    Collect's masked reset twice, and Wildfire's auto-reset kernel once
    (``BatchedEnv.step`` only)."""
    cfg = dataclasses.replace(cfg, max_steps=VEC_MAX_STEPS)
    env, ref = make(cfg, B), make(cfg, B)
    states, _ = env.reset(seed=seed)
    ref.reset(seed=seed)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    mask = torch.zeros((B,), dtype=torch.bool, device=DEV)

    def rows(m, x):
        return m.reshape(m.shape + (1,) * (x.ndim - 1))

    def differ(got, want, m):
        return torch.stack([((g != w) & rows(m, g)).any() for g, w in zip(got, want)]).any()

    def run():
        nonlocal states, mask
        bad = torch.zeros((), dtype=torch.bool, device=DEV)
        masked = torch.zeros((), dtype=torch.int64, device=DEV)
        for _ in range(VEC_STEPS):
            acts = torch.randint(-1, env.num_actions + 1, env.actions_shape, generator=gen,
                                 device=DEV, dtype=torch.int32)
            before = clone_state(states)
            out, obs, rew, term, trunc = next_step_autoreset(env, states, acts, mask)
            r_out, r_obs, r_rew, r_term, r_trunc = ref.step(clone_state(states), acts)
            keep = ~mask
            bad |= differ(state_fields(out) + flat_obs(obs) + [rew, term, trunc],
                          state_fields(r_out) + flat_obs(r_obs) + [r_rew, r_term, r_trunc], keep)
            bad |= differ(state_fields(states), state_fields(before), torch.ones_like(mask))
            bad |= differ(state_fields(out) + flat_obs(obs),
                          state_fields(states) + flat_obs(env.encode(env.cfg, states)), mask)
            bad |= ((rew != 0) & rows(mask, rew)).any() | ((term | trunc) & mask).any()
            masked += mask.sum()
            states, mask = out, term | trunc
        return bool(bad), int(masked)

    counts, (bad, masked) = run_counted(run)
    step_kernel = {"Collect": "collect_step", "CtF": "ctf_step", "Maze": "maze_step",
                   "Wildfire": "wildfire_step"}[name]
    want = {step_kernel: 2 * VEC_STEPS}
    if name == "Collect":
        want["collect_reset"] = 2 * VEC_STEPS
    if name == "Wildfire":  # BatchedEnv.step's auto-reset kernel; NEXT_STEP keeps the glue
        want["wf_autoreset"] = VEC_STEPS
    check_launches(counts, want, f"{name} NEXT_STEP")
    check(not bad, f"{name}: next_step_autoreset differs from BatchedEnv.step or its contract")
    check(masked >= 2 * B, f"{name}: only {masked} masked rows")
    log(f"next_step_autoreset == BatchedEnv.step on the unmasked rows, {name}, {VEC_STEPS} "
        f"steps at B={B}, max_steps {VEC_MAX_STEPS}: {masked} masked rows held with their "
        f"encode, reward 0, no flag")


def check_ctf_step_kernel(cfg, name, steps, seed, n=B, need_events=True):
    """``ctf_step_slab`` against ``step_spec`` (cast to the kernel's bool
    interface by ``step_spec_bool``) over chained steps of ``n`` envs from
    random cells, a tenth of the agents terminated and a tenth collided;
    finished envs are respawned by ``reset_spec`` under the done mask, so
    live episodes keep battling.  Blue ids include the out-of-range -2, -1,
    5 and 6, which both clamp.  ``need_events``: fail unless battles, flag
    captures and (with an MvN obstacle penalty) collisions happened."""
    slab = ctf_slab.make_ctf_slab(cfg, DEV)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    states = ctf_slab.reset_batch(slab, n, generator=gen)
    A, (s0, s1) = cfg.num_agents, cfg.field_map.shape
    states.pos = torch.stack([
        torch.randint(0, s0, (n, A), generator=gen, device=DEV, dtype=torch.int32),
        torch.randint(0, s1, (n, A), generator=gen, device=DEV, dtype=torch.int32),
    ], dim=2)
    states.terminated = torch.rand((n, A), generator=gen, device=DEV) < 0.1
    states.collided = torch.rand((n, A), generator=gen, device=DEV) < 0.1
    err, battles, flags, bumps, episodes = 0.0, 0, 0, 0, 0
    for _ in range(steps):
        ba = torch.randint(-2, 7, (n, cfg.num_blue_agents), generator=gen,
                           device=DEV, dtype=torch.int32)
        rnd = torch.rand((n, slab.step_draws), generator=gen, device=DEV)
        args = ctf_step_args(slab, states, ba, rnd)
        got = ctf_step_slab(*args)
        err = max(err, max_abs_err(got, ctf_slab.step_spec_bool(*args)))
        pos, dirs, term, coll, _, ep_term, rfc, bfc, bbl, brl = got
        battles += int(bbl.sum() + brl.sum())
        flags += int(rfc.sum() + bfc.sum())
        bumps += int((coll & ~args[4]).sum())
        step_count = states.step_count + 1
        done = ep_term[:, 0] | (step_count >= cfg.max_steps)
        episodes += int(done.sum())
        states = CtfState(pos.reshape(states.pos.shape), dirs, term, coll, step_count)
        states = ctf_slab.reset_batch(slab, n, generator=gen, done=done, states=states)
    check(not need_events or battles > 0, f"{name}: no battles")
    check(not need_events or flags > 0, f"{name}: no flag captures")
    check(not need_events or cfg.obstacle_penalty == 0 or cfg.variant != "mvn" or bumps > 0,
          f"{name}: no collisions")
    log(f"ctf_step kernel == step_spec: {name}, {steps} steps at B={n}: "
        f"{battles} battles lost, {flags} flag captures, {bumps} new collisions, "
        f"{episodes} episodes ended, max_abs_err {err}")
    return err


def ctf_step_ops(t, n_border):
    """Operations one batch of CtF steps needs (see CTF_*_OPS)."""
    A, nb = t.n_blue + t.n_red, t.n_blue
    per_env = 0
    for kind, _ in t.policies:
        per_env += CTF_POLICY_OPS
        if kind == "rw":
            continue
        per_env += CTF_ASTAR_OPS
        if kind in ("fight", "patrol_fight"):
            per_env += nb * CTF_DIST_OPS
        if kind in ("patrol", "patrol_fight"):
            per_env += n_border * CTF_BORDER_OPS
    per_env += A * (MOVE_OPS + 2 * A)  # movers, with the move order's pick
    per_env += A * 4  # flag checks
    per_env += (nb * t.n_red if t.mvn else 1) * CTF_BATTLE_OPS
    return B * per_env


def maze_actions(gen):
    """Ids 0..4 with the invalid ids -1, 5 and 9 mixed in (a fifth); they
    clip to stay and up."""
    acts = torch.randint(0, 5, (B, 1), generator=gen, device=DEV, dtype=torch.int32)
    bad = torch.rand((B, 1), generator=gen, device=DEV) < 0.2
    ids = torch.tensor([-1, 5, 9], dtype=torch.int32, device=DEV)
    pick = torch.randint(0, 3, (B, 1), generator=gen, device=DEV)
    return torch.where(bad, ids[pick], acts)


def check_maze_step_kernel(cfg, name, steps, seed):
    """``maze_step_slab`` (the kernel reads the move from the slab's
    ``ms_table``) against ``step_spec`` over chained steps from the batch
    reset; finished envs respawn under the done mask.  Counts the
    steps that end on a flag and on an obstacle."""
    slab = maze_slab.make_maze_slab(cfg, DEV)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    states = maze_slab.reset_batch(slab, B, generator=gen)
    fm = torch.as_tensor(cfg.field_map, device=DEV)
    err, flags, obstacles, episodes = 0.0, 0, 0, 0
    for _ in range(steps):
        args = (slab.t, states.pos, states.dir.reshape(B, 1), maze_actions(gen), slab.cells)
        got = maze_step_slab(*args, slab.ms_table)
        err = max(err, max_abs_err(got, maze_slab.step_spec(*args)))
        pos, dirs, _, term = got
        on = fm[pos[:, 0].long(), pos[:, 1].long()]
        flags += int((on == FLAG).sum())
        obstacles += int((on == M_OBSTACLE).sum())
        step_count = states.step_count + 1
        done = (term[:, 0] == 1) | (step_count >= cfg.max_steps)
        episodes += int(done.sum())
        states = maze_slab.reset_batch(slab, B, generator=gen, done=done,
                                       states=MazeState(pos, dirs[:, 0], step_count))
    check(flags > 0, f"{name}: no flag reached")
    check((obstacles > 0) == (cfg.obstacle_penalty != 0),
          f"{name}: {obstacles} steps on an obstacle with penalty {cfg.obstacle_penalty}")
    log(f"maze_step kernel == step_spec: {name}, {steps} steps at B={B}: {flags} flags "
        f"reached, {obstacles} obstacle cells entered, {episodes} episodes ended, "
        f"max_abs_err {err}")
    return err


def check_steps_kernel(run, spec, state, draws, chunks, what):
    """A K-step kernel entry against its plain version over the steps of
    ``draws`` (each (steps, n, ...)), once as launches of each chunk size in
    ``chunks``, every launch compared: ``run(*state, *draws[k0:k1])`` and
    ``spec(K, *state, *draws[k0:k1])`` return the new state, then the sums,
    the episode counts (n,) last.  Returns (max_abs_err, the episodes each
    env finished in the run of the first chunk size)."""
    steps, n = draws[0].shape[:2]
    err, eps = 0.0, torch.zeros((n,), dtype=torch.int32, device=DEV)
    for chunk in chunks:
        cur = state
        for k0 in range(0, steps, chunk):
            part = [d[k0:k0 + chunk] for d in draws]
            got = run(*cur, *part)
            err = max(err, max_abs_err(got, spec(part[0].shape[0], *cur, *part)))
            cur = got[:len(state)]
            if chunk == chunks[0]:
                eps += got[-1]
    log(f"{what}, {steps} steps at B={n} as launches of "
        f"{' and of '.join(map(str, chunks))}: {int(eps.sum())} episodes ended "
        f"(at least {int(eps.min())} an env), max_abs_err {err}")
    return err, eps


#: The chunkings of the Maze K-step check: whole chunks of the episode
#: path's 25 and 100, and launches that start at odd steps.
MAZE_MS_CHUNKINGS = ((25, 25, 25, 25), (100,), (33, 33, 34))


def check_maze_philox_kernel(cfg, name, seed, n=B, chunkings=MAZE_MS_CHUNKINGS):
    """``maze_philox_slab`` (the kernel entry ``maze_steps_philox``, its
    draws made and its sums kept in the kernel) against ``ms_philox_spec``
    over ``sum(chunking)`` steps with the auto-reset from the first reset
    of a rollout keyed by ``seed``, random running returns and sums, each
    chunking's launches at their running step, every launch compared.
    All chunkings must end in the same state and sums.  Fails unless every
    env finished an episode (``cfg.max_steps`` at most the steps run).
    Returns max_abs_err."""
    slab = maze_slab.make_maze_slab(cfg, DEV)
    check(slab.kernel, f"{name}: not on the kernel route")
    key = philox.key_of(seed)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    start = maze_slab.reset_batch(slab, n, rnd=philox.maze_first_reset_draws(key, n, DEV))
    state0 = (start.pos[:, 0] * cfg.field_map.shape[1] + start.pos[:, 1], start.dir,
              start.step_count, torch.rand((n,), generator=gen, device=DEV) - 0.5,
              torch.rand((n,), generator=gen, device=DEV) * 4 - 2,
              torch.rand((n,), generator=gen, device=DEV) * 4 - 2,
              torch.randint(0, 5, (n,), generator=gen, device=DEV, dtype=torch.int32))
    err, ends = 0.0, []
    for chunking in chunkings:
        state, step = state0, 0
        for K in chunking:
            got = maze_philox_slab(slab, K, *state, key, step)
            err = max(err, max_abs_err(got, maze_slab.ms_philox_spec(slab, K, *state, key, step)))
            state, step = got, step + K
        ends.append(state)
    for end in ends[1:]:
        check(max_abs_err(end, ends[0]) == 0, f"{name}: the chunkings end apart")
    episodes = ends[0][6] - state0[6]
    check(bool((episodes >= 1).all()), f"{name}: an env finished no episode")
    log(f"maze_steps_philox kernel == ms_philox_spec: {name}, {sum(chunkings[0])} steps at "
        f"B={n} as launches of {' / '.join(map(str, chunkings))}: {int(episodes.sum())} "
        f"episodes ended, max_abs_err {err}")
    return err


def check_maze_rollout_card_equals_cpu(seed, n=ROLLOUT_CHECK_ROWS, steps=100, chunk=33):
    """``make_maze_episode_rollout(MAZE_PENALTY, n)`` on the card against
    the same on the CPU, both reset with ``seed``: the counter-based draws
    give the same trajectory, the states, each env's running return and the
    episode count bit for bit after two calls (chunks of 33, the second
    call continuing the step count from an even step, its chunks from odd
    ones), one ``maze_steps_philox`` launch a chunk on the card and no
    other kernel.  The metrics' two float sums over the batch are torch
    reductions, whose order differs between the devices: they agree to
    1e-5 of the summed magnitudes."""
    card = make_maze_episode_rollout(MAZE_PENALTY, n, chunk=chunk)
    cpu = make_maze_episode_rollout(MAZE_PENALTY, n, device="cpu", chunk=chunk)
    exact = ("run_return", "episodes")

    def run():
        (s, _), (sc, _) = card.reset(seed), cpu.reset(seed)
        err, m, mc = card_equals_cpu(state_fields(s), state_fields(sc)), None, None
        for _ in range(2):
            s, m = card(s, steps, run_return=m and m["run_return"])
            sc, mc = cpu(sc, steps, run_return=mc and mc["run_return"])
            err = max(err, card_equals_cpu(state_fields(s) + [m[k] for k in exact],
                                           state_fields(sc) + [mc[k] for k in exact]))
            for k in ("reward_sum", "ep_return_sum"):
                check(abs(float(m[k]) - float(mc[k])) <= 1e-5 * n * steps,
                      f"Maze episode {k}: card {float(m[k])}, CPU {float(mc[k])}")
        return err, int(m["episodes"])

    counts, (err, episodes) = run_counted(run)
    check_launches(counts, {"maze_steps_philox": 2 * -(-steps // chunk)},
                   "Maze episode card against CPU")
    check(episodes > 0, "no episode ended")
    log(f"Maze episode rollout, card == CPU from the same seed: 2 x {steps} steps at B={n} "
        f"(chunks of {chunk}), {episodes} episodes in the second call, max_abs_err {err}")
    return err


def check_ctf_steps_kernel(cfg, name, seed, n=B, steps=100, chunks=CTF_MS_CHUNKS):
    """``ctf_ms_slab`` (the kernel entry ``ctf_steps``) against ``ms_spec``
    over ``steps`` steps with the auto-reset from the batch reset, random
    step counts and running returns.  Blue ids -2..6 (the invalid ones
    clamp).  Fails unless every env finished at least two episodes."""
    slab = ctf_slab.make_ctf_slab(cfg, DEV)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    start = ctf_slab.reset_batch(slab, n, generator=gen)
    sc0 = torch.randint(0, cfg.max_steps, (n,), generator=gen, device=DEV, dtype=torch.int32)
    run0 = torch.rand((n,), generator=gen, device=DEV) - 0.5
    draws = (
        torch.randint(-2, 7, (steps, n, cfg.num_blue_agents), generator=gen, device=DEV,
                      dtype=torch.int32),
        torch.rand((steps, n, slab.step_draws), generator=gen, device=DEV),
        torch.rand((steps, n, slab.reset_draws), generator=gen, device=DEV),
    )
    err, eps = check_steps_kernel(
        lambda *a: ctf_ms_slab(slab, *a),
        lambda K, *a: ctf_slab.ms_spec(slab.t, K, *a, slab.flags, slab.border, slab.pool,
                                       slab.bterr, slab.rterr),
        (start.pos.reshape(n, -1), start.dir, start.terminated, start.collided, sc0, run0),
        draws, chunks, f"ctf_steps kernel == ms_spec: {name}")
    check(bool((eps >= 2).all()), f"{name}: an env finished fewer than two episodes")
    return err


def check_wf_philox_kernel(cfg, name, seed, n=B, steps=100, chunks=(WF_CHUNK, 8)):
    """``wf_philox_slab`` (the kernel entry ``wf_steps_philox``, its draws
    made in the kernel) against ``ms_philox_spec`` over ``steps`` steps
    with the auto-reset from the first reset of a rollout keyed by
    ``seed``, random step counts, extinguished counts and running returns;
    the chunks start at their running step, as the rollout's do.  Fails
    unless every env finished at least two episodes."""
    slab = wildfire_slab.make_wildfire_slab(cfg, DEV)
    check(slab.kernel, f"{name}: not on the kernel route")
    t, key = slab.t, philox.key_of(seed)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    start = wildfire_slab.reset_batch(slab, n, rnd=philox.first_reset_draws(
        key, n, t.n_cells, wildfire_slab.fresh_picks(t), DEV))
    sc0 = torch.randint(0, cfg.max_steps, (n,), generator=gen, device=DEV, dtype=torch.int32)
    ext0 = torch.randint(0, 5, (n,), generator=gen, device=DEV, dtype=torch.int32)
    run0 = torch.rand((n,), generator=gen, device=DEV) - 0.5
    # The global step of each step, laid out as (steps, n) draws so that a
    # chunk's slice starts at its first step.
    step_ids = torch.arange(steps, dtype=torch.int32).view(steps, 1).expand(steps, n)
    err, eps = check_steps_kernel(
        lambda *a: wf_philox_slab(slab, *a[:5], key, int(a[5][0, 0]), a[5].shape[0]),
        lambda K, *a: ms_philox_spec(t, K, *a[:5], key, int(a[5][0, 0])),
        (start.cells.reshape(n, -1), start.agent_pos.reshape(n, -1), sc0, ext0, run0),
        (step_ids,), chunks, f"wf_steps_philox kernel == ms_philox_spec: {name}")
    check(bool((eps >= 2).all()), f"{name}: an env finished fewer than two episodes")
    return err


def check_wildfire_rollout_card_equals_cpu(seed, n=ROLLOUT_CHECK_ROWS, steps=100):
    """``make_wildfire_episode_rollout(WF_MAIN, n)`` on the card against
    the same on the CPU, both reset with ``seed``: the counter-based draws
    give the same trajectory, the states, each env's running return and the
    episode count bit for bit after two calls (chunks of 24, the second
    call continuing the step count), one ``wf_steps_philox`` launch a chunk
    on the card and no other kernel.  The metrics' two float sums over the
    batch are torch reductions, whose order differs between the devices:
    they agree to 1e-5 of the summed magnitudes."""
    card = make_wildfire_episode_rollout(WF_MAIN, n, chunk=WF_CHUNK)
    cpu = make_wildfire_episode_rollout(WF_MAIN, n, device="cpu", chunk=WF_CHUNK)
    exact = ("run_return", "episodes")

    def run():
        (s, _), (sc, _) = card.reset(seed), cpu.reset(seed)
        err, m, mc = card_equals_cpu(state_fields(s), state_fields(sc)), None, None
        for _ in range(2):
            s, m = card(s, steps, run_return=m and m["run_return"])
            sc, mc = cpu(sc, steps, run_return=mc and mc["run_return"])
            err = max(err, card_equals_cpu(state_fields(s) + [m[k] for k in exact],
                                           state_fields(sc) + [mc[k] for k in exact]))
            for k in ("reward_sum", "ep_return_sum"):
                check(abs(float(m[k]) - float(mc[k])) <= 1e-5 * n * steps,
                      f"Wildfire episode {k}: card {float(m[k])}, CPU {float(mc[k])}")
        return err, int(m["episodes"])

    counts, (err, episodes) = run_counted(run)
    check_launches(counts, {"wf_steps_philox": 2 * -(-steps // WF_CHUNK)},
                   "Wildfire episode card against CPU")
    check(episodes > 0, "no episode ended")
    log(f"Wildfire episode rollout, card == CPU from the same seed: 2 x {steps} steps at B={n}, "
        f"{episodes} episodes in the second call, max_abs_err {err}")
    return err


def check_collect_rollout_card_equals_cpu(seed, n=ROLLOUT_CHECK_ROWS, steps=100):
    """``make_collect_episode_rollout(MAIN, n)`` on the card against the
    same on the CPU, both reset with ``seed``: the counter-based draws give
    the same trajectory, the states bit for bit after two calls (the
    second continuing the step count) and the metrics equal (every
    reward a whole number, so the two devices' sums are exact); one
    ``collect_steps_philox`` launch a chunk on the card and the reset's
    ``collect_reset``, no other kernel."""
    card = make_collect_episode_rollout(MAIN, n, chunk=COLLECT_CHUNK)
    cpu = make_collect_episode_rollout(MAIN, n, device="cpu", chunk=COLLECT_CHUNK)

    def run():
        (s, _), (sc, _) = card.reset(seed), cpu.reset(seed)
        err = card_equals_cpu(state_fields(s), state_fields(sc))
        for _ in range(2):
            (s, m), (sc, mc) = card(s, steps), cpu(sc, steps)
            err = max(err, card_equals_cpu(state_fields(s) + list(m.values()),
                                           state_fields(sc) + list(mc.values())))
        return err, float(m["reward_sum"])

    counts, (err, reward) = run_counted(run)
    check_launches(counts, {"collect_steps_philox": 2 * -(-steps // COLLECT_CHUNK),
                            "collect_reset": 1}, "Collect episode card against CPU")
    check(reward > 0, "no Collect episode reward")
    log(f"Collect episode rollout, card == CPU from the same seed: 2 x {steps} steps at B={n}, "
        f"reward {reward} in the second call, max_abs_err {err}")
    return err


def check_plain_route(name, make_batch, cfg, seed, n=OUT_ROWS, steps=OUT_STEPS):
    """``make_batch(cfg, n)`` of a config outside the kernels' envelope on
    the card: its slab takes the plain route, and it equals the same batch
    on the CPU given the same draws (made on the card, copied to the CPU):
    states, obs, rewards, flags and infos bit for bit over chained steps
    with masked resets, launching no kernel."""
    card, cpu = make_batch(cfg, n), make_batch(cfg, n, device="cpu")
    check(not card.slab.kernel, f"{name}: the kernel route")
    gen = torch.Generator(device=DEV).manual_seed(seed)

    def run():
        rnd = torch.rand((n, card.slab.reset_draws), generator=gen, device=DEV)
        s, sc = card.reset_batch(card.slab, n, rnd=rnd), cpu.reset_batch(cpu.slab, n, rnd=rnd.cpu())
        err, resets = card_equals_cpu(state_fields(s), state_fields(sc)), 0
        for _ in range(steps):
            acts = torch.randint(0, card.num_actions, card.actions_shape, generator=gen, device=DEV,
                                 dtype=torch.int32)
            rnd = torch.rand((n, card.slab.step_draws), generator=gen, device=DEV)
            got = card.step_batch(card.slab, s, acts, rnd=rnd, with_info=True)
            want = cpu.step_batch(cpu.slab, sc, acts.cpu(), rnd=rnd.cpu(), with_info=True)
            err = max(err, card_equals_cpu(flat_step(got), flat_step(want)))
            done = got[3] | got[4]
            rnd = torch.rand((n, card.slab.reset_draws), generator=gen, device=DEV)
            s = card.reset_batch(card.slab, n, rnd=rnd, done=done, states=got[0])
            sc = cpu.reset_batch(cpu.slab, n, rnd=rnd.cpu(), done=done.cpu(), states=want[0])
            err = max(err, card_equals_cpu(state_fields(s), state_fields(sc)))
            resets += int(done.sum())
        return err, resets

    counts, (err, resets) = run_counted(run)
    check_launches(counts, {}, f"{name}, outside the kernels' envelope")
    log(f"{name} outside the kernels' envelope, plain route on the card == the CPU: {steps} "
        f"steps at B={n}, {resets} rows reset, max_abs_err {err}")
    return err


def check_out_of_envelope(seed):
    """The configs no kernel takes, each on the card's plain route with no
    kernel launched, against the CPU as the public API builds it there:
    Collect above 256 cells (``step_spec`` and ``reset_rows``), ten CtF
    agents and a Wildfire board above 1024 cells (their batch envs), the
    Wildfire one's episode rollout from the same seed, the per-env
    functions of all three, and the episode rollout of a Maze map whose
    K-step table does not fit (``ms_philox_spec`` on the card) against the
    CPU's from the same seed; then the Collect and Wildfire episode
    rollouts driven on the card.  Returns the largest max_abs_err."""
    err = max(
        check_any_agent_route(COLLECT_LARGE, OUT_STEPS, seed, n=OUT_ROWS,
                              what="Collect above 256 cells"),
        # At a max_steps of 10, so that rows finish and reset in the run.
        check_plain_route("CtF, 5 v 5", make_ctf_batch,
                          dataclasses.replace(CTF_LARGE, max_steps=10), seed + 1),
        check_plain_route("Wildfire 40x40", make_wildfire_batch,
                          dataclasses.replace(WF_LARGE, max_steps=10), seed + 2),
    )
    per_env_err, _ = run_per_env(
        (("Collect", collect_fns, COLLECT_LARGE), ("CtF", make_ctf, CTF_LARGE),
         ("Wildfire", make_wildfire, WF_LARGE)), OUT_STEPS,
        seed + 3, {}, "per-env functions outside the kernels' envelope")
    err = max(err, per_env_err)

    card = make_wildfire_episode_rollout(WF_LARGE, OUT_ROWS, chunk=WF_CHUNK)
    cpu = make_wildfire_episode_rollout(WF_LARGE, OUT_ROWS, device="cpu", chunk=WF_CHUNK)
    check(not card.slab.kernel, "Wildfire 40x40 episode rollout on the kernel route")

    def wildfire_episode():
        (s, _), (sc, _) = card.reset(seed), cpu.reset(seed)
        (s, m), (sc, mc) = card(s, 2 * WF_CHUNK), cpu(sc, 2 * WF_CHUNK)
        return card_equals_cpu(state_fields(s) + [m["run_return"], m["episodes"]],
                               state_fields(sc) + [mc["run_return"], mc["episodes"]])

    counts, wf_err = run_counted(wildfire_episode)
    check_launches(counts, {}, "Wildfire 40x40 episode rollout")
    err = max(err, wf_err)

    card = make_maze_episode_rollout(MAZE_LARGE, OUT_ROWS, chunk=MAZE_CHUNK)
    cpu = make_maze_episode_rollout(MAZE_LARGE, OUT_ROWS, device="cpu", chunk=MAZE_CHUNK)
    check(not card.slab.kernel, "the large Maze map on the kernel route")

    def maze_episode():
        (s, _), (sc, _) = card.reset(seed + 4), cpu.reset(seed + 4)
        (s, m), (sc, mc) = card(s, 2 * MAZE_CHUNK), cpu(sc, 2 * MAZE_CHUNK)
        check(int(m["episodes"]) > 0, "no Maze episode ended")
        return card_equals_cpu(state_fields(s) + [m["run_return"], m["episodes"]],
                               state_fields(sc) + [mc["run_return"], mc["episodes"]])

    counts, maze_err = run_counted(maze_episode)
    check_launches(counts, {}, "the large Maze map's episode path")
    err = max(err, maze_err)

    def drive():
        roll = make_collect_episode_rollout(COLLECT_LARGE_RESPAWN, OUT_ROWS)
        check(not roll.slab.kernel, "Collect 20x20 episode rollout on the kernel route")
        states, m = roll(roll.reset(seed)[0], 2 * COLLECT_LARGE_RESPAWN.max_steps)
        check(bool(((states.grid_obj == BALL).sum(1) == COLLECT_LARGE_RESPAWN.num_balls).all()),
              "balls on the Collect 20x20 boards")
        check(float(m["reward_sum"]) > 0, "no Collect 20x20 reward")
        roll = make_wildfire_episode_rollout(WF_LARGE, OUT_ROWS, chunk=WF_CHUNK)
        states, m = roll(roll.reset(seed)[0], 4 * WF_CHUNK)
        check(int(m["episodes"]) > 0, "no Wildfire 40x40 episode ended")

    counts, _ = run_counted(drive)
    check_launches(counts, {}, "the episode rollouts outside the envelope")
    log(f"outside the kernels' envelope: every route plain on the card, no launch, "
        f"max_abs_err {err}")
    return err


def wildfire_args(slab, states, acts, rnd):
    """The step's inputs from a batch state, as ``step_batch`` passes them."""
    B = states.cells.shape[0]
    return (slab.t, states.cells.reshape(B, -1), states.agent_pos.reshape(B, -1), acts, rnd)


def check_wildfire_step_kernel(cfg, name, steps, seed, n=B, need_events=True):
    """``wildfire_step_slab`` against ``step_spec`` over chained steps of
    ``n`` envs from the batch reset, action ids -2..7 (the invalid ones
    clip); finished envs get fresh boards under the done mask.
    ``need_events``: fail unless fires were put out and trees ignited."""
    slab = wildfire_slab.make_wildfire_slab(cfg, DEV)
    t = slab.t
    gen = torch.Generator(device=DEV).manual_seed(seed)
    states = wildfire_slab.reset_batch(slab, n, generator=gen)
    err, put_out, ignited, episodes = 0.0, 0, 0, 0
    for _ in range(steps):
        acts = torch.randint(-2, 8, (n, t.n_agents), generator=gen, device=DEV, dtype=torch.int32)
        rnd = torch.rand((n, slab.step_draws), generator=gen, device=DEV)
        args = wildfire_args(slab, states, acts, rnd)
        got = wildfire_step_slab(*args)
        err = max(err, max_abs_err(got, wildfire_slab.step_spec(*args)))
        cells, pos, _, n_ext, term = got
        put_out += int(n_ext.sum())
        ignited += int(((args[1] == TREE) & (cells == FIRE)).sum())
        step_count = states.step_count + 1
        done = (term[:, 0] == 1) | (step_count >= t.max_steps)
        episodes += int(done.sum())
        new = WildfireState(cells.reshape(states.cells.shape), pos.reshape(states.agent_pos.shape),
                            step_count, states.extinguished + n_ext[:, 0])
        states = wildfire_slab.reset_batch(slab, n, generator=gen, done=done, states=new)
    check(not need_events or (put_out > 0 and ignited > 0),
          f"{name}: {put_out} fires put out, {ignited} ignitions")
    log(f"wildfire_step kernel == step_spec: {name}, {steps} steps at B={n}: {put_out} fires "
        f"put out, {ignited} trees ignited, {episodes} episodes ended, max_abs_err {err}")
    return err


def autoreset_inputs(slab, states, gen):
    """``wf_autoreset_slab``'s arguments after one step of ``states``:
    the step kernel's outputs (fresh tensors, which the kernel writes in
    place), the counts before it and a reset draw."""
    n = states.cells.shape[0]
    acts = torch.randint(-1, 7, (n, slab.t.n_agents), generator=gen, device=DEV,
                         dtype=torch.int32)
    rnd = torch.rand((n, slab.step_draws), generator=gen, device=DEV)
    rnd_reset = torch.rand((n, slab.reset_draws), generator=gen, device=DEV)
    step = wildfire_step_slab(*wildfire_args(slab, states, acts, rnd))
    return (*step, states.step_count, states.extinguished, rnd_reset)


def check_wf_autoreset_kernel(cfg, name, seed, n=B, steps=30):
    """``wf_autoreset_slab`` (the kernel) against ``autoreset_spec`` over
    ``steps`` chained steps of ``n`` envs from the batch reset with step
    counts spread over the episode and every seventh board without fire,
    with and without the obs; some step must finish some rows and not
    all."""
    slab = wildfire_slab.make_wildfire_slab(cfg, DEV)
    t = slab.t
    gen = torch.Generator(device=DEV).manual_seed(seed)
    states = wildfire_slab.reset_batch(slab, n, generator=gen)
    rows = torch.arange(n, device=DEV)
    states = WildfireState(
        torch.where((rows % 7 == 0)[:, None, None] & (states.cells == FIRE), TREE, states.cells),
        states.agent_pos,
        torch.randint(0, t.max_steps, (n,), generator=gen, device=DEV, dtype=torch.int32),
        states.extinguished)
    err, finished, partial = 0.0, 0, 0
    for _ in range(steps):
        args = autoreset_inputs(slab, states, gen)
        want = wildfire_slab.autoreset_spec(slab, *args)
        for encode_obs in (True, False):
            got = wf_autoreset_slab(slab, *(x.clone() for x in args), encode_obs=encode_obs)
            check((got[4] is None) != encode_obs, f"{name}: obs with encode_obs={encode_obs}")
            err = max(err, max_abs_err([g for g in got if g is not None],
                                       [w for w, g in zip(want, got) if g is not None]))
        done = int((want[6] | want[7]).sum())
        finished += done
        partial += 0 < done < n
        cells, pos, sc, ext = want[:4]
        states = WildfireState(cells.reshape(states.cells.shape),
                               pos.reshape(states.agent_pos.shape), sc, ext)
    check(partial > 0, f"{name}: {finished} rows finished, {partial} of {steps} steps with "
                       f"some rows finished and some not")
    log(f"wf_autoreset kernel == autoreset_spec: {name}, {steps} steps at B={n}, with and "
        f"without the obs: {finished} rows finished, max_abs_err {err}")
    return err


def time_autoreset(slab, states, gen):
    """``wf_autoreset_slab`` after a step of ``states`` (the step's outputs
    taken once: each launch finds the same rows finished and writes the
    same fresh boards), logged: (ms, ``autoreset_spec``'s ms, bound ms,
    what bounds it).  Bytes: the inputs but the reset draw, the finished
    rows' reset uniforms, the outputs and the finished rows' fresh boards;
    operations: the fresh boards' (``wf_steps_philox``'s count of
    them)."""
    t = slab.t
    C, A = t.n_cells, t.n_agents
    args = autoreset_inputs(slab, states, gen)
    ms, ms_all = time_ms(lambda: wf_autoreset_slab(slab, *args), 200)
    plain_ms, plain_all = time_ms(lambda: wildfire_slab.autoreset_spec(slab, *args), 20)
    out = wf_autoreset_slab(slab, *args)
    done = int((out[6] | out[7]).sum())
    nbytes = sum(x.numel() * x.element_size() for x in args[:-1]) + sum(
        x.numel() * x.element_size() for x in out[2:]) + done * 4 * (
        slab.reset_draws + C + 2 * A)
    ops = done * (C * WF_FRESH_CELL_OPS + t.n_fires * WF_FRESH_FIRE_OPS
                  + A * (CTF_SPAWN_OPS + 2 + CTF_SPAWN_PAIR_OPS * (A - 1)))
    bound_ms, by, *parts = bound(nbytes, ops)
    log(f"wf_autoreset at B={states.cells.shape[0]}: {ms * 1e3:.2f} us/launch (median of "
        f"windows {us(ms_all)}), bound {bound_ms * 1e3:.2f} us ({by}; {nbytes} bytes with {done} "
        f"finished rows take {parts[0] * 1e3:.2f} us, {ops} operations {parts[1] * 1e3:.2f} "
        f"us), autoreset_spec {plain_ms * 1e3:.1f} us {us(plain_all)}")
    return ms, plain_ms, bound_ms, by


def check_wildfire_stacked(seed):
    """One call on random boards of every cell type with, in every other
    env, both agents on one cell: a stacked pair puts out one fire."""
    slab = wildfire_slab.make_wildfire_slab(WF_MAIN, DEV)
    t = slab.t
    gen = torch.Generator(device=DEV).manual_seed(seed)
    cells = torch.randint(0, 4, (B, t.n_cells), generator=gen, device=DEV, dtype=torch.int32)
    pos = torch.randint(0, WF_MAIN.size, (B, 2 * t.n_agents), generator=gen, device=DEV,
                        dtype=torch.int32)
    pos[::2, 2:] = pos[::2, :2].repeat(1, t.n_agents - 1)
    acts = torch.randint(0, 5, (B, t.n_agents), generator=gen, device=DEV, dtype=torch.int32)
    rnd = torch.rand((B, slab.step_draws), generator=gen, device=DEV)
    args = (t, cells, pos, acts, rnd)
    err = max_abs_err(wildfire_step_slab(*args), wildfire_slab.step_spec(*args))
    log(f"wildfire_step kernel == step_spec: random boards, stacked agents in every other env, "
        f"B={B}: max_abs_err {err}")
    return err


def check_misaligned_refused():
    """No fallback on the card: the Wildfire kernel refuses uniforms off a
    16-byte boundary (its bulk copies' rule) rather than copy them."""
    n = 64
    slab = wildfire_slab.make_wildfire_slab(WF_MAIN, DEV)
    states = wildfire_slab.reset_batch(slab, n, generator=torch.Generator(device=DEV).manual_seed(0))
    acts = torch.zeros((n, slab.t.n_agents), dtype=torch.int32, device=DEV)
    rnd = torch.rand(n * slab.step_draws + 1, device=DEV)[1:].view(n, slab.step_draws)
    try:
        wildfire_step_slab(*wildfire_args(slab, states, acts, rnd))
    except ValueError as e:
        check("aligned" in str(e), f"misaligned Wildfire uniforms: {e}")
        log("misaligned Wildfire uniforms: refused")
        return
    raise AssertionError("misaligned Wildfire uniforms were taken")


def philox_draws_needed(t, state, key, step0, K):
    """(Philox calls, words read) that ``K`` steps of ``wf_steps_philox``
    from ``state`` at global step ``step0`` need on these inputs, by
    ``ops/philox.py``'s layout, replayed step by step with the plain
    version: per env and step the actions' call (A words) and the move
    order's (1); the cell uniforms of each lane's 4-cell group holding a
    fire or a tree with a burning neighbour after the moves and the
    extinguish (a word a cell that is one); on a reset, the tree
    uniforms (a word a cell, a call a lane's group) and the picks (a word
    each, four to a call)."""
    cells, pos, sc, ext, run = state
    n, C, A = cells.shape[0], t.n_cells, t.n_agents
    picks = wildfire_slab.fresh_picks(t)
    groups = -(-C // 128)
    tree_calls = sum(min(32, C - 128 * q) for q in range(groups))
    calls = words = 0
    for k in range(K):
        acts, rnd_step, rnd_reset = philox.episode_draws(
            key, torch.tensor([step0 + k], device=DEV), n, A, C, picks, DEV)
        xs, ys = wildfire_slab.move_agents(t, pos, acts[0], rnd_step[0][:, :1])
        under = torch.zeros((n, C), dtype=torch.bool, device=DEV)
        under.scatter_(1, (ys * t.width + xs).long(), True)
        board = torch.where(under & (cells == FIRE), BURNT, cells)
        cand = (board == FIRE) | ((board == TREE) & (wildfire_slab.neighbor_fires(t, board) > 0))
        cand = torch.nn.functional.pad(cand, (0, 128 * groups - C)).view(n, groups, 4, 32)
        calls += 2 * n + int(cand.any(dim=2).sum())
        words += n * (A + 1) + int(cand.sum())
        cells, pos, sc, ext, run, _, _, eps = wildfire_slab.ms_spec(
            t, 1, cells, pos, sc, ext, run, acts, rnd_step, rnd_reset)
        done = int(eps.sum())
        calls += done * (tree_calls + -(-picks // 4))
        words += done * (C + picks)
    return calls, words


def time_ms(fn, iters, windows=5):
    """ms per call over ``windows`` windows of ``iters`` calls: CUDA events
    around each window, queued behind a device sleep so that host launch
    cost hides when the device is the slower side, one synchronise per
    window.  The sleep, 2e8 cycles (about 100 ms at 1.98 GHz), outlasts
    the enqueue of 200 launches at up to 500 us of host time each.
    Returns the median window and all of them."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(200_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return sorted(per_call)[windows // 2], per_call


def gpu_clocks():
    """The card's SM and memory clocks, performance state, temperature and
    power draw, as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,pstate,temperature.gpu,power.draw",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def us(times):
    return "[" + ", ".join(f"{t * 1e3:.2f}" for t in times) + "]"


def pick_ops(n_picks, n_cells):
    """Operations of ``n_picks`` masked picks over boards of ``n_cells``."""
    return n_picks * (-(-n_cells // 32) * PICK_OPS_PER_WORD + PICK_OPS)


def bound(nbytes, ops):
    """(bound ms, what bounds it, the bytes' ms, the operations' ms)."""
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, t_bytes, t_ops


#: Each kernel's wrapper, whose ``launches`` counts its launches.
WRAPPERS = kernel_wrappers()


def run_counted(drive):
    """Set every kernel's launch count to 0, run ``drive``, synchronise,
    and return (the counts it left, what it returned)."""
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0
    result = drive()
    torch.cuda.synchronize()
    counts = {name: wrapper.launches for name, wrapper in WRAPPERS.items()}
    log(f"launches on this path: {counts}")
    return counts, result


def check_launches(counts, want, path):
    """Each kernel launched ``want[name]`` times on this path, and every
    kernel not in ``want`` never."""
    for name, n in counts.items():
        check(n == want.get(name, 0),
              f"{path} path: {name} launched {n} times, expected {want.get(name, 0)}")


def collect_main_path():
    """The Collect main path: reset(seed=0) and one 500-step rollout at
    B = 8192.  Returns (env, states, obs, metrics)."""
    env = make_collect_batch(MAIN, B)
    states, obs = env.reset(seed=0)
    states, metrics = env.rollout(states, STEPS_PER_CALL)
    return env, states, obs, metrics


def check_collect_path(env, states, obs, metrics):
    """The Collect rollout's invariants, then 25 more steps' board
    invariants.  Returns the states."""
    check(obs.shape == (B, 10, 10, 3) and obs.dtype == torch.uint8, "obs shape")
    episodes = int(metrics["episodes"])
    reward_sum = float(metrics["reward_sum"])
    ep_return_sum = float(metrics["ep_return_sum"])
    check(episodes == B * STEPS_PER_CALL // MAIN.max_steps, f"episodes {episodes}")
    check(reward_sum > 0, "no reward")
    # Rewards are integers summed below 2**24: float32 sums are exact.
    check(ep_return_sum == reward_sum, f"{ep_return_sum} != {reward_sum}")
    check(bool((metrics["run_return"] == 0).all()), "run_return after lockstep truncation")
    check(bool((states.step_count == 0).all()), "states not reset at the episode boundary")
    log(f"rollout: {episodes} episodes, reward_sum {reward_sum}, "
        f"reward per agent-step {reward_sum / (B * STEPS_PER_CALL * 2)}")
    for _ in range(25):  # mid-episode board invariants
        states, *_ = env.step(states, torch.randint(0, 4, (B, 2), device=DEV, dtype=torch.int32))
    balls = (states.grid_obj == BALL).sum(1)
    check(bool((balls <= MAIN.num_balls).all()), "more balls than placed")
    check(bool((balls >= MAIN.num_balls - states.collected).all()), "balls lost beyond pickups")
    check(bool(((states.grid_obj == AGENT).sum(1) == 2).all()), "agents per board")
    return states


def distinct_cells(pos):
    """True where no two agents of an env share a cell; pos (B, A, 2)."""
    p = pos[:, :, 0] * 1024 + pos[:, :, 1]
    return ~(p[:, :, None] == p[:, None, :]).triu(diagonal=1).any(dim=(1, 2))


def ctf_main_path():
    """The CtF path: CTF_MAIN at B = 8192, reset(seed=0) and one 400-step
    rollout.  Returns (env, first states, obs, final states, metrics)."""
    env = make_ctf_batch(CTF_MAIN, B)
    first, obs = env.reset(seed=0)
    states, metrics = env.rollout(first, CTF_STEPS_PER_CALL)
    return env, first, obs, states, metrics


def check_ctf_path(env, first, obs, states, metrics):
    """The CtF path's invariants: a second reset(seed=0) gives the same
    state, spawns lie in their team's territory and never overlap, the obs
    has its shape, and after the rollout the metrics agree, no two agents
    share a cell and every agent is on the board."""
    again, _ = env.reset(seed=0)
    states0 = first
    check(all(torch.equal(getattr(states0, f), getattr(again, f))
              for f in ("pos", "dir", "terminated", "collided", "step_count")),
          "reset(seed=0) twice differs")
    nb = CTF_MAIN.num_blue_agents
    terr = [env.slab.bterr, env.slab.rterr]
    for a in range(CTF_MAIN.num_agents):  # spawns in their own territory
        t = terr[a >= nb]
        inside = ((states0.pos[:, a, :1] == t[0]) & (states0.pos[:, a, 1:] == t[1])).any(dim=1)
        check(bool(inside.all()), f"agent {a} spawned outside its territory")
    check(bool(distinct_cells(states0.pos).all()), "spawns overlap")
    # flattened: positions, flags, the three cell lists, terminated flags
    A = CTF_MAIN.num_agents
    cells = env.slab.bterr.shape[1] + env.slab.rterr.shape[1] + int((env.slab.cells[3] > 0).sum())
    check(obs.dtype == torch.int32 and tuple(obs.shape) == (B, 2 * A + 4 + 2 * cells + A),
          f"obs {obs.dtype} {tuple(obs.shape)}")
    check_episode_metrics(metrics, CTF_STEPS_PER_CALL, "ctf")
    check(bool(distinct_cells(states.pos).all()), "two agents share a cell")
    check(bool((states.pos >= 0).all() and (states.pos < 10).all()), "agent off the board")
    check(bool((states.step_count < CTF_MAIN.max_steps).all()), "episode past max_steps")


def check_episode_metrics(metrics, steps, name):
    """episodes > 0, finite sums, and the completed episodes' returns plus
    the running ones equal the sum of all rewards: the same rewards summed
    in another order, so up to the float32 rounding of ``steps``
    accumulations into each sum (2**-24 of its magnitude each)."""
    episodes = int(metrics["episodes"])
    reward_sum = float(metrics["reward_sum"])
    ep_return_sum = float(metrics["ep_return_sum"])
    run_sum = float(metrics["run_return"].double().sum())
    check(math.isfinite(reward_sum) and math.isfinite(ep_return_sum) and episodes > 0,
          f"{name}: episodes {episodes}, reward {reward_sum}, episode returns {ep_return_sum}")
    scale = max(1.0, abs(reward_sum), abs(ep_return_sum), abs(run_sum))
    check(abs(ep_return_sum + run_sum - reward_sum) <= steps * 2.0**-23 * scale + 1e-2,
          f"{name}: ep_return_sum {ep_return_sum} + run_return {run_sum} != reward_sum {reward_sum}")
    log(f"{name} rollout: {episodes} episodes, reward_sum {reward_sum}, "
        f"ep_return_sum {ep_return_sum}, run_return sum {run_sum}")


def maze_main_path():
    """The Maze path: MAZE_MAIN at B = 8192, reset(seed=0) and one
    1000-step rollout.  Returns (env, first states, obs, final states,
    metrics)."""
    env = make_maze_batch(MAZE_MAIN, B)
    first, obs = env.reset(seed=0)
    states, metrics = env.rollout(first, MAZE_STEPS_PER_CALL)
    return env, first, obs, states, metrics


def check_maze_path(env, first, obs, states, metrics):
    """The Maze path's invariants: a second reset(seed=0) gives the same
    state, spawns lie on the background, the map obs has its shape, and
    after the rollout the metrics agree and every agent is on the board and
    off the obstacles (no obstacle penalty: they block)."""
    again, _ = env.reset(seed=0)
    check(all(torch.equal(getattr(first, f), getattr(again, f))
              for f in ("pos", "dir", "step_count")), "reset(seed=0) twice differs")
    fm = torch.as_tensor(MAZE_MAIN.field_map, device=DEV)
    S0, S1 = fm.shape
    check(bool((fm[first.pos[:, 0].long(), first.pos[:, 1].long()] == BACKGROUND).all()),
          "spawn off the background")
    check(obs.dtype == torch.float32 and tuple(obs.shape) == (B, S0, S1),
          f"obs {obs.dtype} {tuple(obs.shape)}")
    check_episode_metrics(metrics, MAZE_STEPS_PER_CALL, "maze")
    pos = states.pos
    check(bool(((pos[:, 0] >= 0) & (pos[:, 0] < S0) & (pos[:, 1] >= 0) & (pos[:, 1] < S1)).all()),
          "agent off the board")
    check(not bool((fm[pos[:, 0].long(), pos[:, 1].long()] == M_OBSTACLE).any()),
          "agent on an obstacle")
    check(bool((states.step_count < MAZE_MAIN.max_steps).all()), "episode past max_steps")


def wildfire_main_path():
    """The Wildfire path: WF_MAIN at B = 8192, reset(seed=0) and one
    400-step rollout.  Returns (env, first states, obs, final states,
    metrics)."""
    env = make_wildfire_batch(WF_MAIN, B)
    first, obs = env.reset(seed=0)
    states, metrics = env.rollout(first, WF_STEPS_PER_CALL)
    return env, first, obs, states, metrics


def check_wildfire_path(env, first, obs, states, metrics):
    """The Wildfire path's invariants: a second reset(seed=0) gives the same
    state, fresh boards hold min(num_initial_fires, trees) fires and distinct
    agents, the obs has its shape, and after the rollout the metrics agree,
    no two agents share a cell and every cell is empty, tree, fire or
    burnt."""
    again, _ = env.reset(seed=0)
    check(all(torch.equal(getattr(first, f), getattr(again, f))
              for f in ("cells", "agent_pos", "step_count", "extinguished")),
          "reset(seed=0) twice differs")
    fires = (first.cells == FIRE).sum(dim=(1, 2))
    grown = (first.cells == TREE).sum(dim=(1, 2)) + fires
    check(bool((fires == grown.clamp(max=WF_MAIN.num_initial_fires)).all()), "initial fires")
    check(bool(distinct_cells(first.agent_pos).all()), "spawns overlap")
    size = WF_MAIN.size
    check(obs.dtype == torch.uint8 and tuple(obs.shape) == (B, size, size, 3),
          f"obs {obs.dtype} {tuple(obs.shape)}")
    check_episode_metrics(metrics, WF_STEPS_PER_CALL, "wildfire")
    check(bool(distinct_cells(states.agent_pos).all()), "two agents share a cell")
    check(bool(((states.agent_pos >= 0) & (states.agent_pos < size)).all()), "agent off the board")
    check(bool(((states.cells >= 0) & (states.cells <= 3)).all()), "cell value outside 0..3")
    check(bool((states.step_count < WF_MAIN.max_steps).all()), "episode past max_steps")


def collect_episode_path():
    """The Collect episode path: the main config's episode rollout at
    B = 8192, reset(seed=0) and one 500-step call.  Returns (rollout,
    states, obs, metrics)."""
    roll = make_collect_episode_rollout(MAIN, B)
    states, obs = roll.reset(seed=0)
    states, metrics = roll(states, STEPS_PER_CALL)
    return roll, states, obs, metrics


def check_collect_episode_path(roll, states, obs, metrics):
    """Ten lockstep episodes of every env, all reward in finished episodes,
    and fresh boards after the last one: every ball back, two agents a
    board, the counters zero.  Returns the states."""
    check(obs.shape == (B, 10, 10, 3) and obs.dtype == torch.uint8, "obs shape")
    episodes = int(metrics["episodes"])
    reward_sum = float(metrics["reward_sum"])
    check(episodes == B * STEPS_PER_CALL // MAIN.max_steps, f"episodes {episodes}")
    check(reward_sum > 0 and float(metrics["ep_return_sum"]) == reward_sum, "episode returns")
    check(bool((metrics["run_return"] == 0).all()), "run_return after lockstep truncation")
    for f in ("step_count", "collected", "info_counts"):
        check(not bool(getattr(states, f).any()), f"{f} after the episode boundary")
    check(bool(((states.grid_obj == BALL).sum(1) == MAIN.num_balls).all()), "balls on a fresh board")
    check(bool(((states.grid_obj == AGENT).sum(1) == 2).all()), "agents per board")
    log(f"collect episode rollout: {episodes} episodes, reward_sum {reward_sum}, "
        f"reward per agent-step {reward_sum / (B * STEPS_PER_CALL * 2)}")
    return states


def maze_episode_path():
    """The Maze episode path: MAZE_MAIN at B = 8192, chunks of 100 steps,
    reset(seed=0) and one 1000-step call.  Returns (rollout, first states,
    obs, final states, metrics)."""
    roll = make_maze_episode_rollout(MAZE_MAIN, B, chunk=MAZE_CHUNK)
    first, obs = roll.reset(seed=0)
    states, metrics = roll(first, MAZE_STEPS_PER_CALL)
    return roll, first, obs, states, metrics


def ctf_episode_path():
    """The CtF episode path: CTF_MAIN at B = 8192, chunks of 50 steps,
    reset(seed=0) and one 400-step call.  Returns (rollout, first states,
    obs, final states, metrics)."""
    roll = make_ctf_episode_rollout(CTF_MAIN, B, chunk=CTF_CHUNK)
    first, obs = roll.reset(seed=0)
    states, metrics = roll(first, CTF_STEPS_PER_CALL)
    return roll, first, obs, states, metrics


def wildfire_episode_path():
    """The Wildfire episode path: WF_MAIN at B = 8192, chunks of 24 steps,
    reset(seed=0) and one 400-step call.  Returns (rollout, first states,
    obs, final states, metrics)."""
    roll = make_wildfire_episode_rollout(WF_MAIN, B, chunk=WF_CHUNK)
    first, obs = roll.reset(seed=0)
    states, metrics = roll(first, WF_STEPS_PER_CALL)
    return roll, first, obs, states, metrics


def time_rollout(rollout, name, states, steps, agents, warmup_max):
    """Warm-up calls of ``rollout(states, steps)`` until three in a row lie
    within 5% of each other (at most ``warmup_max``), each logged with the
    host's share of it and the card's clocks, then 11 timed calls; logs
    agent-steps/s (median, slowest, fastest).  Returns the final states."""
    agent_steps = B * steps * agents

    def timed_rollout():
        """One rollout call: (device-event ms, host wall ms, host CPU ms)."""
        nonlocal states
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        w0, c0 = time.perf_counter(), time.process_time()
        start.record()
        states, _ = rollout(states, steps)
        end.record()
        end.synchronize()
        return (start.elapsed_time(end), (time.perf_counter() - w0) * 1e3,
                (time.process_time() - c0) * 1e3)

    warm, settled = [], False
    while len(warm) < warmup_max and not settled:
        clocks = gpu_clocks()
        warm.append(timed_rollout())
        log(f"warm-up call {len(warm) - 1}: {warm[-1][0]:.1f} ms (host wall "
            f"{warm[-1][1]:.1f} ms, host CPU {warm[-1][2]:.1f} ms; before it: {clocks})")
        last = [w[0] for w in warm[-3:]]
        settled = len(last) == 3 and max(last) <= 1.05 * min(last)
    log(f"warm-up: {len(warm)} calls, settled: {settled}")
    calls = [timed_rollout() for _ in range(11)]
    windows = [c[0] for c in calls]
    median = sorted(windows)[len(windows) // 2]
    log(f"{name} rollout of {steps} steps at B={B}, {len(windows)} calls "
        f"after the warm-up: ms per call {windows}; host CPU ms "
        f"{[round(c[2], 1) for c in calls]}; "
        f"agent-steps/s {agent_steps / (median / 1e3)} (median), "
        f"{agent_steps / (max(windows) / 1e3)} (slowest), "
        f"{agent_steps / (min(windows) / 1e3)} (fastest); after: {gpu_clocks()}")
    return states


def full_width_net(env, n_actions, agents):
    """The full-width ``ActorCritic`` for ``env``'s observations."""
    obs_shape = tuple(env.encode(env.cfg, env.reset(0)[0]).shape[1:])
    return ActorCritic(n_actions, agents, TRAIN_HIDDEN, obs_shape=obs_shape)


def training_path(family):
    """The training path of ``family``: ``make_family_batch(family, 8192)``,
    the full-width ``ActorCritic``, ``make_ppo`` with ``TRAIN_CFG``,
    ``init_fn(0)`` and the learner's generator seeded with 1, as
    ``train_loop`` starts them.  Returns (env, net, train_step, carry,
    generator)."""
    env, _, n_actions, agents = make_family_batch(family, B)
    net = full_width_net(env, n_actions, agents)
    init_fn, train_step = make_ppo(env, net, TRAIN_CFG)
    _, carry = init_fn(0)
    return env, net, train_step, carry, torch.Generator(device=DEV).manual_seed(1)


def run_training(family, want_launches):
    """Drive a training path: the card's forward against the CPU forward of
    the same params and obs, then TRAIN_WARMUP untimed and TRAIN_TIMED
    timed iterations, each with the launch counts set to 0 just before it
    and checked just after, its rollout and update timed apart by CUDA
    events.  The forward's tolerance is for bf16 activations.  Checks
    finite losses and moved params; logs env-steps/s (median, slowest,
    fastest), the split and reward_per_step.  Returns (train_step, carry,
    generator, launches of one iteration)."""
    env, net, train_step, carry, gen = training_path(family)
    obs = env.encode(env.cfg, carry.env)
    with torch.no_grad():
        got = net(obs)
        want = copy.deepcopy(net).cpu()(obs.cpu())
    fwd_err = max((g.cpu() - w).abs().max().item() for g, w in zip(got, want))
    check(fwd_err <= FORWARD_ATOL, f"{family}: card forward differs from the CPU by {fwd_err}")
    before = [p.detach().clone() for p in net.parameters()]

    def iteration():
        nonlocal carry
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        w0 = time.perf_counter()
        events[0].record()
        carry, traj, last_value, ep_stats = train_step.rollout(carry, gen)
        events[1].record()
        metrics = train_step.update(traj, last_value, gen)
        events[2].record()
        metrics.update(ep_stats)
        values = {k: float(v) for k, v in metrics.items()}  # the trainer's one sync
        return (events[0].elapsed_time(events[1]), events[1].elapsed_time(events[2]),
                (time.perf_counter() - w0) * 1e3, values)

    rows = []
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        counts, row = run_counted(iteration)
        check_launches(counts, want_launches, f"{family} training iteration {i}")
        check(all(math.isfinite(row[3][k]) for k in ("loss", "pg_loss", "v_loss", "entropy")),
              f"{family}: losses {row[3]}")
        rows.append(row)
    check(any(not torch.equal(a, b) for a, b in zip(before, net.parameters())),
          f"{family}: params did not move")
    timed = rows[TRAIN_WARMUP:]
    ms = [r[0] + r[1] for r in timed]
    steps = B * TRAIN_CFG.rollout_len
    log(f"{family} training at B={B}, hidden {TRAIN_HIDDEN}, rollout {TRAIN_CFG.rollout_len}, "
        f"{TRAIN_CFG.num_epochs} epochs x {TRAIN_CFG.num_minibatches} minibatches: card forward "
        f"vs CPU max_abs_err {fwd_err}; launches an iteration {counts}")
    log(f"{family} training, {TRAIN_TIMED} iterations after {TRAIN_WARMUP} untimed: env-steps/s "
        f"{steps / (sorted(ms)[len(ms) // 2] / 1e3)} (median), {steps / (max(ms) / 1e3)} "
        f"(slowest), {steps / (min(ms) / 1e3)} (fastest); rollout ms {[round(r[0], 3) for r in timed]}; "
        f"update ms {[round(r[1], 3) for r in timed]}; host wall ms {[round(r[2], 1) for r in timed]}; "
        f"reward_per_step {[r[3]['reward_per_step'] for r in rows]}; loss "
        f"{[round(r[3]['loss'], 5) for r in rows]}; after: {gpu_clocks()}")
    return train_step, carry, gen, counts


def run_evaluations():
    """The evaluation paths at B = 8192 with the full-width net, each call
    counted alone: ``evaluate`` on the Collect and CtF family batches and
    ``evaluate_ctf(CTF_MAIN)``, EVAL_STEPS steps each; then three timed
    calls of each (each call ends in its one read of the device).  Returns
    ({path: launches of one call}, the Collect call for the profile)."""
    launches, calls = {}, {}
    for family in ("collect", "ctf"):
        env, cfg, n_actions, agents = make_family_batch(family, B)
        net = full_width_net(env, n_actions, agents)
        calls[family] = (functools.partial(evaluate, env, net, EVAL_STEPS, seed=0),
                         cfg.num_agents)
    ctf_net = full_width_net(make_ctf_batch(CTF_MAIN, 1), 5, CTF_MAIN.num_blue_agents)
    calls["evaluate_ctf"] = (functools.partial(evaluate_ctf, CTF_MAIN, B, ctf_net, EVAL_STEPS,
                                               seed=0), CTF_MAIN.num_agents)
    want = {
        "collect": {"collect_step": EVAL_STEPS, "collect_reset": EVAL_STEPS + 1},
        "ctf": {"ctf_step": EVAL_STEPS},
        "evaluate_ctf": {"ctf_step": EVAL_STEPS},
    }
    for path, (call, agents) in calls.items():
        counts, res = run_counted(call)
        check_launches(counts, want[path], f"{path} evaluation")
        launches[path] = counts
        check(res["episodes"] > 0 and all(math.isfinite(v) for v in res.values()),
              f"{path} evaluation: {res}")
        if path == "collect":  # lockstep truncation at max_steps 50
            check(res["episodes"] == B * (EVAL_STEPS // MAIN.max_steps), f"episodes {res}")
        if path == "evaluate_ctf":
            check(res["wins"] + res["losses"] + res["draws"] == res["episodes"],
                  f"outcomes do not partition the episodes: {res}")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            call()
            times.append(time.perf_counter() - t0)
        rate = B * EVAL_STEPS * agents / sorted(times)[1]
        log(f"{path} evaluation of {EVAL_STEPS} steps at B={B}, hidden {TRAIN_HIDDEN}: {res}; "
            f"s per call {[round(t, 3) for t in times]}; agent-steps/s {rate} (median of 3, "
            f"every agent counted); after: {gpu_clocks()}")
    return launches, calls["collect"][0]


def run_selfplay():
    """Self-play on ``make_ctf_selfplay_batch(CTF_MAIN, 8192)`` with the
    full-width nets and SELFPLAY_CFG: SELFPLAY_WARMUP untimed and
    SELFPLAY_TIMED timed iterations, each counted alone (no kernel: the
    all-agent step is plain PyTorch), rollout and update timed apart by
    CUDA events; finite losses, both nets moved.  Then one league iteration
    (pool_size 2) and ``snapshot_fn``.  Returns (train_step, state,
    generator) for the profile."""
    env = make_ctf_selfplay_batch(CTF_MAIN, B)
    init_fn, train_step, (blue, red) = make_selfplay_ppo(env, CTF_MAIN, SELFPLAY_CFG,
                                                         TRAIN_HIDDEN)
    sp = init_fn(0)
    gen = torch.Generator(device=DEV).manual_seed(1)
    before = [p.detach().clone() for p in (*blue.parameters(), *red.parameters())]
    keys = ("blue_loss", "red_loss", "blue_entropy", "red_entropy", "blue_reward_per_step",
            "red_reward_per_step")

    def iteration():
        nonlocal sp
        events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        events[0].record()
        carry, b, r, stats = train_step.rollout(sp.states, None, B, gen)
        events[1].record()
        sp, metrics = train_step.update(sp, carry, b, r, stats, gen)
        events[2].record()
        values = dict(zip(keys, torch.stack([metrics[k].float() for k in keys]).tolist()))
        return events[0].elapsed_time(events[1]), events[1].elapsed_time(events[2]), values

    rows = []
    for i in range(SELFPLAY_WARMUP + SELFPLAY_TIMED):
        counts, row = run_counted(iteration)
        check_launches(counts, {}, f"self-play iteration {i}")
        check(all(math.isfinite(v) for v in row[2].values()), f"self-play: {row[2]}")
        check(abs(row[2]["red_reward_per_step"] + row[2]["blue_reward_per_step"]) < 1e-6,
              f"red's reward is not minus blue's: {row[2]}")
        rows.append(row)
    after = list((*blue.parameters(), *red.parameters()))
    n_blue = len(list(blue.parameters()))
    check(any(not torch.equal(a, b) for a, b in zip(before[:n_blue], after[:n_blue])),
          "self-play: blue did not move")
    check(any(not torch.equal(a, b) for a, b in zip(before[n_blue:], after[n_blue:])),
          "self-play: red did not move")
    timed = rows[SELFPLAY_WARMUP:]
    ms = sorted(r[0] + r[1] for r in timed)
    steps = B * SELFPLAY_CFG.rollout_len
    log(f"self-play on CTF_MAIN at B={B}, hidden {TRAIN_HIDDEN}, {SELFPLAY_CFG}: "
        f"{SELFPLAY_TIMED} iterations after {SELFPLAY_WARMUP} untimed: env-steps/s "
        f"{steps / (ms[len(ms) // 2] / 1e3)} (median), {steps / (ms[-1] / 1e3)} (slowest), "
        f"{steps / (ms[0] / 1e3)} (fastest); rollout ms {[round(r[0], 3) for r in timed]}; "
        f"update ms {[round(r[1], 3) for r in timed]}; blue_loss "
        f"{[round(r[2]['blue_loss'], 5) for r in rows]}; after: {gpu_clocks()}")

    league_env = make_ctf_selfplay_batch(CTF_MAIN, B)
    l_init, l_step, snapshot_fn, _ = make_league_ppo(league_env, CTF_MAIN, SELFPLAY_CFG,
                                                     pool_size=2, hidden=TRAIN_HIDDEN)
    ls = l_init(0)
    counts, (ls, metrics) = run_counted(lambda: l_step(ls, gen))
    check_launches(counts, {}, "league iteration")
    values = {k: float(v) for k, v in metrics.items()}
    check(all(math.isfinite(v) for v in values.values()), f"league: {values}")
    ls = snapshot_fn(ls)
    check((ls.filled, ls.slot) == (2, 0), f"league ring after a snapshot: {ls.filled}, {ls.slot}")
    log(f"league iteration (pool_size 2, league_fraction 0.5) at B={B}: opponent "
        f"{values['league_opponent']}, blue reward self-play {values['blue_reward_selfplay']}, "
        f"league {values['blue_reward_league']}; snapshot filled {ls.filled} slots")
    return train_step, sp, gen


def run_partial_obs_path():
    """``make_ctf_batch(CTF_MAIN, 8192, partial_obs_view=7)``: reset(seed=0)
    and PARTIAL_STEPS steps of random blue actions, counted: one
    ``ctf_step`` a step and FOV obs of (B, 4, 7, 7, 3) uint8.  Returns the
    launches."""
    env = make_ctf_batch(CTF_MAIN, B, partial_obs_view=VIEW)
    gen = torch.Generator(device=DEV).manual_seed(90)

    def drive():
        states, obs = env.reset(seed=0)
        shapes = {(obs.dtype, tuple(obs.shape))}
        for _ in range(PARTIAL_STEPS):
            acts = torch.randint(0, 5, env.actions_shape, generator=gen, device=DEV,
                                 dtype=torch.int32)
            states, obs, *_ = env.step(states, acts)
            shapes.add((obs.dtype, tuple(obs.shape)))
        return states, shapes

    counts, (states, shapes) = run_counted(drive)
    check_launches(counts, {"ctf_step": PARTIAL_STEPS}, "CtF partial-obs")
    check(shapes == {(torch.uint8, (B, CTF_MAIN.num_agents, VIEW, VIEW, 3))},
          f"partial obs {shapes}")
    acts = torch.zeros(env.actions_shape, dtype=torch.int32, device=DEV)
    enc_ms, enc_all = time_ms(lambda: env.encode(env.cfg, states), 20)
    step_ms, step_all = time_ms(lambda: env.step(states, acts), 20)
    log(f"CtF partial-obs path: {PARTIAL_STEPS} steps at B={B}, obs {shapes}; partial encode "
        f"{enc_ms * 1e3:.1f} us a call {us(enc_all)}; a step with it {step_ms * 1e3:.1f} us "
        f"{us(step_all)}")
    profile_call(lambda: env.encode(env.cfg, states), "one CtF partial encode (V = 7)", 1,
                 "call")
    return counts


#: Each family's step kernel, and the agents a vector-env step counts
#: (make_vector_batch's configs; CtF counts both teams, as bench_all.py).
VEC_FAMILIES = {"collect": ("collect_step", 2), "ctf": ("ctf_step", 4), "maze": ("maze_step", 1),
                "wildfire": ("wildfire_step", 2)}


def run_vector_envs():
    """``make_vector_env(family, 8192)`` as its ``VectorEnv`` drives it:
    gymnasium is not installed on the card's machine, so its core,
    ``NextStepEnv(make_vector_batch(family, 8192))``, numpy actions in and
    numpy results out.  ``reset(seed=0)`` and VEC_STEPS steps of uniform
    random actions drawn on the host, counted: one step-kernel launch a
    step, plus Collect's reset (one all-rows at the reset, one masked a
    step), and no other kernel.  Then agent-steps/s of calls of
    VEC_STEPS_PER_CALL steps (CUDA events around each call, warm-up and
    11 timed calls as the rollouts).  Returns ({family: launches}, the
    Collect env and an action batch, for the profile)."""
    launches, collect = {}, None
    for family, (kernel, agents) in VEC_FAMILIES.items():
        vec = NextStepEnv(make_vector_batch(family, B))
        env = vec.env
        rng = np.random.default_rng(100)
        actions = [rng.integers(0, env.num_actions, env.actions_shape) for _ in range(16)]

        def drive():
            obs = vec.reset(seed=0)
            dones, rew_sum = 0, 0.0
            for i in range(VEC_STEPS):
                obs, rew, term, trunc = vec.step(actions[i % len(actions)])
                dones += int((term | trunc).sum())
                rew_sum += float(rew.sum())
            return obs, rew, dones, rew_sum

        counts, (obs, rew, dones, rew_sum) = run_counted(drive)
        want = {kernel: VEC_STEPS}
        if family == "collect":
            want["collect_reset"] = VEC_STEPS + 1
        check_launches(counts, want, f"{family} vector env")
        launches[family] = counts
        obs_shape = {"collect": (B, 10, 10, 3), "ctf": (B, 216), "maze": (B, 13, 13),
                     "wildfire": (B, 16, 16, 3)}[family]
        check(isinstance(obs, np.ndarray) and obs.shape == obs_shape, f"{family} obs {obs.shape}")
        check(rew.dtype == np.float64 and np.isfinite(rew).all() and dones > 0,
              f"{family}: rewards {rew.dtype}, {dones} done flags")
        if family == "collect":  # truncation at 50, then a held step: 3 episodes in 200
            check(dones == 3 * B, f"collect vector env: {dones} done flags")
        log(f"{family} vector env: reset(seed=0) and {VEC_STEPS} steps at B={B}: obs "
            f"{obs.dtype}{obs.shape}, {dones} done flags, reward sum {rew_sum}")

        def call(_, steps):
            for i in range(steps):
                vec.step(actions[i % len(actions)])
            return None, None

        time_rollout(call, f"{family} vector env (NextStepEnv)", None, VEC_STEPS_PER_CALL,
                     agents, VEC_WARMUP_MAX)
        if family == "collect":
            collect = (vec, actions[0])
    return launches, collect


def time_single_envs(steps=200):
    """One env's steps/s on the card through the per-env functions the
    single-env adapters step (``make_collect`` on MAIN, ``make_ctf`` on
    CTF_MAIN): each step reads its done flags on the host, as an adapter
    does, and a finished episode resets; host wall over ``steps`` steps,
    after as many untimed."""
    ctf_fns = make_ctf(CTF_MAIN, DEV)
    for name, (reset_fn, step_fn), n_act in (
            ("Collect", make_collect(MAIN, DEV)[:2], MAIN.num_agents),
            ("CtF", (ctf_fns.reset_fn, ctf_fns.step_fn), CTF_MAIN.num_blue_agents)):
        gen = torch.Generator(device=DEV).manual_seed(7)
        rng = np.random.default_rng(0)
        rates = []
        for _ in range(2):
            state = reset_fn(gen)
            t0 = time.perf_counter()
            for _ in range(steps):
                state, _, _, term, trunc, _ = step_fn(state, rng.integers(0, 4, n_act), gen)
                if bool(term | trunc):
                    state = reset_fn(gen)
            rates.append(steps / (time.perf_counter() - t0))
        log(f"one {name} env through its per-env functions on the card: {rates[-1]} steps/s "
            f"({steps} steps after {steps} untimed, each reading its done flags)")


#: The render phase's cases: each family's batch, config, tile ids, bank
#: and renderer, and the state fields the renderer reads.
RENDER_CASES = (
    ("Collect main", make_collect_batch, MAIN, tiles.collect_tile_ids, tiles._collect_bank,
     render_collect_batch, ("grid_obj", "grid_color")),
    ("CTF_MAIN", make_ctf_batch, CTF_MAIN, tiles.ctf_tile_ids, tiles._ctf_bank,
     render_ctf_batch, ("pos", "dir", "terminated")),
    ("MAZE_MAIN", make_maze_batch, MAZE_MAIN, tiles.maze_tile_ids, tiles._maze_bank,
     render_maze_batch, ("pos", "dir")),
    ("WF_MAIN", make_wildfire_batch, WF_MAIN, tiles.wildfire_tile_ids, tiles._wildfire_bank,
     render_wildfire_batch, ("cells", "agent_pos")),
)


def spread_rows(n_rows, n):
    """``n_rows`` row indices spread over a batch of ``n``, 0 and n - 1
    included."""
    return torch.linspace(0, n - 1, n_rows, device=DEV).round().long()


def rows_to_cpu(states, idx):
    """Rows ``idx`` of a batch state, copied to the CPU."""
    return type(states)(**{f.name: getattr(states, f.name)[idx].cpu()
                           for f in dataclasses.fields(states)})


def time_events(fn, untimed=2, timed=5):
    """(median ms, all ms) of ``timed`` calls of ``fn`` after ``untimed``
    ones, each call between CUDA events."""
    for _ in range(untimed):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(timed):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[timed // 2], times


def check_batch_renders(seed):
    """Each family's ``render_<family>_batch`` at B = 8192 and T = 32 on
    states after a reset and RENDER_STEPS steps (each launching the
    family's step kernel): RENDER_ROWS rows spread over the batch, the last
    included, pixel-equal to the same function on the CPU for the same
    states copied over, and the whole batch equal to a two-pass gather
    (``bank[ids]``, then a permuted copy).  Times both (CUDA events, median
    of 5 after 2 untimed), with the bytes the render must move (the fields
    it reads and the bank once, the frames once) and its peak memory.
    Returns {name: reading}."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    readings = {}
    for name, make_batch, cfg, tile_ids, make_bank, render, fields in RENDER_CASES:
        env = make_batch(cfg, B)
        states, _ = env.reset(seed)
        for _ in range(RENDER_STEPS):
            acts = torch.randint(0, env.num_actions, env.actions_shape, generator=gen,
                                 device=DEV, dtype=torch.int32)
            states, *_ = env.step(states, acts)
        frames = render(cfg, states)
        check(frames.dtype == torch.uint8 and frames.device == DEV,
              f"{name}: frames {frames.dtype} on {frames.device}")
        idx = spread_rows(RENDER_ROWS, B)
        want = render(cfg, rows_to_cpu(states, idx))
        err = max_abs_err([frames[idx].cpu()], [want])
        ids = tile_ids(cfg, states)
        bank = torch.from_numpy(make_bank(RENDER_T)).to(DEV)
        n, h, w = ids.shape

        def two_pass():
            return bank[ids].permute(0, 1, 3, 2, 4, 5).reshape(n, h * RENDER_T, w * RENDER_T, 3)

        check(torch.equal(two_pass(), frames), f"{name}: the two-pass gather differs")
        in_bytes = bank.numel() + sum(getattr(states, f).numel() * getattr(states, f).element_size()
                                      for f in fields)
        nbytes = in_bytes + frames.numel()
        del frames
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms, all_ms = time_events(lambda: render(cfg, states))
        peak = torch.cuda.max_memory_allocated() - base
        two_ms, two_all = time_events(two_pass)
        ids_ms, _ = time_events(lambda: tile_ids(cfg, states))
        bound_ms = nbytes / MEM_BYTES_PER_S * 1e3
        readings[name] = {"ms": ms, "tile_ids_ms": ids_ms, "two_pass_ms": two_ms,
                          "bound_ms": bound_ms, "bytes": nbytes, "peak_bytes": peak,
                          "max_abs_err": err}
        log(f"render {name}: B={B}, T={RENDER_T}, frames {tuple(want.shape[1:])} uint8; "
            f"{RENDER_ROWS} rows == CPU (max_abs_err {err}); {ms:.3f} ms a call (median of 5 "
            f"after 2 untimed, {[round(t, 3) for t in all_ms]}), {nbytes / ms / 1e6:.1f} GB/s, "
            f"of which the tile ids {ids_ms:.3f} ms; bound {bound_ms:.3f} ms (bytes: {nbytes} "
            f"B, {in_bytes} read); peak {peak} bytes above the {base} allocated before the "
            f"calls; two-pass gather {two_ms:.3f} ms {[round(t, 3) for t in two_all]}")
    return readings


def check_stacked_renders(seed, n=64):
    """Hand-built CtF and Wildfire batches with agents stacked on one cell
    in every other env (the last agent on a cell wins), CtF agents
    terminated at random, rendered on the card and on the CPU."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    s0, s1 = CTF_MAIN.field_map.shape
    A = CTF_MAIN.num_agents
    pos = torch.stack([torch.randint(0, s0, (n, A), generator=gen, device=DEV),
                       torch.randint(0, s1, (n, A), generator=gen, device=DEV)], -1).int()
    pos[::2, 1:] = pos[::2, :1]
    ctf_states = CtfState(
        pos=pos, dir=torch.randint(0, 4, (n, A), generator=gen, device=DEV, dtype=torch.int32),
        terminated=torch.rand((n, A), generator=gen, device=DEV) < 0.3,
        collided=torch.zeros((n, A), dtype=torch.bool, device=DEV),
        step_count=torch.zeros((n,), dtype=torch.int32, device=DEV))
    A = WF_MAIN.num_agents
    wpos = torch.randint(0, WF_MAIN.size, (n, A, 2), generator=gen, device=DEV,
                         dtype=torch.int32)
    wpos[::2, 1:] = wpos[::2, :1]
    wf_states = WildfireState(
        cells=torch.randint(0, 4, (n, WF_MAIN.size, WF_MAIN.size), generator=gen, device=DEV,
                            dtype=torch.int32),
        agent_pos=wpos, step_count=torch.zeros((n,), dtype=torch.int32, device=DEV),
        extinguished=torch.zeros((n,), dtype=torch.int32, device=DEV))
    err = 0.0
    for name, render, cfg, states in (("CTF_MAIN", render_ctf_batch, CTF_MAIN, ctf_states),
                                      ("WF_MAIN", render_wildfire_batch, WF_MAIN, wf_states)):
        idx = torch.arange(n, device=DEV)
        err = max(err, max_abs_err([render(cfg, states).cpu()],
                                   [render(cfg, rows_to_cpu(states, idx))]))
    log(f"render, stacked agents in every other env ({n} envs each, CtF agents terminated at "
        f"random): card == CPU, max_abs_err {err}")
    return err


def check_toroid_obs(seed):
    """``toroid_obs_fn``, batched, on Collect main at B = 8192 after a
    reset and RENDER_STEPS steps: TOROID_ROWS rows spread over the batch
    equal to the CPU's on the same states.  Times it."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    env = make_collect_batch(MAIN, B)
    states, _ = env.reset(seed)
    for _ in range(RENDER_STEPS):
        states, *_ = env.step(states, torch.randint(0, 4, env.actions_shape, generator=gen,
                                                    device=DEV, dtype=torch.int32))
    fn = toroid_obs_fn(MAIN)
    obs = fn(states)
    depth = MAIN.num_ball_types + MAIN.num_agents
    check(obs.dtype == torch.float32 and tuple(obs.shape) == (
        B, MAIN.num_agents, MAIN.height, MAIN.width, depth), f"toroid obs {tuple(obs.shape)}")
    idx = spread_rows(TOROID_ROWS, B)
    err = max_abs_err([obs[idx].cpu()], [fn(rows_to_cpu(states, idx))])
    ms, all_ms = time_events(lambda: fn(states))
    log(f"toroid_obs_fn batched, Collect main at B={B}: obs {tuple(obs.shape)} float32, "
        f"{TOROID_ROWS} rows == CPU (max_abs_err {err}); {ms:.3f} ms a call "
        f"{[round(t, 3) for t in all_ms]}")
    return err


def check_gif_frames():
    """The ``evaluate --gif`` frame function (``policy_frames``) on the
    card for Collect main and CTF_MAIN (max_steps GIF_STEPS), one env,
    an untrained full-width ``ActorCritic``, counted: after the first
    reset, one step-kernel launch a frame and no other kernel; uint8
    frames of the board's shape.  Returns {family: launches}."""
    launches = {}
    ctf_cfg = dataclasses.replace(CTF_MAIN, max_steps=GIF_STEPS)
    for family, make_batch, cfg, kernel, n_actions, agents, reset_launches in (
            ("collect", make_collect_batch, MAIN, "collect_step", 4, MAIN.num_agents,
             {"collect_reset": 1}),
            ("ctf", make_ctf_batch, ctf_cfg, "ctf_step", 5, ctf_cfg.num_blue_agents, {})):
        check(cfg.max_steps == GIF_STEPS, f"{family}: max_steps {cfg.max_steps}")
        net = full_width_net(make_batch(cfg, 1), n_actions, agents)
        t0 = time.perf_counter()
        counts, frames = run_counted(lambda: policy_frames(family, cfg, net, seed=0))
        wall = time.perf_counter() - t0
        steps = len(frames) - 1
        check(1 <= steps <= GIF_STEPS, f"{family} gif: {steps} steps")
        if family == "collect":  # respawn: no termination, truncation at max_steps
            check(steps == GIF_STEPS, f"collect gif: {steps} steps")
        check_launches(counts, {kernel: steps, **reset_launches}, f"{family} gif frame")
        h, w = ((cfg.height, cfg.width) if family == "collect"
                else cfg.field_map.shape[::-1])
        shapes = {(f.dtype, f.shape) for f in frames}
        check(shapes == {(np.dtype(np.uint8), (h * RENDER_T, w * RENDER_T, 3))},
              f"{family} gif frames {shapes}")
        launches[family] = counts
        log(f"gif frame path {family}: {len(frames)} frames, {steps} steps, {counts[kernel]} "
            f"{kernel} launches (one a step), {wall:.2f} s of host wall")
    return launches


def profile_rollout(rollout, states, name, steps=50, max_launches=None, forbid=()):
    """Device time by kernel and the idle share over ``steps`` steps of
    ``rollout(states, steps)`` under ``torch.profiler``."""
    profile_call(lambda: rollout(states, steps), f"{steps} {name} rollout steps", steps, "step",
                 max_launches=max_launches, forbid=forbid)


def profile_call(call, what, per, unit, tries=2, max_launches=None, forbid=()):
    """Device time by kernel and the idle share of one ``call()`` under
    ``torch.profiler`` (``utils/profiling.py`` ``trace`` and
    ``summarize_profile``): the twelve longest kernels, and the port's own
    kernels wherever they rank; launches counted per ``per`` ``unit``s,
    and, where the trace has device time, at most ``max_launches`` in all
    when that is given, and no kernel whose name holds a fragment of
    ``forbid`` (every kernel of the trace is read).  A short window right
    after a long one has come back with no device record at all: the call
    is then profiled again, up to ``tries`` times."""
    for attempt in range(tries):
        torch.cuda.synchronize()
        with profiling.trace() as prof:
            call()
        summary = profiling.summarize_profile(prof, top=1000 if forbid else 12)
        if summary["device"] == "cuda":
            break
        log(f"profile of {what}, try {attempt + 1}: no device time recorded")
    if summary["device"] == "cuda":
        busy_us, wall_us = summary["device_us"], summary["wall_us"]
        log(f"profile of {what} (wall clock under the profiler): "
            f"wall {wall_us:.0f} us, device kernels {busy_us:.0f} us in {summary['launches']} "
            f"launches ({busy_us / per:.2f} us and {summary['launches'] / per:.2f} launches per "
            f"{unit}), idle share {summary['idle_share']:.3f}")
        if max_launches is not None:
            check(summary["launches"] <= max_launches,
                  f"profile of {what}: {summary['launches']} launches, more than {max_launches}")
        for key, _, _ in summary["kernels"]:
            check(not any(f in key for f in forbid), f"profile of {what}: a kernel {key}")
        rows = {(i + 1, *r) for i, r in enumerate(summary["kernels"][:12])}
        for rank, key, dev_us, count in sorted(rows | set(summary["port_kernels"])):
            log(f"  #{rank:<3d} {dev_us:9.1f} us  {count:5d}x  {key[:90]}")
    else:
        log(f"profile of {what}: no device time recorded (device busy share not measured)")


#: Phase 5: the largest parameter difference allowed between the
#: data-parallel learner at world size 1 and the plain one after DDP_ITERS
#: iterations from the same seeds, over the largest parameter.
DDP_RTOL = 1e-5
DDP_ITERS = 2
#: Every metric of each of those iterations against the plain learner's:
#: |ddp - plain| <= DDP_METRIC_ATOL + DDP_METRIC_RTOL * |plain| (the
#: explained variance is summed in float64 on the mesh path).
DDP_METRIC_RTOL = 1e-5
DDP_METRIC_ATOL = 1e-5
#: Rounds of the timed turns of phase 5 (plain, sharded, sharded, plain
#: each): the host-bound calls spread by up to 2x between calls.
EPISODE_TURNS, TRAIN_TURNS = 20, 5


def time_turns(fns, rounds):
    """Host-wall ms of each named call (ending in a synchronise), run in
    turns: A B B A per round for two calls.  Returns {name: [ms, ...]}."""
    names = list(fns)
    times = {name: [] for name in names}
    for _ in range(rounds):
        for name in names + names[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[name]()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
    return times


def median(xs):
    return sorted(xs)[len(xs) // 2]


def quartiles(xs):
    """(first quartile, median, third quartile), rounded to µs."""
    xs = sorted(xs)
    return tuple(round(xs[int(q * (len(xs) - 1))], 3) for q in (0.25, 0.5, 0.75))


def check_sharded_episode(mesh):
    """The Collect episode rollout at B = 8192 under
    ``sharded_episode_rollout`` at world size 1: reset(seed=0) and one
    500-step call, counted (20 ``collect_steps_philox`` and the reset's
    ``collect_reset``),
    its metrics and states bit-equal to the unsharded rollout reset from
    the rank's seed; the audit of a call (one all-reduce of the three
    scalar metrics, float64); then both timed in turns.  Returns the
    launch counts."""
    sharded = sharded_episode_rollout(make_collect_episode_rollout(MAIN, B), mesh)

    def drive():
        states, _ = sharded.reset(0)
        return sharded(states, STEPS_PER_CALL)

    counts, (s_states, s_metrics) = run_counted(drive)
    check_launches(counts, {"collect_steps_philox": STEPS_PER_CALL // COLLECT_CHUNK,
                            "collect_reset": 1}, "sharded Collect episode")
    plain = make_collect_episode_rollout(MAIN, B)
    p_states, _ = plain.reset(fold_in_axis(0, mesh))
    p_states, p_metrics = plain(p_states, STEPS_PER_CALL)
    for k, v in p_metrics.items():
        check(s_metrics[k].dtype == v.dtype and torch.equal(s_metrics[k], v),
              f"sharded episode rollout: {k} {s_metrics[k]} != {v}")
    for f in dataclasses.fields(p_states):
        check(torch.equal(getattr(s_states, f.name), getattr(p_states, f.name)),
              f"sharded episode rollout: state {f.name} differs")
    ops = audit_call(sharded, s_states, STEPS_PER_CALL)
    check([(o.kind, o.shapes) for o in ops] == [("all_reduce", [("float64", (3,))])],
          f"sharded episode rollout's collectives: {ops}")
    states = {"sharded": s_states, "plain": p_states}

    def call(name, roll):
        def run():
            states[name], _ = roll(states[name], STEPS_PER_CALL)
        return run

    times = time_turns({"plain": call("plain", plain), "sharded": call("sharded", sharded)},
                       EPISODE_TURNS)
    agent_steps = B * STEPS_PER_CALL * MAIN.num_agents
    log(f"sharded Collect episode rollout at world size 1 ({dist.get_backend()}), B={B}, "
        f"{STEPS_PER_CALL} steps: launches {counts}; metrics and states bit-equal to the "
        f"unsharded rollout from the rank's seed; collectives a call {[(o.op_name, o.shapes) for o in ops]}; "
        f"host wall ms a call in turns: sharded {[round(t, 3) for t in times['sharded']]}, "
        f"plain {[round(t, 3) for t in times['plain']]}; quartiles sharded "
        f"{quartiles(times['sharded'])}, plain {quartiles(times['plain'])}; agent-steps/s {agent_steps / (median(times['sharded']) / 1e3)} "
        f"sharded, {agent_steps / (median(times['plain']) / 1e3)} plain (medians); after: {gpu_clocks()}")
    return counts


def check_ddp_training(mesh):
    """The Collect training cell (B = 8192, ``ActorCritic((256, 256))``,
    TRAIN_CFG) under ``make_ppo(..., mesh)`` at world size 1 against the
    plain ``make_ppo`` started from the same seeds (the same net seed, the
    rank's env states and env generator, the action generator seeded from
    ``fold_in_axis(1)``): DDP_ITERS counted iterations each, every metric
    of each within DDP_METRIC_ATOL/RTOL, then every parameter within
    DDP_RTOL relative; the audit of a further iteration
    (all-reduces only, none above the parameters' bytes, no uint8
    operand); then env-steps/s of both in turns."""
    env, _, n_actions, agents = make_family_batch("collect", B)
    net = full_width_net(env, n_actions, agents)
    init_fn, train_step = make_ppo(env, net, TRAIN_CFG, mesh)
    _, carry = init_fn(0)
    gen = torch.Generator(device=DEV).manual_seed(fold_in_axis(1, mesh))
    p_env, *_ = make_family_batch("collect", B)
    p_net = full_width_net(p_env, n_actions, agents)
    p_init, p_step = make_ppo(p_env, p_net, TRAIN_CFG)
    p_init(0)
    p_env.generator.set_state(train_step.env.generator.get_state())
    p_carry = tree_map(torch.clone, carry)
    p_gen = torch.Generator(device=DEV).manual_seed(fold_in_axis(1, mesh))
    per_iter = {"collect_step": TRAIN_CFG.rollout_len, "collect_reset": TRAIN_CFG.rollout_len}
    metric_diff = 0.0
    for i in range(DDP_ITERS):
        counts, (carry, metrics) = run_counted(lambda: train_step(carry, gen))
        check_launches(counts, per_iter, f"data-parallel training iteration {i}")
        check(all(math.isfinite(float(metrics[k])) for k in ("loss", "pg_loss", "v_loss")),
              f"data-parallel losses {metrics}")
        p_carry, p_metrics = p_step(p_carry, p_gen)
        check(set(metrics) == set(p_metrics), f"data-parallel metrics {sorted(metrics)}")
        for k, want in p_metrics.items():
            got, want = float(metrics[k]), float(want)
            check(abs(got - want) <= DDP_METRIC_ATOL + DDP_METRIC_RTOL * abs(want),
                  f"iteration {i}: the data-parallel {k} {got} against the plain {want}")
            metric_diff = max(metric_diff, abs(got - want))
    rel = param_rel_err(net, p_net)
    diff = max(float((a.detach() - b.detach()).abs().max())
               for a, b in zip(net.parameters(), p_net.parameters()))
    check(rel <= DDP_RTOL, f"data-parallel params differ from the plain learner's by {rel}")
    param_bytes = sum(p.numel() * p.element_size() for p in net.parameters())
    ops = audit_call(train_step, carry, gen)
    kinds = {o.kind for o in ops}
    biggest = max(o.bytes for o in ops)
    check(kinds == {"all_reduce"}, f"data-parallel train step collectives {kinds}")
    check(biggest <= param_bytes, f"an all-reduce of {biggest} bytes > params' {param_bytes}")
    check(all(dt != "uint8" for o in ops for dt, _ in o.shapes), "uint8 operand on the wire")
    state = {"ddp": (carry, gen, train_step), "plain": (p_carry, p_gen, p_step)}

    def iteration(name):
        def run():
            c, g, step = state[name]
            c, m = step(c, g)
            float(m["loss"])  # the trainer's one read a step
            state[name] = (c, g, step)
        return run

    times = time_turns({"plain": iteration("plain"), "ddp": iteration("ddp")}, TRAIN_TURNS)
    steps = B * TRAIN_CFG.rollout_len
    log(f"data-parallel training at world size 1 ({dist.get_backend()}), B={B}, hidden "
        f"{TRAIN_HIDDEN}, {TRAIN_CFG.num_epochs} epochs x {TRAIN_CFG.num_minibatches} "
        f"minibatches: after {DDP_ITERS} iterations the params differ from the plain "
        f"learner's by at most {diff} ({rel} relative; tolerance {DDP_RTOL}); "
        f"every metric of each iteration within {metric_diff} of the plain learner's "
        f"(tolerance {DDP_METRIC_ATOL} + {DDP_METRIC_RTOL} relative), losses "
        f"{float(metrics['loss'])} vs {float(p_metrics['loss'])}; collectives an "
        f"iteration: {len(ops)} all-reduces, the largest {biggest} bytes (params {param_bytes}); "
        f"host wall ms an iteration in turns: ddp {[round(t, 1) for t in times['ddp']]}, plain "
        f"{[round(t, 1) for t in times['plain']]}; quartiles ddp {quartiles(times['ddp'])}, "
        f"plain {quartiles(times['plain'])}; env-steps/s {steps / (median(times['ddp']) / 1e3)} "
        f"with DDP, {steps / (median(times['plain']) / 1e3)} without (medians); after: {gpu_clocks()}")
    return rel


def check_two_ranks_on_one_card():
    """The dryrun launcher, 2 ranks under gloo, both on cuda:0: it must exit
    0 with the ranks' params bit-equal after every step.  No rate: the
    ranks share one card."""
    out = Path(tempfile.mkdtemp(prefix="dryrun_")) / "multihost.json"
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "gym_multigrid_tpu_torch.scripts.multihost_dryrun",
             "--num-processes", "2", "--device", "cuda", "--backend", "gloo",
             "--timeout", "300", "--out", str(out)],
            capture_output=True, text=True, timeout=360, cwd=Path(__file__).resolve().parent,
        )
        check(proc.returncode == 0,
              f"two gloo ranks on one card: exit {proc.returncode}\n{proc.stdout[-3000:]}"
              f"\n{proc.stderr[-3000:]}")
        rec = json.loads(out.read_text())
    finally:
        shutil.rmtree(out.parent, ignore_errors=True)
    check(rec["ok"] and rec["workers_agree"] and rec["device"] == "cuda:0", f"dryrun {rec}")
    log(f"two gloo ranks on cuda:0 (dryrun launcher): workers_agree {rec['workers_agree']}, "
        f"update_rel_err {rec['update_rel_err']}, rollout_episodes {rec['rollout_episodes']}, "
        f"losses {rec['losses']} (no rate: the two ranks share one card)")
    return rec


def run_multiprocess_phase():
    """Phase 5: world size 1 under NCCL in this process (the sharded
    episode rollout, the data-parallel train step), then two gloo ranks on
    the card; the process group is destroyed at the end, and any failure
    fails the run."""
    store = tempfile.mkdtemp(prefix="nccl_store_")
    distributed_initialize(backend="nccl", init_method=f"file://{os.path.join(store, 'store')}",
                           rank=0, world_size=1, device=DEV)
    try:
        mesh = make_mesh()
        check(mesh.world_size == 1 and mesh.device == DEV and dist.get_backend() == "nccl",
              f"mesh {mesh} on {dist.get_backend()}")
        sharded_counts = check_sharded_episode(mesh)
        ddp_rel = check_ddp_training(mesh)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    dryrun = check_two_ranks_on_one_card()
    return sharded_counts, ddp_rel, dryrun


# ---------------------------------------------------------------------------
# Phase 6: the worked example and the root scripts
# ---------------------------------------------------------------------------

#: Pursuit rows held card against CPU, the steps they take, and the config.
PURSUIT_ROWS, PURSUIT_STEPS = B, 50
PURSUIT_CFG = custom_env.PursuitConfig(size=9, num_agents=3)
#: The soak windows of this phase (the script's default is 30).
SOAK_WINDOWS = 4
#: The rows of the 1M-env PPO run and the sweeps' largest batch: phase 6
#: holds the kernels of those paths to their plain versions there.
PPO_ROWS, SWEEP_ROWS = 1 << 20, 65536
#: The episode rollouts' K-step kernel of each family.
EPISODE_KERNEL = {"collect": "collect_steps_philox", "ctf": "ctf_steps",
                  "maze": "maze_steps_philox", "wildfire": "wf_steps_philox"}


def episode_call_launches(family, steps):
    """Launches of one ``steps``-step call of a family's episode rollout:
    one K-step launch a chunk, which runs the resets too."""
    return {EPISODE_KERNEL[family]: -(-steps // CHUNKS[family])}


def times_launches(per_call, calls, reset_family=None):
    """``per_call`` launches times ``calls``, plus the Collect reset of a
    ``reset(seed)`` when ``reset_family`` is Collect."""
    total = {k: v * calls for k, v in per_call.items()}
    if reset_family == "collect":
        total["collect_reset"] = total.get("collect_reset", 0) + 1
    return total


def per_unit(counts, units, less=None, times=1):
    """The launches by kernel that a run counted, ``less`` (by kernel)
    taken off first, over the ``units`` (iterations, frames, calls) they
    cover, times ``times``; whole numbers where they divide.  Kernels the
    run did not launch are left out."""
    out = {}
    for name, n in counts.items():
        q = (n - (less or {}).get(name, 0)) * times / units
        if n:
            out[name] = int(q) if q == int(q) else q
    return out


def check_pursuit():
    """The worked example on the card.  First the batch step at
    B = PURSUIT_ROWS on PURSUIT_CFG, card against CPU, from one state drawn
    on the CPU and one pre-drawn (steps, B, A) action set: every field,
    obs, reward and flag bit-equal for PURSUIT_STEPS chained steps.  Then
    the example's ``main`` at its sizes (256 envs, a 120-step random
    rollout, 60 PPO iterations), counted: no kernel of the port.  Returns
    the readings."""
    cfg, n, A = PURSUIT_CFG, PURSUIT_ROWS, PURSUIT_CFG.num_agents
    gen = torch.Generator().manual_seed(600)
    cpu_slab, card_slab = custom_env.make_pursuit(cfg, "cpu"), custom_env.make_pursuit(cfg, DEV)
    s_cpu = custom_env.reset_batch(cpu_slab, n, generator=gen)
    acts = torch.randint(0, custom_env.NUM_ACTIONS, (PURSUIT_STEPS, n, A), generator=gen,
                         dtype=torch.int32)
    s_card = type(s_cpu)(*(x.to(DEV) for x in state_fields(s_cpu)))
    err, ended = 0.0, 0
    for t in range(PURSUIT_STEPS):
        want = custom_env.step_batch(cpu_slab, s_cpu, acts[t])
        got = custom_env.step_batch(card_slab, s_card, acts[t].to(DEV))
        err = max(err, card_equals_cpu(flat_step(got), flat_step(want)))
        s_cpu, s_card = want[0], got[0]
        ended += int((want[3] | want[4]).sum())
    check(ended > 0, "no Pursuit episode ended")
    log(f"Pursuit batch step, card == CPU: B={n}, size {cfg.size}, {A} pursuers, "
        f"{PURSUIT_STEPS} steps, {ended} episode ends, max_abs_err {err}")
    counts, res = run_counted(lambda: custom_env.main([]))
    check_launches(counts, {}, "Pursuit example")
    check(len(res["losses"]) == 60 and all(math.isfinite(x) for x in res["losses"]),
          f"Pursuit PPO losses {res['losses']}")
    check(res["device"] == str(DEV) and res["random_episodes"] > 0, f"Pursuit main {res}")
    log(f"Pursuit main on {res['device']}: random policy {res['random_episodes']} episodes, "
        f"mean return {res['random_return']}; PPO after 60 iterations {res['ppo_return']}, "
        f"{res['ppo_iters_per_s']} iterations/s; losses {res['losses']}")
    return {"step_max_abs_err": err, "random_return": res["random_return"],
            "ppo_return": res["ppo_return"], "ppo_iters_per_s": res["ppo_iters_per_s"],
            "losses_finite": True}


def check_train_mvn_ctf_rl(out):
    """``train_mvn_ctf_rl`` at its defaults (512 envs, rollout 64) for 3
    iterations into ``out``, then resumed for 1 more, each run counted:
    64 ``ctf_step`` launches an iteration and no other kernel; the metrics'
    step axis continues across the resume.  Then the greedy episode
    through the gymnasium-free core, counted: one ``ctf_step`` a frame
    after the first, uint8 frames.  Returns the readings."""
    from gym_multigrid_tpu_torch.utils.logging import read_metrics_csv

    per_iter = train_mvn_ctf_rl.parse_args([]).rollout_len
    walls, total = [], collections.Counter()
    for iters in (3, 1):
        args = train_mvn_ctf_rl.parse_args(["--iters", str(iters), "--out", out,
                                            "--no-tensorboard"])
        w0 = time.perf_counter()
        counts, (cfg, net, metrics) = run_counted(lambda: train_mvn_ctf_rl.train(args))
        walls.append(time.perf_counter() - w0)
        check_launches(counts, {"ctf_step": per_iter * iters}, f"train_mvn_ctf_rl, {iters} iters")
        total.update(counts)
        check(all(math.isfinite(metrics[k]) for k in ("loss", "pg_loss", "v_loss", "entropy")),
              f"train_mvn_ctf_rl losses {metrics}")
    steps = read_metrics_csv(os.path.join(out, "logs", "metrics.csv"))["step"]
    check(steps == [0.0, 1.0, 2.0, 3.0], f"train_mvn_ctf_rl step axis after the resume: {steps}")
    g_counts, frames = run_counted(lambda: train_mvn_ctf_rl.greedy_episode_frames(cfg, net))
    H, W = cfg.field_map.shape
    check(all(f.dtype == np.uint8 and f.shape == (H * 32, W * 32, 3) for f in frames),
          "greedy episode frames")
    check_launches(g_counts, {"ctf_step": len(frames) - 1}, "greedy CtF episode")
    log(f"train_mvn_ctf_rl: 3 iterations then 1 resumed, {per_iter} ctf_step launches an "
        f"iteration, step axis {steps}; host wall {[round(w, 2) for w in walls]} s (resume and "
        f"snapshot included); greedy episode {len(frames)} frames, {g_counts['ctf_step']} "
        f"ctf_step launches")
    return {"launches_an_iteration": per_unit(total, 3 + 1),
            "launches_a_frame": per_unit(g_counts, len(frames) - 1),
            "greedy_frames": len(frames), "host_wall_s": walls}


def reckon_ppo_peak(n, T, L, A, hidden):
    """Reckoned peak bytes of a ``make_ppo`` iteration over ``n`` envs with
    an int8 obs buffer of L-wide obs, A agents and the MLP's ``hidden``
    width (bf16): the larger of
    - the last rollout step: T buffer rows of L + 4A + 24 bytes an env
      (int8 obs, int32 actions, six float32 columns), three int32 obs of
      the batch (this step's, the step's and the next), and the two-batch
      forward's concatenated int32 input beside its largest pair of
      temporaries (the bf16 input with its scaled copy, or the bf16 input
      with a layer's product and its tanh);
    - the stack of the buffer: two copies;
    - the update: the buffer and its env-major blocks (obs, actions and
      three float32 columns)."""
    row = L + 4 * A + 24
    buf = T * n * row
    m = 2 * n
    forward = 4 * m * L + max(2 * 2 * m * L, 2 * m * L + 2 * 2 * m * hidden)
    last_step = buf + 3 * 4 * n * L + forward
    stack = 2 * buf + 4 * n * L
    update = buf + T * n * (L + 4 * A + 12)
    return max(last_step, stack, update)


def check_ppo_1m():
    """``bench_ppo_scale`` at its defaults, the JAX record's config (2**20
    CtF envs, rollout 16, 128 minibatches, 64 shuffle blocks, int8 obs
    buffer) with ``--profile``, counted: 16 ``ctf_step`` launches an
    iteration (one untimed, four timed, one timed as its rollout and update
    apart, one profiled) and no other kernel; finite losses, moved
    parameters; env-steps/s, the split, the profile's top kernels and idle
    share, and the peak memory beside the reckoned peak."""
    counts, rec = run_counted(lambda: bench_ppo_scale.main(["--profile"]))
    iters = 1 + 4 + 2
    check_launches(counts, {"ctf_step": rec["rollout_len"] * iters}, "1M-env PPO")
    check(rec["finite"] and rec["param_max_change"] > 0, f"1M-env PPO {rec}")
    env, cfg, _, _ = make_family_batch("ctf", 1, "cpu")
    L = int(env.reset(0)[1].shape[1])
    reckoned = reckon_ppo_peak(rec["envs"], rec["rollout_len"], L, cfg.num_blue_agents,
                               TRAIN_HIDDEN[0])
    log(f"1M-env PPO ({rec['envs']} envs, rollout {rec['rollout_len']}, "
        f"{rec['num_minibatches']} minibatches, {rec['shuffle_blocks']} shuffle blocks, "
        f"{rec['obs_buffer_dtype']} obs of {L}): {rec['env_steps_per_sec']} env-steps/s on "
        f"{rec['card']}; peak memory {rec['peak_memory_bytes']} bytes, reckoned "
        f"{reckoned}; losses {rec['losses']}; launches {counts}")
    prof = rec["profile"]
    log(f"1M-env PPO iteration: rollout {rec['split_s']['rollout']} s, update "
        f"{rec['split_s']['update']} s (CUDA events); profiled iteration: wall "
        f"{prof['wall_us']} us, device kernels {prof['device_us']} us, {prof['launches']} "
        f"launches, idle share {prof['idle_share']}")
    for key, dev_us, count in prof["kernels"]:
        log(f"  {dev_us:12.1f} us  {count:6d}x  {key[:100]}")
    return {"env_steps_per_sec": rec["env_steps_per_sec"], "split_s": rec["split_s"],
            "idle_share": prof["idle_share"],
            "peak_memory_bytes": rec["peak_memory_bytes"], "reckoned_peak_bytes": reckoned,
            "losses": rec["losses"], "launches_an_iteration": per_unit(counts, iters)}


def check_train_step_and_pod_model(out):
    """``measure_train_step`` at its defaults into ``out``, counted (32
    ``collect_step`` and 32 ``collect_reset`` a step, one untimed and five
    timed, and the reset of ``init_fn``), then the audit of the same config at world size 1 under NCCL
    (``audit_comm.audit``) and the pod model on the card's measurement and
    the audited train step's bytes."""
    counts, ts = run_counted(lambda: measure_train_step.main(["--out", out]))
    steps = 1 + 5
    per_step = ts["config"]["rollout_len"]
    check_launches(counts, {"collect_step": per_step * steps,
                            "collect_reset": per_step * steps + 1}, "measure_train_step")
    check(ts["train_step_s"] > 0 and ts["backend"] != "cpu", f"train step measurement {ts}")
    store = tempfile.mkdtemp(prefix="nccl_store_")
    distributed_initialize(backend="nccl", init_method=f"file://{os.path.join(store, 'store')}",
                           rank=0, world_size=1, device=DEV)
    try:
        cfg = ts["config"]
        audited = audit_comm.audit(make_mesh(), cfg["per_device_envs"], cfg["rollout_len"],
                                   cfg["num_minibatches"], cfg["num_epochs"])
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    nbytes = audited["train_step"]["bytes"]
    model = audit_comm.pod_model(nbytes, cfg["per_device_envs"], cfg["rollout_len"],
                                 audit_comm.read_measurement(out))
    check(all(0 < v["efficiency_no_overlap"] <= 1 for k, v in model.items()
              if k != "assumptions"), f"pod model {model}")
    log(f"measure_train_step: {ts['train_step_s']} s a train step (best of "
        f"{[round(t, 6) for t in ts['train_step_s_all']]}) at {ts['env_steps_per_train_step']} "
        f"env-steps on {ts['backend']}; launches {counts}; audited train step "
        f"{audited['train_step']['by_kind']}, {nbytes} bytes; pod model {json.dumps(model)}")
    # Less the one reset of init_fn.
    return {"train_step_s": ts["train_step_s"], "train_step_bytes": nbytes,
            "launches_a_step": per_unit(counts, steps, less={"collect_reset": 1}),
            "pod_model": {k: v["efficiency_no_overlap"] for k, v in model.items()
                          if k != "assumptions"}}


def check_soaks(out_dir):
    """``soak`` on each family at SOAK_WINDOWS windows (its default window
    of 400 steps and at least two seconds), counted: the episode kernels
    of every call and nothing else.  Returns the readings and each
    window's launches by kernel."""
    readings, window_launches = {}, collections.Counter()
    for family in FAMILIES:
        out = os.path.join(out_dir, f"soak_{family}_torch.json")
        counts, rec = run_counted(lambda: soak.main(
            ["--family", family, "--windows", str(SOAK_WINDOWS), "--out", out]))
        per_call = episode_call_launches(family, rec["steps_per_call"])
        calls = 3 + SOAK_WINDOWS * rec["calls_per_window"]  # warm-up, two to size a window
        check_launches(counts, times_launches(per_call, calls, family), f"{family} soak")
        # Less the Collect reset of reset(seed), over the calls, times a
        # window's calls.
        window_launches.update(per_unit(counts, calls, less={"collect_reset": 1},
                                        times=rec["calls_per_window"]))
        readings[family] = {"agent_steps_per_sec": rec["agent_steps_per_sec"],
                            "drift_pct": rec["drift_first_vs_last_third_pct"],
                            "calls_per_window": rec["calls_per_window"]}
        log(f"soak {family}: {rec['command']}; agent-steps/s {rec['agent_steps_per_sec']}; "
            f"drift {rec['drift_first_vs_last_third_pct']}%; windows {rec['windows']}")
    return readings, dict(window_launches)


def check_sweeps():
    """``sweep_batch`` on the four families at its default batches, steps
    and reps, each point counted: the episode kernels of its calls (one
    untimed, the timed reps) and nothing else.  Returns the rates by family
    and batch, and a point's launches by kernel."""
    rates, point_launches = {}, {}
    for family in FAMILIES:
        steps = align_steps(family, 200)
        for batch in (1024, 4096, 16384, 65536):
            counts, point = run_counted(lambda: sweep_batch.measure(family, batch, steps, 4, None))
            per_call = episode_call_launches(family, steps)
            want = times_launches(per_call, 1 + 4, family)
            check_launches(counts, want, f"{family} sweep at {batch}")
            check(point["agent_steps_per_sec"] > 0, f"sweep point {point}")
            rates.setdefault(family, {})[batch] = point["agent_steps_per_sec"]
            point_launches.update(per_unit(counts, 1))
            log(json.dumps(point))
    return rates, point_launches


def check_masked_ctf_reset(cfg, name, seed, n):
    """``ctf_slab.reset_batch`` under a done mask (plain PyTorch: the CtF
    reset has no kernel) at ``n`` rows on the card against the same on the
    CPU, from the same states, mask and uniforms: every field bit for bit.
    On the CPU, the rows not done keep their state and the done rows take
    the unmasked reset's."""
    cpu, card = ctf_slab.make_ctf_slab(cfg, "cpu"), ctf_slab.make_ctf_slab(cfg, DEV)
    gen = torch.Generator().manual_seed(seed)
    A, (s0, s1) = cfg.num_agents, cfg.field_map.shape
    states = CtfState(
        torch.stack([torch.randint(0, s0, (n, A), generator=gen, dtype=torch.int32),
                     torch.randint(0, s1, (n, A), generator=gen, dtype=torch.int32)], dim=2),
        torch.randint(0, 4, (n, A), generator=gen, dtype=torch.int32),
        torch.rand((n, A), generator=gen) < 0.1,
        torch.rand((n, A), generator=gen) < 0.1,
        torch.randint(0, cfg.max_steps, (n,), generator=gen, dtype=torch.int32),
    )
    done = torch.rand((n,), generator=gen) < 0.3
    rnd = torch.rand((n, cpu.reset_draws), generator=gen)
    want = ctf_slab.reset_batch(cpu, n, rnd=rnd, done=done, states=states)
    fresh = ctf_slab.reset_batch(cpu, n, rnd=rnd)
    for w, f, old in zip(*map(state_fields, (want, fresh, states))):
        check(torch.equal(w[done], f[done]) and torch.equal(w[~done], old[~done]),
              f"{name}: the masked CtF reset on the CPU")
    got = ctf_slab.reset_batch(card, n, rnd=rnd.to(DEV), done=done.to(DEV),
                               states=CtfState(*(x.to(DEV) for x in state_fields(states))))
    err = card_equals_cpu(state_fields(got), state_fields(want))
    log(f"masked CtF reset, card == CPU: {name} at B={n}, {int(done.sum())} rows reset, "
        f"max_abs_err {err}")
    return err


def check_large_batches():
    """The kernels of phase 6's largest paths against their plain versions
    at the batch those paths give them.  ``ctf_step`` at the 1M-env PPO
    run's PPO_ROWS on its config, 3 chained steps with done rows respawned,
    and that run's masked CtF reset at the same rows, card against CPU.
    At the sweeps' SWEEP_ROWS on their configs: each family's K-step
    kernel as launches of its episode path's chunk (CtF and Wildfire with
    max_steps cut to MS_CHECK_MAX_STEPS, so that every env resets within
    the check), and the Collect reset, masked and not.  Returns
    max_abs_err by (kernel, rows)."""
    _, ppo_cfg, _, _ = make_family_batch("ctf", 1, "cpu")
    cfgs = {family: family_cfg(family)[0] for family in FAMILIES}
    ms_cut = {f: dataclasses.replace(cfgs[f], max_steps=MS_CHECK_MAX_STEPS)
              for f in ("ctf", "wildfire")}
    n = SWEEP_ROWS
    return {
        ("ctf_step", PPO_ROWS): check_ctf_step_kernel(ppo_cfg, "1M-env PPO config", 3, seed=610,
                                                      n=PPO_ROWS),
        ("ctf_masked_reset", PPO_ROWS): check_masked_ctf_reset(ppo_cfg, "1M-env PPO config",
                                                               611, PPO_ROWS),
        ("collect_steps_philox", n): check_collect_steps_kernel(
            cfgs["collect"], "sweep config", seed=612, n=n, chunks=(CHUNKS["collect"],)),
        ("collect_reset", n): check_reset_kernel(cfgs["collect"], 613, n=n),
        ("ctf_steps", n): check_ctf_steps_kernel(ms_cut["ctf"], "sweep config", 614, n=n,
                                                 chunks=(CHUNKS["ctf"],)),
        ("maze_steps_philox", n): check_maze_philox_kernel(
            cfgs["maze"], "sweep config", 615, n=n, chunkings=((CHUNKS["maze"],),)),
        ("wf_steps_philox", n): check_wf_philox_kernel(ms_cut["wildfire"], "sweep config", 616,
                                                       n=n, chunks=(CHUNKS["wildfire"],)),
    }


def run_example_and_scripts_phase():
    """Phase 6: the worked example and the root scripts on the card; the
    scripts' files go to a temporary directory, removed at the end.
    Returns (the phase's readings, the launches of its paths by kernel,
    max_abs_err by (kernel, rows) at the paths' largest batches)."""
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase6_")
    try:
        large = check_large_batches()
        pursuit = check_pursuit()
        mvn = check_train_mvn_ctf_rl(os.path.join(tmp, "mvn"))
        ppo_1m = check_ppo_1m()
        train_step = check_train_step_and_pod_model(os.path.join(tmp, "train_step_time.json"))
        soaks, soak_launches = check_soaks(tmp)
        sweeps, sweep_launches = check_sweeps()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    readings = {"large_batch_max_abs_err": {f"{k}_b{rows}": e for (k, rows), e in large.items()},
                "pursuit": pursuit, "train_mvn_ctf_rl": mvn, "ppo_1m": ppo_1m,
                "measure_train_step": train_step, "soak": soaks, "sweep_batch": sweeps,
                "seconds": time.perf_counter() - t0}
    launches = {
        "train_mvn_ctf_rl_iteration": mvn["launches_an_iteration"],
        "greedy_episode_frame": mvn["launches_a_frame"],
        "ppo_1m_iteration": ppo_1m["launches_an_iteration"],
        "measure_train_step": train_step["launches_a_step"],
        "soak_window": soak_launches,
        "sweep_point": sweep_launches,
    }
    return readings, launches, large



# ---------------------------------------------------------------------------
# Phase 7: the bench entry points
# ---------------------------------------------------------------------------

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "device", "windows",
              "kernel_launches_per_call"}


def bench_call_launches(family, path, steps):
    """Launches of one ``steps``-step call of a bench path: the episode
    path's as ``episode_call_launches`` (Collect: one ``collect_steps_philox``
    a 25-step chunk); the step path's
    step kernel once a step and, for Collect, the masked reset once a
    step, for Wildfire the auto-reset kernel once a step."""
    if path == "episode":
        return episode_call_launches(family, steps)
    want = {VEC_FAMILIES[family][0]: steps}
    if family == "collect":
        want["collect_reset"] = steps
    if family == "wildfire":
        want["wf_autoreset"] = steps
    return want


def run_script(args, timeout):
    """``python -m gym_multigrid_tpu_torch.scripts.<args>`` from the
    checkout: it must exit 0.  Returns its stdout and wall seconds."""
    t0 = time.perf_counter()
    # A process group of its own, so that a timeout also stops bench_all's
    # family processes.
    proc = subprocess.Popen(
        [sys.executable, "-m", f"gym_multigrid_tpu_torch.scripts.{args[0]}", *args[1:]],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, start_new_session=True,
        cwd=Path(__file__).resolve().parent,
    )
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    seconds = time.perf_counter() - t0
    what = " ".join(args)
    check(proc.returncode == 0,
          f"{what}: exit {proc.returncode}\n{stdout[-3000:]}\n{stderr[-3000:]}")
    log(f"{what}: {seconds:.1f} s")
    return stdout, seconds


def run_bench(args, timeout):
    """``run_script``, whose stdout must be JSON lines only.  Returns the
    lines and the process's wall seconds."""
    stdout, seconds = run_script(args, timeout)
    out = stdout.strip().splitlines()
    check(all(ln.startswith("{") for ln in out),
          f"{' '.join(args)}: stdout not all JSON lines: {out}")
    log(f"{' '.join(args)}: {len(out)} lines")
    return [json.loads(ln) for ln in out], seconds


def check_bench_line(rec, metric, baseline, want, card):
    """One bench line: every key, finite positive value and windows, the
    value the best window, vs_baseline from the value, the card named with
    its power limit, and the path's launches a call."""
    check(set(rec) == BENCH_KEYS, f"{metric}: keys {sorted(rec)}")
    windows = rec["windows"]
    check(len(windows) == 3 and all(math.isfinite(w) and w > 0 for w in windows),
          f"{metric}: windows {windows}")
    check(rec["metric"] == metric and rec["unit"] == "agent-steps/s", f"{metric}: {rec}")
    check(math.isfinite(rec["value"]) and rec["value"] > 0
          and rec["value"] == round(max(windows), 1), f"{metric}: value {rec['value']}")
    check(rec["vs_baseline"] == round(rec["value"] / baseline, 2),
          f"{metric}: vs_baseline {rec['vs_baseline']}")
    check(rec["device"] == card, f"{metric}: device {rec['device']!r}, the card is {card!r}")
    check(rec["kernel_launches_per_call"] == want,
          f"{metric}: launches a call {rec['kernel_launches_per_call']}, expected {want}")
    log(json.dumps(rec))


def run_bench_phase():
    """Phase 7: ``bench``, ``bench_all --all-paths`` (each family in its
    own process) and ``bench_all --families ctf --partial-obs VIEW``, each
    a process of its own, every line checked.  Returns (each line's value
    and windows by label, the launches a call by kernel and label, the
    phase's seconds)."""
    t0 = time.perf_counter()
    card = profiling.card_label(DEV)
    readings, launches = {}, collections.defaultdict(dict)

    def expect(label, rec, metric, family, path, steps):
        want = bench_call_launches(family, path, steps)
        check_bench_line(rec, metric, BASELINES[family], want, card)
        readings[label] = {"value": rec["value"], "windows": rec["windows"]}
        for name, n in rec["kernel_launches_per_call"].items():
            launches[name][label] = n

    lines, seconds = run_bench(["bench"], timeout=300)
    check(len(lines) == 1, f"bench printed {len(lines)} lines, not one")
    expect("bench", lines[0], f"agent-steps/sec/chip (Collect, batch {B})", "collect",
           "episode", STEPS_PER_CALL)
    readings["bench_seconds"] = seconds
    lines, seconds = run_bench(["bench_all", "--all-paths"], timeout=900)
    by_metric = {rec["metric"]: rec for rec in lines}
    check(len(by_metric) == len(lines) == 2 * len(FAMILIES), f"bench_all lines {lines}")
    for family in FAMILIES:
        for path in ("episode", "step"):
            metric = f"agent-steps/sec/chip ({family}, batch {B}, {path}, cuda)"
            check(metric in by_metric, f"bench_all: no line {metric!r}")
            expect(f"{family} {path}", by_metric[metric], metric, family, path,
                   MS_STEPS[family])
    readings["bench_all_seconds"] = seconds
    lines, seconds = run_bench(["bench_all", "--families", "ctf", "--partial-obs", str(VIEW)],
                               timeout=300)
    check(len(lines) == 1, f"bench_all --partial-obs printed {len(lines)} lines, not one")
    expect(f"ctf step pov{VIEW}", lines[0],
           f"agent-steps/sec/chip (ctf, batch {B}, step, pov{VIEW}, cuda)", "ctf", "step",
           MS_STEPS["ctf"])
    readings["bench_all_pov_seconds"] = seconds
    seconds = time.perf_counter() - t0
    log(f"phase 7 (the bench entry points): {seconds:.1f} s")
    return readings, dict(launches), seconds


# ---------------------------------------------------------------------------
# Phase 8: the learner's roofline
# ---------------------------------------------------------------------------

#: Train steps of one ``profile_ppo`` run: one untimed, ``--iters`` (4)
#: timed and one traced.
PROFILE_PPO_STEPS = 1 + 4 + 1


def closed_form_flops(rec):
    """(model, executed) FLOPs of a CtF train step at ``rec``'s envs B and
    rollout length T, from a full-width net's own parameters: a sample's
    forward is ``2 * sum(weight.numel())`` over its dense layers; at E
    epochs (``PPOConfig``'s default) JAX's count is ``B (1 + T + 3TE)``
    forwards, the port's executed count ``B (1 + 2T + 3TE)``."""
    env, _, n_actions, agents = make_family_batch("ctf", 1, "cpu")
    net = full_width_net(env, n_actions, agents)
    fwd = 2 * sum(p.numel() for name, p in net.named_parameters() if name.endswith("weight"))
    B, T, E = rec["envs"], rec["rollout_len"], PPOConfig().num_epochs
    return B * (1 + T + 3 * T * E) * fwd, B * (1 + 2 * T + 3 * T * E) * fwd


def check_roofline(rec, what, card):
    """One ``profile_ppo`` record: both FLOP counts equal their closed
    forms, a model rate and a share of the dense bf16 peak in (0, 1], the
    card named with its power limit, a device profile whose classes' shares
    sum to 1, a binding resource.  Logs it; returns its readings."""
    model, executed = closed_form_flops(rec)
    check(rec["model_flops_per_train_step"] == model,
          f"{what}: model FLOPs {rec['model_flops_per_train_step']}, closed form {model}")
    check(rec["executed_model_flops_per_train_step"] == executed,
          f"{what}: executed FLOPs {rec['executed_model_flops_per_train_step']}, closed form "
          f"{executed}")
    mfu, tflops = rec["mfu_vs_bf16_dense_peak"], rec["achieved_model_tflops_per_s"]
    check(mfu is not None and 0 < mfu <= 1 and math.isfinite(tflops) and tflops > 0,
          f"{what}: {tflops} TFLOP/s, share {mfu}")
    check(rec["device"] == card, f"{what}: device {rec['device']!r}, the card is {card!r}")
    prof = rec["observed_profile"]
    check(prof["device"] == "cuda" and abs(sum(prof["by_class"].values()) - 1) <= 1e-6,
          f"{what}: profile {prof['device']}, by_class {prof.get('by_class')}")
    check(isinstance(rec["binding_resource"], str) and rec["binding_resource"] != "",
          f"{what}: binding resource {rec['binding_resource']!r}")
    log(f"{what} ({rec['envs']} envs, rollout {rec['rollout_len']}, {rec['num_minibatches']} "
        f"minibatches, shuffle blocks {rec['shuffle_blocks']}) on {rec['device']}: "
        f"{rec['train_step_s']} s a train step, {rec['env_steps_per_s']} env-steps/s; model "
        f"{rec['model_flops_per_train_step']} FLOPs (executed "
        f"{rec['executed_model_flops_per_train_step']}), {tflops} TFLOP/s, {mfu} of the "
        f"dense bf16 peak; obs buffer {rec['rollout_obs_buffer_gb']} GB; profiled step: wall "
        f"{prof['wall_us']} us, device {prof['device_us']} us, {prof['launches']} launches, "
        f"idle {prof['idle_share']}, by class {prof['by_class']}; {rec['binding_resource']}")
    for key, dev_us, count in prof["kernels"]:
        log(f"  {dev_us:12.1f} us  {count:6d}x  {key[:100]}")
    for key, host_us, count in prof["host_ops"]:
        log(f"  host {host_us:12.1f} us  {count:6d}x  {key[:90]}")
    return {k: rec[k] for k in ("envs", "rollout_len", "train_step_s", "env_steps_per_s",
                                "model_flops_per_train_step",
                                "executed_model_flops_per_train_step",
                                "achieved_model_tflops_per_s", "mfu_vs_bf16_dense_peak",
                                "rollout_obs_buffer_gb", "binding_resource")} | {
        "idle_share": prof["idle_share"], "by_class": prof["by_class"]}


def run_roofline_phase():
    """Phase 8: ``profile_ppo`` at the ``bench_scale`` point in this
    process, counted (``ctf_step`` once a rollout step of each of its
    train steps, no other kernel), then ``sol_record --families ctf`` as a
    process, whose file must hold both PPO points; every record checked by
    ``check_roofline``.  Returns (the readings, ``ctf_step``'s launches in
    the counted run, the phase's seconds)."""
    t0 = time.perf_counter()
    card = profiling.card_label(DEV)
    tmp = tempfile.mkdtemp(prefix="phase8_")
    try:
        argv = [*sol_record.PPO_POINTS["bench_scale"], "--trace", os.path.join(tmp, "trace"),
                "--json"]
        counts, rec = run_counted(lambda: profile_ppo.main(argv))
        check_launches(counts, {"ctf_step": rec["rollout_len"] * PROFILE_PPO_STEPS},
                       "profile_ppo bench_scale")
        readings = {"profile_ppo_bench_scale": check_roofline(
            rec, "profile_ppo bench_scale, in this process", card)}
        readings["profile_ppo_bench_scale"]["launches_a_train_step"] = per_unit(
            counts, PROFILE_PPO_STEPS)
        out = os.path.join(tmp, "sol_report_torch.json")
        stdout, readings["sol_record_seconds"] = run_script(
            ["sol_record", "--families", "ctf", "--out", out], timeout=600)
        log(stdout.strip())
        with open(out) as f:
            points = json.load(f).get("ppo_train", {})
        check(set(points) == set(sol_record.PPO_POINTS),
              f"sol_record: PPO points {sorted(points)}, expected {sorted(sol_record.PPO_POINTS)}")
        for name, point in points.items():
            readings[f"sol_record_{name}"] = check_roofline(point, f"sol_record ppo {name}", card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t0
    log(f"phase 8 (the learner's roofline): {seconds:.1f} s")
    return readings, counts["ctf_step"], seconds

def main():
    # Phase 1: build.
    t0 = time.perf_counter()
    logs = _build.build()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(logs)} sources")
    for source, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "entry function" in line:
                log(f"  {source}: {line.strip()}")
    for cfg in (WF_FOUR, WF_MAIN, WF_SPREAD):  # the Wildfire ring's dynamic shared memory
        C = cfg.size * cfg.size
        log(f"  wildfire_step.cu: {cfg.size}x{cfg.size}: tiles of {wildfire_slab.tile_envs(C)} "
            f"envs, ring {wildfire_slab.ring_bytes(C)} bytes of dynamic shared memory a block")

    # Phase 2: kernels against their plain versions on the card.
    step_err = max(
        check_step_kernel(MAIN, 100, seed=1),
        check_step_kernel(SINGLE, 100, seed=2),
        check_step_kernel(QUADRANTS15, 100, seed=3),
    )
    reset_err = max(
        check_reset_kernel(CollectConfig(layout=layout), seed=10 + i)
        for i, layout in enumerate(("even", "quadrants", "rooms", "quadrants_respawn"))
    )
    reset_err = max(reset_err, check_reset_kernel(QUADRANTS15, seed=20),
                    # Ragged batches: 8189 and 5 are no multiple of a block's 64 envs.
                    check_reset_kernel(MAIN, seed=21, n=RAGGED[0]),
                    check_reset_kernel(QUADRANTS15, seed=22, n=RAGGED[1]))
    check_any_agent_route(THREE, 60, seed=23)
    check_partial_encodes(seed=24)
    check_step_actions(CTF_MAIN, "CTF_MAIN", 60, seed=25)
    check_step_actions(CTF_PATROL, "2v2 patrol, obstacle penalty", 60, seed=26)
    per_env_err = check_per_env_functions(seed=27)
    host_err = check_host_policy_path(seed=28)
    for i, (name, make, cfg) in enumerate((
            ("Collect", make_collect_batch, MAIN), ("CtF", make_ctf_batch, CTF_MAIN),
            ("Maze", make_maze_batch, MAZE_MAIN), ("Wildfire", make_wildfire_batch, WF_MAIN))):
        check_next_step(name, make, cfg, seed=90 + i)

    ctf_err = max(
        check_ctf_step_kernel(CTF_MAIN, "CTF_MAIN", 100, seed=30),
        check_ctf_step_kernel(CTF_PATROL, "2v2 patrol/patrol_fight, obstacle penalty", 100, seed=31),
        check_ctf_step_kernel(CTF_1V1, "1v1 fight, obstacle penalty", 100, seed=32),
        check_ctf_step_kernel(CTF_3V3, "3v3 capture/patrol/rw", 100, seed=33),
        # Ragged batches: 8189 and 5 are no multiple of the lane group's
        # envs per warp or block.
        check_ctf_step_kernel(CTF_MAIN, "CTF_MAIN, ragged", 10, seed=34, n=RAGGED[0]),
        check_ctf_step_kernel(CTF_3V3, "3v3, ragged", 10, seed=35, n=RAGGED[0]),
        check_ctf_step_kernel(CTF_PATROL, "2v2 patrol, ragged", 10, seed=36, n=RAGGED[1],
                              need_events=False),
        check_ctf_step_kernel(CTF_1V1, "1v1, ragged", 10, seed=37, n=RAGGED[1],
                              need_events=False),
    )
    maze_err = max(
        check_maze_step_kernel(MAZE_MAIN, "MAZE_MAIN", 100, seed=40),
        check_maze_step_kernel(MAZE_PENALTY, "MAZE_MAIN map, obstacle penalty 0.5", 100, seed=41),
    )
    # The Maze K-step entry, its draws made and its sums kept in the
    # kernel, against ms_philox_spec: both configs at B = 8192, 8189 and 5
    # (no multiple of a block's 64 envs); then the episode rollout, card
    # against CPU.
    maze_ms_err = max(
        check_maze_philox_kernel(cfg, name, seed=42 + 3 * i + j, n=n)
        for i, (cfg, name) in enumerate((
            (MAZE_MAIN, "MAZE_MAIN"), (MAZE_PENALTY, "MAZE_MAIN map, obstacle penalty 0.5")))
        for j, n in enumerate((B, *RAGGED))
    )
    maze_ms_err = max(maze_ms_err, check_maze_rollout_card_equals_cpu(seed=48))
    wf_err = max(
        check_wildfire_step_kernel(WF_MAIN, "WF_MAIN", 100, seed=50),
        check_wildfire_step_kernel(WF_FOUR, "10x10, 4 agents, step penalty", 100, seed=51),
        check_wildfire_step_kernel(WF_SPREAD, "32x32, p_spread 1, p_burnout 0", 100, seed=52),
        check_wildfire_stacked(seed=53),
        # Ragged batches: 8189 leaves a tail of 5 envs after 1023 full
        # tiles of 8 (32x32: 2047 tiles of 4 and a tail of 1); 5 is a tail
        # and no full tile at 16x16, and one tile and a tail of 1 at 32x32.
        check_wildfire_step_kernel(WF_MAIN, "WF_MAIN, ragged", 10, seed=54, n=RAGGED[0]),
        check_wildfire_step_kernel(WF_SPREAD, "32x32 spread, ragged", 10, seed=55, n=RAGGED[0]),
        check_wildfire_step_kernel(WF_MAIN, "WF_MAIN, ragged", 10, seed=56, n=RAGGED[1],
                                   need_events=False),
        check_wildfire_step_kernel(WF_SPREAD, "32x32 spread, ragged", 10, seed=57, n=RAGGED[1],
                                   need_events=False),
    )
    check_misaligned_refused()
    # The auto-reset kernel after the step (BatchedEnv.step's Wildfire
    # path): the three configs at B = 8192, WF_MAIN also at 8189 and 5
    # (a block holds 4 envs).
    wf_ar_err = max(
        check_wf_autoreset_kernel(cfg, name, seed=58 + i, n=n)
        for i, (cfg, name, n) in enumerate((
            (WF_MAIN, "WF_MAIN", B), (WF_MAIN, "WF_MAIN, ragged", RAGGED[0]),
            (WF_MAIN, "WF_MAIN, ragged", RAGGED[1]),
            (WF_FOUR, "10x10, 4 agents, step penalty", B),
            (WF_SPREAD, "32x32, p_spread 1, p_burnout 0", B)))
    )
    ctf_ms_err = max(
        check_ctf_steps_kernel(dataclasses.replace(cfg, max_steps=MS_CHECK_MAX_STEPS), name,
                               seed=70 + i, n=n, chunks=chunks)
        for i, (cfg, name, n, chunks) in enumerate((
            (CTF_MAIN, "CTF_MAIN", B, CTF_MS_CHUNKS),
            (CTF_PATROL, "2v2 patrol/patrol_fight, obstacle penalty", B, CTF_MS_CHUNKS),
            (CTF_1V1, "1v1 fight, obstacle penalty", B, CTF_MS_CHUNKS),
            (CTF_3V3, "3v3 capture/patrol/rw", B, CTF_MS_CHUNKS),
            # Ragged batches: no multiple of a block's 32 envs.
            (CTF_MAIN, "CTF_MAIN, ragged", RAGGED[0], CTF_MS_CHUNKS),
            (CTF_3V3, "3v3, ragged", RAGGED[0], CTF_MS_CHUNKS),
            (CTF_PATROL, "2v2 patrol, ragged", RAGGED[1], CTF_MS_CHUNKS),
            (CTF_1V1, "1v1, ragged", RAGGED[1], CTF_MS_CHUNKS),
            # Agents off the board (the swapped bounds) and spawns the moves
            # cannot reach; then launches of one step.
            (CTF_NON_SQUARE, "non-square 10x7 patrol_fight/fight", B, CTF_MS_CHUNKS),
            (CTF_MAIN, "CTF_MAIN, launches of 1", B, (1,)),
        ))
    )
    # The Wildfire K-step entry, its draws made in the kernel, against
    # ms_philox_spec on the counters' draws: the three configs at B = 8192,
    # 8189 and 5 (no multiple of a block's envs: 8, or 4 at 32x32).
    wf_px_err = max(
        check_wf_philox_kernel(dataclasses.replace(cfg, max_steps=MS_CHECK_MAX_STEPS), name,
                               seed=110 + 3 * i + j, n=n)
        for i, (cfg, name) in enumerate((
            (WF_MAIN, "WF_MAIN"), (WF_FOUR, "10x10, 4 agents, step penalty"),
            (WF_SPREAD, "32x32, p_spread 1, p_burnout 0")))
        for j, n in enumerate((B, *RAGGED))
    )
    wf_px_err = max(wf_px_err, check_wildfire_rollout_card_equals_cpu(seed=120))
    out_err = check_out_of_envelope(seed=130)
    # The Collect K-step entry, its draws and resets made in the kernel:
    # five configs at B = 8192 and the ragged batches (no multiple of a
    # block's 64 envs); then the episode rollout, card against CPU.
    collect_ms_err = max(
        check_collect_steps_kernel(cfg, name, seed=140 + 3 * i + j, n=n)
        for i, (cfg, name) in enumerate((
            (MAIN, "main"), (SINGLE, "one agent"), (FIXED, "fixed_horizon"),
            (BOARD16, "16x16"), (TYPES17, "17 ball types")))
        for j, n in enumerate((B, *RAGGED))
    )
    collect_ms_err = max(collect_ms_err, check_collect_rollout_card_equals_cpu(seed=160))

    # Phase 3: each path, with the launch counts of its own run.
    launches, (env, *result) = run_counted(collect_main_path)
    check_launches(launches, {"collect_step": STEPS_PER_CALL,
                              "collect_reset": STEPS_PER_CALL + 1}, "Collect")
    states = check_collect_path(env, *result)
    states = time_rollout(env.rollout, "CollectSlab", states, STEPS_PER_CALL, MAIN.num_agents,
                          COLLECT_WARMUP_MAX)

    slab, C, A = env.slab, MAIN.num_cells, MAIN.num_agents
    pos = states.agent_pos.reshape(B, -1)
    acts = torch.randint(0, 4, (B, A), device=DEV, dtype=torch.int32)
    rnd3 = torch.rand((B, 3), device=DEV)
    step_args = (slab.t, states.grid_obj, states.grid_color, states.grid_slot,
                 pos, acts, rnd3, slab.respawn_rects)
    step_ms, step_all = time_ms(lambda: collect_step_slab(*step_args), 200)
    step_plain_ms, step_plain_all = time_ms(lambda: step_spec(*step_args), 20)
    step_bytes = sum(x.numel() * x.element_size() for x in step_args[1:]) + (
        3 * B * C * 4 + B * 2 * A * 4 + B * A * 4)
    # This call's data: a respawn pick for each pickup.
    respawns = int((collect_step_slab(*step_args)[4] >= 0).sum()) if MAIN.respawn else 0
    step_ops = B * A * MOVE_OPS + pick_ops(respawns, C)
    step_bound, step_by, *step_parts = bound(step_bytes, step_ops)

    ra = slab.reset_arrays
    rnd_r = torch.rand((B, slab.reset_draws), device=DEV)
    reset_ms, reset_all = time_ms(lambda: collect_reset_slab(slab.rt, rnd_r, ra), 200)
    reset_plain_ms, reset_plain_all = time_ms(
        lambda: reset_spec(slab.rt, ra.wall, ra.ball_rects, rnd_r), 20)
    none_done = torch.zeros((B,), dtype=torch.bool, device=DEV)
    out = collect_reset_slab(slab.rt, rnd_r, ra)
    masked_ms, masked_all = time_ms(
        lambda: collect_reset_slab(slab.rt, rnd_r, ra, done=none_done, out=out), 200)
    reset_bytes = sum(x.numel() * x.element_size() for x in (rnd_r, ra.words, ra.program)) + (
        3 * B * C * 4 + B * 2 * A * 4)
    # Every ball is a masked pick; agents are one only when placed uniformly.
    uniform_agents = 0 if slab.rt.agent_fixed or slab.rt.agent_choice else A
    n_balls = len(slab.rt.ball_colors)
    reset_ops = (pick_ops(B * (n_balls + uniform_agents), C)
                 + B * (A - uniform_agents) * MOVE_OPS)
    reset_bound, reset_by, *reset_parts = bound(reset_bytes, reset_ops)
    log(f"collect_step: {step_ms * 1e3:.2f} us/launch (median of windows {us(step_all)}), "
        f"bound {step_bound * 1e3:.2f} us ({step_by}; {step_bytes} bytes take "
        f"{step_parts[0] * 1e3:.2f} us, {step_ops} operations ({respawns} respawns) "
        f"{step_parts[1] * 1e3:.2f} us), step_spec {step_plain_ms * 1e3:.1f} us "
        f"{us(step_plain_all)}")
    # The masked launch with no row done reads the done mask and writes nothing.
    masked_bound, masked_by, *_ = bound(none_done.numel(), B)
    log(f"collect_reset: {reset_ms * 1e3:.2f} us/launch, all rows {us(reset_all)}; "
        f"{masked_ms * 1e3:.2f} us/launch with the done mask and no row done "
        f"{us(masked_all)} (bound {masked_bound * 1e3:.4f} us, {masked_by}: {B} bytes of "
        f"the mask); all rows bound {reset_bound * 1e3:.2f} us ({reset_by}; "
        f"{reset_bytes} bytes take {reset_parts[0] * 1e3:.2f} us, {reset_ops} operations "
        f"{reset_parts[1] * 1e3:.2f} us), reset_spec {reset_plain_ms * 1e3:.1f} us "
        f"{us(reset_plain_all)}")

    # The CtF path.
    ctf_launches, (ctf_env, *ctf_result) = run_counted(ctf_main_path)
    check_launches(ctf_launches, {"ctf_step": CTF_STEPS_PER_CALL}, "CtF")
    check_ctf_path(ctf_env, *ctf_result)
    ctf_states = ctf_result[2]
    ctf_states = time_rollout(ctf_env.rollout, "CtfSlab", ctf_states, CTF_STEPS_PER_CALL,
                              CTF_MAIN.num_agents, CTF_WARMUP_MAX)

    cslab = ctf_env.slab
    ba = torch.randint(0, 5, (B, CTF_MAIN.num_blue_agents), device=DEV, dtype=torch.int32)
    rnd_c = torch.rand((B, cslab.step_draws), device=DEV)
    ctf_args = ctf_step_args(cslab, ctf_states, ba, rnd_c)
    ctf_ms, ctf_all = time_ms(lambda: ctf_step_slab(*ctf_args), 200)
    ctf_plain_ms, ctf_plain_all = time_ms(lambda: ctf_slab.step_spec_bool(*ctf_args), 20)
    ctf_out = ctf_step_slab(*ctf_args)
    ctf_bytes = sum(x.numel() * x.element_size() for x in ctf_args[1:]) + sum(
        x.numel() * x.element_size() for x in ctf_out)
    ctf_ops = ctf_step_ops(cslab.t, cslab.border.shape[1])
    ctf_bound, ctf_by, *ctf_parts = bound(ctf_bytes, ctf_ops)
    rnd_reset = torch.rand((B, cslab.reset_draws), device=DEV)
    ctf_reset_ms, ctf_reset_all = time_ms(
        lambda: ctf_slab.reset_spec(cslab.t, rnd_reset, cslab.bterr, cslab.rterr), 20)
    log(f"ctf_step: {ctf_ms * 1e3:.2f} us/launch (median of windows {us(ctf_all)}), "
        f"bound {ctf_bound * 1e3:.2f} us ({ctf_by}; {ctf_bytes} bytes take "
        f"{ctf_parts[0] * 1e3:.2f} us, {ctf_ops} operations {ctf_parts[1] * 1e3:.2f} us), "
        f"step_spec {ctf_plain_ms * 1e3:.1f} us {us(ctf_plain_all)}; "
        f"ctf reset_spec (plain PyTorch, no kernel) {ctf_reset_ms * 1e3:.1f} us "
        f"{us(ctf_reset_all)}")

    # The Maze path.
    maze_launches, (maze_env, *maze_result) = run_counted(maze_main_path)
    check_launches(maze_launches, {"maze_step": MAZE_STEPS_PER_CALL}, "Maze")
    check_maze_path(maze_env, *maze_result)
    maze_states = time_rollout(maze_env.rollout, "MazeSlab", maze_result[2], MAZE_STEPS_PER_CALL, 1,
                               MAZE_WARMUP_MAX)

    mslab = maze_env.slab
    gen = torch.Generator(device=DEV).manual_seed(60)
    maze_args = (mslab.t, maze_states.pos, maze_states.dir.reshape(B, 1), maze_actions(gen),
                 mslab.cells)
    maze_ms, maze_all = time_ms(lambda: maze_step_slab(*maze_args, mslab.ms_table), 200)
    maze_plain_ms, maze_plain_all = time_ms(lambda: maze_slab.step_spec(*maze_args), 20)
    # The plain version's inputs and the outputs (the kernel reads two
    # table entries an env in place of the cell rows).
    maze_bytes = sum(x.numel() * x.element_size() for x in maze_args[1:]) + sum(
        x.numel() * x.element_size() for x in maze_step_slab(*maze_args, mslab.ms_table))
    maze_bound, maze_by, *maze_parts = bound(maze_bytes, B * MAZE_OPS)
    maze_reset_ms, maze_reset_all = time_ms(
        lambda: maze_slab.reset_batch(mslab, B, generator=gen, done=none_done,
                                      states=maze_states), 20)
    log(f"maze_step: {maze_ms * 1e3:.2f} us/launch (median of windows {us(maze_all)}), "
        f"bound {maze_bound * 1e3:.2f} us ({maze_by}; {maze_bytes} bytes take "
        f"{maze_parts[0] * 1e3:.2f} us, {B * MAZE_OPS} operations {maze_parts[1] * 1e3:.2f} us), "
        f"step_spec {maze_plain_ms * 1e3:.1f} us {us(maze_plain_all)}; "
        f"the rollout's masked reset_batch (plain PyTorch, no kernel) "
        f"{maze_reset_ms * 1e3:.1f} us {us(maze_reset_all)}")

    # The Wildfire path.
    wf_launches, (wf_env, *wf_result) = run_counted(wildfire_main_path)
    check_launches(wf_launches, {"wildfire_step": WF_STEPS_PER_CALL,
                                 "wf_autoreset": WF_STEPS_PER_CALL}, "Wildfire")
    check_wildfire_path(wf_env, *wf_result)
    wf_states = time_rollout(wf_env.rollout, "WildfireSlab", wf_result[2], WF_STEPS_PER_CALL,
                             WF_MAIN.num_agents, WF_WARMUP_MAX)

    wslab = wf_env.slab
    wt = wslab.t
    w_acts = torch.randint(0, 5, (B, wt.n_agents), generator=gen, device=DEV, dtype=torch.int32)
    w_rnd = torch.rand((B, wslab.step_draws), generator=gen, device=DEV)
    wf_args = wildfire_args(wslab, wf_states, w_acts, w_rnd)
    wf_ms, wf_all = time_ms(lambda: wildfire_step_slab(*wf_args), 200)
    wf_plain_ms, wf_plain_all = time_ms(lambda: wildfire_slab.step_spec(*wf_args), 20)
    wf_bytes = sum(x.numel() * x.element_size() for x in wf_args[1:]) + sum(
        x.numel() * x.element_size() for x in wildfire_step_slab(*wf_args))
    A = wt.n_agents
    wf_ops = B * (wt.n_cells * (WF_CELL_OPS + A) + 8 + A * (MOVE_OPS + 2 * A))
    wf_bound, wf_by, *wf_parts = bound(wf_bytes, wf_ops)
    wf_reset_ms, wf_reset_all = time_ms(
        lambda: wildfire_slab.reset_batch(wslab, B, generator=gen, done=none_done,
                                          states=wf_states), 20)
    log(f"wildfire_step: {wf_ms * 1e3:.2f} us/launch (median of windows {us(wf_all)}), "
        f"bound {wf_bound * 1e3:.2f} us ({wf_by}; {wf_bytes} bytes take "
        f"{wf_parts[0] * 1e3:.2f} us, {wf_ops} operations {wf_parts[1] * 1e3:.2f} us), "
        f"step_spec {wf_plain_ms * 1e3:.1f} us {us(wf_plain_all)}; "
        f"the masked reset_batch (plain PyTorch, {wslab.reset_draws} uniforms an env, "
        f"now on the old glue's paths only) {wf_reset_ms * 1e3:.1f} us {us(wf_reset_all)}")
    # The auto-reset kernel after the step, on the rollout's states (their
    # counts spread over the episode) at B, and eight copies of them at the
    # benchmark's 65,536 envs.
    wf_big = WildfireState(*(x.repeat(AUTORESET_BIG // B, *[1] * (x.dim() - 1)) for x in (
        wf_states.cells, wf_states.agent_pos, wf_states.step_count, wf_states.extinguished)))
    ar = {n: time_autoreset(wslab, s, gen) for n, s in ((B, wf_states), (AUTORESET_BIG, wf_big))}

    # The Collect episode path: one collect_steps_philox launch a chunk,
    # the reset's collect_reset, no collect_step.
    ce_launches, (ce_roll, *ce_result) = run_counted(collect_episode_path)
    check_launches(ce_launches, {"collect_steps_philox": STEPS_PER_CALL // COLLECT_CHUNK,
                                 "collect_reset": 1}, "Collect episode")
    ce_states = check_collect_episode_path(ce_roll, *ce_result)
    ce_states = time_rollout(ce_roll, "Collect episode", ce_states, STEPS_PER_CALL,
                             MAIN.num_agents, COLLECT_WARMUP_MAX)
    # collect_steps_philox on the episode path's states at its next step,
    # two COLLECT_CHUNK-step launches a timed call as the path runs them:
    # the first inside an episode, the second ending it with a fresh board.
    cslab_e, A, C = ce_roll.slab, MAIN.num_agents, MAIN.num_cells
    cst_args = (collect_slab.pack_planes(ce_states.grid_obj, ce_states.grid_color,
                                         ce_states.grid_slot),
                ce_states.agent_pos.reshape(B, -1), torch.zeros((B, A), device=DEV))
    cst_key, cst_step = ce_roll.key, ce_roll.step

    def cst_pair(steps=collect_philox_slab):
        return [steps(cslab_e, COLLECT_CHUNK, *cst_args, cst_key, cst_step + k0)
                for k0 in (0, COLLECT_CHUNK)]

    cst_ms, cst_all = time_ms(cst_pair, 100)
    cst_plain_ms, cst_plain_all = time_ms(lambda: cst_pair(collect_slab.ms_philox_spec), 1,
                                          windows=3)
    cst_ms, cst_plain_ms = cst_ms / 2, cst_plain_ms / 2
    cst_all, cst_plain_all = [t / 2 for t in cst_all], [t / 2 for t in cst_plain_all]
    # What the pair's data needs, counted by the plain version on the same
    # launches: the pickups (each bumps one info counter and, on a respawn
    # config, makes a respawn pick) and one fresh board an env.
    cst_counts = torch.zeros((B, A * cslab_e.info_ids.shape[0]), dtype=torch.int32, device=DEV)
    cst_pair(functools.partial(collect_slab.ms_philox_spec, counts=cst_counts))
    cst_picks = int(cst_counts.sum())
    cst_out = collect_philox_slab(cslab_e, COLLECT_CHUNK, *cst_args, cst_key, cst_step)
    tables = (cslab_e.respawn_words, cslab_e.reset_arrays.words, cslab_e.reset_arrays.program,
              cslab_e.slot_rewards)
    cst_bytes = sum(x.numel() * x.element_size() for x in (*cst_args, *tables, *cst_out))
    n_u = cslab_e.reset_draws
    cst_ops = (2 * COLLECT_CHUNK * B * (A * MOVE_OPS + 2 * PHILOX_CALL_OPS
                                        + (A + 3) * PHILOX_WORD_OPS)
               + cst_picks * PICKUP_OPS
               + (pick_ops(cst_picks, C) if MAIN.respawn else 0)
               + B * (-(-n_u // 4) * PHILOX_CALL_OPS + n_u * PHILOX_WORD_OPS + C
                      + pick_ops(len(cslab_e.rt.ball_colors), C) + A * MOVE_OPS)) / 2
    cst_bound, cst_by, *cst_parts = bound(cst_bytes, cst_ops)
    log(f"collect_steps_philox: {cst_ms * 1e3:.2f} "
        f"us/launch of {COLLECT_CHUNK} steps (median of windows {us(cst_all)}; half of a pair, "
        f"one ending an episode), {cst_ms * 1e3 / COLLECT_CHUNK:.4f} us a step against "
        f"collect_step's {step_ms * 1e3:.2f}; bound {cst_bound * 1e3:.2f} us ({cst_by}; "
        f"{cst_bytes} bytes take {cst_parts[0] * 1e3:.2f} us, {cst_ops:.0f} operations "
        f"({cst_picks / 2:.0f} pickups a launch) {cst_parts[1] * 1e3:.2f} us), ms_philox_spec "
        f"{cst_plain_ms * 1e3:.1f} us {us(cst_plain_all)}")

    # The Maze episode path: MAZE_CHUNK steps a launch, no maze_step.
    me_launches, (me_roll, *me_result) = run_counted(maze_episode_path)
    check_launches(me_launches, {"maze_steps_philox": MAZE_STEPS_PER_CALL // MAZE_CHUNK},
                   "Maze episode")
    check_maze_path(me_roll, *me_result)
    me_states = time_rollout(me_roll, "Maze episode", me_result[2], MAZE_STEPS_PER_CALL, 1,
                             MAZE_WARMUP_MAX)
    # maze_steps_philox on the episode path's states at its next step, from
    # zero sums, as the path launches it.
    t_m = mslab.t
    mpx_args = (torch.add(me_states.pos[:, 1], me_states.pos[:, 0], alpha=t_m.s1),
                me_states.dir, me_states.step_count,
                *torch.zeros((3, B), device=DEV), torch.zeros((B,), dtype=torch.int32, device=DEV))
    mpx_key, mpx_step = me_roll.key, me_roll.step
    mpx_ms, mpx_all = time_ms(
        lambda: maze_philox_slab(mslab, MAZE_CHUNK, *mpx_args, mpx_key, mpx_step), 200)
    mpx_plain_ms, mpx_plain_all = time_ms(
        lambda: maze_slab.ms_philox_spec(mslab, MAZE_CHUNK, *mpx_args, mpx_key, mpx_step), 2,
        windows=3)
    mpx_out = maze_philox_slab(mslab, MAZE_CHUNK, *mpx_args, mpx_key, mpx_step)
    mpx_bytes = sum(x.numel() * x.element_size() for x in (*mpx_args, mslab.ms_table, *mpx_out))
    # Per env: one Philox call a pair of steps, the two words each step
    # reads, and the step itself.
    mpx_calls = (mpx_step % 2 + MAZE_CHUNK + 1) // 2
    mpx_ops = B * (mpx_calls * PHILOX_CALL_OPS
                   + MAZE_CHUNK * (2 * PHILOX_WORD_OPS + MAZE_MS_OPS))
    mpx_bound, mpx_by, *mpx_parts = bound(mpx_bytes, mpx_ops)
    log(f"maze_steps_philox: {mpx_ms * 1e3:.2f} us/launch of {MAZE_CHUNK} steps (median of "
        f"windows {us(mpx_all)}), {mpx_ms * 1e3 / MAZE_CHUNK:.4f} us a transition against "
        f"maze_step's {maze_ms * 1e3:.2f}; bound {mpx_bound * 1e3:.2f} us ({mpx_by}; "
        f"{mpx_bytes} bytes take {mpx_parts[0] * 1e3:.2f} us, {mpx_ops} operations "
        f"({mpx_calls} Philox calls an env) {mpx_parts[1] * 1e3:.2f} us), ms_philox_spec "
        f"{mpx_plain_ms * 1e3:.1f} us {us(mpx_plain_all)}")

    # The CtF episode path: CTF_CHUNK steps a launch.
    cte_launches, (cte_roll, *cte_result) = run_counted(ctf_episode_path)
    check_launches(cte_launches, {"ctf_steps": -(-CTF_STEPS_PER_CALL // CTF_CHUNK)},
                   "CtF episode")
    check_ctf_path(cte_roll, *cte_result)
    cte_states = time_rollout(cte_roll, "CtF episode", cte_result[2], CTF_STEPS_PER_CALL,
                              CTF_MAIN.num_agents, CTF_WARMUP_MAX)
    A, nb = CTF_MAIN.num_agents, CTF_MAIN.num_blue_agents
    cte_args = (cte_states.pos.reshape(B, -1), cte_states.dir, cte_states.terminated,
                cte_states.collided, cte_states.step_count, torch.zeros((B,), device=DEV),
                torch.randint(0, 5, (CTF_CHUNK, B, nb), generator=gen, device=DEV,
                              dtype=torch.int32),
                torch.rand((CTF_CHUNK, B, cslab.step_draws), generator=gen, device=DEV),
                torch.rand((CTF_CHUNK, B, cslab.reset_draws), generator=gen, device=DEV))
    cms_ms, cms_all = time_ms(lambda: ctf_ms_slab(cslab, *cte_args), 200)
    # The same launch at B = CHAIN_ROWS, one or two warps on the card: the
    # time of one env's chain of CTF_CHUNK steps.
    chain = ctf_slab.reset_batch(cslab, CHAIN_ROWS, generator=gen)
    chain_args = (chain.pos.reshape(CHAIN_ROWS, -1), chain.dir, chain.terminated,
                  chain.collided, chain.step_count, torch.zeros((CHAIN_ROWS,), device=DEV),
                  *(x[:, :CHAIN_ROWS].contiguous() for x in cte_args[6:]))
    cms_chain_ms, cms_chain_all = time_ms(lambda: ctf_ms_slab(cslab, *chain_args), 200)
    cms_plain_ms, cms_plain_all = time_ms(
        lambda: ctf_slab.ms_spec(cslab.t, CTF_CHUNK, *cte_args, cslab.flags, cslab.border,
                                 cslab.pool, cslab.bterr, cslab.rterr), 1, windows=3)
    cms_out = ctf_ms_slab(cslab, *cte_args)
    cms_done = int(cms_out[8].sum())
    # Each input read once, but the spawn uniforms only of the rows that
    # finished (the kernel reads no other); each output written once.
    cms_bytes = sum(x.numel() * x.element_size() for x in (
        *cte_args[:8], cslab.flags, cslab.border, cslab.pool, cslab.bterr, cslab.rterr,
    )) + cms_done * cslab.reset_draws * 4 + sum(x.numel() * x.element_size() for x in cms_out)
    cms_ops = (CTF_CHUNK * (ctf_step_ops(cslab.t, cslab.border.shape[1]) + B * MS_STEP_OPS)
               + cms_done * A * (CTF_SPAWN_OPS + CTF_SPAWN_PAIR_OPS * (max(nb, A - nb) - 1)))
    cms_bound, cms_by, *cms_parts = bound(cms_bytes, cms_ops)
    cms_draw_ms, cms_draw_all = time_ms(lambda: (
        torch.randint(0, 5, (CTF_CHUNK, B, nb), generator=gen, device=DEV, dtype=torch.int32),
        torch.rand((CTF_CHUNK, B, cslab.step_draws), generator=gen, device=DEV),
        torch.rand((CTF_CHUNK, B, cslab.reset_draws), generator=gen, device=DEV)), 50)
    log(f"ctf_steps: {cms_ms * 1e3:.2f} us/launch of {CTF_CHUNK} steps (median of windows "
        f"{us(cms_all)}), {cms_ms * 1e3 / CTF_CHUNK:.4f} us a step against ctf_step's "
        f"{ctf_ms * 1e3:.2f}; at B={CHAIN_ROWS} {cms_chain_ms * 1e3:.2f} us/launch "
        f"{us(cms_chain_all)}, {cms_chain_ms * 1e3 / CTF_CHUNK:.4f} us a step of one env's "
        f"chain; bound {cms_bound * 1e3:.2f} us ({cms_by}; {cms_bytes} bytes take "
        f"{cms_parts[0] * 1e3:.2f} us, {cms_ops} operations ({cms_done} respawns) "
        f"{cms_parts[1] * 1e3:.2f} us), ms_spec {cms_plain_ms * 1e3:.1f} us "
        f"{us(cms_plain_all)}; the chunk's three draws {cms_draw_ms * 1e3:.2f} us "
        f"{us(cms_draw_all)}")

    # The Wildfire episode path: WF_CHUNK steps a launch.
    wfe_launches, (wfe_roll, *wfe_result) = run_counted(wildfire_episode_path)
    wf_chunks = -(-WF_STEPS_PER_CALL // WF_CHUNK)
    check_launches(wfe_launches, {"wf_steps_philox": wf_chunks}, "Wildfire episode")
    check_wildfire_path(wfe_roll, *wfe_result)
    wfe_states = time_rollout(wfe_roll, "Wildfire episode", wfe_result[2], WF_STEPS_PER_CALL,
                              WF_MAIN.num_agents, WF_WARMUP_MAX)
    A, C = wt.n_agents, wt.n_cells
    # The entry with its draws in the kernel, on the same states, at the
    # rollout's next step: it reads only the state and draws only what the
    # data needs (counted by replaying the chunk with the plain version).
    wpx_args = (wfe_states.cells.reshape(B, -1), wfe_states.agent_pos.reshape(B, -1),
                wfe_states.step_count, wfe_states.extinguished, torch.zeros((B,), device=DEV))
    wpx_key, wpx_step = wfe_roll.key, wfe_roll.step
    wpx_ms, wpx_all = time_ms(
        lambda: wf_philox_slab(wslab, *wpx_args, wpx_key, wpx_step, WF_CHUNK), 200)
    wpx_plain_ms, wpx_plain_all = time_ms(
        lambda: ms_philox_spec(wt, WF_CHUNK, *wpx_args, wpx_key, wpx_step), 1, windows=3)
    wpx_out = wf_philox_slab(wslab, *wpx_args, wpx_key, wpx_step, WF_CHUNK)
    wpx_done = int(wpx_out[7].sum())
    wpx_calls, wpx_words = philox_draws_needed(wt, wpx_args, wpx_key, wpx_step, WF_CHUNK)
    wpx_bytes = sum(x.numel() * x.element_size() for x in (*wpx_args, *wpx_out))
    wpx_ops = WF_CHUNK * (wf_ops + B * MS_STEP_OPS) + wpx_done * (
        C * WF_FRESH_CELL_OPS + wt.n_fires * WF_FRESH_FIRE_OPS
        + A * (CTF_SPAWN_OPS + 2 + CTF_SPAWN_PAIR_OPS * (A - 1))) + (
        wpx_calls * PHILOX_CALL_OPS + wpx_words * PHILOX_WORD_OPS)
    wpx_bound, wpx_by, *wpx_parts = bound(wpx_bytes, wpx_ops)
    log(f"wf_steps_philox: {wpx_ms * 1e3:.2f} us/launch of {WF_CHUNK} steps (median of windows "
        f"{us(wpx_all)}), {wpx_ms * 1e3 / WF_CHUNK:.4f} us a step against wildfire_step's "
        f"{wf_ms * 1e3:.2f}; bound {wpx_bound * 1e3:.2f} us ({wpx_by}; {wpx_bytes} bytes take "
        f"{wpx_parts[0] * 1e3:.2f} us, {wpx_ops} operations ({wpx_done} fresh boards, "
        f"{wpx_calls} Philox calls, {wpx_words} words read; "
        f"{wpx_words / (B * WF_CHUNK):.1f} words an env-step of the "
        f"{A + wslab.step_draws + wslab.reset_draws} ms_philox_spec forms) "
        f"{wpx_parts[1] * 1e3:.2f} us), ms_philox_spec {wpx_plain_ms * 1e3:.1f} us "
        f"{us(wpx_plain_all)}")
    # The launch floor: an empty kernel's device time a launch, queued back
    # to back (torch.cuda._sleep(0): a spin of 0 cycles), beside the bound
    # of maze_step, the kernel furthest below it.
    floor_ms, floor_all = time_ms(lambda: torch.cuda._sleep(0), 200)
    log(f"launch floor: an empty kernel takes {floor_ms * 1e3:.2f} us a launch (median of "
        f"windows {us(floor_all)}); maze_step's bound {maze_bound * 1e3:.3f} us, its time "
        f"{maze_ms * 1e3:.2f} us")
    # The training paths: a step kernel launch each rollout step (and the
    # masked Collect reset), none in the update.
    per_iter = TRAIN_CFG.rollout_len
    tc_step, tc_carry, tc_gen, tc_launches = run_training(
        "collect", {"collect_step": per_iter, "collect_reset": per_iter})
    tf_step, tf_carry, tf_gen, tf_launches = run_training("ctf", {"ctf_step": per_iter})
    # Evaluation (the family's step kernel once a step), self-play and the
    # league (no kernel), and the partial-obs CtF path (ctf_step a step).
    eval_launches, eval_collect_call = run_evaluations()
    sp_step, sp_state, sp_gen = run_selfplay()
    run_partial_obs_path()
    # The vector envs (one step-kernel launch a step, and Collect's reset).
    vec_launches, (vec_collect, vec_actions) = run_vector_envs()
    time_single_envs()
    # Rendering (no kernel of the port): the four batch renders, stacked
    # agents, the toroidal obs, and the gif frame path (a step kernel a frame).
    render_readings = check_batch_renders(seed=100)
    stacked_err = check_stacked_renders(seed=101)
    toroid_err = check_toroid_obs(seed=102)
    gif_launches = check_gif_frames()
    log("library_ms: null for every kernel (no single PyTorch call computes any)")

    # Phase 4: where each rollout's time goes.
    profile_rollout(env.rollout, states, "Collect")
    profile_rollout(ctf_env.rollout, ctf_states, "CtF")
    profile_rollout(maze_env.rollout, maze_states, "Maze")
    profile_rollout(wf_env.rollout, wf_states, "Wildfire")
    # A whole 500-step call: at most COLLECT_CALL_LAUNCHES kernels in all.
    profile_rollout(ce_roll, ce_states, "Collect episode", steps=STEPS_PER_CALL,
                    max_launches=COLLECT_CALL_LAUNCHES)
    # A whole 1000-step call: at most MAZE_CALL_LAUNCHES kernels, no draw.
    profile_rollout(me_roll, me_states, "Maze episode", steps=MAZE_STEPS_PER_CALL,
                    max_launches=MAZE_CALL_LAUNCHES, forbid=DRAW_KERNELS)
    profile_rollout(cte_roll, cte_states, "CtF episode", steps=2 * CTF_CHUNK)
    profile_rollout(wfe_roll, wfe_states, "Wildfire episode", steps=4 * WF_CHUNK + 4)
    profile_call(lambda: tc_step(tc_carry, tc_gen), "one Collect training iteration",
                 per_iter, "rollout step")
    profile_call(lambda: tf_step(tf_carry, tf_gen), "one CtF training iteration",
                 per_iter, "rollout step")
    profile_call(lambda: sp_step(sp_state, sp_gen), "one self-play iteration",
                 SELFPLAY_CFG.rollout_len, "rollout step")
    profile_call(eval_collect_call, "one Collect evaluation call", EVAL_STEPS, "step")
    profile_call(lambda: vec_collect.step(vec_actions), "one Collect vector-env step", 1, "step")

    # Phase 5: multi-process runs.
    sharded_counts, ddp_rel, dryrun = run_multiprocess_phase()

    # Phase 6: the worked example and the root scripts.
    phase6, phase6_launches, phase6_errs = run_example_and_scripts_phase()

    # Phase 7: the bench entry points, each in processes of its own.
    bench_readings, bench_launches, bench_s = run_bench_phase()

    # Phase 8: the learner's roofline.
    roofline, roofline_launches, roofline_s = run_roofline_phase()

    record = {"kernels": [
        {"name": "collect_step", "route": "cuda",
         "source": "gym_multigrid_tpu_torch/csrc/collect_step.cu",
         "replaces": "gym_multigrid_tpu/ops/pallas_collect.py:290",
         "launches": launches["collect_step"],
         "launches_training_iteration": tc_launches["collect_step"], "max_abs_err": step_err,
         "ms": step_ms, "plain_ms": step_plain_ms, "bound_ms": step_bound,
         "bound_by": step_by, "library_ms": None},
        {"name": "collect_reset", "route": "cuda",
         "source": "gym_multigrid_tpu_torch/csrc/collect_reset.cu",
         "replaces": "gym_multigrid_tpu/ops/pallas_collect.py:1127",
         "launches": launches["collect_reset"],
         "launches_collect_episode_path": ce_launches["collect_reset"],
         "launches_sharded_episode_call": sharded_counts["collect_reset"],
         "launches_training_iteration": tc_launches["collect_reset"], "max_abs_err": reset_err,
         "ms": reset_ms, "plain_ms": reset_plain_ms, "bound_ms": reset_bound,
         "bound_by": reset_by, "library_ms": None},
        {"name": "ctf_step", "route": "cuda",
         "source": "gym_multigrid_tpu_torch/csrc/ctf_step.cu",
         "replaces": "gym_multigrid_tpu/ops/pallas_ctf.py:492",
         "launches": ctf_launches["ctf_step"],
         "launches_training_iteration": tf_launches["ctf_step"], "max_abs_err": ctf_err,
         # Phase 8's profile_ppo run: 32 a train step, PROFILE_PPO_STEPS steps.
         "launches_profile_ppo": roofline_launches,
         "ms": ctf_ms, "plain_ms": ctf_plain_ms, "bound_ms": ctf_bound,
         "bound_by": ctf_by, "library_ms": None},
        {"name": "maze_step", "route": "cuda",
         "source": "gym_multigrid_tpu_torch/csrc/maze_step.cu",
         "replaces": "gym_multigrid_tpu/ops/pallas_maze.py:41",
         "launches": maze_launches["maze_step"], "max_abs_err": maze_err,
         "ms": maze_ms, "plain_ms": maze_plain_ms, "bound_ms": maze_bound,
         "bound_by": maze_by, "library_ms": None},
        # The K-step entry of the same source, its draws made and its sums
        # kept in the kernel (ops/philox.py's counters): maze_step_slab's
        # transition with _maze_ms_math's auto-reset (pallas_maze.py:86),
        # 100 steps a launch on the Maze episode path.
        {"name": "maze_steps_philox", "route": "cuda",
         "source": "gym_multigrid_tpu_torch/csrc/maze_step.cu",
         "replaces": "gym_multigrid_tpu/ops/pallas_maze.py:41",
         "launches": me_launches["maze_steps_philox"], "max_abs_err": maze_ms_err,
         "ms": mpx_ms, "plain_ms": mpx_plain_ms, "bound_ms": mpx_bound,
         "bound_by": mpx_by, "library_ms": None},
        {"name": "wildfire_step", "route": "cuda",
         "source": "gym_multigrid_tpu_torch/csrc/wildfire_step.cu",
         "replaces": "gym_multigrid_tpu/ops/pallas_wildfire.py:50",
         "launches": wf_launches["wildfire_step"], "max_abs_err": wf_err,
         "ms": wf_ms, "plain_ms": wf_plain_ms, "bound_ms": wf_bound,
         "bound_by": wf_by, "library_ms": None},
        # No TPU kernel: JAX's batch env encodes and resets with plain XLA
        # around wildfire_step_slab.  BatchedEnv.step's Wildfire path, after
        # wildfire_step: the obs, rewards, flags, counts and fresh boards.
        {"name": "wf_autoreset", "route": "cuda",
         "source": "gym_multigrid_tpu_torch/csrc/wildfire_step.cu", "replaces": None,
         "launches": wf_launches["wf_autoreset"], "max_abs_err": wf_ar_err,
         "ms": ar[B][0], "plain_ms": ar[B][1], "bound_ms": ar[B][2], "bound_by": ar[B][3],
         "library_ms": None, f"ms_b{AUTORESET_BIG}": ar[AUTORESET_BIG][0],
         f"plain_ms_b{AUTORESET_BIG}": ar[AUTORESET_BIG][1],
         f"bound_ms_b{AUTORESET_BIG}": ar[AUTORESET_BIG][2]},
        # The K-step entries: each source's transition with the episode
        # math's auto-reset (_ctf_ms_math, pallas_ctf.py:698; _ms_math,
        # pallas_wildfire.py:101), 50 and 24 steps a launch on the CtF and
        # Wildfire episode paths.
        {"name": "ctf_steps", "route": "cuda",
         "source": "gym_multigrid_tpu_torch/csrc/ctf_step.cu",
         "replaces": "gym_multigrid_tpu/ops/pallas_ctf.py:492",
         "launches": cte_launches["ctf_steps"], "max_abs_err": ctf_ms_err,
         "ms": cms_ms, "plain_ms": cms_plain_ms, "bound_ms": cms_bound,
         "bound_by": cms_by, "library_ms": None, f"ms_b{CHAIN_ROWS}": cms_chain_ms},
        # The Wildfire K steps with the draws made in the kernel
        # (ops/philox.py's counters), 24 steps a launch on the Wildfire
        # episode path.
        {"name": "wf_steps_philox", "route": "cuda",
         "source": "gym_multigrid_tpu_torch/csrc/wildfire_step.cu",
         "replaces": "gym_multigrid_tpu/ops/pallas_wildfire.py:50",
         "launches": wfe_launches["wf_steps_philox"], "max_abs_err": wf_px_err,
         "ms": wpx_ms, "plain_ms": wpx_plain_ms, "bound_ms": wpx_bound,
         "bound_by": wpx_by, "library_ms": None},
        # The Collect K-step entry with its draws and truncation resets
        # made in the kernel (ops/philox.py's counters): collect_step_slab's
        # transition with _collect_ms_math's sums and _reset_math's board
        # (pallas_collect.py:696, :1000), 25 steps a launch on the Collect
        # episode path.
        {"name": "collect_steps_philox", "route": "cuda",
         "source": "gym_multigrid_tpu_torch/csrc/collect_steps.cu",
         "replaces": "gym_multigrid_tpu/ops/pallas_collect.py:290",
         "launches": ce_launches["collect_steps_philox"], "max_abs_err": collect_ms_err,
         "launches_sharded_episode_call": sharded_counts["collect_steps_philox"],
         "ms": cst_ms, "plain_ms": cst_plain_ms, "bound_ms": cst_bound,
         "bound_by": cst_by, "library_ms": None},
    ]}
    # Launches of one evaluation call: evaluate() of the Collect family
    # batch, evaluate_ctf() of CTF_MAIN (self-play and the match evaluator
    # launch none).
    per_eval = dict(eval_launches["collect"], ctf_step=eval_launches["evaluate_ctf"]["ctf_step"])
    per_vec = {name: sum(c[name] for c in vec_launches.values()) for name in WRAPPERS}
    for r in record["kernels"]:
        r["launches_evaluation_call"] = per_eval[r["name"]]
        r["launches_vector_env"] = per_vec[r["name"]]
        for path, per_kernel in phase6_launches.items():
            r[f"launches_{path}"] = per_kernel.get(r["name"], 0)
        for (name, rows), e in phase6_errs.items():
            if name == r["name"]:
                r[f"max_abs_err_b{rows}"] = e
        r["launches_bench_call"] = bench_launches.get(r["name"], {})
    log(f"per-env functions and host-policy path, card == CPU: max_abs_err {per_env_err}, "
        f"{host_err}; configs outside the kernels' envelope, card == CPU: {out_err}")
    log(json.dumps({"render": render_readings, "stacked_max_abs_err": stacked_err,
                    "toroid_max_abs_err": toroid_err, "gif_launches": gif_launches}))
    log(json.dumps({"multiprocess": {"sharded_episode_launches": sharded_counts,
                                     "ddp_param_max_rel_err": ddp_rel,
                                     "two_gloo_ranks_on_one_card": dryrun}}))
    log(json.dumps({"example_and_scripts": phase6}))
    log(json.dumps({"bench": bench_readings, "seconds": bench_s}))
    log(json.dumps({"learner_roofline": roofline, "seconds": roofline_s}))
    log(json.dumps(record))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    log(smi.stdout.strip())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
