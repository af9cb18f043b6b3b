"""Operations and bytes each measured kernel needs, and the learner's
model FLOPs, from the shapes and the data of the call they measure.

Operations are 32-bit integer or float operations counted at the int32
rate (the lower of the two), with the masks bit-packed; bytes count each
input read once and each output written once.  A kernel's bound is the
larger of its bytes over the memory rate and its operations over the
int32 rate; its roofline share is that bound over its measured time.

Per-env operations of the CtF step: a red policy's random action and gate
4; the closed-form A* step 6; a squared distance with its compare 7 (one
per blue agent for ``fight``); a mover 16 plus 2 per agent it checks; a
flag check 4 an agent; a battle 16 (distance, eligibility, the truth
table, the draw, the reward and the outcome).  The Wildfire step: per
cell 25 + A (the put-out test, the neighbour count, the threshold's
select, the ignite and burnout compares, the new cell's select, the
counts' ballots); per env the move order's decode 8 and per mover 16 plus
2 per agent.  The K-step entries add 10 a step and env (step count, done,
three sums, the episode count, the running return's select) and, per env
that finished, the spawn: CtF per agent a pick 9 and 4 per teammate drawn
before it; Wildfire per cell 3, per fire 31, per agent the CtF pick and 2.
A Philox4x32-10 call is 78 operations and each word read 3."""

from __future__ import annotations

from benchmark.roofline.peaks import INT32_OPS_PER_S, MEM_BYTES_PER_S

MOVE_OPS = 16
CTF_DIST_OPS = 7
CTF_POLICY_OPS = 4
CTF_ASTAR_OPS = 6
CTF_BATTLE_OPS = 16
WF_CELL_OPS = 25
MS_STEP_OPS = 10
CTF_SPAWN_OPS = 9
CTF_SPAWN_PAIR_OPS = 4
WF_FRESH_CELL_OPS = 3
WF_FRESH_FIRE_OPS = 31
PHILOX_CALL_OPS = 78
PHILOX_WORD_OPS = 3


def bound_s(nbytes: float, ops: float) -> tuple[float, str]:
    """(the least seconds the work can take, what bounds it)."""
    t_bytes, t_ops = nbytes / MEM_BYTES_PER_S, ops / INT32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ctf_step_ops(B: int, n_blue: int, n_red: int, kinds, mvn: bool, n_border: int = 0) -> int:
    """Operations of one CtF step of ``B`` envs, red policies ``kinds``."""
    A, per_env = n_blue + n_red, 0
    for kind in kinds:
        per_env += CTF_POLICY_OPS
        if kind == "rw":
            continue
        per_env += CTF_ASTAR_OPS
        if kind in ("fight", "patrol_fight"):
            per_env += n_blue * CTF_DIST_OPS
        if kind in ("patrol", "patrol_fight"):
            per_env += n_border * 9
    per_env += A * (MOVE_OPS + 2 * A) + A * 4
    per_env += (n_blue * n_red if mvn else 1) * CTF_BATTLE_OPS
    return B * per_env


def ctf_steps_launch(B, K, n_blue, n_red, kinds, mvn, step_draws, static_bytes, done):
    """(bytes, operations) of one ``ctf_steps`` launch of ``K`` steps in
    which ``done`` envs finished: the state, the K steps' actions and
    uniforms and the spawn uniforms of the finished envs read, the state
    and the three sums written; the static tables ``static_bytes``."""
    A = n_blue + n_red
    state = B * (2 * A * 4 + A * 4 + 2 * A + 4 + 4)
    nbytes = (2 * state + static_bytes + K * B * (n_blue + step_draws) * 4 + done * A * 4
              + 3 * B * 4)
    ops = (K * (ctf_step_ops(B, n_blue, n_red, kinds, mvn) + B * MS_STEP_OPS)
           + done * A * (CTF_SPAWN_OPS + CTF_SPAWN_PAIR_OPS * (max(n_blue, n_red) - 1)))
    return nbytes, ops


def wf_step_ops(B: int, C: int, A: int) -> int:
    """Operations of one Wildfire step of ``B`` envs of ``C`` cells."""
    return B * (C * (WF_CELL_OPS + A) + 8 + A * (MOVE_OPS + 2 * A))


def wildfire_step_launch(B: int, C: int, A: int):
    """(bytes, operations) of one ``wildfire_step`` launch: the boards,
    positions, actions and uniforms read; boards, positions, reward, put
    out count and termination written."""
    nbytes = B * 4 * (C + 2 * A + A + 1 + C) + B * 4 * (C + 2 * A + 3)
    return nbytes, wf_step_ops(B, C, A)


def wf_steps_philox_call(B, C, A, n_fires, Ks, fresh, calls, words):
    """(bytes, operations) of the ``wf_steps_philox`` launches of one call,
    one a chunk of ``Ks``, that made ``fresh`` fresh boards and needed
    ``calls`` Philox calls and ``words`` words: per launch the state read
    and written and the three sums written."""
    state = B * 4 * (C + 2 * A + 3)
    nbytes = len(Ks) * (2 * state + 3 * B * 4)
    ops = (sum(Ks) * (wf_step_ops(B, C, A) + B * MS_STEP_OPS)
           + fresh * (C * WF_FRESH_CELL_OPS + n_fires * WF_FRESH_FIRE_OPS
                      + A * (CTF_SPAWN_OPS + 2 + CTF_SPAWN_PAIR_OPS * (A - 1)))
           + calls * PHILOX_CALL_OPS + words * PHILOX_WORD_OPS)
    return nbytes, ops


def mlp_dims(obs_dim: int, hidden, num_agents: int, num_actions: int):
    """Dense layers (in, out) of the actor-critic: the torso, the policy
    head, the value head."""
    dims, d = [], obs_dim
    for h in hidden:
        dims.append((d, h))
        d = h
    return dims + [(d, num_agents * num_actions), (d, 1)]


def model_flops(envs: int, rollout_len: int, num_epochs: int, dims) -> float:
    """Model FLOPs of a PPO train step: a forward (2 a b FLOPs a sample a
    dense layer a -> b) for each of the ``envs * rollout_len`` rollout
    samples and the ``envs`` last values, and three forwards (forward and
    backward) for each sample in each epoch."""
    fwd = sum(2.0 * a * b for a, b in dims)
    samples = envs * rollout_len
    return samples * fwd + num_epochs * samples * 3.0 * fwd + envs * fwd
