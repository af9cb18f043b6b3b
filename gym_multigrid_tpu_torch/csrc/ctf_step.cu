// Capture-the-Flag transitions for a batch of envs, both variants (MvN and
// 1v1), written by hand for Hopper (sm_90a): ctf_step, one transition, and
// ctf_steps, K of them with the auto-reset (below).
//
// Replaces the TPU kernel ctf_step_slab of gym_multigrid_tpu/ops/pallas_ctf.py
// (body _ctf_step_math).  Its plain PyTorch version is step_spec in
// gym_multigrid_tpu_torch/ops/ctf_slab.py and the two agree bit for bit.
//
// What bounds ctf_step on this card: latency, then memory.  An env's state
// is a few words per agent (under 200 bytes of inputs and outputs for
// 2v2), and its step is a chain of dependent decisions: the scripted red
// policies, the A movers one after another (each sees the moves before
// it), then the n_blue x n_red battles in row-major order.  The bytes of a
// whole batch of 8192 envs take well under a microsecond at the card's
// memory rate, so the launch and the latency of that chain set the time.
// Its design spreads an env over a group of G lanes (G = 4 up to 4
// agents, 8 up to 8), so that a batch has G times the warps to hide each
// other's latency, and shortens the chain where the work is parallel:
// - lane k of a group holds agent k: position, direction, terminated,
//   collided, action and its own uniforms;
// - the static tables (one flag byte per cell, cached per slab by the
//   wrapper; the patrol border and pool lists; the red policies; the move
//   orders) are copied once per block into shared memory and read by index,
//   their loads and the lanes' own all in flight before the block's one
//   barrier.  The TPU kernel's one-hot lane reductions over the board were
//   a TPU workaround and are not carried over;
// - the red policies run one lane per red agent.  A red lane scans the
//   blue agents for the closest itself, on their positions gathered by
//   independent shuffles (at most 7, all in flight at once; a reduction
//   tree across the group measured slower).  The closest-border-cell scan,
//   as long as the red border, is split over the group's lanes and reduced
//   with __shfl_xor_sync on (distance, index) pairs in lexicographic order,
//   which keeps the plain version's "ties go to the first" rule;
// - the moves stay sequential in slot order: the mover's values are
//   broadcast with __shfl_sync inside the group and occupancy is one
//   __ballot_sync masked to the group.  The MvN move order for up to 4
//   agents is the j-th permutation of the A! table in lexicographic order
//   (itertools.permutations), read from csrc/move_order.cuh's table; beyond
//   4 agents it is drawn by Fisher-Yates, as in the plain version, before
//   the first move.  Either way it is packed 4 bits a slot, and no step of
//   the chain divides by a runtime value;
// - each lane forms its battle pairs' distance test and draw; the
//   row-major scan that applies them (eligibility depends on earlier
//   outcomes) and the reward sum run in the group's first lane, on bit
//   masks gathered by ballots, in the plain version's order;
// - terminated, collided and every flag output are bytes (torch.bool), as
//   the batch state holds them, so the step needs no casts around it;
// - every float constant arrives as a float argument, rounded once on the
//   host from a double, and the reward is summed with __fadd_rn/__fmul_rn
//   in the plain version's order, so no multiply-add is contracted into an
//   FMA; floor(u * n) picks are __fmul_rn then __float2int_rz.
// Cell lookups clip the position to the board first: the move's bounds
// check uses the reference's swapped bounds (row against S1, column
// against S0), so on a non-square board an in-bounds target can lie off
// the board, and an unclipped index would leave the table.
//
// The K-step entry ctf_steps runs K transitions with the per-env auto-reset
// of _ctf_ms_math (pallas_ctf.py), the plain version ms_spec in
// ops/ctf_slab.py, in one launch: the counterpart of ctf_step_slab's body on
// the JAX episode path, whose own K-step Pallas kernel was pruned on the
// TPU.  What bounds it is the chain of one env's steps, each depending on
// the last: the draws it reads, about 21 MB for 50 steps of 8192 envs at
// 2v2, take about 6.4 us at the card's memory rate.  So its design keeps
// every cross-lane round trip and every global load off that chain, and
// as few instructions on it as it can (namespace ms):
// - one thread an env, the whole env in registers: each agent's cell as
//   one key (row * 65536 + col), its direction, and the info word of the
//   cell it stands on (ops.ctf_slab.cell_info: the flag byte and the
//   closest red-border cell), terminated and collided as bit masks.  The
//   kernel is templated on the blue and red counts and the variant, so
//   every per-agent loop unrolls over registers with the agents' roles
//   known, and the mover of a slot is picked by a chain of
//   regsel::select_eq;
// - the moves are resolved on bit masks: before the first move, each
//   agent's target is compared with every agent's cell and target (A * A
//   independent compares), so that the A slots, in the plain version's
//   order, are a few bit operations each: an agent is blocked when an agent
//   that has not moved stands on its target, or one that has moved went
//   there;
// - the patrol scan is one read: the closest red-border cell of every
//   position an agent can hold is tabulated once a slab, into the info
//   word, so it is read with the target's flags in the move's one table
//   read; "on the border" is "the closest border cell is its own";
// - no branch on per-thread data in a step (the closed-form A* step, the
//   battles' eligibility, the spawn picks are selects), so the step is a
//   few large blocks the compiler schedules across;
// - two warps a block for the same 32 envs: warp 1 streams each step's
//   draws, the spawn uniforms included, into a ring of kStages steps in
//   shared memory by 4-byte cp.async copies, kStages steps ahead, and
//   decodes everything in a step that depends on no state (the move order,
//   the red agents' random actions, their optimal-action gates and pool
//   picks, the battle draws against each of the three win probabilities,
//   the spawn cells) into shared memory; warp 0 runs the chain on what warp
//   1 decoded, one named barrier a step, so a finished env respawns from
//   registers and the chain's warp issues only the chain;
// - the flag captures, the battles' row-major scan and the reward sum
//   follow the plain version's order, with __fadd_rn/__fsub_rn, a term
//   added only where its flag is 1 (see ms::transition).
// Compiled with -DCTF_STEPS_GROUP=1, warp 0 keeps the one-step entry's
// layout instead, a group of 4 lanes an env (8 above 4 agents), lane k
// holding agent k: each step gathers the group's A state words with A
// independent shuffles, every lane runs the env's step and keeps its own
// agent; scripts/torch_kernel_probe.py times the two layouts.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "copy_async.cuh"
#include "move_order.cuh"
#include "picks.cuh"
#include "select.cuh"

namespace ctf {
namespace {

using move_order::kMoveOrders;
using move_order::kNumOrders;
using picks::floor_pick;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxAgents = 8;
constexpr int kMaxCells = 1024;
constexpr int kThreads = 256;
constexpr int kNumActions = 5;
constexpr int kSpawnDir = 3;

// Policy kinds: their index in POLICY_KINDS of envs/ctf.py.
constexpr int kRw = 0, kFight = 1, kCapture = 2, kPatrol = 3, kPatrolFight = 4;
// Actions: stay, left, down, right, up.
constexpr int kStay = 0, kLeft = 1, kDown = 2, kRight = 3, kUp = 4;
// Cell flag bits, as ops.ctf_slab.cell_flags packs them.
constexpr unsigned char kCanEnter = 1, kBlueOwn = 2, kRedOwn = 4, kObstacle = 8;

struct Params {
  int B, n_blue, n_red, mvn, s0, s1, bound0, bound1;
  int blue_flag0, blue_flag1, red_flag0, red_flag1;
  int n_border, n_pool, rnd_cols, coll_penalty, obstacle_end;
  float battle_range2, p_blue_own, p_blue_away, flag_reward, battle_reward;
  float obstacle_penalty, step_penalty;
};

struct Inputs {
  const int* pos;
  const int* dirs;
  const unsigned char* term;
  const unsigned char* coll;
  const int* blue_acts;
  const float* rnd;
  const unsigned char* flags;
  const int* border;
  const int* pool;
  const int* kinds;
  const float* p_opt;
};

struct Outputs {
  int* pos;
  int* dirs;
  unsigned char* term;
  unsigned char* coll;
  float* reward;
  unsigned char* ep_term;
  unsigned char* rfc;
  unsigned char* bfc;
  unsigned char* bbl;
  unsigned char* brl;
};

// The block's tables in shared memory.
struct Tables {
  const unsigned* orders;
  const int* border;  // (row, col) pairs
  const int* pool;    // (row, col) pairs
  const int* kind;    // per red agent
  const float* popt;  // per red agent
  const unsigned char* cell;
};

// One step's draws as one lane holds them.
template <int G>
struct Draws {
  int act = 0;  // a blue lane's action id, not yet clamped
  float u_perm = 0.f, u_t = 0.f, u_g = 0.f, u_a = 0.f;
  float u_pair[G / 4];
};

// What one transition leaves besides the lanes' state.  reward, ep_term,
// rfc and bfc are valid in the group's first lane only.
struct StepResult {
  float reward = 0.f;
  bool ep_term = false, rfc = false, bfc = false;
  unsigned bbl = 0u, brl = 0u;  // agent k at bit k, every lane of the group
};

__device__ __forceinline__ int dx_of(int a) {
  return a == kDown ? -1 : (a == kUp ? 1 : 0);
}
__device__ __forceinline__ int dy_of(int a) {
  return a == kLeft ? -1 : (a == kRight ? 1 : 0);
}
__device__ __forceinline__ int dir_of(int a) {
  // Render direction of each action: stay and left 3, down 2, right 1, up 0.
  return a == kDown ? 2 : (a == kRight ? 1 : (a == kUp ? 0 : 3));
}

__device__ __forceinline__ float sq_dist(int ax, int ay, int bx, int by) {
  const float dx = (float)(ax - bx), dy = (float)(ay - by);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// The closed-form first step of the reference A* on an open board, as
// selects: per-thread data, so a branch would diverge.
__device__ __forceinline__ int optimal_action(int cr, int cc, int tr, int tc) {
  const int dr = tr - cr, dc = tc - cc;
  const int along = dc != 0 ? (dc < 0 ? kLeft : kRight) : kUp;
  return dr == 0 && dc == 0 ? kStay : (dr < 0 ? kDown : along);
}

// The least (d, idx) over the G lanes of each group, lexicographically:
// the first index among the nearest, as a scan with "d < best" keeps it.
template <int G>
__device__ __forceinline__ void group_argmin(float& d, int& idx) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(kFull, d, off);
    const int oi = __shfl_xor_sync(kFull, idx, off);
    if (od < d || (od == d && oi < idx)) {
      d = od;
      idx = oi;
    }
  }
}

// This group's bits of a warp-wide ballot, agent k at bit k.
template <int G>
__device__ __forceinline__ unsigned group_bits(bool pred, int gbase) {
  return (__ballot_sync(kFull, pred) >> gbase) & ((1u << G) - 1u);
}

// Copies the tables into shared memory, laid out from `smem` on: the border
// and pool lists, the red policies, then one flag byte per cell; the move
// orders go to `s_orders`.  One
// table entry per thread and round (one round for every board and list of
// the phase-2 configs), each round's loads before its stores, so that they
// are all in flight at once: measured, that order, and this register
// staging, beat 4-byte cp.async copies.  No barrier: the caller's follows.
__device__ __forceinline__ Tables load_tables(const Inputs& in, const Params& p,
                                              unsigned* s_orders, int* smem) {
  int* s_border = smem;                          // 2 * n_border
  int* s_pool = s_border + 2 * p.n_border;       // 2 * n_pool
  int* s_kind = s_pool + 2 * p.n_pool;           // n_red
  float* s_popt = (float*)(s_kind + p.n_red);    // n_red
  unsigned char* s_cell = (unsigned char*)(s_popt + p.n_red);  // N
  const int N = p.s0 * p.s1, nr = p.n_red;
  const int most = max(max(N, p.n_border), max(p.n_pool, kNumOrders));
  for (int i = threadIdx.x; i < most; i += kThreads) {
    const bool in_f = i < N, in_b = i < p.n_border, in_p = i < p.n_pool, in_k = i < nr;
    const bool in_o = i < kNumOrders;
    const unsigned char f = in_f ? in.flags[i] : 0;
    const int b0 = in_b ? in.border[i] : 0, b1 = in_b ? in.border[p.n_border + i] : 0;
    const int q0 = in_p ? in.pool[i] : 0, q1 = in_p ? in.pool[p.n_pool + i] : 0;
    const int kind_i = in_k ? in.kinds[i] : 0;
    const float popt_i = in_k ? in.p_opt[i] : 0.f;
    const unsigned o = in_o ? kMoveOrders[i] : 0u;
    if (in_f) s_cell[i] = f;
    if (in_b) {
      s_border[2 * i] = b0;
      s_border[2 * i + 1] = b1;
    }
    if (in_p) {
      s_pool[2 * i] = q0;
      s_pool[2 * i + 1] = q1;
    }
    if (in_k) {
      s_kind[i] = kind_i;
      s_popt[i] = popt_i;
    }
    if (in_o) s_orders[i] = o;
  }
  return Tables{s_orders, s_border, s_pool, s_kind, s_popt, s_cell};
}

// Lane k's draws of one step: `acts` is the env's n_blue action ids and `u`
// its rnd_cols step uniforms, in global or shared memory.  Lanes that hold
// no agent, or lie past the batch, read nothing they do not need.
template <int G>
__device__ __forceinline__ Draws<G> read_draws(const Params& p, const int* acts, const float* u,
                                               int k, bool live, bool agent) {
  constexpr int kPairSlots = G / 4;
  const int nb = p.n_blue, nr = p.n_red, A = nb + nr;
  const int perm_draws = A <= 4 ? 1 : A - 1;
  const int n_pairs = p.mvn ? nb * nr : 1;
  const int ub_base = perm_draws + 3 * nr;
  Draws<G> d;
  if (agent) {
    if (k < nb) {
      d.act = acts[k];
    } else {
      const int base = perm_draws + 3 * (k - nb);
      d.u_t = u[base];
      d.u_g = u[base + 1];
      d.u_a = u[base + 2];
    }
  }
  if (live && k < perm_draws) d.u_perm = u[k];
#pragma unroll
  for (int q = 0; q < kPairSlots; ++q) {
    const int pair = k + G * q;
    d.u_pair[q] = live && pair < n_pairs ? u[ub_base + pair] : 1.f;
  }
  return d;
}

// One transition of the group's env: lane k holds agent k's position,
// terminated and collided flags (0/1) and direction, and leaves them as
// the step does.  Every lane of the warp takes part (shuffles, ballots).
template <int G>
__device__ __forceinline__ StepResult transition(const Params& p, const Tables& s, int k,
                                                 int gbase, bool live, bool agent, int& px,
                                                 int& py, int& tm, int& cl, int& dr,
                                                 const Draws<G>& d) {
  constexpr int kPairSlots = G / 4;
  const int nb = p.n_blue, nr = p.n_red, A = nb + nr;
  int act = k < nb ? min(max(d.act, 0), kNumActions - 1) : 0;

  auto cell = [&](int x, int y) -> unsigned char {
    const int qx = min(max(x, 0), p.s0 - 1), qy = min(max(y, 0), p.s1 - 1);
    return s.cell[qx * p.s1 + qy];
  };

  // ---- the move order: MvN shuffles it, 1v1 is blue then red ----
  // The mover of each slot, 4 bits a slot; it depends on no position, so
  // it is found first and its latency overlaps the red policies'.
  unsigned order = 0x76543210u;
  if (p.mvn && A <= 4) {
    const int j = floor_pick(__shfl_sync(kFull, d.u_perm, gbase), move_order::num_orders(A));
    order = s.orders[move_order::move_order_base(A) + j];
  } else if (p.mvn) {
    // Fisher-Yates: slot s moves the floor(u_s * (A - s))-th agent (0-based)
    // that has not moved yet.
    unsigned taken = 0u;
    order = 0u;
    for (int slot = 0; slot < A; ++slot) {
      const float u_s = __shfl_sync(kFull, d.u_perm, gbase + min(slot, G - 1));
      const int r_pick = slot < A - 1 ? floor_pick(u_s, A - slot) : 0;
      int cnt = 0, mover = 0;
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const bool free_i = i < A && !((taken >> i) & 1u);
        if (free_i && cnt == r_pick) mover = i;
        cnt += free_i;
      }
      taken |= 1u << mover;
      order |= (unsigned)mover << (4 * slot);
    }
  }

  // ---- scripted red actions from the pre-move state ----
  // What a red lane needs no search for: its random action, whether it
  // takes the optimal one, and its pool pick.
  const int kind = agent && k >= nb ? s.kind[k - nb] : kRw;
  const int rand_act = floor_pick(d.u_a, kNumActions);
  const bool optimal = kind != kRw && d.u_g < s.popt[max(k - nb, 0)];
  int prow = 0, pcol = 0;
  if ((kind == kPatrol || kind == kPatrolFight) && p.n_pool > 0) {
    const int j = floor_pick(d.u_t, p.n_pool);
    prow = s.pool[2 * j];
    pcol = s.pool[2 * j + 1];
  }
  // Any blue agent in red territory, flag included.
  const bool opp_in = group_bits<G>(agent && k < nb && (cell(px, py) & kRedOwn), gbase) != 0;
  // Each red lane's chase target: the closest blue agent, ties to the
  // first.  The blue positions come over in shuffles that are all in
  // flight at once, and each red lane scans its own.
  int trow = 0, tcol = 0, brow = 0, bcol = 0;
  {
    float best = INFINITY;
#pragma unroll
    for (int j = 0; j < G - 1; ++j) {
      if (j >= nb) break;
      const int jr = __shfl_sync(kFull, px, gbase + j), jc = __shfl_sync(kFull, py, gbase + j);
      const float dj = sq_dist(jr, jc, px, py);
      if (j == 0 || dj < best) {
        best = dj;
        trow = jr;
        tcol = jc;
      }
    }
  }
  // Each patrolling red lane's closest border cell, found by the whole
  // group, one red agent after another.
  bool onb = false;
  for (int r = 0; r < nr; ++r) {
    const int kind_r = s.kind[r];
    if (kind_r != kPatrol && kind_r != kPatrolFight) continue;
    const int cr = __shfl_sync(kFull, px, gbase + nb + r);
    const int cc = __shfl_sync(kFull, py, gbase + nb + r);
    // Lane k scans cells k, k + G, ...
    float dq_best = INFINITY;
    int j = INT_MAX;
    bool on = false;
    for (int q = k; q < p.n_border; q += G) {
      const int qr = s.border[2 * q], qc = s.border[2 * q + 1];
      on |= cr == qr && cc == qc;
      const float dq = sq_dist(cr, cc, qr, qc);
      if (dq < dq_best) {
        dq_best = dq;
        j = q;
      }
    }
    group_argmin<G>(dq_best, j);
    const bool on_any = group_bits<G>(on, gbase) != 0;
    if (k == nb + r) {
      onb = on_any;
      brow = s.border[2 * j];
      bcol = s.border[2 * j + 1];
    }
  }
  if (agent && k >= nb) {
    if (kind == kCapture) {
      trow = p.blue_flag0;
      tcol = p.blue_flag1;
    }
    if (kind == kPatrol || (kind == kPatrolFight && !opp_in)) {
      trow = onb ? prow : brow;
      tcol = onb ? pcol : bcol;
    }
    act = optimal ? optimal_action(px, py, trow, tcol) : rand_act;
  }

  // ---- sequential moves: MvN shuffles the order, 1v1 is blue then red ----
  // Every agent moves once, in its own slot, and nothing else moves it: its
  // target, bounds test and cell test are known before the first move.
  // Bit 0 of `can`: alive and in bounds; bit 1: the target cell can be
  // entered.
  const int tr = px + dx_of(act), tc = py + dy_of(act);
  const bool inb = tr >= 0 && tc >= 0 && tr < p.bound0 && tc < p.bound1;
  const int can = (tm == 0 && inb) | ((cell(tr, tc) & kCanEnter) ? 2 : 0);
  for (int slot = 0; slot < A; ++slot) {
    const int mover = (order >> (4 * slot)) & 15u;
    const int src = gbase + mover;
    const int nr_ = __shfl_sync(kFull, tr, src), nc_ = __shfl_sync(kFull, tc, src);
    const int mover_can = __shfl_sync(kFull, can, src);
    // Every agent blocks: dead ones, and the mover itself on stay.
    const bool occupied = group_bits<G>(agent && px == nr_ && py == nc_, gbase) != 0;
    if (k == mover) {
      if (p.coll_penalty) cl = max(cl, (int)((mover_can & 1) && occupied));
      if (mover_can == 3 && !occupied) {
        px = nr_;
        py = nc_;
        dr = dir_of(act);
      }
    }
  }

  // ---- what the group's first lane sums and scans, as bit masks ----
  const unsigned cl_bits = group_bits<G>(agent && cl != 0, gbase);
  if (p.coll_penalty) tm = max(tm, cl);
  const unsigned tm_bits = group_bits<G>(agent && tm != 0, gbase);
  const unsigned on_red_flag =
      group_bits<G>(agent && k < nb && px == p.red_flag0 && py == p.red_flag1, gbase);
  const unsigned on_blue_flag =
      group_bits<G>(agent && k >= nb && px == p.blue_flag0 && py == p.blue_flag1, gbase);
  // Blue agents in blue territory, red agents in red.
  const unsigned own =
      group_bits<G>(agent && (cell(px, py) & (k < nb ? kBlueOwn : kRedOwn)) != 0, gbase);
  // Pair k + G q (row-major: blue j = pair / n_red, red nb + pair % n_red;
  // the quotient in float, exact for pair < 64): within range, and won by
  // blue if eligible.  Bit pair of in_range and blue_wins.
  const int n_pairs = p.mvn ? nb * nr : 1;
  const float inv_nr = __frcp_rn((float)nr);
  auto pair_blue = [&](int pair) { return __float2int_rz(__fmul_rn((float)pair + 0.5f, inv_nr)); };
  unsigned in_range = 0u, blue_wins = 0u;
#pragma unroll
  for (int q = 0; q < kPairSlots; ++q) {
    const int pair = k + G * q;
    const bool has = pair < n_pairs;
    const int quo = pair_blue(pair);
    const int j = has && p.mvn ? quo : 0, i = nb + (has && p.mvn ? pair - quo * nr : 0);
    const int jx = __shfl_sync(kFull, px, gbase + j), jy = __shfl_sync(kFull, py, gbase + j);
    const int ix = __shfl_sync(kFull, px, gbase + i), iy = __shfl_sync(kFull, py, gbase + i);
    const bool own_j = (own >> j) & 1u, own_i = (own >> i) & 1u;
    const float p_blue = own_j == own_i ? 0.5f : (own_j ? p.p_blue_own : p.p_blue_away);
    in_range |= group_bits<G>(has && sq_dist(jx, jy, ix, iy) <= p.battle_range2, gbase)
                << (G * q);
    blue_wins |= group_bits<G>(has && d.u_pair[q] < p_blue, gbase) << (G * q);
  }

  // The reward is a sum of terms c * flag in the plain version's order; a
  // term whose flag is 0 is +-0, which leaves every partial sum unchanged
  // (the sum starts at +0 and round-to-nearest never makes it -0), so
  // only the terms whose flag is 1 are added, still in order, and c * 1 is
  // c.
  StepResult res;
  unsigned tmask = tm_bits, bbl = 0u, brl = 0u;
  if (live && k == 0) {
    float reward = 0.f;
    // Collided penalty, MvN only.
    if (p.coll_penalty)
      for (unsigned m = cl_bits & ((1u << nb) - 1u); m; m &= m - 1)
        reward = __fsub_rn(reward, p.obstacle_penalty);
    // Flag captures, terminated agents included.
    for (unsigned m = on_red_flag; m; m &= m - 1) reward = __fadd_rn(reward, p.flag_reward);
    for (unsigned m = on_blue_flag; m; m &= m - 1) reward = __fsub_rn(reward, p.flag_reward);
    const bool rfc = on_red_flag != 0, bfc = on_blue_flag != 0;
    bool ep_term = rfc || bfc;
    // Battles, row-major and sequential (1v1 has the one pair (0, nb));
    // a pair out of range is never eligible.
    for (unsigned m = in_range; m; m &= m - 1) {
      const int pair = __ffs(m) - 1;
      const int j = p.mvn ? pair_blue(pair) : 0, i = nb + (pair - j * nr);
      if (((tmask >> j) | (tmask >> i)) & 1u) continue;  // one of them is out
      if ((blue_wins >> pair) & 1u) {
        reward = __fadd_rn(reward, p.battle_reward);
        tmask |= 1u << i;
        brl |= 1u << i;
      } else {
        reward = __fsub_rn(reward, p.battle_reward);
        if (p.mvn)
          tmask |= 1u << j;
        else
          ep_term = true;  // 1v1: blue losing ends the episode
        bbl |= 1u << j;
      }
    }
    if (p.mvn) {
      const unsigned blue = (1u << nb) - 1u;
      ep_term |= (tmask & blue) == blue;  // every blue agent is out
    } else if (p.obstacle_end && (cell(px, py) & kObstacle)) {
      // 1v1: standing on an obstacle cell costs and ends the episode.
      reward = __fsub_rn(reward, p.obstacle_penalty);
      ep_term = true;
    }
    res.reward = __fsub_rn(reward, p.step_penalty);
    res.ep_term = ep_term;
    res.rfc = rfc;
    res.bfc = bfc;
  }
  tmask = __shfl_sync(kFull, tmask, gbase);
  res.bbl = __shfl_sync(kFull, bbl, gbase);
  res.brl = __shfl_sync(kFull, brl, gbase);
  if (agent) tm = (tmask >> k) & 1u;
  return res;
}

template <int G>
__global__ void __launch_bounds__(kThreads)
step_kernel(const Inputs in, const Outputs out, const Params p) {
  __shared__ unsigned s_orders[kNumOrders];
  extern __shared__ int smem[];

  const int lane = threadIdx.x & 31;
  const int k = lane & (G - 1);       // this lane's agent
  const int gbase = lane & ~(G - 1);  // the group's first lane
  const int b = (blockIdx.x * kThreads + (int)threadIdx.x) / G;
  // Lanes past the batch run along with no loads or stores: every lane of
  // the warp takes part in its shuffles and ballots.
  const bool live = b < p.B;
  const int nb = p.n_blue, nr = p.n_red, A = nb + nr;
  const bool agent = live && k < A;

  // ---- the block's tables, then this lane's loads ----
  // The tables first: measured, that order beat the per-env loads first.
  const Tables tables = load_tables(in, p, s_orders, smem);
  // Not an agent: off the board and terminated, so it never matches a
  // cell, a target or a battle.
  int px = -0x40000000, py = -0x40000000, tm = 1, cl = 0, dr = 0;
  if (agent) {
    px = in.pos[(size_t)b * 2 * A + 2 * k];
    py = in.pos[(size_t)b * 2 * A + 2 * k + 1];
    tm = in.term[(size_t)b * A + k];
    cl = in.coll[(size_t)b * A + k];
    dr = in.dirs[(size_t)b * A + k];
  }
  const Draws<G> draws = read_draws<G>(p, in.blue_acts + (size_t)b * nb,
                                       in.rnd + (size_t)b * p.rnd_cols, k, live, agent);
  __syncthreads();

  const StepResult res = transition<G>(p, tables, k, gbase, live, agent, px, py, tm, cl, dr, draws);

  if (live && k == 0) {
    out.reward[b] = res.reward;
    out.ep_term[b] = res.ep_term;
    out.rfc[b] = res.rfc;
    out.bfc[b] = res.bfc;
  }
  if (agent) {
    out.pos[(size_t)b * 2 * A + 2 * k] = px;
    out.pos[(size_t)b * 2 * A + 2 * k + 1] = py;
    out.dirs[(size_t)b * A + k] = dr;
    out.coll[(size_t)b * A + k] = cl;
    out.term[(size_t)b * A + k] = tm;
    if (k < nb)
      out.bbl[(size_t)b * nb + k] = (res.bbl >> k) & 1u;
    else
      out.brl[(size_t)b * nr + (k - nb)] = (res.brl >> k) & 1u;
  }
}

template <int G>
cudaError_t launch(const Inputs& in, const Outputs& out, const Params& p, size_t smem,
                   cudaStream_t stream) {
  const long long threads = (long long)p.B * G;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  step_kernel<G><<<blocks, kThreads, smem, stream>>>(in, out, p);
  return cudaGetLastError();
}

// The scalar arguments of ctf_step, checked.
bool valid(int B, int n_blue, int n_red, int s0, int s1, int n_border, int n_pool) {
  const int A = n_blue + n_red;
  return B >= 1 && n_blue >= 1 && n_red >= 1 && A <= kMaxAgents && s0 >= 1 && s1 >= 1 &&
         s0 * s1 <= kMaxCells && n_border >= 1 && n_border <= kMaxCells && n_pool >= 0 &&
         n_pool <= 4 * kMaxCells;
}

// Shared memory of the tables (load_tables' layout).
size_t table_bytes(int n_border, int n_pool, int n_red, int s0, int s1) {
  return sizeof(int) * (2 * (size_t)n_border + 2 * (size_t)n_pool + 2 * (size_t)n_red) +
         (size_t)s0 * s1;
}

// ---------------------------------------------------------------------------
// ctf_steps: the whole env in one thread's registers
// ---------------------------------------------------------------------------

#ifndef CTF_STEPS_GROUP
#define CTF_STEPS_GROUP 0
#endif

namespace ms {

using regsel::select_eq;

// Lanes an env: one, or with -DCTF_STEPS_GROUP=1 a group of 4 (8 above 4
// agents), lane k holding agent k.
template <int A>
constexpr int kLanes = CTF_STEPS_GROUP ? (A <= 4 ? 4 : 8) : 1;
// Steps of draws in flight ahead of the one the chain runs.
constexpr int kStages = 8;
// The info word of a position (ops.ctf_slab.cell_info): the flag byte of
// the board cell it clips to, then the row and the column of the closest
// red-border cell at these shifts, 10 bits each.
constexpr int kInfoRowShift = 8, kInfoColShift = 18, kCoordMask = 1023;
// A cell's key is row * kRowKey + col (ops.ctf_slab.KEY_ROW).
constexpr int kRowKey = 65536;
// Each action's row and column step plus one, and its render direction, 4
// bits an action (stay, left, down, right, up).
constexpr unsigned kRowStep = 0x21011u, kColStep = 0x12101u, kDirOf = 0x01233u;

// What the kernel is compiled for: NB blue and NR red agents, MvN or 1v1.
template <int NB, int NR, bool MVN>
struct Shape {
  static constexpr int A = NB + NR;
  static constexpr int perm_draws = A <= 4 ? 1 : A - 1;
  static constexpr int pairs = MVN ? NB * NR : 1;  // battle pairs
  static constexpr int R = perm_draws + 3 * NR + NB * NR;  // step uniforms (rnd_width)
  static constexpr int W = NB + R + A;  // words of an env's record of a step
};

struct Params {
  int B, K, s0, s1, bound0, bound1;
  int blue_flag, red_flag;  // the flags' cell keys
  int n_pool, coll_penalty, obstacle_end, n_bt, n_rt, max_steps;
  float battle_range2, p_blue_own, p_blue_away, flag_reward, battle_reward;
  float obstacle_penalty, step_penalty;
};

struct Args {
  const int* pos;
  const int* dirs;
  const unsigned char* term;
  const unsigned char* coll;
  const int* sc;
  const float* run_ret;
  const int* blue_acts;
  const float* rnd;
  const float* rnd_reset;
  const int* table;
  const int* kinds;
  const float* p_opt;
  int* pos_out;
  int* dirs_out;
  unsigned char* term_out;
  unsigned char* coll_out;
  int* sc_out;
  float* run_out;
  float* rew_sum;
  float* ep_sum;
  int* eps;
};

// The block's tables in shared memory: the slab's steps_table, then the
// move orders.
struct Shared {
  const int2* terr;  // blue then red territory: each cell's key and info word
  const int* info;   // the info word of each position, at info_index
  const int* pool;   // the patrol pool as keys
  const unsigned* orders;
};

__host__ __device__ __forceinline__ int key_of(int r, int c) { return r * kRowKey + c; }

// Where a position's info word is (ops.ctf_slab.agent_positions): the
// positions the move's bounds check admits, row-major, then the board's
// cells, row-major, where spawns land.
__device__ __forceinline__ int info_index(const Params& p, int r, int c) {
  if (r >= 0 && c >= 0 && r < p.bound0 && c < p.bound1) return r * p.bound1 + c;
  return p.bound0 * p.bound1 + min(max(r, 0), p.s0 - 1) * p.s1 + min(max(c, 0), p.s1 - 1);
}

// Nibble a of a table of 4-bit entries.
__device__ __forceinline__ int nibble(unsigned table, int a) { return (table >> (4 * a)) & 15u; }

// One env's state.
template <int A>
struct Env {
  int key[A];       // each agent's cell
  int info[A];      // the info word of that cell
  int dir[A];
  unsigned tm, cl;  // bit i: agent i terminated, collided
};

// What a step needs that depends on no state, decoded from its draws.
template <int A>
struct Pre {
  int act[A];         // blue: the action id, clamped; red: the random action
  int pool[A];        // a red agent's pool pick, as a key
  int spawn[A];       // each agent's spawn cell, as a key
  int spawn_info[A];  // and its info word
  unsigned order;     // the mover of slot s at bits 4s..4s+3
  unsigned opt;       // bit i: red agent i takes its optimal action
  unsigned wins[3];   // bit k: battle pair k's uniform is below 0.5,
                      // p_blue_own, p_blue_away
};

// Decodes one env's draws of one step: `acts` its NB action ids, `u` its R
// step uniforms, `ur` its A spawn uniforms.
template <int NB, int NR, bool MVN>
__device__ __forceinline__ Pre<NB + NR> decode(const Params& p, const Shared& s, const int* acts,
                                               const float* u, const float* ur,
                                               const int (&kind)[NR], const float (&popt)[NR]) {
  using S = Shape<NB, NR, MVN>;
  constexpr int A = S::A;
  Pre<A> d;
  // The move order: MvN shuffles it, 1v1 is blue then red.
  if (!MVN) {
    d.order = 0x76543210u;
  } else if (A <= 4) {
    const int j = floor_pick(u[0], move_order::num_orders(A));
    d.order = s.orders[move_order::move_order_base(A) + j];
  } else {
    // Fisher-Yates: slot s moves the floor(u_s * (A - s))-th agent (0-based)
    // that has not moved yet.
    unsigned taken = 0u;
    d.order = 0u;
#pragma unroll
    for (int slot = 0; slot < A; ++slot) {
      const int r_pick = slot < A - 1 ? floor_pick(u[slot], A - slot) : 0;
      int cnt = 0, mover = 0;
#pragma unroll
      for (int i = 0; i < A; ++i) {
        const bool free_i = !((taken >> i) & 1u);
        mover = free_i && cnt == r_pick ? i : mover;
        cnt += free_i;
      }
      taken |= 1u << mover;
      d.order |= (unsigned)mover << (4 * slot);
    }
  }
  // The actions, the red agents' gates and pool picks.
  d.opt = 0u;
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    d.act[i] = min(max(acts[i], 0), kNumActions - 1);
    d.pool[i] = 0;
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int base = S::perm_draws + 3 * r;
    d.act[NB + r] = floor_pick(u[base + 2], kNumActions);
    d.opt |= (unsigned)(kind[r] != kRw && u[base + 1] < popt[r]) << (NB + r);
    // An empty pool reads entry 0 of the orders after it, and keeps 0.
    const int q = s.pool[max(floor_pick(u[base], p.n_pool), 0)];
    d.pool[NB + r] = p.n_pool > 0 ? q : 0;
  }
  // Each battle pair's draw against the three probabilities blue can have.
  d.wins[0] = d.wins[1] = d.wins[2] = 0u;
#pragma unroll
  for (int k = 0; k < S::pairs; ++k) {
    const float v = u[S::perm_draws + 3 * NR + k];
    d.wins[0] |= (unsigned)(v < 0.5f) << k;
    d.wins[1] |= (unsigned)(v < p.p_blue_own) << k;
    d.wins[2] |= (unsigned)(v < p.p_blue_away) << k;
  }
  // The spawn cells: MvN, each team's picks without replacement over its
  // territory in agent order (picks::pick_untaken); 1v1, a floor pick each.
  int taken_b[NB] = {}, taken_r[NR] = {};
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    const int cell = MVN ? picks::pick_untaken(ur[j], p.n_bt, j, taken_b) : floor_pick(ur[j], p.n_bt);
    const int2 e = s.terr[cell];
    d.spawn[j] = e.x;
    d.spawn_info[j] = e.y;
  }
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    const int cell =
        MVN ? picks::pick_untaken(ur[NB + j], p.n_rt, j, taken_r) : floor_pick(ur[NB + j], p.n_rt);
    const int2 e = s.terr[p.n_bt + cell];
    d.spawn[NB + j] = e.x;
    d.spawn_info[NB + j] = e.y;
  }
  return d;
}

// Words lane, lane + 32, ... of a run of N words from `src` to `dst` (both
// already offset by the lane), those below `n` of them (n is N less the
// lane for a full run).
template <int N>
__device__ __forceinline__ void copy_run(int* dst, const void* src, int lane, int n = N) {
  const int* from = static_cast<const int*>(src);
#pragma unroll
  for (int t = 0; t < (N + 31) / 32; ++t)
    if (32 * t + lane < N && 32 * t < n) copy_async::copy4(dst + 32 * t, from + 32 * t);
}

struct StepOut {
  float reward;
  bool ep_term;
};

// One transition of the env `e`, in place: the plain version's step, with
// the moves resolved on bit masks.
template <int NB, int NR, bool MVN>
__device__ __forceinline__ StepOut transition(const Params& p, const Shared& s,
                                              const Pre<NB + NR>& d, const int (&kind)[NR],
                                              Env<NB + NR>& e) {
  constexpr int A = NB + NR;
  int r[A], c[A];
  bool opp_in = false;  // any blue agent in red territory, flag included
#pragma unroll
  for (int i = 0; i < A; ++i) {
    r[i] = e.key[i] >> 16;
    c[i] = e.key[i] & 0xffff;
    if (i < NB) opp_in |= (e.info[i] & kRedOwn) != 0;
  }

  // ---- scripted red actions from the pre-move state ----
  // Every red agent's three targets are formed and its kind picks one;
  // the random action stays where the gate (0 for rw) says so.
  int act[A];
#pragma unroll
  for (int i = 0; i < A; ++i) act[i] = d.act[i];
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    const int i = NB + q;
    // The closest blue agent, ties to the first.
    int tr = r[0], tc = c[0];
    float best = sq_dist(r[0], c[0], r[i], c[i]);
#pragma unroll
    for (int j = 1; j < NB; ++j) {
      const float dj = sq_dist(r[j], c[j], r[i], c[i]);
      const bool closer = dj < best;
      best = closer ? dj : best;
      tr = closer ? r[j] : tr;
      tc = closer ? c[j] : tc;
    }
    // The closest border cell, or the pool pick when standing on it.
    const int near = key_of((e.info[i] >> kInfoRowShift) & kCoordMask,
                            (e.info[i] >> kInfoColShift) & kCoordMask);
    const int patrol = near == e.key[i] ? d.pool[i] : near;
    const bool patrols = kind[q] == kPatrol || (kind[q] == kPatrolFight && !opp_in);
    const int target = kind[q] == kCapture ? p.blue_flag : (patrols ? patrol : key_of(tr, tc));
    const int opt = optimal_action(r[i], c[i], target >> 16, target & 0xffff);
    act[i] = (d.opt >> i) & 1u ? opt : act[i];
  }

  // ---- each agent's target, read once: its info word and can bits ----
  int tkey[A], tinfo[A];
  unsigned can1 = 0u, can3 = 0u;  // alive and in bounds; and enterable too
#pragma unroll
  for (int i = 0; i < A; ++i) {
    const int tr = r[i] + nibble(kRowStep, act[i]) - 1, tc = c[i] + nibble(kColStep, act[i]) - 1;
    const bool inb = (unsigned)tr < (unsigned)p.bound0 && (unsigned)tc < (unsigned)p.bound1;
    // Off the bounds the index is any entry: the move is refused anyway.
    tinfo[i] = s.info[min((unsigned)tr, (unsigned)p.bound0 - 1u) * p.bound1 +
                      min((unsigned)tc, (unsigned)p.bound1 - 1u)];
    tkey[i] = key_of(tr, tc);  // off the bounds it matches no agent's key
    const bool c1 = inb && !((e.tm >> i) & 1u);
    can1 |= (unsigned)c1 << i;
    can3 |= (unsigned)(c1 && (tinfo[i] & kCanEnter)) << i;
  }

  // ---- sequential moves in slot order, on bit masks ----
  // Word m: bit j (j < 8) when agent j stands on m's target, bit 8 + j when
  // agent j's target is m's, bits 16 and 17 m's can bits.  Every agent
  // blocks, dead ones and the mover itself on stay.
  unsigned w[A];
#pragma unroll
  for (int m = 0; m < A; ++m) {
    unsigned on = 0u, same = 0u;
#pragma unroll
    for (int j = 0; j < A; ++j) {
      on |= (unsigned)(tkey[m] == e.key[j]) << j;
      if (j != m) same |= (unsigned)(tkey[m] == tkey[j]) << j;
    }
    w[m] = on | same << 8 | ((can3 >> m) & 1u) << 16 | ((can1 >> m) & 1u) << 17;
  }
  unsigned moved = 0u, bumped = 0u;
#pragma unroll
  for (int slot = 0; slot < A; ++slot) {
    const int m = nibble(d.order, slot);
    unsigned ws = w[0];
#pragma unroll
    for (int j = 1; j < A; ++j) ws = (unsigned)select_eq(m, j, (int)w[j], (int)ws);
    // Blocked: an agent that has not moved stands there, or one that has
    // went there.
    const bool blocked = ((ws & ~moved) | ((ws >> 8) & moved)) & 0xffu;
    moved |= ((ws >> 16) & 1u) && !blocked ? 1u << m : 0u;
    bumped |= ((ws >> 17) & 1u) && blocked ? 1u << m : 0u;
  }
#pragma unroll
  for (int i = 0; i < A; ++i) {
    const bool mv = (moved >> i) & 1u;
    e.key[i] = mv ? tkey[i] : e.key[i];
    e.info[i] = mv ? tinfo[i] : e.info[i];
    e.dir[i] = mv ? nibble(kDirOf, act[i]) : e.dir[i];
  }
  if (MVN && p.coll_penalty) {
    e.cl |= bumped;
    e.tm |= e.cl;
  }

  // ---- flags, territories, battles and the reward ----
  // The reward is a sum of terms c * flag in the plain version's order; a
  // term whose flag is 0 is +-0, which leaves every partial sum unchanged
  // (the sum starts at +0 and round-to-nearest never makes it -0), so only
  // the terms whose flag is 1 are added, still in order, and c * 1 is c.
  unsigned on_red = 0u, on_blue = 0u, own = 0u;
#pragma unroll
  for (int i = 0; i < A; ++i) {
    const bool blue = i < NB;
    if (blue) on_red |= (unsigned)(e.key[i] == p.red_flag) << i;
    if (!blue) on_blue |= (unsigned)(e.key[i] == p.blue_flag) << i;
    own |= (unsigned)((e.info[i] & (blue ? kBlueOwn : kRedOwn)) != 0) << i;
    r[i] = e.key[i] >> 16;
    c[i] = e.key[i] & 0xffff;
  }
  float reward = 0.f;
  if (MVN && p.coll_penalty) {  // the collided penalty
#pragma unroll
    for (int i = 0; i < NB; ++i)
      reward = (e.cl >> i) & 1u ? __fsub_rn(reward, p.obstacle_penalty) : reward;
  }
  // Flag captures, terminated agents included.
#pragma unroll
  for (int i = 0; i < NB; ++i)
    reward = (on_red >> i) & 1u ? __fadd_rn(reward, p.flag_reward) : reward;
#pragma unroll
  for (int i = NB; i < A; ++i)
    reward = (on_blue >> i) & 1u ? __fsub_rn(reward, p.flag_reward) : reward;
  bool ep_term = on_red != 0u || on_blue != 0u;
  // Battles, row-major and sequential (1v1 has the one pair (0, NB)).
#pragma unroll
  for (int k = 0; k < Shape<NB, NR, MVN>::pairs; ++k) {
    const int j = k / NR, i = NB + k % NR;
    const bool oj = (own >> j) & 1u, oi = (own >> i) & 1u;
    const unsigned wins = oj == oi ? d.wins[0] : (oj ? d.wins[1] : d.wins[2]);
    const bool win = (wins >> k) & 1u;
    // Both terms evaluated (no branch): the data is per thread.
    const bool eligible = (sq_dist(r[j], c[j], r[i], c[i]) <= p.battle_range2) &
                          !(((e.tm >> j) | (e.tm >> i)) & 1u);
    reward = eligible ? __fadd_rn(reward, win ? p.battle_reward : -p.battle_reward) : reward;
    e.tm |= eligible ? (win ? 1u << i : (MVN ? 1u << j : 0u)) : 0u;
    if (!MVN) ep_term |= eligible && !win;  // 1v1: blue losing ends the episode
  }
  if (MVN) {
    constexpr unsigned blue = (1u << NB) - 1u;
    ep_term |= (e.tm & blue) == blue;  // every blue agent is out
  } else if (p.obstacle_end && (e.info[0] & kObstacle)) {
    // 1v1: standing on an obstacle cell costs and ends the episode.
    reward = __fsub_rn(reward, p.obstacle_penalty);
    ep_term = true;
  }
  return StepOut{__fsub_rn(reward, p.step_penalty), ep_term};
}

// Named barrier 1 over a block's two warps.
__device__ __forceinline__ void pair_sync() { asm volatile("bar.sync 1, 64;" ::: "memory"); }

// Words of a Pre in shared memory.
template <int NB, int NR>
constexpr int kPreWords = 3 * (NB + NR) + NR + 5;

// A Pre to and from shared memory, word w of env e at slot[w * EW + e].
template <int NB, int NR, int EW>
__device__ __forceinline__ void put_pre(int* slot, const Pre<NB + NR>& d) {
  constexpr int A = NB + NR;
#pragma unroll
  for (int i = 0; i < A; ++i) {
    slot[EW * i] = d.act[i];
    slot[EW * (A + NR + i)] = d.spawn[i];
    slot[EW * (2 * A + NR + i)] = d.spawn_info[i];
  }
#pragma unroll
  for (int q = 0; q < NR; ++q) slot[EW * (A + q)] = d.pool[NB + q];
  int* w = slot + EW * (3 * A + NR);
  w[0] = (int)d.order;
  w[EW] = (int)d.opt;
#pragma unroll
  for (int j = 0; j < 3; ++j) w[EW * (2 + j)] = (int)d.wins[j];
}

template <int NB, int NR, int EW>
__device__ __forceinline__ Pre<NB + NR> get_pre(const int* slot) {
  constexpr int A = NB + NR;
  Pre<A> d;
#pragma unroll
  for (int i = 0; i < A; ++i) {
    d.act[i] = slot[EW * i];
    d.spawn[i] = slot[EW * (A + NR + i)];
    d.spawn_info[i] = slot[EW * (2 * A + NR + i)];
    d.pool[i] = i < NB ? 0 : slot[EW * (A + i - NB)];
  }
  const int* w = slot + EW * (3 * A + NR);
  d.order = (unsigned)w[0];
  d.opt = (unsigned)w[EW];
#pragma unroll
  for (int j = 0; j < 3; ++j) d.wins[j] = (unsigned)w[EW * (2 + j)];
  return d;
}

// Two warps a block, for the same EW envs: warp 1 copies each step's draws
// into the ring and decodes them into a Pre in shared memory; warp 0 runs
// the chain on the Pre warp 1 left a step before.  One named barrier a
// step hands a Pre over: the two slots alternate, so warp 1 decodes step
// kk + 1 while warp 0 runs step kk.
template <int NB, int NR, bool MVN>
__global__ void __launch_bounds__(64) steps_kernel(const Args a, const Params p) {
  using S = Shape<NB, NR, MVN>;
  constexpr int A = S::A, R = S::R, W = S::W, PW = kPreWords<NB, NR>;
  constexpr int G = kLanes<A>, EW = 32 / G;  // lanes an env, envs a block
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  const int B = p.B;
  const int n_terr = p.n_bt + p.n_rt, n_info = p.bound0 * p.bound1 + p.s0 * p.s1;
  const int n_table = 2 * n_terr + n_info + p.n_pool;
  const Shared s{reinterpret_cast<const int2*>(smem), smem + 2 * n_terr,
                 smem + 2 * n_terr + n_info, reinterpret_cast<const unsigned*>(smem + n_table)};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e = lane / G;  // the env's slot in the block
  const int k = lane % G;  // lane-group layout: this lane's agent
  const int b0 = blockIdx.x * EW, b = b0 + e;
  const int n_live = min(EW, B - b0);
  const bool live = b < B;
  // The ring: kStages steps of the block's EW records, each step as the
  // envs' action ids, then their step uniforms, then their spawn uniforms,
  // as they lie in global memory.  Slots no copy fills read as zeros.
  int* ring = smem + n_table + kNumOrders;
  int* pre = ring + kStages * EW * W;  // two slots of PW * EW words
  for (int i = threadIdx.x; i < n_table; i += 64) copy_async::copy4(smem + i, a.table + i);
  for (int i = threadIdx.x; i < kNumOrders; i += 64) smem[n_table + i] = kMoveOrders[i];
  copy_async::commit();
  int kind[NR];
  float popt[NR];
#pragma unroll
  for (int q = 0; q < NR; ++q) {
    kind[q] = a.kinds[q];
    popt[q] = a.p_opt[q];
  }
  if (warp == 1 && (n_live < EW || p.K < kStages)) {
    for (int i = lane; i < kStages * EW * W; i += 32) ring[i] = 0;
    __syncwarp();
  }
  // The three runs of a step's records are contiguous in global memory:
  // lane l of warp 1 copies words l, l + 32, ... of each, from pointers
  // that advance a step at a time.
  const int* src_a = a.blue_acts + (size_t)b0 * NB + lane;
  const float* src_u = a.rnd + (size_t)b0 * R + lane;
  const float* src_r = a.rnd_reset + (size_t)b0 * A + lane;
  const int n_a = n_live * NB - lane, n_u = n_live * R - lane, n_r = n_live * A - lane;
  auto issue = [&](int kk) {
    if (kk < p.K) {
      int* dst = ring + (kk % kStages) * EW * W + lane;
      if (n_live == EW) {  // every env of the block: no test a copy
        copy_run<EW * NB>(dst, src_a, lane);
        copy_run<EW * R>(dst + EW * NB, src_u, lane);
        copy_run<EW * A>(dst + EW * (NB + R), src_r, lane);
      } else {
        copy_run<EW * NB>(dst, src_a, lane, n_a);
        copy_run<EW * R>(dst + EW * NB, src_u, lane, n_u);
        copy_run<EW * A>(dst + EW * (NB + R), src_r, lane, n_r);
      }
      src_a += (size_t)B * NB;
      src_u += (size_t)B * R;
      src_r += (size_t)B * A;
    }
    copy_async::commit();
  };
  if (warp == 1) {
#pragma unroll
    for (int kk = 0; kk < kStages; ++kk) issue(kk);
    copy_async::wait<kStages>();  // the tables
  } else {
    copy_async::wait<0>();
  }
  __syncthreads();

  if (warp == 1) {
    // Warp 1: a Pre a step, written by the env's first lane.
    for (int kk = 0; kk < p.K; ++kk) {
      copy_async::wait<kStages - 1>();
      __syncwarp();
      const int* rec = ring + (kk % kStages) * EW * W;
      const float* u = reinterpret_cast<const float*>(rec + EW * NB) + e * R;
      const float* ur = reinterpret_cast<const float*>(rec + EW * (NB + R)) + e * A;
      const Pre<A> d = decode<NB, NR, MVN>(p, s, rec + e * NB, u, ur, kind, popt);
      __syncwarp();
      issue(kk + kStages);  // into the stage just decoded
      if (k == 0) put_pre<NB, NR, EW>(pre + (kk & 1) * PW * EW + e, d);
      pair_sync();  // step kk's Pre is in; warp 0 is done with step kk - 1's
    }
    return;
  }

  // Warp 0: the state and the chain.  Every agent in one thread; in the
  // lane-group layout, agent k in lane k and zeros elsewhere.
  Env<A> env;
  env.tm = env.cl = 0u;
  int sc = 0;
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < A; ++i) {
    env.key[i] = env.info[i] = env.dir[i] = 0;
    if (live && (G == 1 || i == k)) {
      const int r = a.pos[(size_t)b * 2 * A + 2 * i], c = a.pos[(size_t)b * 2 * A + 2 * i + 1];
      env.key[i] = key_of(r, c);
      env.info[i] = s.info[info_index(p, r, c)];
      env.dir[i] = a.dirs[(size_t)b * A + i];
      env.tm |= (unsigned)(a.term[(size_t)b * A + i] != 0) << i;
      env.cl |= (unsigned)(a.coll[(size_t)b * A + i] != 0) << i;
    }
  }
  if (live) {
    sc = a.sc[b];
    run = a.run_ret[b];
  }
  float rew_sum = 0.f, ep_sum = 0.f;
  int eps = 0;
  for (int kk = 0; kk < p.K; ++kk) {
    pair_sync();
    const Pre<A> cur = get_pre<NB, NR, EW>(pre + (kk & 1) * PW * EW + e);
    if constexpr (G > 1) {
      // Lane-group layout: agent i's state from lane i of the group.
      const int base = lane & ~(G - 1);
      unsigned tm = 0u, cl = 0u;
#pragma unroll
      for (int i = 0; i < A; ++i) {
        const int word = env.key[i] | env.dir[i] << 26 | (int)((env.tm >> i) & 1u) << 28 |
                         (int)((env.cl >> i) & 1u) << 29;
        const int got = __shfl_sync(kFull, word, base + i);
        env.info[i] = __shfl_sync(kFull, env.info[i], base + i);
        env.key[i] = got & 0x03ffffff;
        env.dir[i] = (got >> 26) & 3;
        tm |= (unsigned)((got >> 28) & 1) << i;
        cl |= (unsigned)((got >> 29) & 1) << i;
      }
      env.tm = tm;
      env.cl = cl;
    }
    const StepOut o = transition<NB, NR, MVN>(p, s, cur, kind, env);
    // The sums, in _ctf_ms_math's order; a finished env respawns.
    const int sc2 = sc + 1;
    const bool done = o.ep_term || sc2 >= p.max_steps;
    const float run2 = __fadd_rn(run, o.reward);
    rew_sum = __fadd_rn(rew_sum, o.reward);
    ep_sum = __fadd_rn(ep_sum, done ? run2 : 0.f);
    eps += done;
    run = done ? 0.f : run2;
    sc = done ? 0 : sc2;
#pragma unroll
    for (int i = 0; i < A; ++i) {
      env.key[i] = done ? cur.spawn[i] : env.key[i];
      env.info[i] = done ? cur.spawn_info[i] : env.info[i];
      env.dir[i] = done ? kSpawnDir : env.dir[i];
    }
    env.tm = done ? 0u : env.tm;
    env.cl = done ? 0u : env.cl;
  }

  if (live) {
#pragma unroll
    for (int i = 0; i < A; ++i) {
      if (G == 1 || i == k) {
        a.pos_out[(size_t)b * 2 * A + 2 * i] = env.key[i] >> 16;
        a.pos_out[(size_t)b * 2 * A + 2 * i + 1] = env.key[i] & 0xffff;
        a.dirs_out[(size_t)b * A + i] = env.dir[i];
        a.term_out[(size_t)b * A + i] = (env.tm >> i) & 1u;
        a.coll_out[(size_t)b * A + i] = (env.cl >> i) & 1u;
      }
    }
    if (k == 0) {
      a.sc_out[b] = sc;
      a.run_out[b] = run;
      a.rew_sum[b] = rew_sum;
      a.ep_sum[b] = ep_sum;
      a.eps[b] = eps;
    }
  }
}

template <int NB, int NR, bool MVN>
cudaError_t launch(const Args& a, const Params& p, cudaStream_t stream) {
  using S = Shape<NB, NR, MVN>;
  constexpr int EW = 32 / kLanes<S::A>;
  const size_t table = 2 * (size_t)(p.n_bt + p.n_rt) + (size_t)p.bound0 * p.bound1 +
                       (size_t)p.s0 * p.s1 + p.n_pool + kNumOrders;
  const size_t smem =
      sizeof(int) * (table + (size_t)kStages * EW * S::W + 2 * (size_t)EW * kPreWords<NB, NR>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        steps_kernel<NB, NR, MVN>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  steps_kernel<NB, NR, MVN><<<(p.B + EW - 1) / EW, 64, smem, stream>>>(a, p);
  return cudaGetLastError();
}

// The instance for n_blue and n_red agents: MvN for every split of 2 to 8
// agents, 1v1 for one against one.
cudaError_t launch_any(int n_blue, int n_red, bool mvn, const Args& a, const Params& p,
                       cudaStream_t st) {
  if (!mvn) return n_blue == 1 && n_red == 1 ? launch<1, 1, false>(a, p, st) : cudaErrorInvalidValue;
#define CTF_STEPS_CASE(NB, NR) \
  case NB * 16 + NR:           \
    return launch<NB, NR, true>(a, p, st);
  switch (n_blue * 16 + n_red) {
    CTF_STEPS_CASE(1, 1) CTF_STEPS_CASE(1, 2) CTF_STEPS_CASE(1, 3) CTF_STEPS_CASE(1, 4)
    CTF_STEPS_CASE(1, 5) CTF_STEPS_CASE(1, 6) CTF_STEPS_CASE(1, 7) CTF_STEPS_CASE(2, 1)
    CTF_STEPS_CASE(2, 2) CTF_STEPS_CASE(2, 3) CTF_STEPS_CASE(2, 4) CTF_STEPS_CASE(2, 5)
    CTF_STEPS_CASE(2, 6) CTF_STEPS_CASE(3, 1) CTF_STEPS_CASE(3, 2) CTF_STEPS_CASE(3, 3)
    CTF_STEPS_CASE(3, 4) CTF_STEPS_CASE(3, 5) CTF_STEPS_CASE(4, 1) CTF_STEPS_CASE(4, 2)
    CTF_STEPS_CASE(4, 3) CTF_STEPS_CASE(4, 4) CTF_STEPS_CASE(5, 1) CTF_STEPS_CASE(5, 2)
    CTF_STEPS_CASE(5, 3) CTF_STEPS_CASE(6, 1) CTF_STEPS_CASE(6, 2) CTF_STEPS_CASE(7, 1)
    default:
      return cudaErrorInvalidValue;
  }
#undef CTF_STEPS_CASE
}

}  // namespace ms

}  // namespace
}  // namespace ctf

// pos (B, 2A), dirs (B, A), blue_acts (B, n_blue) int32; term, coll (B, A)
// bool; rnd (B, rnd_cols) float32; flags (s0 * s1) uint8, one flag byte per
// cell (ops.ctf_slab.cell_flags); border (2, n_border), pool (2, n_pool)
// int32; kinds (n_red) int32 and p_opt (n_red) float32, each red agent's
// policy.  Outputs: pos, dirs (int32) and term, coll (bool) of the same
// shapes, reward (B, 1) float32, episode_term, rfc, bfc (B, 1), bbl
// (B, n_blue), brl (B, n_red) bool.  Launches on `stream` and returns the
// launch's cudaError_t.
extern "C" int ctf_step(const void* pos, const void* dirs, const void* term,
                        const void* coll, const void* blue_acts,
                        const void* rnd, const void* flags, const void* border,
                        const void* pool, const void* kinds, const void* p_opt,
                        void* pos_out, void* dirs_out, void* term_out,
                        void* coll_out, void* reward, void* ep_term, void* rfc,
                        void* bfc, void* bbl, void* brl, int B, int n_blue,
                        int n_red, int mvn, int s0, int s1, int bound0,
                        int bound1, int blue_flag0, int blue_flag1,
                        int red_flag0, int red_flag1, int n_border, int n_pool,
                        int rnd_cols, int coll_penalty, int obstacle_end,
                        float battle_range2, float p_blue_own,
                        float p_blue_away, float flag_reward,
                        float battle_reward, float obstacle_penalty,
                        float step_penalty, void* stream) {
  using namespace ctf;
  if (!valid(B, n_blue, n_red, s0, s1, n_border, n_pool)) return (int)cudaErrorInvalidValue;
  const Params p{B, n_blue, n_red, mvn, s0, s1, bound0, bound1,
                 blue_flag0, blue_flag1, red_flag0, red_flag1, n_border,
                 n_pool, rnd_cols, coll_penalty, obstacle_end, battle_range2,
                 p_blue_own, p_blue_away, flag_reward, battle_reward,
                 obstacle_penalty, step_penalty};
  using uchar = unsigned char;
  const Inputs in{(const int*)pos, (const int*)dirs, (const uchar*)term, (const uchar*)coll,
                  (const int*)blue_acts, (const float*)rnd, (const uchar*)flags,
                  (const int*)border, (const int*)pool, (const int*)kinds,
                  (const float*)p_opt};
  const Outputs out{(int*)pos_out, (int*)dirs_out, (uchar*)term_out, (uchar*)coll_out,
                    (float*)reward, (uchar*)ep_term, (uchar*)rfc, (uchar*)bfc,
                    (uchar*)bbl, (uchar*)brl};
  const size_t smem = table_bytes(n_border, n_pool, n_red, s0, s1);
  const int A = n_blue + n_red;
  auto run = A <= 4 ? launch<4> : launch<8>;
  return (int)run(in, out, p, smem, (cudaStream_t)stream);
}

// K steps with the auto-reset.  The state as for ctf_step, plus sc (B,)
// int32 and run_ret (B,) float32; blue_acts (K, B, n_blue) int32, rnd
// (K, B, rnd_cols) and rnd_reset (K, B, n_blue + n_red) float32; table
// (ops.ctf_slab.steps_table) int32: the blue then the red territory as
// (key, info word) pairs, n_bt and n_rt of them, the info word of every
// position (bound0 * bound1 + s0 * s1 of them) and the patrol pool as
// n_pool keys; kinds and p_opt as for ctf_step.  Outputs: pos, dirs, term,
// coll, sc and run_ret of the same shapes, rew_sum and ep_sum (B,)
// float32, eps (B,) int32.  Launches on `stream` and returns the launch's
// cudaError_t.
extern "C" int ctf_steps(const void* pos, const void* dirs, const void* term,
                         const void* coll, const void* sc, const void* run_ret,
                         const void* blue_acts, const void* rnd,
                         const void* rnd_reset, const void* table,
                         const void* kinds, const void* p_opt, void* pos_out,
                         void* dirs_out, void* term_out, void* coll_out,
                         void* sc_out, void* run_out, void* rew_sum,
                         void* ep_sum, void* eps, int B, int K, int n_blue,
                         int n_red, int mvn, int s0, int s1, int bound0,
                         int bound1, int blue_flag0, int blue_flag1,
                         int red_flag0, int red_flag1, int n_pool, int rnd_cols,
                         int coll_penalty, int obstacle_end, int n_bt, int n_rt,
                         int max_steps, float battle_range2, float p_blue_own,
                         float p_blue_away, float flag_reward,
                         float battle_reward, float obstacle_penalty,
                         float step_penalty, void* stream) {
  using namespace ctf;
  const int A = n_blue + n_red;
  if (B < 1 || K < 1 || n_blue < 1 || n_red < 1 || A > kMaxAgents || s0 < 1 || s1 < 1 ||
      s0 * s1 > kMaxCells || bound0 < 1 || bound1 < 1 || bound0 * bound1 > kMaxCells ||
      n_pool < 0 || n_pool > 4 * kMaxCells || n_bt < 1 || n_rt < 1 || n_bt > kMaxCells ||
      n_rt > kMaxCells || rnd_cols != (A <= 4 ? 1 : A - 1) + 3 * n_red + n_blue * n_red)
    return (int)cudaErrorInvalidValue;
  const ms::Params p{B, K, s0, s1, bound0, bound1,
                     ms::key_of(blue_flag0, blue_flag1), ms::key_of(red_flag0, red_flag1),
                     n_pool, coll_penalty, obstacle_end, n_bt, n_rt, max_steps,
                     battle_range2, p_blue_own, p_blue_away, flag_reward, battle_reward,
                     obstacle_penalty, step_penalty};
  using uchar = unsigned char;
  const ms::Args a{(const int*)pos, (const int*)dirs, (const uchar*)term, (const uchar*)coll,
                   (const int*)sc, (const float*)run_ret, (const int*)blue_acts,
                   (const float*)rnd, (const float*)rnd_reset, (const int*)table,
                   (const int*)kinds, (const float*)p_opt, (int*)pos_out, (int*)dirs_out,
                   (uchar*)term_out, (uchar*)coll_out, (int*)sc_out, (float*)run_out,
                   (float*)rew_sum, (float*)ep_sum, (int*)eps};
  return (int)ms::launch_any(n_blue, n_red, mvn != 0, a, p, (cudaStream_t)stream);
}
