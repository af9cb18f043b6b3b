// One Capture-the-Flag transition for a batch of envs, both variants
// (MvN and 1v1), written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel ctf_step_slab of gym_multigrid_tpu/ops/pallas_ctf.py
// (body _ctf_step_math).  Its plain PyTorch version is step_spec in
// gym_multigrid_tpu_torch/ops/ctf_slab.py and the two agree bit for bit.
//
// What bounds it on this card: latency, then memory.  An env's state is a
// few words per agent (under 200 bytes of inputs and outputs for 2v2), and
// its step is a chain of dependent decisions: the scripted red policies,
// the A movers one after another (each sees the moves before it), then the
// n_blue x n_red battles in row-major order.  The bytes of a whole batch of
// 8192 envs take well under a microsecond at the card's memory rate, so the
// launch and the latency of that chain set the time.  The design spreads an
// env over a group of G lanes (G = 4 up to 4 agents, 8 up to 8), so that a
// batch has G times the warps to hide each other's latency, and shortens
// the chain where the work is parallel:
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
// ops/ctf_slab.py, in one launch: the counterpart of ctf_step_slab's body
// on the JAX episode path, whose own K-step Pallas kernel was pruned on the
// TPU.  Both entries run the same transition (a __device__ function), so
// the state never leaves the lane group's registers between steps:
// - each step's draws (the blue actions and the step's uniforms, about
//   50 bytes an env at 2v2) reach a ring of kStages steps in shared memory
//   by 4-byte cp.async copies, each lane of the group copying every G-th
//   word of its env's record, kStages steps ahead of the step that reads
//   them, so a step waits on no global load;
// - the step's done flag and the sums (run_ret, rew_sum, ep_sum, eps) are
//   formed alike in every lane of the group from the first lane's reward,
//   with __fadd_rn in _ctf_ms_math's order, a +0 added where no episode
//   ended;
// - a finished env respawns in the kernel: each agent lane reads its
//   team's spawn uniforms (only on that step: the plain version draws them
//   every step and throws them away elsewhere, so skipping them changes
//   nothing) and repeats its team's picks up to its own, MvN as PickState
//   picks without replacement over the team's territory (the r-th cell not
//   yet taken, found by counting the taken ones in order), 1v1 as a floor
//   pick; the territories sit in shared memory beside the other tables.
// What bounds it: the step's chain, as for ctf_step, times K (50 steps
// take about as long at B = 64 as at B = 8192, scripts/torch_kernel_probe.py);
// the draws it reads, about 21 MB for 50 steps of 8192 envs at 2v2, would
// take about 6.4 us at the card's memory rate.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "copy_async.cuh"
#include "move_order.cuh"
#include "picks.cuh"

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
// Steps of draws the K-step entry keeps in flight ahead of the one it runs.
constexpr int kStages = 4;

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

// The K-step entry's own parameters.
struct MsParams {
  int K, n_bt, n_rt, max_steps;
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
  // The K-step entry only: step counts, running returns, the spawn
  // uniforms and the two territories ((2, n) int32, rows then columns).
  const int* sc;
  const float* run_ret;
  const float* rnd_reset;
  const int* bterr;
  const int* rterr;
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

struct MsOutputs {
  int* pos;
  int* dirs;
  unsigned char* term;
  unsigned char* coll;
  int* sc;
  float* run_ret;
  float* rew_sum;
  float* ep_sum;
  int* eps;
};

// The block's tables in shared memory.
struct Tables {
  const unsigned* orders;
  const int* border;  // (row, col) pairs
  const int* pool;    // (row, col) pairs
  const int* kind;    // per red agent
  const float* popt;  // per red agent
  const int* terr;    // blue then red territory, (row, col) pairs
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

// The closed-form first step of the reference A* on an open board.
__device__ __forceinline__ int optimal_action(int cr, int cc, int tr, int tc) {
  const int dr = tr - cr, dc = tc - cc;
  if (dr == 0 && dc == 0) return kStay;
  if (dr < 0) return kDown;
  if (dc != 0) return dc < 0 ? kLeft : kRight;
  return kUp;
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
// and pool lists, the red policies, the territories (n_bt and n_rt may be
// 0), then one flag byte per cell; the move orders go to `s_orders`.  One
// table entry per thread and round (one round for every board and list of
// the phase-2 configs), each round's loads before its stores, so that they
// are all in flight at once: measured, that order, and this register
// staging, beat 4-byte cp.async copies.  No barrier: the caller's follows.
__device__ __forceinline__ Tables load_tables(const Inputs& in, const Params& p, int n_bt,
                                              int n_rt, unsigned* s_orders, int* smem) {
  int* s_border = smem;                          // 2 * n_border
  int* s_pool = s_border + 2 * p.n_border;       // 2 * n_pool
  int* s_kind = s_pool + 2 * p.n_pool;           // n_red
  float* s_popt = (float*)(s_kind + p.n_red);    // n_red
  int* s_terr = (int*)(s_popt + p.n_red);        // 2 * (n_bt + n_rt)
  unsigned char* s_cell = (unsigned char*)(s_terr + 2 * (n_bt + n_rt));  // N
  const int N = p.s0 * p.s1, nr = p.n_red, n_terr = n_bt + n_rt;
  const int most = max(max(max(N, p.n_border), max(p.n_pool, kNumOrders)), n_terr);
  for (int i = threadIdx.x; i < most; i += kThreads) {
    const bool in_f = i < N, in_b = i < p.n_border, in_p = i < p.n_pool, in_k = i < nr;
    const bool in_o = i < kNumOrders, in_t = i < n_terr;
    const unsigned char f = in_f ? in.flags[i] : 0;
    const int b0 = in_b ? in.border[i] : 0, b1 = in_b ? in.border[p.n_border + i] : 0;
    const int q0 = in_p ? in.pool[i] : 0, q1 = in_p ? in.pool[p.n_pool + i] : 0;
    const int kind_i = in_k ? in.kinds[i] : 0;
    const float popt_i = in_k ? in.p_opt[i] : 0.f;
    const unsigned o = in_o ? kMoveOrders[i] : 0u;
    int t0 = 0, t1 = 0;
    if (in_t) {
      const bool blue = i < n_bt;
      const int* terr = blue ? in.bterr : in.rterr;
      const int j = blue ? i : i - n_bt, n = blue ? n_bt : n_rt;
      t0 = terr[j];
      t1 = terr[n + j];
    }
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
    if (in_t) {
      s_terr[2 * i] = t0;
      s_terr[2 * i + 1] = t1;
    }
  }
  return Tables{s_orders, s_border, s_pool, s_kind, s_popt, s_terr, s_cell};
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
  const Tables tables = load_tables(in, p, 0, 0, s_orders, smem);
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

// The cell index of agent `a` of its team's spawn among the team's n
// territory cells: MvN, pick a of the team's picks without replacement
// (picks::pick_untaken, after the picks of the agents before it); 1v1, a
// floor pick of its own uniform.  `u` holds the team's spawn uniforms.
__device__ __forceinline__ int spawn_cell(const float* u, int a, int n, bool mvn) {
  if (!mvn) return floor_pick(u[a], n);
  int taken[kMaxAgents - 1], cell = 0;
#pragma unroll
  for (int j = 0; j < kMaxAgents - 1; ++j) {
    if (j > a) break;
    const int c = picks::pick_untaken(u[j], n, j, taken);
    if (j == a) cell = c;
  }
  return cell;
}

template <int G>
__global__ void __launch_bounds__(kThreads)
steps_kernel(const Inputs in, const MsOutputs out, const Params p, const MsParams q, int ring_words) {
  constexpr int E = kThreads / G;  // envs per block
  __shared__ unsigned s_orders[kNumOrders];
  extern __shared__ int smem[];

  const int lane = threadIdx.x & 31;
  const int k = lane & (G - 1);
  const int gbase = lane & ~(G - 1);
  const int e = threadIdx.x / G;  // the env's slot in the block
  const int b = blockIdx.x * E + e;
  const bool live = b < p.B;
  const int nb = p.n_blue, nr = p.n_red, A = nb + nr, B = p.B;
  const bool agent = live && k < A;
  // The ring: kStages steps of E records of W words, each record the
  // env's n_blue action ids then its rnd_cols step uniforms.  The tables
  // follow it.
  const int W = nb + p.rnd_cols;
  int* ring = smem;

  // Lane k copies words k, k + G, ... of the env's record of step kk.
  auto issue = [&](int kk) {
    if (live && kk < q.K) {
      int* dst = ring + ((kk % kStages) * E + e) * W;
      const size_t row = (size_t)kk * B + b;
      for (int w = k; w < W; w += G) {
        const void* src = w < nb ? (const void*)(in.blue_acts + row * nb + w)
                                 : (const void*)(in.rnd + row * p.rnd_cols + (w - nb));
        copy_async::copy4(dst + w, src);
      }
    }
    copy_async::commit();
  };
#pragma unroll
  for (int kk = 0; kk < kStages; ++kk) issue(kk);

  const Tables tables = load_tables(in, p, q.n_bt, q.n_rt, s_orders, smem + ring_words);
  int px = -0x40000000, py = -0x40000000, tm = 1, cl = 0, dr = 0, sc = 0;
  float run = 0.f;
  if (agent) {
    px = in.pos[(size_t)b * 2 * A + 2 * k];
    py = in.pos[(size_t)b * 2 * A + 2 * k + 1];
    tm = in.term[(size_t)b * A + k];
    cl = in.coll[(size_t)b * A + k];
    dr = in.dirs[(size_t)b * A + k];
  }
  if (live) {
    sc = in.sc[b];
    run = in.run_ret[b];
  }
  __syncthreads();

  // This lane's team: its territory and its place in the team's picks.
  const bool blue = k < nb;
  const int a = blue ? k : k - nb, n_terr = blue ? q.n_bt : q.n_rt;
  const int* terr = tables.terr + (blue ? 0 : 2 * q.n_bt);
  float rew_sum = 0.f, ep_sum = 0.f;
  int eps = 0;
  for (int kk = 0; kk < q.K; ++kk) {
    copy_async::wait<kStages - 1>();
    __syncwarp();
    const int* rec = ring + ((kk % kStages) * E + e) * W;
    const Draws<G> draws = read_draws<G>(p, rec, (const float*)(rec + nb), k, live, agent);
    __syncwarp();
    issue(kk + kStages);  // into the stage just read

    const StepResult res =
        transition<G>(p, tables, k, gbase, live, agent, px, py, tm, cl, dr, draws);
    // The sums, alike in every lane of the group.
    const float reward = __shfl_sync(kFull, res.reward, gbase);
    const bool ep_term = __shfl_sync(kFull, (int)res.ep_term, gbase) != 0;
    const int sc2 = sc + 1;
    const bool done = ep_term || sc2 >= q.max_steps;
    const float run2 = __fadd_rn(run, reward);
    rew_sum = __fadd_rn(rew_sum, reward);
    ep_sum = __fadd_rn(ep_sum, done ? run2 : 0.f);
    eps += done;
    run = done ? 0.f : run2;
    sc = done ? 0 : sc2;
    if (done && agent) {
      const float* u = in.rnd_reset + ((size_t)kk * B + b) * A + (blue ? 0 : nb);
      const int idx = spawn_cell(u, a, n_terr, p.mvn);
      px = terr[2 * idx];
      py = terr[2 * idx + 1];
      dr = kSpawnDir;
      tm = 0;
      cl = 0;
    }
  }

  if (agent) {
    out.pos[(size_t)b * 2 * A + 2 * k] = px;
    out.pos[(size_t)b * 2 * A + 2 * k + 1] = py;
    out.dirs[(size_t)b * A + k] = dr;
    out.term[(size_t)b * A + k] = tm;
    out.coll[(size_t)b * A + k] = cl;
  }
  if (live && k == 0) {
    out.sc[b] = sc;
    out.run_ret[b] = run;
    out.rew_sum[b] = rew_sum;
    out.ep_sum[b] = ep_sum;
    out.eps[b] = eps;
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

template <int G>
cudaError_t launch_steps(const Inputs& in, const MsOutputs& out, const Params& p,
                         const MsParams& q, size_t table_bytes, cudaStream_t stream) {
  constexpr int E = kThreads / G;
  const int ring_words = kStages * E * (p.n_blue + p.rnd_cols);
  const size_t smem = sizeof(int) * (size_t)ring_words + table_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        steps_kernel<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (p.B + E - 1) / E;
  steps_kernel<G><<<blocks, kThreads, smem, stream>>>(in, out, p, q, ring_words);
  return cudaGetLastError();
}

// The scalar arguments both entries share, checked.
bool valid(int B, int n_blue, int n_red, int s0, int s1, int n_border, int n_pool) {
  const int A = n_blue + n_red;
  return B >= 1 && n_blue >= 1 && n_red >= 1 && A <= kMaxAgents && s0 >= 1 && s1 >= 1 &&
         s0 * s1 <= kMaxCells && n_border >= 1 && n_border <= kMaxCells && n_pool >= 0 &&
         n_pool <= 4 * kMaxCells;
}

// Shared memory of the tables (load_tables' layout).
size_t table_bytes(int n_border, int n_pool, int n_red, int n_terr, int s0, int s1) {
  return sizeof(int) * (2 * (size_t)n_border + 2 * (size_t)n_pool + 2 * (size_t)n_red +
                        2 * (size_t)n_terr) +
         (size_t)s0 * s1;
}

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
                  (const float*)p_opt, nullptr, nullptr, nullptr, nullptr, nullptr};
  const Outputs out{(int*)pos_out, (int*)dirs_out, (uchar*)term_out, (uchar*)coll_out,
                    (float*)reward, (uchar*)ep_term, (uchar*)rfc, (uchar*)bfc,
                    (uchar*)bbl, (uchar*)brl};
  const size_t smem = table_bytes(n_border, n_pool, n_red, 0, s0, s1);
  const int A = n_blue + n_red;
  auto run = A <= 4 ? launch<4> : launch<8>;
  return (int)run(in, out, p, smem, (cudaStream_t)stream);
}

// K steps with the auto-reset.  The state as for ctf_step, plus sc (B,)
// int32 and run_ret (B,) float32; blue_acts (K, B, n_blue) int32, rnd
// (K, B, rnd_cols) and rnd_reset (K, B, n_blue + n_red) float32; bterr
// (2, n_bt) and rterr (2, n_rt) int32, the spawn territories.  Outputs:
// pos, dirs, term, coll, sc and run_ret of the same shapes, rew_sum and
// ep_sum (B,) float32, eps (B,) int32.  Launches on `stream` and returns
// the launch's cudaError_t.
extern "C" int ctf_steps(const void* pos, const void* dirs, const void* term,
                         const void* coll, const void* sc, const void* run_ret,
                         const void* blue_acts, const void* rnd,
                         const void* rnd_reset, const void* flags,
                         const void* border, const void* pool,
                         const void* bterr, const void* rterr,
                         const void* kinds, const void* p_opt, void* pos_out,
                         void* dirs_out, void* term_out, void* coll_out,
                         void* sc_out, void* run_out, void* rew_sum,
                         void* ep_sum, void* eps, int B, int K, int n_blue,
                         int n_red, int mvn, int s0, int s1, int bound0,
                         int bound1, int blue_flag0, int blue_flag1,
                         int red_flag0, int red_flag1, int n_border,
                         int n_pool, int rnd_cols, int coll_penalty,
                         int obstacle_end, int n_bt, int n_rt, int max_steps,
                         float battle_range2, float p_blue_own,
                         float p_blue_away, float flag_reward,
                         float battle_reward, float obstacle_penalty,
                         float step_penalty, void* stream) {
  using namespace ctf;
  if (!valid(B, n_blue, n_red, s0, s1, n_border, n_pool) || K < 1 || n_bt < 1 ||
      n_rt < 1 || n_bt > kMaxCells || n_rt > kMaxCells)
    return (int)cudaErrorInvalidValue;
  const Params p{B, n_blue, n_red, mvn, s0, s1, bound0, bound1,
                 blue_flag0, blue_flag1, red_flag0, red_flag1, n_border,
                 n_pool, rnd_cols, coll_penalty, obstacle_end, battle_range2,
                 p_blue_own, p_blue_away, flag_reward, battle_reward,
                 obstacle_penalty, step_penalty};
  const MsParams q{K, n_bt, n_rt, max_steps};
  using uchar = unsigned char;
  const Inputs in{(const int*)pos, (const int*)dirs, (const uchar*)term, (const uchar*)coll,
                  (const int*)blue_acts, (const float*)rnd, (const uchar*)flags,
                  (const int*)border, (const int*)pool, (const int*)kinds,
                  (const float*)p_opt, (const int*)sc, (const float*)run_ret,
                  (const float*)rnd_reset, (const int*)bterr, (const int*)rterr};
  const MsOutputs out{(int*)pos_out, (int*)dirs_out, (uchar*)term_out, (uchar*)coll_out,
                      (int*)sc_out, (float*)run_out, (float*)rew_sum, (float*)ep_sum,
                      (int*)eps};
  const size_t tables = table_bytes(n_border, n_pool, n_red, n_bt + n_rt, s0, s1);
  const int A = n_blue + n_red;
  auto run = A <= 4 ? launch_steps<4> : launch_steps<8>;
  return (int)run(in, out, p, q, tables, (cudaStream_t)stream);
}
