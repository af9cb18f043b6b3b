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

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "move_order.cuh"

namespace ctf {
namespace {

using move_order::kMoveOrders;
using move_order::kNumOrders;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxAgents = 8;
constexpr int kMaxCells = 1024;
constexpr int kThreads = 256;
constexpr int kNumActions = 5;

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

__device__ __forceinline__ int floor_pick(float u, int n) {
  // min(floor(u * n), n - 1) with the product rounded as float32.
  return min(__float2int_rz(__fmul_rn(u, (float)n)), n - 1);
}

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

template <int G>
__global__ void __launch_bounds__(kThreads)
step_kernel(const Inputs in, const Outputs out, const Params p) {
  // Up to G/2 x G/2 battle pairs over G lanes.
  constexpr int kPairSlots = G / 4;
  // Shared tables: the move orders; the border and pool lists as (row, col)
  // pairs, the red policies, then one flag byte per cell.
  __shared__ unsigned s_orders[kNumOrders];
  extern __shared__ int smem[];
  int* s_border = smem;                          // 2 * n_border
  int* s_pool = s_border + 2 * p.n_border;       // 2 * n_pool
  int* s_kind = s_pool + 2 * p.n_pool;           // n_red
  float* s_popt = (float*)(s_kind + p.n_red);    // n_red
  unsigned char* s_cell = (unsigned char*)(s_popt + p.n_red);  // N

  const int lane = threadIdx.x & 31;
  const int k = lane & (G - 1);       // this lane's agent
  const int gbase = lane & ~(G - 1);  // the group's first lane
  const int b = (blockIdx.x * kThreads + (int)threadIdx.x) / G;
  // Lanes past the batch run along with no loads or stores: every lane of
  // the warp takes part in its shuffles and ballots.
  const bool live = b < p.B;
  const int nb = p.n_blue, nr = p.n_red, A = nb + nr;
  const bool agent = live && k < A;
  const int perm_draws = A <= 4 ? 1 : A - 1;
  const int n_pairs = p.mvn ? nb * nr : 1;
  const int ub_base = perm_draws + 3 * nr;

  // ---- the block's tables, then this lane's loads ----
  // One table entry per thread and round (one round for every board and
  // list of the phase-2 configs), each round's loads before its stores, so
  // that they are all in flight at once.  The tables first: measured, that
  // order, and this register staging, beat 4-byte cp.async copies and the
  // per-env loads first.
  const int N = p.s0 * p.s1;
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

  // ---- this lane's loads ----
  // Not an agent: off the board and terminated, so it never matches a
  // cell, a target or a battle.
  int px = -0x40000000, py = -0x40000000, tm = 1, cl = 0, dr = 0, act = 0;
  float u_perm = 0.f, u_t = 0.f, u_g = 0.f, u_a = 0.f;
  float u_pair[kPairSlots];
  const float* u = in.rnd + (size_t)b * p.rnd_cols;
  if (agent) {
    px = in.pos[(size_t)b * 2 * A + 2 * k];
    py = in.pos[(size_t)b * 2 * A + 2 * k + 1];
    tm = in.term[(size_t)b * A + k];
    cl = in.coll[(size_t)b * A + k];
    dr = in.dirs[(size_t)b * A + k];
    if (k < nb) {
      act = in.blue_acts[(size_t)b * nb + k];  // clamped after the barrier: no wait here
    } else {
      const int base = perm_draws + 3 * (k - nb);
      u_t = u[base];
      u_g = u[base + 1];
      u_a = u[base + 2];
    }
  }
  if (live && k < perm_draws) u_perm = u[k];
#pragma unroll
  for (int q = 0; q < kPairSlots; ++q) {
    const int pair = k + G * q;
    u_pair[q] = live && pair < n_pairs ? u[ub_base + pair] : 1.f;
  }
  __syncthreads();
  if (k < nb) act = min(max(act, 0), kNumActions - 1);

  auto cell = [&](int x, int y) -> unsigned char {
    const int qx = min(max(x, 0), p.s0 - 1), qy = min(max(y, 0), p.s1 - 1);
    return s_cell[qx * p.s1 + qy];
  };

  // ---- the move order: MvN shuffles it, 1v1 is blue then red ----
  // The mover of each slot, 4 bits a slot; it depends on no position, so
  // it is found first and its latency overlaps the red policies'.
  unsigned order = 0x76543210u;
  if (p.mvn && A <= 4) {
    const int j = floor_pick(__shfl_sync(kFull, u_perm, gbase), move_order::num_orders(A));
    order = s_orders[move_order::move_order_base(A) + j];
  } else if (p.mvn) {
    // Fisher-Yates: slot s moves the floor(u_s * (A - s))-th agent (0-based)
    // that has not moved yet.
    unsigned taken = 0u;
    order = 0u;
    for (int slot = 0; slot < A; ++slot) {
      const float u_s = __shfl_sync(kFull, u_perm, gbase + min(slot, G - 1));
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
  const int kind = agent && k >= nb ? s_kind[k - nb] : kRw;
  const int rand_act = floor_pick(u_a, kNumActions);
  const bool optimal = kind != kRw && u_g < s_popt[max(k - nb, 0)];
  int prow = 0, pcol = 0;
  if ((kind == kPatrol || kind == kPatrolFight) && p.n_pool > 0) {
    const int j = floor_pick(u_t, p.n_pool);
    prow = s_pool[2 * j];
    pcol = s_pool[2 * j + 1];
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
      const float d = sq_dist(jr, jc, px, py);
      if (j == 0 || d < best) {
        best = d;
        trow = jr;
        tcol = jc;
      }
    }
  }
  // Each patrolling red lane's closest border cell, found by the whole
  // group, one red agent after another.
  bool onb = false;
  for (int r = 0; r < nr; ++r) {
    const int kind_r = s_kind[r];
    if (kind_r != kPatrol && kind_r != kPatrolFight) continue;
    const int cr = __shfl_sync(kFull, px, gbase + nb + r);
    const int cc = __shfl_sync(kFull, py, gbase + nb + r);
    // Lane k scans cells k, k + G, ...
    float d = INFINITY;
    int j = INT_MAX;
    bool on = false;
    for (int q = k; q < p.n_border; q += G) {
      const int qr = s_border[2 * q], qc = s_border[2 * q + 1];
      on |= cr == qr && cc == qc;
      const float dq = sq_dist(cr, cc, qr, qc);
      if (dq < d) {
        d = dq;
        j = q;
      }
    }
    group_argmin<G>(d, j);
    const bool on_any = group_bits<G>(on, gbase) != 0;
    if (k == nb + r) {
      onb = on_any;
      brow = s_border[2 * j];
      bcol = s_border[2 * j + 1];
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

  if (agent) {  // final: the battles change none of these
    out.pos[(size_t)b * 2 * A + 2 * k] = px;
    out.pos[(size_t)b * 2 * A + 2 * k + 1] = py;
    out.dirs[(size_t)b * A + k] = dr;
    out.coll[(size_t)b * A + k] = cl;
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
    blue_wins |= group_bits<G>(has && u_pair[q] < p_blue, gbase) << (G * q);
  }

  // The reward is a sum of terms c * flag in the plain version's order; a
  // term whose flag is 0 is +-0, which leaves every partial sum unchanged
  // (the sum starts at +0 and round-to-nearest never makes it -0), so
  // only the terms whose flag is 1 are added, still in order, and c * 1 is
  // c.
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
    reward = __fsub_rn(reward, p.step_penalty);
    out.reward[b] = reward;
    out.ep_term[b] = ep_term;
    out.rfc[b] = rfc;
    out.bfc[b] = bfc;
  }
  tmask = __shfl_sync(kFull, tmask, gbase);
  bbl = __shfl_sync(kFull, bbl, gbase);
  brl = __shfl_sync(kFull, brl, gbase);

  if (agent) {
    out.term[(size_t)b * A + k] = (tmask >> k) & 1u;
    if (k < nb)
      out.bbl[(size_t)b * nb + k] = (bbl >> k) & 1u;
    else
      out.brl[(size_t)b * nr + (k - nb)] = (brl >> k) & 1u;
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
  const int A = n_blue + n_red;
  if (B < 1 || n_blue < 1 || n_red < 1 || A > kMaxAgents || s0 < 1 || s1 < 1 ||
      s0 * s1 > kMaxCells || n_border < 1 || n_border > kMaxCells ||
      n_pool < 0 || n_pool > 4 * kMaxCells)
    return (int)cudaErrorInvalidValue;
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
  const size_t smem = sizeof(int) * (2 * (size_t)n_border + 2 * (size_t)n_pool +
                                     2 * (size_t)n_red) +
                      (size_t)s0 * s1;
  auto run = A <= 4 ? launch<4> : launch<8>;
  return (int)run(in, out, p, smem, (cudaStream_t)stream);
}
