// One Capture-the-Flag transition for a batch of envs, both variants
// (MvN and 1v1), written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel ctf_step_slab of gym_multigrid_tpu/ops/pallas_ctf.py
// (body _ctf_step_math).  Its plain PyTorch version is step_spec in
// gym_multigrid_tpu_torch/ops/ctf_slab.py and the two agree bit for bit.
//
// What bounds it on this card: latency, then memory.  An env's state is a
// few ints per agent (244 bytes of inputs and outputs for 2v2), and its step
// is a short chain of dependent decisions: the scripted red policies, the
// A movers one after another (each sees the moves before it), then the
// n_blue x n_red battles in row-major order.  The bytes of a whole batch of
// 8192 envs take well under a microsecond at the card's memory rate, so the
// launch and the length of that chain set the time.  The design:
// - one thread per env, its agents in registers as fixed arrays of
//   kMaxAgents entries indexed only by unrolled loop counters (a mover's
//   slot is selected by predicated compares, never by a dynamic index, so
//   nothing spills to local memory); a warp per env would leave 31 lanes
//   idle on a sequential chain;
// - blocks of 64 threads, so that B = 8192 spreads over 128 blocks and most
//   of the card's 132 SMs;
// - the static per-cell tables (can_enter, blue and red territory,
//   obstacles), the patrol border and pool lists and the red policies are
//   loaded once per block into shared memory, one byte of flags per cell,
//   and read by index.  The TPU kernel's one-hot lane reductions over the
//   board were a TPU workaround and are not carried over;
// - the MvN move order for up to 4 agents is the j-th permutation of the
//   A! table in lexicographic order (itertools.permutations); it is decoded
//   from j digit by digit (factorial number system), which gives the same
//   mover for each slot with no table.  Beyond 4 agents the order is drawn
//   by Fisher-Yates, as in the plain version;
// - every float constant arrives as a float argument, rounded once on the
//   host from a double, and the reward is summed with __fadd_rn/__fmul_rn
//   in the plain version's order, so no multiply-add is contracted into an
//   FMA; floor(u * n) picks are __fmul_rn then __float2int_rz.
// Cell lookups clip the position to the board first: the move's bounds
// check uses the reference's swapped bounds (row against S1, column
// against S0), so on a non-square board an in-bounds target can lie off
// the board, and an unclipped index would leave the table.

#include <cuda_runtime.h>

namespace ctf {
namespace {

constexpr int kMaxAgents = 8;
constexpr int kMaxCells = 1024;
constexpr int kThreads = 64;
constexpr int kNumActions = 5;

// Policy kinds: their index in POLICY_KINDS of envs/ctf.py.
constexpr int kRw = 0, kFight = 1, kCapture = 2, kPatrol = 3, kPatrolFight = 4;
// Actions: stay, left, down, right, up.
constexpr int kStay = 0, kLeft = 1, kDown = 2, kRight = 3, kUp = 4;
// Cell flag bits.
constexpr unsigned char kCanEnter = 1, kBlueOwn = 2, kRedOwn = 4, kObstacle = 8;

struct Params {
  int B, n_blue, n_red, mvn, s0, s1, bound0, bound1;
  int blue_flag0, blue_flag1, red_flag0, red_flag1;
  int n_border, n_pool, rnd_cols, coll_penalty, obstacle_end;
  float battle_range2, p_blue_own, p_blue_away, flag_reward, battle_reward;
  float obstacle_penalty, step_penalty;
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

template <int NA>
__global__ void __launch_bounds__(kThreads)
step_kernel(const int* __restrict__ pos, const int* __restrict__ dirs,
            const int* __restrict__ term, const int* __restrict__ coll,
            const int* __restrict__ blue_acts, const float* __restrict__ rnd,
            const int* __restrict__ cells, const int* __restrict__ border,
            const int* __restrict__ pool, const int* __restrict__ kinds,
            const float* __restrict__ p_opt, int* __restrict__ pos_out,
            int* __restrict__ dirs_out, int* __restrict__ term_out,
            int* __restrict__ coll_out, float* __restrict__ reward_out,
            int* __restrict__ ep_term_out, int* __restrict__ rfc_out,
            int* __restrict__ bfc_out, int* __restrict__ bbl_out,
            int* __restrict__ brl_out, const Params p) {
  // Shared tables: one flag byte per cell, then the border and pool lists
  // as (row, col) pairs, then the red policies.
  extern __shared__ int smem[];
  int* s_border = smem;                          // 2 * n_border
  int* s_pool = s_border + 2 * p.n_border;       // 2 * n_pool
  int* s_kind = s_pool + 2 * p.n_pool;           // n_red
  float* s_popt = (float*)(s_kind + p.n_red);    // n_red
  unsigned char* s_cell = (unsigned char*)(s_popt + p.n_red);  // N
  const int N = p.s0 * p.s1;
  for (int c = threadIdx.x; c < N; c += blockDim.x)
    s_cell[c] = (cells[c] > 0 ? kCanEnter : 0) | (cells[N + c] > 0 ? kBlueOwn : 0) |
                (cells[2 * N + c] > 0 ? kRedOwn : 0) |
                (cells[3 * N + c] > 0 ? kObstacle : 0);
  for (int k = threadIdx.x; k < p.n_border; k += blockDim.x) {
    s_border[2 * k] = border[k];
    s_border[2 * k + 1] = border[p.n_border + k];
  }
  for (int k = threadIdx.x; k < p.n_pool; k += blockDim.x) {
    s_pool[2 * k] = pool[k];
    s_pool[2 * k + 1] = pool[p.n_pool + k];
  }
  for (int r = threadIdx.x; r < p.n_red; r += blockDim.x) {
    s_kind[r] = kinds[r];
    s_popt[r] = p_opt[r];
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  const int nb = p.n_blue, A = p.n_blue + p.n_red;

  auto cell = [&](int x, int y) -> unsigned char {
    const int qx = min(max(x, 0), p.s0 - 1), qy = min(max(y, 0), p.s1 - 1);
    return s_cell[qx * p.s1 + qy];
  };

  int px[NA], py[NA], tm[NA], cl[NA], dr[NA], act[NA];
#pragma unroll
  for (int k = 0; k < NA; ++k) {
    if (k < A) {
      px[k] = pos[(size_t)b * 2 * A + 2 * k];
      py[k] = pos[(size_t)b * 2 * A + 2 * k + 1];
      tm[k] = term[(size_t)b * A + k];
      cl[k] = coll[(size_t)b * A + k];
      dr[k] = dirs[(size_t)b * A + k];
    } else {
      // Off the board and terminated: never matches a cell or a battle.
      px[k] = py[k] = -0x40000000;
      tm[k] = 1;
      cl[k] = dr[k] = 0;
    }
    act[k] = 0;
  }
  const float* u = rnd + (size_t)b * p.rnd_cols;
  const int perm_draws = A <= 4 ? 1 : A - 1;

  // ---- scripted red actions from the pre-move state ----
#pragma unroll
  for (int k = 0; k < NA; ++k) {
    if (k >= A) continue;
    if (k < nb) {
      act[k] = min(max(blue_acts[(size_t)b * nb + k], 0), kNumActions - 1);
      continue;
    }
    const int r = k - nb, base = perm_draws + 3 * r;
    const float u_t = u[base], u_g = u[base + 1], u_a = u[base + 2];
    const int kind = s_kind[r];
    const int rand_act = floor_pick(u_a, kNumActions);
    if (kind == kRw) {
      act[k] = rand_act;
      continue;
    }
    const int cr = px[k], cc = py[k];
    int trow, tcol;
    if (kind == kCapture) {
      trow = p.blue_flag0;
      tcol = p.blue_flag1;
    } else {
      // Closest blue agent; ties go to the first.
      float best = 0.f;
      trow = tcol = 0;
#pragma unroll
      for (int j = 0; j < NA; ++j) {
        if (j >= nb) continue;
        const float d = sq_dist(px[j], py[j], cr, cc);
        if (j == 0 || d < best) {
          best = d;
          trow = px[j];
          tcol = py[j];
        }
      }
    }
    if (kind == kPatrol || kind == kPatrolFight) {
      bool onb = false;
      int brow = 0, bcol = 0;
      float best = 0.f;
      for (int j = 0; j < p.n_border; ++j) {
        const int qr = s_border[2 * j], qc = s_border[2 * j + 1];
        onb |= cr == qr && cc == qc;
        // Closest border cell; ties go to the first.
        const float d = sq_dist(cr, cc, qr, qc);
        if (j == 0 || d < best) {
          best = d;
          brow = qr;
          bcol = qc;
        }
      }
      int prow = 0, pcol = 0;
      if (p.n_pool > 0) {
        const int j = floor_pick(u_t, p.n_pool);
        prow = s_pool[2 * j];
        pcol = s_pool[2 * j + 1];
      }
      const int patrol_row = onb ? prow : brow, patrol_col = onb ? pcol : bcol;
      bool opp_in = false;  // any blue in red territory, flag included
      if (kind == kPatrolFight) {
#pragma unroll
        for (int j = 0; j < NA; ++j)
          if (j < nb) opp_in |= (cell(px[j], py[j]) & kRedOwn) != 0;
      }
      if (!opp_in) {
        trow = patrol_row;
        tcol = patrol_col;
      }
    }
    act[k] = u_g < s_popt[r] ? optimal_action(cr, cc, trow, tcol) : rand_act;
  }

  // ---- sequential moves: MvN shuffles the order, 1v1 is blue then red ----
  int perm_j = 0, radix = 1;
  if (p.mvn && A <= 4) {
    int fact = 1;
    for (int k = 2; k <= A; ++k) fact *= k;
    perm_j = floor_pick(u[0], fact);
    radix = fact;  // (A - slot)! before slot's digit is taken
  }
  unsigned taken = 0u;
#pragma unroll
  for (int slot = 0; slot < NA; ++slot) {
    if (slot >= A) continue;
    int mover = slot;
    if (p.mvn) {
      // The r-th agent (0-based) that has not moved yet moves now.
      const int remaining = A - slot;
      int r_pick;
      if (A <= 4) {
        // Digit of j in the factorial number system: the lexicographic
        // j-th permutation of 0..A-1.
        radix /= remaining;
        r_pick = perm_j / radix;
        perm_j -= r_pick * radix;
      } else {
        r_pick = slot < A - 1 ? floor_pick(u[slot], remaining) : 0;
      }
      int cnt = 0;
      mover = 0;
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const bool free_i = i < A && !((taken >> i) & 1u);
        if (free_i && cnt == r_pick) mover = i;
        cnt += free_i;
      }
      taken |= 1u << mover;
    }
    int a = 0, cr = 0, cc = 0, t_m = 0;
#pragma unroll
    for (int i = 0; i < NA; ++i)
      if (i == mover) {
        a = act[i];
        cr = px[i];
        cc = py[i];
        t_m = tm[i];
      }
    const bool alive = t_m == 0;
    const int nr = cr + dx_of(a), nc = cc + dy_of(a);
    const bool inb = nr >= 0 && nc >= 0 && nr < p.bound0 && nc < p.bound1;
    const bool static_ok = (cell(nr, nc) & kCanEnter) != 0;
    // Every agent blocks: dead ones, and the mover itself on stay.
    bool occupied = false;
#pragma unroll
    for (int i = 0; i < NA; ++i) occupied |= i < A && px[i] == nr && py[i] == nc;
    const bool can_move = alive && inb && static_ok && !occupied;
    const bool bump = p.coll_penalty && alive && inb && occupied;
#pragma unroll
    for (int i = 0; i < NA; ++i)
      if (i == mover) {
        if (p.coll_penalty) cl[i] = max(cl[i], (int)bump);
        if (can_move) {
          px[i] = nr;
          py[i] = nc;
          dr[i] = dir_of(a);
        }
      }
  }

  // ---- collided penalty and termination, MvN only ----
  float reward = 0.f;
  bool ep_term = false;
  if (p.coll_penalty) {
#pragma unroll
    for (int i = 0; i < NA; ++i)
      if (i < nb) reward = __fsub_rn(reward, __fmul_rn(p.obstacle_penalty, (float)cl[i]));
#pragma unroll
    for (int i = 0; i < NA; ++i) tm[i] = max(tm[i], cl[i]);
  }

  // ---- flag captures, terminated agents included ----
  bool rfc = false, bfc = false;
#pragma unroll
  for (int i = 0; i < NA; ++i)
    if (i < nb) {
      const bool on = px[i] == p.red_flag0 && py[i] == p.red_flag1;
      reward = __fadd_rn(reward, __fmul_rn(p.flag_reward, on ? 1.f : 0.f));
      rfc |= on;
    }
#pragma unroll
  for (int i = 0; i < NA; ++i)
    if (i >= nb && i < A) {
      const bool on = px[i] == p.blue_flag0 && py[i] == p.blue_flag1;
      reward = __fsub_rn(reward, __fmul_rn(p.flag_reward, on ? 1.f : 0.f));
      bfc |= on;
    }
  ep_term = rfc || bfc;

  // ---- battles, row-major and sequential ----
  bool own[NA];  // blue agents in blue territory, red agents in red
#pragma unroll
  for (int i = 0; i < NA; ++i)
    own[i] = i < A && (cell(px[i], py[i]) & (i < nb ? kBlueOwn : kRedOwn)) != 0;
  bool bbl[NA], brl[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) bbl[i] = brl[i] = false;
  const int ub_base = perm_draws + 3 * p.n_red;
#pragma unroll
  for (int j = 0; j < NA; ++j) {
    if (j >= nb) continue;
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      if (i < nb || i >= A) continue;
      if (!p.mvn && (j != 0 || i != nb)) continue;
      const int k = j * p.n_red + (i - nb);  // pair index, row-major
      const float d2 = sq_dist(px[j], py[j], px[i], py[i]);
      const bool eligible = d2 <= p.battle_range2 && tm[j] == 0 && tm[i] == 0;
      const float p_blue =
          own[j] == own[i] ? 0.5f : (own[j] ? p.p_blue_own : p.p_blue_away);
      const bool blue_win = u[ub_base + k] < p_blue;
      const bool win = eligible && blue_win, lose = eligible && !blue_win;
      reward = __fadd_rn(reward, __fmul_rn(p.battle_reward, win ? 1.f : 0.f));
      reward = __fsub_rn(reward, __fmul_rn(p.battle_reward, lose ? 1.f : 0.f));
      tm[i] = max(tm[i], (int)win);
      if (p.mvn)
        tm[j] = max(tm[j], (int)lose);
      else
        ep_term |= lose;  // 1v1: blue losing ends the episode
      brl[i] |= win;
      bbl[j] |= lose;
    }
  }

  if (p.mvn) {
    bool all_blue_dead = true;
#pragma unroll
    for (int i = 0; i < NA; ++i)
      if (i < nb) all_blue_dead &= tm[i] == 1;
    ep_term |= all_blue_dead;
  } else if (p.obstacle_end) {
    // 1v1: standing on an obstacle cell costs and ends the episode.
    const bool on_obs = (cell(px[0], py[0]) & kObstacle) != 0;
    reward = __fsub_rn(reward, __fmul_rn(p.obstacle_penalty, on_obs ? 1.f : 0.f));
    ep_term |= on_obs;
  }
  reward = __fsub_rn(reward, p.step_penalty);

#pragma unroll
  for (int k = 0; k < NA; ++k)
    if (k < A) {
      pos_out[(size_t)b * 2 * A + 2 * k] = px[k];
      pos_out[(size_t)b * 2 * A + 2 * k + 1] = py[k];
      dirs_out[(size_t)b * A + k] = dr[k];
      term_out[(size_t)b * A + k] = tm[k];
      coll_out[(size_t)b * A + k] = cl[k];
      if (k < nb)
        bbl_out[(size_t)b * nb + k] = bbl[k];
      else
        brl_out[(size_t)b * p.n_red + (k - nb)] = brl[k];
    }
  reward_out[b] = reward;
  ep_term_out[b] = ep_term;
  rfc_out[b] = rfc;
  bfc_out[b] = bfc;
}

template <int NA>
cudaError_t launch(const void* const* in, void* const* out, const Params& p,
                   size_t smem, cudaStream_t stream) {
  const int blocks = (p.B + kThreads - 1) / kThreads;
  step_kernel<NA><<<blocks, kThreads, smem, stream>>>(
      (const int*)in[0], (const int*)in[1], (const int*)in[2], (const int*)in[3],
      (const int*)in[4], (const float*)in[5], (const int*)in[6], (const int*)in[7],
      (const int*)in[8], (const int*)in[9], (const float*)in[10], (int*)out[0],
      (int*)out[1], (int*)out[2], (int*)out[3], (float*)out[4], (int*)out[5],
      (int*)out[6], (int*)out[7], (int*)out[8], (int*)out[9], p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace ctf

// pos (B, 2A), dirs/term/coll (B, A), blue_acts (B, n_blue) int32; rnd
// (B, rnd_cols) float32; cells (4, s0 * s1), border (2, n_border), pool
// (2, n_pool) int32; kinds (n_red) int32 and p_opt (n_red) float32, each red
// agent's policy.  Outputs: pos, dirs, term, coll of the same shapes,
// reward (B, 1) float32, episode_term, rfc, bfc (B, 1), bbl (B, n_blue),
// brl (B, n_red) int32.  Launches on `stream` and returns the launch's
// cudaError_t.
extern "C" int ctf_step(const void* pos, const void* dirs, const void* term,
                        const void* coll, const void* blue_acts,
                        const void* rnd, const void* cells, const void* border,
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
  const void* in[] = {pos, dirs, term, coll, blue_acts, rnd, cells, border,
                      pool, kinds, p_opt};
  void* out[] = {pos_out, dirs_out, term_out, coll_out, reward, ep_term,
                 rfc, bfc, bbl, brl};
  const size_t smem = sizeof(int) * (2 * (size_t)n_border + 2 * (size_t)n_pool +
                                     2 * (size_t)n_red) +
                      (size_t)s0 * s1;
  auto run = A <= 2 ? launch<2> : (A <= 4 ? launch<4> : launch<8>);
  return (int)run(in, out, p, smem, (cudaStream_t)stream);
}
