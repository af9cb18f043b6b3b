// K steps of the Collect episode path for a batch of envs, written by hand
// for Hopper (sm_90a): collect_steps_philox makes each step's draws from
// counters (csrc/philox.cuh), runs the step, adds each pickup's reward to a
// running sum and, at each episode's end, puts a fresh board in place, all
// in one launch on a packed board.
//
// It is the counterpart of the K-step Collect kernel that the JAX package
// pruned on the TPU (gym_multigrid_tpu/ops/pallas_collect.py,
// make_collect_episode_rollout's _one_episode_packed, :831: chunks of
// _collect_ms_math_packed, then _reset_math_packed at the lockstep
// truncation, on one packed plane).  Its plain PyTorch version is
// ms_philox_spec in gym_multigrid_tpu_torch/ops/collect_slab.py, which forms
// the same draws from ops/philox.py's counters and runs ms_spec (K
// step_spec steps, the rewards summed) and reset_spec; the two agree bit
// for bit.  It replaces the pre-drawn entry collect_steps, which read three
// int32 planes and 20 bytes of uniforms an env-step, ran one warp an env
// with every value but the board alike in all 32 lanes (about 150 issued
// instructions an env-step on that scalar chain), and left the reset and
// the draws to other launches.
//
// What bounds it on this card.  Per launch at C = 100, A = 2, K = 25 and
// B = 8192 the memory traffic is the packed board read and written once
// (6.6 MB) and the positions and running rewards (0.2 MB): about 2.1 us at
// 3.35 TB/s.  The operations are two Philox calls an env-step and a few
// dozen for the step and the fresh boards: about 46 M, 2.8 us at the
// card's int32 rate (chip_smoke.py's reckoning).  What sets its time is
// one env's chain of steps, which no batch size hides: on an H100 at
// 700 W a 25-step launch takes about 29 us at B = 8192 and about as long
// at B = 64 (scripts/torch_kernel_probe.py --only collect).  The design:
// - a block holds kEnvs envs, kLanes = 4 lanes each (1 and 8, built with
//   -DCOLLECT_STEPS_GROUP=1 or 8, took longer; scripts/torch_kernel_probe.py
//   --only collect times the three in turns); the lanes of an env run its
//   step chain together, each computing the same values, and share the
//   rest: lane g draws the steps k0 + g of each window of kLanes steps (the
//   next window's while this one runs) and hands them over by __shfl_sync,
//   fills a fresh board's cells g, g + kLanes, ... and draws its uniforms'
//   counters g, g + kLanes, ...;
// - the boards live in shared memory cell-major with the env as the fast
//   index (board[c * kEnvs + e]), so the 32 lanes of a warp, reading any
//   cells of their envs, fall in distinct banks (or share a word);
// - each env keeps its empty cells as NK bit words in registers (4 words
//   up to 128 cells, 8 up to 256), and the respawn rects, the reset's
//   ball rects and the wall as bit words in shared memory: a respawn or a
//   placement is NK popcounts of `rect & empty`, the rank min(floor(u *
//   count), count - 1) in float32 as the plain version forms it, and a
//   select of that set bit (prefix counts over the words, then a binary
//   search by popcounts inside the word), with no branch on the data;
// - the block's packed rows are contiguous in global memory: they are
//   copied by 4-byte cp.async (csrc/copy_async.cuh, all of a thread's in
//   flight at once) into a staging buffer (rows of C | 1 words, odd, so
//   that the transpose reads distinct banks), transposed into the board,
//   and written back through the same buffer, coalesced, at the end;
// - the truncation reset falls on the same step in every env (lockstep
//   episodes), so it branches for no env; its uniforms are drawn by the
//   env's lanes into the staging buffer, free during the steps;
// - a pickup adds its slot's reward to the agent's running sum with
//   __fadd_rn, in step order.  ms_spec adds +0.0 at every step without
//   one, which changes no sum (round-to-nearest never makes a sum -0).
// The info counters are not kept: the episode path discards them, as
// JAX's reset zeroes them.
// Packed cell: obj | color << 8 | slot << 16, as collect_step.cu packs it
// in registers; obj and color in 0..255 and slot a signed 16-bit value,
// which holds every cell an env makes (ops.collect_slab.pack_planes).

#include "collect_warp.cuh"
#include "copy_async.cuh"
#include "philox.cuh"

namespace collect {
namespace {

constexpr int kObjBits = 0xff;          // a packed cell's object byte
constexpr int kColorShift = 8, kSlotShift = 16;
constexpr int kSlotBits = ~0xffff;      // a packed cell's reward slot
constexpr int kEnvs = 64;               // envs a block (a power of two)
constexpr int kMaxSmem = 232448;        // dynamic shared memory a block can have
constexpr int kMaxDevices = 64;         // devices a process may launch on

#ifndef COLLECT_STEPS_GROUP
#define COLLECT_STEPS_GROUP 4
#endif
constexpr int kLanes = COLLECT_STEPS_GROUP;  // lanes an env
static_assert(kLanes == 1 || kLanes == 4 || kLanes == 8, "lanes an env: 1, 4 or 8");

// How the agents are placed (ops.collect_slab._AGENTS_*).
constexpr int kAgentsFixed = 0, kAgentsChoice = 1, kAgentsUniform = 2;

__device__ __forceinline__ int pack(int obj, int color, int slot) {
  return obj | color << kColorShift | slot << kSlotShift;
}

// Bit `cell - 32 k` of word k: 1 << (cell - 32 k) where that lies in 0..31,
// else 0.  PTX clamps a shift of 32 or more to 32, so this is one shift with
// no compare and no dynamic index into the register words.
__device__ __forceinline__ unsigned bit_in_word(int cell, int k) {
  unsigned v;
  asm("shl.b32 %0, %1, %2;" : "=r"(v) : "r"(1u), "r"(static_cast<unsigned>(cell - 32 * k)));
  return v;
}

template <int NK>
__device__ __forceinline__ void set_cell(unsigned (&w)[NK], int cell) {
#pragma unroll
  for (int k = 0; k < NK; ++k) w[k] |= bit_in_word(cell, k);
}

template <int NK>
__device__ __forceinline__ void clear_cell(unsigned (&w)[NK], int cell) {
#pragma unroll
  for (int k = 0; k < NK; ++k) w[k] &= ~bit_in_word(cell, k);
}

// Position of the r-th set bit (counting from 0) of w, 0 <= r < popc(w):
// a binary search by popcounts of the lower half.
__device__ __forceinline__ int select_bit(unsigned w, int r) {
  int pos = 0;
#pragma unroll
  for (int width = 16; width >= 1; width >>= 1) {
    const int lo = __popc(w & ((1u << width) - 1u));
    const bool up = r >= lo;
    r = up ? r - lo : r;
    w = up ? w >> width : w;
    pos = up ? pos + width : pos;
  }
  return pos;
}

// Uniform pick among the set cells of the words m: the r-th set cell in
// cell order, r = min(floor(u * count), count - 1) with the float32 product
// rounded and truncated as the plain version does (ops.sampling.
// masked_pick); -1 when none is set.
template <int NK>
__device__ __forceinline__ int pick(const unsigned (&m)[NK], float u) {
  int pre[NK + 1];  // set cells in the words before word k
  pre[0] = 0;
#pragma unroll
  for (int k = 0; k < NK; ++k) pre[k + 1] = pre[k] + __popc(m[k]);
  const int count = pre[NK];
  const int r = max(min(__float2int_rz(__fmul_rn(u, (float)count)), count - 1), 0);
  // The last word whose first set cell's rank is at most r holds it.
  unsigned w = m[0];
  int at = 0, rr = r;
#pragma unroll
  for (int k = 1; k < NK; ++k) {
    const bool later = r >= pre[k];
    w = later ? m[k] : w;
    at = later ? k * 32 : at;
    rr = later ? r - pre[k] : rr;
  }
  return count > 0 ? at + select_bit(w, rr) : -1;
}

// What a launch reads besides the envs' rows.
struct Params {
  const int* p_in;            // (B, C) packed boards
  const int* pos_in;          // (B, 2A)
  const float* ret_in;        // (B, A) running rewards
  const unsigned* rect_words; // (n_colors, nw) respawn rect of each ball color
  const unsigned* words;      // (n_balls + 1, nw) each placement's rect, then the wall
  const int* program;         // each placement's ball color, then the agents' (x, y)
  const float* slot_rewards;  // (n_slots,)
  int* p_out;
  int* pos_out;
  float* ret_out;
  int B, K, W, H, respawn, n_colors, slot_base, color0, color1, n_slots;
  int n_balls, balls_first, agent_mode, n_xy, max_steps, phase0;
  unsigned key0, key1, step0;
};

// A step's draws (ops.philox: COLLECT_ACTIONS and COLLECT_RND).
struct Draws {
  int a0, a1;
  float u0, u1, u2;
};

__device__ __forceinline__ Draws draw(unsigned b, unsigned s, const Params& q) {
  const philox::Words a = philox::philox(0u, b, s, philox::kCollectActions, q.key0, q.key1);
  const philox::Words u = philox::philox(0u, b, s, philox::kCollectRnd, q.key0, q.key1);
  return Draws{philox::collect_action(a.w[0]), philox::collect_action(a.w[1]),
               philox::uniform(u.w[0]), philox::uniform(u.w[1]), philox::uniform(u.w[2])};
}

// Step k0 + j's draws, from lane j of the env's kLanes lanes.
__device__ __forceinline__ Draws from_lane(const Draws& d, int j) {
  if (kLanes == 1) return d;
  return Draws{__shfl_sync(kFull, d.a0, j, kLanes), __shfl_sync(kFull, d.a1, j, kLanes),
               __shfl_sync(kFull, d.u0, j, kLanes), __shfl_sync(kFull, d.u1, j, kLanes),
               __shfl_sync(kFull, d.u2, j, kLanes)};
}

// Shared memory: the boards, the staging rows, then the tables.
struct Smem {
  int* board;        // [C][kEnvs]
  int* stage;        // [kEnvs][R]; a fresh board's uniforms [n_u][kEnvs] between
  unsigned* rects;   // [n_colors][NK]
  unsigned* balls;   // [n_balls + 1][NK]: each placement's rect, then the wall
  int* prog;         // [n_balls + 2 n_xy]
  float* rewards;    // [n_slots]
};

__host__ __device__ __forceinline__ int stage_stride(int C, int n_u) {
  return (C > n_u ? C : n_u) | 1;  // odd: the transpose reads distinct banks
}

__host__ __device__ __forceinline__ size_t smem_words(int NK, int C, const Params& q, int A) {
  return (size_t)C * kEnvs + (size_t)kEnvs * stage_stride(C, q.n_balls + A) +
         (size_t)q.n_colors * NK + (size_t)(q.n_balls + 1) * NK + q.n_balls + 2 * q.n_xy +
         q.n_slots;
}

// The fresh board of env e after global step s, as reset_spec places it:
// walls, then the balls and the agents in the plan's order, each ball at
// the min(floor(u n), n - 1)-th empty cell of its rect, the agents fixed,
// drawn from the pool or uniform over the empty cells.  Every lane of the
// env returns the same empty words and positions.
template <int NK, int A>
__device__ __forceinline__ void fresh_board(const Smem& sm, const Params& q, int C, int e, int g,
                                            unsigned b, unsigned s, unsigned (&empty)[NK],
                                            int (&x)[2], int (&y)[2]) {
  const int n_u = q.n_balls + A;
  float* u_s = reinterpret_cast<float*>(sm.stage);  // [n_u][kEnvs]
  for (int c = g; 4 * c < n_u; c += kLanes) {
    const philox::Words w = philox::philox((unsigned)c, b, s, philox::kCollectFresh, q.key0, q.key1);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * c + j < n_u) u_s[(4 * c + j) * kEnvs + e] = philox::uniform(w.w[j]);
  }
  const unsigned* wall = sm.balls + q.n_balls * NK;
  for (int c = g; c < C; c += kLanes)
    sm.board[c * kEnvs + e] = (wall[c >> 5] >> (c & 31)) & 1u ? pack(kWall, kWallColor, 0) : 0;
  if (kLanes > 1) __syncwarp();
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int left = C - k * 32;  // cells of the board in word k
    const unsigned on = left >= 32 ? ~0u : (left > 0 ? (1u << left) - 1u : 0u);
    empty[k] = ~wall[k] & on;
  }
  const int* coords = sm.prog + q.n_balls;
  for (int phase = 0; phase < 2; ++phase) {
    if ((phase == 0) == (q.balls_first != 0)) {
      const int base = q.balls_first ? 0 : A;
      for (int j = 0; j < q.n_balls; ++j) {
        unsigned m[NK];
#pragma unroll
        for (int k = 0; k < NK; ++k) m[k] = sm.balls[j * NK + k] & empty[k];
        const int cell = pick<NK>(m, u_s[(base + j) * kEnvs + e]);
        if (cell >= 0) {
          sm.board[cell * kEnvs + e] = pack(kBall, sm.prog[j], j);
          clear_cell(empty, cell);
        }
      }
    } else {
      const int base = q.balls_first ? q.n_balls : 0;
#pragma unroll
      for (int i = 0; i < A; ++i) {
        const float u = u_s[(base + i) * kEnvs + e];
        int cell;
        if (q.agent_mode == kAgentsFixed) {
          cell = coords[2 * i + 1] * q.W + coords[2 * i];
        } else if (q.agent_mode == kAgentsChoice) {
          const int j = min(__float2int_rz(__fmul_rn(u, (float)q.n_xy)), q.n_xy - 1);
          cell = coords[2 * j + 1] * q.W + coords[2 * j];
        } else {
          // No empty cell: cell 0, the plain version's sum over no hit.
          cell = max(pick<NK>(empty, u), 0);
        }
        // Agents overwrite whatever holds their cell.
        sm.board[cell * kEnvs + e] = pack(kAgent, i ? q.color1 : q.color0, 0);
        clear_cell(empty, cell);
        x[i] = cell % q.W;
        y[i] = cell / q.W;
      }
    }
  }
  // The uniforms' rows are read; the next reset or the write-back reuses them.
  if (kLanes > 1) __syncwarp();
}

template <int NK, int A>
__global__ void __launch_bounds__(kEnvs * kLanes)
steps_philox_kernel(const Params q) {
  extern __shared__ int smem[];
  const int C = q.W * q.H, n_u = q.n_balls + A, R = stage_stride(C, n_u);
  Smem sm;
  sm.board = smem;
  sm.stage = sm.board + C * kEnvs;
  sm.rects = reinterpret_cast<unsigned*>(sm.stage + kEnvs * R);
  sm.balls = sm.rects + q.n_colors * NK;
  sm.prog = reinterpret_cast<int*>(sm.balls + (q.n_balls + 1) * NK);
  sm.rewards = reinterpret_cast<float*>(sm.prog + q.n_balls + 2 * q.n_xy);

  constexpr int T = kEnvs * kLanes;
  const int tid = threadIdx.x, e = tid / kLanes, g = tid % kLanes;
  const int b0 = blockIdx.x * kEnvs, rows = min(kEnvs, q.B - b0);
  const unsigned b = (unsigned)(b0 + e);
  const bool live = e < rows;

  // The tables.
  const int nw = (C + 31) >> 5;  // words of a row on the host
  for (int i = tid; i < q.n_colors * NK; i += T) {
    const int row = i / NK, k = i - row * NK;
    sm.rects[i] = k < nw ? __ldg(q.rect_words + row * nw + k) : 0u;
  }
  for (int i = tid; i < (q.n_balls + 1) * NK; i += T) {
    const int row = i / NK, k = i - row * NK;
    sm.balls[i] = k < nw ? __ldg(q.words + row * nw + k) : 0u;
  }
  for (int i = tid; i < q.n_balls + 2 * q.n_xy; i += T) sm.prog[i] = __ldg(q.program + i);
  for (int i = tid; i < q.n_slots; i += T) sm.rewards[i] = __ldg(q.slot_rewards + i);

  // The block's rows, coalesced into the staging rows, then transposed into
  // the boards; rows past the batch are empty boards, stepped and dropped.
  // Asynchronous 4-byte copies, all of a thread's in flight at once.
  const float invC = 1.0f / (float)C;
  const int* src = q.p_in + (size_t)b0 * C;
  for (int i = tid; i < rows * C; i += T) {
    const int r = __float2int_rz(__fmul_rn((float)i + 0.5f, invC)), c = i - r * C;
    copy_async::copy4(sm.stage + r * R + c, src + i);
  }
  copy_async::commit();
  copy_async::wait<0>();
  __syncthreads();
  for (int i = tid; i < kEnvs * C; i += T) {
    const int r = i & (kEnvs - 1), c = i / kEnvs;
    sm.board[c * kEnvs + r] = r < rows ? sm.stage[r * R + c] : 0;
  }
  __syncthreads();

  // The env's empty cells: lane g reads bits g, g + kLanes, ... of each word,
  // then the env's lanes combine their words.
  unsigned empty[NK];
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    unsigned w = 0u;
#pragma unroll
    for (int j = 0; j < 32 / kLanes; ++j) {
      const int bit = g + kLanes * j, c = 32 * k + bit;
      const int cell = c < C ? sm.board[c * kEnvs + e] : kObjBits;
      w |= (unsigned)((cell & kObjBits) == kEmpty) << bit;
    }
    empty[k] = w;
  }
#pragma unroll
  for (int d = 1; d < kLanes; d <<= 1)
#pragma unroll
    for (int k = 0; k < NK; ++k) empty[k] |= __shfl_xor_sync(kFull, empty[k], d);

  int x[2] = {0, 0}, y[2] = {0, 0};
  float ret[2] = {0.f, 0.f};
  if (live) {
    const int* qp = q.pos_in + (size_t)b * 2 * A;
#pragma unroll
    for (int i = 0; i < A; ++i) {
      x[i] = qp[2 * i];
      y[i] = qp[2 * i + 1];
      ret[i] = q.ret_in[(size_t)b * A + i];
    }
  }

  const int W = q.W, H = q.H;
  int phase = q.phase0;  // the episode's step count before each step
  Draws cur = draw(b, q.step0 + (unsigned)g, q);
  for (int k0 = 0; k0 < q.K; k0 += kLanes) {
    // The next window's draws, off the chain.
    const Draws next = draw(b, q.step0 + (unsigned)(k0 + kLanes + g), q);
    const int n = min(kLanes, q.K - k0);
    for (int j = 0; j < n; ++j) {
      const Draws d = from_lane(cur, j);
      // Agent 1 moves first when u0 < 0.5 (two agents).
      const int first = (A == 2 && d.u0 < 0.5f) ? 1 : 0;
#pragma unroll
      for (int s = 0; s < A; ++s) {
        const int i = s == 0 ? first : 1 - first;
        const int act = i ? d.a1 : d.a0;
        const int xi = i ? x[1] : x[0], yi = i ? y[1] : y[0];
        // North, east, south, west (COLLECT_ACTION_TO_VEC).
        const int dx = (act == kEast) - (act == kWest);
        const int dy = (act == kSouth) - (act == kNorth);
        const int nx = min(max(xi + dx, 0), W - 1), ny = min(max(yi + dy, 0), H - 1);
        const int nidx = ny * W + nx, oidx = yi * W + xi;
        int* to = sm.board + nidx * kEnvs + e;
        const int cell = *to;
        // The env's lanes write what each of them read only once all have
        // read it (the same values, from every lane).
        if (kLanes > 1) __syncwarp();
        const int obj = cell & kObjBits;
        const int ball_color = (cell >> kColorShift) & kObjBits;
        const bool is_ball = obj == kBall, do_move = is_ball || obj == kEmpty;
        if (is_ball) {
          // Pickup: the ball cell empties, its slot's reward is summed.
          *to = pack(kEmpty, 0, 0);
          set_cell(empty, nidx);
          const int ps = min(max(cell >> kSlotShift, 0), q.n_slots - 1);
          if (i) ret[1] = __fadd_rn(ret[1], sm.rewards[ps]);
          else ret[0] = __fadd_rn(ret[0], sm.rewards[ps]);
          if (q.respawn) {
            // Respawn before the mover enters: uniform over the empty
            // cells of the ball color's rect, the vacated ball cell
            // included.
            const int bc = min(max(ball_color, 0), q.n_colors - 1);
            unsigned m[NK];
#pragma unroll
            for (int k = 0; k < NK; ++k) m[k] = sm.rects[bc * NK + k] & empty[k];
            const int at = pick<NK>(m, s == 0 ? d.u1 : d.u2);
            if (at >= 0) {
              sm.board[at * kEnvs + e] = pack(kBall, ball_color, q.slot_base + ball_color);
              clear_cell(empty, at);
            }
          }
        }
        if (do_move) {
          // The mover enters (over a respawn on the vacated ball cell: the
          // reference's stomp) and leaves its old cell, whose slot stays.
          *to = pack(kAgent, i ? q.color1 : q.color0, 0);
          clear_cell(empty, nidx);
          sm.board[oidx * kEnvs + e] &= kSlotBits;
          set_cell(empty, oidx);
          if (i) {
            x[1] = nx;
            y[1] = ny;
          } else {
            x[0] = nx;
            y[0] = ny;
          }
        }
        // ... and read the next cell once all have written (a cell may be
        // written twice in a sub-step: emptied, then entered).
        if (kLanes > 1) __syncwarp();
      }
      if (++phase == q.max_steps) {  // the same step in every env
        phase = 0;
        fresh_board<NK, A>(sm, q, C, e, g, b, q.step0 + (unsigned)(k0 + j), empty, x, y);
      }
    }
    cur = next;
  }

  if (live && g == 0) {
    int* qp = q.pos_out + (size_t)b * 2 * A;
#pragma unroll
    for (int i = 0; i < A; ++i) {
      qp[2 * i] = x[i];
      qp[2 * i + 1] = y[i];
      q.ret_out[(size_t)b * A + i] = ret[i];
    }
  }
  // The boards back through the staging rows, written coalesced.
  __syncthreads();
  for (int i = tid; i < kEnvs * C; i += T) {
    const int r = i & (kEnvs - 1), c = i / kEnvs;
    sm.stage[r * R + c] = sm.board[c * kEnvs + r];
  }
  __syncthreads();
  int* dst = q.p_out + (size_t)b0 * C;
  for (int i = tid; i < rows * C; i += T) {
    const int r = __float2int_rz(__fmul_rn((float)i + 0.5f, invC)), c = i - r * C;
    dst[i] = sm.stage[r * R + c];
  }
}

template <int NK, int A>
cudaError_t launch(const Params& q, cudaStream_t stream) {
  const size_t smem = sizeof(int) * smem_words(NK, q.W * q.H, q, A);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  // Per device, the dynamic shared memory this instance was allowed so far:
  // the attribute is set only when a launch needs more.
  static int allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && (size_t)allowed[dev] < smem) {
    err = cudaFuncSetAttribute(steps_philox_kernel<NK, A>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed[dev] = (int)smem;
  }
  const int blocks = (q.B + kEnvs - 1) / kEnvs;
  steps_philox_kernel<NK, A><<<blocks, kEnvs * kLanes, smem, stream>>>(q);
  return cudaGetLastError();
}

}  // namespace
}  // namespace collect

// K steps of the Collect episode path (ops.collect_slab.collect_philox_slab;
// plain version ms_philox_spec), the draws made from ops.philox's counters:
// key (key0, key1) and the global step step0 of the launch's first step,
// their 32-bit words passed as int.  p (B, W * H) int32 packed boards, pos
// (B, 2A) int32, ret (B, A) float32 running rewards; rect_words (n_colors *
// nw) and words ((n_balls + 1) * nw) int32 bit words (nw = ceil(W * H /
// 32)): the respawn rects, then each placement's rect and the wall
// (ResetArrays.words); program (n_balls + 2 n_xy) int32; slot_rewards
// (n_slots) float32.  phase0 is the episode's step count before the first
// step (step0 % max_steps on the host, from the unwrapped count); after a
// step that brings it to max_steps every env takes a fresh board.  Writes
// p_out, pos_out and ret_out, separate buffers of the same shapes.  Launches
// on `stream` and returns the launch's cudaError_t.
extern "C" int collect_steps_philox(const void* p, const void* pos, const void* ret,
                                    const void* rect_words, const void* words,
                                    const void* program, const void* slot_rewards, void* p_out,
                                    void* pos_out, void* ret_out, int B, int K, int W, int H,
                                    int A, int respawn, int n_colors, int slot_base, int color0,
                                    int color1, int n_slots, int n_balls, int balls_first,
                                    int agent_mode, int n_xy, int max_steps, int phase0,
                                    int key0, int key1, int step0, void* stream) {
  using namespace collect;
  const int C = W * H;
  if (B < 1 || K < 1 || A < 1 || A > 2 || W < 1 || H < 1 || C > kMaxCells || n_colors < 1 ||
      n_slots < 1 || n_balls < 0 || max_steps < 1 || phase0 < 0 || phase0 >= max_steps ||
      (agent_mode == kAgentsFixed && n_xy < A) || (agent_mode == kAgentsChoice && n_xy < 1))
    return (int)cudaErrorInvalidValue;
  const Params q{(const int*)p, (const int*)pos, (const float*)ret, (const unsigned*)rect_words,
                 (const unsigned*)words, (const int*)program, (const float*)slot_rewards,
                 (int*)p_out, (int*)pos_out, (float*)ret_out, B, K, W, H, respawn, n_colors,
                 slot_base, color0, color1, n_slots, n_balls, balls_first, agent_mode, n_xy,
                 max_steps, phase0, (unsigned)key0, (unsigned)key1, (unsigned)step0};
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (C <= 128)
    err = A == 1 ? launch<4, 1>(q, s) : launch<4, 2>(q, s);
  else
    err = A == 1 ? launch<8, 1>(q, s) : launch<8, 2>(q, s);
  return (int)err;
}
