// Whole-board Collect reset for a batch of envs, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel collect_reset_slab of
// gym_multigrid_tpu/ops/pallas_collect.py (body _reset_math).  Its plain
// PyTorch version is reset_spec in
// gym_multigrid_tpu_torch/ops/collect_slab.py and the two agree bit for
// bit.
//
// What bounds it on this card: memory in principle, the chain of placements
// in practice.  An env's reset writes its three (C,) int32 planes once
// (12 * C bytes) and reads one uniform per placement, but its placements
// run one after another, each a pick among the cells the earlier ones left
// empty: at B = 8192 every SM holds about 62 envs, so the time is one
// env's chain plus the SM's share of the writes.  The design keeps the
// chain short and everything else off it:
// - one thread per env runs the chain on bit words: its empty cells as NK
//   32-bit words in registers, each ball rect as NK words in shared memory
//   (built on the host, ResetArrays.words), so a placement is the counts
//   of NK words, the rank r = min(floor(u * count), count - 1) in float32
//   as the plain version forms it, the word holding it by prefix counts,
//   and the bit inside it by byte counts and a 256-entry table of the set
//   bits of every byte; no ballot, no shuffle, and no branch, which would
//   diverge across the warp's envs;
// - the next placement's words and counts are formed against the empty
//   cells while the current pick runs and then corrected for the one cell
//   it took, so only the pick itself is on the chain;
// - nothing the chain reads comes from global memory: the words, the
//   program and each env's uniforms are staged into shared memory first.
//   Each chain thread loads its own env's uniforms, since remapping the
//   block's contiguous run to rows cost an integer division a uniform;
// - each placement lands in a board of packed cells (object | color << 4 |
//   slot << 8) in shared memory, one row per env, set to walls and empty
//   cells first; then the planes are written from it, coalesced, each cell
//   once.  A block has 8 warps for 64 envs: all of them stage, fill and
//   write, and two of them run the chains.
// With a `done` mask a block with no row done returns after one byte per
// env, and rows that are not done write nothing, so the batch env's
// auto-reset costs one short launch per step and never asks the host
// whether a row finished.

#include "collect_warp.cuh"

namespace collect {
namespace {

// How the agents are placed (the plan's agent_fixed / agent_choice / neither).
constexpr int kAgentsFixed = 0, kAgentsChoice = 1, kAgentsUniform = 2;
// Envs of a block, one chain thread each: 128 blocks cover B = 8192 on the
// card's 132 SMs.  The block's 8 warps stage, fill and write together.
constexpr int kEnvs = 64;
constexpr int kResetThreads = 256;
constexpr int kResetWarps = kResetThreads / 32;
constexpr int kEnvsPerWarp = kEnvs / kResetWarps;
// Uniforms a chain thread has in flight in one staging round.
constexpr int kStageLoads = 32;

__device__ __forceinline__ int pack(int obj, int color, int slot) {
  return obj | (color << 4) | (slot << 8);
}

// Entry v of the byte table: the positions of the set bits of v, in order,
// 4 bits each.
__device__ __forceinline__ unsigned byte_positions(unsigned v) {
  unsigned e = 0;
  int n = 0;
#pragma unroll
  for (int bit = 0; bit < 8; ++bit)
    if ((v >> bit) & 1u) {
      e |= (unsigned)bit << (4 * n);
      ++n;
    }
  return e;
}

// Position of the r-th set bit (counting from 0) of w, for 0 <= r <
// popc(w): the byte by prefix counts, the bit by the byte table.
__device__ __forceinline__ int select_bit(unsigned w, int r, const unsigned* byte_table) {
  const int c0 = __popc(w & 0xffu), c1 = __popc(w & 0xffffu), c2 = __popc(w & 0xffffffu);
  const int byte = (r >= c0) + (r >= c1) + (r >= c2);
  const int before = r >= c2 ? c2 : (r >= c1 ? c1 : (r >= c0 ? c0 : 0));
  const unsigned v = (w >> (8 * byte)) & 0xffu;
  return 8 * byte + (int)((byte_table[v] >> (4 * (r - before))) & 7u);
}

// Uniform pick among the set cells of the words m, whose counts are c: the
// r-th set cell in cell order, r = min(floor(u * count), count - 1) with the
// float32 product rounded and truncated as the plain version does; -1 when
// none is set.
template <int NK>
__device__ __forceinline__ int pick(const unsigned (&m)[NK], const int (&c)[NK], float u,
                                    const unsigned* byte_table) {
  int pre[NK + 1];  // set cells in the words before word k
  pre[0] = 0;
#pragma unroll
  for (int k = 0; k < NK; ++k) pre[k + 1] = pre[k] + c[k];
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
  const int cell = at + select_bit(w, rr, byte_table);
  return count > 0 ? cell : -1;
}

// Bit `cell - 32 * k` of word k: 1 << (cell - 32 k) where that lies in
// 0..31, else 0 (cell negative: none).  PTX clamps a shift of 32 or more
// to 32, so this is one shift with no compare: written as a compare and
// select, the compiler indexed the register words by it, with a branch a
// word that diverged across the warp.
__device__ __forceinline__ unsigned bit_in_word(int cell, int k) {
  unsigned v;
  asm("shl.b32 %0, %1, %2;" : "=r"(v) : "r"(1u), "r"(static_cast<unsigned>(cell - 32 * k)));
  return v;
}

// Clears `cell` (none when it is negative) in the words w.
template <int NK>
__device__ __forceinline__ void take(unsigned (&w)[NK], int cell) {
#pragma unroll
  for (int k = 0; k < NK; ++k) w[k] &= ~bit_in_word(cell, k);
}

#ifdef COLLECT_RESET_STAMPS
// Per-phase clock64() sums over blocks, for timing the phases on the card
// (built only with -DCOLLECT_RESET_STAMPS): staging, board fill, chain,
// writing the planes, and the number of blocks.
__device__ unsigned long long g_stamps[5];
#define STAMP(i)                                                       \
  do {                                                                 \
    __syncthreads();                                                   \
    const long long now = clock64();                                   \
    if (threadIdx.x == 0) atomicAdd(&g_stamps[i], (unsigned long long)(now - t_prev)); \
    t_prev = now;                                                      \
  } while (0)
#else
#define STAMP(i) \
  do {           \
  } while (0)
#endif

template <int NK>
__global__ void __launch_bounds__(kResetThreads)
reset_kernel(const float* __restrict__ rnd, const unsigned* __restrict__ words,
             const int* __restrict__ program,
             const unsigned char* __restrict__ done, int* __restrict__ go_out,
             int* __restrict__ gc_out, int* __restrict__ gs_out,
             int* __restrict__ pos_out, int B, int W, int C, int n_balls,
             int A, int balls_first, int agent_mode, int n_xy, int color0,
             int color1) {
  extern __shared__ unsigned smem[];
  const int n_words = (n_balls + 1) * NK;  // each rect's words, then the wall's
  const int n_prog = n_balls + 2 * n_xy;
  const int n_u = n_balls + A;
  const int u_stride = n_u | 1;  // odd: a warp's rows fall in distinct banks
  const int stride = (C + 1) | 1;  // odd, with a scratch slot at C
  unsigned* s_words = smem;
  const unsigned* s_wall = s_words + n_balls * NK;
  unsigned* s_bytes = s_words + n_words;  // the byte table, 256 entries
  int* s_mine = reinterpret_cast<int*>(s_bytes + 256);
  int* s_prog = s_mine + kEnvs;
  float* s_u = reinterpret_cast<float*>(s_prog + n_prog);
  int* s_board = reinterpret_cast<int*>(s_u + kEnvs * u_stride);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * kEnvs, b = b0 + tid;  // b: the chain thread's env
  const bool mine = tid < kEnvs && b < B && (done == nullptr || done[b]);
  if (!__syncthreads_or(mine)) return;  // no row of this block to reset
#ifdef COLLECT_RESET_STAMPS
  long long t_prev = clock64();
#endif

  // Staging: every load of a round before its stores.
  const int nw = (C + 31) >> 5;  // words a row has on the host
  unsigned wall[NK];             // the wall's words, for the fill
#pragma unroll
  for (int k = 0; k < NK; ++k) wall[k] = k < nw ? __ldg(words + n_balls * nw + k) : 0u;
  for (int i = tid; i < n_words; i += kResetThreads) {
    const int row = i / NK, k = i - row * NK;
    s_words[i] = k < nw ? __ldg(words + row * nw + k) : 0u;
  }
  for (int i = tid; i < n_prog; i += kResetThreads) s_prog[i] = __ldg(program + i);
  const float* u_row = rnd + (size_t)b * n_u;  // this chain thread's uniforms
  for (int j0 = 0; j0 < n_u; j0 += kStageLoads) {
    float v[kStageLoads];
#pragma unroll
    for (int r = 0; r < kStageLoads; ++r) v[r] = mine && j0 + r < n_u ? __ldg(u_row + j0 + r) : 0.f;
#pragma unroll
    for (int r = 0; r < kStageLoads; ++r)
      if (mine && j0 + r < n_u) s_u[tid * u_stride + j0 + r] = v[r];
  }
  s_bytes[tid] = byte_positions(tid);
  if (tid < kEnvs) s_mine[tid] = mine;
  STAMP(0);

  // The board's rows: walls and empty cells.  Warp w fills (and later
  // writes out) envs w * kEnvsPerWarp and on.
  int fill[NK];
#pragma unroll
  for (int k = 0; k < NK; ++k)
    fill[k] = (wall[k] >> lane) & 1u ? pack(kWall, kWallColor, 0) : pack(kEmpty, 0, 0);
#pragma unroll
  for (int i = 0; i < kEnvsPerWarp; ++i) {
    int* row_s = s_board + (warp * kEnvsPerWarp + i) * stride;
#pragma unroll
    for (int k = 0; k < NK; ++k)
      if (k * 32 + lane < C) row_s[k * 32 + lane] = fill[k];
  }
  __syncthreads();
  STAMP(1);

  // The chains: one thread per env, on shared memory and registers only.
  if (mine) {
    int* board = s_board + tid * stride;
    const float* u_env = s_u + tid * u_stride;  // read in placement order
    unsigned empty[NK];
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const int left = C - k * 32;  // cells of the board in word k
      const unsigned on = left >= 32 ? ~0u : (left > 0 ? (1u << left) - 1u : 0u);
      empty[k] = ~s_wall[k] & on;
    }
    const int* coords = s_prog + n_balls;  // (x, y) pairs after the colors
    int x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    for (int phase = 0; phase < 2; ++phase) {
      if ((phase == 0) == (balls_first != 0)) {
        const float* u = u_env + (balls_first ? 0 : A);
        unsigned m[NK];  // this placement's rect against the empty cells
        int c[NK];
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          m[k] = s_words[k] & empty[k];
          c[k] = __popc(m[k]);
        }
        for (int j = 0; j < n_balls; ++j) {
          // The next rect (row n_balls: the wall's, unused) against the
          // cells empty now, off the chain.
          unsigned mn[NK];
          int cn[NK];
#pragma unroll
          for (int k = 0; k < NK; ++k) {
            mn[k] = s_words[(j + 1) * NK + k] & empty[k];
            cn[k] = __popc(mn[k]);
          }
          const int cell = pick<NK>(m, c, u[j], s_bytes);
          // An empty rect places nothing: its write goes to the row's
          // scratch slot C.
          board[cell >= 0 ? cell : C] = pack(kBall, s_prog[j], j);
          // The cell leaves the empty cells and the next rect's.
#pragma unroll
          for (int k = 0; k < NK; ++k) {
            const unsigned bit = bit_in_word(cell, k);
            empty[k] &= ~bit;
            c[k] = cn[k] - ((mn[k] & bit) != 0u);
            m[k] = mn[k] & ~bit;
          }
        }
      } else {
        const float* u = u_env + (balls_first ? n_balls : 0);
        for (int i = 0; i < A; ++i) {
          int cell;
          if (agent_mode == kAgentsFixed) {
            cell = coords[2 * i + 1] * W + coords[2 * i];
          } else if (agent_mode == kAgentsChoice) {
            const int j = min(__float2int_rz(__fmul_rn(u[i], (float)n_xy)), n_xy - 1);
            cell = j >= 0 ? coords[2 * j + 1] * W + coords[2 * j] : 0;
          } else {
            int c[NK];
#pragma unroll
            for (int k = 0; k < NK; ++k) c[k] = __popc(empty[k]);
            // No empty cell: cell 0, the plain version's sum over no hit.
            cell = max(pick<NK>(empty, c, u[i], s_bytes), 0);
          }
          // Agents overwrite whatever holds their cell.
          take(empty, cell);
          board[cell] = pack(kAgent, i ? color1 : color0, 0);
          if (i) {
            x1 = cell % W;
            y1 = cell / W;
          } else {
            x0 = cell % W;
            y0 = cell / W;
          }
        }
      }
    }
    int* q = pos_out + (size_t)b * 2 * A;
    q[0] = x0;
    q[1] = y0;
    if (A == 2) {
      q[2] = x1;
      q[3] = y1;
    }
  }
  __syncthreads();
  STAMP(2);

  // The planes, each cell written once, coalesced: warp w writes the rows
  // it filled.
#pragma unroll
  for (int i = 0; i < kEnvsPerWarp; ++i) {
    const int e = warp * kEnvsPerWarp + i;
    const bool write = s_mine[e] != 0;
    const int* row_s = s_board + e * stride;
    const size_t row = (size_t)(b0 + e) * C;
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const int c = k * 32 + lane;
      if (write && c < C) {
        const int v = row_s[c];
        go_out[row + c] = v & 15;
        gc_out[row + c] = (v >> 4) & 15;
        gs_out[row + c] = v >> 8;
      }
    }
  }
  STAMP(3);
#ifdef COLLECT_RESET_STAMPS
  if (threadIdx.x == 0) atomicAdd(&g_stamps[4], 1ull);
#endif
}

// Dynamic shared memory of a block: the words, the program, the uniforms
// and the board.
size_t smem_bytes(int NK, int C, int n_balls, int A, int n_xy) {
  return sizeof(int) * ((size_t)(n_balls + 1) * NK + 256 + kEnvs + n_balls + 2 * n_xy +
                        (size_t)kEnvs * ((n_balls + A) | 1) + (size_t)kEnvs * ((C + 1) | 1));
}

template <int NK>
cudaError_t launch(const void* rnd, const void* words, const void* program,
                   const void* done, void* go, void* gc, void* gs, void* pos,
                   int B, int W, int C, int n_balls, int A, int balls_first,
                   int agent_mode, int n_xy, int color0, int color1,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(NK, C, n_balls, A, n_xy);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        reset_kernel<NK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (B + kEnvs - 1) / kEnvs;
  reset_kernel<NK><<<blocks, kResetThreads, smem, stream>>>(
      (const float*)rnd, (const unsigned*)words, (const int*)program,
      (const unsigned char*)done, (int*)go, (int*)gc, (int*)gs, (int*)pos, B,
      W, C, n_balls, A, balls_first, agent_mode, n_xy, color0, color1);
  return cudaGetLastError();
}

}  // namespace
}  // namespace collect

// rnd (B, n_balls + A) float32; words ((n_balls + 1) * ceil(C / 32),)
// int32: each ball rect's cells as bit words (bit c % 32 of word c / 32),
// then the wall's; program (n_balls + 2 * n_xy,) int32 (each placement's
// ball color, then the agents' (x, y) coordinates); done (B,) bool or null.
// Writes the planes (B, C) int32 and pos (B, 2A) int32 of every row, or of
// the rows where done is true.  Launches on `stream` and returns the
// launch's cudaError_t.
extern "C" int collect_reset(const void* rnd, const void* words,
                             const void* program, const void* done, void* go,
                             void* gc, void* gs, void* pos, int B, int W,
                             int C, int n_balls, int A, int balls_first,
                             int agent_mode, int n_xy, int color0, int color1,
                             void* stream) {
  using namespace collect;
  if (B < 1 || A < 1 || A > 2 || C < 1 || C > kMaxCells || n_balls < 0 ||
      (agent_mode == kAgentsFixed && n_xy < A) ||
      (agent_mode == kAgentsChoice && n_xy < 1))
    return (int)cudaErrorInvalidValue;
  auto run = C <= 128 ? launch<4> : launch<8>;
  return (int)run(rnd, words, program, done, go, gc, gs, pos, B, W, C,
                  n_balls, A, balls_first, agent_mode, n_xy, color0, color1,
                  (cudaStream_t)stream);
}

#ifdef COLLECT_RESET_STAMPS
// Copies the five g_stamps sums to `out` (host memory) and sets them to 0.
extern "C" int collect_reset_stamps(void* out) {
  using namespace collect;
  cudaError_t err = cudaMemcpyFromSymbol(out, g_stamps, sizeof(g_stamps));
  if (err == cudaSuccess) {
    const unsigned long long zero[5] = {0, 0, 0, 0, 0};
    err = cudaMemcpyToSymbol(g_stamps, zero, sizeof(zero));
  }
  return (int)err;
}
#endif
