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
// empty.  The design keeps the whole chain in registers and writes the
// board once:
// - one warp per env, lane l owning cells l, l + 32, ... (collect_warp.cuh);
// - each placement is one __ballot_sync per 32-cell word plus __popc
//   (no prefix-sum plane, no tril matmul);
// - the static wall row and ball rects are a few hundred bytes that stay in
//   L1 for the whole grid.
// With a `done` mask the rows that are not done return at once and write
// nothing, so the batch env's auto-reset costs one short launch per step
// and never asks the host whether a row finished.

#include "collect_warp.cuh"

namespace collect {
namespace {

// How the agents are placed (the plan's agent_fixed / agent_choice / neither).
constexpr int kAgentsFixed = 0, kAgentsChoice = 1, kAgentsUniform = 2;

template <int NK>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
reset_kernel(const float* __restrict__ rnd,
             const unsigned char* __restrict__ wall,
             const unsigned char* __restrict__ ball_rects,
             const int* __restrict__ program,
             const unsigned char* __restrict__ done, int* __restrict__ go_out,
             int* __restrict__ gc_out, int* __restrict__ gs_out,
             int* __restrict__ pos_out, int B, int W, int C, int n_balls,
             int A, int balls_first, int agent_mode, int n_xy, int color0,
             int color1) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // the same for every lane of the warp
  if (done != nullptr && !done[b]) return;  // this row keeps its state
  const size_t row = (size_t)b * C;
  const float* u = rnd + (size_t)b * (n_balls + A);
  const int* coords = program + n_balls;  // (x, y) pairs after the colors

  int go[NK], gc[NK], gs[NK];
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int c = k * 32 + lane;
    const bool w = c < C && wall[c];
    go[k] = c < C ? (w ? kWall : kEmpty) : kOffBoard;
    gc[k] = w ? kWallColor : 0;
    gs[k] = 0;
  }
  int x0 = 0, y0 = 0, x1 = 0, y1 = 0;

  // Balls then agents, or agents then balls (the rooms layout).
  for (int phase = 0; phase < 2; ++phase) {
    if ((phase == 0) == (balls_first != 0)) {
      const int base = balls_first ? 0 : A;
      for (int j = 0; j < n_balls; ++j) {
        const unsigned char* rect = ball_rects + (size_t)j * C;
        bool m[NK];
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const int c = k * 32 + lane;
          m[k] = c < C && rect[c] && go[k] == kEmpty;
        }
        const unsigned hits = warp_pick(m, u[base + j], lane);
        const int color = program[j];
#pragma unroll
        for (int k = 0; k < NK; ++k)
          if ((hits >> k) & 1u) {
            go[k] = kBall;
            gc[k] = color;
            gs[k] = j;
          }
      }
    } else {
      const int base = balls_first ? n_balls : 0;
      for (int i = 0; i < A; ++i) {
        int idx;
        if (agent_mode == kAgentsFixed) {
          idx = coords[2 * i + 1] * W + coords[2 * i];
        } else if (agent_mode == kAgentsChoice) {
          const int j = min(__float2int_rz(__fmul_rn(u[base + i], (float)n_xy)),
                            n_xy - 1);
          idx = j >= 0 ? coords[2 * j + 1] * W + coords[2 * j] : 0;
        } else {
          bool m[NK];
#pragma unroll
          for (int k = 0; k < NK; ++k) m[k] = go[k] == kEmpty;
          const unsigned hits = warp_pick(m, u[base + i], lane);
          idx = 0;  // no empty cell: the plain version's sum over no hit
#pragma unroll
          for (int k = 0; k < NK; ++k) {
            const unsigned word = __ballot_sync(kFull, (hits >> k) & 1u);
            if (word) idx = k * 32 + __ffs(word) - 1;
          }
        }
        // Agents overwrite whatever holds their cell.
#pragma unroll
        for (int k = 0; k < NK; ++k)
          if (k * 32 + lane == idx) {
            go[k] = kAgent;
            gc[k] = i ? color1 : color0;
            gs[k] = 0;
          }
        if (i) {
          x1 = idx % W;
          y1 = idx / W;
        } else {
          x0 = idx % W;
          y0 = idx / W;
        }
      }
    }
  }

#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int c = k * 32 + lane;
    if (c < C) {
      go_out[row + c] = go[k];
      gc_out[row + c] = gc[k];
      gs_out[row + c] = gs[k];
    }
  }
  if (lane == 0) {
    int* q = pos_out + (size_t)b * 2 * A;
    q[0] = x0;
    q[1] = y0;
    if (A == 2) {
      q[2] = x1;
      q[3] = y1;
    }
  }
}

template <int NK>
cudaError_t launch(const void* rnd, const void* wall, const void* ball_rects,
                   const void* program, const void* done, void* go, void* gc,
                   void* gs, void* pos, int B, int W, int C, int n_balls,
                   int A, int balls_first, int agent_mode, int n_xy,
                   int color0, int color1, cudaStream_t stream) {
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  reset_kernel<NK><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      (const float*)rnd, (const unsigned char*)wall,
      (const unsigned char*)ball_rects, (const int*)program,
      (const unsigned char*)done, (int*)go, (int*)gc, (int*)gs, (int*)pos, B,
      W, C, n_balls, A, balls_first, agent_mode, n_xy, color0, color1);
  return cudaGetLastError();
}

}  // namespace
}  // namespace collect

// rnd (B, n_balls + A) float32, wall (C,) bool, ball_rects (n_balls, C)
// bool, program (n_balls + 2 * n_xy,) int32 (each placement's ball color,
// then the agents' (x, y) coordinates), done (B,) bool or null.  Writes the
// planes (B, C) int32 and pos (B, 2A) int32 of every row, or of the rows
// where done is true.  Launches on `stream` and returns the launch's
// cudaError_t.
extern "C" int collect_reset(const void* rnd, const void* wall,
                             const void* ball_rects, const void* program,
                             const void* done, void* go, void* gc, void* gs,
                             void* pos, int B, int W, int C, int n_balls,
                             int A, int balls_first, int agent_mode, int n_xy,
                             int color0, int color1, void* stream) {
  using namespace collect;
  if (B < 1 || A < 1 || A > 2 || C < 1 || C > kMaxCells || n_balls < 0 ||
      (agent_mode == kAgentsFixed && n_xy < A) ||
      (agent_mode == kAgentsChoice && n_xy < 1))
    return (int)cudaErrorInvalidValue;
  auto run = C <= 128 ? launch<4> : launch<8>;
  return (int)run(rnd, wall, ball_rects, program, done, go, gc, gs, pos, B, W,
                  C, n_balls, A, balls_first, agent_mode, n_xy, color0,
                  color1, (cudaStream_t)stream);
}
