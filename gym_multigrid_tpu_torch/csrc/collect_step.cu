// One Collect transition for a batch of envs, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel collect_step_slab of
// gym_multigrid_tpu/ops/pallas_collect.py (body _step_math).  Its plain
// PyTorch version is step_spec in gym_multigrid_tpu_torch/ops/collect_slab.py
// and the two agree bit for bit.
//
// What bounds it on this card: memory.  Each env reads its three (C,) int32
// planes and writes them back, 24 * C bytes (2.4 kB at C = 100), and does a
// few dozen integer operations per cell, far under the card's integer rate.
// The design reads and writes each plane once, coalesced, and keeps every
// intermediate in registers:
// - one warp per env, lane l owning cells l, l + 32, ... (collect_warp.cuh);
// - the cell a mover enters is read with one __shfl_sync from its lane;
// - the respawn pick is one __ballot_sync per 32-cell word plus __popc;
// - both agents' sub-steps run on the registers between the load and the
//   store, the second seeing the board the first one left.
// The TPU kernel's tril matmul, one-hot lane reductions and 128-lane
// shapes were workarounds for the TPU and are not carried over.

#include "collect_warp.cuh"

namespace collect {
namespace {

template <int NK>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
step_kernel(const int* __restrict__ go_in, const int* __restrict__ gc_in,
            const int* __restrict__ gs_in, const int* __restrict__ pos_in,
            const int* __restrict__ acts, const float* __restrict__ rnd,
            const unsigned char* __restrict__ rects,
            int* __restrict__ go_out, int* __restrict__ gc_out,
            int* __restrict__ gs_out, int* __restrict__ pos_out,
            int* __restrict__ picked_out, int B, int W, int H, int A,
            int respawn, int n_colors, int slot_base, int color0,
            int color1) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // the same for every lane of the warp
  const int C = W * H;
  const size_t row = (size_t)b * C;

  int go[NK], gc[NK], gs[NK];
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int c = k * 32 + lane;
    go[k] = c < C ? go_in[row + c] : kOffBoard;
    gc[k] = c < C ? gc_in[row + c] : 0;
    gs[k] = c < C ? gs_in[row + c] : 0;
  }

  const int* p = pos_in + (size_t)b * 2 * A;
  int x0 = p[0], y0 = p[1];
  int x1 = A == 2 ? p[2] : 0, y1 = A == 2 ? p[3] : 0;
  const int a0 = acts[(size_t)b * A], a1 = A == 2 ? acts[(size_t)b * A + 1] : 0;
  int picked0 = -1, picked1 = -1;
  const float* u = rnd + (size_t)b * 3;
  // Move order: a fair coin for two agents; agent 1 moves first when
  // u[0] < 0.5.
  const int first = (A == 2 && u[0] < 0.5f) ? 1 : 0;

  for (int s = 0; s < A; ++s) {
    const int i = s == 0 ? first : 1 - first;
    const int act = i ? a1 : a0;
    const int x = i ? x1 : x0, y = i ? y1 : y0;
    // North, east, south, west (COLLECT_ACTION_TO_VEC); other ids stay put.
    const int dx = (act == kEast) - (act == kWest);
    const int dy = (act == kSouth) - (act == kNorth);
    const int nx = min(max(x + dx, 0), W - 1), ny = min(max(y + dy, 0), H - 1);
    const int nidx = ny * W + nx, oidx = y * W + x;

    const int cell = warp_gather(go, nidx);
    const int ball_color = warp_gather(gc, nidx);
    const int ball_slot = warp_gather(gs, nidx);
    const bool is_ball = cell == kBall;
    const bool do_move = is_ball || cell == kEmpty;

    if (is_ball) {  // the same on every lane
      // Pickup: clear the ball cell.
#pragma unroll
      for (int k = 0; k < NK; ++k)
        if (k * 32 + lane == nidx) {
          go[k] = kEmpty;
          gc[k] = 0;
          gs[k] = 0;
        }
      if (respawn) {
        // Respawn before the mover enters: uniform over the empty cells of
        // the ball color's rect, the vacated ball cell included.
        const int bc = min(max(ball_color, 0), n_colors - 1);
        const unsigned char* rect = rects + (size_t)bc * C;
        bool m[NK];
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const int c = k * 32 + lane;
          m[k] = c < C && rect[c] && go[k] == kEmpty;
        }
        const unsigned hits = warp_pick(m, u[1 + s], lane);
#pragma unroll
        for (int k = 0; k < NK; ++k)
          if ((hits >> k) & 1u) {
            go[k] = kBall;
            gc[k] = ball_color;
            gs[k] = slot_base + ball_color;
          }
      }
    }

    if (do_move) {
      // The mover enters (overwriting a respawn on the vacated cell: the
      // reference's stomp) and leaves its old cell.
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        const int c = k * 32 + lane;
        if (c == nidx) {
          go[k] = kAgent;
          gc[k] = i ? color1 : color0;
          gs[k] = 0;
        }
        if (c == oidx) {
          go[k] = kEmpty;
          gc[k] = 0;
        }
      }
      if (i) {
        x1 = nx;
        y1 = ny;
      } else {
        x0 = nx;
        y0 = ny;
      }
    }
    const int got = is_ball ? ball_slot : -1;
    if (i) picked1 = got; else picked0 = got;
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
    picked_out[(size_t)b * A] = picked0;
    if (A == 2) {
      q[2] = x1;
      q[3] = y1;
      picked_out[(size_t)b * A + 1] = picked1;
    }
  }
}

template <int NK>
cudaError_t launch(const void* go, const void* gc, const void* gs,
                   const void* pos, const void* acts, const void* rnd,
                   const void* rects, void* go_out, void* gc_out,
                   void* gs_out, void* pos_out, void* picked_out, int B,
                   int W, int H, int A, int respawn, int n_colors,
                   int slot_base, int color0, int color1,
                   cudaStream_t stream) {
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  step_kernel<NK><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      (const int*)go, (const int*)gc, (const int*)gs, (const int*)pos,
      (const int*)acts, (const float*)rnd, (const unsigned char*)rects,
      (int*)go_out, (int*)gc_out, (int*)gs_out, (int*)pos_out,
      (int*)picked_out, B, W, H, A, respawn, n_colors, slot_base, color0,
      color1);
  return cudaGetLastError();
}

}  // namespace
}  // namespace collect

// Planes (B, C = W * H) int32, pos (B, 2A) int32, acts (B, A) int32, rnd
// (B, 3) float32, rects (n_colors, C) bool; outputs are separate buffers of
// the same shapes, picked (B, A) int32.  Launches on `stream` and returns
// the launch's cudaError_t.
extern "C" int collect_step(const void* go, const void* gc, const void* gs,
                            const void* pos, const void* acts,
                            const void* rnd, const void* rects, void* go_out,
                            void* gc_out, void* gs_out, void* pos_out,
                            void* picked_out, int B, int W, int H, int A,
                            int respawn, int n_colors, int slot_base,
                            int color0, int color1, void* stream) {
  using namespace collect;
  const int C = W * H;
  if (B < 1 || A < 1 || A > 2 || C < 1 || C > kMaxCells || n_colors < 1)
    return (int)cudaErrorInvalidValue;
  auto run = C <= 128 ? launch<4> : launch<8>;
  return (int)run(go, gc, gs, pos, acts, rnd, rects, go_out, gc_out, gs_out,
                  pos_out, picked_out, B, W, H, A, respawn, n_colors,
                  slot_base, color0, color1, (cudaStream_t)stream);
}
