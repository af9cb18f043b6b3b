// One Collect transition for a batch of envs, written by hand for Hopper
// (sm_90a): collect_step.
//
// It replaces the TPU kernel collect_step_slab of
// gym_multigrid_tpu/ops/pallas_collect.py (body _step_math).  Its plain
// PyTorch version is step_spec in gym_multigrid_tpu_torch/ops/collect_slab.py
// and the two agree bit for bit.  The K steps of the episode path are
// csrc/collect_steps.cu's collect_steps_philox.
//
// What bounds it on this card: memory.  Each env reads its three (C,) int32
// planes and writes them back, 24 * C bytes (2.4 kB at C = 100), and does a
// few dozen integer operations per cell, far under the card's integer rate.
// The design reads and writes each plane once, coalesced, and keeps every
// intermediate in registers:
// - one warp per env, lane l owning cells l, l + 32, ... (collect_warp.cuh);
// - the three planes packed into one register word per cell (see Packed
//   below), so a cell is read with one __shfl_sync from its lane and
//   written with one select;
// - the respawn pick is one __ballot_sync per 32-cell word plus __popc;
// - both agents' sub-steps run on the registers between the load and the
//   store, the second seeing the board the first one left.
// The TPU kernel's tril matmul, one-hot lane reductions and 128-lane
// shapes were workarounds for the TPU and are not carried over.
//
// Packed: a cell is obj | color << 8 | slot << 16, obj and color in
// 0..255 and slot a signed 16-bit value, which holds every cell an env
// makes (object ids 0..3, color ids, reward slots below n_balls + n_colors
// <= 256 + colors on this envelope); JAX's episode math packs the planes
// the same way (pack_planes, pallas_collect.py:630).

#include "collect_warp.cuh"

namespace collect {
namespace {

constexpr int kObjBits = 0xff;          // a packed cell's object byte
constexpr int kColorShift = 8, kSlotShift = 16;
constexpr int kSlotBits = ~0xffff;      // a packed cell's reward slot

__device__ __forceinline__ int pack(int obj, int color, int slot) {
  return obj | color << kColorShift | slot << kSlotShift;
}

// What a transition reads besides the board and the draws.
struct Board {
  const unsigned char* rects;  // (n_colors, C) respawn rect of each color
  int W, H, respawn, n_colors, slot_base, color0, color1;
};

// One Collect transition of the env whose packed board the warp holds in
// p, for A agents (1 or 2): they move in the fair-coin order, agent 1 first
// when u0 < 0.5; u1 and u2 are the first and second mover's respawn
// uniforms.  Updates p and the positions, and sets picked0/picked1 to the
// reward slot of the ball each agent picked up, or -1.  Every value but
// p's is alike in every lane.
template <int NK, int A>
__device__ __forceinline__ void transition(int (&p)[NK], const Board& bd, int lane, int a0,
                                           int a1, float u0, float u1, float u2, int& x0,
                                           int& y0, int& x1, int& y1, int& picked0,
                                           int& picked1) {
  const int W = bd.W, H = bd.H, C = W * H;
  const int first = (A == 2 && u0 < 0.5f) ? 1 : 0;
#pragma unroll
  for (int s = 0; s < A; ++s) {
    const int i = s == 0 ? first : 1 - first;
    const int act = i ? a1 : a0;
    const int x = i ? x1 : x0, y = i ? y1 : y0;
    // North, east, south, west (COLLECT_ACTION_TO_VEC); other ids stay put.
    const int dx = (act == kEast) - (act == kWest);
    const int dy = (act == kSouth) - (act == kNorth);
    const int nx = min(max(x + dx, 0), W - 1), ny = min(max(y + dy, 0), H - 1);
    const int nidx = ny * W + nx, oidx = y * W + x;

    const int cell = warp_gather(p, nidx);
    const int obj = cell & kObjBits;
    const int ball_color = (cell >> kColorShift) & kObjBits;
    const int ball_slot = cell >> kSlotShift;
    const bool is_ball = obj == kBall;
    const bool do_move = is_ball || obj == kEmpty;

    if (is_ball) {  // the same on every lane
      // Pickup: clear the ball cell.
#pragma unroll
      for (int k = 0; k < NK; ++k)
        if (k * 32 + lane == nidx) p[k] = pack(kEmpty, 0, 0);
      if (bd.respawn) {
        // Respawn before the mover enters: uniform over the empty cells of
        // the ball color's rect, the vacated ball cell included.
        const int bc = min(max(ball_color, 0), bd.n_colors - 1);
        const unsigned char* rect = bd.rects + (size_t)bc * C;
        bool m[NK];
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const int c = k * 32 + lane;
          m[k] = c < C && rect[c] && (p[k] & kObjBits) == kEmpty;
        }
        const unsigned hits = warp_pick(m, s == 0 ? u1 : u2, lane);
        const int ball = pack(kBall, ball_color, bd.slot_base + ball_color);
#pragma unroll
        for (int k = 0; k < NK; ++k)
          if ((hits >> k) & 1u) p[k] = ball;
      }
    }

    if (do_move) {
      // The mover enters (overwriting a respawn on the vacated cell: the
      // reference's stomp) and leaves its old cell, whose slot stays.
      const int agent = pack(kAgent, i ? bd.color1 : bd.color0, 0);
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        const int c = k * 32 + lane;
        if (c == nidx) p[k] = agent;
        if (c == oidx) p[k] &= kSlotBits;
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
}

// The env's three planes, packed into the warp's registers.
template <int NK>
__device__ __forceinline__ void load_board(int (&p)[NK], const int* go, const int* gc,
                                           const int* gs, size_t row, int C, int lane) {
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int c = k * 32 + lane;
    p[k] = c < C ? pack(go[row + c], gc[row + c], gs[row + c]) : kOffBoard;
  }
}

template <int NK>
__device__ __forceinline__ void store_board(const int (&p)[NK], int* go, int* gc, int* gs,
                                            size_t row, int C, int lane) {
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int c = k * 32 + lane;
    if (c < C) {
      go[row + c] = p[k] & kObjBits;
      gc[row + c] = (p[k] >> kColorShift) & kObjBits;
      gs[row + c] = p[k] >> kSlotShift;
    }
  }
}

template <int NK, int A>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
step_kernel(const int* __restrict__ go_in, const int* __restrict__ gc_in,
            const int* __restrict__ gs_in, const int* __restrict__ pos_in,
            const int* __restrict__ acts, const float* __restrict__ rnd,
            int* __restrict__ go_out, int* __restrict__ gc_out,
            int* __restrict__ gs_out, int* __restrict__ pos_out,
            int* __restrict__ picked_out, const Board bd, int B) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // the same for every lane of the warp
  const int C = bd.W * bd.H;
  const size_t row = (size_t)b * C;

  int p[NK];
  load_board<NK>(p, go_in, gc_in, gs_in, row, C, lane);
  const int* q = pos_in + (size_t)b * 2 * A;
  int x0 = q[0], y0 = q[1];
  int x1 = A == 2 ? q[2] : 0, y1 = A == 2 ? q[3] : 0;
  const int a0 = acts[(size_t)b * A], a1 = A == 2 ? acts[(size_t)b * A + 1] : 0;
  const float* u = rnd + (size_t)b * 3;
  int picked0 = -1, picked1 = -1;
  transition<NK, A>(p, bd, lane, a0, a1, u[0], u[1], u[2], x0, y0, x1, y1, picked0, picked1);

  store_board<NK>(p, go_out, gc_out, gs_out, row, C, lane);
  if (lane == 0) {
    int* o = pos_out + (size_t)b * 2 * A;
    o[0] = x0;
    o[1] = y0;
    picked_out[(size_t)b * A] = picked0;
    if (A == 2) {
      o[2] = x1;
      o[3] = y1;
      picked_out[(size_t)b * A + 1] = picked1;
    }
  }
}

int blocks_for(int B) { return (B + kWarpsPerBlock - 1) / kWarpsPerBlock; }

// The instance of a kernel template for a board of C cells and A agents.
template <typename Fn>
Fn pick(int C, int A, Fn nk4a1, Fn nk4a2, Fn nk8a1, Fn nk8a2) {
  return C <= 128 ? (A == 1 ? nk4a1 : nk4a2) : (A == 1 ? nk8a1 : nk8a2);
}

bool board_ok(int B, int W, int H, int A, int n_colors) {
  const int C = W * H;
  return B >= 1 && A >= 1 && A <= 2 && W >= 1 && H >= 1 && C <= kMaxCells && n_colors >= 1;
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
  if (!board_ok(B, W, H, A, n_colors)) return (int)cudaErrorInvalidValue;
  const Board bd{(const unsigned char*)rects, W, H, respawn, n_colors, slot_base, color0, color1};
  auto kernel = pick(W * H, A, step_kernel<4, 1>, step_kernel<4, 2>, step_kernel<8, 1>,
                     step_kernel<8, 2>);
  kernel<<<blocks_for(B), kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (const int*)go, (const int*)gc, (const int*)gs, (const int*)pos, (const int*)acts,
      (const float*)rnd, (int*)go_out, (int*)gc_out, (int*)gs_out, (int*)pos_out,
      (int*)picked_out, bd, B);
  return (int)cudaGetLastError();
}
