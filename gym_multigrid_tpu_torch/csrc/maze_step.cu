// One Maze transition for a batch of envs, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel maze_step_slab of gym_multigrid_tpu/ops/pallas_maze.py
// (body maze_step_math in gym_multigrid_tpu/envs/maze.py).  Its plain PyTorch
// version is step_spec in gym_multigrid_tpu_torch/ops/maze_slab.py and the two
// agree bit for bit.
//
// What bounds it on this card: launch latency.  An env is one agent: it
// reads 12 bytes (position, direction, action) and writes 20 (position,
// direction, reward, termination), 0.26 MB for a batch of 8192, which the
// card's memory moves in well under a microsecond.  The design:
// - one thread per env: the transition is a dozen dependent integer
//   operations and at most three table reads, too little to share;
// - blocks of 64 threads, so that B = 8192 spreads over 128 blocks and most
//   of the card's 132 SMs;
// - the (3, N) can-enter/flag/obstacle rows are read through the read-only
//   cache (__ldg), three reads at most per env from a table every env of
//   the batch shares, so the board has no size limit.  The TPU kernel's
//   one-hot lane reductions over the board were a TPU workaround and are
//   not carried over;
// - every float constant arrives as a float argument, rounded once on the
//   host from a double, and the reward is formed with __fmul_rn/__fsub_rn in
//   the plain version's order, so no multiply-add is contracted into an FMA.
// Bounds are checked in the natural axis order (row against S0, column
// against S1), unlike CtF's swapped bounds; cell lookups clip the position
// to the board first, as the plain version does.

#include <cuda_runtime.h>

namespace maze {
namespace {

constexpr int kThreads = 64;
constexpr int kNumActions = 5;
// Actions: stay, left, down, right, up (rows of CTF_ACTION_TO_VEC).
constexpr int kStay = 0, kLeft = 1, kDown = 2, kRight = 3, kUp = 4;
// Rows of the cells table (ops/maze_slab.py maze_static_inputs).
constexpr int kCanEnterRow = 0, kFlagRow = 1, kObstacleRow = 2;

struct Params {
  int B, s0, s1, obstacle_on;
  float flag_reward, obstacle_penalty, step_penalty;
};

// Row (pos[0]) and column (pos[1]) delta of each action.
__device__ __forceinline__ int d0_of(int a) {
  return a == kDown ? -1 : (a == kUp ? 1 : 0);
}
__device__ __forceinline__ int d1_of(int a) {
  return a == kLeft ? -1 : (a == kRight ? 1 : 0);
}
__device__ __forceinline__ int dir_of(int a) {
  // Render direction of each action: stay and left 3, down 2, right 1, up 0.
  return a == kDown ? 2 : (a == kRight ? 1 : (a == kUp ? 0 : 3));
}

__global__ void __launch_bounds__(kThreads)
step_kernel(const int* __restrict__ pos, const int* __restrict__ dirs,
            const int* __restrict__ acts, const int* __restrict__ cells,
            int* __restrict__ pos_out, int* __restrict__ dirs_out,
            float* __restrict__ reward_out, int* __restrict__ term_out,
            const Params p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  const int n_cells = p.s0 * p.s1;

  // Static flag of `row` at the position clipped to the board.
  auto cell = [&](int row, int c0, int c1) -> bool {
    const int q0 = min(max(c0, 0), p.s0 - 1), q1 = min(max(c1, 0), p.s1 - 1);
    return __ldg(cells + (size_t)row * n_cells + q0 * p.s1 + q1) > 0;
  };

  int p0 = pos[2 * (size_t)b], p1 = pos[2 * (size_t)b + 1], d = dirs[b];
  const int a = min(max(acts[b], 0), kNumActions - 1);
  const int n0 = p0 + d0_of(a), n1 = p1 + d1_of(a);
  const bool inb = n0 >= 0 && n1 >= 0 && n0 < p.s0 && n1 < p.s1;
  // Stay never moves; a blocked move keeps position and direction.
  if (inb && cell(kCanEnterRow, n0, n1) && a != kStay) {
    p0 = n0;
    p1 = n1;
    d = dir_of(a);
  }

  const bool on_flag = cell(kFlagRow, p0, p1);
  float reward = __fmul_rn(p.flag_reward, on_flag ? 1.f : 0.f);
  bool term = on_flag;
  if (p.obstacle_on) {
    const bool on_obs = cell(kObstacleRow, p0, p1);
    reward = __fsub_rn(reward, __fmul_rn(p.obstacle_penalty, on_obs ? 1.f : 0.f));
    term |= on_obs;
  }
  reward = __fsub_rn(reward, p.step_penalty);

  pos_out[2 * (size_t)b] = p0;
  pos_out[2 * (size_t)b + 1] = p1;
  dirs_out[b] = d;
  reward_out[b] = reward;
  term_out[b] = term;
}

}  // namespace
}  // namespace maze

// pos (B, 2), dirs (B, 1), acts (B, 1) int32; cells (3, s0 * s1) int32
// (can_enter, flag, obstacle).  Outputs: pos (B, 2), dirs (B, 1) int32,
// reward (B, 1) float32, term (B, 1) int32.  obstacle_on: the obstacle
// penalty is not 0.  Launches on `stream` and returns the launch's
// cudaError_t.
extern "C" int maze_step(const void* pos, const void* dirs, const void* acts,
                         const void* cells, void* pos_out, void* dirs_out,
                         void* reward, void* term, int B, int s0, int s1,
                         int obstacle_on, float flag_reward,
                         float obstacle_penalty, float step_penalty,
                         void* stream) {
  using namespace maze;
  if (B < 1 || s0 < 1 || s1 < 1) return (int)cudaErrorInvalidValue;
  const Params p{B, s0, s1, obstacle_on, flag_reward, obstacle_penalty,
                 step_penalty};
  const int blocks = (B + kThreads - 1) / kThreads;
  step_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)pos, (const int*)dirs, (const int*)acts, (const int*)cells,
      (int*)pos_out, (int*)dirs_out, (float*)reward, (int*)term, p);
  return (int)cudaGetLastError();
}
