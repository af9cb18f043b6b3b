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
//
// The second entry, maze_steps, runs K transitions with the per-env
// auto-reset and the return accounting in one launch: the episode math
// _maze_ms_math of gym_multigrid_tpu/ops/pallas_maze.py, whose plain
// PyTorch version is ms_spec in ops/maze_slab.py.  It pays the launch once
// per K transitions.  What bounds it then is the chain of K dependent steps
// of each env, against a byte bound of 8 bytes a transition (its action and
// spawn uniform) plus the state.  The design shortens the chain:
// - the step is tabulated on the host by the plain version (ms_table in
//   ops/maze_slab.py): for every (cell, action) the cell the move ends on,
//   the direction after it, the termination and the reward, so a move is
//   one shared-memory read and the kernel repeats no float arithmetic of
//   the step;
// - each block copies that table into shared memory once, 16 bytes a load,
//   all of a thread's loads issued before its stores;
// - one thread per env keeps its state in registers across the K steps,
//   the position as cell * 5 (the table's row), and writes (row, col) once;
// - actions and uniforms reach shared memory in tiles of kTile steps by
//   cp.async, each thread copying its own column, the next tile in flight
//   while this one runs, waited for as a copy group apart from the
//   chain's reads (a ring of global loads held in registers took about a
//   global round trip a step instead: twice the time at K = 100);
// - the spawn cell is looked up every step, off the chain (a read the
//   compiler may not sink under the step's `done`, which would put a second
//   shared-memory round trip on the chain), and selected where the episode
//   ended; the sums are formed with __fadd_rn in
//   _maze_ms_math's order (a zero added where no episode ended), so none is
//   contracted or reordered.

#include <cuda_runtime.h>

#include "copy_async.cuh"

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

// Steps of one tile of actions and uniforms in shared memory.
constexpr int kTile = 32;
// Table entries a thread copies in one round: kCopyVecs int4 loads.
constexpr int kCopyVecs = 4;
// The direction field of a table entry that leaves the direction as it was.
constexpr int kKeepDir = 4;
constexpr int kSpawnDir = 3;

constexpr int kTileBytes = 2 * kTile * kThreads * 8;

struct MsParams {
  int B, K, s1, n_moves, n_bg, max_steps, n_table;
};

// A shared-memory read issued where it stands: the compiler may neither
// move it under a later predicate nor drop it.  The spawn read uses it, so
// that it overlaps the move's read instead of following the step's `done`.
__device__ __forceinline__ int load_shared_now(const int* p) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];\n"
               : "=r"(v)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
}

// This thread's actions and uniforms of steps [k0, k0 + kTile) into its own
// column of one tile buffer: the thread reads only what it copied.
__device__ __forceinline__ void fetch_tile(int* s_a, float* s_u, const int* acts,
                                           const float* rnd, int k0, int K,
                                           int B, int b) {
  const int n = min(kTile, K - k0);
  for (int j = 0; j < n; ++j) {
    const size_t at = (size_t)(k0 + j) * B + b;
    copy_async::copy4(s_a + j * kThreads + threadIdx.x, acts + at);
    copy_async::copy4(s_u + j * kThreads + threadIdx.x, rnd + at);
  }
  copy_async::commit();
}

__global__ void __launch_bounds__(kThreads)
steps_kernel(const int* __restrict__ pos, const int* __restrict__ dirs,
             const int* __restrict__ sc_in, const float* __restrict__ run_in,
             const int* __restrict__ acts, const float* __restrict__ rnd,
             const int4* __restrict__ table, int* __restrict__ pos_out,
             int* __restrict__ dirs_out, int* __restrict__ sc_out,
             float* __restrict__ run_out, float* __restrict__ rew_out,
             float* __restrict__ ep_out, int* __restrict__ eps_out,
             const MsParams p) {
  // Two tile buffers of actions and uniforms, then the table.
  __shared__ int s_acts[2][kTile * kThreads];
  __shared__ float s_rnd[2][kTile * kThreads];
  extern __shared__ int4 smem4[];
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = b < p.B;
  const int K = p.K;

  // The first tile starts on its way before the table copy.
  if (live) fetch_tile(s_acts[0], s_rnd[0], acts, rnd, 0, K, p.B, b);
  int base = 0, d = 0, sc = 0;
  float run = 0.f;
  if (live) {
    // Clipped so that a position off the board cannot read outside the
    // table; positions on the board (every reset and step leaves them so)
    // are unchanged by it.
    const int cell = pos[2 * (size_t)b] * p.s1 + pos[2 * (size_t)b + 1];
    base = min(max(cell, 0), p.n_moves / kNumActions - 1) * kNumActions;
    d = dirs[b];
    sc = sc_in[b];
    run = run_in[b];
  }

  // The table, into shared memory: every load of a round before its stores.
  const int n_vec = p.n_table / 4;
  for (int v0 = 0; v0 < n_vec; v0 += kCopyVecs * kThreads) {
    int4 v[kCopyVecs];
#pragma unroll
    for (int r = 0; r < kCopyVecs; ++r) {
      const int i = v0 + r * kThreads + threadIdx.x;
      if (i < n_vec) v[r] = __ldg(table + i);
    }
#pragma unroll
    for (int r = 0; r < kCopyVecs; ++r) {
      const int i = v0 + r * kThreads + threadIdx.x;
      if (i < n_vec) smem4[i] = v[r];
    }
  }
  __syncthreads();
  if (!live) return;
  const int* moves = reinterpret_cast<const int*>(smem4);
  const float* reward_of = reinterpret_cast<const float*>(moves + p.n_moves);
  const int* spawns = moves + 2 * p.n_moves;
  const float n_bg_f = (float)p.n_bg;

  float rew_sum = 0.f, ep_sum = 0.f;
  int eps = 0;
  for (int k0 = 0, t = 0; k0 < K; k0 += kTile, t ^= 1) {
    // The next tile goes out before this one is waited for.
    if (k0 + kTile < K) {
      fetch_tile(s_acts[t ^ 1], s_rnd[t ^ 1], acts, rnd, k0 + kTile, K, p.B, b);
      copy_async::wait<1>();
    } else {
      copy_async::wait<0>();
    }
    const int* ta = s_acts[t] + threadIdx.x;
    const float* tu = s_rnd[t] + threadIdx.x;
    const int n = min(kTile, K - k0);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const int a = min(max(ta[j * kThreads], 0), kNumActions - 1);
      const float u = tu[j * kThreads];
      // The spawn this step's uniform draws, used where the episode ends.
      const int spawn =
          load_shared_now(spawns + min(__float2int_rz(__fmul_rn(u, n_bg_f)), p.n_bg - 1));
      const int e = moves[base + a];
      const float reward = reward_of[base + a];
      const int nd = (e >> 1) & 7;
      const int sc2 = sc + 1;
      const bool done = (e & 1) || sc2 >= p.max_steps;
      const float run2 = __fadd_rn(run, reward);
      rew_sum = __fadd_rn(rew_sum, reward);
      ep_sum = __fadd_rn(ep_sum, done ? run2 : 0.f);
      eps += done;
      run = done ? 0.f : run2;
      base = done ? spawn : e >> 4;
      d = done ? kSpawnDir : (nd != kKeepDir ? nd : d);
      sc = done ? 0 : sc2;
    }
  }

  const int cell = base / kNumActions;
  pos_out[2 * (size_t)b] = cell / p.s1;
  pos_out[2 * (size_t)b + 1] = cell % p.s1;
  dirs_out[b] = d;
  sc_out[b] = sc;
  run_out[b] = run;
  rew_out[b] = rew_sum;
  ep_out[b] = ep_sum;
  eps_out[b] = eps;
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

// K steps with the auto-reset.  pos (B, 2), dirs (B,), sc (B,) int32,
// run_ret (B,) float32; acts (K, B) int32, rnd (K, B) float32; table
// (n_table,) int32, 16-byte aligned, n_table a multiple of 4: n_moves move
// entries, n_moves rewards, n_bg spawn rows (ms_table in ops/maze_slab.py).
// Outputs: pos (B, 2), dirs, sc (B,) int32, run_ret, rew_sum, ep_sum (B,)
// float32, eps (B,) int32.  Launches on `stream` and returns the launch's
// cudaError_t.
extern "C" int maze_steps(const void* pos, const void* dirs, const void* sc,
                          const void* run_ret, const void* acts,
                          const void* rnd, const void* table, void* pos_out,
                          void* dirs_out, void* sc_out, void* run_out,
                          void* rew_sum, void* ep_sum, void* eps, int B,
                          int K, int s1, int n_moves, int n_bg, int max_steps,
                          void* stream) {
  using namespace maze;
  const int n_table = 2 * n_moves + n_bg + (-(2 * n_moves + n_bg) & 3);
  const size_t smem = (size_t)n_table * sizeof(int);
  if (B < 1 || K < 1 || s1 < 1 || n_moves < kNumActions || n_bg < 1 ||
      ((size_t)table & 15) != 0)
    return (int)cudaErrorInvalidValue;
  // The tile buffers take kTileBytes of static shared memory beside it.
  if (smem + kTileBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        steps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const MsParams p{B, K, s1, n_moves, n_bg, max_steps, n_table};
  const int blocks = (B + kThreads - 1) / kThreads;
  steps_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)pos, (const int*)dirs, (const int*)sc, (const float*)run_ret,
      (const int*)acts, (const float*)rnd, (const int4*)table, (int*)pos_out,
      (int*)dirs_out, (int*)sc_out, (float*)run_out, (float*)rew_sum,
      (float*)ep_sum, (int*)eps, p);
  return (int)cudaGetLastError();
}
