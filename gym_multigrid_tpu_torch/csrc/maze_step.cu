// The Maze transition for a batch of envs, written by hand for Hopper
// (sm_90a): one step a launch (maze_step), and K steps with the auto-reset,
// the draws and the return sums in one launch (maze_steps_philox).
//
// Replaces the TPU kernel maze_step_slab of gym_multigrid_tpu/ops/pallas_maze.py
// (body maze_step_math in gym_multigrid_tpu/envs/maze.py).  Its plain PyTorch
// version is step_spec in gym_multigrid_tpu_torch/ops/maze_slab.py and the two
// agree bit for bit.
//
// Both entries read the step tabulated on the host by the plain version
// (ms_table in ops/maze_slab.py): for every (cell, action) the cell the
// move ends on (as cell * 5, the table's row), the direction after it (or
// kKeepDir where the move leaves it as it was), the termination and the
// reward's float32 bits, then the cell * 5 of each background cell in
// reset_spec's order.  A move is then one table read and its reward one
// more, and neither kernel repeats the step's float arithmetic.
//
// maze_step.  What bounds it on this card: launch latency.  An env is one
// agent: it reads 12 bytes (position, direction, action) and writes 20
// (position, direction, reward, termination), 0.26 MB for a batch of 8192,
// which the card's memory moves in well under a microsecond.  After the
// launch, what it waits for is its chain of dependent global reads.  The
// design:
// - one thread per env, blocks of MAZE_STEP_THREADS (128 unless built
//   otherwise; scripts/torch_kernel_probe.py --only maze times 64, 128 and
//   256 in turns: 2.43, 2.34 and 2.35 us at B = 8192 on an H100 at 700 W,
//   where the parent's three-read kernel took 2.60 and an empty kernel
//   1.71);
// - two round trips: the inputs, then the move's table entry and its
//   reward, issued together through the read-only cache (__ldg); the table
//   stays in L2 across launches and the board has no size limit.  The
//   direct reads of the can-enter, flag and obstacle rows (three round
//   trips, the last two after the move) are kept only for a position off
//   the board, which no reset or step makes: they clip it to the board
//   first, as the plain version does, with every float constant an
//   argument rounded once on the host and the reward formed with
//   __fmul_rn/__fsub_rn in the plain version's order.
// Bounds are checked in the natural axis order (row against S0, column
// against S1), unlike CtF's swapped bounds.
//
// maze_steps_philox runs K transitions with the per-env auto-reset and the
// return accounting: the episode math _maze_ms_math of
// gym_multigrid_tpu/ops/pallas_maze.py, whose plain PyTorch version is
// ms_philox_spec in ops/maze_slab.py (ms_spec on the counters' draws, the
// sums carried in).  It makes each step's action and spawn uniform from
// Philox counters (csrc/philox.cuh; the layout is ops/philox.py's MAZE
// stream: one call serves two steps), so it reads no draw from memory, and
// carries each env's reward sum, episode-return sum, episode count and
// running return in and out, so that a rollout sums once a call.  It
// replaces the pre-drawn entry maze_steps, which read an action and a
// uniform an env-step (drawn by two other launches) by cp.async tiles and
// ran one thread an env, two warps an SM.
//
// What bounds it.  At B = 8192 and K = 100 it moves about 0.46 MB (the
// state and the sums in and out, the table once), 0.14 us at 3.35 TB/s,
// and needs about 57 M integer operations (50 Philox calls of 78 an env,
// a few for each word, 25 a step), 3.4 us at the card's int32 rate: bound
// by operations.  What sets its time is one env's chain of K dependent
// steps, each a shared-memory read and the operations that form the next
// read's address, which no batch size hides (B = 64 takes as long as
// B = 8192).  Timed on an H100 at 700 W (scripts/torch_kernel_probe.py
// --only maze, in turns): a first design, G lanes an env sharing the
// draws by __shfl_sync, ran each window's Philox calls in series with the
// steps on the same warp (9.2 us at G = 4, 13.5 at G = 1, against the
// pre-drawn maze_steps' 8.9); this one takes 7.8-8.0 us, about 3.5 at
// K = 1 and 84 cycles a step after.  The design:
// - warp-specialised blocks of 64 envs: two chain warps, one thread an
//   env, run the steps; kProducers threads an env in the other warps
//   (MAZE_STEPS_PRODUCERS: 4, 2 and 1 took 7.8, 8.0 and 10.0 us) make the
//   draws of the next window of kWindow steps (MAZE_STEPS_WINDOW: 16, 8
//   and 32 took 8.0, 8.1 and 9.2 us at 2) into a ring of two windows in
//   shared memory, each call's word pairs turned into the action and the
//   spawn row it picks, packed as spawn row offset << 8 | 4 action; named
//   barriers hand the slots over (a FULL and an EMPTY barrier a slot), so
//   the draws run on other warps' issue slots beside the chain;
// - the table is copied into shared memory once a block, 16 bytes a load,
//   all of a thread's loads issued before its stores, and re-encoded there
//   for the chain: a move entry as the byte offset of the row the move
//   ends on, its direction in bits 24..26 and the termination in the sign
//   bit, a spawn as its row's byte offset, the rewards as they are;
// - the chain thread keeps its state in registers, the position as its
//   row's byte offset; a step reads its packed draw (off the chain), then
//   the move entry and its reward at that offset plus 4 a, and forms the
//   next row as one compare (terminated or truncated) and one select, so
//   that the chain between two reads is three integer operations (an
//   8-byte (entry, reward) read took 9.1 us against 8.2, and a `done`
//   formed as an integer and tested again cost three more operations a
//   step); a window whose steps all lie in the chunk runs unpredicated;
// - every sum is formed with __fadd_rn in _maze_ms_math's order (a zero
//   added where no episode ended), so none is contracted or reordered.

#include <cuda_runtime.h>

#include "philox.cuh"

namespace maze {
namespace {

#ifndef MAZE_STEP_THREADS
#define MAZE_STEP_THREADS 128
#endif
#ifndef MAZE_STEPS_PRODUCERS
#define MAZE_STEPS_PRODUCERS 4
#endif
#ifndef MAZE_STEPS_WINDOW
#define MAZE_STEPS_WINDOW 16
#endif

constexpr int kThreads = MAZE_STEP_THREADS;  // maze_step's block
constexpr int kNumActions = 5;
// Actions: stay, left, down, right, up (rows of CTF_ACTION_TO_VEC).
constexpr int kStay = 0, kLeft = 1, kDown = 2, kRight = 3, kUp = 4;
// Rows of the cells table (ops/maze_slab.py maze_static_inputs).
constexpr int kCanEnterRow = 0, kFlagRow = 1, kObstacleRow = 2;
// The direction field of a table entry that leaves the direction as it was.
constexpr int kKeepDir = 4;
constexpr int kSpawnDir = 3;

constexpr int kProducers = MAZE_STEPS_PRODUCERS;  // draw threads an env
static_assert(kProducers == 1 || kProducers == 2 || kProducers == 4,
              "draw threads an env: 1, 2 or 4");
constexpr int kWindow = MAZE_STEPS_WINDOW;  // steps a ring slot
static_assert(kWindow % (2 * kProducers) == 0 && kWindow <= 64,
              "a window is whole Philox calls for every draw thread");
constexpr int kEnvs = 64;                   // envs a block: two chain warps
constexpr int kStepsThreads = kEnvs * (1 + kProducers);
constexpr int kRingBytes = 2 * kWindow * kEnvs * 4;
constexpr int kFullBar = 1, kEmptyBar = 3;  // named barriers of slots 0 and 1 (0: __syncthreads)
constexpr int kCopyVecs = 4;                // int4 table loads a thread issues at once
constexpr int kMaxSmem = 232448;            // shared memory a block can have
constexpr int kMaxDevices = 64;             // devices a process may launch on

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
            const int* __restrict__ table, int* __restrict__ pos_out,
            int* __restrict__ dirs_out, float* __restrict__ reward_out,
            int* __restrict__ term_out, const Params p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.B) return;
  const int n_cells = p.s0 * p.s1;
  int p0 = pos[2 * (size_t)b], p1 = pos[2 * (size_t)b + 1], d = dirs[b];
  const int a = min(max(acts[b], 0), kNumActions - 1);

  if (p0 >= 0 && p0 < p.s0 && p1 >= 0 && p1 < p.s1) {
    // The tabulated move: its entry and its reward, read together.
    const int at = (p0 * p.s1 + p1) * kNumActions + a;
    const int e = __ldg(table + at);
    const float reward = __int_as_float(__ldg(table + n_cells * kNumActions + at));
    const int next = (e >> 4) / kNumActions, nd = (e >> 1) & 7;
    pos_out[2 * (size_t)b] = next / p.s1;
    pos_out[2 * (size_t)b + 1] = next % p.s1;
    dirs_out[b] = nd == kKeepDir ? d : nd;
    reward_out[b] = reward;
    term_out[b] = e & 1;
    return;
  }

  // A position off the board: the plain step, its cell reads clipped.
  auto cell = [&](int row, int c0, int c1) -> bool {
    const int q0 = min(max(c0, 0), p.s0 - 1), q1 = min(max(c1, 0), p.s1 - 1);
    return __ldg(cells + (size_t)row * n_cells + q0 * p.s1 + q1) > 0;
  };
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

// What a maze_steps_philox launch reads and writes.
struct MsParams {
  const int* cell_in;   // (B,) row * S1 + col
  const int* dir_in;    // (B,)
  const int* sc_in;     // (B,) step counts
  const float* run_in;  // (B,) returns of the episodes in progress
  const float* rew_in;  // (B,) reward sums
  const float* ep_in;   // (B,) summed returns of the finished episodes
  const int* eps_in;    // (B,) finished episodes
  const int4* table;    // ms_table, n_table int32
  int* cell_out;
  int* dir_out;
  int* sc_out;
  float* run_out;
  float* rew_out;
  float* ep_out;
  int* eps_out;
  int B, K, n_moves, n_bg, max_steps, n_table;
  unsigned key0, key1, step0;
};

// One env's state across the steps.
struct Env {
  int base;   // the byte offset of the position's row of shared moves
  int d, sc, eps;
  float run, rew, ep;
};

// The shared-memory move entry (see the design notes above): the byte
// offset of the row the move ends on, then the direction, then the
// termination in the sign bit.
constexpr int kRowBytes = kNumActions * 4;  // a cell's row of entries
constexpr int kOffsetBits = 0xffffff;
constexpr int kDirShift = 24;

// The draws of the two steps of one Philox call, each packed as
// spawn row offset << 8 | 4 * action id.
struct Pair {
  int even, odd;
};

// A step's action and the spawn row its uniform picks: the
// min(floor(u * n_bg), n_bg - 1)-th background cell, the float32 product
// truncated as reset_spec forms it.
__device__ __forceinline__ int packed_draw(unsigned wa, unsigned wu, const int* spawns,
                                           int n_bg) {
  const int j = min(__float2int_rz(__fmul_rn(philox::uniform(wu), (float)n_bg)), n_bg - 1);
  return spawns[j] << 8 | philox::action(wa) * 4;
}

// Pair i of the chunk: the steps whose counter is ((step0 & ~1) + 2 i) >> 1
// (ops/philox.py's MAZE layout; the counter wraps with the step).
__device__ __forceinline__ Pair draw_pair(const MsParams& q, unsigned b, int i,
                                          const int* spawns) {
  const unsigned c = ((q.step0 & ~1u) + 2u * (unsigned)i) >> 1;
  const philox::Words w = philox::philox(0u, b, c, philox::kMaze, q.key0, q.key1);
  return Pair{packed_draw(w.w[0], w.w[1], spawns, q.n_bg),
              packed_draw(w.w[2], w.w[3], spawns, q.n_bg)};
}

// One step of _maze_ms_math on the shared moves (`rewards` bytes past the
// entries): the move, the sums, and the spawn where the episode ends.
__device__ __forceinline__ void step(Env& s, int draw, const char* moves, int rewards,
                                     int max_steps) {
  const char* at = moves + s.base + (draw & 0xff);
  const int m = *reinterpret_cast<const int*>(at);
  const float reward = *reinterpret_cast<const float*>(at + rewards);
  const int nd = (m >> kDirShift) & 7;
  const int sc2 = s.sc + 1;
  // done = terminated (the sign bit) or truncated, as a predicate that
  // selects the next row directly.
  int next, done;
  asm("{\n\t.reg .pred t, p;\n\t"
      "setp.ge.s32 t, %2, %3;\n\t"
      "setp.lt.or.s32 p, %4, 0, t;\n\t"
      "selp.b32 %0, %5, %6, p;\n\t"
      "selp.b32 %1, 1, 0, p;\n\t}"
      : "=r"(next), "=r"(done)
      : "r"(sc2), "r"(max_steps), "r"(m), "r"(draw >> 8), "r"(m & kOffsetBits));
  const float run2 = __fadd_rn(s.run, reward);
  s.rew = __fadd_rn(s.rew, reward);
  s.ep = __fadd_rn(s.ep, done ? run2 : 0.f);
  s.eps += done;
  s.run = done ? 0.f : run2;
  s.base = next;
  s.d = done ? kSpawnDir : (nd != kKeepDir ? nd : s.d);
  s.sc = done ? 0 : sc2;
}

// The steps of one ring slot ([kWindow][kEnvs]): step i of the window
// takes slot[i][e], the word pair i & 1 of the window's pair i >> 1.  `first` is the chunk step
// of the window's first step (-1 when the chunk starts at an odd step);
// with kCheck, steps outside the chunk are skipped.
template <bool kCheck>
__device__ __forceinline__ void run_window(Env& s, const int* slot, int e, int first,
                                           int K, const char* moves, int rewards,
                                           int max_steps) {
#pragma unroll
  for (int i = 0; i < kWindow; ++i)
    if (!kCheck || (first + i >= 0 && first + i < K))
      step(s, slot[i * kEnvs + e], moves, rewards, max_steps);
}

// Named barriers over the whole block: wait for, or only signal, `id`.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" : : "r"(id), "r"(kStepsThreads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" : : "r"(id), "r"(kStepsThreads) : "memory");
}

__global__ void __launch_bounds__(kStepsThreads) philox_steps_kernel(const MsParams q) {
  extern __shared__ int4 smem4[];
  __shared__ int ring[2][kWindow][kEnvs];
  // Threads 0..63 run the chains (warps 0 and 1); the rest make the draws.
  const bool chain = threadIdx.x < kEnvs;
  const int e = threadIdx.x % kEnvs, g = threadIdx.x / kEnvs - 1;
  // A thread past the batch runs the last env beside it, so that every
  // warp takes part in the barriers, and writes nothing.
  const int b_raw = blockIdx.x * kEnvs + e;
  const bool live = b_raw < q.B;
  const int b = live ? b_raw : q.B - 1;

  // The chain's state first, so that its reads overlap the table copy.
  // The cell is clipped so that a position off the board cannot read
  // outside the table; cells on the board (every reset and step leaves
  // them so) are unchanged by it.
  const int n_cells = q.n_moves / kNumActions;
  Env s{};
  if (chain) {
    s.base = min(max(q.cell_in[b], 0), n_cells - 1) * kRowBytes;
    s.d = q.dir_in[b];
    s.sc = q.sc_in[b];
    s.run = q.run_in[b];
    s.rew = q.rew_in[b];
    s.ep = q.ep_in[b];
    s.eps = q.eps_in[b];
  }

  // The table, into shared memory, re-encoded (every load of a round
  // before its stores): a move entry (next * 5) << 4 | dir << 1 |
  // terminated, and a spawn's cell * 5, as byte offsets of rows of shared
  // entries; the rewards as they are.
  const int n_vec = q.n_table / 4;
  for (int v0 = 0; v0 < n_vec; v0 += kCopyVecs * kStepsThreads) {
    int4 v[kCopyVecs];
#pragma unroll
    for (int r = 0; r < kCopyVecs; ++r) {
      const int i = v0 + r * kStepsThreads + threadIdx.x;
      if (i < n_vec) v[r] = __ldg(q.table + i);
    }
#pragma unroll
    for (int r = 0; r < kCopyVecs; ++r) {
      const int i = v0 + r * kStepsThreads + threadIdx.x;
      if (i >= n_vec) continue;
      const auto encode = [&](int at, int x) {
        if (at < q.n_moves)
          return (x >> 4) * 4 | ((x >> 1) & 7) << kDirShift | (int)((unsigned)x << 31);
        return at >= 2 * q.n_moves ? x * 4 : x;
      };
      smem4[i] = make_int4(encode(4 * i, v[r].x), encode(4 * i + 1, v[r].y),
                           encode(4 * i + 2, v[r].z), encode(4 * i + 3, v[r].w));
    }
  }
  __syncthreads();
  const char* moves = reinterpret_cast<const char*>(smem4);
  const int rewards = 4 * q.n_moves;
  const int* spawns = reinterpret_cast<const int*>(smem4) + 2 * q.n_moves;

  // Window w holds the chunk's steps kWindow w - off .. kWindow (w + 1) -
  // 1 - off: its pairs kWindow / 2 * w .. kWindow / 2 * (w + 1) - 1.
  const int off = (int)(q.step0 & 1u);
  const int n_windows = (off + q.K + kWindow - 1) / kWindow;
  if (chain) {
    for (int w = 0; w < n_windows; ++w) {
      const int slot = w & 1, first = kWindow * w - off;
      bar_sync(kFullBar + slot);
      if (first >= 0 && first + kWindow <= q.K)
        run_window<false>(s, &ring[slot][0][0], e, first, q.K, moves, rewards, q.max_steps);
      else
        run_window<true>(s, &ring[slot][0][0], e, first, q.K, moves, rewards, q.max_steps);
      if (w + 2 < n_windows) bar_arrive(kEmptyBar + slot);
    }
    if (!live) return;
    q.cell_out[b] = s.base / kRowBytes;
    q.dir_out[b] = s.d;
    q.sc_out[b] = s.sc;
    q.run_out[b] = s.run;
    q.rew_out[b] = s.rew;
    q.ep_out[b] = s.ep;
    q.eps_out[b] = s.eps;
    return;
  }
  // Draw thread g of env e makes the calls g, g + kProducers, ... of each
  // window (the last window's calls past the chunk too, unused).
  for (int w = 0; w < n_windows; ++w) {
    const int slot = w & 1;
    if (w >= 2) bar_sync(kEmptyBar + slot);
#pragma unroll
    for (int c = 0; c < kWindow / 2 / kProducers; ++c) {
      const int j = c * kProducers + g;
      const Pair d = draw_pair(q, (unsigned)b, kWindow / 2 * w + j, spawns);
      ring[slot][2 * j][e] = d.even;
      ring[slot][2 * j + 1][e] = d.odd;
    }
    bar_arrive(kFullBar + slot);
  }
}

}  // namespace
}  // namespace maze

// pos (B, 2), dirs (B, 1), acts (B, 1) int32; cells (3, s0 * s1) int32
// (can_enter, flag, obstacle); table: ms_table of ops/maze_slab.py
// (5 s0 s1 move entries, then their rewards).  Outputs: pos (B, 2),
// dirs (B, 1) int32, reward (B, 1) float32, term (B, 1) int32.
// obstacle_on: the obstacle penalty is not 0.  Launches on `stream` and
// returns the launch's cudaError_t.
extern "C" int maze_step(const void* pos, const void* dirs, const void* acts,
                         const void* cells, const void* table, void* pos_out,
                         void* dirs_out, void* reward, void* term, int B, int s0,
                         int s1, int obstacle_on, float flag_reward,
                         float obstacle_penalty, float step_penalty,
                         void* stream) {
  using namespace maze;
  if (B < 1 || s0 < 1 || s1 < 1) return (int)cudaErrorInvalidValue;
  const Params p{B, s0, s1, obstacle_on, flag_reward, obstacle_penalty,
                 step_penalty};
  const int blocks = (B + kThreads - 1) / kThreads;
  step_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)pos, (const int*)dirs, (const int*)acts, (const int*)cells,
      (const int*)table, (int*)pos_out, (int*)dirs_out, (float*)reward,
      (int*)term, p);
  return (int)cudaGetLastError();
}

// K steps with the auto-reset, the draws made from the Philox counters of
// the global steps step0 .. step0 + K - 1 under the key (key0, key1).
// cell (B,) int32 (row * S1 + col), dirs, sc (B,) int32, run_ret, rew_sum,
// ep_sum (B,) float32, eps (B,) int32; table (n_table,) int32, 16-byte
// aligned, n_table = 2 n_moves + n_bg rounded up to a multiple of 4
// (ms_table in ops/maze_slab.py).  Outputs: the same seven, each sum with
// the K steps' terms added.  The key and the step are uint32 words passed
// as C ints.  Launches on `stream` and returns the launch's cudaError_t.
extern "C" int maze_steps_philox(const void* cell, const void* dirs, const void* sc,
                                 const void* run_ret, const void* rew_sum,
                                 const void* ep_sum, const void* eps, const void* table,
                                 void* cell_out, void* dirs_out, void* sc_out,
                                 void* run_out, void* rew_out, void* ep_out,
                                 void* eps_out, int B, int K, int n_moves, int n_bg,
                                 int max_steps, int key0, int key1, int step0,
                                 void* stream) {
  using namespace maze;
  const int n_table = 2 * n_moves + n_bg + (-(2 * n_moves + n_bg) & 3);
  const size_t smem = (size_t)n_table * sizeof(int);
  if (B < 1 || K < 1 || n_moves < kNumActions || n_moves % kNumActions || n_bg < 1 ||
      smem + kRingBytes > (size_t)kMaxSmem || ((size_t)table & 15) != 0)
    return (int)cudaErrorInvalidValue;
  // Per device, the dynamic shared memory allowed so far: the attribute is
  // set only when a launch needs more.
  static int allowed[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem + kRingBytes > 48 * 1024 && (size_t)allowed[dev] < smem) {
    err = cudaFuncSetAttribute(philox_steps_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = (int)smem;
  }
  const MsParams q{(const int*)cell, (const int*)dirs, (const int*)sc,
                   (const float*)run_ret, (const float*)rew_sum, (const float*)ep_sum,
                   (const int*)eps, (const int4*)table, (int*)cell_out, (int*)dirs_out,
                   (int*)sc_out, (float*)run_out, (float*)rew_out, (float*)ep_out,
                   (int*)eps_out, B, K, n_moves, n_bg, max_steps, n_table,
                   (unsigned)key0, (unsigned)key1, (unsigned)step0};
  const int blocks = (B + kEnvs - 1) / kEnvs;
  philox_steps_kernel<<<blocks, kStepsThreads, smem, (cudaStream_t)stream>>>(q);
  return (int)cudaGetLastError();
}
