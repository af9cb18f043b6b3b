// One Wildfire transition for a batch of envs, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel wildfire_step_slab of
// gym_multigrid_tpu/ops/pallas_wildfire.py (body wf_step_math in
// gym_multigrid_tpu/envs/wildfire.py).  Its plain PyTorch version is
// step_spec in gym_multigrid_tpu_torch/ops/wildfire_slab.py and the two agree
// bit for bit.
//
// What bounds it on this card: memory.  An env's step reads its board and
// one uniform per cell and writes the board back, about 12 bytes per cell
// (3,128 bytes per env at 16x16 with 2 agents, 25.6 MB for a batch of
// 8192), against a few integer operations per cell.  The design:
// - one warp per env, 8 envs to a block of 256 threads.  Lane l holds cells
//   l, l + 32, l + 64, ... of the board in registers (NK words of 32 cells,
//   NK a power of two, up to 32 for a 32x32 board), so every load and store
//   of a row, and of its uniforms, is a run of consecutive words;
// - the agents' moves (at most 4, one after another, each seeing the moves
//   before it) run in every lane alike on the same values, with the agents
//   in fixed-size register arrays indexed only by unrolled loop counters.
//   The move order is the j-th permutation of the A! table in lexicographic
//   order (itertools.permutations), decoded digit by digit (factorial
//   number system) with no table, as csrc/ctf_step.cu does;
// - the spread stencil reads its neighbours from the board's fire cells
//   after the extinguish, staged as one bit per cell in shared memory (one
//   __ballot_sync per word, NK words per warp), with no wrap at the edges.
//   The TPU kernel's (C, C) adjacency matmul fed the TPU's matrix unit and
//   is not carried over;
// - the counts (fires put out, trees ignited) are __popc of ballots, and
//   "no fire left" one __any_sync per word;
// - the ignition thresholds 1 - (1 - p_spread)^n arrive as float arguments
//   formed on the host from the numpy float32 table, as the plain version
//   forms them (no powf here), and the reward is formed with
//   __fmul_rn/__fsub_rn in the plain version's order, so no multiply-add is
//   contracted into an FMA; floor(u * A!) is __fmul_rn then __float2int_rz.
// Envelope: at most 4 agents (the move-order table's) and 1024 cells.

#include <cuda_runtime.h>

namespace wildfire {
namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxAgents = 4;
constexpr int kMaxCells = 1024;  // NK = 32 words; ops.wildfire_slab.MAX_CELLS
constexpr int kNumActions = 5;
// Actions: stay (0), left, down, right, up (rows of CTF_ACTION_TO_VEC,
// applied as x += vec[1], y += vec[0]).
constexpr int kLeft = 1, kDown = 2, kRight = 3, kUp = 4;
// WildfireWorld cell types, as in gym_multigrid_tpu_torch/core/world.py.
constexpr int kEmpty = 0, kTree = 1, kFire = 2, kBurnt = 3;

struct Params {
  int B, w, h, n_agents;
  // Ignition probability by burning-neighbour count 1..4 (0 for none).
  float p_ig1, p_ig2, p_ig3, p_ig4;
  float p_burnout, ext_reward, burn_penalty, step_penalty;
};

__device__ __forceinline__ int dx_of(int a) {
  return a == kLeft ? -1 : (a == kRight ? 1 : 0);
}
__device__ __forceinline__ int dy_of(int a) {
  return a == kDown ? -1 : (a == kUp ? 1 : 0);
}

template <int NK>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
step_kernel(const int* __restrict__ cells, const int* __restrict__ pos,
            const int* __restrict__ acts, const float* __restrict__ rnd,
            int* __restrict__ cells_out, int* __restrict__ pos_out,
            float* __restrict__ reward_out, int* __restrict__ ext_out,
            int* __restrict__ term_out, const Params p) {
  __shared__ unsigned s_fire[kWarpsPerBlock][NK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= p.B) return;  // the whole warp: it owns one env
  const int C = p.w * p.h, A = p.n_agents;
  const int* row = cells + (size_t)b * C;
  const float* u = rnd + (size_t)b * (C + 1);

  // ---- moves, in every lane alike ----
  int xs[kMaxAgents], ys[kMaxAgents], act[kMaxAgents];
#pragma unroll
  for (int i = 0; i < kMaxAgents; ++i) {
    xs[i] = ys[i] = act[i] = 0;
    if (i < A) {
      xs[i] = pos[(size_t)b * 2 * A + 2 * i];
      ys[i] = pos[(size_t)b * 2 * A + 2 * i + 1];
      act[i] = min(max(acts[(size_t)b * A + i], 0), kNumActions - 1);
    }
  }
  int fact = 1;
  for (int k = 2; k <= A; ++k) fact *= k;
  int perm_j = min(__float2int_rz(__fmul_rn(u[0], (float)fact)), fact - 1);
  // A negative index selects no permutation: agent 0 moves in every slot.
  const bool shuffled = perm_j >= 0;
  int radix = fact;  // (A - slot)! before slot's digit is taken
  unsigned taken = 0u;
#pragma unroll
  for (int slot = 0; slot < kMaxAgents; ++slot) {
    if (slot >= A) continue;
    int mover = 0;
    if (shuffled) {
      // The r-th agent (0-based) that has not moved yet moves now: r is the
      // slot's digit of j in the factorial number system.
      radix /= A - slot;
      const int r_pick = perm_j / radix;
      perm_j -= r_pick * radix;
      int cnt = 0;
#pragma unroll
      for (int i = 0; i < kMaxAgents; ++i) {
        const bool free_i = i < A && !((taken >> i) & 1u);
        if (free_i && cnt == r_pick) mover = i;
        cnt += free_i;
      }
      taken |= 1u << mover;
    }
    int a = 0, px = 0, py = 0;
#pragma unroll
    for (int i = 0; i < kMaxAgents; ++i)
      if (i == mover) {
        a = act[i];
        px = xs[i];
        py = ys[i];
      }
    // Clipped to the board; blocked by any agent on the target, the mover
    // itself included.
    const int nx = min(max(px + dx_of(a), 0), p.w - 1);
    const int ny = min(max(py + dy_of(a), 0), p.h - 1);
    bool occupied = false;
#pragma unroll
    for (int i = 0; i < kMaxAgents; ++i) occupied |= i < A && xs[i] == nx && ys[i] == ny;
    if (!occupied && (nx != px || ny != py)) {
#pragma unroll
      for (int i = 0; i < kMaxAgents; ++i)
        if (i == mover) {
          xs[i] = nx;
          ys[i] = ny;
        }
    }
  }

  // ---- extinguish: a fire cell under any agent becomes burnt ----
  int under[kMaxAgents];
#pragma unroll
  for (int i = 0; i < kMaxAgents; ++i) under[i] = i < A ? ys[i] * p.w + xs[i] : -1;
  int v[NK];
  int n_ext = 0;
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int c = 32 * k + lane;
    v[k] = c < C ? row[c] : kEmpty;  // a slot past the board is never fire
    bool occ = false;
#pragma unroll
    for (int i = 0; i < kMaxAgents; ++i) occ |= under[i] == c;
    const bool put_out = c < C && occ && v[k] == kFire;
    n_ext += __popc(__ballot_sync(kFull, put_out));
    if (put_out) v[k] = kBurnt;
  }

  // ---- the post-extinguish fire cells, one bit each, shared by the warp ----
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const unsigned word = __ballot_sync(kFull, v[k] == kFire);
    if (lane == 0) s_fire[warp][k] = word;
  }
  __syncwarp();
  auto fire_at = [&](int c) -> int { return (s_fire[warp][c >> 5] >> (c & 31)) & 1u; };

  // ---- spread and burnout on one uniform per cell ----
  int n_ig = 0;
  bool burning = false;
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int c = 32 * k + lane;
    bool ignite = false;
    if (c < C) {
      const int x = c % p.w;
      const int nb = (c >= p.w ? fire_at(c - p.w) : 0) + (c + p.w < C ? fire_at(c + p.w) : 0) +
                     (x != 0 ? fire_at(c - 1) : 0) + (x != p.w - 1 ? fire_at(c + 1) : 0);
      const float p_ig = nb == 1 ? p.p_ig1
                         : nb == 2 ? p.p_ig2
                         : nb == 3 ? p.p_ig3
                         : nb == 4 ? p.p_ig4
                                   : 0.f;
      const float uc = u[1 + c];
      ignite = v[k] == kTree && uc < p_ig;
      const bool burnout = v[k] == kFire && uc < p.p_burnout;
      const int out = burnout ? kBurnt : (ignite ? kFire : v[k]);
      cells_out[(size_t)b * C + c] = out;
      burning |= out == kFire;
    }
    n_ig += __popc(__ballot_sync(kFull, ignite));
  }
  const bool any_fire = __any_sync(kFull, burning);

  if (lane == 0) {
    const float reward = __fsub_rn(
        __fsub_rn(__fmul_rn(p.ext_reward, (float)n_ext), __fmul_rn(p.burn_penalty, (float)n_ig)),
        p.step_penalty);
    reward_out[b] = reward;
    ext_out[b] = n_ext;
    term_out[b] = !any_fire;
  }
  if (lane < A) {
    int x = 0, y = 0;
#pragma unroll
    for (int i = 0; i < kMaxAgents; ++i)
      if (i == lane) {
        x = xs[i];
        y = ys[i];
      }
    pos_out[(size_t)b * 2 * A + 2 * lane] = x;
    pos_out[(size_t)b * 2 * A + 2 * lane + 1] = y;
  }
}

template <int NK>
cudaError_t launch(const void* const* in, void* const* out, const Params& p,
                   cudaStream_t stream) {
  const int blocks = (p.B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  step_kernel<NK><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      (const int*)in[0], (const int*)in[1], (const int*)in[2], (const float*)in[3],
      (int*)out[0], (int*)out[1], (float*)out[2], (int*)out[3], (int*)out[4], p);
  return cudaGetLastError();
}

}  // namespace
}  // namespace wildfire

// cells (B, width * height) int32, flat index y * width + x; pos (B, 2A)
// int32 [x0, y0, x1, ...]; acts (B, A) int32; rnd (B, 1 + width * height)
// float32 [move order, one per cell].  Outputs: cells and pos of the same
// shapes, reward (B, 1) float32, n_ext and term (B, 1) int32.  p_ig1..4:
// ignition probability by burning-neighbour count.  Launches on `stream`
// and returns the launch's cudaError_t.
extern "C" int wildfire_step(const void* cells, const void* pos, const void* acts,
                             const void* rnd, void* cells_out, void* pos_out,
                             void* reward, void* n_ext, void* term, int B,
                             int width, int height, int n_agents, float p_ig1,
                             float p_ig2, float p_ig3, float p_ig4,
                             float p_burnout, float ext_reward,
                             float burn_penalty, float step_penalty,
                             void* stream) {
  using namespace wildfire;
  const int C = width * height;
  if (B < 1 || n_agents < 1 || n_agents > kMaxAgents || width < 1 || height < 1 ||
      C > kMaxCells)
    return (int)cudaErrorInvalidValue;
  const Params p{B, width, height, n_agents, p_ig1, p_ig2, p_ig3, p_ig4,
                 p_burnout, ext_reward, burn_penalty, step_penalty};
  const void* in[] = {cells, pos, acts, rnd};
  void* out[] = {cells_out, pos_out, reward, n_ext, term};
  const int words = (C + 31) / 32;
  auto run = words <= 1    ? launch<1>
             : words <= 2  ? launch<2>
             : words <= 4  ? launch<4>
             : words <= 8  ? launch<8>
             : words <= 16 ? launch<16>
                           : launch<32>;
  return (int)run(in, out, p, (cudaStream_t)stream);
}
