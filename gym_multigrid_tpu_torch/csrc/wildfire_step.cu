// One Wildfire transition for a batch of envs, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel wildfire_step_slab of
// gym_multigrid_tpu/ops/pallas_wildfire.py (body wf_step_math in
// gym_multigrid_tpu/envs/wildfire.py).  Its plain PyTorch version is
// step_spec in gym_multigrid_tpu_torch/ops/wildfire_slab.py and the two agree
// bit for bit.
//
// What bounds it on this card: memory, once the instructions per cell are
// few enough.  An env's step reads its board and one uniform per cell and
// writes the board back, about 12 bytes per cell (3,128 bytes per env at
// 16x16 with 2 agents, 25.6 MB for a batch of 8192), against a few integer
// operations per cell.  The design:
// - persistent blocks, as many as fit on the SMs at once (one wave, sized
//   by the occupancy calculator), each walking over tiles of T consecutive
//   envs (tile_envs: 8, or 4 above 512 cells), one warp per env;
// - a two-stage ring of tiles in shared memory fed by the Tensor Memory
//   Accelerator: one thread issues two 1-D bulk copies per tile (its boards,
//   4 T C bytes, and its uniforms, 4 T (C + 1) bytes, both contiguous in the
//   batch) that complete on the stage's mbarrier.  A block issues its next
//   tile as soon as the current one has landed, so the next tile's bytes
//   are in flight while this one computes, and the first tiles of all
//   blocks, requested alone, arrive first.  With T a multiple of 4
//   every span's size and offset is a multiple of 16 bytes, as the bulk copy
//   needs; the wrapper checks that the tensors are 16-byte aligned
//   (ops.wildfire_slab.tile_spans lists the same spans).  The last B mod T
//   envs, the ragged tail, take plain loads and stores;
// - the moves need only pos, acts and the move-order uniform, which each
//   warp loads before it waits on the tile's barrier, so that the serial
//   move chain overlaps the copy.  The agents (at most 4, one after
//   another, each seeing the moves before it) move in every lane alike, in
//   registers; the order is the j-th permutation of the A! table in
//   lexicographic order, read from csrc/move_order.cuh's table;
// - lane l holds cells l, l + 32, l + 64, ... (NK words of 32 cells) read
//   from shared memory, and writes the new cells back in place; the tile's
//   boards then leave in one bulk copy from shared to global memory;
// - the spread stencil works on words: the post-extinguish fire cells are
//   one ballot word per 32 cells, kept by lane k for word k; each lane
//   shifts its word and its neighbours' (fetched by __shfl_sync) into the
//   four neighbour words (north and south by the board's width, west and
//   east by one, the board's edge columns masked out, with no wrap) and
//   adds them into three bit planes of the neighbour count, so a cell's
//   count is three bits and its ignition threshold three selects.  Every
//   load of a tile's cells and uniforms comes before the first store, so no
//   loop waits on memory.  The TPU kernel's (C, C) adjacency matmul fed the
//   TPU's matrix unit and is not carried over;
// - the counts (fires put out, trees ignited) are summed per lane and
//   reduced once per env (__reduce_add_sync), "no fire left" one
//   __any_sync;
// - the ignition thresholds 1 - (1 - p_spread)^n arrive as float arguments
//   formed on the host from the numpy float32 table, as the plain version
//   forms them (no powf here), and the reward is formed with
//   __fmul_rn/__fsub_rn in the plain version's order, so no multiply-add is
//   contracted into an FMA; floor(u * A!) is __fmul_rn then __float2int_rz.
// Envelope: at most 4 agents (the move-order table's) and 1024 cells.
//
// The K-step entry wf_steps_philox runs K transitions with the per-env
// auto-reset of _ms_math (pallas_wildfire.py) in one launch: the
// counterpart of wildfire_step_slab's body on the JAX episode path, whose
// own K-step Pallas kernel was pruned on the TPU.  Its plain version
// ms_philox_spec in ops/wildfire_slab.py forms acts, rnd and rnd_reset
// from the counters of ops/philox.py and runs ms_spec (_ms_math's
// pre-drawn form) on them; the kernel makes the same draws by Philox4x32-10
// (csrc/philox.cuh), each only where it is read: the actions and the move
// order every step, a lane's four cell uniforms (one call) only when a
// word of its group holds a fire or a tree with a burning neighbour, the
// fresh board's only on the step its episode ended.  It takes the key and
// the global step of its first step, so no uniform crosses HBM.  Both
// entries run the same moves and cell step (move_all, extinguish,
// spread_cell), and skip the spread of a word with no fire and no
// ignitable tree (the `todo` words of extinguish), whose cells no uniform
// can change.  One warp per env keeps the board in its lanes' registers
// for all K steps, so a launch reads and writes each board once.  A
// finished env gets a fresh board in the kernel (fresh_board): its trees
// by one compare a cell, the fires picked among the trees by a popcount
// prefix over the lanes' ballot words, the agents by picks::pick_untaken.
// The sums are __fadd_rn adds in _ms_math's order, a +0 added where no
// episode ended.  What bounds it at 16x16, B = 8192: the SMs' instruction
// issue, not one warp's chain (scripts/torch_kernel_probe.py: a lone
// warp's step takes about a quarter of a full batch's).

#include <cuda_runtime.h>

#include <cstdint>

#include "move_order.cuh"
#include "philox.cuh"
#include "picks.cuh"

namespace wildfire {
namespace {

using move_order::kMoveOrders;
using move_order::kNumOrders;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxAgents = 4;    // the move-order table's (csrc/move_order.cuh)
constexpr int kMaxCells = 1024;  // NK = 32 words; ops.wildfire_slab.MAX_CELLS
constexpr int kNumActions = 5;
constexpr int kMaxDevices = 64;
// Actions: stay (0), left, down, right, up (rows of CTF_ACTION_TO_VEC,
// applied as x += vec[1], y += vec[0]).
constexpr int kLeft = 1, kDown = 2, kRight = 3, kUp = 4;
// WildfireWorld cell types, as in gym_multigrid_tpu_torch/core/world.py.
constexpr int kEmpty = 0, kTree = 1, kFire = 2, kBurnt = 3;

// Envs per tile (and warps per block): 8, or 4 for boards above 512 cells,
// so that two stages of a 32x32 tile take 64 KB of shared memory.
// ops.wildfire_slab.tile_envs gives the same.
template <int NK>
__host__ __device__ constexpr int tile_envs() {
  return NK > 16 ? 4 : 8;
}

struct Params {
  int B, w, h, n_agents;
  // Ignition probability by burning-neighbour count 1..4 (0 for none).
  float p_ig1, p_ig2, p_ig3, p_ig4;
  float p_burnout, ext_reward, burn_penalty, step_penalty;
};

// The per-env outputs; the cells leave through their own pointer.
struct Outputs {
  int* pos;
  float* reward;
  int* n_ext;
  int* term;
};

// Lane k's words of the board's geometry: bit l of word k is cell
// 32 k + l, set if that cell lies in the board's first (left) or last
// (right) column.  The same for every env, found once per block.
struct EdgeWords {
  unsigned left, right;
};

__device__ __forceinline__ int dx_of(int a) {
  return a == kLeft ? -1 : (a == kRight ? 1 : 0);
}
__device__ __forceinline__ int dy_of(int a) {
  return a == kDown ? -1 : (a == kUp ? 1 : 0);
}

// ---- mbarriers and bulk copies (PTX) ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits for the completion of the barrier's phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Global -> shared, completing `bytes` of the barrier's transaction count.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Shared -> global; bulk_stores_read() waits until every such copy has
// read its shared memory.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst), "r"(src),
               "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_stores_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// ---- one env, by one warp ----

// The AA agents move one after another in `order`'s slots, each target
// clipped to the board and blocked by any agent on it, the mover included.
template <int AA>
__device__ __forceinline__ void move_agents(unsigned order, const int (&act)[kMaxAgents],
                                            int (&xs)[kMaxAgents], int (&ys)[kMaxAgents],
                                            int w, int h) {
#pragma unroll
  for (int slot = 0; slot < AA; ++slot) {
    const int mover = (order >> (4 * slot)) & 15u;
    int a = 0, px = 0, py = 0;
#pragma unroll
    for (int i = 0; i < AA; ++i)
      if (i == mover) {
        a = act[i];
        px = xs[i];
        py = ys[i];
      }
    const int nx = min(max(px + dx_of(a), 0), w - 1);
    const int ny = min(max(py + dy_of(a), 0), h - 1);
    bool occupied = false;
#pragma unroll
    for (int i = 0; i < AA; ++i) occupied |= xs[i] == nx && ys[i] == ny;
    if (!occupied && (nx != px || ny != py)) {
#pragma unroll
      for (int i = 0; i < AA; ++i)
        if (i == mover) {
          xs[i] = nx;
          ys[i] = ny;
        }
    }
  }
}

// The moves of one step, in every lane alike: the order is permutation
// min(floor(u0 * A!), A! - 1) of the A! table (clipped action ids in act).
__device__ __forceinline__ void move_all(const Params& p, const unsigned* orders, float u0,
                                         const int (&act)[kMaxAgents], int (&xs)[kMaxAgents],
                                         int (&ys)[kMaxAgents]) {
  const int A = p.n_agents;
  const int fact = move_order::num_orders(A);
  const int perm_j = min(__float2int_rz(__fmul_rn(u0, (float)fact)), fact - 1);
  // A negative index selects no permutation: agent 0 moves in every slot.
  const unsigned order = perm_j >= 0 ? orders[move_order::move_order_base(A) + perm_j] : 0u;
  switch (A) {
    case 1: move_agents<1>(order, act, xs, ys, p.w, p.h); break;
    case 2: move_agents<2>(order, act, xs, ys, p.w, p.h); break;
    case 3: move_agents<3>(order, act, xs, ys, p.w, p.h); break;
    default: move_agents<4>(order, act, xs, ys, p.w, p.h); break;
  }
}

// What a step's cells leave besides the board, the same in every lane.
struct Burn {
  int n_ext, n_ig;
  bool any_fire;
};

// What the extinguish leaves for the spread: lane k holds the bit planes of
// word k's burning-neighbour counts; bit k of `todo` (the same in every
// lane) is set where word k holds a fire or a tree with a burning
// neighbour, the only cells whose uniform is read.
struct Spread {
  unsigned plane0, plane1, plane2, todo;
  int n_ext;  // this lane's fires put out
};

// The step's first half, on the board in registers: lane l holds cells
// l, l + 32, ... in v (kEmpty past the board).  Fires under the agents (at
// their moved cells) are put out, then the burning neighbours of every
// cell are counted on the post-extinguish board.  The words the stencil
// needs move between lanes by shuffles.
template <int NK>
__device__ __forceinline__ Spread extinguish(const Params& p, int lane,
                                             const int (&xs)[kMaxAgents],
                                             const int (&ys)[kMaxAgents], int (&v)[NK],
                                             EdgeWords edge) {
  const int A = p.n_agents;

  // ---- extinguish: a fire cell under any agent becomes burnt ----
  int under[kMaxAgents];
#pragma unroll
  for (int i = 0; i < kMaxAgents; ++i) under[i] = i < A ? ys[i] * p.w + xs[i] : -1;
  int n_ext = 0;
  // lane k < NK: word k of the post-extinguish fire cells and of the trees
  unsigned fire = 0u, tree = 0u;
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int c = 32 * k + lane;
    bool occ = false;
#pragma unroll
    for (int i = 0; i < kMaxAgents; ++i) occ |= under[i] == c;
    const bool put_out = occ && v[k] == kFire;
    n_ext += put_out;
    if (put_out) v[k] = kBurnt;
    const unsigned word = __ballot_sync(kFull, v[k] == kFire);
    const unsigned trees = __ballot_sync(kFull, v[k] == kTree);
    if (lane == k) {
      fire = word;
      tree = trees;
    }
  }

  // ---- neighbour counts as bit planes, lane k for word k ----
  // Word j of the fire cells, 0 off either end of the board.
  auto fire_word = [&](int j) -> unsigned {
    const unsigned w = __shfl_sync(kFull, fire, j & 31);
    return j >= 0 && j < NK ? w : 0u;
  };
  const int q = p.w >> 5, r = p.w & 31;
  const unsigned north = __funnelshift_l(fire_word(lane - q - 1), fire_word(lane - q), r);
  const unsigned south = __funnelshift_r(fire_word(lane + q), fire_word(lane + q + 1), r);
  const unsigned west = __funnelshift_l(fire_word(lane - 1), fire, 1) & ~edge.left;
  const unsigned east = __funnelshift_r(fire, fire_word(lane + 1), 1) & ~edge.right;
  // north + south + west + east, bit-sliced: t1 + 2 c1 + t2 + 2 c2.
  const unsigned t1 = north ^ south, c1 = north & south;
  const unsigned t2 = west ^ east, c2 = west & east;
  const unsigned plane0 = t1 ^ t2, plane1 = (c1 ^ c2) | (t1 & t2), plane2 = c1 & c2;
  // Lanes NK and up hold no fire and no tree.
  const unsigned todo = __ballot_sync(kFull, (fire | (tree & (plane0 | plane1 | plane2))) != 0u);
  return Spread{plane0, plane1, plane2, todo, n_ext};
}

// The spread and the burnout of cell 32 k + lane, value vk, on its uniform
// u, for a word with a bit of `todo` set (warp-uniform: the other words
// change nothing whatever their uniforms, since a tree with no burning
// neighbour has threshold 0).
template <int NK>
__device__ __forceinline__ void spread_cell(const Params& p, int lane, int k, const Spread& s,
                                            int& vk, float u, int& n_ig, bool& burning) {
  const int c = 32 * k + lane;
  const bool b0 = (__shfl_sync(kFull, s.plane0, k) >> lane) & 1u;
  const bool b1 = (__shfl_sync(kFull, s.plane1, k) >> lane) & 1u;
  const bool b2 = (__shfl_sync(kFull, s.plane2, k) >> lane) & 1u;
  if (c < p.w * p.h) {
    // The threshold for b0 + 2 b1 + 4 b2 burning neighbours (0 for none).
    const float p01 = b0 ? p.p_ig1 : 0.f, p23 = b0 ? p.p_ig3 : p.p_ig2;
    const float p_ig = b2 ? p.p_ig4 : (b1 ? p23 : p01);
    const bool ignite = vk == kTree && u < p_ig;
    const bool burnout = vk == kFire && u < p.p_burnout;
    vk = burnout ? kBurnt : (ignite ? kFire : vk);
    n_ig += ignite;
    burning |= vk == kFire;
  }
}

__device__ __forceinline__ Burn burn_totals(const Spread& s, int n_ig, bool burning) {
  return Burn{__reduce_add_sync(kFull, s.n_ext), __reduce_add_sync(kFull, n_ig),
              __any_sync(kFull, burning) != 0};
}

// The step's cells with their uniforms in uc (lane l's cells l + 32 k):
// the extinguish, then the spread and the burnout of the words that hold a
// cell they can change; v holds the new board.
template <int NK>
__device__ __forceinline__ Burn burn(const Params& p, int lane, const int (&xs)[kMaxAgents],
                                     const int (&ys)[kMaxAgents], int (&v)[NK],
                                     const float (&uc)[NK], EdgeWords edge) {
  const Spread s = extinguish<NK>(p, lane, xs, ys, v, edge);
  int n_ig = 0;
  bool burning = false;
#pragma unroll
  for (int k = 0; k < NK; ++k)
    if ((s.todo >> k) & 1u) spread_cell<NK>(p, lane, k, s, v[k], uc[k], n_ig, burning);
  return burn_totals(s, n_ig, burning);
}

// The team reward, in the plain version's order with no contraction.
__device__ __forceinline__ float team_reward(const Params& p, const Burn& s) {
  return __fsub_rn(
      __fsub_rn(__fmul_rn(p.ext_reward, (float)s.n_ext), __fmul_rn(p.burn_penalty, (float)s.n_ig)),
      p.step_penalty);
}

// `wait` is called after the moves and before `row` and `u_cell` are read:
// for a tile it waits on the ring's barrier.  u_cell[c] is cell c's
// uniform; row_out may alias row.  Every load of row and u_cell comes
// before the first store to row_out, so nothing in the cell loops waits on
// memory that an earlier store might have changed.
template <int NK, typename Wait>
__device__ __forceinline__ void step_env(int b, int lane, const Params& p, const int* pos,
                                         const int* acts, const float* rnd, Wait wait,
                                         const int* row, const float* u_cell, int* row_out,
                                         const unsigned* orders, EdgeWords edge,
                                         const Outputs& out) {
  const int C = p.w * p.h, A = p.n_agents;

  // ---- moves, in every lane alike, on loads issued before the wait ----
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
  move_all(p, orders, rnd[(size_t)b * (C + 1)], act, xs, ys);

  wait();

  // ---- the env's cells and uniforms, lane l holding cells l + 32 k ----
  int v[NK];
  float uc[NK];
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int c = 32 * k + lane;
    v[k] = c < C ? row[c] : kEmpty;  // a slot past the board is never fire
    uc[k] = c < C ? u_cell[c] : 1.f;
  }
  const Burn s = burn<NK>(p, lane, xs, ys, v, uc, edge);
#pragma unroll
  for (int k = 0; k < NK; ++k)
    if (32 * k + lane < C) row_out[32 * k + lane] = v[k];

  if (lane == 0) {
    out.reward[b] = team_reward(p, s);
    out.n_ext[b] = s.n_ext;
    out.term[b] = !s.any_fire;
  }
  if (lane < A) {
    int x = 0, y = 0;
#pragma unroll
    for (int i = 0; i < kMaxAgents; ++i)
      if (i == lane) {
        x = xs[i];
        y = ys[i];
      }
    out.pos[(size_t)b * 2 * A + 2 * lane] = x;
    out.pos[(size_t)b * 2 * A + 2 * lane + 1] = y;
  }
}

// The n-th (0-based) set bit of m, which has more than n.
__device__ __forceinline__ int nth_set_bit(unsigned m, int n) {
  int at = 0;
#pragma unroll
  for (int half = 16; half > 0; half >>= 1) {
    const int c = __popc(m & ((1u << half) - 1u));
    if (n >= c) {
      n -= c;
      m >>= half;
      at += half;
    }
  }
  return at;
}

// A fresh board from the env's C + n_fires + A uniforms, as
// ops.wildfire_slab.reset_spec draws it: a tree on cell c where its
// uniform is below tree_density, the fires picked without replacement
// among the trees (none once they are used up), the agents picked without
// replacement among all cells.  tree_u(k) is the uniform of the lane's
// cell 32 k + lane, called for cells on the board only; pick_u(j) that of
// pick j (the fires', then the agents'), the same in every lane.  The tree
// cells are one ballot word per 32 cells, held by lane k for word k; a fire
// pick finds its word by a prefix sum of the words' popcounts over the
// lanes, then its bit.
template <int NK, typename TreeU, typename PickU>
__device__ __forceinline__ void fresh_board(const Params& p, float tree_density, int n_fires,
                                            int lane, TreeU&& tree_u, PickU&& pick_u,
                                            int (&v)[NK], int (&xs)[kMaxAgents],
                                            int (&ys)[kMaxAgents]) {
  const int C = p.w * p.h, A = p.n_agents;
  unsigned trees = 0u;
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int c = 32 * k + lane;
    const bool tree = c < C && tree_u(k) < tree_density;
    v[k] = tree ? kTree : kEmpty;
    const unsigned word = __ballot_sync(kFull, tree);
    if (lane == k) trees = word;
  }
  for (int j = 0; j < n_fires; ++j) {
    const int here = __popc(trees);
    int upto = here;  // trees in words 0..lane
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, upto, off);
      if (lane >= off) upto += t;
    }
    const int count = __shfl_sync(kFull, upto, 31);
    if (count == 0) break;  // no tree left: no more fires
    const int r = picks::floor_pick(pick_u(j), count);
    const bool mine = r < upto && r >= upto - here;
    const int word = __ffs(__ballot_sync(kFull, mine)) - 1;
    const int bit = __shfl_sync(kFull, mine ? nth_set_bit(trees, r - (upto - here)) : 0, word);
#pragma unroll
    for (int k = 0; k < NK; ++k)
      if (k == word && lane == bit) v[k] = kFire;
    if (lane == word) trees &= ~(1u << bit);
  }
  int taken[kMaxAgents];
#pragma unroll
  for (int i = 0; i < kMaxAgents; ++i) {
    if (i < A) {
      const int cell = picks::pick_untaken(pick_u(n_fires + i), C, i, taken);
      xs[i] = cell % p.w;
      ys[i] = cell / p.w;
    }
  }
}

// Lane k's EdgeWords.
template <int NK>
__device__ __forceinline__ EdgeWords edge_words(const Params& p, int lane) {
  EdgeWords edge{0u, 0u};
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int x = (32 * k + lane) % p.w;
    const unsigned first = __ballot_sync(kFull, x == 0), last = __ballot_sync(kFull, x == p.w - 1);
    if (lane == k) edge = EdgeWords{first, last};
  }
  return edge;
}

// ---- the persistent kernel ----

template <int NK>
__global__ void __launch_bounds__(tile_envs<NK>() * 32)
step_kernel(const int* __restrict__ cells, const int* __restrict__ pos,
            const int* __restrict__ acts, const float* __restrict__ rnd,
            int* __restrict__ cells_out, const Outputs out, const Params p) {
  constexpr int T = tile_envs<NK>();
  // Two stages, each [T boards of C int32][T rows of C + 1 float32].
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) unsigned long long full_bar[2];
  __shared__ unsigned s_orders[kNumOrders];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = p.w * p.h;
  const int n_full = p.B / T;
  const uint32_t cells_bytes = 4u * T * C, rnd_bytes = 4u * T * (C + 1);
  const uint32_t stage_bytes = cells_bytes + rnd_bytes;
  const uint32_t ring0 = smem_addr(ring);
  const uint32_t bar0 = smem_addr(&full_bar[0]), bar1 = smem_addr(&full_bar[1]);

  // One thread sets up the barriers and issues the block's first tile; the
  // block writes its tables meanwhile.
  auto issue = [&](int tile, int stage) {
    const uint32_t bar = stage ? bar1 : bar0, dst = ring0 + stage * stage_bytes;
    mbar_expect_tx(bar, stage_bytes);
    bulk_load(dst, cells + (size_t)tile * T * C, cells_bytes, bar);
    bulk_load(dst + cells_bytes, rnd + (size_t)tile * T * (C + 1), rnd_bytes, bar);
  };
  if (threadIdx.x == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if ((int)blockIdx.x < n_full) issue(blockIdx.x, 0);
  }
  for (int i = threadIdx.x; i < kNumOrders; i += blockDim.x) s_orders[i] = kMoveOrders[i];
  const EdgeWords edge = edge_words<NK>(p, lane);
  __syncthreads();

  int use = 0;  // tiles this block has taken; stage use & 1, its parity (use >> 1) & 1
  for (int tile = blockIdx.x; tile < n_full; tile += gridDim.x, ++use) {
    const int stage = use & 1;
    unsigned char* base = ring + stage * stage_bytes;
    int* s_row = reinterpret_cast<int*>(base) + warp * C;
    const float* s_u = reinterpret_cast<const float*>(base + cells_bytes) + warp * (C + 1) + 1;
    const uint32_t bar = stage ? bar1 : bar0, parity = (use >> 1) & 1;
    // Once this tile has landed, the next one goes into the other stage,
    // as soon as the bulk store of that stage's last tile has read it: one
    // tile in flight ahead, so that the first tiles of all blocks arrive
    // first, and no wait on a store until its stage is needed again.
    auto wait = [&] {
      mbar_wait(bar, parity);
      if (threadIdx.x == 0 && tile + (int)gridDim.x < n_full) {
        bulk_stores_read();
        issue(tile + gridDim.x, stage ^ 1);
      }
    };
    step_env<NK>(tile * T + warp, lane, p, pos, acts, rnd, wait, s_row, s_u, s_row, s_orders, edge,
                 out);
    // The new cells were written through the generic proxy; the bulk store
    // reads them through the async proxy.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0)
      bulk_store(cells_out + (size_t)tile * T * C, ring0 + stage * stage_bytes, cells_bytes);
  }

  // The ragged tail, with plain loads, by the block that would take the
  // next tile.
  const int b = n_full * T + warp;
  if (blockIdx.x == n_full % gridDim.x && b < p.B) {
    const int* row = cells + (size_t)b * C;
    const float* u = rnd + (size_t)b * (C + 1) + 1;
    step_env<NK>(b, lane, p, pos, acts, rnd, [] {}, row, u, cells_out + (size_t)b * C, s_orders,
                 edge, out);
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int NK>
cudaError_t launch(const void* const* in, int* cells_out, const Outputs& out, const Params& p,
                   cudaStream_t stream) {
  constexpr int T = tile_envs<NK>();
  auto kernel = step_kernel<NK>;
  const int C = p.w * p.h;
  const int ring_bytes = 2 * 4 * T * (2 * C + 1);
  // Per device: the SM count, the dynamic shared memory this variant was
  // allowed, and the blocks that fit on an SM for the last board size.
  static int sms[kMaxDevices], allowed[kMaxDevices], fit_C[kMaxDevices], fit[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  if (allowed[dev] < ring_bytes) {
    // The variant's largest ring: its widest board.
    const int most = 2 * 4 * T * (2 * 32 * NK + 1);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return err;
    allowed[dev] = most;
  }
  if (fit_C[dev] != C) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit[dev], kernel, T * 32, ring_bytes);
    if (err != cudaSuccess) return err;
    if (fit[dev] < 1) return cudaErrorInvalidConfiguration;
    fit_C[dev] = C;
  }
  // One wave, with the tiles spread evenly over its blocks.
  const int n_full = p.B / T;
  const int most_blocks = sms[dev] * fit[dev];
  const int per_block = (n_full + most_blocks - 1) / most_blocks;
  const int blocks = n_full == 0 ? 1 : (n_full + per_block - 1) / per_block;
  kernel<<<blocks, T * 32, ring_bytes, stream>>>((const int*)in[0], (const int*)in[1],
                                                  (const int*)in[2], (const float*)in[3],
                                                  cells_out, out, p);
  return cudaGetLastError();
}

// ---- the K-step kernels ----

struct MsInputs {
  const int* cells;
  const int* pos;
  const int* sc;
  const int* ext;
  const float* run_ret;
};

struct MsOutputs {
  int* cells;
  int* pos;
  int* sc;
  int* ext;
  float* run_ret;
  float* rew_sum;
  float* ep_sum;
  int* eps;
};

struct MsParams {
  int K, n_fires, max_steps;
  float tree_density;
  // wf_steps_philox only: the key and the global step of the launch's
  // first step (ops.philox's counter layout).
  unsigned key0, key1, step0;
};

// Warps (envs) per block of the K-step kernels: as the step kernel's tile.
template <int NK>
__host__ __device__ constexpr int ms_warps() {
  return tile_envs<NK>();
}

// Blocks of a K-step kernel an SM should hold at once, which caps its
// registers.  Up to 256 cells, 4 blocks of 8 warps (64 registers a thread,
// a few bytes spilled) run B = 8192 in two waves where the compiler's own
// choice (107 registers, 2 blocks) takes four: measured faster for the
// K-step entry by scripts/torch_kernel_probe.py.  Larger boards keep the
// compiler's choice.
template <int NK>
__host__ __device__ constexpr int ms_min_blocks() {
  return NK <= 8 ? 4 : 1;
}

// One env's state between steps, alike in every lane of its warp but for
// the board: lane l holds cells l + 32 k in v.
template <int NK>
struct Env {
  int v[NK];
  int xs[kMaxAgents], ys[kMaxAgents];
  int sc, ext, eps;
  float run, rew_sum, ep_sum;
};

template <int NK>
__device__ __forceinline__ void load_env(const MsInputs& in, const Params& p, int b, int lane,
                                         Env<NK>& e) {
  const int C = p.w * p.h, A = p.n_agents;
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int c = 32 * k + lane;
    e.v[k] = c < C ? in.cells[(size_t)b * C + c] : kEmpty;
  }
#pragma unroll
  for (int i = 0; i < kMaxAgents; ++i) {
    e.xs[i] = i < A ? in.pos[(size_t)b * 2 * A + 2 * i] : 0;
    e.ys[i] = i < A ? in.pos[(size_t)b * 2 * A + 2 * i + 1] : 0;
  }
  e.sc = in.sc[b];
  e.ext = in.ext[b];
  e.eps = 0;
  e.run = in.run_ret[b];
  e.rew_sum = e.ep_sum = 0.f;
}

// The step's sums, alike in every lane, in _ms_math's order; returns
// whether the episode ended (the caller then puts a fresh board in).
template <int NK>
__device__ __forceinline__ bool account(const Params& p, int max_steps, const Burn& s,
                                        Env<NK>& e) {
  const float reward = team_reward(p, s);
  const int sc2 = e.sc + 1;
  const bool done = !s.any_fire || sc2 >= max_steps;
  const float run2 = __fadd_rn(e.run, reward);
  e.rew_sum = __fadd_rn(e.rew_sum, reward);
  e.ep_sum = __fadd_rn(e.ep_sum, done ? run2 : 0.f);
  e.eps += done;
  e.run = done ? 0.f : run2;
  e.sc = done ? 0 : sc2;
  e.ext = done ? 0 : e.ext + s.n_ext;
  return done;
}

template <int NK>
__device__ __forceinline__ void store_env(const MsOutputs& out, const Params& p, int b, int lane,
                                          const Env<NK>& e) {
  const int C = p.w * p.h, A = p.n_agents;
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int c = 32 * k + lane;
    if (c < C) out.cells[(size_t)b * C + c] = e.v[k];
  }
  if (lane < A) {
    int x = 0, y = 0;
#pragma unroll
    for (int i = 0; i < kMaxAgents; ++i)
      if (i == lane) {
        x = e.xs[i];
        y = e.ys[i];
      }
    out.pos[(size_t)b * 2 * A + 2 * lane] = x;
    out.pos[(size_t)b * 2 * A + 2 * lane + 1] = y;
  }
  if (lane == 0) {
    out.sc[b] = e.sc;
    out.ext[b] = e.ext;
    out.run_ret[b] = e.run;
    out.rew_sum[b] = e.rew_sum;
    out.ep_sum[b] = e.ep_sum;
    out.eps[b] = e.eps;
  }
}

// Uniforms of one stream laid out four to a counter (ops.philox): value j
// is word j % 4 of the counter (index_of(j / 4), b, s, stream).  The last
// counter's words are kept, so consecutive values of one counter cost one
// call.
struct LazyDraws {
  unsigned b, s, stream, key0, key1;
  int lane_base;  // index_of(g) = 32 g + lane_base for a cell stream, g for picks
  int stride;     // 32 for a cell stream, 1 for picks
  int group = -1;
  philox::Words words{};

  __device__ __forceinline__ float operator()(int j) {
    if ((j >> 2) != group) {
      group = j >> 2;
      words = philox::philox(stride * group + lane_base, b, s, stream, key0, key1);
    }
    return philox::uniform(words.w[j & 3]);
  }
};

// K steps with the auto-reset, the draws made in the kernel from
// ops.philox's counters, each only where it is read: the actions and the move order every step
// (lane 0 and lane 1 each make one call, shared by shuffles); a group of
// four cell uniforms (one call a lane: its cells l + 32 k, k = 4 g ..
// 4 g + 3) only when a word of the group holds a fire or a tree with a
// burning neighbour, the words with neither skipping the spread; a fresh
// board's uniforms only on the step its episode ended.  No uniform crosses
// HBM, and the board stays in the warp's registers for all K steps.
template <int NK>
__global__ void __launch_bounds__(ms_warps<NK>() * 32, ms_min_blocks<NK>())
philox_steps_kernel(const MsInputs in, const MsOutputs out, const Params p, const MsParams q) {
  constexpr int kWarps = ms_warps<NK>();
  __shared__ unsigned s_orders[kNumOrders];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  const int A = p.n_agents;
  for (int i = threadIdx.x; i < kNumOrders; i += blockDim.x) s_orders[i] = kMoveOrders[i];
  const EdgeWords edge = edge_words<NK>(p, lane);
  __syncthreads();
  if (b >= p.B) return;  // a whole warp: no block barrier follows

  Env<NK> e;
  load_env<NK>(in, p, b, lane, e);
  for (int kk = 0; kk < q.K; ++kk) {
    const unsigned s = q.step0 + (unsigned)kk;
    // Lane 0: the actions' call; lane 1: the move order's.
    const philox::Words w = philox::philox(0u, b, s, lane == 1 ? philox::kOrder : philox::kActions,
                                           q.key0, q.key1);
    int act[kMaxAgents];
#pragma unroll
    for (int i = 0; i < kMaxAgents; ++i) {
      const unsigned x = __shfl_sync(kFull, w.w[i], 0);
      act[i] = i < A ? philox::action(x) : 0;
    }
    const float u0 = philox::uniform(__shfl_sync(kFull, w.w[0], 1));
    move_all(p, s_orders, u0, act, e.xs, e.ys);

    const Spread sp = extinguish<NK>(p, lane, e.xs, e.ys, e.v, edge);
    int n_ig = 0;
    bool burning = false;
#pragma unroll
    for (int g = 0; g < (NK + 3) / 4; ++g) {
      if ((sp.todo >> (4 * g)) & 15u) {
        const philox::Words c =
            philox::philox(32u * g + lane, b, s, philox::kCells, q.key0, q.key1);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = 4 * g + j;
          if (k < NK && ((sp.todo >> k) & 1u))
            spread_cell<NK>(p, lane, k, sp, e.v[k < NK ? k : 0], philox::uniform(c.w[j]), n_ig,
                            burning);
        }
      }
    }
    if (account<NK>(p, q.max_steps, burn_totals(sp, n_ig, burning), e)) {
      fresh_board<NK>(p, q.tree_density, q.n_fires, lane,
                      LazyDraws{(unsigned)b, s, philox::kTrees, q.key0, q.key1, lane, 32},
                      LazyDraws{(unsigned)b, s, philox::kPicks, q.key0, q.key1, 0, 1}, e.v, e.xs,
                      e.ys);
    }
  }
  store_env<NK>(out, p, b, lane, e);
}

template <int NK>
cudaError_t launch_philox_steps(const MsInputs& in, const MsOutputs& out, const Params& p,
                                const MsParams& q, cudaStream_t stream) {
  constexpr int kWarps = ms_warps<NK>();
  const int blocks = (p.B + kWarps - 1) / kWarps;
  philox_steps_kernel<NK><<<blocks, kWarps * 32, 0, stream>>>(in, out, p, q);
  return cudaGetLastError();
}

// ---- the per-step auto-reset after wildfire_step ----
//
// autoreset_kernel replaces no TPU kernel: the JAX package's batch env
// encodes and resets with plain XLA ops around its step.  It was added for
// BatchedEnv.step's per-step path, where that glue ran as about 140 PyTorch
// passes over the whole batch a step (a fresh board drawn for every env,
// then kept in the 1-2% of rows that finished), forty times the step
// kernel's own device time.  Its plain version is
// ops.wildfire_slab.autoreset_spec, and the two agree bit for bit.
//
// After wildfire_step it does the rest of the step in one launch, one warp
// per env: the observation of the stepped, pre-reset board (WildfireWorld
// encode: type, colour, state, x-major, each agent written over its cell in
// agent order), the per-agent rewards (the team reward over A, a float32
// division as the plain version's), the flags, the step and put-out counts,
// and for a finished env a fresh board (fresh_board, on the reset draw's
// uniforms of that row, which no other row reads) written over the step
// kernel's own outputs in place.  What bounds it: bytes.  A step reads the
// boards (4 C bytes an env) and writes the observation (3 C bytes an env),
// plus a few words an env and, for the finished envs, their uniforms and
// fresh boards; at 16x16 and B = 65536 that is about 123 MB, 37 us at the
// card's 3.35 TB/s.  The design: lane l holds cells l + 32 k, read with
// coalesced loads; every load of an env, and a finished env's reset
// uniforms, is issued before its first store, so a warp's life is about one
// round trip to memory; the block's few envs are consecutive, so their
// observations are one contiguous span, staged in shared memory byte by
// byte (the transpose to x-major happens there) and written out in aligned
// 16-byte stores; the fresh board stays in the warp's registers until it is
// stored.  At 16x16 and B = 65536 it takes about 55 us on an H100 (the
// profiler's kernel time), two thirds of its byte bound: what is left is
// the many short warps' latency and the fresh board's registers (60
// against 47 without it), which cut the warps an SM holds; capping the
// registers spilled and ran slower, and blocks of 1, 2 or 8 envs ran no
// faster than 4.

constexpr int kAgent = 4;  // WildfireWorld's agent type, in the observation only
// Envs (warps) a block of autoreset_kernel: few, so that a block's barrier
// before the observation's stores holds few warps (measured faster than 8).
constexpr int kAutoresetEnvs = 4;

struct AutoresetIn {
  const float* reward;  // (B, 1) wildfire_step's team reward
  const int* n_ext;     // (B, 1) its fires put out
  const int* term;      // (B, 1) its "no fire left"
  const int* sc;        // (B,) the step counts before the step
  const int* ext;       // (B,) the put-out counts before the step
  const float* rnd;     // (B, C + n_fires + A) the fresh boards' uniforms
};

struct AutoresetOut {
  int* cells;          // (B, C) wildfire_step's boards, fresh ones written over the finished
  int* pos;            // (B, 2A) its positions, likewise
  unsigned char* obs;  // (B, W, H, 3), or null for no observation
  float* rewards;      // (B, A)
  int* sc;
  int* ext;
  bool* terminated;
  bool* truncated;
};

struct AutoresetParams {
  int n_fires, max_steps;
  float tree_density;
  // Observation colours of a tree, a fire, a burnt cell and each agent.
  int tree_color, fire_color, burnt_color;
  int agent_color[kMaxAgents];
};

template <int NK>
__global__ void __launch_bounds__(kAutoresetEnvs * 32)
autoreset_kernel(const AutoresetIn in, const AutoresetOut out, const Params p,
                 const AutoresetParams q) {
  constexpr int T = kAutoresetEnvs;
  // The block's observations, staged at their global byte offset minus
  // `base`, the 16-byte boundary at or below the first.
  __shared__ __align__(16) unsigned char s_obs[16 + T * 3 * 32 * NK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int C = p.w * p.h, A = p.n_agents;
  const int b0 = blockIdx.x * T, b = b0 + warp;
  const size_t env_bytes = 3 * (size_t)C;
  const size_t g0 = b0 * env_bytes, g1 = min(b0 + T, p.B) * env_bytes;
  const size_t base = g0 & ~(size_t)15;

  if (b < p.B) {  // a whole warp
    // Every load of the env comes before its first store, so that none
    // waits on a store to memory it might alias.
    const float reward = in.reward[b];
    const int sc2 = in.sc[b] + 1, ext2 = in.ext[b] + in.n_ext[b];
    const bool term = in.term[b] != 0, trunc = sc2 >= q.max_steps, done = term || trunc;
    int v[NK];
#pragma unroll
    for (int k = 0; k < NK; ++k) {
      const int c = 32 * k + lane;
      v[k] = c < C ? out.cells[(size_t)b * C + c] : kEmpty;
    }
    int xs[kMaxAgents], ys[kMaxAgents];
#pragma unroll
    for (int i = 0; i < kMaxAgents; ++i) {
      xs[i] = i < A ? out.pos[(size_t)b * 2 * A + 2 * i] : 0;
      ys[i] = i < A ? out.pos[(size_t)b * 2 * A + 2 * i + 1] : 0;
    }
    // A finished row's reset uniforms, requested before the observation is
    // staged so that their latency overlaps it: lane l's tree uniforms of
    // cells l + 32 k, and pick j (the fires', then the agents') in lane j.
    const float* u = in.rnd + (size_t)b * (C + q.n_fires + A);
    float u_tree[NK], u_pick = 0.f;
    if (done) {  // warp-uniform
#pragma unroll
      for (int k = 0; k < NK; ++k) u_tree[k] = 32 * k + lane < C ? u[32 * k + lane] : 1.f;
      if (lane < q.n_fires + A) u_pick = u[C + lane];
    }
    if (out.obs) {
      unsigned char* s = s_obs + (g0 - base) + warp * env_bytes;
      // Cell c = 32 k + lane is (x, y) = (c % w, c / w), stepped 32 cells
      // a word, so that the divisions are made once.
      const int step_y = 32 / p.w, step_x = 32 % p.w;
      int x = lane % p.w, y = lane / p.w;
#pragma unroll
      for (int k = 0; k < NK; ++k, x += step_x, y += step_y) {
        if (x >= p.w) {
          x -= p.w;
          ++y;
        }
        if (32 * k + lane < C) {
          unsigned char* o = s + 3 * (x * p.h + y);
          const int t = v[k];
          o[0] = (unsigned char)t;
          o[1] = (unsigned char)(t == kTree    ? q.tree_color
                                 : t == kFire  ? q.fire_color
                                 : t == kBurnt ? q.burnt_color
                                               : 0);
          o[2] = 0;
        }
      }
      __syncwarp();
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < kMaxAgents; ++i) {
          if (i < A) {
            unsigned char* o = s + 3 * (xs[i] * p.h + ys[i]);
            o[0] = kAgent;
            o[1] = (unsigned char)q.agent_color[i];
            o[2] = 3;
          }
        }
      }
    }
    if (lane == 0) {
      out.terminated[b] = term;
      out.truncated[b] = trunc;
      out.sc[b] = done ? 0 : sc2;
      out.ext[b] = done ? 0 : ext2;
    }
    if (lane < A) out.rewards[(size_t)b * A + lane] = __fdiv_rn(reward, (float)A);
    if (done) {
      fresh_board<NK>(
          p, q.tree_density, q.n_fires, lane, [&](int k) { return u_tree[k]; },
          [&](int j) { return j < 32 ? __shfl_sync(kFull, u_pick, j) : u[C + j]; }, v, xs, ys);
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        const int c = 32 * k + lane;
        if (c < C) out.cells[(size_t)b * C + c] = v[k];
      }
      if (lane < A) {
        int x = 0, y = 0;
#pragma unroll
        for (int i = 0; i < kMaxAgents; ++i)
          if (i == lane) {
            x = xs[i];
            y = ys[i];
          }
        out.pos[(size_t)b * 2 * A + 2 * lane] = x;
        out.pos[(size_t)b * 2 * A + 2 * lane + 1] = y;
      }
    }
  }
  if (!out.obs) return;  // block-uniform
  __syncthreads();
  // The block's span [g0, g1) of the observation, in 16-byte chunks at
  // 16-byte boundaries: whole chunks by one vector store, the partial ones
  // at either end byte by byte.
  for (size_t at = base + 16 * (size_t)threadIdx.x; at < g1; at += 16 * (size_t)blockDim.x) {
    const unsigned char* s = s_obs + (at - base);
    if (at >= g0 && at + 16 <= g1) {
      *reinterpret_cast<uint4*>(out.obs + at) = *reinterpret_cast<const uint4*>(s);
    } else {
      for (int i = 0; i < 16; ++i)
        if (at + i >= g0 && at + i < g1) out.obs[at + i] = s[i];
    }
  }
}

template <int NK>
cudaError_t launch_autoreset(const AutoresetIn& in, const AutoresetOut& out, const Params& p,
                             const AutoresetParams& q, cudaStream_t stream) {
  constexpr int T = kAutoresetEnvs;
  autoreset_kernel<NK><<<(p.B + T - 1) / T, T * 32, 0, stream>>>(in, out, p, q);
  return cudaGetLastError();
}

// The words of 32 cells a lane holds for a board of C cells: the kernels'
// NK, a power of two.
int words_for(int C) {
  const int words = (C + 31) / 32;
  return words <= 1 ? 1 : words <= 2 ? 2 : words <= 4 ? 4 : words <= 8 ? 8 : words <= 16 ? 16 : 32;
}

}  // namespace
}  // namespace wildfire

// cells (B, width * height) int32, flat index y * width + x; pos (B, 2A)
// int32 [x0, y0, x1, ...]; acts (B, A) int32; rnd (B, 1 + width * height)
// float32 [move order, one per cell].  cells, rnd and cells_out must be
// 16-byte aligned (the bulk copies' rule), and `tile` must be the envs per
// tile of this board (ops.wildfire_slab.tile_envs).  Outputs: cells and pos
// of the same shapes, reward (B, 1) float32, n_ext and term (B, 1) int32.
// p_ig1..4: ignition probability by burning-neighbour count.  Launches on
// `stream` and returns the launch's cudaError_t.
extern "C" int wildfire_step(const void* cells, const void* pos, const void* acts,
                             const void* rnd, void* cells_out, void* pos_out,
                             void* reward, void* n_ext, void* term, int B,
                             int width, int height, int n_agents, int tile,
                             float p_ig1, float p_ig2, float p_ig3, float p_ig4,
                             float p_burnout, float ext_reward,
                             float burn_penalty, float step_penalty,
                             void* stream) {
  using namespace wildfire;
  const int C = width * height;
  if (B < 1 || n_agents < 1 || n_agents > kMaxAgents || width < 1 || height < 1 ||
      C > kMaxCells)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)cells | (uintptr_t)rnd | (uintptr_t)cells_out) & 15u)
    return (int)cudaErrorMisalignedAddress;
  const Params p{B, width, height, n_agents, p_ig1, p_ig2, p_ig3, p_ig4,
                 p_burnout, ext_reward, burn_penalty, step_penalty};
  const void* in[] = {cells, pos, acts, rnd};
  const Outputs out{(int*)pos_out, (float*)reward, (int*)n_ext, (int*)term};
  const int nk = words_for(C);
  const int want_tile = nk > 16 ? tile_envs<32>() : tile_envs<16>();
  if (tile != want_tile) return (int)cudaErrorInvalidValue;
  auto run = nk == 1    ? launch<1>
             : nk == 2  ? launch<2>
             : nk == 4  ? launch<4>
             : nk == 8  ? launch<8>
             : nk == 16 ? launch<16>
                        : launch<32>;
  return (int)run(in, (int*)cells_out, out, p, (cudaStream_t)stream);
}

// K steps with the auto-reset and the draws made in the kernel
// (ops.wildfire_slab.wf_philox_slab; plain version ms_philox_spec), from
// step step0 of the rollout keyed by (key0, key1), the uint32 words of
// ops.philox passed as int.  cells (B, width * height), pos (B, 2A), sc and
// ext (B,) int32, run_ret (B,) float32.  Outputs: cells, pos, sc, ext and
// run_ret of the same shapes, rew_sum and ep_sum (B,) float32, eps (B,)
// int32.  p_ig1..4 as for wildfire_step; tree_density the fresh board's
// threshold.  Launches on `stream` and returns the launch's cudaError_t.
extern "C" int wf_steps_philox(const void* cells, const void* pos, const void* sc,
                               const void* ext, const void* run_ret, void* cells_out,
                               void* pos_out, void* sc_out, void* ext_out, void* run_out,
                               void* rew_sum, void* ep_sum, void* eps, int B, int K, int width,
                               int height, int n_agents, int n_fires, int max_steps, int key0,
                               int key1, int step0, float p_ig1, float p_ig2, float p_ig3,
                               float p_ig4, float p_burnout, float ext_reward,
                               float burn_penalty, float step_penalty, float tree_density,
                               void* stream) {
  using namespace wildfire;
  const int C = width * height;
  if (B < 1 || K < 1 || n_agents < 1 || n_agents > kMaxAgents || width < 1 || height < 1 ||
      C > kMaxCells || n_fires < 0)
    return (int)cudaErrorInvalidValue;
  const Params p{B, width, height, n_agents, p_ig1, p_ig2, p_ig3, p_ig4,
                 p_burnout, ext_reward, burn_penalty, step_penalty};
  const MsParams q{K, n_fires, max_steps, tree_density,
                   (unsigned)key0, (unsigned)key1, (unsigned)step0};
  const MsInputs in{(const int*)cells, (const int*)pos, (const int*)sc, (const int*)ext,
                    (const float*)run_ret};
  const MsOutputs out{(int*)cells_out, (int*)pos_out, (int*)sc_out, (int*)ext_out,
                      (float*)run_out, (float*)rew_sum, (float*)ep_sum, (int*)eps};
  const int nk = words_for(C);
  auto run = nk == 1    ? launch_philox_steps<1>
             : nk == 2  ? launch_philox_steps<2>
             : nk == 4  ? launch_philox_steps<4>
             : nk == 8  ? launch_philox_steps<8>
             : nk == 16 ? launch_philox_steps<16>
                        : launch_philox_steps<32>;
  return (int)run(in, out, p, q, (cudaStream_t)stream);
}

// The rest of BatchedEnv.step after wildfire_step, with the auto-reset
// (ops.wildfire_slab.wf_autoreset_slab; plain version autoreset_spec).
// cells (B, width * height) and pos (B, 2A) int32, reward (B, 1) float32,
// n_ext and term (B, 1) int32: wildfire_step's outputs, of which cells and
// pos are rewritten in place with the fresh boards of the finished envs.
// sc and ext (B,) int32: the counts before the step.  rnd_reset (B, width *
// height + n_fires + A) float32: the reset draw, read in the finished rows
// only.  Outputs: obs (B, width, height, 3) uint8, 16-byte aligned, or null
// for none; rewards (B, A) float32; sc_out and ext_out (B,) int32;
// terminated and truncated (B,) bool.  The colours are the observation's;
// agent_color0..3 those of the agents (the unused ones any value).
// Launches on `stream` and returns the launch's cudaError_t.
extern "C" int wf_autoreset(void* cells, void* pos, const void* reward, const void* n_ext,
                            const void* term, const void* sc, const void* ext,
                            const void* rnd_reset, void* obs, void* rewards, void* sc_out,
                            void* ext_out, void* terminated, void* truncated, int B, int width,
                            int height, int n_agents, int n_fires, int max_steps, int tree_color,
                            int fire_color, int burnt_color, int agent_color0, int agent_color1,
                            int agent_color2, int agent_color3, float tree_density,
                            void* stream) {
  using namespace wildfire;
  const int C = width * height;
  if (B < 1 || n_agents < 1 || n_agents > kMaxAgents || width < 1 || height < 1 ||
      C > kMaxCells || n_fires < 0)
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)obs & 15u) return (int)cudaErrorMisalignedAddress;
  const Params p{B, width, height, n_agents, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const AutoresetParams q{n_fires,     max_steps,   tree_density,
                          tree_color,  fire_color,  burnt_color,
                          {agent_color0, agent_color1, agent_color2, agent_color3}};
  const AutoresetIn in{(const float*)reward, (const int*)n_ext, (const int*)term,
                       (const int*)sc,       (const int*)ext,   (const float*)rnd_reset};
  const AutoresetOut out{(int*)cells,   (int*)pos,     (unsigned char*)obs, (float*)rewards,
                         (int*)sc_out,  (int*)ext_out, (bool*)terminated,   (bool*)truncated};
  const int nk = words_for(C);
  auto run = nk == 1    ? launch_autoreset<1>
             : nk == 2  ? launch_autoreset<2>
             : nk == 4  ? launch_autoreset<4>
             : nk == 8  ? launch_autoreset<8>
             : nk == 16 ? launch_autoreset<16>
                        : launch_autoreset<32>;
  return (int)run(in, out, p, q, (cudaStream_t)stream);
}
