// Warp-level helpers shared by the Collect kernels.
//
// A warp owns one env's board.  Lane l holds cells l, l + 32, l + 64, ...
// of each (C,) plane in registers, NK words of 32 cells for C <= 32 * NK,
// so a row is loaded and stored as runs of consecutive words.
#pragma once

#include <cuda_runtime.h>

#include "select.cuh"

namespace collect {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxCells = 256;  // NK = 8 words per lane; ops.collect_slab.MAX_CELLS

// CollectWorld object ids and the wall color id (grey), as in
// gym_multigrid_tpu_torch/core/world.py and core/constants.py.  The action
// ids of north, east, south and west (rows of COLLECT_ACTION_TO_VEC); other
// ids are a no-op.  tests/test_torch_tables.py holds these to the Python
// tables.
constexpr int kEmpty = 0, kWall = 1, kBall = 2, kAgent = 3, kWallColor = 7;
constexpr int kNorth = 0, kEast = 1, kSouth = 2, kWest = 3;
// A lane's slots past the last cell hold this value (as a packed cell of
// collect_step.cu, object byte 255): never empty, never a ball, so no mask
// selects them.
constexpr int kOffBoard = -1;

using regsel::select_eq;

// Value of cell idx (0 <= idx < C) of a plane held across the warp.
template <int NK>
__device__ __forceinline__ int warp_gather(const int (&v)[NK], int idx) {
  const int w = idx >> 5;
  int mine = v[0];
#pragma unroll
  for (int k = 1; k < NK; ++k) mine = select_eq(w, k, v[k], mine);
  return __shfl_sync(kFull, mine, idx & 31);
}

// Uniform pick among the set cells of a mask held across the warp: the
// r-th set cell in cell order (counting from 0), with
// r = min(floor(u * count), count - 1) and the float32 product rounded and
// truncated as the plain version does.  One ballot per word gives every
// lane the count of set cells before each of its own, so no prefix-sum
// plane is formed.  Returns this lane's hit bits: bit k is set when cell
// 32k + lane is the pick.  An empty mask picks nothing.
template <int NK>
__device__ __forceinline__ unsigned warp_pick(const bool (&m)[NK], float u,
                                              int lane) {
  unsigned words[NK];
  int count = 0;
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    words[k] = __ballot_sync(kFull, m[k]);
    count += __popc(words[k]);
  }
  const int r = min(__float2int_rz(__fmul_rn(u, (float)count)), count - 1);
  const unsigned below = (1u << lane) - 1u;  // the lanes under this one
  unsigned hits = 0;
  int before = 0;  // set cells in the words before word k
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    if (m[k] && before + __popc(words[k] & below) == r) hits |= 1u << k;
    before += __popc(words[k]);
  }
  return hits;
}

}  // namespace collect
