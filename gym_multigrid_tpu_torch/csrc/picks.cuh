// Picks without replacement of a few cells, for the in-kernel resets of
// csrc/ctf_step.cu (spawns over a territory) and csrc/wildfire_step.cu (the
// agents over the board): the same cells as ops.sampling.PickState gives
// for the same uniforms.

#pragma once

namespace picks {

// min(floor(u * n), n - 1) with the product rounded as float32, as the
// plain versions form it.
__device__ __forceinline__ int floor_pick(float u, int n) {
  return min(__float2int_rz(__fmul_rn(u, (float)n)), n - 1);
}

// Pick j (0-based) of a draw without replacement from cells 0..n-1: the
// r-th cell not taken yet, r = floor_pick(u, n - j), or cell 0 once all n
// are taken (PickState picks nothing then, and its cell index is 0).  The
// r-th free cell is r moved up by one for each taken cell at or below it,
// the taken cells visited in ascending order.  taken[0..j) holds the cells
// taken so far, ascending, and the pick is inserted.  Called in a loop over
// j that unrolls, j is a constant and `taken` stays in registers.
template <int N>
__device__ __forceinline__ int pick_untaken(float u, int n, int j, int (&taken)[N]) {
  // As selects, with no branch on n - j.
  const bool left = n - j > 0;
  int x = left ? floor_pick(u, n - j) : 0;
#pragma unroll
  for (int q = 0; q < N; ++q)
    if (q < j) x += left && taken[q] <= x;
  const int cell = x;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    if (q < j && taken[q] > x) {
      const int t = taken[q];
      taken[q] = x;
      x = t;
    }
  }
  taken[j] = x;
  return cell;
}

}  // namespace picks
