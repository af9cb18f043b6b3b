// Philox4x32-10 (Salmon et al., SC 2011; the Random123 library) for the
// in-kernel draws of csrc/wildfire_step.cu's wf_steps_philox,
// csrc/collect_steps.cu's collect_steps_philox and csrc/maze_step.cu's
// maze_steps_philox.  The plain
// version, and the layout of the counters, is
// gym_multigrid_tpu_torch/ops/philox.py; the two form the same words from
// the same counters.  A CPU test checks these constants against that
// module's.

#pragma once

namespace philox {

constexpr unsigned kM0 = 0xD2511F53u, kM1 = 0xCD9E8D57u;
constexpr unsigned kW0 = 0x9E3779B9u, kW1 = 0xBB67AE85u;
constexpr int kRounds = 10;
// Streams, the counter's last word (ops.philox).
constexpr unsigned kActions = 0, kOrder = 1, kCells = 2, kTrees = 3, kPicks = 4;
// The Collect streams, after Wildfire's seven.
constexpr unsigned kCollectActions = 7, kCollectRnd = 8, kCollectFresh = 9, kCollectFirst = 10;
// The Maze streams, after Collect's four.
constexpr unsigned kMaze = 11, kMazeFirst = 12;

struct Words {
  unsigned w[4];
};

// The four output words for counter (c0, c1, c2, c3) and key (k0, k1).
__device__ __forceinline__ Words philox(unsigned c0, unsigned c1, unsigned c2, unsigned c3,
                                        unsigned k0, unsigned k1) {
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    if (r) {
      k0 += kW0;
      k1 += kW1;
    }
    const unsigned hi0 = __umulhi(kM0, c0), lo0 = kM0 * c0;
    const unsigned hi1 = __umulhi(kM1, c2), lo1 = kM1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return Words{{c0, c1, c2, c3}};
}

// (x >> 8) * 2^-24, exact in float32.
__device__ __forceinline__ float uniform(unsigned x) {
  return __fmul_rn(__uint2float_rz(x >> 8), 0x1p-24f);
}

// A Wildfire or Maze action id in 0..4: (x * 5) >> 32.
__device__ __forceinline__ int action(unsigned x) { return (int)__umulhi(x, 5u); }

// A Collect action id in 0..3: (x * 4) >> 32.
__device__ __forceinline__ int collect_action(unsigned x) { return (int)(x >> 30); }

}  // namespace philox
