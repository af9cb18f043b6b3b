// A compare-and-select that the compiler keeps as one, for kernels that pick
// one entry of a register array by a runtime index (csrc/collect_warp.cuh,
// csrc/ctf_step.cu).

#pragma once

namespace regsel {

// a == b ? x : y, as one compare and one select.  Written in PTX so that
// the compiler cannot fold a chain of them over a register array into a
// dynamic index of the array, which it lowers into a branch per word.
__device__ __forceinline__ int select_eq(int a, int b, int x, int y) {
  int r;
  asm("{\n\t.reg .pred p;\n\tsetp.eq.s32 p, %1, %2;\n\tselp.b32 %0, %3, %4, p;\n\t}"
      : "=r"(r)
      : "r"(a), "r"(b), "r"(x), "r"(y));
  return r;
}

}  // namespace regsel
