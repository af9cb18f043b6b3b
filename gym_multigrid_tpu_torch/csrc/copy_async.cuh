// 4-byte asynchronous copies from global to shared memory (cp.async), for
// the K-step kernels of csrc/ctf_step.cu and csrc/maze_step.cu, which
// stream each step's draws into a ring in shared memory ahead of the step
// that reads them, and csrc/collect_steps.cu, which stages its block's
// boards with them.  A 4-byte copy takes any
// 4-byte aligned address, so rows of any length and batches of any size
// can be streamed (16-byte copies would need 16-byte aligned rows).

#pragma once

namespace copy_async {

// One 4-byte copy; it completes with the thread's current copy group.
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// Closes the thread's current copy group (an empty one too).
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Waits until at most N of the thread's copy groups are still in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace copy_async
