// The move orders of up to 4 agents, for csrc/ctf_step.cu and
// csrc/wildfire_step.cu: permutation j of range(A) in lexicographic order
// (itertools.permutations, the order the plain versions' tables hold),
// packed 4 bits a slot, the agent that moves in slot s at bits 4s..4s+3.
// Permutation j of A agents is kMoveOrders[move_order_base(A) + j].  Each
// kernel copies the table into shared memory once per block, and a lookup
// replaces the digit-by-digit decode of j and its integer divisions.  A CPU
// test checks the table against itertools.permutations.

#pragma once

namespace move_order {

constexpr int kNumOrders = 33;  // 1! + 2! + 3! + 4!

// Where the permutations of A agents start: 1! + ... + (A - 1)!.
__host__ __device__ constexpr int move_order_base(int A) {
  return A == 4 ? 9 : (A == 3 ? 3 : (A == 2 ? 1 : 0));
}

// A!: the number of move orders of A agents.
__host__ __device__ constexpr int num_orders(int A) {
  return A == 4 ? 24 : (A == 3 ? 6 : (A == 2 ? 2 : 1));
}

__device__ const unsigned kMoveOrders[kNumOrders] = {
    0x0000, 0x0010, 0x0001, 0x0210, 0x0120, 0x0201, 0x0021, 0x0102,
    0x0012, 0x3210, 0x2310, 0x3120, 0x1320, 0x2130, 0x1230, 0x3201,
    0x2301, 0x3021, 0x0321, 0x2031, 0x0231, 0x3102, 0x1302, 0x3012,
    0x0312, 0x1032, 0x0132, 0x2103, 0x1203, 0x2013, 0x0213, 0x1023,
    0x0123,
};

}  // namespace move_order
