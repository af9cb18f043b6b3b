"""Published peaks of one NVIDIA H100 SXM (80 GB HBM3), at its full power
limit of 700 W; every run prints the card's name and power limit before
its result, since a card set below 700 W runs slower under load.

Sources: NVIDIA H100 Tensor Core GPU data sheet (dense rates, without
sparsity) and the NVIDIA H100 (Hopper) architecture white paper (132 SMs
on the SXM part, 1.98 GHz boost clock, 64 INT32 lanes an SM)."""

#: HBM3 bandwidth, bytes/s.
MEM_BYTES_PER_S = 3.35e12
#: int32 operations on the CUDA cores: 132 SMs x 64 lanes x 1.98 GHz.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: Dense bf16 tensor-core FLOP/s.
BF16_DENSE_FLOPS = 989e12
