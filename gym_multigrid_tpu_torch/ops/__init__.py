"""Slab math of the port: plain PyTorch versions and their CUDA kernels."""
