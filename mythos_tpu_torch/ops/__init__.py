"""Kernels of the port (CUDA sources in csrc/) and their plain twins."""
