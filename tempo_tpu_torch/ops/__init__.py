"""Tensor ops of the port: plain PyTorch, and wrappers of the CUDA kernels."""
