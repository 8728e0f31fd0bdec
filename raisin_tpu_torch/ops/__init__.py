"""Tensor ops and the wrappers of the port's CUDA kernels."""
