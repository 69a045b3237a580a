"""Tensor operations of the codec and its CUDA kernel wrappers."""
