"""Attention cores and the CUDA kernel wrappers of the port."""
