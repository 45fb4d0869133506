"""Operators over Batches: keys, group-by, sort, and the CUDA kernels."""
