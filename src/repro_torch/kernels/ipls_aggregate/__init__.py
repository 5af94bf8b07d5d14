"""Batched IPLS partition aggregation: CUDA kernel, plain version, wrappers."""
