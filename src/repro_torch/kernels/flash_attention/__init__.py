"""Causal (or full) flash attention: CUDA kernel, plain version, wrapper."""
