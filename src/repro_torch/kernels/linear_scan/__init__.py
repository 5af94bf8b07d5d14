"""RWKV6 linear recurrence: CUDA kernel, plain versions, wrapper."""
