"""Flash-decode over a KV cache: CUDA kernels, plain version, wrapper."""
