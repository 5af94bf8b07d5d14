"""Block-int8 codec with error feedback: CUDA kernels, plain versions, wrappers."""
