// Block-int8 codec with error feedback for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernels quantize (src/repro/kernels/quantize/quantize.py:62,
// body _kernel) and dequantize (quantize.py:107, body _dq_kernel). Per block of
// 1024 values:
//
//   v = x + err;  m = max |v|;  E = biased exponent of m
//   scale = 2^(E-133), inv = 2^(133-E) from the exponent bits (0 and 0 if E <= 6)
//   code = clip(rint(v * inv), -127, 127);  new_err = v - code * scale
//
// and dequantize is code * scale. The contract is bitwise against the plain
// versions (ref.py) and the reference's numpy wire codec: with power-of-two
// scales every operation but v = x + err is exact, and each one is written as an
// explicit round-to-nearest intrinsic so nvcc cannot contract or reorder it.
// rintf rounds half to even, as jnp.round and torch.round do.
//
// Bound: bytes. quantize reads x and err (8 B a value) and writes the code, the
// residual and a scale per block (5 B a value); dequantize reads 1 B and writes
// 4 B a value. A handful of operations per value is far below the card's rate.
//
// Design: the TPU kernel walked (8, 1024) tiles over a sequential grid. Here one
// CUDA block of 256 threads owns one 1024-value quantization block, 4 values a
// thread at a stride of 256, so every load and store of a warp is coalesced. The
// block's absmax is a warp-shuffle reduction, then one value per warp through
// shared memory; thread 0 derives the scale pair and broadcasts it. The ragged
// tail of a payload with N % 1024 != 0 reads as zeros and is not written.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 1024;               // values per quantization block
constexpr int kThreads = 256;              // threads per CUDA block
constexpr int kPerThread = kBlock / kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kEmin = 6;                   // biased exponents <= this: zero block

__global__ void __launch_bounds__(kThreads)
quantize_kernel(int8_t* __restrict__ q, float* __restrict__ scales,
                float* __restrict__ new_err, const float* __restrict__ x,
                const float* __restrict__ err, int64_t n) {
  __shared__ float warp_max[kWarps];
  __shared__ float scale_pair[2];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  float v[kPerThread];
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t i = base + j * kThreads;
    v[j] = i < n ? __fadd_rn(__ldg(x + i), __ldg(err + i)) : 0.0f;
    amax = fmaxf(amax, fabsf(v[j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, warp_max[w]);
    const int e0 = __float_as_int(m) >> 23;  // m >= 0: the sign bit is clear
    const int e0c = max(e0, kEmin + 1);
    const bool zero = e0 <= kEmin;
    scale_pair[0] = zero ? 0.0f : __int_as_float((e0c - kEmin) << 23);
    scale_pair[1] = zero ? 0.0f : __int_as_float(((127 + 133) - e0c) << 23);
    scales[blockIdx.x] = scale_pair[0];
  }
  __syncthreads();
  const float scale = scale_pair[0];
  const float inv = scale_pair[1];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t i = base + j * kThreads;
    if (i < n) {
      const float c = fminf(fmaxf(rintf(__fmul_rn(v[j], inv)), -127.0f), 127.0f);
      const int8_t code = static_cast<int8_t>(c);
      q[i] = code;
      new_err[i] = __fsub_rn(v[j], __fmul_rn(static_cast<float>(code), scale));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dequantize_kernel(float* __restrict__ out, const int8_t* __restrict__ q,
                  const float* __restrict__ scales, int64_t n) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  const float scale = __ldg(scales + blockIdx.x);
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t i = base + j * kThreads;
    if (i < n) out[i] = __fmul_rn(static_cast<float>(__ldg(q + i)), scale);
  }
}

unsigned int grid_of(int64_t n) { return static_cast<unsigned int>((n + kBlock - 1) / kBlock); }

}  // namespace

// Plain C entry points, loaded with ctypes. All pointers are device pointers to
// contiguous arrays: q (n,) int8; scales (ceil(n/1024),) float32; x, err,
// new_err, out (n,) float32; n >= 1. Each launch goes on `stream` and does not
// synchronise. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int quantize_f32_int8(int8_t* q, float* scales, float* new_err, const float* x,
                                 const float* err, int64_t n, cudaStream_t stream) {
  quantize_kernel<<<grid_of(n), kThreads, 0, stream>>>(q, scales, new_err, x, err, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dequantize_int8_f32(float* out, const int8_t* q, const float* scales, int64_t n,
                                   cudaStream_t stream) {
  dequantize_kernel<<<grid_of(n), kThreads, 0, stream>>>(out, q, scales, n);
  return static_cast<int>(cudaGetLastError());
}
