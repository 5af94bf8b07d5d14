// No-fire twin of the cuda pack (and the source wrappers_ok.py and
// cu01_fire.py bind): block sizes at their __launch_bounds__, dynamic shared
// memory above 48 KiB opted in through an alias of the kernel, every
// launch's error returned.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowBytes = 4 * 1024;
constexpr int kSmemBytes = 16 * kRowBytes + 128;  // 65,664 bytes: above 48 KiB

__global__ void __launch_bounds__(kThreads)
scale_kernel(float* __restrict__ out, const float* __restrict__ x, int cols) {
  extern __shared__ float row[];
  __shared__ float partial[kThreads / 32];
  const int c = threadIdx.x;
  row[c] = c < cols ? x[blockIdx.x * cols + c] : 0.0f;
  if (c < kThreads / 32) partial[c] = 0.0f;
  __syncthreads();
  if (c < cols) out[blockIdx.x * cols + c] = 2.0f * row[c] + partial[c & 7];
}

template <int L>
__global__ void __launch_bounds__(kThreads, 2)
copy_kernel(float* __restrict__ out, const float* __restrict__ x, int n) {
  const int i = (blockIdx.x * kThreads + threadIdx.x) * L;
  for (int l = 0; l < L; ++l)
    if (i + l < n) out[i + l] = x[i + l];
}

}  // namespace

extern "C" int scale_rows(float* out, const float* x, int rows, int cols, cudaStream_t stream) {
  auto kernel = scale_kernel;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<rows, kThreads, kSmemBytes, stream>>>(out, x, cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int copy_rows(float* out, const float* x, int64_t n, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>((n + 1023) / 1024));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, copy_kernel<4>, out, x, static_cast<int>(n));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cuda_ok_smem_bytes() { return kSmemBytes; }
