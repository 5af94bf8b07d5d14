// CU04 fire: a launch whose function returns 0 whatever happened, and a
// cudaLaunchKernelEx whose result is dropped.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) fill_kernel(float* out) { out[threadIdx.x] = 1.0f; }

}  // namespace

extern "C" int fill(float* out, cudaStream_t stream) {
  fill_kernel<<<1, kThreads, 0, stream>>>(out);
  return 0;
}

extern "C" int fill_ex(float* out, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchKernelEx(&cfg, fill_kernel, out);
  return 0;
}
