// CU02 fire: a block of 256 threads for a kernel whose __launch_bounds__
// allow 128, and a 32 x 64 block (2,048 threads) for one with no bounds.
#include <cuda_runtime.h>

namespace {

constexpr int kBound = 128;
constexpr int kBlock = 2 * kBound;

__global__ void __launch_bounds__(kBound) narrow_kernel(float* out) {
  out[threadIdx.x] = 0.0f;
}

__global__ void wide_kernel(float* out) { out[threadIdx.y * 32 + threadIdx.x] = 1.0f; }

}  // namespace

extern "C" int narrow(float* out, cudaStream_t stream) {
  narrow_kernel<<<1, kBlock, 0, stream>>>(out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int wide(float* out, cudaStream_t stream) {
  wide_kernel<<<1, dim3(32, 64), 0, stream>>>(out);
  return static_cast<int>(cudaGetLastError());
}
