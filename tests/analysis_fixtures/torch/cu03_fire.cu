// CU03 fire: 64 KiB of dynamic shared memory with no opt-in, and a kernel
// whose opted-in dynamic bytes plus its static array pass the 227 KiB a
// block may hold.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRing = 64 * 1024;
constexpr int kHuge = 200 * 1024;

__global__ void __launch_bounds__(kThreads) ring_kernel(float* out) {
  extern __shared__ float ring[];
  ring[threadIdx.x] = 0.0f;
  out[threadIdx.x] = ring[threadIdx.x];
}

__global__ void __launch_bounds__(kThreads) huge_kernel(float* out) {
  extern __shared__ float dyn[];
  __shared__ float table[10 * 1024];  // 40 KiB static
  table[threadIdx.x] = 1.0f;
  dyn[threadIdx.x] = table[threadIdx.x];
  out[threadIdx.x] = dyn[threadIdx.x];
}

}  // namespace

extern "C" int ring(float* out, cudaStream_t stream) {
  ring_kernel<<<1, kThreads, kRing, stream>>>(out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int huge(float* out, cudaStream_t stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(huge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kHuge);
  if (err != cudaSuccess) return static_cast<int>(err);
  huge_kernel<<<1, kThreads, kHuge, stream>>>(out);
  return static_cast<int>(cudaGetLastError());
}
