// Suppression fixture (CUDA C++): each violation carries a reasoned noqa,
// on its line or on comment lines above it; the file must analyze clean.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) one_kernel(float* out) { out[threadIdx.x] = 1.0f; }

}  // namespace

extern "C" int one(float* out, cudaStream_t stream) {
  // repro: noqa[CU02] fixture: demonstrates preceding-comment suppression
  one_kernel<<<1, 2 * kThreads, 0, stream>>>(out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int two(float* out, cudaStream_t stream) {
  one_kernel<<<1, kThreads, 0, stream>>>(out);  // repro: noqa[CU04] fixture: same-line
  return 0;
}
