// IPLS partition aggregation for Hopper (sm_90a), hand-written CUDA C++.
//
// Two kernels. The first replaces the Pallas TPU kernel ipls_aggregate_batched
// (src/repro/kernels/ipls_aggregate/ipls_aggregate.py:150, body
// _kernel_batched). For every partition instance k and lane n:
//
//   acc = 0;  for r = 0..R-1 in slot order:  acc = acc + mask[k,r] * d[k,r,n]
//   out[k,n] = fma(-eps[k], acc, w[k,n])              (one rounding)
//
// The contract is bitwise: the scalar oracle sums the pending deltas in
// slot order and applies w - eps*acc with a single rounding. So every add
// and multiply of the sum is an explicit round-to-nearest intrinsic that the
// compiler may not contract into an FMA, and the update is one __fmaf_rn.
// An all-zero mask row gives acc = +0 and passes w through unchanged.
//
// Bound: bytes. The kernel reads K*R*S + K*S floats (deltas and w) and
// writes K*S, two flops per delta element. At the main path's shape
// (K=20, R=51, S=44361) that is about 188 MB, about 56 us at 3.35 TB/s;
// the flops (about 90 MFLOP) would take about 1.4 us at 67 TFLOP/s.
//
// Design: the TPU kernel padded R to 8-slot chunks and N to 128x128 tiles
// and carried the running sum across sequential grid steps. Here blocks run
// in parallel in no order, so the whole r loop stays in one thread's
// registers: one thread per output element, a grid of (ceil(S/256), K), and
// the ragged tail masked by the bounds check instead of padding. Neighbour
// threads read neighbour addresses of each delta row, so every load of the
// r loop is coalesced; the loop is unrolled so several independent loads
// are in flight per thread. No split over R and no atomics: either would
// change the association of the sum.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ipls_aggregate_batched_kernel(float* __restrict__ out,
                              const float* __restrict__ w,
                              const float* __restrict__ deltas,
                              const float* __restrict__ mask,
                              const float* __restrict__ eps,
                              int R, int S) {
  const int k = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= S) return;
  const int64_t row = static_cast<int64_t>(k) * S + n;
  const float* d = deltas + static_cast<int64_t>(k) * R * S + n;
  const float* m = mask + static_cast<int64_t>(k) * R;
  float acc = 0.0f;
#pragma unroll 8
  for (int r = 0; r < R; ++r) {
    acc = __fadd_rn(acc, __fmul_rn(__ldg(m + r), __ldg(d + static_cast<int64_t>(r) * S)));
  }
  out[row] = __fmaf_rn(-__ldg(eps + k), acc, __ldg(w + row));
}

// The second replaces ipls_aggregate_batched_q (ipls_aggregate.py:245, body
// _kernel_batched_q): the same update over remote contributors that arrive as
// int8 codes with one power-of-two float32 scale per 1024 lanes, dequantized in
// the loop, plus the holder's own raw float32 delta, gated by own_mask and
// summed FIRST (the scalar oracle pushes the local delta before it drains the
// inbox):
//
//   acc = own_mask[k] * own[k,n]
//   for r in slot order:  acc = acc + mask[k,r] * (float(q[k,r,n]) * scale[k,r,n/1024])
//   out[k,n] = fma(-eps[k], acc, w[k,n])
//
// Each product and add is an explicit round-to-nearest intrinsic, as above.
// Masked slots are not skipped: adding a masked zero can turn a -0 sum into
// +0, and the contract with the plain version is bitwise.
//
// Bound: bytes. Per output element it reads R codes (1 B) and R scales (cached:
// one per 1024 lanes, 4R/1024 B), w and own, and writes out. At the main int8
// path's shape (K=20, R=198, S=45056) that is about 190 MB, about 57 us at
// 3.35 TB/s. Same design as the first kernel; the codes are read one byte a
// thread (32 B a warp per slot), which vectorising would widen.
constexpr int kQBlock = 1024;

__global__ void __launch_bounds__(kThreads)
ipls_aggregate_batched_q_kernel(float* __restrict__ out,
                                const float* __restrict__ w,
                                const float* __restrict__ own,
                                const int8_t* __restrict__ q,
                                const float* __restrict__ scales,
                                const float* __restrict__ mask,
                                const float* __restrict__ own_mask,
                                const float* __restrict__ eps,
                                int R, int S, int NB) {
  const int k = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= S) return;
  const int64_t row = static_cast<int64_t>(k) * S + n;
  const int8_t* qk = q + static_cast<int64_t>(k) * R * S + n;
  const float* sk = scales + static_cast<int64_t>(k) * R * NB + n / kQBlock;
  const float* m = mask + static_cast<int64_t>(k) * R;
  float acc = __fmul_rn(__ldg(own_mask + k), __ldg(own + row));
#pragma unroll 8
  for (int r = 0; r < R; ++r) {
    const float d = __fmul_rn(static_cast<float>(__ldg(qk + static_cast<int64_t>(r) * S)),
                              __ldg(sk + static_cast<int64_t>(r) * NB));
    acc = __fadd_rn(acc, __fmul_rn(__ldg(m + r), d));
  }
  out[row] = __fmaf_rn(-__ldg(eps + k), acc, __ldg(w + row));
}

}  // namespace

// Plain C entry point, loaded with ctypes. All pointers are device pointers
// to contiguous float32 arrays: out, w (K,S); deltas (K,R,S); mask (K,R);
// eps (K,). The launch goes on `stream` and does not synchronise. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int ipls_aggregate_batched_f32(float* out, const float* w, const float* deltas,
                                          const float* mask, const float* eps, int K, int R,
                                          int S, cudaStream_t stream) {
  const dim3 grid((S + kThreads - 1) / kThreads, K);
  ipls_aggregate_batched_kernel<<<grid, kThreads, 0, stream>>>(out, w, deltas, mask, eps, R, S);
  return static_cast<int>(cudaGetLastError());
}

// Quantized variant: out, w, own (K,S) float32; q (K,R,S) int8; scales
// (K,R,NB) float32 with NB = ceil(S/1024); mask (K,R); own_mask, eps (K,).
extern "C" int ipls_aggregate_batched_q_f32(float* out, const float* w, const float* own,
                                            const int8_t* q, const float* scales,
                                            const float* mask, const float* own_mask,
                                            const float* eps, int K, int R, int S, int NB,
                                            cudaStream_t stream) {
  const dim3 grid((S + kThreads - 1) / kThreads, K);
  ipls_aggregate_batched_q_kernel<<<grid, kThreads, 0, stream>>>(out, w, own, q, scales, mask,
                                                                 own_mask, eps, R, S, NB);
  return static_cast<int>(cudaGetLastError());
}
