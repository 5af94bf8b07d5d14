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
// 3.35 TB/s.
//
// Design: wide loads. A thread owns L adjacent lanes (L = 8, 4 where S is not a
// multiple of 8, or 1 where S is odd) and keeps one accumulator per lane, so
// each lane still sums in slot order and the result is the one-lane kernel's
// bit for bit. Per slot it reads its L codes with one L-byte load (a warp: 32*L
// contiguous bytes, 256 at L = 8, against 32 with one byte a thread) and one
// scale, which its lanes share (L divides 1024); w, own and out go as float4.
// The slots go in groups of 8 whose loads are all issued before the first is
// used, so a thread has 8 code loads in flight, 64 bytes at L = 8. (L = 16,
// timed by aggregate_variants.py, was slower: half the threads, half the loads
// in flight.) A code becomes a float without a conversion instruction
// (I2F issues at a quarter of the FMA rate on this card): its byte, offset by
// 128, is the low byte of the float 2^23 + (c + 128), and one exact subtract
// of 2^23 + 128 leaves c. L must divide S (so every code row is L-aligned and
// no thread straddles the end): the wrapper picks the widest L that does, and
// a ragged S such as 70001 runs at L = 1. No padding, no copies.
constexpr int kQBlock = 1024;
constexpr int kQThreads = 128;
constexpr int kQGroup = 8;  // slots whose code loads a thread issues together

template <int L>
struct Codes;  // L int8 codes, loaded with one L-byte load
template <>
struct Codes<8> {
  uint2 v;
  __device__ __forceinline__ void load(const int8_t* p) { v = __ldg(reinterpret_cast<const uint2*>(p)); }
  __device__ __forceinline__ uint32_t word(int i) const { return i == 0 ? v.x : v.y; }
};
template <>
struct Codes<4> {
  uint32_t v;
  __device__ __forceinline__ void load(const int8_t* p) { v = __ldg(reinterpret_cast<const unsigned int*>(p)); }
  __device__ __forceinline__ uint32_t word(int) const { return v; }
};
template <>
struct Codes<1> {
  uint32_t v;
  __device__ __forceinline__ void load(const int8_t* p) { v = static_cast<uint8_t>(__ldg(p)); }
  __device__ __forceinline__ uint32_t word(int) const { return v; }
};

// float(c) of the signed byte b of `biased` (the codes' word xor 0x80808080):
// the float whose bits are 0x4B0000xx is 2^23 + xx = 2^23 + c + 128, exactly
__device__ __forceinline__ float code_value(uint32_t biased, int b) {
  return __fsub_rn(__int_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 | b)), 8388736.0f);
}

// acc[l] = acc[l] + mask * (code_l * scale), each operation rounded on its own
template <int L>
__device__ __forceinline__ void add_slot(float (&acc)[L], const Codes<L>& c, float sc, float mr) {
  const uint32_t flip = L == 1 ? 0x80u : 0x80808080u;
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const float d = __fmul_rn(code_value(c.word(l / 4) ^ flip, l % 4), sc);
    acc[l] = __fadd_rn(acc[l], __fmul_rn(mr, d));
  }
}

template <int L>
__device__ __forceinline__ void load_lanes(float (&x)[L], const float* p) {
  if constexpr (L == 1) {
    x[0] = __ldg(p);
  } else {
#pragma unroll
    for (int i = 0; i < L; i += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p + i));
      x[i] = f.x, x[i + 1] = f.y, x[i + 2] = f.z, x[i + 3] = f.w;
    }
  }
}

template <int L>
__global__ void __launch_bounds__(kQThreads)
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
  const int n0 = (blockIdx.x * kQThreads + threadIdx.x) * L;
  if (n0 >= S) return;
  const int64_t row = static_cast<int64_t>(k) * S + n0;
  const int8_t* qk = q + static_cast<int64_t>(k) * R * S + n0;
  const float* sk = scales + static_cast<int64_t>(k) * R * NB + n0 / kQBlock;
  const float* m = mask + static_cast<int64_t>(k) * R;
  float acc[L];
  load_lanes<L>(acc, own + row);
  const float om = __ldg(own_mask + k);
#pragma unroll
  for (int l = 0; l < L; ++l) acc[l] = __fmul_rn(om, acc[l]);
  int r = 0;
  for (; r + kQGroup <= R; r += kQGroup) {  // a group's loads first, all in flight at once
    Codes<L> c[kQGroup];
    float sc[kQGroup], mr[kQGroup];
#pragma unroll
    for (int g = 0; g < kQGroup; ++g) {
      c[g].load(qk + static_cast<int64_t>(r + g) * S);
      sc[g] = __ldg(sk + static_cast<int64_t>(r + g) * NB);
      mr[g] = __ldg(m + r + g);
    }
#pragma unroll
    for (int g = 0; g < kQGroup; ++g) add_slot<L>(acc, c[g], sc[g], mr[g]);
  }
  for (; r < R; ++r) {
    Codes<L> c;
    c.load(qk + static_cast<int64_t>(r) * S);
    add_slot<L>(acc, c, __ldg(sk + static_cast<int64_t>(r) * NB), __ldg(m + r));
  }
  float wl[L];
  load_lanes<L>(wl, w + row);
  const float ne = -__ldg(eps + k);
  if constexpr (L == 1) {
    out[row] = __fmaf_rn(ne, acc[0], wl[0]);
  } else {
#pragma unroll
    for (int i = 0; i < L; i += 4) {
      *reinterpret_cast<float4*>(out + row + i) =
          make_float4(__fmaf_rn(ne, acc[i], wl[i]), __fmaf_rn(ne, acc[i + 1], wl[i + 1]),
                      __fmaf_rn(ne, acc[i + 2], wl[i + 2]), __fmaf_rn(ne, acc[i + 3], wl[i + 3]));
    }
  }
}

template <int L>
int launch_q(float* out, const float* w, const float* own, const int8_t* q,
             const float* scales, const float* mask, const float* own_mask, const float* eps,
             int K, int R, int S, int NB, cudaStream_t stream) {
  const int threads = (S + L - 1) / L;
  const dim3 grid((threads + kQThreads - 1) / kQThreads, K);
  ipls_aggregate_batched_q_kernel<L><<<grid, kQThreads, 0, stream>>>(
      out, w, own, q, scales, mask, own_mask, eps, R, S, NB);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % static_cast<uintptr_t>(bytes) == 0;
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
// `lanes` per thread: 8, 4 or 1; it must divide S, and q must be aligned to
// it (w, own and out to 16 bytes where lanes >= 4), else cudaErrorInvalidValue.
extern "C" int ipls_aggregate_batched_q_f32(float* out, const float* w, const float* own,
                                            const int8_t* q, const float* scales,
                                            const float* mask, const float* own_mask,
                                            const float* eps, int K, int R, int S, int NB,
                                            int lanes, cudaStream_t stream) {
  if (S % lanes != 0 || !aligned(q, lanes) ||
      (lanes >= 4 && !(aligned(w, 16) && aligned(own, 16) && aligned(out, 16))))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (lanes) {
    case 8:
      return launch_q<8>(out, w, own, q, scales, mask, own_mask, eps, K, R, S, NB, stream);
    case 4:
      return launch_q<4>(out, w, own, q, scales, mask, own_mask, eps, K, R, S, NB, stream);
    case 1:
      return launch_q<1>(out, w, own, q, scales, mask, own_mask, eps, K, R, S, NB, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
