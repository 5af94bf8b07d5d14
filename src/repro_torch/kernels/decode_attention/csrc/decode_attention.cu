// Flash-decode for Hopper (sm_90a), hand-written CUDA C++: one new query per (batch,
// head) against a KV cache, keys 0..pos.
//
// Replaces the Pallas TPU kernel decode_attention
// (src/repro/kernels/decode_attention/decode_attention.py:67, body _kernel, with the
// GQA repeat of its ops.py):
//
//   s_t = (q . k_t) / sqrt(D) for t <= pos, finfo(float32).min after it
//   o = sum_t softmax(s)_t v_t
//
// in float32, the output cast to the input type at the end, l clamped at 1e-30.
//
// Bound: bytes. A step reads the keys and values up to pos once, 2*B*KV*(pos+1)*D
// elements (71 MB in bf16 at B=4, KV=8, pos=4351, D=128: 21.3 us at 3.35 TB/s), and
// does 4 flops per element and query head, far below the card's rate.
//
// Design. The TPU kernel walked the cache as a sequential grid (B, H, blocks of 256
// keys) with the softmax state in VMEM. At the serve shape B*H = 64 such programs
// would leave half of the 132 SMs idle, so the cache is split across blocks
// (flash-decoding): decode_partial runs one block per (256-key chunk, kv head, batch)
// and writes the chunk's (max, sum, unnormalised accumulator); decode_combine merges
// the chunks of each (batch, head). One block serves all H/KV query heads of its kv
// head, so K and V are read once, not H/KV times. `pos` is read from device memory,
// as the TPU kernel read it from SMEM: chunks past pos exit at once and only keys up
// to pos are read, and a CUDA graph of the decode step needs no change. Keys are read
// as 16-byte vectors, D/8 (bf16) or D/4 (float32) lanes to a key; the score is a
// shuffle sum over those lanes. Probabilities go through shared memory; for the
// product with V each thread owns a 16-byte column slice of a V row and a strided set
// of the chunk's keys, and the slices are summed by shuffles, then across warps. The
// cache comes as a strided (B, KV, T, D) view of the model's (B, T, KV, D) cache.
#include <cfloat>
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 256;    // keys per block (the TPU kernel's BS)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;       // query heads per kv head
constexpr int kCombineThreads = 128;
constexpr float kNegInf = -FLT_MAX;  // finfo(float32).min, the TPU kernel's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// one 16-byte load of 4 float32 or 8 bfloat16 values, as float32
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}
// a bfloat16 is the top half of a float32: element 2i is the low half of word i
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

struct Strides {
  int64_t b, h, t;  // in elements; the last dimension is contiguous
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_partial(float* __restrict__ part_acc, float* __restrict__ part_ml,
               const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const int* __restrict__ pos_p, Strides sq, Strides sk, Strides sv, int H,
               int G, int T_len, int n_chunks, float scale) {
  constexpr int V = 16 / static_cast<int>(sizeof(T));  // values per 16-byte vector
  constexpr int LPK = D / V;                            // lanes per key row
  constexpr int KPW = 32 / LPK;                         // keys per warp per step
  constexpr int kSlices = kThreads / LPK;               // key slices of the V product
  __shared__ float q_s[kMaxG][D];
  __shared__ float p_s[kMaxG][kChunk];
  __shared__ float red[kWarps][kMaxG * D];
  __shared__ float ml_s[kMaxG][2];

  const int chunk = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int pos = min(*pos_p, T_len - 1);
  const int c0 = chunk * kChunk;
  if (c0 > pos) return;  // decode_combine reads chunks 0..pos/kChunk only
  const int n_keys = min(kChunk, pos + 1 - c0);
  const int h0 = kvh * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* kb = k + b * sk.b + kvh * sk.h + static_cast<int64_t>(c0) * sk.t;
  const T* vb = v + b * sv.b + kvh * sv.h + static_cast<int64_t>(c0) * sv.t;

  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i / D][i % D] = to_f32(q[b * sq.b + (h0 + i / D) * sq.h + i % D]);
  }
  __syncthreads();

  // scores: LPK lanes per key, a shuffle sum over them
  const int sub = lane / LPK, part = lane % LPK;
  for (int kk = warp * KPW + sub; kk < kChunk; kk += kWarps * KPW) {
    float dot[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) dot[g] = 0.0f;
    if (kk < n_keys) {
      float kv[V];
      load16(kb + kk * sk.t + part * V, kv);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
#pragma unroll
          for (int e = 0; e < V; ++e) dot[g] = fmaf(q_s[g][part * V + e], kv[e], dot[g]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {  // G is the same in every lane
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1) {
          dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], off);
        }
      }
    }
    if (part == 0) {
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) p_s[g][kk] = kk < n_keys ? dot[g] * scale : kNegInf;
      }
    }
  }
  __syncthreads();

  // the chunk's max and sum: one warp per query head
  if (warp < G) {
    float mx = kNegInf;
    for (int i = lane; i < kChunk; i += 32) mx = fmaxf(mx, p_s[warp][i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.0f;
    for (int i = lane; i < kChunk; i += 32) {
      const float p = expf(p_s[warp][i] - mx);
      p_s[warp][i] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      ml_s[warp][0] = mx;
      ml_s[warp][1] = sum;
    }
  }
  __syncthreads();

  // P V: a 16-byte column slice per thread, keys strided by kSlices
  const int col = (tid % LPK) * V, slice = tid / LPK;
  float acc[kMaxG][V];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[g][e] = 0.0f;
  for (int kk = slice; kk < n_keys; kk += kSlices) {
    float vv[V];
    load16(vb + kk * sv.t + col, vv);
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
        const float p = p_s[g][kk];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e]);
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
#pragma unroll
        for (int off = 16; off >= LPK; off >>= 1) {
          acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        }
      }
    }
  }
  if (lane < LPK) {
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) {
#pragma unroll
        for (int e = 0; e < V; ++e) red[warp][g * D + col + e] = acc[g][e];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][i];
    const int64_t row = (static_cast<int64_t>(b) * H + h0 + i / D) * n_chunks + chunk;
    part_acc[row * D + i % D] = s;
  }
  if (tid < G) {
    const int64_t row = (static_cast<int64_t>(b) * H + h0 + tid) * n_chunks + chunk;
    part_ml[row * 2] = ml_s[tid][0];
    part_ml[row * 2 + 1] = ml_s[tid][1];
  }
}

// merges the chunks of one (batch, head): out = sum_c acc_c e^(m_c - M) / sum_c l_c e^(m_c - M)
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine(T* __restrict__ out, const float* __restrict__ part_acc,
               const float* __restrict__ part_ml, const int* __restrict__ pos_p, int H, int D,
               int T_len, int n_chunks) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int pos = min(*pos_p, T_len - 1);
  const int nc = pos < 0 ? 0 : pos / kChunk + 1;
  const int64_t row = (static_cast<int64_t>(b) * H + h) * n_chunks;
  const float* ml = part_ml + row * 2;
  float mx = kNegInf;
  for (int c = 0; c < nc; ++c) mx = fmaxf(mx, ml[2 * c]);
  for (int d = threadIdx.x; d < D; d += kCombineThreads) {
    float l = 0.0f, a = 0.0f;
    for (int c = 0; c < nc; ++c) {
      const float w = expf(ml[2 * c] - mx);
      l += ml[2 * c + 1] * w;
      a += part_acc[(row + c) * D + d] * w;
    }
    store(out + (static_cast<int64_t>(b) * H + h) * D + d, a / fmaxf(l, 1e-30f));
  }
}

template <typename T, int D>
int launch(void* out, float* part_acc, float* part_ml, const void* q, const void* k,
           const void* v, const int* pos, int B, int H, int KV, int T_len, const int64_t* st,
           cudaStream_t stream) {
  const int n_chunks = (T_len + kChunk - 1) / kChunk;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  decode_partial<T, D><<<dim3(n_chunks, KV, B), kThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pos, Strides{st[0], st[1], 0}, Strides{st[2], st[3], st[4]},
      Strides{st[5], st[6], st[7]}, H, H / KV, T_len, n_chunks, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine<T><<<dim3(H, B), kCombineThreads, 0, stream>>>(
      static_cast<T*>(out), part_acc, part_ml, pos, H, D, T_len, n_chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(void* out, float* part_acc, float* part_ml, const void* q, const void* k,
               const void* v, const int* pos, int B, int H, int KV, int T_len, int D,
               const int64_t* st, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(out, part_acc, part_ml, q, k, v, pos, B, H, KV, T_len, st, stream);
    case 128: return launch<T, 128>(out, part_acc, part_ml, q, k, v, pos, B, H, KV, T_len, st, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. out: (B, H, D) contiguous; q: (B, H, D);
// k, v: (B, KV, T, D), device pointers of one type (dtype 0 = float32, 1 = bfloat16),
// the last dimension contiguous, k and v 16-byte aligned with 16-byte aligned strides;
// `strides` holds 8 host int64 element strides: q (b, h), k (b, h, t), v (b, h, t).
// part_acc (B, H, ceil(T/256), D) and part_ml (B, H, ceil(T/256), 2) are float32
// scratch; pos is one device int32 (keys 0..pos are attended; pos >= T means all).
// H % KV == 0, H / KV <= 8, D in {16, 128}, T >= 1. Two launches (partials,
// combine) on `stream`, no synchronisation. Returns the CUDA error after them (0 =
// launched).
extern "C" int decode_attention_fwd(void* out, float* part_acc, float* part_ml, const void* q,
                                    const void* k, const void* v, const int* pos, int dtype,
                                    int B, int H, int KV, int T_len, int D,
                                    const int64_t* strides, cudaStream_t stream) {
  if (H % KV != 0 || H / KV > kMaxG) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_d<float>(out, part_acc, part_ml, q, k, v, pos, B, H, KV, T_len, D, strides,
                             stream);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(out, part_acc, part_ml, q, k, v, pos, B, H, KV, T_len, D,
                                     strides, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
