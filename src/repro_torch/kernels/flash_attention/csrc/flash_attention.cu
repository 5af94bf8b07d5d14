// Causal (or full) flash attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attention/flash_attention.py:74, body _kernel, with the GQA
// repeat of its ops.py). Per (batch, head) and query row i:
//
//   s_j = (q_i . k_j) / sqrt(D), masked to finfo(float32).min where j > i (causal)
//   o_i = sum_j softmax(s)_j v_j
//
// in float32 throughout (online softmax: running max m, sum l, accumulator acc), the
// output cast to the input type at the end, with l clamped at 1e-30 as the TPU kernel
// does. A masked score gives exp(min - m) = 0 and never a NaN.
//
// Bound: operations. At the serve shape (B=4, H=16, S=4096, D=128) the causal products
// are 4*B*H*D*S(S+1)/2 = 275 GFLOP, 0.278 ms at the card's 989 TFLOP/s bf16 tensor-core
// rate, while q, k, v and o are 0.2 GB (0.06 ms at 3.35 TB/s). This first kernel
// computes on the CUDA cores in float32 (67 TFLOP/s peak); tensor cores (mma/wgmma)
// and TMA are later work.
//
// Design. The TPU kernel walked a sequential (B*H, q tile, k tile) grid with the
// softmax state in VMEM scratch. Here one block of 256 threads owns a 64-row query tile
// of one (batch, head); the key tiles are a loop inside the block, so the state lives
// in registers. The grid is (query tiles, B*H), longest causal rows first. Per key
// tile the block stages K (then V, in the same buffer) in shared memory as float32;
// each thread computes a 4x4 patch of the 64x64 scores (rows ty+16i, columns tx+16j)
// and keeps the matching 4 rows x D/16 columns of the output accumulator, so a query
// row's D=128 accumulators are spread over 16 threads. Row max and sum are xor
// shuffles across those 16 lanes. Rows of shared memory are padded by one float so
// column reads fall on 32 distinct banks. Tensors come with strides (the last
// dimension contiguous), so the model's (B, S, H, D) projections go in as (B, H, S, D)
// views without a copy; GQA reads kv head h / (H/KV) directly. Any S: the ragged last
// tile is masked.
#include <cfloat>
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -FLT_MAX;  // finfo(float32).min, the TPU kernel's mask value

struct Strides {
  int64_t b, h, s;  // in elements; the last dimension is contiguous
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int D>
constexpr int smem_bytes() {
  return (kBQ * (D + 1) + kBK * (D + 1) + kBQ * (kBK + 1)) * static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd(T* __restrict__ out, const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, Strides so, Strides sq, Strides sk, Strides sv, int H,
          int group, int S, float scale, int causal) {
  constexpr int kLd = D + 1;    // padded row of q_s and kv_s
  constexpr int kPLd = kBK + 1;  // padded row of p_s
  constexpr int kDc = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;               // kBQ x kLd
  float* kv_s = q_s + kBQ * kLd;   // kBK x kLd: K, then V, of one key tile
  float* p_s = kv_s + kBK * kLd;   // kBQ x kPLd: probabilities of the tile

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest causal rows first
  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / group;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    q_s[r * kLd + c] = q0 + r < S ? to_f32(qb[(q0 + r) * sq.s + c]) : 0.0f;
  }
  float m[4], l[4], acc[4][kDc];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kDc; ++c) acc[i][c] = 0.0f;
  }

  const int k_end = causal ? min(S, q0 + kBQ) : S;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // q_s is written; the previous tile's V and P reads are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      kv_s[r * kLd + c] = k0 + r < S ? to_f32(kb[(k0 + r) * sk.s + c]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * kLd + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kv_s[(tx + 16 * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const float x = s[i][j] * scale;
        s[i][j] = (col >= S || (causal && col > row)) ? kNegInf : x;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(ty + 16 * i) * kPLd + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDc; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();  // every K read is done: the buffer takes V

    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      kv_s[r * kLd + c] = k0 + r < S ? to_f32(vb[(k0 + r) * sv.s + c]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * kPLd + c];
#pragma unroll
      for (int cc = 0; cc < kDc; ++cc) {
        const float vv = kv_s[c * kLd + tx + 16 * cc];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][cc] = fmaf(pv[i], vv, acc[i][cc]);
      }
    }
  }

  T* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < S) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < kDc; ++c) store(ob + row * so.s + tx + 16 * c, acc[i][c] / denom);
    }
  }
}

template <typename T, int D>
int launch(void* out, const void* q, const void* k, const void* v, int B, int H, int KV, int S,
           int causal, const int64_t* st, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  static bool configured = false;  // once per instantiation, before any graph capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  flash_fwd<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, H, H / KV, S, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(void* out, const void* q, const void* k, const void* v, int B, int H, int KV,
               int S, int D, int causal, const int64_t* st, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(out, q, k, v, B, H, KV, S, causal, st, stream);
    case 128: return launch<T, 128>(out, q, k, v, B, H, KV, S, causal, st, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes. out, q: (B, H, S, D); k, v: (B, KV, S, D),
// device pointers of one type (dtype 0 = float32, 1 = bfloat16), the last dimension
// contiguous; `strides` holds 12 host int64 element strides (b, h, s) of out, q, k, v
// in that order. H % KV == 0, D in {16, 128} (the ported configs' head sizes), S >= 1. The launch goes on
// `stream` and does not synchronise. Returns the CUDA error after the launch (0 =
// launched).
extern "C" int flash_attention_fwd(void* out, const void* q, const void* k, const void* v,
                                   int dtype, int B, int H, int KV, int S, int D, int causal,
                                   const int64_t* strides, cudaStream_t stream) {
  if (dtype == 0) return dispatch_d<float>(out, q, k, v, B, H, KV, S, D, causal, strides, stream);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(out, q, k, v, B, H, KV, S, D, causal, strides, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
