// RWKV6 linear recurrence (the "Finch" time mix) for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel rwkv6_scan
// (src/repro/kernels/linear_scan/linear_scan.py:77, body _kernel):
//
//   out_t = r_t . S_{t-1} + (r_t . (u * k_t)) v_t
//   S_t   = diag(exp(logw_t)) S_{t-1} + k_t v_t^T
//
// for r, k, v (B, T, H, 64) in float32 or bfloat16, logw (B, T, H, 64) float32, u (H, 64)
// float32 and an optional float32 initial state (B, H, 64, 64) (zeros without one); out
// (B, T, H, 64) in r's type, the final state (B, H, 64, 64) in float32. All arithmetic is
// float32; out is rounded once.
//
// Bound: operations. Per token and head the readout r.S is K*V multiply-adds and the update
// S*w + k v^T is K*V multiplies and K*V multiply-adds: 5*K*V = 20,480 flops, plus the bonus,
// 3*K + 2*V. At the serve shape (B=4, T=4096, H=64, bf16) that is 2.18e10 flops, 0.326 ms
// at 67 TFLOP/s (float32 outside the tensor cores); the bytes, r, k, v and out in bf16, logw
// in float32 and the final state, are 809.5 MB, 0.242 ms at 3.35 TB/s.
//
// Design. The TPU kernel used the chunked form (64-step chunks, a (Q, Q, K) pair tensor in
// VMEM, the state carried in scratch across a sequential grid) because the MXU wants matrix
// products. This kernel uses the step form: column v of S evolves on its own, so one block
// per (batch, head) gives each of 64 consumer threads one column, 64 floats in registers, and
// walks the T steps in order, one readout and one update per state element and step. No sum
// of decays is ever exponentiated, so nothing can overflow: each factor exp(logw) lies in
// (0, 1]. The steps' inputs come through shared memory, 16 steps to a buffer, in two buffers:
// while the two consumer warps run chunk c, four producer warps load chunk c+1 (r, k and v as
// float32, w = exp(logw), and each step's bonus r.(u*k) as a warp sum), so the loads' latency
// hides behind the recurrence. The consumers read a step's r, k and w as broadcast 16-byte
// shared-memory loads. Inputs are read in place through (b, t, h) strides with the last
// dimension contiguous, so the model's (B, T, H, K) projections need no transposed copy (the
// TPU kernel's fold). Any T >= 1: the last chunk may be partial.
//
// At the serve shape there are B*H = 256 blocks, about two an SM, and one consumer warp per
// scheduler: the recurrence's dependent multiply-adds, not the memory, set the pace. More
// parallelism (several blocks per (batch, head) over slices of the state, or the chunked
// form on tensor cores) is a later redesign.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kK = 64;                                      // head size: K = V
constexpr int kSteps = 16;                                  // time steps in one buffer
constexpr int kConsumers = kK;                              // one thread per state column
constexpr int kProducerWarps = 4;
constexpr int kThreads = kConsumers + 32 * kProducerWarps;  // 192
constexpr int kStepsPerWarp = kSteps / kProducerWarps;      // steps each producer warp loads

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

struct Strides {
  int64_t b, t, h;  // in elements; the last dimension is contiguous
};

// one buffer: kSteps steps of the inputs, as float32 (32,896 bytes for two)
struct __align__(16) Chunk {
  float r[kSteps][kK];
  float k[kSteps][kK];
  float w[kSteps][kK];  // exp(logw)
  float v[kSteps][kK];
  float bonus[kSteps];  // r . (u * k)
};

// A producer warp's part of staging chunk c: steps pw, pw + 4, ... of it, all loads first,
// then the shared-memory stores and the bonus sums.
template <typename T>
struct Producer {
  const T* __restrict__ r;
  const T* __restrict__ k;
  const T* __restrict__ v;
  const float* __restrict__ logw;
  Strides sr, sk, sv, sw;
  int b, h, T_len, pw, lane;
  float u0, u1;  // u at this lane's two elements

  __device__ __forceinline__ void stage(Chunk& ch, int c) const {
    float x[kStepsPerWarp][4][2];
#pragma unroll
    for (int q = 0; q < kStepsPerWarp; ++q) {
      const int t = c * kSteps + pw + q * kProducerWarps;
      if (t < T_len) {
        const T* rp = r + b * sr.b + static_cast<int64_t>(t) * sr.t + h * sr.h;
        const T* kp = k + b * sk.b + static_cast<int64_t>(t) * sk.t + h * sk.h;
        const T* vp = v + b * sv.b + static_cast<int64_t>(t) * sv.t + h * sv.h;
        const float* wp = logw + b * sw.b + static_cast<int64_t>(t) * sw.t + h * sw.h;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          x[q][0][e] = to_f32(rp[lane + 32 * e]);
          x[q][1][e] = to_f32(kp[lane + 32 * e]);
          x[q][2][e] = to_f32(vp[lane + 32 * e]);
          x[q][3][e] = wp[lane + 32 * e];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kStepsPerWarp; ++q) {
      const int s = pw + q * kProducerWarps;
      if (c * kSteps + s < T_len) {  // the same in every lane of the warp
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          ch.r[s][lane + 32 * e] = x[q][0][e];
          ch.k[s][lane + 32 * e] = x[q][1][e];
          ch.v[s][lane + 32 * e] = x[q][2][e];
          ch.w[s][lane + 32 * e] = expf(x[q][3][e]);
        }
        float p = fmaf(x[q][0][1] * u1, x[q][1][1], x[q][0][0] * u0 * x[q][1][0]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
        if (lane == 0) ch.bonus[s] = p;
      }
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
rwkv6_scan_kernel(T* __restrict__ out, float* __restrict__ state_out, const T* __restrict__ r,
                  const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ logw, const float* __restrict__ u,
                  const float* __restrict__ state_in, Strides so, Strides sr, Strides sk,
                  Strides sv, Strides sw, int H, int T_len) {
  __shared__ Chunk buf[2];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const bool consumer = tid < kConsumers;
  const int j = tid;                                        // a consumer's state column
  const int pw = (tid - kConsumers) >> 5, lane = tid & 31;  // a producer's warp and lane
  const int n_chunks = (T_len + kSteps - 1) / kSteps;
  const int64_t bh = static_cast<int64_t>(b) * H + h;
  float u0 = 0.0f, u1 = 0.0f;
  if (!consumer) {
    u0 = u[h * kK + lane];
    u1 = u[h * kK + lane + 32];
  }
  const Producer<T> prod{r, k, v, logw, sr, sk, sv, sw, b, h, T_len, pw, lane, u0, u1};

  float S[kK];  // column j of the state (consumers)
  if (consumer) {
#pragma unroll
    for (int i = 0; i < kK; ++i) S[i] = state_in ? state_in[(bh * kK + i) * kK + j] : 0.0f;
  } else {
    prod.stage(buf[0], 0);
  }
  __syncthreads();

  T* ob = out + b * so.b + h * so.h + j;
  for (int c = 0; c < n_chunks; ++c) {
    if (!consumer) {
      if (c + 1 < n_chunks) prod.stage(buf[(c + 1) & 1], c + 1);
    } else {
      const Chunk& ch = buf[c & 1];
      const int t0 = c * kSteps;
      const int n = min(kSteps, T_len - t0);
      for (int s = 0; s < n; ++s) {
        const float vj = ch.v[s][j];
        float o[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < kK; i += 4) {
          const float4 rr = *reinterpret_cast<const float4*>(&ch.r[s][i]);
          const float4 kk = *reinterpret_cast<const float4*>(&ch.k[s][i]);
          const float4 ww = *reinterpret_cast<const float4*>(&ch.w[s][i]);
          // readout with S_{t-1}, then S_t = S_{t-1} * w + k v
          o[0] = fmaf(rr.x, S[i], o[0]);
          S[i] = fmaf(S[i], ww.x, kk.x * vj);
          o[1] = fmaf(rr.y, S[i + 1], o[1]);
          S[i + 1] = fmaf(S[i + 1], ww.y, kk.y * vj);
          o[2] = fmaf(rr.z, S[i + 2], o[2]);
          S[i + 2] = fmaf(S[i + 2], ww.z, kk.z * vj);
          o[3] = fmaf(rr.w, S[i + 3], o[3]);
          S[i + 3] = fmaf(S[i + 3], ww.w, kk.w * vj);
        }
        const float y = ((o[0] + o[1]) + (o[2] + o[3])) + ch.bonus[s] * vj;
        store(ob + static_cast<int64_t>(t0 + s) * so.t, y);
      }
    }
    __syncthreads();  // chunk c read, chunk c + 1 staged
  }

  if (consumer) {
#pragma unroll
    for (int i = 0; i < kK; ++i) state_out[(bh * kK + i) * kK + j] = S[i];
  }
}

template <typename T>
int launch(void* out, float* state_out, const void* r, const void* k, const void* v,
           const float* logw, const float* u, const float* state_in, int B, int T_len, int H,
           const int64_t* st, cudaStream_t stream) {
  rwkv6_scan_kernel<T><<<dim3(H, B), kThreads, 0, stream>>>(
      static_cast<T*>(out), state_out, static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), logw, u, state_in, Strides{st[0], st[1], st[2]},
      Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      Strides{st[12], st[13], st[14]}, H, T_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. out (B, T, H, 64) in r's type; r, k, v
// (B, T, H, 64) device pointers of one type (dtype 0 = float32, 1 = bfloat16); logw
// (B, T, H, 64) float32; each with the last dimension contiguous and the (b, t, h) element
// strides given in `strides`, 15 host int64 values: out, r, k, v, logw. u (H, 64), state_in
// (B, H, 64, 64) (or NULL: zeros) and state_out (B, H, 64, 64) are contiguous float32.
// B <= 65535, T >= 1. One launch on `stream`, no synchronisation. Returns the CUDA error
// after it (0 = launched).
extern "C" int rwkv6_scan_fwd(void* out, float* state_out, const void* r, const void* k,
                              const void* v, const float* logw, const float* u,
                              const float* state_in, int dtype, int B, int T_len, int H,
                              const int64_t* strides, cudaStream_t stream) {
  if (B < 1 || B > 65535 || H < 1 || T_len < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(out, state_out, r, k, v, logw, u, state_in, B, T_len, H, strides,
                         stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(out, state_out, r, k, v, logw, u, state_in, B, T_len, H,
                                 strides, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
