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
// in float32 and the final state, are 809.5 MB, 0.242 ms at 3.35 TB/s. In instructions the
// step form issues three per state element and step (the readout FMA, the k*v multiply, the
// update FMA), 1.29e10 at the serve shape: 0.385 ms at 132 SMs x 128 lanes x 1.98 GHz.
//
// Design. The TPU kernel used the chunked form (64-step chunks, a (Q, Q, K) pair tensor in
// VMEM, the state carried in scratch across a sequential grid) because the MXU wants matrix
// products. Its factors exp(-A) of summed log-decays (down to -54.6 a step here) overflow
// float32 within a chunk, so this kernel keeps the step form, where every factor exp(logw)
// lies in (0, 1]: one block per (batch, head) walks the T steps in order.
//
// The block's threads tile the 64 x 64 state: a thread holds kRT = 8 rows x kCT = 2 columns
// of it in registers, so a (batch, head) has 256 threads, 8 warps. At the serve shape two
// blocks share an SM, so each scheduler has 4 warps to hide the FMA and shared-memory
// latencies behind. (16 x 1 and 8 x 1, timed against it by scan_variants.py, lost.) With
// rows = warps and columns = lanes, a step's r, k and w rows reach a warp as broadcast
// 16-byte loads, each serving kCT columns: per step a thread issues 3 kRT kCT FP32
// instructions, 3 kRT / 4 + 1 shared loads and one store. A column's readout is split over
// the 64 / kRT row groups: each thread writes its partial to shared memory, and at the end
// of every 16-step chunk the partials are summed in group order 0, 1, ... (fixed: the kernel
// is bitwise repeatable), the bonus added, and the chunk's outputs stored four to a thread.
//
// Inputs stream in by TMA, thread 0 issuing one box of 16 rows per input and chunk (4-D
// tensor maps over the (b, t, h) strides, rows past T read as zeros; rows not 16-byte
// aligned are copied element by element instead) into a ring of three chunks as read (bf16
// or float32), three chunks ahead of the one being stepped. Between chunks the block sums
// the partials and converts the next chunk to float32 (r, k, w = exp(logw), v), forming
// each step's bonus r.(u*k) as a fixed tree over 16 lanes. Two barriers a chunk: after the
// steps (partials written) and after the conversion. Any T >= 1: the last chunk may be
// partial.
#include <cstdint>
#include <cstring>

#include <cuda.h>  // CUtensorMap and its enums (types only: the encoder comes from the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kK = 64;                   // head size: K = V
constexpr int kSteps = 16;               // time steps in one chunk
constexpr int kRing = 3;                 // chunks in the TMA ring (inputs as read)
constexpr int kItems = kSteps * kK / 4;  // (step, 4 lanes) items of a chunk: 256

struct Strides {
  int64_t b, t, h;  // in elements; the last dimension is contiguous
};

template <typename T>
struct Raw {  // one chunk as read from device memory (TMA boxes of kSteps rows)
  T r[kSteps][kK];
  T k[kSteps][kK];
  T v[kSteps][kK];
  float logw[kSteps][kK];
};

struct Stage {  // one chunk in float32, read by every thread's steps
  float r[kSteps][kK];
  float k[kSteps][kK];
  float w[kSteps][kK];  // exp(logw)
};

struct Tail {  // v and the bonus, double-buffered: the reduce of chunk c reads them
  float v[kSteps][kK];
  float bonus[kSteps];  // r . (u * k)
};

constexpr int kRT = 8;                          // state rows a thread holds
constexpr int kCT = 2;                          // state columns a thread holds
constexpr int kThreads = kK * kK / (kRT * kCT);  // a block, one (batch, head): 256
constexpr int kGroups = kK / kRT;                // row groups: partials of each output
constexpr int kCols = kK / kCT;                  // column groups: threads of one row group
static_assert(kRT % 4 == 0 && (kCT == 1 || kCT == 2 || kCT == 4) && kThreads >= kItems,
              "tiling");

template <typename T>
struct Layout {  // the dynamic shared memory: ring, stage, tails, partials
  static constexpr int kStageOff = kRing * static_cast<int>(sizeof(Raw<T>));
  static constexpr int kTailOff = kStageOff + static_cast<int>(sizeof(Stage));
  static constexpr int kPartOff = kTailOff + 2 * static_cast<int>(sizeof(Tail));
  // + 128: the ring is aligned to 128 bytes for TMA by an offset from the dynamic base
  static constexpr int kBytes = kPartOff + 4 * kSteps * kGroups * kK + 128;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, uint32_t tx_bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(tx_bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// a TMA copy of one box at element coordinates (c0, c1, c2, c3) into shared memory
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 y) { *reinterpret_cast<float4*>(p) = y; }
// N adjacent floats of shared memory (N = 1, 2 or 4, the address N-float aligned) as one
// load or store
template <int N>
__device__ __forceinline__ void load_n(float (&x)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 f = load4(p);
    x[0] = f.x, x[1] = f.y, x[2] = f.z, x[3] = f.w;
  } else if constexpr (N == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    x[0] = f.x, x[1] = f.y;
  } else {
    x[0] = *p;
  }
}
template <int N>
__device__ __forceinline__ void store_n(float* p, const float (&x)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *p = x[0];
  }
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 y) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(y.x, y.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(y.z, y.w);
  uint2 x;
  x.x = *reinterpret_cast<const unsigned*>(&a);
  x.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = x;
}

struct Maps {  // TMA descriptors of r, k, v and logw (used where `vec`)
  CUtensorMap r, k, v, logw;
};

// The steps' inputs of one (batch, head): where they lie, how to fetch and convert a chunk.
template <typename T>
struct Inputs {
  const T* __restrict__ r;
  const T* __restrict__ k;
  const T* __restrict__ v;
  const float* __restrict__ logw;
  Strides sr, sk, sv, sw;
  int b, h, T_len;
  bool vec;  // every row 16-byte aligned: TMA; else element loads

  // The whole block: chunk c into `raw`, complete on `full`. TMA: one box of kSteps rows per
  // input (rows past T read as zeros), issued by thread 0. Else every thread copies elements
  // (rows past T are left alone: nothing reads them).
  __device__ __forceinline__ void fetch(const Maps* maps, Raw<T>& raw, uint64_t* full, int c,
                                        int tid) const {
    const int t0 = c * kSteps;
    if (vec) {
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // after generic reads
        mbar_arrive(full, sizeof(Raw<T>));
        tma_load_4d(raw.r, &maps->r, full, 0, h, t0, b);
        tma_load_4d(raw.k, &maps->k, full, 0, h, t0, b);
        tma_load_4d(raw.v, &maps->v, full, 0, h, t0, b);
        tma_load_4d(raw.logw, &maps->logw, full, 0, h, t0, b);
      }
      return;
    }
    for (int x = tid; x < 4 * kSteps * kK; x += kThreads) {
      const int a = x / (kSteps * kK), s = x / kK % kSteps, e = x % kK, t = t0 + s;
      if (t >= T_len) continue;
      if (a < 3) {
        const Strides st = a == 0 ? sr : a == 1 ? sk : sv;
        const T* src = a == 0 ? r : a == 1 ? k : v;
        T* dst = a == 0 ? raw.r[s] : a == 1 ? raw.k[s] : raw.v[s];
        dst[e] = src[b * st.b + static_cast<int64_t>(t) * st.t + h * st.h + e];
      } else {
        raw.logw[s][e] = logw[b * sw.b + static_cast<int64_t>(t) * sw.t + h * sw.h + e];
      }
    }
    __syncthreads();
    if (tid == 0) mbar_arrive(full, 0);
  }

  // item = (step s, lanes e..e+3) of chunk c to float32; the step's bonus as a fixed tree
  // over its 16 items, which are 16 adjacent lanes (all lanes take part, past T with 0)
  __device__ __forceinline__ void convert(const Raw<T>& raw, Stage& st, Tail& tail, int c,
                                          int item, float4 u4) const {
    const int s = item >> 4, e = (item & 15) * 4;
    float p = 0.0f;
    if (c * kSteps + s < T_len) {
      const float4 r4 = load4(&raw.r[s][e]), k4 = load4(&raw.k[s][e]);
      const float4 lw = load4(&raw.logw[s][e]);
      store4(&st.r[s][e], r4);
      store4(&st.k[s][e], k4);
      store4(&st.w[s][e], make_float4(expf(lw.x), expf(lw.y), expf(lw.z), expf(lw.w)));
      store4(&tail.v[s][e], load4(&raw.v[s][e]));
      p = fmaf(r4.w * u4.w, k4.w,
               fmaf(r4.z * u4.z, k4.z, fmaf(r4.y * u4.y, k4.y, r4.x * u4.x * k4.x)));
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
    if ((item & 15) == 0) tail.bonus[s] = p;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
rwkv6_scan_kernel(const __grid_constant__ Maps maps, T* __restrict__ out,
                  float* __restrict__ state_out, Inputs<T> in, const float* __restrict__ u,
                  const float* __restrict__ state_in, Strides so, int H) {
  using Tl = Layout<T>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kRing];  // a ring slot's copies landed
  unsigned char* smem = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  Raw<T>* ring = reinterpret_cast<Raw<T>*>(smem);
  Stage& st = *reinterpret_cast<Stage*>(smem + Tl::kStageOff);
  Tail* tail = reinterpret_cast<Tail*>(smem + Tl::kTailOff);
  float* part = reinterpret_cast<float*>(smem + Tl::kPartOff);  // [kSteps][kGroups][kK]
  in.h = blockIdx.x;
  in.b = blockIdx.y;

  const int tid = threadIdx.x;
  const int rg = tid / kCols, i0 = rg * kRT, j0 = (tid % kCols) * kCT;
  const int T_len = in.T_len, n_chunks = (T_len + kSteps - 1) / kSteps;
  const int64_t bh = static_cast<int64_t>(in.b) * H + in.h;
  const bool worker = tid < kItems;  // converts and reduces one item of every chunk
  float4 u4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (worker) {
    const float* up = u + in.h * kK + (tid & 15) * 4;
    u4 = make_float4(up[0], up[1], up[2], up[3]);
  }

  float S[kRT][kCT];  // rows i0.., columns j0.. of the state
#pragma unroll
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int c = 0; c < kCT; ++c)
      S[i][c] = state_in ? state_in[(bh * kK + i0 + i) * kK + j0 + c] : 0.0f;

  if (tid == 0) {
    for (int i = 0; i < kRing; ++i) mbar_init(&full[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // chunks 0 .. kRing-1 in flight; chunk 0 converted
  for (int c = 0; c < kRing && c < n_chunks; ++c)
    in.fetch(&maps, ring[c], &full[c], c, tid);
  if (worker) {
    mbar_wait(&full[0], 0);
    in.convert(ring[0], st, tail[0], 0, tid, u4);
  }
  __syncthreads();

  T* ob = out + in.b * so.b + in.h * so.h;
  for (int c = 0; c < n_chunks; ++c) {
    // the slot of chunk c, converted before the last barrier, takes chunk c + kRing
    if (c + kRing < n_chunks)
      in.fetch(&maps, ring[c % kRing], &full[c % kRing], c + kRing, tid);

    const Tail& tl = tail[c & 1];
    const int n = min(kSteps, T_len - c * kSteps);
#pragma unroll 2
    for (int s = 0; s < n; ++s) {
      float vj[kCT], o[kCT];
      load_n(vj, &tl.v[s][j0]);
#pragma unroll
      for (int c2 = 0; c2 < kCT; ++c2) o[c2] = 0.0f;
#pragma unroll
      for (int i = 0; i < kRT; i += 4) {
        const float4 rr = load4(&st.r[s][i0 + i]);
        const float4 kk = load4(&st.k[s][i0 + i]);
        const float4 ww = load4(&st.w[s][i0 + i]);
        const float rv[4] = {rr.x, rr.y, rr.z, rr.w};
        const float kv[4] = {kk.x, kk.y, kk.z, kk.w};
        const float wv[4] = {ww.x, ww.y, ww.z, ww.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int c2 = 0; c2 < kCT; ++c2) {
            // readout with S_{t-1}, then S_t = S_{t-1} * w + k v
            o[c2] = fmaf(rv[q], S[i + q][c2], o[c2]);
            S[i + q][c2] = fmaf(S[i + q][c2], wv[q], kv[q] * vj[c2]);
          }
      }
      store_n(part + (s * kGroups + rg) * kK + j0, o);
    }

    __syncthreads();  // the chunk's partials written
    if (worker) {
      const int s = tid >> 4, j = (tid & 15) * 4, t = c * kSteps + s;
      if (t < T_len) {
        const float* pp = part + s * kGroups * kK + j;
        float4 y = load4(pp);
#pragma unroll
        for (int g = 1; g < kGroups; ++g) {
          const float4 x = load4(pp + g * kK);
          y = make_float4(y.x + x.x, y.y + x.y, y.z + x.z, y.w + x.w);
        }
        const float bo = tl.bonus[s];
        const float4 v4 = load4(&tl.v[s][j]);
        y = make_float4(fmaf(bo, v4.x, y.x), fmaf(bo, v4.y, y.y), fmaf(bo, v4.z, y.z),
                        fmaf(bo, v4.w, y.w));
        store4(ob + static_cast<int64_t>(t) * so.t + j, y);
      }
      if (c + 1 < n_chunks) {
        mbar_wait(&full[(c + 1) % kRing], ((c + 1) / kRing) & 1);
        in.convert(ring[(c + 1) % kRing], st, tail[(c + 1) & 1], c + 1, tid, u4);
      }
    }
    __syncthreads();  // chunk c + 1 staged; the partials free again
  }

#pragma unroll
  for (int i = 0; i < kRT; ++i)
#pragma unroll
    for (int c = 0; c < kCT; ++c) state_out[(bh * kK + i0 + i) * kK + j0 + c] = S[i][c];
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched through the CUDA runtime: no link against libcuda.
EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The (B, T, H, 64) input at `base` with (b, t, h) element strides `st` as a 4-D tensor map
// whose box is one (batch, head)'s kSteps rows; rows past T read as zeros.
bool input_map(CUtensorMap* map, const void* base, int elem, int B, int T_len, int H,
               Strides st) {
  const EncodeTiled fn = tensor_map_encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {kK, static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(T_len),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.h * elem),
                                 static_cast<cuuint64_t>(st.t * elem),
                                 static_cast<cuuint64_t>(st.b * elem)};
  const cuuint32_t box[4] = {kK, 1, kSteps, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            4, const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p, const int64_t* st, int elem) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if (st[i] * elem % 16) return false;
  return true;
}

template <typename T>
int launch(void* out, float* state_out, const void* r, const void* k, const void* v,
           const float* logw, const float* u, const float* state_in, int B, int T_len, int H,
           const int64_t* st, cudaStream_t stream) {
  constexpr int elem = static_cast<int>(sizeof(T));
  const bool vec = aligned16(r, st + 3, elem) && aligned16(k, st + 6, elem) &&
                   aligned16(v, st + 9, elem) && aligned16(logw, st + 12, 4);
  if (!aligned16(out, st, elem)) return static_cast<int>(cudaErrorInvalidValue);
  const Inputs<T> in{static_cast<const T*>(r), static_cast<const T*>(k),
                     static_cast<const T*>(v), logw,
                     Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
                     Strides{st[9], st[10], st[11]}, Strides{st[12], st[13], st[14]},
                     0, 0, T_len, vec};  // b, h: the block's
  Maps maps;
  std::memset(&maps, 0, sizeof(maps));
  if (vec && !(input_map(&maps.r, r, elem, B, T_len, H, in.sr) &&
               input_map(&maps.k, k, elem, B, T_len, H, in.sk) &&
               input_map(&maps.v, v, elem, B, T_len, H, in.sv) &&
               input_map(&maps.logw, logw, 4, B, T_len, H, in.sw)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = rwkv6_scan_kernel<T>;
  static unsigned sized = 0;  // devices on which the shared memory was allowed
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 32 || !(sized >> dev & 1u)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Layout<T>::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 32) sized |= 1u << dev;
  }
  kernel<<<dim3(H, B), kThreads, Layout<T>::kBytes, stream>>>(
      maps, static_cast<T*>(out), state_out, in, u, state_in, Strides{st[0], st[1], st[2]}, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point, loaded with ctypes. out (B, T, H, 64) in r's type; r, k, v
// (B, T, H, 64) device pointers of one type (dtype 0 = float32, 1 = bfloat16); logw
// (B, T, H, 64) float32; each with the last dimension contiguous and the (b, t, h) element
// strides given in `strides`, 15 host int64 values: out, r, k, v, logw (out's rows 16-byte
// aligned). u (H, 64), state_in (B, H, 64, 64) (or NULL: zeros) and state_out (B, H, 64, 64)
// are contiguous float32. B <= 65535, T >= 1. One launch on `stream`, no synchronisation.
// Returns the CUDA error after it (0 = launched).
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
