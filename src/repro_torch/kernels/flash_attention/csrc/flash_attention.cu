// Causal (or full) flash attention forward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel flash_attention
// (src/repro/kernels/flash_attention/flash_attention.py:74, body _kernel, with the GQA
// repeat of its ops.py). Per (batch, head) and query row i < Sq, over keys j < Sk:
//
//   s_j = (q_i . k_j) / sqrt(D), masked to finfo(float32).min where j > i (causal) and,
//         with a sliding window W (gemma3's local layers), where j <= i - W
//   o_i = sum_j softmax(s)_j v_j
//
// Sq and Sk differ without a mask (whisper's cross-attention: 4 decoder rows against
// 1,500 encoder frames), or with a causal query offset: q_off puts query row i at
// position q_off + i (a sequence-parallel rank's rows of a prefill, q_off = r * Sq), so
// the causal mask, the last key tile a query tile visits and the tiles it masks follow
// the rows' positions, and q_off = 0 with Sq == Sk is the plain causal call. A window
// at an offset (gemma3's local layers on a model axis that its 4 heads do not divide)
// follows the positions too: the first key tile a query tile visits is the one that
// holds key p0 - window + 1, p0 its first row's position, wherever p0 lies in a tile.
// The grid, the Q tile and the store guard follow Sq; the key tiles, the ragged-end mask
// and the K and V tensor maps follow Sk.
//
// with a float32 online softmax (running max m, sum l, accumulator acc), l clamped at
// 1e-30 and the output cast to the input type, as the TPU kernel does. A masked score
// gives a probability of exactly 0, never a NaN: a row that has seen only masked scores
// (a window's first tile can hide every key of some rows) takes 0, not its running max
// -FLT_MAX, as the reference of its exponentials, so they are exp(-FLT_MAX) = 0 and not
// exp(0) = 1, and the rescale of the first real tile multiplies zeros.
//
// Windows: each CTA starts at the first key tile that meets its rows' windows (at S =
// 4096, W = 512 that cuts a local layer's work about 8-fold) and masks every tile that
// crosses the diagonal, the window's lower edge (up to three 64-key tiles for 128 rows) or
// the ragged end. The bf16 kernel is instantiated with and without a window (kWindow):
// the window as a run-time value cost the full causal kernel about 3% on an H100.
//
// Bound: operations. At the serve shape (B=4, H=16, S=4096, D=128) the causal products
// are 4*B*H*D*S(S+1)/2 = 275 GFLOP, 0.278 ms at the card's 989 TFLOP/s bf16 tensor-core
// rate, while q, k, v and o are 0.2 GB (0.06 ms at 3.35 TB/s).
//
// Two paths, chosen by the input's type:
//
// bfloat16 (served): flash_fwd_wgmma. One CTA of 384 threads owns a 128-row query tile
// of one (batch, head), longest causal rows first. Warpgroup 0 is the producer: it gives
// up registers (setmaxnreg 24) and one thread issues TMA loads, Q once and then each
// 128-key tile of K and of V into its own two-stage ring, each stage with a full and an
// empty mbarrier. Warpgroups 1 and 2 (setmaxnreg 240) each own 64 query rows. S = Q K^T
// is wgmma m64n128k16 (bf16 in, float32 out, both operands K-major from 128-byte (D =
// 64, 128) or 32-byte (D = 16) swizzled shared memory, D/16 steps). The softmax runs on the
// accumulator's layout (a thread holds parts of two rows; a row spans 4 lanes), with
// scale*log2(e) folded into one ex2 per score, and rescales the output accumulator by
// alpha. P is rounded to bf16 in registers (the accumulator's layout is the A operand's)
// and O += P V is wgmma m64nDk16 in its register-A form, V read MN-major (the transpose
// bit). At D = 64 a tile row is exactly one 128-byte swizzle row: one TMA box a tile.
// Each consumer issues S of tile t + 1 together with P V of tile t and runs the softmax
// of tile t + 1 while P V runs; the two consumers take turns at issuing (named
// barriers), so one's softmax overlaps the other's products. K and V stages go back to
// the producer after the wgmma wait that retires their last reader. Only the last key
// tiles that cross the diagonal, the window's lower edge or the ragged end are masked;
// tiles above the diagonal or below the window are never loaded; TMA fills rows past Sk
// with zeros. At D = 256 the K and V tiles hold 64 keys (Tile<D, Rows>): Q's 64 KB and two
// stages each of 32 KB K and V tiles make 192 KB of shared memory (128-key tiles would need
// 320 KB), the S tile is 64 x 64 (wgmma m64n64k16, 32 registers a thread) beside the 128
// of the 64 x 256 output accumulator, and O += P V is two m64n128k16 products over the two
// halves of V's columns. The tensor maps are 4-D (D, S, heads, B)
// over the caller's strides, so the model's (B, S, H, D) projections go in as (B, H, S,
// D) views without a copy; GQA reads kv head h / (H/KV). Bases and strides must be
// multiples of 16 bytes (the wrapper checks). The one deliberate change from a float32
// product: P is rounded to bf16 before P V, as tensor-core flash kernels do; l is summed
// from the float32 P.
//
// float32 (the tight agreement checks): flash_fwd, on the CUDA cores in float32
// throughout, as it was first written. One block of 256 threads owns a 64-row query
// tile; per 64-key tile it stages K, then V, in shared memory as float32; each thread
// computes a 4x4 patch of the scores and keeps 4 rows x D/16 output columns; row max
// and sum are xor shuffles across 16 lanes. At D = 256 that is 148,096 bytes of shared
// memory, one block an SM.
#include <cfloat>
#include <cmath>
#include <cstdint>

#include <cuda.h>  // CUtensorMap and its enums (types only: the encoder comes from the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // float32 path: query rows per block
constexpr int kBK = 64;        // float32 path: keys per tile
constexpr int kThreads = 256;  // float32 path: 16 x 16
constexpr float kNegInf = -FLT_MAX;  // finfo(float32).min, the TPU kernel's mask value

struct Strides {
  int64_t b, h, s;  // in elements; the last dimension is contiguous
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// Whether key `col` is hidden from query row `row`: past the Sk keys, after the row
// (causal), or `window` or more keys before it (window > 0).
__device__ __forceinline__ bool hidden(int col, int row, int Sk, int causal, int window) {
  return col >= Sk || (causal && col > row) || (window > 0 && col <= row - window);
}

template <int D>
constexpr int smem_bytes() {
  return (kBQ * (D + 1) + kBK * (D + 1) + kBQ * (kBK + 1)) * static_cast<int>(sizeof(float));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd(T* __restrict__ out, const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, Strides so, Strides sq, Strides sk, Strides sv, int H,
          int group, int Sq, int Sk, float scale, int causal, int window, int q_off) {
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
    q_s[r * kLd + c] = q0 + r < Sq ? to_f32(qb[(q0 + r) * sq.s + c]) : 0.0f;
  }
  float m[4], l[4], acc[4][kDc];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kDc; ++c) acc[i][c] = 0.0f;
  }

  const int p0 = q0 + q_off;  // the position of the tile's first row
  const int k_end = causal ? min(Sk, p0 + kBQ) : Sk;
  const int k_begin = window > 0 ? max(0, p0 - window + 1) / kBK * kBK : 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // q_s is written; the previous tile's V and P reads are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      kv_s[r * kLd + c] = k0 + r < Sk ? to_f32(kb[(k0 + r) * sk.s + c]) : 0.0f;
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
        s[i][j] = hidden(col, row + q_off, Sk, causal, window) ? kNegInf : x;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float m_ref = m_new == kNegInf ? 0.0f : m_new;  // only masked scores so far: p = 0
      const float alpha = expf(m[i] - m_ref);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_ref);
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
      kv_s[r * kLd + c] = k0 + r < Sk ? to_f32(vb[(k0 + r) * sv.s + c]) : 0.0f;
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
    if (row < Sq) {
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < kDc; ++c) store(ob + row * so.s + tx + 16 * c, acc[i][c] / denom);
    }
  }
}

template <typename T, int D>
int launch(void* out, const void* q, const void* k, const void* v, int B, int H, int KV, int Sq,
           int Sk, int causal, int window, int q_off, const int64_t* st, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  static bool configured = false;  // once per instantiation, before any graph capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));
  flash_fwd<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<T*>(out), static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, H, H / KV, Sq, Sk, scale,
      causal, window, q_off);
  return static_cast<int>(cudaGetLastError());
}


// ---- bfloat16: warp-specialised TMA + wgmma ----------------------------------------

constexpr int kTileRows = 128;  // query rows per CTA
constexpr int kWsThreads = 384;  // producer warpgroup + two consumer warpgroups

// Shared-memory geometry of a tile of Rows rows of D bf16 columns, as TMA writes it:
// panels of kSwz bytes a row (the swizzle span: 128 B at D >= 64, 32 B at D = 16), each
// panel Rows deep, rows kSwz bytes apart, 8-row groups 8 * kSwz bytes apart.
template <int D, int Rows>
struct Tile {
  static constexpr int kSwz = D * 2 >= 128 ? 128 : D * 2;
  static constexpr int kBoxCols = kSwz / 2;  // bf16 columns of one TMA box
  static constexpr int kPanels = D / kBoxCols;
  static constexpr int kPanelBytes = Rows * kSwz;
  static constexpr int kBytes = Rows * D * 2;
  static constexpr uint64_t kLayout = kSwz == 128 ? 1 : 3;  // wgmma's code of the swizzle
  static_assert(kSwz == 32 || kSwz == 128, "D = 16 or a multiple of 64");
  static_assert(D <= 256 && D % 16 == 0, "wgmma n");
};

// The kernel's tiles at head_dim D: a 128-row Q tile, K and V tiles of kKeys keys (128,
// but 64 at D = 256, where 128-key tiles would not fit), two stages each.
template <int D>
struct Layout {
  static constexpr int kKeys = D == 256 ? 64 : 128;
  using QT = Tile<D, kTileRows>;
  using KT = Tile<D, kKeys>;
  // Q, two K stages, two V stages, 9 mbarriers; 1 KB of slack to align the tiles
  static constexpr int kSmem = QT::kBytes + 4 * KT::kBytes + 9 * 8 + 1024;
  static_assert(kSmem <= 232448, "above the SM's 227 KB of shared memory a block");
  static_assert(kTileRows % kKeys == 0, "a query tile spans whole key tiles");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride byte offsets
// (16-byte units) and the swizzle layout.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint64_t layout) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Wait until at most N committed wgmma groups of this warpgroup are still running.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma's registers across the
// asynchronous instruction.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(i) F4(i), F4(i + 4), F4(i + 8), F4(i + 12)
#define D64                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "          \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128, float32) (+)= A (64 x 16) B (16 x 128), A and B K-major in shared memory.
__device__ __forceinline__ void mma_ss(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " D64
      ", %64, %65, p, 1, 1, 0, 0;\n}"
      : F16(0), F16(16), F16(32), F16(48)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, float32) (+)= A (64 x 16) B (16 x 64), A and B K-major in shared memory.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}"
      : F16(0), F16(16)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128) += A (64 x 16, bf16 in registers) B (16 x 128), B MN-major in shared memory.
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"
      : F16(0), F16(16), F16(32), F16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64) += A (64 x 16, bf16 in registers) B (16 x 64), B MN-major in shared memory.
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : F16(0), F16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 16) += A (64 x 16, bf16 in registers) B (16 x 16), B MN-major in shared memory.
__device__ __forceinline__ void mma_rs(float (&d)[8], const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}"
      ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}"
      : F4(0), F4(4)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef D64
#undef F16
#undef F4

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2**x in one MUFU instruction (flushes results below 2**-126 to 0: probabilities that
// small vanish beside the row's largest, which is 1)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Mask a thread's scores of the key tile at k0 (hidden()). The thread holds rows row0
// (s[4i], s[4i+1]) and row0 + 8 (s[4i+2], s[4i+3]) at columns k0 + 8i + col0 + {0, 1}.
template <int N>
__device__ __forceinline__ void mask_tile(float (&s)[N], int k0, int col0, int row0, int Sk,
                                          int causal, int window) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = k0 + 8 * i + col0 + j;
      if (hidden(col, row0, Sk, causal, window)) s[4 * i + j] = kNegInf;
      if (hidden(col, row0 + 8, Sk, causal, window)) s[4 * i + 2 + j] = kNegInf;
    }
  }
}

// The float32 online-softmax state of a thread's two rows: running maxima (of the raw
// scores), this thread's partial sums, and the last step's rescale factors.
struct Softmax {
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f, alpha0 = 1.0f, alpha1 = 1.0f;

  // s: raw scores of one key tile -> p = exp((s - m) / sqrt(D)) = exp2(s c - m c), with
  // c = log2(e) / sqrt(D); a row's max over the 4 lanes that hold it. A row whose max is
  // still -FLT_MAX (only masked scores so far) takes m c = 0, so that its p are
  // exp2(-FLT_MAX c) = 0: with m c = -FLT_MAX c rounded, the fmaf would leave that
  // rounding's error, up to 2^100, in the exponent.
  template <int N>
  __device__ __forceinline__ void step(float (&s)[N], float c) {
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mc0 = mx0 == kNegInf ? 0.0f : mx0 * c;
    const float mc1 = mx1 == kNegInf ? 0.0f : mx1 * c;
    alpha0 = exp2_approx(fmaf(m0, c, -mc0));
    alpha1 = exp2_approx(fmaf(m1, c, -mc1));
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      s[4 * i] = exp2_approx(fmaf(s[4 * i], c, -mc0));
      s[4 * i + 1] = exp2_approx(fmaf(s[4 * i + 1], c, -mc0));
      s[4 * i + 2] = exp2_approx(fmaf(s[4 * i + 2], c, -mc1));
      s[4 * i + 3] = exp2_approx(fmaf(s[4 * i + 3], c, -mc1));
      sum0 += s[4 * i] + s[4 * i + 1];
      sum1 += s[4 * i + 2] + s[4 * i + 3];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
  }

  // the rows' sums over their 4 lanes
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
  }
};

template <int D, bool kWindow>
__global__ void __launch_bounds__(kWsThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
                Strides so, int H, int group, int Sq, int Sk, float scale_log2, int causal,
                int window_arg, int q_off) {
  const int window = kWindow ? window_arg : 0;  // a constant 0 folds every window test away
  using L = Layout<D>;
  using QT = typename L::QT;
  using KT = typename L::KT;
  constexpr int KR = L::kKeys;  // keys per K and V tile
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles start on 1 KB boundaries (the 128-byte swizzle repeats every 1 KB)
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t s_q = (raw + 1023u) & ~1023u;
  const uint32_t s_k = s_q + QT::kBytes;      // stage st at s_k + st * KT::kBytes
  const uint32_t s_v = s_k + 2 * KT::kBytes;  // likewise
  const uint32_t bar = s_v + 2 * KT::kBytes;  // q_full, k_full[2], k_empty[2], v_full[2], v_empty[2]
  const uint32_t q_full = bar;
  auto k_full = [&](int st) { return bar + 8 * (1 + st); };
  auto k_empty = [&](int st) { return bar + 8 * (3 + st); };
  auto v_full = [&](int st) { return bar + 8 * (5 + st); };
  auto v_empty = [&](int st) { return bar + 8 * (7 + st); };

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int q0 = qt * kTileRows;
  const int p0 = q0 + q_off;  // the position of the tile's first row
  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / group;
  // key tiles [t_lo, t_lo + n_tiles): from the first that meets the rows' windows to the
  // last at or before the diagonal (causal: the tile of the last row's position) or the end
  const int t_all = (Sk + KR - 1) / KR;
  const int t_lo = window > 0 ? max(0, p0 - window + 1) / KR : 0;
  const int n_tiles = (causal ? min(t_all, (p0 + kTileRows + KR - 1) / KR) : t_all) - t_lo;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), 8);  // lane 0 of each consumer warp
      mbar_init(v_empty(st), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // ---- producer warpgroup ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, QT::kBytes);
      for (int p = 0; p < QT::kPanels; ++p)
        tma_load(s_q + p * QT::kPanelBytes, &tm_q, q_full, p * QT::kBoxCols, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i & 1, row = (t_lo + i) * KR;
        const uint32_t ph = (i >> 1) & 1;
        mbar_wait(k_empty(st), ph ^ 1);  // the first pass through the ring does not wait
        mbar_expect_tx(k_full(st), KT::kBytes);
        for (int p = 0; p < KT::kPanels; ++p)
          tma_load(s_k + st * KT::kBytes + p * KT::kPanelBytes, &tm_k, k_full(st),
                   p * KT::kBoxCols, row, kvh, b);
        mbar_wait(v_empty(st), ph ^ 1);
        mbar_expect_tx(v_full(st), KT::kBytes);
        for (int p = 0; p < KT::kPanels; ++p)
          tma_load(s_v + st * KT::kBytes + p * KT::kPanelBytes, &tm_v, v_full(st),
                   p * KT::kBoxCols, row, kvh, b);
      }
    }
  } else {  // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int tid = threadIdx.x - 128;
    const int cw = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
    const int row0 = q0 + 64 * cw + 16 * warp + (lane >> 2);  // this thread's rows: row0, row0 + 8
    const int col0 = 2 * (lane & 3);  // its columns in each 8-column group: col0, col0 + 1
    const uint32_t q_rows = s_q + 64 * cw * QT::kSwz;  // this warpgroup's rows of Q

    float o[D / 2];  // the output accumulator, m64nD layout
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    Softmax sm;
    float s[KR / 2];  // scores, then probabilities, of 64 rows x KR keys (m64nKR layout)
#pragma unroll
    for (int i = 0; i < KR / 2; ++i) s[i] = 0.0f;
    uint32_t pa[KR / 4];  // P in bf16: KR/16 A operands of 16 keys

    // S = Q K^T: D/16 steps of 16 columns (32 bytes) along the swizzled rows
    auto issue_s = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int panel = (kk * 32) / QT::kSwz, off = (kk * 32) % QT::kSwz;
        mma_ss(s, desc(q_rows + panel * QT::kPanelBytes + off, 16, 8 * QT::kSwz, QT::kLayout),
               desc(s_k + st * KT::kBytes + panel * KT::kPanelBytes + off, 16, 8 * KT::kSwz,
                    KT::kLayout),
               kk > 0);
      }
      wg_commit();
    };
    // O += P V: KR/16 steps of 16 keys; V (keys x D, D contiguous) read MN-major; at D =
    // 256 two n128 products a step, over panels 0-1 and 2-3 of V into o's two halves
    auto issue_pv = [&](int st) {
#pragma unroll
      for (int kk = 0; kk < KR / 16; ++kk) {
        const uint32_t vb = s_v + st * KT::kBytes + kk * 16 * KT::kSwz;
        if constexpr (D == 256) {
          mma_rs(*reinterpret_cast<float(*)[64]>(o), pa + 4 * kk,
                 desc(vb, KT::kPanelBytes, 8 * KT::kSwz, KT::kLayout));
          mma_rs(*reinterpret_cast<float(*)[64]>(o + 64), pa + 4 * kk,
                 desc(vb + 2 * KT::kPanelBytes, KT::kPanelBytes, 8 * KT::kSwz, KT::kLayout));
        } else {
          mma_rs(o, pa + 4 * kk, desc(vb, KT::kPanelBytes, 8 * KT::kSwz, KT::kLayout));
        }
      }
      wg_commit();
    };
    // the scores of the i-th key tile, once its product has landed: release K, mask a tile
    // that crosses the diagonal, the window's lower edge or the ragged end, online softmax
    // in place
    auto softmax = [&](int i) {
      if (lane == 0) mbar_arrive(k_empty(i & 1));
      const int k0 = (t_lo + i) * KR;
      if (k0 + KR > Sk || (causal && k0 + KR - 1 > p0) ||
          (window > 0 && k0 <= p0 + kTileRows - 1 - window))
        mask_tile(s, k0, col0, row0 + q_off, Sk, causal, window);
      sm.step(s, scale_log2);
    };
    // the m64nKR accumulator's 16-key slices are the m64k16 A operand's layout
    auto pack_p = [&]() {
#pragma unroll
      for (int j = 0; j < KR / 4; ++j) pa[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
    };

    // The two consumer warpgroups take turns at issuing their products (named barriers
    // 1 and 2, one per warpgroup), so that one's softmax runs while the other's
    // products occupy the tensor cores. Warpgroup 0 goes first.
    auto my_turn = [&]() { asm volatile("bar.sync %0, 256;" ::"r"(1 + cw) : "memory"); };
    auto your_turn = [&]() { asm volatile("bar.arrive %0, 256;" ::"r"(2 - cw) : "memory"); };
    if (cw == 1) your_turn();

    mbar_wait(q_full, 0);
    mbar_wait(k_full(0), 0);
    my_turn();
    wg_fence();
    pin(s);
    issue_s(0);
    your_turn();
    wg_wait<0>();
    pin(s);
    softmax(0);
    pack_p();
    // Per tile i: S of tile i + 1 and P V of tile i go to the tensor cores together, and
    // the softmax of tile i + 1 runs while P V does. No branch between a wgmma and the
    // wait that retires it, so ptxas keeps them asynchronous.
    for (int i = 0; i + 1 < n_tiles; ++i) {
      const int st = i & 1;
      mbar_wait(k_full(st ^ 1), ((i + 1) >> 1) & 1);
      mbar_wait(v_full(st), (i >> 1) & 1);
      my_turn();
      wg_fence();
      pin(s);
      issue_s(st ^ 1);
      pin(o);
      pin(pa);
      issue_pv(st);
      your_turn();
      wg_wait<1>();
      pin(s);
      softmax(i + 1);
      wg_wait<0>();
      pin(o);
      pin(pa);
      if (lane == 0) mbar_arrive(v_empty(st));
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= sm.alpha0;
        o[4 * j + 1] *= sm.alpha0;
        o[4 * j + 2] *= sm.alpha1;
        o[4 * j + 3] *= sm.alpha1;
      }
      pack_p();
    }
    mbar_wait(v_full((n_tiles - 1) & 1), ((n_tiles - 1) >> 1) & 1);
    my_turn();
    wg_fence();
    pin(o);
    pin(pa);
    issue_pv((n_tiles - 1) & 1);
    if (cw == 0) your_turn();  // warpgroup 1's last turn is the last: no arrival left over
    wg_wait<0>();
    pin(o);
    pin(pa);

    sm.finish();
    const float d0 = fmaxf(sm.l0, 1e-30f), d1 = fmaxf(sm.l1, 1e-30f);
    __nv_bfloat16* ob = out + b * so.b + h * so.h + col0;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      if (row0 < Sq)
        *reinterpret_cast<uint32_t*>(ob + row0 * so.s + 8 * i) =
            pack_bf16(o[4 * i] / d0, o[4 * i + 1] / d0);
      if (row0 + 8 < Sq)
        *reinterpret_cast<uint32_t*>(ob + (row0 + 8) * so.s + 8 * i) =
            pack_bf16(o[4 * i + 2] / d1, o[4 * i + 3] / d1);
    }
  }
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

// A 4-D map (D, S, heads, B) over bf16 `base` with element strides st = (b, h, s); boxes
// of (kBoxCols, Rows, 1, 1) with the tile's swizzle. Rows past S read as zeros (S = Sq for
// Q, Sk for K and V).
template <int D, int Rows>
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int S, int heads, int B,
            const int64_t* st) {
  using T = Tile<D, Rows>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {T::kBoxCols, Rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz =
      T::kSwz == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool kWindow>
int launch_wgmma(void* out, const void* q, const void* k, const void* v, int B, int H, int KV,
                 int Sq, int Sk, int causal, int window, int q_off, const int64_t* st,
                 cudaStream_t stream) {
  using L = Layout<D>;
  const EncodeTiled fn = tensor_map_encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode<D, kTileRows>(fn, &tm_q, q, Sq, H, B, st + 3) ||
      !encode<D, L::kKeys>(fn, &tm_k, k, Sk, KV, B, st + 6) ||
      !encode<D, L::kKeys>(fn, &tm_v, v, Sk, KV, B, st + 9))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;  // once per instantiation, before any graph capture
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_wgmma<D, kWindow>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((Sq + kTileRows - 1) / kTileRows, B * H);
  const float scale_log2 = static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D)));
  flash_fwd_wgmma<D, kWindow><<<grid, kWsThreads, L::kSmem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), Strides{st[0], st[1], st[2]}, H,
      H / KV, Sq, Sk, scale_log2, causal, window, q_off);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 kernel with a window, or without one.
template <int D>
int launch_bf16(void* out, const void* q, const void* k, const void* v, int B, int H, int KV,
                int Sq, int Sk, int causal, int window, int q_off, const int64_t* st,
                cudaStream_t stream) {
  return window > 0 ? launch_wgmma<D, true>(out, q, k, v, B, H, KV, Sq, Sk, causal, window,
                                            q_off, st, stream)
                    : launch_wgmma<D, false>(out, q, k, v, B, H, KV, Sq, Sk, causal, 0, q_off,
                                             st, stream);
}

// Both paths by dtype and D, after the entry points' checks.
int dispatch(void* out, const void* q, const void* k, const void* v, int dtype, int B, int H,
             int KV, int Sq, int Sk, int D, int causal, int window, int q_off,
             const int64_t* st, cudaStream_t stream) {
  if (dtype == 0) {
    if (D == 16) return launch<float, 16>(out, q, k, v, B, H, KV, Sq, Sk, causal, window, q_off, st, stream);
    if (D == 64) return launch<float, 64>(out, q, k, v, B, H, KV, Sq, Sk, causal, window, q_off, st, stream);
    if (D == 128)
      return launch<float, 128>(out, q, k, v, B, H, KV, Sq, Sk, causal, window, q_off, st, stream);
    if (D == 256)
      return launch<float, 256>(out, q, k, v, B, H, KV, Sq, Sk, causal, window, q_off, st, stream);
  } else if (dtype == 1) {
    if (D == 16) return launch_bf16<16>(out, q, k, v, B, H, KV, Sq, Sk, causal, window, q_off, st, stream);
    if (D == 64) return launch_bf16<64>(out, q, k, v, B, H, KV, Sq, Sk, causal, window, q_off, st, stream);
    if (D == 128)
      return launch_bf16<128>(out, q, k, v, B, H, KV, Sq, Sk, causal, window, q_off, st, stream);
    if (D == 256)
      return launch_bf16<256>(out, q, k, v, B, H, KV, Sq, Sk, causal, window, q_off, st, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point, loaded with ctypes. out, q: (B, H, Sq, D); k, v: (B, KV, Sk, D),
// device pointers of one type (dtype 0 = float32, 1 = bfloat16), the last dimension
// contiguous; `strides` holds 12 host int64 element strides (b, h, s) of out, q, k, v
// in that order. H % KV == 0, D in {16, 64, 128, 256} (the ported configs' head sizes),
// Sq, Sk >= 1. Causal: query row i sits at position q_off + i (q_off >= 0, q_off + Sq <=
// Sk; q_off > 0 is a sequence-parallel rank's rows against every key of the prefill,
// q_off = 0 with Sq == Sk the plain causal call); `window` 0 (none) or the keys each row
// sees (q_off + i - window < j <= q_off + i). Not causal: window and q_off 0. For bfloat16 the base pointers and strides are multiples of 16 bytes
// (TMA). float32 runs flash_fwd on the CUDA cores, bfloat16 flash_fwd_wgmma on the tensor
// cores. The launch goes on `stream` and does not synchronise. Returns the CUDA error
// after the launch (0 = launched).
extern "C" int flash_attention_fwd(void* out, const void* q, const void* k, const void* v,
                                   int dtype, int B, int H, int KV, int Sq, int Sk, int D,
                                   int causal, int window, int q_off, const int64_t* strides,
                                   cudaStream_t stream) {
  if (Sq < 1 || Sk < 1 || window < 0 || q_off < 0 || (!causal && (window > 0 || q_off > 0)) ||
      (causal && q_off + Sq > Sk))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(out, q, k, v, dtype, B, H, KV, Sq, Sk, D, causal, window, q_off, strides,
                  stream);
}

// Dynamic shared memory of the kernel that `dtype` and D select, in bytes (0 if none).
extern "C" int flash_attention_smem_bytes(int dtype, int D) {
  if (dtype == 0)
    return D == 16 ? smem_bytes<16>() : D == 64 ? smem_bytes<64>() : D == 128 ? smem_bytes<128>()
         : D == 256 ? smem_bytes<256>() : 0;
  if (dtype == 1)
    return D == 16 ? Layout<16>::kSmem : D == 64 ? Layout<64>::kSmem : D == 128 ? Layout<128>::kSmem
         : D == 256 ? Layout<256>::kSmem : 0;
  return 0;
}
