// Flash-decode for Hopper (sm_90a), hand-written CUDA C++: one new query per (batch,
// head) against a KV cache, keys 0..pos.
//
// Replaces the Pallas TPU kernel decode_attention
// (src/repro/kernels/decode_attention/decode_attention.py:67, body _kernel, with the
// GQA repeat of its ops.py):
//
//   s_t = (q . k_t) / sqrt(D) for t <= min(pos, T-1), finfo(float32).min after it
//   o = sum_t softmax(s)_t v_t
//
// in float32, the output cast to the input type at the end, l clamped at 1e-30.
//
// Bound: bytes. A step reads the keys and values up to pos once, 2*B*KV*(pos+1)*D
// elements (71 MB in bf16 at B=4, KV=8, pos=4351, D=128: 21.3 us at 3.35 TB/s). The
// arithmetic is G/2 FMAs a byte (G = H/KV query heads share each key and value): at
// G = 8 and 3.35 TB/s that is 13.4 TFMA/s, 40% of the CUDA cores' 33.5 TFMA/s (67
// TFLOP/s float32), at the served G = 2 a tenth of it. The tensor cores are not needed:
// a product of G <= 8 rows would fill at most 8 of wgmma's 64, and the scores stay in
// float32 as the TPU kernel keeps them.
//
// Design. The TPU kernel walked the cache as a sequential grid (B, H, blocks of 256
// keys) with the softmax state in VMEM. Here one launch covers a step:
// - One thread-block cluster per (batch, kv head): the grid is (n_splits, KV, B) with
//   cluster dims (n_splits, 1, 1), n_splits <= 8 chosen by the wrapper from the SM count
//   and B*KV so that the card fills in about one wave. The grid depends only on the
//   shapes and the card, so a CUDA graph of the decode step replays it at any pos.
// - CTA s of a cluster takes the balanced key range [floor(n*s/S), floor(n*(s+1)/S)) of
//   the n = min(pos, T-1) + 1 valid keys, S = n_splits, computed from pos, which it reads
//   from device memory (no host sync). A split with no keys leaves m = -FLT_MAX, l = 0,
//   acc = 0. The CTA serves all G query heads of its kv head, so K and V are read once.
// - A 3-stage ring in dynamic shared memory, fed by TMA: each stage holds the K and the V
//   rows of the same tile of keys (16 KB each: 64 keys of bf16 at D = 128, 32 at D = 256,
//   whose 16-row boxes of 256 columns are at TMA's box limit). One thread
//   issues the tile as 16-row boxes of 4-D tensor maps (D, T, KV, B) over the caller's
//   strides, so the model's (B, T, KV, D) cache goes in as its (B, KV, T, D) view with no
//   copy; an mbarrier a stage counts the bytes in. Two stages (64 KB) are in flight while
//   one is consumed: by Little's law 3.35 TB/s at about 1 us of latency needs about 25 KB
//   an SM. (A ring of 16-byte cp.async copies issued by every thread moved fewer bytes
//   a second on an H100 than these few large copies.) The maps are encoded once per
//   cache tensor and kept (cache_map): a decode step that passes the same cache encodes
//   nothing. One __syncthreads a tile frees a stage.
// - One pass, an online softmax, on the CUDA cores. A key row is D/V 16-byte chunks (V
//   values each); a lane owns CPL of them (2 at G <= 2, else 1, for registers; at least
//   D/(32 V), so that a key spans at most one warp: 2 for float32 at D = 256), so a
//   "key group" of LPK = D/(V*CPL) lanes shares a key and takes keys grp, grp + NG, ...
//   of each tile. Each lane holds its slices of the G queries in registers, widens its
//   slices of K to float32 and FMAs; the group sums its lanes with xor shuffles. Scores
//   are in base 2 (scale*log2(e) folded in, p = 2^(s - m) on the SFU). The group keeps
//   its own running (m, l) per query head and its slices of acc[G][D], rescales them
//   only when the max moves, and adds p * v from the same keys' V rows. Accumulators are
//   sized by kG, G rounded up to 1, 2, 4 or 8: 32 floats a lane at the served G = 2.
// - Sliding windows need no mask here: a window layer's cache is a ring of T = window
//   slots written at pos % T, and "keys 0..pos, all of them once pos >= T" is the
//   reference's ring mask (every slot valid once the ring has wrapped).
// - The merge. Each warp merges its key groups with xor shuffles (a fixed tree), the
//   warps of a CTA merge in shared memory (the ring, no longer needed) in warp order,
//   and the CTA leaves (m[G], l[G], acc[G][D]) in shared memory; the cluster syncs. Rank
//   r reads every peer's values through distributed shared memory
//   (cluster.map_shared_rank), merges them in rank order, so that the result is the same
//   run to run, and writes output columns [D*r/S, D*(r+1)/S) of the G heads. A second
//   cluster sync keeps every CTA alive until its peers have read it. No global scratch,
//   no second launch.
// - The partial form (decode_attention_partial_fwd), for a cache split over the sequence
//   among the ranks of a context-parallel decode: local slot j holds global key
//   slot0 + j, so the valid keys are n = min(pos - slot0, T-1) + 1 (none when pos <
//   slot0: every split is empty, no tile is loaded, the output is 0). It writes the
//   normalised output in float32 and, from rank 0 of the cluster, the log-sum-exp of the
//   scaled scores, ln 2 * (M + log2 l) in the merge's base-2 terms, -inf for an empty
//   slice, so that the ranks' partials merge by it. slot0 = 0 without the log-sum-exp is
//   the plain call, bit for bit.
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <unordered_map>

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums (types only: the encoder comes from the runtime)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;           // query heads per kv head
constexpr int kMaxSplits = 8;      // the portable cluster size
constexpr int kTileBytes = 16384;  // K (and V) bytes of one tile
constexpr int kStages = 3;
constexpr int kBoxRows = 16;       // key rows of one TMA copy
constexpr int kRingBytes = kStages * 2 * kTileBytes;
constexpr int kSmemBytes = kRingBytes + 128;  // the ring, and slack to align it to 128 bytes
constexpr float kNegInf = -FLT_MAX;  // finfo(float32).min, the TPU kernel's mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// 2^x on the SFU (relative error about 2^-22); 2^(-huge) is 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// one 16-byte shared-memory load of 4 float32 or 8 bfloat16 values, as float32
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}
// a bfloat16 is the top half of a float32: element 2i is the low half of word i
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
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

// How a CTA cuts a tile. A key row is D/V 16-byte chunks; a lane owns CPL of them
// (chunks part, part + LPK, ...), so LPK lanes share a key: a "key group". Two chunks a
// lane at kG <= 2 (fewer shuffles and exponentials a key), one above (registers), but
// enough that a key's lanes fit in one warp (float32 rows of 256 are 64 chunks).
template <typename T, int D, int kG>
struct Shape {
  static constexpr int V = 16 / static_cast<int>(sizeof(T));  // values per 16-byte chunk
  static constexpr int ROW = D / V;                            // chunks per key row
  static constexpr int CPL0 = (kG <= 2 && ROW >= 2) ? 2 : 1;
  static constexpr int CPL = ROW / CPL0 > 32 ? ROW / 32 : CPL0;  // chunks per lane
  static constexpr int LPK = ROW / CPL;                        // lanes per key
  static constexpr int NG = kWarps * (32 / LPK);               // key groups per CTA
  static constexpr int KT = kTileBytes / (D * static_cast<int>(sizeof(T)));  // keys per tile
  static constexpr int KPG = KT / NG;                          // keys per group per tile
  static_assert(LPK <= 32 && KPG >= 1 && KPG * NG == KT && KT % kBoxRows == 0,
                "tile does not split evenly");
};

// one thread: copies the K and V rows [t0, t0 + nk) of one tile into a ring stage, in
// boxes of kBoxRows rows (the last box may read rows past nk, or past T as zeros)
template <typename T, int D>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const CUtensorMap* km,
                                          const CUtensorMap* vm, int t0, int nk, int kvh, int b,
                                          uint64_t* full) {
  const int n_box = (nk + kBoxRows - 1) / kBoxRows;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // after the generic reads
  mbar_expect_tx(full, 2u * n_box * kBoxRows * D * sizeof(T));
  for (int j = 0; j < n_box; ++j) {
    tma_load_4d(ks + j * kBoxRows * D, km, full, 0, t0 + j * kBoxRows, kvh, b);
    tma_load_4d(vs + j * kBoxRows * D, vm, full, 0, t0 + j * kBoxRows, kvh, b);
  }
}

template <typename T, int D, int kG>
__global__ void __launch_bounds__(kThreads)
decode_attn(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
            T* __restrict__ out, const T* __restrict__ q, const int* __restrict__ pos_p,
            int64_t sqb, int64_t sqh, int H, int G, int T_len, float scale_log2, int slot0,
            float* __restrict__ out32, float* __restrict__ lse_out) {
  using S = Shape<T, D, kG>;
  constexpr int V = S::V, CPL = S::CPL, LPK = S::LPK, NG = S::NG, KT = S::KT, KPG = S::KPG;
  extern __shared__ unsigned char smem_raw[];
  // aligned to 128 bytes for TMA by an offset from smem_raw, so that the compiler still
  // sees shared memory (shared-memory loads, not generic ones)
  unsigned char* ring = smem_raw + ((128u - (smem_u32(smem_raw) & 127u)) & 127u);
  __shared__ __align__(8) uint64_t full[kStages];  // one mbarrier a stage: its tile landed
  __shared__ float ex_ml[kG][2];  // this CTA's (m, l) per head, read by its peers
  __shared__ float ex_acc[kG][D];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, n_splits = gridDim.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int part = lane % LPK, grp = warp * (32 / LPK) + lane / LPK;
  const int h0 = kvh * G;

  // this split's balanced share of local keys 0..min(pos - slot0, T-1)
  const int64_t n_keys = max(min(*pos_p - slot0, T_len - 1), -1) + 1;
  const int lo = static_cast<int>(n_keys * split / n_splits);
  const int hi = static_cast<int>(n_keys * (split + 1) / n_splits);
  const int n_tiles = (hi - lo + KT - 1) / KT;
  T* stage0 = reinterpret_cast<T*>(ring);
  constexpr int kStageElems = 2 * kTileBytes / static_cast<int>(sizeof(T));

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < kStages - 1 && s < n_tiles; ++s) {
      T* ks = stage0 + s * kStageElems;
      load_tile<T, D>(ks, ks + KT * D, &kmap, &vmap, lo + s * KT, min(KT, hi - lo - s * KT),
                      kvh, b, &full[s]);
    }
  }

  // this lane's chunks of the G queries, as float32; scores in base 2:
  // s = (q . k) / sqrt(D) * log2(e), p = 2^(s - m)
  float qr[kG][CPL][V];
#pragma unroll
  for (int g = 0; g < kG; ++g)
#pragma unroll
    for (int c = 0; c < CPL; ++c)
#pragma unroll
      for (int e = 0; e < V; ++e)
        qr[g][c][e] =
            g < G ? to_f32(q[b * sqb + (h0 + g) * sqh + (part + c * LPK) * V + e]) : 0.0f;
  float m[kG], l[kG], acc[kG][CPL][V];
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
#pragma unroll
      for (int e = 0; e < V; ++e) acc[g][c][e] = 0.0f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    mbar_wait(&full[i % kStages], (i / kStages) & 1);  // tile i has landed
    __syncthreads();  // and every thread is done with tile i - 1: its stage is free
    const int nxt = i + kStages - 1;
    if (tid == 0 && nxt < n_tiles) {
      T* ks = stage0 + (nxt % kStages) * kStageElems;
      load_tile<T, D>(ks, ks + KT * D, &kmap, &vmap, lo + nxt * KT,
                      min(KT, hi - lo - nxt * KT), kvh, b, &full[nxt % kStages]);
    }

    const T* ks = stage0 + (i % kStages) * kStageElems;
    const T* vs = ks + KT * D;
    const int nk = min(KT, hi - lo - i * KT);
    float s[KPG][kG];
#pragma unroll
    for (int j = 0; j < KPG; ++j) {
      const int kk = grp + j * NG;
#pragma unroll
      for (int g = 0; g < kG; ++g) s[j][g] = 0.0f;
      if (kk < nk) {
        float dot[CPL][kG];  // one chain a chunk, summed at the end
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          float kv[V];
          load16(ks + kk * D + (part + c * LPK) * V, kv);
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            dot[c][g] = 0.0f;
#pragma unroll
            for (int e = 0; e < V; ++e) dot[c][g] = fmaf(qr[g][c][e], kv[e], dot[c][g]);
          }
        }
#pragma unroll
        for (int g = 0; g < kG; ++g)
#pragma unroll
          for (int c = 0; c < CPL; ++c) s[j][g] += dot[c][g];
      }
    }
    // the group's sums: xor shuffles inside its LPK aligned lanes (every lane takes part)
#pragma unroll
    for (int j = 0; j < KPG; ++j)
#pragma unroll
      for (int g = 0; g < kG; ++g)
        if (g < G) {
#pragma unroll
          for (int off = LPK / 2; off > 0; off >>= 1)
            s[j][g] += __shfl_xor_sync(0xffffffffu, s[j][g], off);
          s[j][g] *= scale_log2;
        }
    if (grp < nk) {  // the group has keys in this tile; key j is valid if grp + j*NG < nk
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        float m_new = m[g];
#pragma unroll
        for (int j = 0; j < KPG; ++j)
          if (grp + j * NG < nk) m_new = fmaxf(m_new, s[j][g]);
        if (g < G && m_new > m[g]) {  // rescale only when the max moves (alpha = 1 else)
          const float alpha = exp2_approx(m[g] - m_new);
          l[g] *= alpha;
#pragma unroll
          for (int c = 0; c < CPL; ++c)
#pragma unroll
            for (int e = 0; e < V; ++e) acc[g][c][e] *= alpha;
          m[g] = m_new;
        }
      }
#pragma unroll
      for (int j = 0; j < KPG; ++j) {
        if (grp + j * NG < nk) {
          float p[kG];
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            p[g] = g < G ? exp2_approx(s[j][g] - m[g]) : 0.0f;
            l[g] += p[g];
          }
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            float vv[V];
            load16(vs + (grp + j * NG) * D + (part + c * LPK) * V, vv);
#pragma unroll
            for (int g = 0; g < kG; ++g)
#pragma unroll
              for (int e = 0; e < V; ++e) acc[g][c][e] = fmaf(p[g], vv[e], acc[g][c][e]);
          }
        }
      }
    }
  }
  __syncthreads();  // every tile has landed and been consumed: the ring holds the warps' states

  // merge the key groups of each warp: xor shuffles across groups (a fixed tree), with
  // weights 2^(m_grp - M_warp); then the warps in shared memory, in warp order
  float* w_m = reinterpret_cast<float*>(ring);  // [kWarps][kG]
  float* w_l = w_m + kWarps * kG;               // [kWarps][kG]
  float* w_w = w_l + kWarps * kG;               // [kWarps][kG]
  float* w_acc = w_w + kWarps * kG;             // [kWarps][kG][D]
  static_assert((3 + D) * kWarps * kG * 4 <= kRingBytes, "warp states exceed the ring");
#pragma unroll
  for (int g = 0; g < kG; ++g) {
    if (g < G) {
      float mw = m[g];
#pragma unroll
      for (int off = LPK; off < 32; off <<= 1) mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, off));
      const float w = exp2_approx(m[g] - mw);
      float lw = l[g] * w;
#pragma unroll
      for (int off = LPK; off < 32; off <<= 1) lw += __shfl_xor_sync(0xffffffffu, lw, off);
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int e = 0; e < V; ++e) {
          float a = acc[g][c][e] * w;
#pragma unroll
          for (int off = LPK; off < 32; off <<= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
          if (lane < LPK) w_acc[(warp * kG + g) * D + (part + c * LPK) * V + e] = a;
        }
      if (lane == 0) {
        w_m[warp * kG + g] = mw;
        w_l[warp * kG + g] = lw;
      }
    }
  }
  __syncthreads();
  if (warp < G) {  // warp g: M, the weights and l of head g
    const int g = warp;
    const float mw = lane < kWarps ? w_m[lane * kG + g] : kNegInf;
    float mx = mw;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float w = exp2_approx(mw - mx);
    float sum = lane < kWarps ? w_l[lane * kG + g] * w : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane < kWarps) w_w[lane * kG + g] = w;
    if (lane == 0) {
      ex_ml[g][0] = mx;
      ex_ml[g][1] = sum;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    float a = 0.0f;
#pragma unroll
    for (int r = 0; r < kWarps; ++r) a = fmaf(w_acc[(r * kG + g) * D + d], w_w[r * kG + g], a);
    ex_acc[g][d] = a;
  }
  cluster.sync();  // every CTA of the cluster has left its (m, l, acc)

  // rank r merges the splits, in rank order, for output columns [D*r/S, D*(r+1)/S)
  const int rank = static_cast<int>(cluster.block_rank());
  const int c0 = D * rank / n_splits, nc = D * (rank + 1) / n_splits - c0;
  for (int idx = tid; idx < G * nc; idx += kThreads) {
    const int g = idx / nc, d = c0 + idx % nc;
    float mx = kNegInf;
    for (int r = 0; r < n_splits; ++r) mx = fmaxf(mx, cluster.map_shared_rank(&ex_ml[g][0], r)[0]);
    float lsum = 0.0f, a = 0.0f;
    for (int r = 0; r < n_splits; ++r) {
      const float* ml = cluster.map_shared_rank(&ex_ml[g][0], r);
      const float w = exp2_approx(ml[0] - mx);
      lsum = fmaf(ml[1], w, lsum);
      a = fmaf(cluster.map_shared_rank(&ex_acc[g][0], r)[d], w, a);
    }
    const int64_t o = (static_cast<int64_t>(b) * H + h0 + g) * D + d;
    if (out32 != nullptr) {
      out32[o] = a / fmaxf(lsum, 1e-30f);
      if (lse_out != nullptr && d == 0)  // rank 0's first column: once per head
        lse_out[static_cast<int64_t>(b) * H + h0 + g] =
            lsum > 0.0f ? (mx + log2f(lsum)) * 0.69314718055994531f : __int_as_float(0xff800000u);  // -inf
    } else {
      store(out + o, a / fmaxf(lsum, 1e-30f));
    }
  }
  cluster.sync();  // no CTA exits while a peer may still read its shared memory
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

// What a cache's tensor map encodes: base, element size, dims (D, T, KV, B), strides.
struct MapKey {
  int64_t f[9];
  bool operator==(const MapKey& o) const { return std::memcmp(f, o.f, sizeof(f)) == 0; }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    uint64_t h = 1469598103934665603ull;
    for (int64_t x : k.f) h = (h ^ static_cast<uint64_t>(x)) * 1099511628211ull;
    return static_cast<size_t>(h);
  }
};

// The tensor map of a (B, KV, T, D) cache view with element strides st = (b, h, t), boxes
// of (D, kBoxRows, 1, 1). Encoded once and kept: a model passes the same cache tensors
// every decode step, so a step looks its maps up and encodes none.
bool cache_map(CUtensorMap* map, const void* base, int elem, int D, int T_len, int KV, int B,
               const int64_t* st) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> maps;
  const MapKey key{{reinterpret_cast<int64_t>(base), elem, D, T_len, KV, B, st[0], st[1], st[2]}};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = maps.find(key);
  if (it != maps.end()) {
    *map = it->second;
    return true;
  }
  const EncodeTiled fn = tensor_map_encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(T_len),
                              static_cast<cuuint64_t>(KV), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2] * elem),
                                 static_cast<cuuint64_t>(st[1] * elem),
                                 static_cast<cuuint64_t>(st[0] * elem)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(D), kBoxRows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  if (fn(map, elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
         const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (maps.size() >= 4096) maps.clear();  // bound the cache; any map is re-encoded on demand
  maps.emplace(key, *map);
  return true;
}

// the partial form's extras: global index of local slot 0, the float32 output and the
// log-sum-exp (nullptr for the plain call)
struct Partial {
  int slot0;
  float* out32;
  float* lse;
};

template <typename T, int D, int kG>
int launch(void* out, const void* q, const void* k, const void* v, const int* pos, int B,
           int H, int KV, int T_len, int n_splits, const int64_t* st, cudaStream_t stream,
           Partial part) {
  auto kernel = decode_attn<T, D, kG>;
  static unsigned sized = 0;  // devices on which the ring's shared memory was allowed
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 32 || !(sized >> dev & 1u)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 32) sized |= 1u << dev;
  }
  constexpr int elem = static_cast<int>(sizeof(T));
  CUtensorMap kmap, vmap;
  if (!cache_map(&kmap, k, elem, D, T_len, KV, B, st + 2) ||
      !cache_map(&vmap, v, elem, D, T_len, KV, B, st + 5))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(n_splits);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_splits, KV, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float scale_log2 = static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D)));
  err = cudaLaunchKernelEx(&cfg, kernel, kmap, vmap, static_cast<T*>(out),
                           static_cast<const T*>(q), pos, st[0], st[1], H, H / KV,
                           T_len, scale_log2, part.slot0, part.out32, part.lse);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dispatch_g(void* out, const void* q, const void* k, const void* v, const int* pos, int B,
               int H, int KV, int T_len, int n_splits, const int64_t* st, cudaStream_t stream,
               Partial p) {
  const int G = H / KV;  // accumulators for 1, 2, 4 or 8 heads: G rounded up
  if (G == 1) return launch<T, D, 1>(out, q, k, v, pos, B, H, KV, T_len, n_splits, st, stream, p);
  if (G == 2) return launch<T, D, 2>(out, q, k, v, pos, B, H, KV, T_len, n_splits, st, stream, p);
  if (G <= 4) return launch<T, D, 4>(out, q, k, v, pos, B, H, KV, T_len, n_splits, st, stream, p);
  return launch<T, D, 8>(out, q, k, v, pos, B, H, KV, T_len, n_splits, st, stream, p);
}

template <typename T>
int dispatch_d(void* out, const void* q, const void* k, const void* v, const int* pos, int B,
               int H, int KV, int T_len, int D, int n_splits, const int64_t* st,
               cudaStream_t stream, Partial p) {
  switch (D) {
    case 16: return dispatch_g<T, 16>(out, q, k, v, pos, B, H, KV, T_len, n_splits, st, stream, p);
    case 64: return dispatch_g<T, 64>(out, q, k, v, pos, B, H, KV, T_len, n_splits, st, stream, p);
    case 128:
      return dispatch_g<T, 128>(out, q, k, v, pos, B, H, KV, T_len, n_splits, st, stream, p);
    case 256:
      return dispatch_g<T, 256>(out, q, k, v, pos, B, H, KV, T_len, n_splits, st, stream, p);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int dispatch(void* out, const void* q, const void* k, const void* v, const int* pos, int dtype,
             int B, int H, int KV, int T_len, int D, int n_splits, const int64_t* strides,
             cudaStream_t stream, Partial p) {
  if (H % KV != 0 || H / KV > kMaxG || n_splits < 1 || n_splits > kMaxSplits || T_len < 1 ||
      p.slot0 < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch_d<float>(out, q, k, v, pos, B, H, KV, T_len, D, n_splits, strides, stream, p);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(out, q, k, v, pos, B, H, KV, T_len, D, n_splits, strides,
                                     stream, p);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point, loaded with ctypes. out: (B, H, D) contiguous; q: (B, H, D);
// k, v: (B, KV, T, D), device pointers of one type (dtype 0 = float32, 1 = bfloat16),
// the last dimension contiguous, k and v 16-byte aligned with 16-byte aligned strides;
// `strides` holds 8 host int64 element strides: q (b, h), k (b, h, t), v (b, h, t).
// pos is one device int32 (keys 0..pos are attended; pos >= T means all).
// H % KV == 0, H / KV <= 8, D in {16, 64, 128, 256}, T >= 1, 1 <= n_splits <= 8 (the CTAs of
// each (batch, kv head), one cluster). One launch on `stream`, no synchronisation.
// Returns the CUDA error of the launch (0 = launched).
extern "C" int decode_attention_fwd(void* out, const void* q, const void* k, const void* v,
                                    const int* pos, int dtype, int B, int H, int KV, int T_len,
                                    int D, int n_splits, const int64_t* strides,
                                    cudaStream_t stream) {
  return dispatch(out, q, k, v, pos, dtype, B, H, KV, T_len, D, n_splits, strides, stream,
                  Partial{0, nullptr, nullptr});
}

// The partial form: as decode_attention_fwd, but local slot j of k and v is global key
// slot0 + j (slot0 >= 0, a host int), keys with global index <= pos attended; out32:
// (B, H, D) float32 contiguous, the slice's normalised output (0 where no key is valid);
// lse: (B, H) float32 contiguous, the log-sum-exp of the slice's scaled scores (-inf
// where no key is valid).
extern "C" int decode_attention_partial_fwd(float* out32, float* lse, const void* q,
                                            const void* k, const void* v, const int* pos,
                                            int slot0, int dtype, int B, int H, int KV,
                                            int T_len, int D, int n_splits,
                                            const int64_t* strides, cudaStream_t stream) {
  return dispatch(nullptr, q, k, v, pos, dtype, B, H, KV, T_len, D, n_splits, strides, stream,
                  Partial{slot0, out32, lse});
}

// Dynamic shared memory of every instantiation (the TMA ring and its alignment), in bytes.
extern "C" int decode_attention_smem_bytes() { return kSmemBytes; }
