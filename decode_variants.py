#!/usr/bin/env python3
"""Where the flash-decode kernel's time goes, on one NVIDIA GPU.

Run from the repository root on a GPU host:  python3 decode_variants.py

Builds the kernel of src/repro_torch/kernels/decode_attention/csrc/ as it
is and two variants made from its source by text substitution, each from its
own copy under that module's (git-ignored) build/variants/:
  loads_only   — the tile loop waits for each tile and issues the next one,
                 but skips the arithmetic (its output is wrong): the time of
                 the TMA ring, the merge and the launch alone;
  compute_only — the arithmetic on whatever the ring holds, with no copies
                 after the first ones (its output is wrong): the time of the
                 arithmetic and the merge alone.
Each runs at the serve shape (B=4, H=16, KV=8, T=4352, D=128, pos 4,351,
bf16) with 4 to 8 splits, device time per call from CUDA-graph replay, beside
scaled_dot_product_attention and a plain streaming read of the same 71 MB of
K and V (the card's read rate for this data). Also prints, per split count,
the clusters of the kernel that fit on the card at once
(cudaOccupancyMaxActiveClusters): a (batch, kv head) is one cluster, so
fewer than B*KV of them means a second wave. One JSON line per result, then
the nvidia-smi line. Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPE = (4, 16, 8, 4352, 128)  # B, H, KV, T, D of the serve decode
POS = 4351
SPLITS = (4, 5, 6, 7, 8)
HBM_BYTES_PER_S = 3.35e12

# appended inside the source's anonymous namespace: the occupancy query and a
# streaming read (16-byte loads, grid-stride)
EXTRA = r'''
int max_clusters_impl(int n_splits, int KV, int B) {
  auto kern = decode_attn<__nv_bfloat16, 128, 2>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_splits, KV, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, (void*)kern, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}
__global__ void read_kernel(const uint4* __restrict__ p, long long n, unsigned* out) {
  unsigned x = 0;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const uint4 v = __ldg(p + i);
    x ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  if (x == 0x12345678u) out[0] = x;  // keeps the loads
}
int read_impl(const void* p, long long bytes, void* out, int blocks, cudaStream_t st) {
  read_kernel<<<blocks, 256, 0, st>>>(static_cast<const uint4*>(p), bytes / 16,
                                      static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
'''
EXTRA_C = '''
extern "C" int decode_max_clusters(int n, int KV, int B) { return max_clusters_impl(n, KV, B); }
extern "C" int stream_read(const void* p, long long bytes, void* out, int blocks,
                           cudaStream_t st) { return read_impl(p, bytes, out, blocks, st); }
'''
TILE_ARITHMETIC = "    const T* ks = stage0 + (i % kStages) * kStageElems;"
TILE_WAIT = "    mbar_wait(&full[i % kStages], (i / kStages) & 1);  // tile i has landed"
TILE_ISSUE = "    if (tid == 0 && nxt < n_tiles) {"


def _substitute(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"decode_variants: the kernel source no longer has {old.strip()!r}")
    return src.replace(old, new)


def variant_source(src: str, name: str) -> str:
    src = _substitute(src, "}  // namespace\n", EXTRA + "}  // namespace\n") + EXTRA_C
    if name == "loads_only":
        src = _substitute(src, TILE_ARITHMETIC, "    if (n_tiles > 0) continue;\n" + TILE_ARITHMETIC)
    elif name == "compute_only":
        src = _substitute(src, TILE_WAIT,
                          "    if (i < kStages - 1) mbar_wait(&full[i], 0);  // the first tiles")
        src = _substitute(src, TILE_ISSUE, "    if (false) {")
    return src


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("decode_variants: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.decode_attention import ref as dref

    base = dops._SRC.read_text()
    srcs = {}
    for name in ("kernel", "loads_only", "compute_only"):
        d = dops._SRC.parent.parent / "build" / "variants" / name / "csrc"
        d.mkdir(parents=True, exist_ok=True)
        srcs[name] = d / dops._SRC.name
        srcs[name].write_text(variant_source(base, name))
    with ThreadPoolExecutor(max_workers=len(srcs)) as pool:  # one nvcc per variant, at once
        libs = dict(zip(srcs, pool.map(_build.build_library, srcs.values())))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.decode_attention_fwd.argtypes = [ptr] * 5 + [i32] * 7 + [ptr, ptr]
        lib.decode_max_clusters.argtypes = [i32] * 3
        lib.stream_read.argtypes = [ptr, ctypes.c_longlong, ptr, i32, ptr]

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    B, H, KV, T, D = SHAPE
    q, k, v = cs._attn_inputs(*SHAPE, dtype=torch.bfloat16, seed=1)
    q = q[:, :, 0]
    pos = torch.tensor(POS, dtype=torch.int32, device="cuda")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def call(lib, n):
        out = torch.empty((B, H, D), dtype=q.dtype, device="cuda")
        st = (ctypes.c_int64 * 8)(*q.stride()[:2], *k.stride()[:3], *v.stride()[:3])
        err = lib.decode_attention_fwd(out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                       pos.data_ptr(), 1, B, H, KV, T, D, n,
                                       ctypes.cast(st, ptr), stream())
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return out

    got = call(libs["kernel"], dops.choose_splits(B, KV, torch.cuda.get_device_properties(0)
                                                  .multi_processor_count))
    d, ok = cs._gap(got, dref.decode_ref(q, k, v, pos), cs.ATTN_F32_TOL, ulp=True)
    if not ok:
        raise RuntimeError(f"decode_variants: the kernel disagrees with decode_ref ({d})")
    moved = 2 * B * KV * (POS + 1) * D * 2
    cs._emit({"shape": list(SHAPE), "pos": POS, "bytes_moved": moved,
              "bound_us": moved / HBM_BYTES_PER_S * 1e6, "kernel_max_abs_err": d,
              "max_active_clusters": {n: libs["kernel"].decode_max_clusters(n, KV, B)
                                      for n in SPLITS}})
    kb, vb = k.transpose(1, 2), v.transpose(1, 2)  # the contiguous (B, T, KV, D) caches
    sink = torch.zeros(4, dtype=torch.int32, device="cuda")
    mask = (torch.arange(T, device="cuda") <= POS)[None, None, None, :]
    for rnd in range(2):  # two rounds, in turns
        res = {"round": rnd}
        res["sdpa_us"] = cs._device_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask, enable_gqa=True))["ms"] * 1e3
        res["stream_read_k_and_v_us"] = cs._device_ms(lambda: [
            libs["kernel"].stream_read(t.data_ptr(), t.numel() * 2, sink.data_ptr(), 132 * 8,
                                       stream()) for t in (kb, vb)])["ms"] * 1e3
        for name, lib in libs.items():
            res[f"{name}_us"] = {n: cs._device_ms(lambda: call(lib, n))["ms"] * 1e3 for n in SPLITS}
        cs._emit(res)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
