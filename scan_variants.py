#!/usr/bin/env python3
"""Where the RWKV6 scan kernel's time goes, on one NVIDIA GPU.

Run from the repository root on a GPU host:  python3 scan_variants.py

Builds the kernel of src/repro_torch/kernels/linear_scan/csrc/ as it is and
variants made from its source by text substitution, each from its own copy
under that module's (git-ignored) build/variants/:
  16x1, 8x1       — other splits of the 64 x 64 state over a block's threads
                    (rows x columns a thread holds; the kernel holds 8 x 2):
                    256 and 512 threads a (batch, head);
  4x4             — 4 x 4 a thread, 256 threads, two r/k/w loads in three
                    saved and twice the partials; its ring holds two chunks,
                    not three, so that two blocks still fit an SM;
  steps_only      — the 16-step chunks' steps and barriers, with the chunk
                    phases' work (summing the readout partials, converting the
                    next chunk) skipped: the steps run on whatever the stage
                    holds;
  steps_registers — the same with each step's r, k and w taken from registers
                    instead of shared memory: the FP32 instruction stream, the
                    v load and the partial's store;
  phases_only     — the TMA ring and the chunk phases with no steps.
The splits compute the recurrence and are held to the chunked plain version
within chip_smoke.py's SCAN_TOL; the last three give wrong outputs and only
their times mean something. Each copy also gets a C function that reports
its threads, dynamic shared memory and the blocks an SM holds
(cudaOccupancyMaxActiveBlocksPerMultiprocessor). Each runs at the serve shape
(B=4, T=4096, H=64, K=64, bf16), device time per call from CUDA-graph
replay, in two rounds in turns, beside the instruction floor of the step
form: three FP32 instructions per state element and step at 132 SMs x 128
lanes x 1.98 GHz. One JSON line for the build, one per round, then the
nvidia-smi line. Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPE = (4, 4096, 64, 64)  # B, T, H, K of the serve prefill
B_, T_, H_, K_ = SHAPE
INSTRUCTION_FLOOR_MS = 3 * B_ * T_ * H_ * K_ * K_ / (132 * 128 * 1.98e9) * 1e3

RT, CT, RING = "constexpr int kRT = 8;", "constexpr int kCT = 2;", "constexpr int kRing = 3;"
SPLITS = {  # name: (rows, columns, ring chunks)
    "16x1": (16, 1, 3), "8x1": (8, 1, 3), "4x4": (4, 4, 2),
}
REDUCE = "      if (t < T_len) {\n        const float* pp = part"
CONVERT = "        in.convert(ring[(c + 1) % kRing], st, tail[(c + 1) & 1], c + 1, tid, u4);"
STEP_LOOP = "#pragma unroll 2\n    for (int s = 0; s < n; ++s) {"
STEP_LOADS = ("        const float4 rr = load4(&st.r[s][i0 + i]);\n"
              "        const float4 kk = load4(&st.k[s][i0 + i]);\n"
              "        const float4 ww = load4(&st.w[s][i0 + i]);")
STEP_REGISTERS = ("        const float4 rr = make_float4(vj[0], vj[kCT - 1], 0.5f, 0.25f);\n"
                  "        const float4 kk = rr, ww = rr;")
OCCUPANCY = """
namespace {
template <typename T>
int occupancy_of(int* threads, int* smem_bytes) {
  *threads = kThreads;
  *smem_bytes = Layout<T>::kBytes;
  auto kernel = rwkv6_scan_kernel<T>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Layout<T>::kBytes) != cudaSuccess)
    return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads,
                                                    Layout<T>::kBytes) != cudaSuccess)
    return -1;
  return blocks;
}
}  // namespace

extern "C" int rwkv6_scan_occupancy(int dtype, int* threads, int* smem_bytes) {
  return dtype == 0 ? occupancy_of<float>(threads, smem_bytes)
                    : occupancy_of<__nv_bfloat16>(threads, smem_bytes);
}
"""
VARIANTS = ("kernel", *SPLITS, "steps_only", "steps_registers", "phases_only")


def _substitute(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"scan_variants: the kernel source no longer has {old.strip()!r}")
    return src.replace(old, new)


def variant_source(src: str, name: str) -> str:
    if name in SPLITS:
        rows, cols, ring = SPLITS[name]
        src = _substitute(src, RT, RT.replace("8", str(rows)))
        src = _substitute(src, CT, CT.replace("2", str(cols)))
        src = _substitute(src, RING, RING.replace("3", str(ring)))
    if name in ("steps_only", "steps_registers"):
        src = _substitute(src, REDUCE, REDUCE.replace("if (t < T_len)", "if (false)"))
        src = _substitute(src, CONVERT, "        ;")
    if name == "steps_registers":
        src = _substitute(src, STEP_LOADS, STEP_REGISTERS)
    if name == "phases_only":
        src = _substitute(src, STEP_LOOP, STEP_LOOP.replace("s < n", "s < 0"))
    return src + OCCUPANCY


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("scan_variants: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.linear_scan import ops as sops
    from repro_torch.kernels.linear_scan import ref as sref

    base = sops._SRC.read_text()
    srcs = {}
    for name in VARIANTS:
        d = sops._SRC.parent.parent / "build" / "variants" / name / "csrc"
        d.mkdir(parents=True, exist_ok=True)
        srcs[name] = d / sops._SRC.name
        srcs[name].write_text(variant_source(base, name))
    with ThreadPoolExecutor(max_workers=len(srcs)) as pool:  # one nvcc per variant, at once
        list(pool.map(_build.build_library, srcs.values()))

    def use(name):  # point the wrapper at a variant's library
        sops._lib, sops._SRC = None, srcs[name]
        return sops.build()

    B, T, H, K = SHAPE
    r, k, v, logw, u, _ = cs._scan_inputs(B, T, H, torch.bfloat16, seed=0)
    want = sref.rwkv6_chunked(r, k, v, logw, u, 16)
    built = {"shape": list(SHAPE), "instruction_floor_ms": INSTRUCTION_FLOOR_MS}
    for name in VARIANTS:
        lib = use(name)
        lib.rwkv6_scan_occupancy.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        lib.rwkv6_scan_occupancy.restype = ctypes.c_int
        facts = {}
        for dtype, tag in ((0, "float32"), (1, "bfloat16")):
            threads, smem = ctypes.c_int(), ctypes.c_int()
            blocks = lib.rwkv6_scan_occupancy(dtype, ctypes.byref(threads), ctypes.byref(smem))
            facts[tag] = {"threads": threads.value, "warps": threads.value // 32,
                          "smem_bytes": smem.value, "blocks_per_sm": blocks,
                          "warps_per_sm": blocks * threads.value // 32}
        if name in ("kernel", *SPLITS):  # complete kernels: hold them to the plain version
            got, got_s = sops.rwkv6_scan(r, k, v, logw, u, 16)
            _, d_rel, ok = cs._scan_gap(got, got_s, *want)
            if not ok:
                raise RuntimeError(f"scan_variants: {name} disagrees with rwkv6_chunked ({d_rel})")
            facts["max_over_scale"] = d_rel
        built[name] = facts
    cs._emit(built)
    for rnd in range(2):  # two rounds, in turns
        res = {"round": rnd}
        for name in VARIANTS:
            use(name)
            res[f"{name}_ms"] = cs._device_ms(
                lambda: sops.rwkv6_scan(r, k, v, logw, u, 16), 5, 3)["ms"]
        cs._emit(res)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
