#!/usr/bin/env python3
"""The int8 aggregation kernel at each lane width, on one NVIDIA GPU.

Run from the repository root on a GPU host:  python3 aggregate_variants.py

The quantized aggregation kernel of
src/repro_torch/kernels/ipls_aggregate/csrc/ gives each thread L adjacent
lanes; the wrapper picks L = 8, 4 or 1 from S and the pointers' alignment
(ops.choose_lanes). This script builds a copy of the source, under that
module's (git-ignored) build/variants/, with a 16-lane width added by text
substitution, and calls its C entry point at every width, 16, 8, 4 and 1, on
the main_int8 path's shape (K=20, R=198, S=45056): each width against the
plain version, bit for bit, then its device time per call from CUDA-graph
replay, in two rounds in turns, beside the bound (bytes at 3.35 TB/s). One
JSON line per round, then the nvidia-smi line. Imports nothing of JAX or of
the JAX package.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WIDTHS = (16, 8, 4, 1)

CODES8 = "template <>\nstruct Codes<8> {"
CODES16 = """template <>
struct Codes<16> {
  uint4 v;
  __device__ __forceinline__ void load(const int8_t* p) { v = __ldg(reinterpret_cast<const uint4*>(p)); }
  __device__ __forceinline__ uint32_t word(int i) const { return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w; }
};
"""
CASE8 = "    case 8:\n"
CASE16 = ("    case 16:\n"
          "      return launch_q<16>(out, w, own, q, scales, mask, own_mask, eps, K, R, S, NB, stream);\n")


def _substitute(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise RuntimeError(f"aggregate_variants: the source no longer has one {old.strip()!r}")
    return src.replace(old, new)


def variant_source(src: str) -> str:
    src = _substitute(src, CODES8, CODES16 + CODES8)
    return _substitute(src, CASE8, CASE16 + CASE8)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("aggregate_variants: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.ipls_aggregate import ops, ref
    from repro_torch.kernels.quantize.ref import num_blocks

    d = ops._SRC.parent.parent / "build" / "variants" / "lanes16" / "csrc"
    d.mkdir(parents=True, exist_ok=True)
    src = d / ops._SRC.name
    src.write_text(variant_source(ops._SRC.read_text()))
    lib = _build.build_library(src)
    fn = lib.ipls_aggregate_batched_q_f32
    fn.argtypes = ops.build().ipls_aggregate_batched_q_f32.argtypes
    fn.restype = ops.build().ipls_aggregate_batched_q_f32.restype

    K, R, S = cs.MAIN_Q_SHAPE
    args = cs._agg_q_inputs(K, R, S, seed=9)
    w, own, q = args[:3]
    out = torch.empty_like(w)
    want = ref.ipls_aggregate_batched_q_ref(*args)

    def call(lanes):  # repro: noqa[KW02] a variant library's launch, timed beside the wrapper's
        _build.launch("ipls_aggregate_batched_q", fn, out.data_ptr(),
                      *(t.data_ptr() for t in args), K, R, S, num_blocks(S), lanes,
                      device=w.device)
        return out

    for lanes in WIDTHS:
        call(lanes)
        torch.cuda.synchronize()
        if not cs._bits_equal(out, want):
            raise RuntimeError(f"aggregate_variants: {lanes} lanes differ from the plain version")
    nbytes = K * R * S + K * R * num_blocks(S) * 4 + 3 * K * S * 4 + K * R * 4 + 2 * K * 4
    head = {"shape": [K, R, S], "bound_ms": nbytes / cs.HBM_BYTES_PER_S * 1e3,
            "wrapper_lanes": ops.choose_lanes(S, w, own, q), "bitwise": True}
    cs._emit(head)
    for rnd in range(2):  # two rounds, in turns
        cs._emit({"round": rnd, "ms_by_lanes": {
            lanes: cs._device_ms(lambda: call(lanes))["ms"] for lanes in WIDTHS}})
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
