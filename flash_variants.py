#!/usr/bin/env python3
"""What the sliding window costs the flash kernel, on one NVIDIA GPU.

Run from the repository root on a GPU host:

    python3 flash_variants.py [--other PATH/flash_attention.cu]

Builds the bf16 flash kernel of src/repro_torch/kernels/flash_attention/
csrc/ as it is and a variant made from its source by text substitution,
each from its own copy under that module's (git-ignored) build/variants/:
  kernel          — as built: the window-free instance (kWindow = false)
                    serves windowless calls, the window folded away;
  runtime_window  — the window a run-time value in every instance (the
                    design before kWindow).
With ``--other``, a flash_attention.cu of another commit too (its C entry
point with or without the window argument, with one sequence length or with
the query's and the keys' apart, with or without the query offset; left out
at a head size it refuses), for a comparison in one call.
Each runs the full causal attention at the served shapes of earlier slices
(B=4, S=4096, bf16: H=16, KV=8, D=128 of ``serve``; H=24, KV=8, D=64 of
``serve_moe``) and gemma3's (H=4, KV=1, D=256), and ``kernel`` also with
gemma3's window of 512; each variant's output must equal ``kernel``'s bit for
bit. Device time per call from CUDA-graph replay (``chip_smoke._device_ms``),
the variants in turns, forward then backward, over 6 rounds; the medians.
One JSON line per shape, then the nvidia-smi line. Imports nothing of JAX or
of the JAX package.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SHAPES = ((4, 16, 8, 4096, 128), (4, 24, 8, 4096, 64), (4, 4, 1, 4096, 256))  # B, H, KV, S, D
WINDOW = 512
ROUNDS = 6
WINDOW_TERM = "  const int window = kWindow ? window_arg : 0;"


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, help="a flash_attention.cu of another commit")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fops

    base = fops._SRC.read_text()
    if WINDOW_TERM not in base:
        raise RuntimeError(
            f"flash_variants: the kernel source no longer has {WINDOW_TERM.strip()!r}")
    texts = {"kernel": base,
             "runtime_window": base.replace(WINDOW_TERM, "  const int window = window_arg;")}
    if args.other:
        texts["other"] = args.other.read_text()
    srcs = {}
    for name, text in texts.items():
        d = fops._SRC.parent.parent / "build" / "variants" / name / "csrc"
        d.mkdir(parents=True, exist_ok=True)
        srcs[name] = d / fops._SRC.name
        srcs[name].write_text(text)
    with ThreadPoolExecutor(max_workers=len(srcs)) as pool:  # one nvcc per variant, at once
        libs = dict(zip(srcs, pool.map(_build.build_library, srcs.values())))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    windowed = {}  # whether a library's entry point takes the window argument
    two_lengths = {}  # whether it takes the query's and the keys' lengths apart
    offset = {}  # whether it takes the causal query offset
    for name, lib in libs.items():
        offset[name] = "int window, int q_off, const int64_t* strides" in texts[name]
        windowed[name] = offset[name] or "int window, const int64_t* strides" in texts[name]
        two_lengths[name] = "int Sq, int Sk, int D" in texts[name]
        n_ints = 7 + windowed[name] + two_lengths[name] + offset[name]
        lib.flash_attention_fwd.argtypes = [ptr] * 4 + [i32] * n_ints + [ptr, ptr]
        lib.flash_attention_fwd.restype = ctypes.c_int

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    def launch(name, q, k, v, out, window=0):
        st = (ctypes.c_int64 * 12)(*(s for t in (out, q, k, v) for s in t.stride()[:3]))
        B, H, S, D = q.shape
        lengths = [S, k.shape[2]] if two_lengths[name] else [S]
        extra = ([window] if windowed[name] else []) + ([0] if offset[name] else [])
        return libs[name].flash_attention_fwd(
            out.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), 1, B, H, k.shape[1],
            *lengths, D, 1, *extra, ctypes.cast(st, ptr), torch.cuda.current_stream().cuda_stream)

    def call(name, q, k, v, out, window=0):
        err = launch(name, q, k, v, out, window)
        if err:
            raise RuntimeError(f"{name}: launch failed, CUDA error {err}")

    for shape in SHAPES:
        q, k, v = cs._attn_inputs(*shape, dtype=torch.bfloat16, seed=0)
        outs = {name: torch.empty_like(q) for name in libs}
        # the libraries that take this head size (another commit's may refuse it)
        names = [name for name in libs
                 if name != "other" or launch(name, q, k, v, outs[name]) == 0]
        for name in names:
            call(name, q, k, v, outs[name])
        torch.cuda.synchronize()
        equal = {name: torch.equal(outs[name], outs["kernel"]) for name in names}
        if not all(equal.values()):
            raise RuntimeError(f"flash_variants: outputs differ at {shape}: {equal}")
        cases = [(name, 0) for name in names] + [("kernel", WINDOW), ("runtime_window", WINDOW)]
        times = {f"{n}{'_window' if w else ''}": [] for n, w in cases}
        for _ in range(ROUNDS):
            for n, w in cases + cases[::-1]:
                ms = cs._device_ms(lambda: call(n, q, k, v, outs[n], w), 5, 3)["ms"]
                times[f"{n}{'_window' if w else ''}"].append(ms)
        cs._emit({"shape": list(shape), "window_of_the_windowed": WINDOW,
                  "median_ms": {n: statistics.median(t) for n, t in times.items()},
                  "all_ms": times})
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
