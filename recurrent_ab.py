#!/usr/bin/env python3
"""The recurrent families' cells of two checkouts, in turns on one NVIDIA GPU.

Run from the repository root on a GPU host:

    python3 recurrent_ab.py --other PATH [--out DIR]

PATH is another checkout's root (for example the parent commit unpacked
with ``git archive`` into a git-ignored directory). Each run is a fresh
process on one checkout, its own ``chip_smoke.py`` and ``src/``, in the
order other, this, this, other. A run builds the kernels and drives, with
that checkout's phase functions and settings, the cells of
``chip_smoke.py`` that take zamba2-1.2b and rwkv6-7b on one card:
``train_zamba2``, ``train_rwkv``, ``serve_zamba2``, ``serve_rwkv`` and
``serve_steps`` for both archs (the built prefill and decode steps, the
sha256 of their prefill logits, step logits and tokens). A run's own
output goes to ``DIR/run{i}_{tree}.log`` (default ``ab_out/``, git-ignored);
one JSON line per run follows on standard output (its cells' times,
losses, range shares and digests), then a summary line (each number by
checkout, in run order; whether each digest and loss of one checkout's
runs equals the other's), then the nvidia-smi line. Imports nothing of
JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TRAIN = ("train_zamba2", "train_rwkv")
SERVE = ("serve_zamba2", "serve_rwkv")
STEPS = (dict(arch="zamba2-1.2b", batch=4, prompt_len=4096, tokens=32, seed=0),
         dict(arch="rwkv6-7b", batch=4, prompt_len=4096, tokens=32, seed=0))
# the numbers a run keeps of a phase's result: its keys that hold these
KEEP = ("step_s", "tokens_per_s", "mfu", "peak_bytes", "loss", "prefill_s", "decode_ms",
        "share", "sha256", "built_", "same_tokens", "logits_bitwise")
MARK = "recurrent_ab: "


def _kept(result: dict) -> dict:
    return {k: v for k, v in result.items() if any(w in k for w in KEEP)}


def run_tree(root: Path) -> dict:
    """The cells on the checkout at ``root``, in this process."""
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke_ab", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, str(root / "src"))
    from repro_torch import checkpoint, configs, data, device, optim, serve_lm, telemetry, tree
    from repro_torch.core import sharded
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ipls_aggregate import ops
    from repro_torch.kernels.linear_scan import ops as sops
    from repro_torch.kernels.linear_scan import ref as sref
    from repro_torch.kernels.quantize import ops as qops
    from repro_torch.launch import mesh, steps
    from repro_torch.models import layers, ssm
    from repro_torch.roofline import HW

    cs.HW = HW
    kmods = {"ipls_aggregate_batched": ops.aggregate_batched,
             "ipls_aggregate_batched_q": ops.aggregate_batched_q,
             "quantize": qops.quantize, "dequantize": qops.dequantize,
             "flash_attention": fops.attention, "decode_attention": dops.decode,
             "rwkv6_scan": sops.rwkv6_scan}
    lm = {"configs": configs, "device": device, "serve_lm": serve_lm, "layers": layers,
          "steps": steps, "build": _build, "mesh": mesh}
    tr = {"configs": configs, "sharded": sharded, "steps": steps, "mesh": mesh, "optim": optim,
          "checkpoint": checkpoint, "tree": tree, "data": data, "layers": layers,
          "telemetry": telemetry, "ssm": ssm, "scan_ref": sref, "serve_lm": serve_lm}
    libs = (ops, qops, fops, dops, sops)
    with ThreadPoolExecutor(max_workers=len(libs)) as pool:  # one nvcc per source, at once
        list(pool.map(lambda m: m.build(), libs))
    cells = {}
    for cell in cs.TRAIN_CELLS:
        if cell["phase"] in TRAIN:
            cells[cell["phase"]] = _kept(cs.phase_train(tr, kmods, cell))
    torch.distributed.destroy_process_group()
    for name, spec_, n_params, bounds, kw in cs.SERVE_PHASES:
        if name in SERVE:
            cells[name] = _kept(cs.phase_serve(lm, kmods, name, spec_, n_params, bounds, **kw))
    out = cs.phase_serve_steps(lm, kmods, STEPS)
    cells["serve_steps"] = {a["arch"]: _kept(a) for a in out["archs"]}
    return cells


def _flat(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", type=Path, help="another checkout's root")
    ap.add_argument("--out", type=Path, default=ROOT / "ab_out")
    ap.add_argument("--run", type=Path, help=argparse.SUPPRESS)  # one run, in this process
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("recurrent_ab: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    if args.run:
        print(MARK + json.dumps(run_tree(args.run.resolve())), flush=True)
        return 0
    if args.other is None or not (args.other / "chip_smoke.py").is_file():
        print("recurrent_ab: --other must name a checkout's root", file=sys.stderr)
        return 2
    args.out.mkdir(parents=True, exist_ok=True)
    trees = {"other": args.other.resolve(), "this": ROOT}
    results = []
    for i, name in enumerate(("other", "this", "this", "other")):
        log = args.out / f"run{i}_{name}.log"
        with open(log, "w") as f:
            proc = subprocess.run([sys.executable, __file__, "--run", str(trees[name])],
                                  stdout=subprocess.PIPE, stderr=f, text=True, cwd=trees[name])
            f.write(proc.stdout)
        lines = [x for x in proc.stdout.splitlines() if x.startswith(MARK)]
        if proc.returncode or not lines:
            print(f"recurrent_ab: run {i} ({name}) failed with {proc.returncode}; see {log}",
                  file=sys.stderr)
            return 1
        cells = json.loads(lines[-1][len(MARK):])
        results.append((name, cells))
        print(json.dumps({"run": i, "tree": name, "cells": cells}), flush=True)
    by_tree = {"other": [], "this": []}
    for name, cells in results:
        by_tree[name].append(_flat(cells))
    keys = sorted(set(by_tree["this"][0]) & set(by_tree["other"][0]))
    summary = {"numbers": {k: {t: [r[k] for r in by_tree[t]] for t in by_tree} for k in keys
                           if all(isinstance(r[k], (int, float)) and not isinstance(r[k], bool)
                                  for t in by_tree for r in by_tree[t])},
               "equal_across_checkouts": {k: len({json.dumps(r[k]) for t in by_tree
                                                  for r in by_tree[t]}) == 1
                                          for k in keys if "sha256" in k or "loss" in k}}
    print(json.dumps({"summary": summary}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
