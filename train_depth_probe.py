#!/usr/bin/env python3
"""Peak memory of chip_smoke.py's `train_rwkv` cell at other depths, on one
NVIDIA GPU: how TRAIN_RWKV_LAYERS is chosen, the most of rwkv6-7b's 32
layers whose train step at full width peaks under ~72 GB.

Run from the repository root:  python3 train_depth_probe.py 12 13 14

For each depth, chip_smoke's `phase_train` on that many layers at batch 1
and 4,096 tokens, 2 steps: its JSON line (seconds a step, peak bytes over
the phase's base), or a line with the out-of-memory error. Then the
nvidia-smi line (the card's name and power limit).
"""
from __future__ import annotations

import gc
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch import configs, data, optim, serve_lm, telemetry, tree  # noqa: E402
from repro_torch.core import sharded  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.linear_scan import ops as sops  # noqa: E402
from repro_torch.kernels.linear_scan import ref as sref  # noqa: E402
from repro_torch.launch import mesh, steps  # noqa: E402
from repro_torch.models import layers, ssm  # noqa: E402

LAYER_PARAMS = 218_677_248  # one rwkv6-7b layer: time mix and channel mix


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("train_depth_probe: no CUDA device", file=sys.stderr)
        return 2
    tr = {"configs": configs, "sharded": sharded, "steps": steps, "mesh": mesh, "optim": optim,
          "tree": tree, "data": data, "layers": layers, "telemetry": telemetry, "ssm": ssm,
          "scan_ref": sref, "serve_lm": serve_lm}
    kmods = {"flash_attention": fops.attention, "decode_attention": dops.decode,
             "rwkv6_scan": sops.rwkv6_scan}
    for n in [int(a) for a in argv] or [cs.TRAIN_RWKV_LAYERS]:
        cs.TRAIN_PARAMS["rwkv6-7b"] = cs.SERVE_RWKV_PARAMS - (32 - n) * LAYER_PARAMS
        cell = dict(phase=f"train_rwkv_{n}_layers", arch="rwkv6-7b", batch=1, steps=2, layers=n)
        try:
            cs.phase_train(tr, kmods, cell)
        except torch.OutOfMemoryError as e:
            cs._emit({"phase": cell["phase"], "out_of_memory": str(e).splitlines()[0]})
        gc.collect()
        torch.cuda.empty_cache()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
