"""The roofline of built steps on the CPU, counted on fake tensors.

    python -m repro_torch.roofline --arch gemma3-1b --shape long_500k
    python -m repro_torch.roofline --arch internlm2-1.8b --kind train \\
        --batch 2 --seq-len 4096 [--layers N] [--mesh 4,1] [--fsdp]
    python -m repro_torch.roofline --cells - < cells.json

One JSON line per step: the report's ``row()``, its ``step_time_s``, the
counted bytes, collectives, kernel wrapper calls and the operations that
moved the most bytes. A shape
of the registry (``--shape``) or a kind with a batch and a sequence length
(a decode step's cache slots); ``--layers`` cuts the first group's period
to that many repeats (the widths as published); ``--enc-len`` gives
whisper's encoder frames (its cross caches), the sequence length by
default; ``--fsdp`` counts a train step with ``IplsStepConfig(fsdp=True)``
(parameters stored as "data" shards, gathered per layer). ``--layers``
cuts the last group when the first is a single layer (deepseek's dense
layer before its MoE layers). ``--cells -`` reads a JSON list of such cells
from standard input (keys ``cell``, ``arch``, ``kind``, ``batch``,
``seq_len``, optional ``layers``, ``enc_len``, ``mesh``, ``fsdp``).
Nothing is allocated and no card is used.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from repro_torch.configs import get_config
from repro_torch.configs.registry import SHAPES, ShapeSpec
from repro_torch.core.sharded import IplsStepConfig
from repro_torch.roofline.cost import count_cell_step


def _config(arch: str, layers=None):
    """The arch's config; with ``layers``, its first group's period repeated
    that many times, or, where the first group is one layer and others
    follow (deepseek's dense layer), its last group's."""
    cfg = get_config(arch)
    if layers:
        groups = list(cfg.groups)
        gi = len(groups) - 1 if len(groups) > 1 and groups[0].repeat == 1 else 0
        groups[gi] = dataclasses.replace(groups[gi], repeat=layers)
        cfg = dataclasses.replace(cfg, groups=tuple(groups))
    return cfg


def count_cell(cell: dict) -> dict:
    """One cell's report row, step time and counts (see the module
    docstring for the keys)."""
    cfg = _config(cell["arch"], cell.get("layers"))
    shape = ShapeSpec(cell.get("cell", "cell"), cell["seq_len"], cell["batch"], cell["kind"])
    c = count_cell_step(cfg, cell["arch"], shape, tuple(cell.get("mesh", (1, 1))),
                        step_cfg=IplsStepConfig(fsdp=True) if cell.get("fsdp") else None,
                        enc_len=cell.get("enc_len"))
    report, cost = c.report, c.cost
    return {"cell": shape.name, **report.row(), "step_time_s": report.step_time_s,
            "hlo_bytes": report.hlo_bytes, "collective_bytes": report.collective_bytes,
            "kernel_calls": dict(cost.kernel_calls),
            "bytes_top_ops": dict(sorted(cost.bytes_by_op.items(), key=lambda kv: -kv[1])[:6]),
            "input_bytes": cost.input_bytes, "hw": report.hw.name,
            "count_s": c.build_s + c.count_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=sorted(SHAPES))
    ap.add_argument("--kind", choices=("train", "prefill", "decode"))
    ap.add_argument("--batch", type=int)
    ap.add_argument("--seq-len", type=int)
    ap.add_argument("--layers", type=int)
    ap.add_argument("--enc-len", type=int)
    ap.add_argument("--mesh", default="1,1", help="mesh shape, e.g. 4,1 or 2,2,1")
    ap.add_argument("--fsdp", action="store_true", help="a train step with fsdp=True")
    ap.add_argument("--cells", choices=("-",),
                    help="'-': read a JSON list of cells from standard input")
    args = ap.parse_args(argv)
    if args.cells:
        cells = json.load(sys.stdin)
    else:
        if not args.arch or not (args.shape or args.kind):
            ap.error("give --arch and --shape (or --kind, --batch, --seq-len), or --cells -")
        s = SHAPES.get(args.shape) if args.shape else None
        cells = [{"cell": args.shape or args.kind, "arch": args.arch,
                  "kind": s.kind if s else args.kind,
                  "batch": args.batch or (s.global_batch if s else 1),
                  "seq_len": args.seq_len or (s.seq_len if s else 4096),
                  "layers": args.layers, "enc_len": args.enc_len, "fsdp": args.fsdp,
                  "mesh": [int(n) for n in args.mesh.split(",")]}]
    for cell in cells:
        print(json.dumps(count_cell(cell)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
