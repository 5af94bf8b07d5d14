"""Multi-pod dry run: build and count every (arch x shape) step on the
production meshes and report its memory, cost and roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A|all] \\
        [--shape S|all] [--mesh single|multi|both] [--out rows.jsonl]

Port of the reference's ``launch/dryrun.py``. For every applicable (arch,
shape) (``configs.shape_applicable``; the others are skipped with its
reason):

    single-pod mesh (16, 16) ("data", "model")        -> roofline row
    multi-pod mesh (2, 16, 16) ("pod", "data", "model") -> proves the pod axis

No card is used, by design: the reference lowers and compiles its steps for
512 fake host devices; here each cell's model and step are built in
``roofline.fake_world`` (a one-process fake process group of the mesh's
size, ``FakeTensorMode``: nothing is allocated) on this process's rank-0
shards, and one call of the step is counted
(``roofline.cost.count_cell_step``, the counting path of ``python -m
repro_torch.roofline``). A row holds the report's ``row()``, ``status`` and
``multi_pod``, ``build_s`` and ``count_s`` (the counterparts of the
reference's ``lower_s`` and ``compile_s``: seconds to build the model and
the step, and to count one call), ``arg_bytes_per_dev`` (the step's inputs:
parameters, state or cache, batch), ``temp_bytes_per_dev`` (the most the
step's own tensors held at once beside them; ``bytes_per_device`` is the
two summed, the peak), ``output_bytes_per_dev`` (None: not counted apart)
and ``collective_bytes`` (per-device wire bytes by kind). A failure (a
layout that does not build, a collective the mesh cannot run) is a bug in
the port: its row is ``FAILED`` and the run exits 1.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

MESHES = {False: ((16, 16), "16x16"), True: ((2, 16, 16), "2x16x16")}


def run_cell(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True) -> dict:
    """One (arch, shape) on the single- or multi-pod mesh: its row (see the
    module docstring), or a ``skipped`` row with the reference's reason."""
    from repro_torch.configs import SHAPES, get_config, shape_applicable
    from repro_torch.core.sharded import IplsStepConfig
    from repro_torch.launch.steps import TRAIN_OVERRIDES
    from repro_torch.roofline.cost import count_cell_step

    shape = SHAPES[shape_name]
    ok, why = shape_applicable(arch, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod, "status": "skipped",
                "why": why}
    mesh_shape, mesh_desc = MESHES[multi_pod]
    step_cfg = IplsStepConfig(**TRAIN_OVERRIDES.get(arch, {})) if shape.kind == "train" else None
    c = count_cell_step(get_config(arch), arch, shape, mesh_shape, step_cfg=step_cfg)
    report, cost = c.report, c.cost
    row = report.row()
    row.update(
        status="ok",
        multi_pod=multi_pod,
        build_s=round(c.build_s, 1),
        count_s=round(c.count_s, 1),
        arg_bytes_per_dev=cost.input_bytes,
        temp_bytes_per_dev=cost.peak_bytes - cost.input_bytes,
        output_bytes_per_dev=None,
        collective_bytes=report.collective_bytes,
        step_time_s=report.step_time_s,
    )
    if verbose:
        print(f"--- {arch} x {shape_name} x {mesh_desc} ---")
        print(f"memory (counted): args={row['arg_bytes_per_dev']:.0f} "
              f"temp={row['temp_bytes_per_dev']:.0f} peak={row['bytes_per_device']:.0f} "
              f"(per device)")
        print(f"cost (counted): global_flops={report.hlo_flops:.3e} "
              f"global_bytes={report.hlo_bytes:.3e}")
        print(f"roofline: compute={report.compute_s * 1e3:.2f}ms "
              f"memory={report.memory_s * 1e3:.2f}ms "
              f"collective={report.collective_s * 1e3:.2f}ms bottleneck={report.bottleneck} "
              f"useful={report.useful_flops_ratio:.3f} frac={report.roofline_fraction:.3f}")
        sys.stdout.flush()
    return row


def main(argv=None) -> int:
    from repro_torch.configs import ARCH_IDS, SHAPES

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all", help="arch id or 'all'")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=None, help="write JSONL results here")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    t0 = time.perf_counter()
    rows, failures = [], []
    for arch in archs:
        for shape in shapes:
            for multi_pod in meshes:
                try:
                    rows.append(run_cell(arch, shape, multi_pod))
                except Exception as e:  # a failing cell is reported, and the run goes on
                    traceback.print_exc()
                    failures.append((arch, shape, multi_pod, repr(e)))
                    rows.append({"arch": arch, "shape": shape, "multi_pod": multi_pod,
                                 "status": "FAILED", "error": repr(e)})
                if args.out:
                    with open(args.out, "w") as f:
                        for r in rows:
                            f.write(json.dumps(r) + "\n")
    print(f"\n=== dry-run complete: {sum(r['status'] == 'ok' for r in rows)} ok, "
          f"{sum(r['status'] == 'skipped' for r in rows)} skipped, {len(failures)} FAILED === "
          f"({time.perf_counter() - t0:.1f} s)")
    for f_ in failures:
        print("FAILED:", f_)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
