"""``repro_torch.launch.dryrun``, the port's multi-pod dry run: every
(arch, shape) step built and counted on fake tensors on the (16, 16) and
(2, 16, 16) meshes (no card), its rows those of the reference's
``repro.launch.dryrun`` (``lower_s`` and ``compile_s`` as ``build_s`` and
``count_s``), a skipped cell with the reference's reason, and a failing
cell a ``FAILED`` row and exit 1. The cheap full-width cells only (about
1-3 s each); the whole run is ``python -m repro_torch.launch.dryrun --mesh
both`` (PERF.md)."""
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import dryrun  # noqa: E402

from test_torch_tp import one_torch_thread  # noqa: E402,F401

# the reference's row keys (its report's ``row()`` and what run_cell adds),
# with its lower_s and compile_s under the port's names
REFERENCE_KEYS = {
    "arch", "shape", "mesh", "compute_s", "memory_s", "collective_s", "bottleneck",
    "model_flops", "hlo_flops", "useful_ratio", "roofline_fraction", "bytes_per_device",
    "status", "multi_pod", "arg_bytes_per_dev", "temp_bytes_per_dev", "output_bytes_per_dev",
    "collective_bytes",
}
RENAMED = {"lower_s": "build_s", "compile_s": "count_s"}


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch,shape", [("whisper-base", "decode_32k"),
                                        ("gemma3-1b", "long_500k")])
def test_run_cell_rows_have_the_reference_keys(arch, shape, multi_pod):
    row = dryrun.run_cell(arch, shape, multi_pod, verbose=False)
    assert row["status"] == "ok" and row["multi_pod"] is multi_pod
    assert REFERENCE_KEYS | set(RENAMED.values()) <= set(row), sorted(row)
    assert row["mesh"] == ("pod=2xdata=16xmodel=16" if multi_pod else "data=16xmodel=16")
    assert row["arg_bytes_per_dev"] > 0 and row["temp_bytes_per_dev"] >= 0
    assert row["bytes_per_device"] == row["arg_bytes_per_dev"] + row["temp_bytes_per_dev"]
    assert row["hlo_flops"] > 0 and row["step_time_s"] > 0
    assert row["bottleneck"] in ("compute", "memory", "collective")
    json.dumps(row)  # a JSONL row


def test_full_attention_arch_skips_long_500k():
    row = dryrun.run_cell("internlm2-1.8b", "long_500k", False)
    assert row == {"arch": "internlm2-1.8b", "shape": "long_500k", "multi_pod": False,
                   "status": "skipped",
                   "why": "long_500k needs sub-quadratic attention; pure full-attention arch"}


def test_main_writes_rows_and_exits_0(tmp_path, capsys):
    out = tmp_path / "rows.jsonl"
    rc = dryrun.main(["--arch", "whisper-base", "--shape", "decode_32k", "--mesh", "single",
                      "--out", str(out)])
    assert rc == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["status"] for r in rows] == ["ok"]
    printed = capsys.readouterr().out
    assert "--- whisper-base x decode_32k x 16x16 ---" in printed
    assert "=== dry-run complete: 1 ok, 0 skipped, 0 FAILED ===" in printed


def test_a_failing_cell_is_a_failed_row_and_exit_1(tmp_path, monkeypatch, capsys):
    from repro_torch.launch import steps

    def broken(*args, **kw):
        raise RuntimeError("a layout that does not build")

    monkeypatch.setattr(steps, "build_step", broken)
    out = tmp_path / "rows.jsonl"
    rc = dryrun.main(["--arch", "whisper-base", "--shape", "decode_32k", "--mesh", "both",
                      "--out", str(out)])
    assert rc == 1
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["status"], r["multi_pod"]) for r in rows] == [("FAILED", False), ("FAILED", True)]
    assert "a layout that does not build" in rows[0]["error"]
    assert "0 ok, 0 skipped, 2 FAILED" in capsys.readouterr().out
