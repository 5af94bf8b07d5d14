"""``repro_torch.roofline`` on the CPU: the reference's report terms on the
H100 spec, ``model_flops_for``, the counter on small programs, the
collectives of a reduced train step on fake (4, 1) and (2, 2, 1) meshes,
the bytes of long decode steps, and the dot FLOPs of the dense family's
built steps against the reference's ``analyze_hlo_text``
(``torch_roofline_ref``). Everything is counted on fake tensors.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import build_model, get_config
from repro_torch.configs.registry import SHAPES, ShapeSpec
from repro_torch.core.sharded import owned_dim, tree_leaves_of_specs
from repro_torch.launch import steps
from repro_torch.roofline import (
    HW,
    HardwareSpec,
    RooflineReport,
    analyze_step,
    collective_bytes,
    count_step,
    fake_world,
    model_flops_for,
)
from repro_torch.roofline.cost import counting
from repro_torch.tree import tree_leaves
from torch_roofline_ref import KINDS, port_flops, ref_flops

ARCHS = ("internlm2-1.8b", "qwen2-vl-72b")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small products only: run torch on one thread (no numeric effect
    here), and give the pool back afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_hardware_spec_is_the_h100_data_sheet():
    assert HW == HardwareSpec()
    assert (HW.name, HW.peak_flops, HW.f32_flops, HW.hbm_bw, HW.link_bw) == (
        "h100-sxm5-80gb", 989e12, 67e12, 3.35e12, 450e9)


def test_roofline_report_terms():
    r = RooflineReport(
        arch="x", shape="train_4k", mesh="16x16", chips=256,
        hlo_flops=1e18, hlo_bytes=1e15, collective_bytes={"all-reduce": 5e10},
        model_flops=5e17,
    )
    assert np.isclose(r.compute_s, 1e18 / (256 * 989e12))
    assert np.isclose(r.memory_s, 1e15 / (256 * 3.35e12))
    assert np.isclose(r.collective_s, 5e10 / 450e9)
    assert r.bottleneck == "compute" and r.step_time_s == r.compute_s
    assert 0 < r.roofline_fraction <= 1.0
    assert np.isclose(r.useful_flops_ratio, 0.5)
    assert set(r.row()) == {"arch", "shape", "mesh", "compute_s", "memory_s", "collective_s",
                            "bottleneck", "model_flops", "hlo_flops", "hlo_flops_f32",
                            "useful_ratio", "roofline_fraction", "bytes_per_device"}
    # float32 dots at the float32 rate (TF32 off), the rest at bf16's
    f32 = RooflineReport(arch="x", shape="s", mesh="", chips=2, hlo_flops=3e15, hlo_bytes=0.0,
                         collective_bytes={}, model_flops=0.0, hlo_flops_f32=1e15)
    assert np.isclose(f32.compute_s, (2e15 / 989e12 + 1e15 / 67e12) / 2)


def test_collective_ring_accounting():
    assert collective_bytes("all-gather", 10, 40) == 40
    assert collective_bytes("reduce-scatter", 40, 10) == 40
    assert collective_bytes("all-reduce", 40, 40) == 80
    assert collective_bytes("all-to-all", 40, 40) == 40
    assert collective_bytes("collective-permute", 40, 40) == 40
    with pytest.raises(ValueError):
        collective_bytes("broadcast", 1, 1)


@pytest.mark.parametrize("arch", ("internlm2-1.8b", "granite-moe-3b-a800m", "rwkv6-7b",
                                  "whisper-base"))
def test_model_flops_for_matches_reference(arch):
    pytest.importorskip("jax")
    from repro.configs import build_model as jax_build
    from repro.configs import get_config as jax_config
    from repro.roofline.analysis import model_flops_for as jax_model_flops

    jmodel = jax_build(jax_config(arch, reduced=True))
    with fake_world((1, 1)):
        model = build_model(get_config(arch, reduced=True), device="cpu")
        for kind, S, B in (("train", 4096, 256), ("prefill", 32768, 32), ("decode", 32768, 128)):
            assert model_flops_for(model, kind, S, B) == jax_model_flops(jmodel, kind, S, B)


def test_counter_on_small_programs():
    with fake_world((1, 1)):
        a = torch.zeros((256, 256))
        with counting([a]) as m:
            a @ a
        assert m.cost.flops == m.cost.f32_flops == 2 * 256**3  # float32 operands
        assert m.cost.bytes == 3 * 256 * 256 * 4  # two reads, one write
        assert m.cost.peak_bytes == 2 * 256 * 256 * 4
        with counting() as m:
            x = a
            for _ in range(7):  # eager: every product runs
                x = x @ a
        assert m.cost.flops == 7 * 2 * 256**3
        b = torch.zeros((4, 64, 64))
        with counting() as m:
            torch.einsum("bij,bjk->bik", b, b)
            b.transpose(1, 2).contiguous()  # a copy: read and written
            b.transpose(1, 2)[:, :2]  # views move nothing
        assert m.cost.flops == 4 * 2 * 64**3
        assert m.cost.bytes == 3 * b.numel() * 4 + 2 * b.numel() * 4
        cache = torch.zeros((1, 1000, 4, 16), dtype=torch.bfloat16)
        new = torch.zeros((1, 1, 4, 16), dtype=torch.bfloat16)
        with counting() as m:
            cache.index_copy_(1, torch.tensor([7]), new)  # writes one slot
        assert m.cost.bytes == 2 * new.numel() * 2 + 8
        h, bias = a.to(torch.bfloat16), torch.zeros(256, dtype=torch.bfloat16)
        with counting() as m:
            h @ h  # bf16 operands: the tensor cores' rate
            torch.addmm(bias, h, h)
            torch.addmm(bias.float(), a, a)
        assert m.cost.flops == 3 * 2 * 256**3 and m.cost.f32_flops == 2 * 256**3


def test_counting_needs_fake_tensors():
    with pytest.raises(RuntimeError, match="fake"):
        with counting():
            pass


def test_fake_world_leaves_real_runs_alone():
    """A fake world's cached constants (RoPE frequencies) are cleared on
    exit: a real CPU model prefills afterwards."""
    cfg = get_config("gemma3-1b", reduced=True)
    with fake_world((1, 1)) as mesh:
        model = build_model(cfg, device="cpu")
        count_step(steps.build_prefill_step(model, mesh, ShapeSpec("p", 8, 1, "prefill")))
    real = build_model(cfg, device="cpu")
    logits, _ = real.prefill({"tokens": torch.zeros((1, 8), dtype=torch.int32)})
    assert torch.isfinite(logits.float()).all()


def _expected_collectives(params, specs, D, P):
    """The ring accounting of a train step's gradients and parameters on a
    mesh of ``D`` data ranks and ``P`` pods: a leaf with an owned dim is
    reduce-scattered over "data" (its gradient), all-reduced over "pod"
    (its owned slice) and all-gathered (its parameter); one without is
    all-reduced over each group above one device. Beside them: the
    participant counts and the loss (one float each, over each group) and
    the owned slices' squared norms (over "data")."""
    rs = ag = ar = 0
    leaves = tree_leaves(params)
    dims = [owned_dim(s) for s in tree_leaves_of_specs(specs, params)]
    groups = [n for n in (D, P) if n > 1]
    for p, k in zip(leaves, dims):
        n = p.numel() * p.element_size()
        if k is None:
            ar += 2 * n * len(groups)
        else:
            rs += n
            ag += n
            ar += 2 * (n // D) if P > 1 else 0
    ar += 2 * 4 * 2 * len(groups)  # counts (one microbatch) and loss
    ar += 2 * 4 * sum(k is not None for k in dims) if D > 1 else 0
    return {"reduce-scatter": rs, "all-gather": ag, "all-reduce": ar}


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2, 1)])
def test_train_collectives_are_the_ring_accounting(mesh_shape):
    with fake_world(mesh_shape) as mesh:
        model = build_model(get_config("internlm2-1.8b", reduced=True), device="cpu")
        built = steps.build_train_step(model, mesh, ShapeSpec("t", 16, 8, "train"))
        cost = count_step(built)
        D = mesh_shape[-2]
        P = mesh_shape[0] if len(mesh_shape) == 3 else 1
        want = _expected_collectives(model.params(), built.update_shardings, D, P)
        report = analyze_step(built, arch="internlm2-1.8b", shape="t")
    assert dict(cost.collective_bytes) == want
    assert report.chips == D * P and report.collective_s == sum(want.values()) / HW.link_bw


@pytest.mark.parametrize("arch", ("gemma3-1b", "zamba2-1.2b", "rwkv6-7b"))
def test_long_decode_bytes_cover_parameters_and_cache(arch):
    """A long_500k decode step (the reduced widths, 524,288 slots) moves at
    least the parameters it reads and its whole cache: flash-decode reads
    every slot up to pos, the plain path the whole cache."""
    with fake_world((1, 1)) as mesh:
        model = build_model(get_config(arch, reduced=True), device="cpu")
        built = steps.build_decode_step(model, mesh, SHAPES["long_500k"])
        cost = count_step(built)
        params = model.params()
        table = 0 if model.cfg.tie_embeddings else params["embed"]["table"]
        read = sum(p.numel() * p.element_size() for p in tree_leaves(params)
                   if p is not table)
        cache = sum(s.numel() * s.element_size()
                    for s in tree_leaves(model.init_cache(1, SHAPES["long_500k"].seq_len)))
    assert cost.bytes >= read + cache
    assert cost.input_bytes >= read + cache
    if arch != "rwkv6-7b":
        assert cost.kernel_calls["decode_attention"] == model.kernel_launches()["decode_step"][
            "decode_attention"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_dot_flops_match_reference(arch, kind):
    pytest.importorskip("jax")
    assert port_flops(arch, kind) == ref_flops(arch, kind)


def test_cli_counts_a_full_width_long_decode(capsys):
    """``python -m repro_torch.roofline`` on gemma3-1b's long_500k decode
    at full width (nothing allocated): 26 decode calls a step, memory-bound,
    its bytes at least the parameters (bf16, the table tied) and the 4
    global caches of 512 MiB."""
    import json

    from repro_torch.roofline.__main__ import main

    assert main(["--arch", "gemma3-1b", "--shape", "long_500k"]) == 0
    row = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert row["kernel_calls"] == {"decode_attention": 26} and row["bottleneck"] == "memory"
    assert row["hlo_bytes"] >= 999_826_048 * 2 + 4 * 512 * 2**20
    assert row["step_time_s"] == row["memory_s"] == row["hlo_bytes"] / HW.hbm_bw


def test_cli_reads_cells_from_standard_input(capsys, monkeypatch):
    """``--cells -`` (as chip_smoke.py runs it): one row a cell, in order,
    a float32 train step's dots at the float32 rate."""
    import io
    import json

    from repro_torch.roofline.__main__ import main

    cells = [dict(cell="d", arch="gemma3-1b", kind="decode", batch=1, seq_len=64, layers=1),
             dict(cell="t", arch="internlm2-1.8b", kind="train", batch=1, seq_len=16, layers=1)]
    monkeypatch.setattr("sys.stdin", io.StringIO(json.dumps(cells)))
    assert main(["--cells", "-"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["cell"] for r in rows] == ["d", "t"]
    for r in rows:
        half = r["hlo_flops"] - r["hlo_flops_f32"]
        assert np.isclose(r["compute_s"], half / HW.peak_flops + r["hlo_flops_f32"] / HW.f32_flops)
    with pytest.raises(SystemExit):
        main(["--cells", "cells.json"])
