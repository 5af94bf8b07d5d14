"""The roofline's count of whisper-base's steps on the production mesh, on
fake tensors (``repro_torch.roofline.cost``): at full width (d_model 512,
8 heads, d_ff 2,048, a tied vocabulary of 51,865 rows), cut to 1 encoder
and 1 decoder layer, on ``fake_world((16, 16))`` against the same step on
``fake_world((16, 1))`` (the model axis of 1, the same data rank's rows).

At 16 its 8 heads and its vocabulary do not divide the axis, so its
attention weights and its table are whole on every rank; its d_ff does,
so the MLP is column- then row-parallel, its parts summed in float32. The
registry's shapes split their sequences (4,096 tokens and frames in
training, 32,768 in a prefill) and caches (32,768 slots and frames) over
the axis. The dot FLOPs of a rank times 16 exceed the model-axis-1 step's
by what every rank computes whole:

* train_4k: the cross-attention's keys and values of the whole encoder
  output (each rank's decoder rows read every frame), in the forward, the
  layer's recompute and the backward's two products; and one row of tied
  logits (the counted rank holds 256 rows with a target each, the
  model-axis-1 step 4,095 of 4,096), forward and backward;
* prefill_32k: the cross keys and values once, and the last row's logits
  (every rank computes them from the gathered row);
* decode_32k: the token's attention projections (self q, k, v, o; cross q
  and o) and its logits over the whole table; the attention over the
  slots and frames, each rank's 1/16 of them, cancels in the difference.

The collectives: the MLP's float32 parts reduce-scattered into the rank's
rows ((B, S, 512) float32 a layer, encoder and decoder), and in decode
all-reduced ((B, 512) float32), and the merge of the 16 ranks' partials
of self- and cross-attention (their float32 (B, 8, 64) outputs and (B, 8)
log-sum-exps gathered).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import SHAPES, build_model, get_config  # noqa: E402
from repro_torch.launch.steps import build_step  # noqa: E402
from repro_torch.roofline.cost import analyze_step, count_step, fake_world  # noqa: E402

from test_torch_roofline_tp import one_torch_thread  # noqa: E402,F401

M, F32 = 16, 4


def whisper_cut():
    return dataclasses.replace(get_config("whisper-base"), enc_layers=1, dec_layers=1)


def counted(cfg, key):
    costs = {}
    for mesh_shape in ((16, M), (16, 1)):
        with fake_world(mesh_shape) as mesh:
            model = build_model(cfg, device="cpu", mesh=mesh)
            built = build_step(model, mesh, SHAPES[key])
            costs[mesh_shape] = count_step(built)
            if mesh_shape[1] == M:
                assert model.params()["dec"][0]["mlp"]["wd"].shape == (cfg.d_ff // M, cfg.d_model)
                assert model.params()["embed"]["table"].shape == (cfg.vocab, cfg.d_model)
                report = analyze_step(built, arch=cfg.name, shape=key, cost=costs[mesh_shape])
    return costs[(16, M)], report, costs[(16, 1)]


def whole_flops(cfg, key) -> float:
    """The dot FLOPs every rank computes whole (the module docstring), over
    the 16 ranks against the model-axis-1 step."""
    shape = SHAPES[key]
    B, S, d, V = shape.global_batch // 16, shape.seq_len, cfg.d_model, cfg.vocab
    cross_kv = 2 * 2 * B * S * d * d * cfg.dec_layers  # ek and ev of every frame
    logits_row = 2 * B * d * V
    if shape.kind == "train":
        return (M - 1) * 4 * cross_kv + 3 * logits_row
    if shape.kind == "prefill":
        return (M - 1) * (cross_kv + logits_row)
    projections = (4 + 2) * 2 * B * d * d * cfg.dec_layers
    return (M - 1) * (projections + logits_row)


@pytest.mark.parametrize("key", ["train_4k", "prefill_32k", "decode_32k"])
def test_whisper_counts_on_the_production_mesh(key):
    cfg = whisper_cut()
    cost, report, one = counted(cfg, key)
    assert report.chips == 256 and report.step_time_s > 0
    assert M * cost.flops - one.flops == whole_flops(cfg, key)
    shape = SHAPES[key]
    B, S, d = shape.global_batch // 16, shape.seq_len, cfg.d_model
    logged = [(k, n, i) for k, n, i, o in cost.collective_log]
    assert all(n == M for _, n, _ in logged)
    kinds = {k for k, _, _ in logged}
    if shape.kind == "decode":
        parts = [i for k, _, i in logged if k == "all-reduce" and i == B * d * F32]
        merged = [i for k, _, i in logged if k == "all-gather"]
        H, hd = cfg.n_heads, cfg.head_dim
        assert len(parts) == cfg.dec_layers and kinds == {"all-reduce", "all-gather"}
        assert sorted(merged) == sorted([B * H * hd * F32, B * H * F32] * 2 * cfg.dec_layers)
    else:
        parts = [i for k, _, i in logged if k == "reduce-scatter" and i == B * S * d * F32]
        assert len(parts) >= cfg.enc_layers + cfg.dec_layers
        assert {"all-gather", "reduce-scatter"} <= kinds
    print(key, f"dot FLOPs x16 - model axis 1 = {M * cost.flops - one.flops:.6g}",
          f"collectives {len(logged)}", report.bottleneck, report.step_time_s)
