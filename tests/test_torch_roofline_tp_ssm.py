"""The roofline's count of the recurrent families' steps on the production
mesh, on fake tensors (``repro_torch.roofline.cost``): zamba2-1.2b here,
rwkv6-7b in ``test_torch_roofline_tp_rwkv.py``, at full width on
``fake_world((16, 16))``, the train, prefill and decode steps of the
registry's shapes, each counted against the same step on
``fake_world((16, 1))`` (the model axis of 1, the same data rank's rows):

* the dot FLOPs of a rank on the model axis of 16, times 16, exceed the
  model-axis-1 step's by the products every rank computes whole, written
  out below per block (and none else);
* the collectives by kind, with Mamba2's in-projection gathered as the
  weight, (d_model, N / 16) bf16 per rank a layer (its gradient
  reduce-scattered in training; a decode step gathers the token's
  projection instead), and RWKV6's columns-to-rows all-to-all;
* the row-parallel outputs (Mamba2's ``w_out``, RWKV6's channel mix)
  summed over the model axis in float32 (``float32_sums``).

zamba2-1.2b is cut to one period of its first group with 2 of its 6
Mamba2 blocks, and its shared attention and MLP blocks (32 heads, 2 a
rank; d_ff 8,192); rwkv6-7b to 1 of its 32 layers. Every kind of block and
collective is kept.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import SHAPES, build_model, get_config  # noqa: E402
from repro_torch.launch.steps import build_step  # noqa: E402
from repro_torch.roofline.cost import analyze_step, count_step, fake_world  # noqa: E402

from test_torch_roofline_tp import _totals, one_torch_thread  # noqa: E402,F401

M, BF16 = 16, 2
# a train step counts each product four times: the forward, the layer's
# recompute (remat) and the two products of its backward
PASSES = {"prefill_32k": 1, "train_4k": 4}


def counted(cfg, key):
    """(the rank's StepCost on the model axis of 16, its report, the
    model-axis-1 step's StepCost)."""
    costs = {}
    for mesh_shape in ((16, M), (16, 1)):
        with fake_world(mesh_shape) as mesh:
            model = build_model(cfg, device="cpu", mesh=mesh)
            built = build_step(model, mesh, SHAPES[key])
            costs[mesh_shape] = count_step(built)
            if mesh_shape[1] == M:
                report = analyze_step(built, arch=cfg.name, shape=key, cost=costs[mesh_shape])
    return costs[(16, M)], report, costs[(16, 1)]


def tokens_of(key):
    """(batch rows, sequence) of a data rank: the global batch over 16."""
    shape = SHAPES[key]
    return shape.global_batch // 16, shape.seq_len


# a block's row-parallel parts are summed once a step (the reduce-scatter
# into the rank's rows, a decode step's all-reduce), in training again in
# the layer's recompute
SUMS = {"train_4k": 2, "prefill_32k": 1, "decode_32k": 1}


def float32_sums(cost, cfg, key):
    """The collectives over the model axis that sum the row-parallel parts
    of a block's output in float32 (the parts rounded to bf16 by their
    products, their sum rounded once after the collective, as the MoE
    layers' are): reduce-scatters of the data rank's (B, T, D) rows, in a
    decode step all-reduces of (B, D), at 4 bytes an element. The shared
    attention and MLP blocks' sums stay bf16, at 2."""
    B, T = tokens_of(key)
    want = (("all-reduce", B * cfg.d_model * 4) if SHAPES[key].kind == "decode"
            else ("reduce-scatter", B * T * cfg.d_model * 4))
    return sum((k, i) == want for k, n, i, o in cost.collective_log if n == M)


def zamba2_cut():
    cfg = get_config("zamba2-1.2b")
    g = cfg.groups[0]
    return dataclasses.replace(cfg, groups=(dataclasses.replace(
        g, blocks=g.blocks[:2], repeat=1),))


def mamba2_extra(s, key):
    """The dot FLOPs a Mamba2 block computes on every rank whole, over the
    16 ranks (against the model-axis-1 step): the in-projection's B and C
    columns (2 d_state of them) and the chunks' C B^T products (each rank
    reads all of B and C); in a prefill also the convolution history's
    product of the last d_conv - 1 rows, which the model-axis-1 step slices
    from its projection."""
    B, T = tokens_of(key)
    if SHAPES[key].kind == "decode":
        return 0  # the token's projection is split by columns and gathered
    Q = min(s.chunk, T)
    inproj = (M - 1) * B * T * s.d_model * 2 * s.d_state * 2
    cb = (M - 1) * 2 * B * (T // Q) * Q * Q * s.d_state
    tail = 0
    if key.startswith("prefill"):
        tail = M * 2 * B * (s.d_conv - 1) * s.d_model * (s.d_inner + 2 * s.d_state)
    return PASSES[key] * (inproj + cb) + tail


@pytest.mark.parametrize("key", ["train_4k", "prefill_32k", "decode_32k"])
def test_zamba2_counts_on_the_production_mesh(key):
    cfg = zamba2_cut()
    s = cfg.groups[0].blocks[0].mamba
    N = 2 * s.d_inner + 2 * s.d_state + s.n_heads
    cost, report, one = counted(cfg, key)
    assert report.chips == 256 and report.step_time_s > 0
    n_mamba = sum(b.kind == "mamba2" for g in cfg.groups for b in g.blocks * g.repeat)
    extra = n_mamba * mamba2_extra(s, key)
    assert M * cost.flops - one.flops == extra
    calls = _totals([(k, i, o) for k, n, i, o in cost.collective_log if n == M])
    # the in-projection's weight gathered over the model axis, a layer (and
    # in training again in its recompute; its gradient reduce-scattered)
    w_in = s.d_model * (N // M) * BF16
    gathers = sum(k == "all-gather" and i == w_in for k, n, i, o in cost.collective_log)
    assert gathers == n_mamba * {"train_4k": 2, "prefill_32k": 1, "decode_32k": 0}[key]
    # each Mamba2 block's row-parallel output summed in float32, then cast
    assert float32_sums(cost, cfg, key) == n_mamba * SUMS[key]
    print(key, calls, f"w_in gathers {gathers} x {w_in} B; dot FLOPs x16 - model axis 1 = "
          f"{extra:.6g} ({M * cost.flops / one.flops:.4f}x)", report.bottleneck,
          report.step_time_s)
