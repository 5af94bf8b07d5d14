"""The roofline's count of rwkv6-7b's steps on the production mesh
(``fake_world((16, 16))``, 1 of its 32 layers), against the model-axis-1
step, as ``test_torch_roofline_tp_ssm.py`` counts zamba2-1.2b's (the
train and decode steps here, the prefill in
``test_torch_roofline_tp_rwkv_prefill.py``: its chunked scan's plain
version loops over 2,048 chunks of 16, 10 s a count): the dot
FLOPs of a rank times 16 exceed the model-axis-1 step's by the decay
lora's first product (``w1``, d_model x 64, on every rank whole: the
decay of each rank's columns needs all of it) and, in a decode step, whose
one token a row is whole on every rank, the channel mix's gate (``wr``,
replicated); the time mix's output leaves by one all-to-all (columns to
rows) a layer, and the channel mix's row-parallel output is summed in
float32 (``float32_sums``). And the long-context layout (``kv_seq`` over data and
model) counts there; only its decode graph raises.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import SHAPES, build_model, get_config  # noqa: E402
from repro_torch.launch.steps import build_decode_step  # noqa: E402
from repro_torch.roofline.cost import count_step, fake_world  # noqa: E402

from test_torch_roofline_tp import _totals, one_torch_thread  # noqa: E402,F401
from test_torch_roofline_tp_ssm import (M, PASSES, SUMS, counted, float32_sums,  # noqa: E402
                                       tokens_of)


def rwkv6_cut():
    cfg = get_config("rwkv6-7b")
    return dataclasses.replace(cfg, groups=(dataclasses.replace(cfg.groups[0], repeat=1),))


@pytest.mark.parametrize("key", ["train_4k", "decode_32k"])
def test_rwkv6_counts_on_the_production_mesh(key):
    check_rwkv6(key)


def check_rwkv6(key):
    """The module docstring's counts of one step of ``key``."""
    cfg = rwkv6_cut()
    s = cfg.groups[0].blocks[0].rwkv
    D = s.d_model
    cost, report, one = counted(cfg, key)
    assert report.chips == 256 and report.step_time_s > 0
    B, T = tokens_of(key)
    if SHAPES[key].kind == "decode":
        extra = (M - 1) * B * D * (s.decay_lora + D) * 2
    else:
        extra = PASSES[key] * (M - 1) * B * T * D * s.decay_lora * 2
    assert M * cost.flops - one.flops == extra
    calls = _totals([(k, i, o) for k, n, i, o in cost.collective_log if n == M])
    # the time mix's columns to rows: (B, T, D / 16) bf16 a rank, a layer
    # (and in training again in its recompute and once back in its backward)
    a2a = {"train_4k": 3, "prefill_32k": 1, "decode_32k": 0}[key]
    assert calls.get("all-to-all", (0, 0)) == (a2a, a2a * B * T * D // M * 2)
    # the channel mix's row-parallel output summed in float32, then cast
    assert float32_sums(cost, cfg, key) == SUMS[key]
    print(key, calls, f"dot FLOPs x16 - model axis 1 = {extra:.6g} "
          f"({M * cost.flops / one.flops:.4f}x)", report.bottleneck, report.step_time_s)


def test_long_context_layout_raises_on_a_model_axis():
    """On a model axis above 1 the long-context layout (``kv_seq`` over data
    and model) raises only for a decode graph (its collectives would be
    captured); the step itself counts: rwkv6 keeps no slots, so no merge
    over the 256 ranks runs, and its decode's collectives are the
    model-axis decode's (``test_torch_roofline_long_cp.py`` counts the
    long decode of every arch)."""
    with fake_world((16, 16)) as mesh:
        model = build_model(rwkv6_cut(), device="cpu", mesh=mesh)
        with pytest.raises(NotImplementedError, match="decode graph"):
            build_decode_step(model, mesh, SHAPES["long_500k"], graph=True)
        cost = count_step(build_decode_step(model, mesh, SHAPES["long_500k"]))
    assert cost.flops > 0
    assert all(n == M for _, n, _, _ in cost.collective_log)
