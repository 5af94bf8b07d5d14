"""The roofline's count of long_500k's decode on the production meshes, on
fake tensors (``repro_torch.roofline.cost``): gemma3-1b (one period of its
first group: 5 windowed layers and a global one), zamba2-1.2b (2 Mamba2
blocks and the shared attention and MLP blocks, ``zamba2_cut``) and
rwkv6-7b (1 of 32 layers, ``rwkv6_cut``) at full width, batch 1, 524,288
slots, ``kv_seq`` over ("data", "model"):

* on ``fake_world((16, 16))`` each rank holds 2,048 slots of each full
  cache (and zamba2's), 2 of each 512-slot ring, and merges the 256
  ranks' partials: two all-gathers over the 256-rank group an attention
  layer, of its float32 (1, H, hd) output and (1, H) log-sum-exp;
* the dot FLOPs of a rank times 16 exceed those of the model-axis-1 step
  (``fake_world((16, 1))``: the group is its 16 data ranks, 32,768 slots a
  rank) by 15 times the token's products with weights that "model" does
  not split (each of the 16 model ranks computes them whole): gemma3's
  q, k, v and o (its 4 heads do not divide 16), rwkv6's decay lora's first
  product and its channel mix's gate (as ``test_torch_roofline_tp_rwkv.py``
  counts them); none for zamba2 (the attention over the slots, 1/16 of the
  model-axis-1 rank's, cancels in the difference);
* on ``fake_world((2, 16, 16))`` each pod is its own 256-rank group:
  gemma3's rank counts the dot FLOPs it counts on (16, 16), its merge
  gathers over 256 ranks.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import SHAPES, build_model, get_config  # noqa: E402
from repro_torch.launch.steps import build_decode_step  # noqa: E402
from repro_torch.roofline.cost import analyze_step, count_step, fake_world  # noqa: E402

from test_torch_roofline_tp import one_torch_thread  # noqa: E402,F401
from test_torch_roofline_tp_rwkv import rwkv6_cut  # noqa: E402
from test_torch_roofline_tp_ssm import zamba2_cut  # noqa: E402

M, GROUP, F32 = 16, 256, 4


def gemma3_cut():
    cfg = get_config("gemma3-1b")
    return dataclasses.replace(cfg, groups=(dataclasses.replace(cfg.groups[0], repeat=1),))


CUTS = {"gemma3-1b": gemma3_cut, "zamba2-1.2b": zamba2_cut, "rwkv6-7b": rwkv6_cut}


def _attention(cfg):
    return [b.attn for g in cfg.groups for b in (g.blocks + g.shared) * g.repeat
            if b.kind == "attn"]


def whole_token_flops(cfg) -> float:
    """The long decode token's dot FLOPs with weights "model" does not split
    at 16 (batch 1)."""
    flops = 0.0
    for s in _attention(cfg):
        if s.n_heads % M:
            flops += 2 * s.d_model * 2 * (s.n_heads + s.kv_heads) * s.head_dim
    for g in cfg.groups:
        for b in g.blocks * g.repeat:
            if b.kind == "rwkv6_time":
                flops += 2 * b.rwkv.d_model * b.rwkv.decay_lora
            elif b.kind == "rwkv6_channel":
                flops += 2 * b.rwkv.d_model * b.rwkv.d_model
    return flops


def counted(cfg, mesh_shape):
    with fake_world(mesh_shape) as mesh:
        model = build_model(cfg, device="cpu", mesh=mesh)
        built = build_decode_step(model, mesh, SHAPES["long_500k"])
        assert built.rules["kv_seq"] == ("data", "model")
        cost = count_step(built)
        report = analyze_step(built, arch=cfg.name, shape="long_500k", cost=cost)
        slots = [s.shape[1] for s in _cache_leaves(built.arg_shapes[1])]
    return cost, report, slots


def _cache_leaves(tree, key=None):
    """The attention caches' k and v specs of a cache tree."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _cache_leaves(v, k)]
    if isinstance(tree, list):
        return [x for v in tree for x in _cache_leaves(v)]
    return [tree] if key in ("k", "v") else []


def merge_gathers(cost, size=GROUP):
    """(calls, the bytes each rank sends) of the all-gathers over ``size``."""
    calls = [(i, o) for k, n, i, o in cost.collective_log if k == "all-gather" and n == size]
    return len(calls), sum(i for i, _ in calls)


@pytest.mark.parametrize("arch", sorted(CUTS))
def test_long_decode_counts_on_the_production_mesh(arch):
    cfg = CUTS[arch]()
    cost, report, slots = counted(cfg, (16, M))
    one, _, slots1 = counted(cfg, (16, 1))
    assert report.chips == 256 and report.step_time_s > 0
    assert M * cost.flops - one.flops == (M - 1) * whole_token_flops(cfg)
    attn = _attention(cfg)
    T = SHAPES["long_500k"].seq_len
    assert sorted(set(slots)) == sorted({min(T, s.window or T) // GROUP for s in attn})
    assert sorted(set(slots1)) == sorted({min(T, s.window or T) // 16 for s in attn})
    n, sent = merge_gathers(cost)
    assert n == 2 * len(attn)
    assert sent == sum(s.n_heads * (s.head_dim + 1) * F32 for s in attn)
    print(arch, f"dot FLOPs x16 - model axis 1 = {M * cost.flops - one.flops:.6g}",
          f"merge gathers {n}, {sent} bytes a rank", report.bottleneck, report.step_time_s)


def test_long_decode_counts_on_the_multi_pod_mesh():
    cfg = gemma3_cut()
    cost, report, slots = counted(cfg, (2, 16, M))
    single, _, _ = counted(cfg, (16, M))
    assert report.chips == 512
    assert cost.flops == single.flops
    assert merge_gathers(cost) == merge_gathers(single) == (12, 12 * 4 * 257 * F32 // 2)
    assert set(slots) == {2048, 2}
