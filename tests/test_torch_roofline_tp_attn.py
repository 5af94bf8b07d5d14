"""The roofline's count of the attention variants' steps on the production
mesh, on fake tensors (``repro_torch.roofline.cost``), beside
``test_torch_roofline_tp.py``'s internlm2-1.8b: at full width on
``fake_world((16, 16))``, each train step with its arch's
``TRAIN_OVERRIDES`` (fsdp for deepseek and qwen2-vl), the train, prefill
and decode steps of the registry's shapes build and are counted, the model
holding 1/16 of each split leaf:

* deepseek-v2-lite-16b: MLA, 1 of its 16 heads a rank (wq, wuk, wuv, wo);
  cut to its dense layer and 2 of its 26 MoE layers;
* qwen2-vl-72b: M-RoPE and qkv biases, 4 of its 64 heads a rank; 4 of its
  80 layers;
* gemma3-1b: sliding windows; its 4 heads do not divide 16, so its
  attention is sequence-parallel (the MLP's 6,912 columns split); one
  period of 6 layers and its 2-layer tail, 8 of 26.

Counting the whole depths takes 17-26 s a train step on the CPU; the cuts
keep every kind of layer.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import SHAPES, build_model, get_config  # noqa: E402
from repro_torch.core.sharded import IplsStepConfig  # noqa: E402
from repro_torch.launch.steps import TRAIN_OVERRIDES, build_step  # noqa: E402
from repro_torch.roofline.cost import analyze_step, count_step, fake_world  # noqa: E402

from test_torch_roofline_tp import _totals, one_torch_thread  # noqa: E402,F401

# (the repeats of each group kept, a split leaf's path in the first layer,
# its shape on a rank)
VARIANTS = {
    "deepseek-v2-lite-16b": ((1, 2), ("b0", "mla", "wuk"), (512, 1, 128)),
    "qwen2-vl-72b": ((4,), ("b0", "attn", "bq"), (4, 128)),
    "gemma3-1b": ((1, 1), ("b1", "mlp", "wu"), (1152, 432)),
}


@pytest.mark.parametrize("key", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", sorted(VARIANTS))
def test_attention_variants_count_on_the_production_mesh(arch, key):
    repeats, path, local = VARIANTS[arch]
    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, groups=tuple(
        dataclasses.replace(g, repeat=n) for g, n in zip(cfg.groups, repeats)))
    with fake_world((16, 16)) as mesh:
        model = build_model(cfg, device="cpu", mesh=mesh)
        leaf = model.groups[0][0]
        for k in path:
            leaf = leaf[k]
        assert tuple(leaf.shape) == local
        kw = ({"step_cfg": IplsStepConfig(**TRAIN_OVERRIDES.get(arch, {}))}
              if key.startswith("train") else {})
        built = build_step(model, mesh, SHAPES[key], **kw)
        cost = count_step(built)
        report = analyze_step(built, arch=arch, shape=key, cost=cost)
    assert report.chips == 256 and report.step_time_s > 0
    calls = _totals([(k, i, o) for k, _, i, o in cost.collective_log])
    assert calls["all-gather"][0] > 0
    print(arch, key, calls, report.bottleneck, report.step_time_s)
