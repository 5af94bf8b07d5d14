"""The roofline's count of the fsdp train step (``IplsStepConfig(fsdp=True)``)
on fake tensors: deepseek-v2-lite-16b at full width, cut to the
``train_mla`` cell's depth (the dense layer and 5 MoE layers), on
``fake_world((16, 1))`` (16 data ranks), with and without fsdp.

* all-gathers: one per stored leaf where the loss uses it: each layer's
  leaves twice (the forward and the recompute of its checkpoint), the
  embedding, the final norm and the head once; a rank receives 15/16 of
  each gathered leaf (its out bytes less its in bytes). Nothing else is
  gathered: no LoadModel all-gather after the update;
* reduce-scatters: the same bytes as the step without fsdp (each leaf's
  gradient once, in the parameter's dtype: the gather's backward instead
  of UpdateModel);
* peak memory: lower by at least 15/16 of the parameters' bytes, less the
  largest layer's (a layer's gathered weights live inside its checkpoint).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ShapeSpec, build_model, get_config  # noqa: E402
from repro_torch.core.sharded import IplsStepConfig, owned_dim, tree_leaves_of_specs  # noqa: E402
from repro_torch.launch.steps import build_train_step  # noqa: E402
from repro_torch.roofline.cost import count_step, fake_world  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

from test_torch_tp import one_torch_thread  # noqa: E402,F401

ARCH, MOE_LAYERS, D = "deepseek-v2-lite-16b", 5, 16
B, S = 16, 256


def _config():
    cfg = get_config(ARCH)
    return dataclasses.replace(cfg, groups=cfg.groups[:1] + (
        dataclasses.replace(cfg.groups[1], repeat=MOE_LAYERS),))


def _count(fsdp: bool):
    """(cost, {leaf group: [(bytes, split)]}) of one train step."""
    with fake_world((D, 1)) as mesh:
        model = build_model(_config(), device="cpu")
        built = build_train_step(model, mesh, ShapeSpec("t", S, B, "train"),
                                 step_cfg=IplsStepConfig(fsdp=fsdp))
        whole = model.params()
        specs = tree_leaves_of_specs(built.update_shardings, whole)
        it = iter(specs)
        leaves = {}
        for key in sorted(whole):
            group = whole[key] if isinstance(whole[key], list) else [whole[key]]
            for li, tree in enumerate(group):
                leaves[(key, li)] = [(t.numel() * t.element_size(), owned_dim(next(it)) is not None)
                                     for t in tree_leaves(tree)]
        cost = count_step(built)
    return cost, leaves


@pytest.fixture(scope="module")
def counts():
    return _count(False), _count(True)


def test_fsdp_gathers_each_stored_leaf_where_it_is_used(counts):
    (plain, leaves), (fsdp, _) = counts
    layer_split = sum(b for k, ls in leaves.items() if k[0].startswith("g") for b, s in ls if s)
    other_split = sum(b for k, ls in leaves.items() if not k[0].startswith("g") for b, s in ls if s)
    n_layer = sum(s for k, ls in leaves.items() if k[0].startswith("g") for _, s in ls)
    n_other = sum(s for k, ls in leaves.items() if not k[0].startswith("g") for _, s in ls)
    gathers = [(n, i, o) for kind, n, i, o in fsdp.collective_log if kind == "all-gather"]
    assert all(n == D and o == D * i for n, i, o in gathers)
    assert len(gathers) == 2 * n_layer + n_other
    received = sum(o - i for _, i, o in gathers)
    assert received == (2 * layer_split + other_split) * (D - 1) // D
    # the step without fsdp gathers every split leaf once, after the update (LoadModel)
    loads = [o for kind, _, _, o in plain.collective_log if kind == "all-gather"]
    assert sum(loads) == layer_split + other_split
    print(f"all-gather: fsdp {received / 1e9:.3f} GB received a rank, "
          f"LoadModel {sum(loads) * (D - 1) / D / 1e9:.3f} GB")


def test_fsdp_reduce_scatters_as_the_step_without_it(counts):
    (plain, _), (fsdp, _) = counts
    assert fsdp.collective_bytes["reduce-scatter"] == plain.collective_bytes["reduce-scatter"] > 0
    assert fsdp.collective_bytes["all-reduce"] == plain.collective_bytes["all-reduce"]


def test_fsdp_peak_is_lower_by_the_stored_share(counts):
    (plain, leaves), (fsdp, _) = counts
    params = sum(b for ls in leaves.values() for b, _ in ls)
    largest_layer = max(sum(b for b, _ in ls) for k, ls in leaves.items() if k[0].startswith("g"))
    saved = plain.peak_bytes - fsdp.peak_bytes
    print(f"peak: {plain.peak_bytes / 1e9:.3f} GB without fsdp, {fsdp.peak_bytes / 1e9:.3f} GB "
          f"with it; parameters {params / 1e9:.3f} GB")
    assert saved >= params * (D - 1) / D - largest_layer
