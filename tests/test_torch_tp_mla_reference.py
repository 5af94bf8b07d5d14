"""MLA over a "model" mesh axis above 1 against the JAX reference on one
device: deepseek-reduced's lossless copy (every MoE capacity at all the
choices) in float32 on gloo meshes (data, model) = (1, 2) (head-parallel:
wq, wuk, wuv and wo split over its 4 heads; expert-parallel MoE) and (1, 3)
(sequence-parallel: the query rows at their offset against the gathered
latent and k_rope; replicated MoE), through ``tests/torch_tp_attn_worker.py``,
with ``test_torch_tp_attn_reference.py``'s reference run and bounds
(deepseek's router within the MoE family's 5e-3 of its largest).
"""
import pickle

import pytest

torch = pytest.importorskip("torch")

import torch_tp_attn_worker as worker  # noqa: E402
from test_torch_tp import _spawn, one_torch_thread  # noqa: E402,F401
from test_torch_tp_attn_reference import _reference, check_worst  # noqa: E402

NAME = "deepseek-v2-lite-16b"


@pytest.fixture(scope="module")
def reference_pickle(tmp_path_factory):
    path = tmp_path_factory.mktemp("tp_mla_ref") / "ref.pkl"
    with open(path, "wb") as f:
        pickle.dump({NAME: _reference(NAME)}, f)
    return str(path)


@pytest.mark.parametrize("shape", [(1, 2), (1, 3)], ids=["1x2-head-parallel",
                                                         "1x3-sequence-parallel"])
def test_mla_matches_the_reference_on_a_mesh(shape, tmp_path, reference_pickle):
    worst = _spawn(shape, tmp_path, reference_pickle, module=worker)
    check_worst(worst, shape, (NAME,))
    assert worst[f"{NAME}/ref_grads_router"] <= worker.REF_ROUTER_TOL
    assert worst[f"{NAME}/ref_params_router"] <= worker.REF_ROUTER_TOL
