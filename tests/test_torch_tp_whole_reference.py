"""Prompts and caches that do not divide the "model" axis against the JAX
reference on one device: internlm2-, gemma3- and qwen2-vl-reduced on
(data, model) = (1, 3), a prompt of 10 and a cache of 14 (every leaf
whole on every rank, the blocks run alike), through
``tests/torch_tp_whole_worker.py``: the reference's float32 params (drawn
by the port, loaded into each rank's shards), one train step (AdamW, clip
1, two microbatches, one for qwen2-vl), a prefill and 3 decode steps, with
``test_torch_tp_attn_reference.py``'s bounds (the loss within 1e-5
relative, parameters and gradients within 2e-3 of each leaf's largest,
logits within one bf16 ulp + 1e-5), but elements whose gradient is
float32 noise within 2 learning rates (``worker.REF_NOISE_LR``: ROADMAP.md
queue 3)."""
import pickle

import pytest

torch = pytest.importorskip("torch")

import torch_tp_whole_worker as worker  # noqa: E402
from test_torch_tp import one_torch_thread  # noqa: E402,F401
from test_torch_tp_attn_reference import _reference  # noqa: E402
from test_torch_tp_whole import spawn_job  # noqa: E402


@pytest.fixture(scope="module")
def worst(tmp_path_factory):
    """One spawn on (1, 3) against the reference's results of every case."""
    tmp = tmp_path_factory.mktemp("tp_whole_ref")
    path = tmp / "ref.pkl"
    with open(path, "wb") as f:
        pickle.dump({n: _reference(n, module=worker) for n in worker.REF_CASES}, f)
    return spawn_job("dense", (1, 3), tmp, str(path))


@pytest.mark.parametrize("name", worker.REF_CASES)
def test_whole_rows_match_the_reference_on_1x3(name, worst):
    assert worst[f"{name}/ref_loss_rel"] <= 1e-5
    assert worst[f"{name}/ref_params"] <= worker.aw.REF_TOL
    assert worst[f"{name}/ref_params_noise_gradients_over_lr"] <= worker.REF_NOISE_LR
    assert worst[f"{name}/ref_grads"] <= worker.aw.REF_TOL
    assert worst[f"{name}/ref_prefill_logits_ulps"] <= 1.0
    assert worst[f"{name}/ref_decode_logits_ulps"] <= 1.0
