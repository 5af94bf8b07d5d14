"""The recurrent families over a "model" mesh axis above 1 against the JAX
reference on one device: zamba2-reduced (Mamba2, its shared attention and
MLP blocks) here, rwkv6-reduced (time and channel mix) and its copy with 4
heads in ``test_torch_tp_rwkv_reference.py`` (each file a reference run of
its own), in float32 on gloo meshes (data, model) = (1, 2) (the heads split
where they divide: zamba2's 2 Mamba2 heads one a rank, its in-projection
gathered; rwkv6-reduced's one head split in halves, run whole) and (1, 3)
(nothing splits: each rank runs the blocks whole), through
``tests/torch_tp_ssm_worker.py``.

The reference runs here, from numpy seeds, and hands the workers a pickle:
its float32 params (drawn by the port in its layout, RWKV6's ``mu_*``,
``u`` and ``w0`` redrawn, since the reference inits them to 1, 0 and 0,
and loaded into each rank's shards), one train step (AdamW, clip 1, two
microbatches), a prefill and 8 decode steps. Bounds (the port's training
against the reference): the loss within 1e-5 relative; parameters and
gradients (AdamW's first moments) within 2e-3 of each leaf's largest
(elements whose gradient is float32 noise within the learning rate);
rwkv6's logits within one bf16 ulp + 1e-5; zamba2's by the float64 rule
of ROADMAP.md queue 3 (no farther from the reference's float64 run than
its own float32 run, plus one bf16 ulp of the step's largest and 1e-5:
the reduced Mamba2 blocks amplify float32 rounding past one bf16 ulp
between any two float32 runs). The test prints the measured gaps.
"""
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_tp_attn_worker as aw  # noqa: E402
import torch_tp_ssm_worker as worker  # noqa: E402
from test_torch_tp import _spawn, one_torch_thread  # noqa: E402,F401
from test_torch_tp_attn_reference import _drawn_params, _reference  # noqa: E402

NAMES = ("zamba2-1.2b",)


def _redraw_rwkv6(model):
    """RWKV6's ``mu_*``, ``u`` and ``w0`` drawn from seed 3 (the reference's
    init sets them to 1, 0 and 0, which leaves the token shift's mix, the
    bonus and the decay's offset untested)."""
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for layer in model.groups[0]:
            for blk in ("b0", "b1"):
                tree = layer[blk]["rwkv" if blk == "b0" else "rwkv_ffn"]
                for k, v in tree.as_dict().items():
                    if k.startswith("mu_") or k in ("u", "w0"):
                        scale, shift = (0.3, 0.5) if k.startswith("mu_") else (0.5, 0.0)
                        v.copy_(torch.from_numpy(rng.standard_normal(v.shape) * scale + shift))


def _reference_of(name):
    rwkv = name.startswith("rwkv6")
    drawn = _drawn_params(name, cfg=worker.config(name),
                          redraw=_redraw_rwkv6 if rwkv else None)
    return _reference(name, config=lambda get: worker.config(name, get=get), drawn=drawn,
                      float64=not rwkv)


def reference_pickle_of(names, path):
    with open(path, "wb") as f:
        pickle.dump({n: _reference_of(n) for n in names}, f)
    return str(path)


@pytest.fixture(scope="module")
def reference_pickle(tmp_path_factory):
    return reference_pickle_of(NAMES, tmp_path_factory.mktemp("tp_ssm_ref") / "ref.pkl")


def check_against_reference(shape, tmp_path, path, names):
    """One spawn of the worker on ``shape`` with the reference's results of
    ``names``: the module docstring's bounds."""
    worst = _spawn(shape, tmp_path, path, module=worker)
    cases = [n for n in worker.REF_CASES[shape] if n in names]
    assert cases
    for name in cases:
        assert worst[f"{name}/ref_loss_rel"] <= 1e-5
        assert worst[f"{name}/ref_params"] <= aw.REF_TOL
        assert worst[f"{name}/ref_params_noise_gradients_over_lr"] <= aw.NOISE_LR
        assert worst[f"{name}/ref_grads"] <= aw.REF_TOL
        for what in ("prefill", "decode"):
            key = (f"{name}/ref_{what}_logits_of_float64_bound" if name.startswith("zamba2")
                   else f"{name}/ref_{what}_logits_ulps")
            assert worst[key] <= 1.0


@pytest.mark.parametrize("shape", [(1, 2), (1, 3)], ids=["1x2-heads", "1x3-whole"])
def test_mamba2_and_shared_blocks_match_the_reference_on_a_mesh(shape, tmp_path,
                                                                 reference_pickle):
    check_against_reference(shape, tmp_path, reference_pickle, NAMES)
