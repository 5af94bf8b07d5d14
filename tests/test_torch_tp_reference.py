"""Tensor parallelism of the dense LMs against the JAX reference on one
device: internlm2-reduced and phi4-mini-reduced (tied) in float32 on gloo
meshes (data, model) = (1, 4) (head-parallel queries, the 2 kv heads
replicated) and (1, 3) (heads, ffn and vocab do not divide:
sequence-parallel attention at the query rows' offset, the MLP and the CE
on the rank's rows), through ``tests/torch_tp_worker.py``, which also
holds each mesh to the port in one process.

The reference runs here, from numpy seeds, and hands the workers a pickle:
its float32 params (loaded into each rank's shards), one train step
(AdamW, clip 1, two microbatches), a prefill and 8 decode steps. Bounds:
the loss within 1e-5 relative; parameters and gradients (AdamW's first
moments) within 2e-3 of each leaf's largest; logits within one bf16 ulp +
1e-5 (the port's existing bounds against the reference).
"""
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.tree import named_leaves  # noqa: E402

import torch_tp_worker as worker  # noqa: E402
from test_torch_tp import _spawn, one_torch_thread  # noqa: E402,F401


def _reference(arch):
    """The reference's float32 params (a numpy tree), its train step (AdamW
    as the worker's, clip 1, two microbatches, one agent) from them, and its
    prefill and 8 decode steps' logits."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.configs import build_model as jax_build
    from repro.configs import get_config as jax_config
    from repro.core import sharded as jsh
    from repro.optim import adamw as jadamw

    B, S, T, STEPS = worker.B, worker.S, worker.T, worker.STEPS
    model = jax_build(jax_config(arch, reduced=True))
    params = jax.tree.map(lambda a: a.astype(jnp.float32), model.init(0))
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    opt = jadamw(worker.LR, wd=0.1)
    step = jax.jit(jsh.make_train_step(model.loss, opt,
                                       jsh.IplsStepConfig(grad_clip=1.0, accum_steps=2),
                                       num_agents=1))
    state, m = step(jsh.init_state(params, opt),
                    {"tokens": jnp.asarray(tokens), "participation": jnp.ones((B,), jnp.float32)})
    serve_tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    steps = rng.integers(0, 256, (STEPS, B, 1)).astype(np.int32)
    prefill = jax.jit(lambda p, t: model.prefill(p, {"tokens": t, "cache_len": T}))
    logits, cache = prefill(params, jnp.asarray(serve_tokens))
    decode = jax.jit(model.decode_step)
    dec_logits = []
    for t in range(STEPS):
        lg, cache = decode(params, cache, {"token": jnp.asarray(steps[t]),
                                           "pos": jnp.asarray(S + t, jnp.int32)})
        dec_logits.append(np.asarray(lg.astype(jnp.float32)))
    return {
        "params": jax.tree.map(np.asarray, params),
        "tokens": tokens, "loss": float(m["loss"]),
        "state": {n: np.asarray(v) for n, v in named_leaves(jax.tree.map(np.asarray, state))},
        "serve_tokens": serve_tokens, "steps": steps,
        "prefill_logits": np.asarray(logits.astype(jnp.float32)),
        "decode_logits": np.stack(dec_logits),
    }


@pytest.fixture(scope="module")
def reference_pickle(tmp_path_factory):
    path = tmp_path_factory.mktemp("tp_ref") / "ref.pkl"
    with open(path, "wb") as f:
        pickle.dump({arch: _reference(arch) for arch in worker.ARCHS}, f)
    return str(path)


@pytest.mark.parametrize("shape", [(1, 4), (1, 3)], ids=["1x4-kv-replicated",
                                                         "1x3-sequence-parallel"])
def test_tp_mesh_equals_one_process_and_reference(shape, tmp_path, reference_pickle):
    worst = _spawn(shape, tmp_path, reference_pickle)
    for arch in worker.ARCHS:
        assert worst[f"{arch}/ref_loss_rel"] <= 1e-5
        assert worst[f"{arch}/ref_params"] <= worker.REF_TOL
        assert worst[f"{arch}/ref_decode_logits_ulps"] <= 1.0
        assert worst[f"{arch}/ref_grads"] <= worker.REF_TOL
        assert worst[f"{arch}/ref_prefill_logits_ulps"] <= 1.0
    # (1, 3) splits no leaf; (1, 4) every matrix but wk and wv (5 a layer) and
    # both tables
    n_split = worst["internlm2-1.8b/init_split_leaves"]
    assert n_split == 0 if shape == (1, 3) else n_split == 5 * 2 + 2
