"""The attention variants over a "model" mesh axis above 1 against the JAX
reference on one device: gemma3-reduced (sliding windows) and
qwen2-vl-reduced (M-RoPE, with positions3 that are not the token positions;
``test_torch_tp_mla_reference.py`` holds deepseek's MLA alike) in float32
on gloo meshes (data, model) = (1, 2) (head-parallel: 4 heads over 2) and
(1, 3) (sequence-parallel: the query rows at their offset; gemma3 with
6-slot windows, whose rings split over 3), through
``tests/torch_tp_attn_worker.py``.

The reference runs here, from numpy seeds, and hands the workers a pickle:
its float32 params (drawn by the port in its layout, loaded into each
rank's shards), one train step (AdamW,
clip 1, two microbatches, one for qwen2-vl: ``worker.accum_steps``), a
prefill and 8 decode steps. Bounds: the loss within 1e-5 relative;
parameters and gradients (AdamW's first moments) within 2e-3 of each leaf's
largest (elements whose gradient is float32 noise, below 1e-3 of the
leaf's largest, within the learning rate: AdamW's first step moves them by
a share of it); logits within one bf16 ulp + 1e-5 (the port's bounds
against the reference). Each test prints its measured gaps.
"""
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.tree import named_leaves  # noqa: E402

import torch_tp_attn_worker as worker  # noqa: E402
from test_torch_tp import _spawn, one_torch_thread  # noqa: E402,F401


def _drawn_params(name, cfg=None, redraw=None, module=worker):
    """float32 params in the reference's layout (a numpy tree), drawn by
    the port from seed 0 (the reference's init, without its per-leaf
    compiles: deepseek-reduced's ``init`` takes 14 s on the CPU); ``cfg``
    by default ``module.config(name, lossless=True)``; ``redraw(model)``
    may overwrite leaves first."""
    from repro_torch.configs import build_model
    from repro_torch.core.sharded import IplsTrainState
    from repro_torch.models.convert import to_reference_layout

    one = build_model(cfg or module.config(name, lossless=True), device="cpu", seed=0).float()
    if redraw is not None:
        redraw(one)
    state = IplsTrainState(step=torch.zeros((), dtype=torch.int32), params=one.params(),
                           opt_state=(), eps=torch.ones(()))
    return module.tw._numpy_tree(to_reference_layout(state).params)


def _reference(name, config=None, drawn=None, float64=False, module=worker):
    """The reference's float32 params (a numpy tree), its train step from
    them, and its prefill's and decode steps' logits (the worker
    ``module``'s B, S, T and STEPS: by default a prompt of 12, a cache of
    24 and 8 steps); with ``float64`` also those logits from the params in
    float64 (``prefill_logits64``, ``decode_logits64``). ``config(get)``
    gives the config from a package's ``get_config`` (by default
    ``module.config(name, lossless=True)``); ``drawn`` the params (by
    default ``_drawn_params(name)``)."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.configs import build_model as jax_build
    from repro.configs import get_config as jax_config
    from repro.core import sharded as jsh
    from repro.optim import adamw as jadamw

    B, S, T, STEPS = module.B, module.S, module.T, module.STEPS
    cfg = (config or (lambda get: module.config(name, lossless=True, get=get)))(jax_config)
    model = jax_build(cfg)
    params = jax.tree.map(jnp.asarray, drawn if drawn is not None
                          else _drawn_params(name, module=module))
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    opt = jadamw(module.LR, wd=0.1)
    step = jax.jit(jsh.make_train_step(
        model.loss, opt, jsh.IplsStepConfig(grad_clip=1.0, accum_steps=module.accum_steps(cfg)),
        num_agents=1))
    batch = {k: jnp.asarray(v.numpy()) for k, v in
             module.train_batch(cfg, torch.from_numpy(tokens)).items()}
    state, m = step(jsh.init_state(params, opt), batch)
    serve_tokens = rng.integers(0, 256, (B, S)).astype(np.int32)
    steps = rng.integers(0, 256, (STEPS, B, 1)).astype(np.int32)
    serve = {k: (jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v) for k, v in
             module.serve_batch(cfg, torch.from_numpy(serve_tokens)).items()}
    cache_len = serve.pop("cache_len")
    prefill = jax.jit(lambda p, b: model.prefill(p, dict(b, cache_len=cache_len)))
    decode = jax.jit(model.decode_step)

    def serve_logits(params, out_dtype):
        logits, cache = prefill(params, serve)
        dec_logits = []
        for t in range(STEPS):
            lg, cache = decode(params, cache, {"token": jnp.asarray(steps[t]),
                                               "pos": jnp.asarray(S + t, jnp.int32)})
            dec_logits.append(np.asarray(lg.astype(out_dtype)))
        return np.asarray(logits.astype(out_dtype)), np.stack(dec_logits)

    prefill_logits, decode_logits = serve_logits(params, jnp.float32)
    out = {
        "params": jax.tree.map(np.asarray, params),
        "tokens": tokens, "loss": float(m["loss"]),
        "state": {n: np.asarray(v) for n, v in named_leaves(jax.tree.map(np.asarray, state))},
        "serve_tokens": serve_tokens, "steps": steps,
        "prefill_logits": prefill_logits, "decode_logits": decode_logits,
    }
    if float64:
        with jax.enable_x64(True):
            p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), out["params"])
            out["prefill_logits64"], out["decode_logits64"] = serve_logits(p64, jnp.float64)
    return out


NAMES = ("gemma3-1b", "gemma3-window6", "qwen2-vl-72b")


@pytest.fixture(scope="module")
def reference_pickle(tmp_path_factory):
    path = tmp_path_factory.mktemp("tp_attn_ref") / "ref.pkl"
    with open(path, "wb") as f:
        pickle.dump({n: _reference(n) for n in NAMES}, f)
    return str(path)


def check_worst(worst, shape, names):
    """The bounds of the module docstring, for ``names``' cases on ``shape``."""
    cases = [n for n in worker.REF_CASES[shape] if n in names]
    assert cases
    for name in cases:
        assert worst[f"{name}/ref_loss_rel"] <= 1e-5
        assert worst[f"{name}/ref_params"] <= worker.REF_TOL
        assert worst[f"{name}/ref_params_noise_gradients_over_lr"] <= worker.NOISE_LR
        assert worst[f"{name}/ref_grads"] <= worker.REF_TOL
        assert worst[f"{name}/ref_prefill_logits_ulps"] <= 1.0
        assert worst[f"{name}/ref_decode_logits_ulps"] <= 1.0


@pytest.mark.parametrize("shape", [(1, 2), (1, 3)], ids=["1x2-head-parallel",
                                                         "1x3-sequence-parallel"])
def test_windows_and_mrope_match_the_reference_on_a_mesh(shape, tmp_path, reference_pickle):
    check_worst(_spawn(shape, tmp_path, reference_pickle, module=worker), shape, NAMES)
