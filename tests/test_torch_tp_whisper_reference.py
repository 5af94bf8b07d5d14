"""whisper over a "model" mesh axis above 1 against the JAX reference on
one device: whisper-reduced on gloo (1, 2) (heads, ffn and vocab split) and
(1, 3) (nothing splits), and the production layout of whisper-base at 16
ranks (``whisper-prod``: 3 heads and a vocab of 251 whole, d_ff 128 split)
on (1, 2), through ``tests/torch_tp_whisper_worker.py``, in float32.

The reference runs here, from numpy seeds, and hands the workers a pickle:
its float32 params (drawn by the port, loaded into each rank's shards),
its loss and gradients (``REF_TRAIN``: encoder frames and tokens) and its
prefill's and 8 decode steps' logits (``REF_SERVE``: frames, prompt and
self-cache slots; on (1, 2) 9 frames, whole on every rank), each in float32
and in float64. whisper-reduced's init amplifies float32 rounding
(ROADMAP.md queue 3), so the mesh is held to the reference run in float64
no farther than the reference's own float32 run, plus the dense bounds:
the loss plus 1e-5 (and plus the one-process port's own gap, a witness of
the bf16 logits that two float32 runs round apart), each gradient leaf
plus 2e-3 of its largest, but the
key biases (their exact gradient is 0: within twice the reference's own
noise), as ``test_torch_train_whisper.py`` holds the port in one process;
the logits plus one bf16 ulp of the step's largest, as
``test_torch_whisper.py`` does. The test prints the measured gaps.
"""
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_tp_whisper_worker as worker  # noqa: E402
from test_torch_tp import _spawn, one_torch_thread  # noqa: E402,F401
from test_torch_tp_attn_reference import _drawn_params  # noqa: E402
from torch_train_ref import ref_loss_and_grads  # noqa: E402


def _serve_logits(jmodel, params, frames, tokens, steps, P, T, dtype):
    """The reference's prefill and teacher-forced decode steps (jitted) in
    ``dtype``: their logits, float64 numpy."""
    import jax
    import jax.numpy as jnp

    p = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
    prefill = jax.jit(lambda p, t, e: jmodel.prefill(p, {"tokens": t, "enc_embeds": e,
                                                         "cache_len": T}))
    decode = jax.jit(jmodel.decode_step)
    lg, cache = prefill(p, jnp.asarray(tokens), jnp.asarray(frames, dtype))
    out = [np.asarray(lg, np.float64)]
    for t, tok in enumerate(steps):
        lg, cache = decode(p, cache, {"token": jnp.asarray(tok),
                                      "pos": jnp.asarray(P + t, jnp.int32)})
        out.append(np.asarray(lg, np.float64))
    return out


def _reference(name, M):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.configs import build_model as jax_build
    from repro.configs import get_config as jax_config

    cfg = worker.config(name)
    jmodel = jax_build(worker.config(name, get=jax_config))
    params = _drawn_params(name, cfg=cfg)
    rng = np.random.default_rng(13)
    S_enc, S = worker.REF_TRAIN[M]
    batch = {"tokens": rng.integers(0, cfg.vocab, (worker.B, S)).astype(np.int32),
             "enc_embeds": rng.standard_normal((worker.B, S_enc, cfg.d_model)).astype(np.float32)}
    (l32, g32), (l64, g64) = (ref_loss_and_grads(jmodel, params, batch, float64=f)
                              for f in (False, True))
    S_enc, P, T = worker.REF_SERVE[M]
    tokens = rng.integers(0, cfg.vocab, (worker.B, P)).astype(np.int32)
    frames = rng.standard_normal((worker.B, S_enc, cfg.d_model)).astype(np.float32)
    steps = rng.integers(0, cfg.vocab, (worker.STEPS, worker.B, 1)).astype(np.int32)
    out = {"params": params, "batch": batch, "loss32": l32, "loss64": l64, "grads32": g32,
           "grads64": g64, "serve": (S_enc, P, T), "serve_tokens": tokens,
           "serve_frames": frames, "steps": steps,
           "logits32": _serve_logits(jmodel, params, frames, tokens, steps, P, T, jnp.float32)}
    with jax.enable_x64(True):
        out["logits64"] = _serve_logits(jmodel, params, frames, tokens, steps, P, T, jnp.float64)
    return out


@pytest.fixture(scope="module")
def reference_pickle(tmp_path_factory):
    path = tmp_path_factory.mktemp("tp_whisper_ref") / "ref.pkl"
    cases = {f"{n}/M{shape[1]}": (n, shape[1])
             for shape, names in worker.REF_CASES.items() for n in names}
    with open(path, "wb") as f:
        pickle.dump({k: _reference(*v) for k, v in cases.items()}, f)
    return str(path)


@pytest.mark.parametrize("shape", [(1, 2), (1, 3)], ids=["1x2-heads", "1x3-whole"])
def test_whisper_on_a_mesh_matches_the_reference_in_float64(shape, tmp_path, reference_pickle):
    worst = _spawn(shape, tmp_path, reference_pickle, module=worker)
    for name in worker.REF_CASES[shape]:
        for key in ("ref_loss_of_bound", "ref_grads_of_bound", "ref_bk_grad_noise_of_own",
                    "ref_logits_of_bound"):
            assert worst[f"{name}/{key}"] <= 1.0, (name, key)
