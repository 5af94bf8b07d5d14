"""Shared helpers of the port's training tests against the JAX package
(``tests/test_torch_train_*.py``): the reference's reduced model and params,
a batch drawn from a numpy seed (tokens, and whisper's frames), the
reference's per-example loss and ``jax.grad`` of its mean (in float32, or
in float64 under ``jax.enable_x64``), the port's loss and autograd
gradients by the reference's leaf names, and the gap of two gradient trees
leaf by leaf.

RWKV6's ``mu_*``, ``u`` and ``w0`` leaves are redrawn from a numpy seed
before both sides load them (``randomize_rwkv``, as
``tests/test_torch_rwkv.py`` does): the reference inits them to 1, 0 and 0,
which would leave the token shift's mix and the bonus term unexercised.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import build_model, get_config
from repro_torch.core.sharded import IplsTrainState
from repro_torch.models.convert import load_jax_params, to_reference_layout
from repro_torch.tree import named_leaves, tree_leaves, tree_unflatten

B, S = 4, 32  # S: four of gemma3-reduced's 8-key windows, two zamba2-reduced chunks


def jax_modules():
    jax = pytest.importorskip("jax")  # the reference; absent on a GPU host
    return jax, jax.numpy


def randomize_rwkv(tree, rng):
    """The numpy tree with its mu_*, u and w0 leaves redrawn (same dtype):
    mu in [0, 1), u ~ N(0, 0.25), w0 in [-3, 2)."""
    out = {}
    for name, a in tree.items():
        if isinstance(a, dict):
            out[name] = randomize_rwkv(a, rng)
        elif name.startswith("mu_"):
            out[name] = rng.uniform(0.0, 1.0, a.shape).astype(np.float32).astype(a.dtype)
        elif name == "u":
            out[name] = (rng.standard_normal(a.shape) * 0.5).astype(np.float32).astype(a.dtype)
        elif name == "w0":
            out[name] = rng.uniform(-3.0, 2.0, a.shape).astype(np.float32).astype(a.dtype)
        else:
            out[name] = a
    return out


def ref_model(arch):
    """The reference's reduced model and its float32 params as a numpy
    tree (drawn under jit; RWKV6's mix, bonus and decay leaves redrawn)."""
    jax, jnp = jax_modules()
    from repro.configs import build_model as jax_build
    from repro.configs import get_config as jax_config

    model = jax_build(jax_config(arch, reduced=True))
    params = jax.jit(lambda: model.init(0))()
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), params)
    if arch == "rwkv6-7b":
        tree = randomize_rwkv(tree, np.random.default_rng(7))
    return model, tree


def draw_batch(arch, seed=0, b=B, s=S):
    """Tokens (b, s) int32 and, for whisper, s frames (b, s, d_model)
    float32, from a numpy seed."""
    rng = np.random.default_rng(seed)
    cfg = get_config(arch, reduced=True)
    batch = {"tokens": rng.integers(0, 256, (b, s)).astype(np.int32)}
    if arch == "whisper-base":
        batch["enc_embeds"] = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    return batch


def ref_loss_and_grads(model, tree, batch, float64=False):
    """The reference's per-example loss (numpy) and the gradients of its
    mean by leaf name (numpy), jitted; with ``float64`` the params and
    frames cast up and run under ``jax.enable_x64``."""
    jax, jnp = jax_modules()

    def run(dtype):
        params = jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
        jb = {k: jnp.asarray(v, dtype if v.dtype.kind == "f" else None) for k, v in batch.items()}
        per_ex = jax.jit(lambda p: model.loss(p, jb)[0])(params)
        grads = jax.jit(jax.grad(lambda p: model.loss(p, jb)[0].mean()))(params)
        return (np.asarray(per_ex, np.float64),
                {k: np.asarray(v, np.float64) for k, v in named_leaves(grads)})

    if not float64:
        return run(jnp.float32)
    with jax.enable_x64(True):
        return run(jnp.float64)


def port_model(arch, tree):
    return load_jax_params(build_model(get_config(arch, reduced=True), device="cpu"), tree)


def port_loss_and_grads(model, batch):
    """The port's per-example loss (numpy) and the gradients of its mean by
    the reference's leaf names (numpy), through detached aliases of the
    params as the train step takes them."""
    params = model.params()
    alias = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    per_ex, _ = model.loss(tree_unflatten(params, alias),
                           {k: torch.from_numpy(v) for k, v in batch.items()})
    assert per_ex.shape == (batch["tokens"].shape[0],) and per_ex.dtype == torch.float32
    grads = torch.autograd.grad(per_ex.mean(), alias)
    tree = IplsTrainState(torch.zeros(()), tree_unflatten(params, list(grads)), (),
                          torch.zeros(()))
    return (per_ex.detach().double().numpy(),
            {k: v.double().numpy() for k, v in named_leaves(to_reference_layout(tree).params)})


def leaf_gaps(got, want):
    """Per leaf: (max |got - want|, max |want|)."""
    assert got.keys() == want.keys(), sorted(set(got) ^ set(want))
    return {k: (float(np.abs(got[k] - w).max()), float(np.abs(w).max())) for k, w in want.items()}


def worst_relative(got, want):
    """The largest, over the leaves, of max |got - want| over max |want|."""
    return max(d / max(scale, 1e-30) for d, scale in leaf_gaps(got, want).values())
