"""gemma3's training forward and gradients in the port against the JAX
package's, on the CPU.

gemma3-reduced (2 x (5 local + 1 global) attention + GeGLU layers, then 2
local ones; 8-key windows, qk-norm, the embedding scale, tied logits),
float32 weights carried across bit for bit, tokens (4, 32) from a numpy
seed, so every local layer's window cuts its causal mask:

- ``loss``: the per-example loss within 1e-5 (measured 9.5e-7) and every
  gradient leaf within 2e-3 of that leaf's largest |gradient| (measured
  1.2e-5), the dense family's bounds (``test_torch_train_lm.py``);
- the windowed training attention (``layers.apply_attention`` of a local
  layer's spec) and its gradients against the reference's at the full
  config's window of 512 over 1,100 positions, in float32: output within
  1e-5 of its largest (measured 2.2e-6), gradients within 1e-4 of each
  one's largest (measured 2.5e-6); it differs from the same layer without
  its window.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.tree import named_leaves
from torch_train_ref import (
    draw_batch,
    jax_modules,
    port_loss_and_grads,
    port_model,
    ref_loss_and_grads,
    ref_model,
    worst_relative,
)

ARCH = "gemma3-1b"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small products: run torch on one thread (no numeric effect:
    both sides of every comparison run in this process), and give the pool
    back afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_loss_and_grads_match_reference():
    model, tree = ref_model(ARCH)
    batch = draw_batch(ARCH)
    want_loss, want = ref_loss_and_grads(model, tree, batch)
    got_loss, got = port_loss_and_grads(port_model(ARCH, tree), batch)
    d_loss = float(np.abs(got_loss - want_loss).max())
    worst = worst_relative(got, want)
    print(f"{ARCH}: loss max |d| {d_loss:.3g}, grads max |d| / max |g| {worst:.3g}")
    assert d_loss <= 1e-5, d_loss
    assert worst <= 2e-3, worst


def test_windowed_training_attention_matches_reference():
    """A local layer of the full config (4 query heads on 1 kv head of
    256, qk-norm, window 512) at d_model 64, over 1,100 positions."""
    jax, jnp = jax_modules()
    from repro.models import layers as JL

    full = next(b.attn for g in get_config(ARCH).groups for b in g.blocks
                if b.kind == "attn" and b.attn.window)
    spec = dataclasses.replace(full, d_model=64)
    assert spec.window == 512 and spec.kv_heads == 1 and spec.head_dim == 256
    from repro.configs import get_config as jax_config

    jfull = next(b.attn for g in jax_config(ARCH).groups for b in g.blocks
                 if b.kind == "attn" and b.attn.window)
    jspec = dataclasses.replace(jfull, d_model=64)
    rng = np.random.default_rng(3)
    defs = L.init_attention(spec)
    params = {k: (rng.standard_normal(d.shape) * (0.1 if k.startswith("w") else 1.0)
                  ).astype(np.float32) if not isinstance(d, dict) else
              {kk: (1.0 + 0.1 * rng.standard_normal(dd.shape)).astype(np.float32)
               for kk, dd in d.items()} for k, d in defs.items()}
    x = rng.standard_normal((1, 1100, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(1100)[None], (1, 1100)).astype(np.int32)
    dout = rng.standard_normal((1, 1100, 64)).astype(np.float32)

    def jf(p, x):
        return (JL.apply_attention(p, jspec, x, jnp.asarray(pos)) * dout).sum()

    jp = jax.tree.map(jnp.asarray, params)
    j_out = np.asarray(jax.jit(lambda p, x: JL.apply_attention(p, jspec, x, jnp.asarray(pos)))(
        jp, jnp.asarray(x)))
    j_grads = jax.jit(jax.grad(jf, argnums=(0, 1)))(jp, jnp.asarray(x))

    tp = {k: (torch.tensor(v, requires_grad=True) if not isinstance(v, dict) else
              {kk: torch.tensor(vv, requires_grad=True) for kk, vv in v.items()})
          for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    out = L.apply_attention(tp, spec, tx, torch.from_numpy(pos))
    names = [n for n, _ in named_leaves(tp)]
    grads = torch.autograd.grad((out * torch.from_numpy(dout)).sum(),
                                [tx] + [t for _, t in named_leaves(tp)])
    want = dict(named_leaves(jax.tree.map(np.asarray, j_grads[0])))
    assert sorted(want) == names
    pairs = [(grads[0], np.asarray(j_grads[1]))] + [(g, want[n]) for g, n in zip(grads[1:], names)]
    d_out = float(np.abs(out.detach().numpy() - j_out).max()) / float(np.abs(j_out).max())
    worst = max(float(np.abs(g.numpy() - w).max()) / float(np.abs(w).max()) for g, w in pairs)
    print(f"windowed attention: out max |d| / max |out| {d_out:.3g}, grads {worst:.3g} "
          f"(max |out| {float(np.abs(j_out).max()):.3g})")
    assert d_out <= 1e-5, d_out
    assert worst <= 1e-4, worst
    with torch.no_grad():
        unwindowed = L.apply_attention(tp, dataclasses.replace(spec, window=None), tx,
                                       torch.from_numpy(pos))
    assert float((unwindowed - out.detach()).abs().max()) > 1e-2  # the window is applied
