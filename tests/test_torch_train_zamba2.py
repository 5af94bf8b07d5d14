"""zamba2's training (Mamba2 blocks, shared attention and MLP blocks) in the
port against the JAX package's, on the CPU.

zamba2-reduced (two periods of 2 Mamba2 blocks, each followed by the one
shared attention + MLP pair, then one more Mamba2 block; chunks of 16),
float32 weights carried across bit for bit, tokens (4, 32) from a numpy
seed:

- ``loss``: the per-example loss within 1e-5 (measured 4.8e-7) and every
  gradient leaf within 2e-3 of that leaf's largest |gradient| (measured
  1.1e-3, on a Mamba2 block's ``dt_bias``), the dense family's bounds. The
  Mamba2 blocks amplify float32 rounding (ROADMAP.md queue 3): the
  reference's own float32 gradients lie 2.9e-4 of a leaf's largest from its
  float64 ones on these inputs, the port's 7.9e-4; the direct bound holds
  all the same. The shared blocks' gradients are the sum over their two
  applications, as the reference's;
- Mamba2's training forward (grad enabled, the scan's chain out of place)
  equals the no-grad prefill's output and final state bit for bit, in
  float32 and bfloat16, at a T that pads the last chunk;
- the Mamba2 block's gradients against ``jax.grad`` of the reference's
  ``apply_mamba2`` alone (the convolution, the ``dt`` softplus, the scan,
  the gated norm): within 1e-4 of each leaf's largest.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.models import ssm
from repro_torch.models.param_defs import init_values
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

ARCH = "zamba2-1.2b"


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
    assert any(k.startswith("['g0_shared']") for k in got)
    d_loss = float(np.abs(got_loss - want_loss).max())
    worst = worst_relative(got, want)
    print(f"{ARCH}: loss max |d| {d_loss:.3g}, grads max |d| / max |g| {worst:.3g}")
    assert d_loss <= 1e-5, d_loss
    assert worst <= 2e-3, worst


def _mamba_block(dtype, seed=0):
    spec = next(b.mamba for g in get_config(ARCH, reduced=True).groups for b in g.blocks)
    gen = torch.Generator().manual_seed(seed)
    params = init_values(ssm.init_mamba2(spec), gen, torch.device("cpu"))
    params["A_log"] = torch.rand(spec.n_heads, generator=gen) - 0.5
    params["dt_bias"] = torch.rand(spec.n_heads, generator=gen) - 0.5
    params = {k: (v.to(dtype) if not isinstance(v, dict) else
                  {kk: vv.to(dtype) for kk, vv in v.items()}) for k, v in params.items()}
    x = torch.randn(2, 3 * spec.chunk + 5, spec.d_model, generator=gen).to(dtype)
    return spec, params, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mamba2_training_forward_equals_prefill_bitwise(dtype):
    spec, params, x = _mamba_block(dtype)
    with torch.no_grad():
        y0, final0 = ssm.apply_mamba2(params, spec, x)
    leaves = [t.requires_grad_(True) for _, t in named_leaves(params)]
    y1, final1 = ssm.apply_mamba2(params, spec, x)
    assert y1.requires_grad
    assert torch.equal(y0, y1.detach()) and torch.equal(final0, final1.detach())
    grads = torch.autograd.grad(y1.float().square().sum(), leaves)
    assert all(torch.isfinite(g).all() for g in grads)


def test_mamba2_block_grads_match_reference():
    jax, jnp = jax_modules()
    from repro.models import ssm as jssm

    spec, params, x = _mamba_block(torch.float32, seed=1)
    np_params = {k: (v.numpy() if not isinstance(v, dict) else
                     {kk: vv.numpy() for kk, vv in v.items()}) for k, v in params.items()}
    dout = np.random.default_rng(2).standard_normal(tuple(x.shape)).astype(np.float32)
    jspec = jssm.Mamba2Spec(**{f: getattr(spec, f) for f in
                               ("d_model", "d_state", "head_dim", "expand", "d_conv", "chunk")})

    def jf(p, x):
        return (jssm.apply_mamba2(p, jspec, x)[0] * dout).sum()

    jg = jax.jit(jax.grad(jf, argnums=(0, 1)))(jax.tree.map(jnp.asarray, np_params),
                                                jnp.asarray(x.numpy()))
    names = [n for n, _ in named_leaves(params)]
    tx = x.clone().requires_grad_(True)
    leaves = [t.requires_grad_(True) for _, t in named_leaves(params)]
    y, _ = ssm.apply_mamba2(params, spec, tx)
    grads = torch.autograd.grad((y * torch.from_numpy(dout)).sum(), [tx] + leaves)
    want = dict(named_leaves(jax.tree.map(np.asarray, jg[0])))
    assert sorted(want) == names
    pairs = [(grads[0], np.asarray(jg[1]))] + [(g, want[n]) for g, n in zip(grads[1:], names)]
    worst = max(float(np.abs(g.numpy() - w).max()) / float(np.abs(w).max()) for g, w in pairs)
    print(f"Mamba2 block grads max |d| / max |g| {worst:.3g}")
    assert worst <= 1e-4, worst
