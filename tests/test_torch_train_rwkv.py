"""RWKV6's training (the time mix through the plain chunked scan, the
channel mix) in the port against the JAX package's, on the CPU.

rwkv6-reduced (2 x (time mix + channel mix), d_model 64, one head of 64,
chunks of 8), float32 weights carried across bit for bit with its ``mu_*``,
``u`` and ``w0`` leaves redrawn from a numpy seed (``torch_train_ref``),
tokens (4, 32) from a numpy seed:

- ``loss``: the per-example loss within 1e-5 (measured 9.5e-7) and every
  gradient leaf within 2e-3 of that leaf's largest |gradient| (measured
  3.9e-5), the dense family's bounds;
- the training time mix (``ssm.train_rwkv6_time``: ``rwkv6_chunked`` under
  autograd) equals the prefill's (``apply_rwkv6_time``, whose scan wrapper
  takes the same chunked version on CPU tensors) bit for bit; on a card
  (``-m cuda``) the loss launches no kernel while the prefill still
  launches the scan kernel once per time-mix layer.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import build_model, get_config
from repro_torch.kernels.linear_scan import ops as scan_ops
from repro_torch.models import ssm
from torch_train_ref import (
    draw_batch,
    port_loss_and_grads,
    port_model,
    ref_loss_and_grads,
    ref_model,
    worst_relative,
)

ARCH = "rwkv6-7b"


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


def test_training_time_mix_equals_prefill_on_cpu():
    model = build_model(get_config(ARCH, reduced=True), device="cpu").float()
    block = model.cfg.groups[0].blocks[0]
    p = model.params()["g0"][0]["b0"]["rwkv"]
    x = torch.randn(2, 21, block.rwkv.d_model, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want, _, _ = ssm.apply_rwkv6_time(p, block.rwkv, x)
    xg = x.clone().requires_grad_(True)
    got = ssm.train_rwkv6_time(p, block.rwkv, xg)
    assert torch.equal(got.detach(), want)
    (g,) = torch.autograd.grad(got.square().sum(), [xg])
    assert torch.isfinite(g).all() and g.abs().max() > 0


@pytest.mark.cuda
def test_cuda_training_launches_no_kernel_and_prefill_the_scan():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on a GPU host)")
    model = build_model(get_config(ARCH, reduced=True), device="cuda")
    tokens = torch.from_numpy(draw_batch(ARCH)["tokens"])
    n0 = scan_ops.rwkv6_scan.LAUNCHES
    per_ex, _ = model.loss(model.params(), {"tokens": tokens})
    assert torch.isfinite(per_ex).all() and scan_ops.rwkv6_scan.LAUNCHES == n0
    model.prefill({"tokens": tokens})
    assert scan_ops.rwkv6_scan.LAUNCHES - n0 == model.kernel_launches()["prefill"]["rwkv6_scan"]
