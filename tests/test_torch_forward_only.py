"""The forward-only kernel wrappers refuse to drop gradients.

``flash_attention.ops.attention``, ``decode_attention.ops.decode`` and
``linear_scan.ops.rwkv6_scan`` write their results into fresh tensors on
the card (no ``grad_fn``), so an input that requires grad would get a zero
gradient without a word. Each raises ``RuntimeError`` when grad mode is on
and an input requires grad, on either device (here: the CPU, where the
wrapper would otherwise take its plain version), counts no launch, and
runs as before under ``torch.no_grad()`` or on inputs that need no grad.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.linear_scan import ops as sops


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tiny tensors only: run torch on one thread, and give the pool back
    afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _attention():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 8, 16, generator=g)
    k, v = torch.randn(1, 2, 8, 16, generator=g), torch.randn(1, 2, 8, 16, generator=g)
    return fops.attention, (q, k, v)


def _decode():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 16, generator=g)
    k, v = torch.randn(1, 2, 8, 16, generator=g), torch.randn(1, 2, 8, 16, generator=g)
    return (lambda q, k, v: dops.decode(q, k, v, torch.tensor(5, dtype=torch.int32))), (q, k, v)


def _scan():
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn(1, 8, 2, 4, generator=g) for _ in range(3))
    logw = -torch.rand(1, 8, 2, 4, generator=g)
    u = torch.randn(2, 4, generator=g)
    return (lambda r, k, v, logw, u: sops.rwkv6_scan(r, k, v, logw, u, chunk=4)), (r, k, v, logw, u)


WRAPPERS = {"attention": (_attention, fops.attention), "decode": (_decode, dops.decode),
            "rwkv6_scan": (_scan, sops.rwkv6_scan)}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_wrapper_refuses_inputs_that_require_grad(name):
    make, wrapper = WRAPPERS[name]
    fn, args = make()
    want = fn(*args)  # no input requires grad: runs
    before = wrapper.LAUNCHES
    for i in range(len(args)):
        grad_args = [a.clone().requires_grad_(j == i) for j, a in enumerate(args)]
        with pytest.raises(RuntimeError, match="forward-only"):
            fn(*grad_args)
        with torch.no_grad():  # serving: grad mode off, the same result
            got = fn(*grad_args)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(a, b)
    assert wrapper.LAUNCHES == before  # the CPU path launches nothing
