"""The port's attention kernels against the JAX package's Pallas kernels.

On the CPU each wrapper takes its kernel's plain PyTorch version, held here
to the reference's Pallas kernels run in interpret mode
(``repro.kernels.flash_attention.ops.attention``,
``repro.kernels.decode_attention.ops.decode``) on the same inputs, made from
a numpy seed, at the shapes of ``tests/test_kernels.py`` plus GQA and ragged
cases: float32 within 2e-5 and bfloat16 within 3e-2, the reference's own
tolerances. Measured max |d|: flash 7.2e-7 (float32) and 2.0e-3 (bfloat16,
single roundings of outputs near 0.5), decode 1.8e-7 and 0.0: the plain
versions keep the softmax and the product with V in float32, as the
kernels do.

The CUDA kernels are held against the plain versions on the card
(``-m cuda``): float32 within 2e-5, bfloat16 within one bfloat16 ulp
(+2e-5 for outputs near 0).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.decode_attention import ref as dref
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax(arrs, dtype):
    import jax.numpy as jnp

    return [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]


def _close(got: torch.Tensor, want, tol: float) -> float:
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    np.testing.assert_allclose(g, w, atol=tol, rtol=tol)
    return float(np.abs(g - w).max())


# --- flash attention ----------------------------------------------------------
@pytest.mark.parametrize("shape", [(1, 2, 128, 64), (2, 2, 256, 128), (1, 1, 384, 32)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas(shape, causal, dtype):
    from repro.kernels.flash_attention.ops import attention

    arrs = _arrays([shape] * 3, seed=sum(shape) + causal)
    want = attention(*_jax(arrs, dtype), causal=causal)
    got = fops.attention(*_torch(arrs, dtype), causal=causal)
    assert got.dtype == getattr(torch, dtype) and got.shape == shape
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV", [(4, 2), (6, 2)])
def test_flash_plain_gqa_matches_pallas(H, KV, dtype):
    """GQA: the reference's ops.py repeats kv heads; the port indexes them."""
    from repro.kernels.flash_attention.ops import attention

    arrs = _arrays([(1, H, 128, 64), (1, KV, 128, 64), (1, KV, 128, 64)], seed=H)
    want = attention(*_jax(arrs, dtype))
    _close(fops.attention(*_torch(arrs, dtype)), want, TOL[dtype])


@pytest.mark.parametrize("S", [1, 16, 100])
def test_flash_plain_ragged_matches_reference_oracle(S):
    """Any S: the Pallas kernel needs S % 128 == 0, its pure-jnp oracle
    (``mha_ref``, float32) does not; GQA repeated for it."""
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ref import mha_ref

    q, k, v = _arrays([(2, 4, S, 16), (2, 2, S, 16), (2, 2, S, 16)], seed=S)
    want = mha_ref(jnp.asarray(q), jnp.repeat(jnp.asarray(k), 2, 1), jnp.repeat(jnp.asarray(v), 2, 1))
    _close(fops.attention(*_torch([q, k, v], "float32")), want, 2e-5)


def test_flash_strided_views_equal_contiguous():
    """The model passes (B, S, H, D) projections as transposed views."""
    q, k, v = _torch(_arrays([(2, 40, 4, 32), (2, 40, 2, 32), (2, 40, 2, 32)], seed=3),
                     "float32")
    got = fops.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    want = fref.flash_attention_ref(
        q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(),
    )
    assert torch.equal(got, want)


# --- decode attention ---------------------------------------------------------
@pytest.mark.parametrize("shape", [(2, 4, 256, 64), (1, 8, 512, 128)])
@pytest.mark.parametrize("pos_frac", [0.0, 0.4, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_pallas(shape, pos_frac, dtype):
    import jax.numpy as jnp
    from repro.kernels.decode_attention.ops import decode

    B, H, S, D = shape
    pos = int((S - 1) * pos_frac)
    arrs = _arrays([(B, H, D), shape, shape], seed=S + int(10 * pos_frac))
    want = decode(*_jax(arrs, dtype), jnp.asarray(pos, jnp.int32))
    got = dops.decode(*_torch(arrs, dtype), torch.tensor(pos, dtype=torch.int32))
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, H, D)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV,pos", [(4, 2, 300), (6, 2, 511)])
def test_decode_plain_gqa_matches_pallas(H, KV, pos, dtype):
    import jax.numpy as jnp
    from repro.kernels.decode_attention.ops import decode

    arrs = _arrays([(2, H, 64), (2, KV, 512, 64), (2, KV, 512, 64)], seed=pos)
    want = decode(*_jax(arrs, dtype), jnp.asarray(pos, jnp.int32))
    got = dops.decode(*_torch(arrs, dtype), torch.tensor(pos, dtype=torch.int32))
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("T,pos", [(1, 0), (100, 57), (300, 299), (300, 1000)])
def test_decode_plain_ragged_matches_reference_oracle(T, pos):
    """Any T (the Pallas kernel needs T % 256 == 0, its oracle does not);
    pos >= T attends to the whole cache, as the Pallas kernel does."""
    import jax.numpy as jnp
    from repro.kernels.decode_attention.ref import decode_ref

    q, k, v = _arrays([(2, 4, 16), (2, 4, T, 16), (2, 4, T, 16)], seed=T)
    want = decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
    got = dops.decode(*_torch([q, k, v], "float32"), torch.tensor(pos, dtype=torch.int32))
    _close(got, want, 2e-5)


# --- wrapper contracts ----------------------------------------------------------
def _qkv(dtype=torch.float32, S=8):
    q = torch.zeros((1, 4, S, 16), dtype=dtype)
    kv = torch.zeros((1, 2, S, 16), dtype=dtype)
    return q, kv, kv.clone()


@pytest.mark.parametrize(
    "mutate,err",
    [
        (lambda q, k, v: (q.half(), k, v), TypeError),
        (lambda q, k, v: (q, k.double(), v), TypeError),
        (lambda q, k, v: (q[:, :, :0], k[:, :, :0], v[:, :, :0]), ValueError),  # empty
        (lambda q, k, v: (q.transpose(2, 3).contiguous().transpose(2, 3), k, v),
         ValueError),  # D not contiguous
        (lambda q, k, v: (q, k[:, :, :4], v[:, :, :4]), ValueError),  # S differs
        (lambda q, k, v: (q[:, :3], k, v), ValueError),  # 3 heads over 2 kv heads
        (lambda q, k, v: (q, k, v[:, :1]), ValueError),  # k, v shapes differ
        (lambda q, k, v: (q[0], k[0], v[0]), ValueError),  # 3-D
    ],
)
def test_flash_wrapper_rejects_bad_inputs(mutate, err):
    with pytest.raises(err):
        fops.attention(*mutate(*_qkv()))


def test_decode_wrapper_rejects_bad_inputs():
    q = torch.zeros((1, 4, 16))
    k = torch.zeros((1, 2, 8, 16))
    pos = torch.tensor(3, dtype=torch.int32)
    with pytest.raises(TypeError):
        dops.decode(q, k, k, 3)  # an int, not a device tensor
    with pytest.raises(TypeError):
        dops.decode(q, k, k, pos.long())
    with pytest.raises(TypeError):
        dops.decode(q.bfloat16(), k, k, pos)
    with pytest.raises(ValueError):
        dops.decode(q[:, :3], k, k, pos)
    with pytest.raises(ValueError):
        dops.decode(q, k[:, :, :0], k[:, :, :0], pos)


def test_cpu_tensors_launch_nothing():
    f0, d0 = fops.attention.LAUNCHES, dops.decode.LAUNCHES
    q, k, v = _qkv(torch.bfloat16, S=40)
    fops.attention(q, k, v)
    dops.decode(q[:, :, 0], k, v, torch.tensor(39, dtype=torch.int32))
    assert (fops.attention.LAUNCHES, dops.decode.LAUNCHES) == (f0, d0)
    assert fops._lib is None and dops._lib is None  # nothing was built either


# --- on the card: each kernel against its plain version -------------------------
def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at |x| (float32 tensor)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0**-126)))
    return torch.exp2(e - 7)


def _hold(got, want, dtype):
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 2e-5
    else:
        g, w = got.float(), want.float()  # near 0, bf16 keeps float32's noise: + 2e-5
        assert bool(((g - w).abs() <= _bf16_ulp(torch.maximum(g.abs(), w.abs())) + 2e-5).all())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on a GPU host)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,S,D,causal", [
    (1, 2, 2, 128, 128, True), (2, 4, 2, 100, 16, True), (1, 6, 2, 257, 128, True),
    (2, 2, 1, 77, 16, False),
])
def test_flash_kernel_matches_plain(cuda, dtype, B, H, KV, S, D, causal):
    g = torch.Generator(device=cuda).manual_seed(S)
    q = torch.randn((B, S, H, D), generator=g, device=cuda).to(dtype).transpose(1, 2)
    k = torch.randn((B, S, KV, D), generator=g, device=cuda).to(dtype).transpose(1, 2)
    v = torch.randn((B, S, KV, D), generator=g, device=cuda).to(dtype).transpose(1, 2)
    n = fops.attention.LAUNCHES
    got = fops.attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fops.attention.LAUNCHES == n + 1
    assert got.transpose(1, 2).is_contiguous()
    _hold(got, fref.flash_attention_ref(q, k, v, causal=causal), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,T,D,pos", [
    (2, 4, 2, 300, 16, 0), (2, 4, 2, 300, 16, 299), (1, 6, 2, 1000, 128, 513),
    (1, 8, 8, 256, 128, 255), (1, 8, 1, 700, 16, 5000),
])
def test_decode_kernel_matches_plain(cuda, dtype, B, H, KV, T, D, pos):
    g = torch.Generator(device=cuda).manual_seed(T + pos)
    q = torch.randn((B, H, D), generator=g, device=cuda).to(dtype)
    k = torch.randn((B, T, KV, D), generator=g, device=cuda).to(dtype).transpose(1, 2)
    v = torch.randn((B, T, KV, D), generator=g, device=cuda).to(dtype).transpose(1, 2)
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    n = dops.decode.LAUNCHES
    got = dops.decode(q, k, v, p)
    torch.cuda.synchronize()
    assert dops.decode.LAUNCHES == n + 1
    _hold(got, dref.decode_ref(q, k, v, p), dtype)
