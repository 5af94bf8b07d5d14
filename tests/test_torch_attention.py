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
kernels do. Without a mask the query and key lengths may differ (whisper's
cross-attention): the plain versions are held there to the reference
model's own attention (``repro.models.layers._sdpa`` with no mask, as its
whisper cross-attends), float32 within 2e-5 and bfloat16 within 3e-2, and a
mask with unequal lengths raises ``ValueError``.

The CUDA kernels are held against the plain versions on the card
(``-m cuda``): float32 within 2e-5; decode in bfloat16 within one bfloat16
ulp (+2e-5 for outputs near 0). The bfloat16 flash kernel rounds P to bf16
before the product with V (tensor cores), so it is held to the bound that
rounding implies: each p is off by a relative 2**-8 at most, each output by
at most 2**-8 * attn(q, k, |v|); the check allows twice that, plus one bf16
ulp of the larger magnitude (the two final roundings) and 2e-5:
``|got - want| <= 2**-7 * attn(q, k, |v|) + ulp + 2e-5``. The plain tiled
version (``ref.flash_attention_tiled_ref``, the kernel's arithmetic) is held
to the same bound on the CPU, against the Pallas kernel and the plain
version, and a faulty tiled version is shown to break it. On the card the
kernel is held to the tiled version within the same bound: both round P,
but from float32 p that differ in their last bits, so where a bf16 rounding
midpoint lies between them they round one bf16 ulp of p apart; each is
within 2**-8 * attn(q, k, |v|) of the float32 product, the two within 2**-7.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.decode_attention import ref as dref
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref

TOL = {"float32": 2e-5, "bfloat16": 3e-2}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The runs here are many small products, which torch's thread pool
    slows down when several test processes share the cores: run them on
    one thread (no numeric effect: both sides of every comparison run in
    this process), and give the pool back afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# --- the tiled plain version: the bf16 kernel's arithmetic ---------------------
def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at |x| (float32 tensor)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0**-126)))
    return torch.exp2(e - 7)


def _flash_bf16_gap(got, want, q, k, v, causal, window=None):
    """max |got - want| over the bf16 flash bound, elementwise (<= 1 passes):
    2**-7 * attn(q, k, |v|) + one bf16 ulp of max(|got|, |want|) + 2e-5."""
    g, w = got.float(), want.float()
    attn_abs = fref.flash_attention_ref(q.float(), k.float(), v.float().abs(), causal=causal,
                                        window=window)
    bound = 2.0**-7 * attn_abs + _bf16_ulp(torch.maximum(g.abs(), w.abs())) + 2e-5
    return ((g - w).abs() / bound).max().item()


# (B, H, KV, S, D, causal): S % 128 == 0 runs the Pallas kernel, the ragged S
# its float32 oracle (mha_ref, GQA repeated for it)
TILED_CASES = [
    (1, 2, 2, 128, 128, True), (1, 4, 2, 256, 16, False), (2, 4, 1, 256, 128, True),
    (2, 4, 2, 100, 16, True), (1, 4, 1, 257, 128, False), (1, 6, 2, 257, 16, True),
]


def _tiled_inputs(case, dtype, seed):
    B, H, KV, S, D, _ = case
    arrs = _arrays([(B, H, S, D), (B, KV, S, D), (B, KV, S, D)], seed=seed)
    # the same values on both sides: rounded to the dtype once
    return [t.float().numpy() for t in _torch(arrs, dtype)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", TILED_CASES)
def test_flash_tiled_plain_within_bound_of_jax(case, dtype):
    import jax.numpy as jnp
    from repro.kernels.flash_attention.ops import attention
    from repro.kernels.flash_attention.ref import mha_ref

    B, H, KV, S, D, causal = case
    arrs = _tiled_inputs(case, dtype, seed=S + D)
    if S % 128 == 0:
        want = attention(*_jax(arrs, dtype), causal=causal)
    else:
        q, k, v = (jnp.asarray(a) for a in arrs)
        want = mha_ref(q, jnp.repeat(k, H // KV, 1), jnp.repeat(v, H // KV, 1), causal=causal)
    q, k, v = _torch(arrs, dtype)
    got = fref.flash_attention_tiled_ref(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    want = torch.from_numpy(np.array(want, np.float32))
    assert _flash_bf16_gap(got, want, q, k, v, causal) <= 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", TILED_CASES)
def test_flash_tiled_plain_within_bound_of_plain(case, dtype):
    """The same bound against the port's own plain version, in the large-logit
    regime too (q x 8: the running max moves across tiles, alpha far from 1)."""
    B, H, KV, S, D, causal = case
    q, k, v = _torch(_tiled_inputs(case, dtype, seed=S + D + 1), dtype)
    for qs in (1.0, 8.0):
        qq = (q.float() * qs).to(q.dtype)
        got = fref.flash_attention_tiled_ref(qq, k, v, causal=causal)
        want = fref.flash_attention_ref(qq, k, v, causal=causal)
        assert _flash_bf16_gap(got, want, qq, k, v, causal) <= 1.0


def _faulty_tiled(q, k, v, causal, fault):
    """flash_attention_tiled_ref with one deliberate fault: ``drop_last_tile``
    skips the last key tile; ``skip_alpha`` leaves the accumulator unrescaled
    at the first tile boundary."""
    rep = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).float()
    v = v.repeat_interleave(rep, dim=1).float()
    qf = q.float() / np.sqrt(q.shape[-1])
    B, H, S, D = q.shape
    m = torch.full((B, H, S, 1), fref.NEG_INF)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, D))
    rows = torch.arange(S)[:, None]
    starts = list(range(0, S, fref.TILE))
    if fault == "drop_last_tile":
        starts = starts[:-1]
    for i, k0 in enumerate(starts):
        s = torch.einsum("bhsd,bhtd->bhst", qf, k[:, :, k0 : k0 + fref.TILE])
        if causal:
            cols = torch.arange(k0, min(k0 + fref.TILE, S))[None, :]
            s = s.masked_fill(cols > rows, fref.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        keep = torch.ones_like(alpha) if (fault == "skip_alpha" and i == 1) else alpha
        acc = acc * keep + torch.einsum("bhst,bhtd->bhsd", p.bfloat16().float(),
                                        v[:, :, k0 : k0 + fref.TILE])
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


@pytest.mark.parametrize("fault,causal", [
    ("drop_last_tile", False), ("skip_alpha", False), ("skip_alpha", True),
])
def test_flash_bound_catches_a_faulty_tiled_version(fault, causal):
    """At S = 257 (two full tiles and one of a single key) the bound passes
    the tiled version and fails each fault. The last key's value is scaled
    by 64, so that dropping it moves every row (non-causal: in the causal
    case only row 256 sees it); the running max moves at the first tile
    boundary in about half the rows."""
    q, k, v = _torch(_arrays([(1, 4, 257, 16), (1, 2, 257, 16), (1, 2, 257, 16)], seed=7),
                     "float32")
    v[:, :, -1] *= 64
    want = fref.flash_attention_ref(q, k, v, causal=causal)
    assert _flash_bf16_gap(fref.flash_attention_tiled_ref(q, k, v, causal), want, q, k, v,
                           causal) <= 1.0
    assert _flash_bf16_gap(_faulty_tiled(q, k, v, causal, fault), want, q, k, v, causal) > 1.0


@pytest.mark.parametrize("layout,ok", [
    ("transposed", True), ("base+2B", False), ("stride 17", False), ("contiguous", True),
])
def test_flash_tma_layout_check(layout, ok):
    """The bf16 kernel's TMA needs 16-byte aligned bases and strides; the
    wrapper checks before any launch (CPU tensors stand in here)."""
    base = torch.zeros(2 * 40 * 4 * 32 + 8, dtype=torch.bfloat16)
    n = 2 * 40 * 4 * 32
    t = {
        "transposed": lambda: base[:n].view(2, 40, 4, 32).transpose(1, 2),
        "base+2B": lambda: base[1 : n + 1].view(2, 4, 40, 32),
        "stride 17": lambda: base[: 2 * 4 * 40 * 17].view(2, 4, 40, 17)[..., :16],
        "contiguous": lambda: base[:n].view(2, 4, 40, 32),
    }[layout]()
    if ok:
        fops.check_tma_layout(t)
    else:
        with pytest.raises(ValueError, match="16-byte"):
            fops.check_tma_layout(t)


# --- query and key lengths apart (cross-attention) -------------------------------
# (B, H, KV, Sq, Sk, D): whisper's cross shape cut down (4 decoder rows against
# many frames), one query row, more rows than keys, GQA
CROSS_CASES = [(2, 4, 4, 4, 150, 16), (1, 4, 2, 1, 300, 16), (2, 4, 2, 30, 7, 16),
               (1, 6, 2, 130, 257, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CROSS_CASES)
def test_flash_plain_cross_lengths_match_reference_sdpa(case, dtype):
    """Measured max |d|: 8.3e-7 (float32) and 7.8e-3 (bfloat16: the
    reference rounds its scores and probabilities to bf16)."""
    import jax.numpy as jnp
    from repro.models.layers import _sdpa

    B, H, KV, Sq, Sk, D = case
    arrs = _arrays([(B, H, Sq, D), (B, KV, Sk, D), (B, KV, Sk, D)], seed=Sq * Sk)
    q, k, v = (jnp.swapaxes(a, 1, 2) for a in _jax(arrs, dtype))  # (B, S, heads, D)
    want = jnp.swapaxes(_sdpa(q, k, v, None, H // KV), 1, 2)
    got = fops.attention(*_torch(arrs, dtype), causal=False)
    assert got.shape == (B, H, Sq, D) and got.dtype == getattr(torch, dtype)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("case", CROSS_CASES)
def test_flash_tiled_plain_cross_lengths_within_bound(case):
    """The tiled plain version (the bf16 kernel's arithmetic) against the
    plain one with Sq != Sk, at q x 1 and q x 8, within the P-rounding
    bound."""
    B, H, KV, Sq, Sk, D = case
    q, k, v = _torch(_arrays([(B, H, Sq, D), (B, KV, Sk, D), (B, KV, Sk, D)], seed=Sq + Sk),
                     "bfloat16")
    for qs in (1.0, 8.0):
        qq = (q.float() * qs).to(q.dtype)
        got = fref.flash_attention_tiled_ref(qq, k, v, causal=False)
        want = fref.flash_attention_ref(qq, k, v, causal=False)
        assert got.shape == qq.shape
        assert _flash_bf16_gap(got, want, qq, k, v, False) <= 1.0


@pytest.mark.parametrize("causal,window", [(True, None), (True, 3)])
def test_flash_mask_needs_equal_lengths(causal, window):
    """A causal or windowed mask pairs row i with key i: with Sq != Sk the
    wrapper and both plain versions raise ValueError, and nothing runs."""
    q, k, v = _qkv(S=8)
    k, v = k[:, :, :5], v[:, :, :5]
    n = fops.attention.LAUNCHES
    for fn in (fops.attention, fref.flash_attention_ref, fref.flash_attention_tiled_ref):
        with pytest.raises(ValueError, match="as many queries as keys"):
            fn(q, k, v, causal=causal, window=window)
    assert fops.attention.LAUNCHES == n


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
        (lambda q, k, v: (q, k[:, :, :4], v[:, :, :4]), ValueError),  # S differs, causal
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


def test_head_dim_64_on_the_cpu_takes_the_plain_versions():
    """granite-moe's attention shapes (24 heads over 8 kv heads, D = 64): the
    wrappers return their plain versions' results and launch nothing."""
    g = torch.Generator().manual_seed(64)
    q = torch.randn((2, 40, 24, 64), generator=g).transpose(1, 2)
    k, v = (torch.randn((2, 40, 8, 64), generator=g).transpose(1, 2) for _ in range(2))
    pos = torch.tensor(39, dtype=torch.int32)
    f0, d0 = fops.attention.LAUNCHES, dops.decode.LAUNCHES
    assert torch.equal(fops.attention(q, k, v), fref.flash_attention_ref(q, k, v))
    assert torch.equal(dops.decode(q[:, :, -1], k, v, pos), dref.decode_ref(q[:, :, -1], k, v, pos))
    assert (fops.attention.LAUNCHES, dops.decode.LAUNCHES) == (f0, d0)
    assert 64 in fops.HEAD_DIMS


# --- on the card: each kernel against its plain version -------------------------
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
@pytest.mark.parametrize("B,H,KV,S,D,causal,qscale", [
    (1, 2, 2, 128, 128, True, 1), (2, 4, 2, 100, 16, True, 1), (1, 6, 2, 257, 128, True, 1),
    (2, 2, 1, 77, 16, False, 1), (1, 4, 4, 1, 128, True, 1), (2, 4, 4, 1, 16, False, 1),
    (1, 8, 2, 127, 128, True, 1), (2, 4, 1, 128, 16, False, 1), (1, 4, 2, 129, 128, False, 1),
    (1, 8, 2, 4097, 128, True, 1), (1, 4, 1, 4097, 16, True, 1), (1, 8, 4, 1000, 128, True, 8),
    (2, 4, 4, 257, 16, False, 8), (1, 4, 1, 4097, 128, True, 8),
    (1, 24, 8, 300, 64, True, 1), (2, 6, 2, 129, 64, False, 1), (2, 3, 1, 1, 64, True, 1),
    (1, 24, 8, 4097, 64, True, 8),
])
def test_flash_kernel_matches_plain(cuda, dtype, B, H, KV, S, D, causal, qscale):
    """S = 1, one key short of, at and past a tile, and past 32 tiles; GQA
    groups 1, 2 and 4; q x 8 drives the online rescale across tiles. float32
    within 2e-5; bf16 within the P-rounding bound of both plain versions."""
    g = torch.Generator(device=cuda).manual_seed(S + H)
    q = torch.randn((B, S, H, D), generator=g, device=cuda).mul(qscale).to(dtype).transpose(1, 2)
    k = torch.randn((B, S, KV, D), generator=g, device=cuda).to(dtype).transpose(1, 2)
    v = torch.randn((B, S, KV, D), generator=g, device=cuda).to(dtype).transpose(1, 2)
    n = fops.attention.LAUNCHES
    got = fops.attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fops.attention.LAUNCHES == n + 1
    assert got.transpose(1, 2).is_contiguous()
    assert bool(torch.isfinite(got.float()).all())
    want = fref.flash_attention_ref(q, k, v, causal=causal)
    if dtype == torch.float32:
        _hold(got, want, dtype)
    else:
        assert _flash_bf16_gap(got, want, q, k, v, causal) <= 1.0
        tiled = fref.flash_attention_tiled_ref(q, k, v, causal=causal)
        assert _flash_bf16_gap(got, tiled, q, k, v, causal) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,S,D,causal,window,qscale", [
    (1, 4, 1, 300, 256, True, None, 1), (2, 4, 1, 129, 256, False, None, 1),
    (2, 4, 1, 1, 256, True, None, 1), (1, 8, 2, 64, 256, True, None, 1),
    (1, 4, 1, 4097, 256, True, None, 8), (1, 4, 1, 4097, 256, True, 512, 8),
    (1, 4, 1, 700, 256, True, 1, 1), (1, 4, 1, 700, 256, True, 7, 1),
    (1, 4, 1, 700, 256, True, 65, 1), (1, 4, 1, 700, 256, True, 130, 1),
    (1, 4, 2, 700, 128, True, 8, 1), (1, 4, 2, 700, 128, True, 100, 8),
    (1, 6, 2, 500, 64, True, 7, 1), (1, 6, 2, 500, 64, True, 512, 1),
    (2, 4, 2, 300, 16, True, 8, 1), (2, 4, 2, 300, 16, True, 300, 1),
])
def test_flash_kernel_head_dim_256_and_windows(cuda, dtype, B, H, KV, S, D, causal, window,
                                               qscale):
    """head_dim 256 (64-key K and V tiles in the bf16 kernel) and sliding
    windows in both paths: windows of 1, of no multiple of a tile, across
    tile edges, of S; rows whose first tiles are wholly masked; q x 8
    drives the rescale. The same bounds as the full causal cases."""
    g = torch.Generator(device=cuda).manual_seed(S + D + (window or 0))
    q = torch.randn((B, S, H, D), generator=g, device=cuda).mul(qscale).to(dtype).transpose(1, 2)
    k = torch.randn((B, S, KV, D), generator=g, device=cuda).to(dtype).transpose(1, 2)
    v = torch.randn((B, S, KV, D), generator=g, device=cuda).to(dtype).transpose(1, 2)
    n = fops.attention.LAUNCHES
    got = fops.attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fops.attention.LAUNCHES == n + 1
    assert bool(torch.isfinite(got.float()).all())
    want = fref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if dtype == torch.float32:
        _hold(got, want, dtype)
    else:
        assert _flash_bf16_gap(got, want, q, k, v, causal, window) <= 1.0
        tiled = fref.flash_attention_tiled_ref(q, k, v, causal=causal, window=window)
        assert _flash_bf16_gap(got, tiled, q, k, v, causal, window) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,Sq,Sk,D,qscale", [
    (2, 8, 8, 4, 1500, 64, 1), (1, 4, 4, 1, 1500, 16, 1), (1, 8, 2, 300, 77, 64, 1),
    (1, 8, 2, 300, 77, 64, 8), (2, 4, 4, 129, 128, 128, 1), (1, 4, 1, 5, 700, 256, 8),
])
def test_flash_kernel_cross_lengths(cuda, dtype, B, H, KV, Sq, Sk, D, qscale):
    """Sq != Sk without a mask (whisper's cross-attention): the grid and
    stores follow Sq, the key tiles and the ragged-end mask Sk. The same
    bounds as the other flash cases; a mask with Sq != Sk raises before a
    launch."""
    g = torch.Generator(device=cuda).manual_seed(Sq + Sk + D)
    q = torch.randn((B, Sq, H, D), generator=g, device=cuda).mul(qscale).to(dtype).transpose(1, 2)
    k = torch.randn((B, Sk, KV, D), generator=g, device=cuda).to(dtype).transpose(1, 2)
    v = torch.randn((B, Sk, KV, D), generator=g, device=cuda).to(dtype).transpose(1, 2)
    n = fops.attention.LAUNCHES
    got = fops.attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fops.attention.LAUNCHES == n + 1 and got.shape == (B, H, Sq, D)
    assert bool(torch.isfinite(got.float()).all())
    want = fref.flash_attention_ref(q, k, v, causal=False)
    if dtype == torch.float32:
        _hold(got, want, dtype)
    else:
        assert _flash_bf16_gap(got, want, q, k, v, False) <= 1.0
        tiled = fref.flash_attention_tiled_ref(q, k, v, causal=False)
        assert _flash_bf16_gap(got, tiled, q, k, v, False) <= 1.0
    with pytest.raises(ValueError, match="as many queries as keys"):
        fops.attention(q, k, v, causal=True)
    assert fops.attention.LAUNCHES == n + 1


@pytest.mark.cuda
@pytest.mark.parametrize("what", ["base", "stride"])
def test_flash_kernel_rejects_misaligned_bf16(cuda, what):
    """TMA takes 16-byte aligned bases and strides: anything else raises
    ValueError before a launch, with no other kernel to switch to."""
    n = fops.attention.LAUNCHES
    if what == "base":
        flat = torch.zeros(2 * 4 * 40 * 16 + 1, dtype=torch.bfloat16, device=cuda)
        q = flat[1:].view(2, 4, 40, 16)
    else:
        q = torch.zeros((2, 4, 40, 17), dtype=torch.bfloat16, device=cuda)[..., :16]
    kv = torch.zeros((2, 2, 40, 16), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        fops.attention(q, kv, kv)
    assert fops.attention.LAUNCHES == n
    fops.attention(q.float(), kv.float(), kv.float())  # float32 takes any strides
    assert fops.attention.LAUNCHES == n + 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,T,D,pos", [
    (2, 4, 2, 300, 16, 0), (2, 4, 2, 300, 16, 299), (1, 6, 2, 1000, 128, 513),
    (1, 8, 8, 256, 128, 255), (1, 8, 1, 700, 16, 5000), (2, 24, 8, 700, 64, 699),
    (1, 6, 2, 300, 64, 100),
    # whisper's cross-attention (group 1, a ragged 1,500 keys, all of them or
    # pos past T) and qwen2-vl's decode (group 8)
    (2, 8, 8, 1500, 64, 1499), (2, 8, 8, 1500, 64, 4000), (1, 64, 8, 700, 128, 699),
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
