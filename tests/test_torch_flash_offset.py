"""The flash-attention kernel's causal query offset: a sequence-parallel
rank's query rows of a prefill (rows r S/M .. (r+1) S/M - 1 against all S
keys), ``ops.attention(q, k, v, causal=True, q_offset=r * S / M)``, with a
sliding ``window`` too (gemma3's local layers on a model axis its heads do
not divide).

On the CPU (the wrapper's plain path, ``ref.flash_attention_ref``) the rows
at an offset equal the same rows of one full causal call (checked bit for
bit), the tiled plain version (the bf16 kernel's arithmetic) likewise, and
both agree with the reference's own masked attention (JAX:
``repro.models.layers._sdpa`` under ``causal_mask(S/M, S, offset=r S/M)``,
the layout its sequence-parallel attention computes) within 2e-6 in
float32, windowed too (``causal_mask(S/M, S, window, offset)``) for every
rank of M in {2, 3, 4}. The checks: an offset takes causal attention, and
its rows must lie within the keys; without an offset the old rule (a mask
needs Sq == Sk) stands. On the card (``-m cuda``) the kernel at
offsets r S/M for r in {0, M/2 - 1, M - 1} is held to the rows of one full
causal kernel call, bit for bit when S/M is a whole number of the kernel's
query tiles (128 rows in bf16, 64 in float32: the same key tiles in the
same order), and to the plain version within the bf16 flash bound of
ROADMAP queue 3 (float32: 2e-5); a window at an offset likewise, at
offsets that are not whole tiles as well. Launches at an offset count in
``attention.OFFSET_LAUNCHES`` alone.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fref  # noqa: E402

F32_TOL = 2e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, H, KV, S, D, seed, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, H, S, D), (B, KV, S, D), (B, KV, S, D))]
    return [torch.from_numpy(a).to(dtype).to(device) for a in arrs]


@pytest.mark.parametrize("M", [2, 3, 4])
@pytest.mark.parametrize("fn", [fref.flash_attention_ref, fref.flash_attention_tiled_ref],
                         ids=["plain", "tiled"])
@pytest.mark.parametrize("window", [None, 3, 7, 20], ids=["causal", "w3", "w7", "w20"])
def test_rows_at_an_offset_equal_the_full_call(M, fn, window):
    """Rows r S/M.. of one call (causal, or over windows smaller and larger
    than a rank's 6-12 rows) at their offset: bit for bit those rows of
    the whole call."""
    q, k, v = _inputs(2, 4, 2, 24, 16, seed=M)
    full = fn(q, k, v, causal=True, window=window)
    Sl = 24 // M
    for r in range(M):
        got = fn(q[:, :, r * Sl:(r + 1) * Sl], k, v, causal=True, window=window,
                 q_offset=r * Sl)
        assert torch.equal(got, full[:, :, r * Sl:(r + 1) * Sl]), (M, r)


def test_wrapper_offset_on_the_cpu():
    q, k, v = _inputs(1, 4, 2, 16, 16, seed=1, dtype=torch.bfloat16)
    full = fops.attention(q, k, v)
    got = fops.attention(q[:, :, 8:].contiguous(), k, v, q_offset=8)
    assert torch.equal(got, full[:, :, 8:])


def _reference_rows(M, window, seed, S=24):
    """Each rank's rows through the plain version at their offset against
    the reference's ``_sdpa`` under ``causal_mask(S/M, S, window,
    offset=r S/M)`` (JAX, float32): the largest gap."""
    jax = pytest.importorskip("jax")
    from repro.models import layers as jl

    B, H, KV, D = 2, 4, 2, 16
    q, k, v = _inputs(B, H, KV, S, D, seed=seed)
    Sl = S // M
    worst = 0.0
    for r in range(M):
        qr = q[:, :, r * Sl:(r + 1) * Sl]
        got = fref.flash_attention_ref(qr, k, v, causal=True, window=window, q_offset=r * Sl)
        jq = jax.numpy.asarray(qr.transpose(1, 2).numpy())   # (B, Sl, H, D)
        jk = jax.numpy.asarray(k.transpose(1, 2).numpy())
        jv = jax.numpy.asarray(v.transpose(1, 2).numpy())
        want = np.array(jl._sdpa(jq, jk, jv, jl.causal_mask(Sl, S, window, offset=r * Sl),
                                 H // KV))
        worst = max(worst, float(np.abs(got.transpose(1, 2).numpy() - want).max()))
    return worst


@pytest.mark.parametrize("M", [2, 4])
def test_offset_rows_match_the_reference_masked_attention(M):
    gap = _reference_rows(M, None, seed=10 + M, S=16)
    assert gap <= F32_TOL, (M, gap)


@pytest.mark.parametrize("M", [2, 3, 4])
@pytest.mark.parametrize("window", [3, 7, 20], ids=["w3", "w7", "w20"])
def test_windowed_offset_rows_match_the_reference_masked_attention(M, window):
    """A window at a query offset (gemma3's local layers on a model axis
    its heads do not divide): every rank's rows, windows smaller and larger
    than its 6-12 rows, within F32_TOL of the reference's masked ``_sdpa``."""
    gap = _reference_rows(M, window, seed=20 + M + window)
    print(f"M={M} window={window}: vs the reference {gap:.3g}")
    assert gap <= F32_TOL, (M, window, gap)


def test_offset_checks():
    """An offset takes causal attention, with or without a window, and rows
    within the keys (a window at an offset gives the whole windowed call's
    rows); without an offset a mask needs Sq == Sk. The CPU path counts no
    launch."""
    q, k, v = _inputs(1, 4, 2, 16, 16, seed=2)
    n = fops.attention.LAUNCHES, fops.attention.OFFSET_LAUNCHES
    for kw in ({"q_offset": 9}, {"q_offset": -1}, {"q_offset": 0, "causal": False},
               {"q_offset": 4, "window": 4, "causal": False}):
        with pytest.raises(ValueError):
            fops.attention(q[:, :, :8], k, v, **kw)
    with pytest.raises(ValueError, match="as many queries as keys"):
        fops.attention(q[:, :, :8], k, v)  # no offset: a mask pairs row i with key i
    got = fops.attention(q[:, :, 4:12], k, v, q_offset=4, window=4)
    assert torch.equal(got, fops.attention(q, k, v, window=4)[:, :, 4:12])
    assert (fops.attention.LAUNCHES, fops.attention.OFFSET_LAUNCHES) == n


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on a GPU host)")
    return torch.device("cuda")


def _bf16_gap(got, want, q, k, v, q_offset, window=None):
    """max |got - want| over the bf16 flash bound (<= 1 passes)."""
    g, w = got.float(), want.float()
    attn_abs = fref.flash_attention_ref(q.float(), k.float(), v.float().abs(), causal=True,
                                        window=window, q_offset=q_offset)
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(g.abs(), w.abs())
                                            .clamp_min(2.0 ** -126))) - 7)
    return float(((g - w).abs() / (2.0 ** -7 * attn_abs + ulp + 2e-5)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("M", [2, 4, 16])
def test_kernel_offset_rows_equal_the_full_call(cuda, dtype, D, M):
    B, H, KV, S = 1, 4, 2, 2048
    q, k, v = _inputs(B, H, KV, S, D, seed=M + D, dtype=dtype, device=cuda)
    full = fops.attention(q, k, v)
    Sl = S // M
    for r in sorted({0, M // 2 - 1, M - 1}):
        qr = q[:, :, r * Sl:(r + 1) * Sl].contiguous()
        got = fops.attention(qr, k, v, q_offset=r * Sl)
        torch.cuda.synchronize()
        assert torch.equal(got, full[:, :, r * Sl:(r + 1) * Sl]), (M, r)
        want = fref.flash_attention_ref(qr.cpu(), k.cpu(), v.cpu(), causal=True,
                                        q_offset=r * Sl)
        if dtype == torch.float32:
            assert float((got.cpu() - want).abs().max()) <= 2e-5
        else:
            assert _bf16_gap(got.cpu(), want, qr.cpu(), k.cpu(), v.cpu(), r * Sl) <= 1.0


@pytest.mark.cuda
def test_kernel_offset_ragged_rows(cuda):
    """Rows that are not whole query tiles (S/M = 100): against the plain
    version within the bound."""
    q, k, v = _inputs(1, 4, 2, 400, 64, seed=5, dtype=torch.bfloat16, device=cuda)
    for r in range(4):
        qr = q[:, :, r * 100:(r + 1) * 100].contiguous()
        before = fops.attention.LAUNCHES, fops.attention.OFFSET_LAUNCHES
        got = fops.attention(qr, k, v, q_offset=r * 100)
        assert (fops.attention.LAUNCHES, fops.attention.OFFSET_LAUNCHES) == (
            before[0], before[1] + 1)
        want = fref.flash_attention_ref(qr.cpu(), k.cpu(), v.cpu(), causal=True,
                                        q_offset=r * 100)
        assert _bf16_gap(got.cpu(), want, qr.cpu(), k.cpu(), v.cpu(), r * 100) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("D,window", [(64, 130), (128, 7), (256, 512), (256, 65)])
def test_kernel_windowed_offset_rows(cuda, dtype, D, window):
    """A window at a query offset on the card: at offsets that are not
    multiples of the 64- or 128-row tiles (S/M = 100 and 300 rows; ranks
    whose first key tile lies below the window's edge), against the plain
    version within the bf16 flash bound (float32: 2e-5) and, at offsets of
    whole query tiles, bit for bit the whole windowed call's rows. Each
    call counts one launch in ``OFFSET_LAUNCHES``."""
    S = 1200
    q, k, v = _inputs(1, 4, 2 if D < 256 else 1, S, D, seed=D + window, dtype=dtype,
                      device=cuda)
    full = fops.attention(q, k, v, window=window)
    for Sl, ranks in ((100, (0, 5, 11)), (300, (0, 1, 3)), (256 if dtype == torch.bfloat16
                                                              else 128, (0, 2, 3))):
        for r in ranks:
            qr = q[:, :, r * Sl:(r + 1) * Sl].contiguous()
            before = fops.attention.OFFSET_LAUNCHES
            got = fops.attention(qr, k, v, window=window, q_offset=r * Sl)
            assert fops.attention.OFFSET_LAUNCHES == before + 1
            torch.cuda.synchronize()
            if Sl in (128, 256):
                assert torch.equal(got, full[:, :, r * Sl:(r + 1) * Sl]), (Sl, r)
            want = fref.flash_attention_ref(qr.cpu(), k.cpu(), v.cpu(), causal=True,
                                            window=window, q_offset=r * Sl)
            if dtype == torch.float32:
                assert float((got.cpu() - want).abs().max()) <= 2e-5, (Sl, r)
            else:
                assert _bf16_gap(got.cpu(), want, qr.cpu(), k.cpu(), v.cpu(), r * Sl,
                                 window) <= 1.0, (Sl, r)
