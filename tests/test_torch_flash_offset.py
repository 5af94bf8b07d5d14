"""The flash-attention kernel's causal query offset: a sequence-parallel
rank's query rows of a prefill (rows r S/M .. (r+1) S/M - 1 against all S
keys), ``ops.attention(q, k, v, causal=True, q_offset=r * S / M)``.

On the CPU (the wrapper's plain path, ``ref.flash_attention_ref``) the rows
at an offset equal the same rows of one full causal call (checked bit for
bit), the tiled plain version (the bf16 kernel's arithmetic) likewise, and
both agree with the reference's own masked attention (JAX:
``repro.models.layers._sdpa`` under ``causal_mask(S/M, S, offset=r S/M)``,
the layout its sequence-parallel attention computes) within 2e-6 in
float32. The checks: an offset takes causal attention without a window,
and its rows must lie within the keys; without an offset the old rule (a
mask needs Sq == Sk) stands. On the card (``-m cuda``) the kernel at
offsets r S/M for r in {0, M/2 - 1, M - 1} is held to the rows of one full
causal kernel call, bit for bit when S/M is a whole number of the kernel's
query tiles (128 rows in bf16, 64 in float32: the same key tiles in the
same order), and to the plain version within the bf16 flash bound of
ROADMAP queue 3 (float32: 2e-5). Launches at an offset count in
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
def test_rows_at_an_offset_equal_the_full_call(M, fn):
    q, k, v = _inputs(2, 4, 2, 24, 16, seed=M)
    full = fn(q, k, v, causal=True)
    Sl = 24 // M
    for r in range(M):
        got = fn(q[:, :, r * Sl:(r + 1) * Sl], k, v, causal=True, q_offset=r * Sl)
        assert torch.equal(got, full[:, :, r * Sl:(r + 1) * Sl]), (M, r)


def test_wrapper_offset_on_the_cpu():
    q, k, v = _inputs(1, 4, 2, 16, 16, seed=1, dtype=torch.bfloat16)
    full = fops.attention(q, k, v)
    got = fops.attention(q[:, :, 8:].contiguous(), k, v, q_offset=8)
    assert torch.equal(got, full[:, :, 8:])


@pytest.mark.parametrize("M", [2, 4])
def test_offset_rows_match_the_reference_masked_attention(M):
    jax = pytest.importorskip("jax")
    from repro.models import layers as jl

    B, H, KV, S, D = 2, 4, 2, 16, 16
    q, k, v = _inputs(B, H, KV, S, D, seed=10 + M)
    Sl = S // M
    for r in range(M):
        qr = q[:, :, r * Sl:(r + 1) * Sl]
        got = fref.flash_attention_ref(qr, k, v, causal=True, q_offset=r * Sl)
        jq = jax.numpy.asarray(qr.transpose(1, 2).numpy())   # (B, Sl, H, D)
        jk = jax.numpy.asarray(k.transpose(1, 2).numpy())
        jv = jax.numpy.asarray(v.transpose(1, 2).numpy())
        want = np.array(jl._sdpa(jq, jk, jv, jl.causal_mask(Sl, S, offset=r * Sl), H // KV))
        gap = float(np.abs(got.transpose(1, 2).numpy() - want).max())
        assert gap <= F32_TOL, (M, r, gap)


def test_offset_checks():
    q, k, v = _inputs(1, 4, 2, 16, 16, seed=2)
    n = fops.attention.LAUNCHES, fops.attention.OFFSET_LAUNCHES
    for kw in ({"q_offset": 9}, {"q_offset": -1}, {"q_offset": 0, "causal": False},
               {"q_offset": 4, "window": 4}):
        with pytest.raises(ValueError):
            fops.attention(q[:, :, :8], k, v, **kw)
    with pytest.raises(ValueError, match="as many queries as keys"):
        fops.attention(q[:, :, :8], k, v)  # no offset: a mask pairs row i with key i
    assert (fops.attention.LAUNCHES, fops.attention.OFFSET_LAUNCHES) == n


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on a GPU host)")
    return torch.device("cuda")


def _bf16_gap(got, want, q, k, v, q_offset):
    """max |got - want| over the bf16 flash bound (<= 1 passes)."""
    g, w = got.float(), want.float()
    attn_abs = fref.flash_attention_ref(q.float(), k.float(), v.float().abs(), causal=True,
                                        q_offset=q_offset)
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
