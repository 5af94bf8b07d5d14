"""The flash-decode kernel's partial form: one rank's slice of a KV cache
split over the sequence (a context-parallel decode on a "model" mesh axis).

``ops.decode(q, k, v, pos, slot0=, return_lse=True)`` reads local slot j as
global key ``slot0 + j``, attends the keys whose global index is at most
``pos`` and returns the slice's normalised output and the log-sum-exp of
its scaled scores, both float32; a slice with no valid key gives 0 and
-inf. ``ops.merge_partials`` (the context-parallel decode's) merges the
ranks' partials by their log-sum-exp; ``ref.merge_partials`` is its plain
version, in rank order. On the CPU (the wrapper's plain path,
``ref.decode_partial_ref``), for caches split 2, 3, 4 and 16 ways at
positions that leave slices empty, partly and wholly valid, the merge is
held to the plain merge, to ``ref.decode_ref`` and to the reference's
float32 oracle (JAX,
``repro.kernels.decode_attention.ref.decode_ref``) on the same inputs from
a numpy seed: within 2e-6 of the output's scale in float32, and within one
bf16 ulp of one whole call once rounded to bf16. On the card (``-m cuda``)
the kernel's partials are held to the plain partials (2e-5 of the scale;
an empty slice bit for bit), their merge to one whole kernel call and to
``decode_ref``, and the partial form at slot 0 rounds to the plain call's
bits. Launches of the partial form count in ``decode.PARTIAL_LAUNCHES``
alone, a graph's replays too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as dref  # noqa: E402

MERGE_TOL = 2e-6  # merged float32 partials against one whole call, of the output's scale
F32_TOL = 2e-5    # the kernel's partials against the plain ones (exp2 on the SFU)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, H, KV, T, D, seed, dtype=torch.float32, device="cpu"):
    """q (B, H, D) and k, v as (B, KV, T, D) views of (B, T, KV, D) caches,
    from a numpy seed."""
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((B, T, KV, D)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((B, T, KV, D)).astype(np.float32))
    q, k, v = (t.to(dtype).to(device) for t in (q, k, v))
    return q, k.transpose(1, 2), v.transpose(1, 2)


def _partials(q, k, v, pos, M, fn):
    """Each of M slices' (out, lse) by ``fn(q, k_r, v_r, pos, slot0)``."""
    T = k.shape[2] // M
    return [fn(q, k[:, :, r * T:(r + 1) * T], v[:, :, r * T:(r + 1) * T], pos, r * T)
            for r in range(M)]


def _plain(q, k, v, pos, slot0):
    return dops.decode(q, k, v, pos, slot0=slot0, return_lse=True)


def _merge(parts, dtype=torch.float32):
    """The slices' partials merged as the context-parallel decode merges them."""
    return dops.merge_partials(torch.stack([o for o, _ in parts]),
                               torch.stack([lse for _, lse in parts]), dtype)


def _scale_gap(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def _bf16_ulp(x):
    return torch.exp2(torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126))) - 7)


# (M, pos) over T = 48 slots: pos 0 (every slice but the first empty), a pos
# inside slice 1, the last slot of a slice, and past the cache
CASES = [(M, pos) for M in (2, 3, 4, 16) for pos in (0, 13, 47, 60)]


@pytest.mark.parametrize("M,pos", CASES)
def test_plain_partials_merge_to_decode_ref(M, pos):
    q, k, v = _inputs(2, 8, 2, 48, 16, seed=M * 100 + pos)
    p = torch.tensor(pos, dtype=torch.int32)
    parts = _partials(q, k, v, p, M, _plain)
    merged = _merge(parts)
    plain = dref.merge_partials([o for o, _ in parts], [lse for _, lse in parts])
    want = dref.decode_ref(q, k, v, p)
    gap, gap_plain = _scale_gap(merged, want), _scale_gap(merged, plain)
    print(f"M={M} pos={pos}: merged vs decode_ref {gap:.3g}, vs the plain merge "
          f"{gap_plain:.3g} of the output's scale")
    assert gap <= MERGE_TOL and gap_plain <= MERGE_TOL
    assert _scale_gap(plain, want) <= MERGE_TOL
    T = 48 // M
    for r, (out, lse) in enumerate(parts):
        assert out.dtype == lse.dtype == torch.float32
        if r * T > pos:  # no valid key: 0 and -inf exactly
            assert torch.equal(out, torch.zeros_like(out))
            assert bool(torch.isneginf(lse).all())
        else:
            assert bool(torch.isfinite(lse).all())


@pytest.mark.parametrize("M", [2, 4, 16])
def test_merged_partials_match_the_jax_oracle(M):
    """The reference's float32 decode oracle on the same numpy inputs (its
    GQA repeat done here, as its ops.py does)."""
    jax = pytest.importorskip("jax")
    from repro.kernels.decode_attention.ref import decode_ref as jax_decode_ref

    B, H, KV, T, D, pos = 2, 8, 2, 64, 16, 37
    q, k, v = _inputs(B, H, KV, T, D, seed=M)
    p = torch.tensor(pos, dtype=torch.int32)
    parts = _partials(q, k, v, p, M, _plain)
    merged = _merge(parts)
    rep = H // KV
    kk = k.repeat_interleave(rep, dim=1).numpy()
    vv = v.repeat_interleave(rep, dim=1).numpy()
    want = torch.from_numpy(np.array(jax_decode_ref(
        jax.numpy.asarray(q.numpy()), jax.numpy.asarray(kk), jax.numpy.asarray(vv),
        jax.numpy.asarray(pos, jax.numpy.int32))))
    gap = _scale_gap(merged, want)
    print(f"M={M}: merged vs the reference's oracle {gap:.3g} of the output's scale")
    assert gap <= MERGE_TOL


def test_bf16_merge_within_one_ulp_of_a_whole_call():
    q, k, v = _inputs(2, 8, 2, 48, 16, seed=7, dtype=torch.bfloat16)
    p = torch.tensor(40, dtype=torch.int32)
    whole = dops.decode(q, k, v, p)
    for M in (2, 3, 4, 16):
        parts = _partials(q, k, v, p, M, _plain)
        merged = _merge(parts, q.dtype)
        d = (merged.float() - whole.float()).abs()
        assert bool((d <= _bf16_ulp(whole) + 1e-6).all()), M


def test_partial_form_at_slot_zero_and_checks():
    """slot0 = 0 without the log-sum-exp is the plain call; the partial
    form's output rounds to it; a negative slot0 raises."""
    q, k, v = _inputs(1, 4, 2, 32, 16, seed=3)
    p = torch.tensor(20, dtype=torch.int32)
    before = dops.decode.LAUNCHES, dops.decode.PARTIAL_LAUNCHES
    assert torch.equal(dops.decode(q, k, v, p, slot0=0), dref.decode_ref(q, k, v, p))
    out, lse = dops.decode(q, k, v, p, slot0=0, return_lse=True)
    assert _scale_gap(out, dref.decode_ref(q, k, v, p)) <= MERGE_TOL
    # slot0 without the log-sum-exp: the slice's output in q's dtype
    out8 = dops.decode(q, k[:, :, 8:], v[:, :, 8:], p, slot0=8)
    want8, _ = dref.decode_partial_ref(q, k[:, :, 8:], v[:, :, 8:], p, 8)
    assert torch.equal(out8, want8.to(q.dtype))
    with pytest.raises(ValueError, match="slot0"):
        dops.decode(q, k, v, p, slot0=-1)
    # the CPU's plain path launches nothing, of either form
    assert (dops.decode.LAUNCHES, dops.decode.PARTIAL_LAUNCHES) == before


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on a GPU host)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("M", [2, 4, 16])
@pytest.mark.parametrize("G,D", [(2, 128), (3, 128), (8, 64)])
def test_kernel_partials_match_plain(cuda, dtype, M, G, D):
    B, KV, T = 2, 4, 1024
    q, k, v = _inputs(B, G * KV, KV, T, D, seed=M + G + D, dtype=dtype, device=cuda)
    for pos in (0, 300, T - 1):
        p = torch.tensor(pos, dtype=torch.int32, device=cuda)
        got = _partials(q, k, v, p, M, _plain)
        want = _partials(q.cpu(), k.cpu(), v.cpu(), p.cpu(), M,
                         lambda *a: dref.decode_partial_ref(*a))
        for r, ((o, lse), (wo, wlse)) in enumerate(zip(got, want)):
            if torch.isneginf(wlse).all():
                assert torch.equal(o.cpu(), wo) and bool(torch.isneginf(lse).all()), r
                continue
            assert _scale_gap(o.cpu(), wo) <= F32_TOL, (pos, r)
            assert float((lse.cpu() - wlse).abs().max()) <= F32_TOL, (pos, r)
        merged = _merge(got)
        plain = dref.merge_partials([o.cpu() for o, _ in want], [lse for _, lse in want])
        assert _scale_gap(merged.cpu(), plain) <= F32_TOL, pos
        whole = dops.decode(q, k, v, p)
        ref32 = dref.decode_ref(q.float().cpu(), k.float().cpu(), v.float().cpu(), p.cpu())
        if dtype == torch.float32:
            assert _scale_gap(merged.cpu(), ref32) <= F32_TOL
            assert _scale_gap(merged, whole) <= F32_TOL
        else:
            m16 = merged.to(dtype).float()
            assert bool(((m16 - whole.float()).abs() <= 2 * _bf16_ulp(whole) + 2e-5).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_kernel_partial_at_slot_zero_rounds_to_the_plain_call(cuda, dtype):
    q, k, v = _inputs(4, 16, 8, 512, 128, seed=9, dtype=dtype, device=cuda)
    p = torch.tensor(400, dtype=torch.int32, device=cuda)
    before = dops.decode.LAUNCHES, dops.decode.PARTIAL_LAUNCHES
    out, lse = dops.decode(q, k, v, p, slot0=0, return_lse=True)
    assert (dops.decode.LAUNCHES, dops.decode.PARTIAL_LAUNCHES) == (before[0], before[1] + 1)
    assert torch.equal(out.to(dtype), dops.decode(q, k, v, p))


@pytest.mark.cuda
def test_kernel_partial_form_graph_replays_count_apart(cuda):
    """A CUDA graph of one partial call records it under the partial
    form's counter, and each replay adds one there and none to LAUNCHES."""
    q, k, v = _inputs(4, 16, 8, 512, 128, seed=10, dtype=torch.bfloat16, device=cuda)
    p = torch.tensor(300, dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dops.decode(q, k[:, :, 256:], v[:, :, 256:], p, slot0=256, return_lse=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = _build.Graph()
    with graph.capture():
        out, lse = dops.decode(q, k[:, :, 256:], v[:, :, 256:], p, slot0=256, return_lse=True)
    assert graph.launches == {(dops.decode, "PARTIAL_LAUNCHES"): 1}
    before = dops.decode.LAUNCHES, dops.decode.PARTIAL_LAUNCHES
    graph.replay()
    graph.replay()
    assert (dops.decode.LAUNCHES, dops.decode.PARTIAL_LAUNCHES) == (before[0], before[1] + 2)
    want = dops.decode(q, k[:, :, 256:], v[:, :, 256:], p, slot0=256, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
