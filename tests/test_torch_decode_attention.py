"""The port's flash-decode kernel: its split arithmetic and its launch plan.

The CUDA kernel cuts the valid keys 0..min(pos, T-1) of each (batch, kv
head) into ``n_splits`` balanced ranges, one CTA each, keeps a softmax state
(m, l, acc) per split and merges the states in rank order inside a
thread-block cluster. ``ref.decode_split_ref`` is that arithmetic in plain
PyTorch. On the CPU it is held here to the reference's Pallas kernel in
interpret mode (``repro.kernels.decode_attention.ops.decode``, T % 256 == 0)
and to its float32 oracle (``repro.kernels.decode_attention.ref.decode_ref``,
ragged T), on the same inputs made from a numpy seed: within 2e-5 in
float32 and one bf16 ulp + 2e-5 in bfloat16, the bounds the kernel is held
to on the card. Faulty versions (a dropped split, a merge without its
rescale) break that bound. The wrapper's choice of ``n_splits`` is checked
for given SM counts.

On the card (``-m cuda``) the kernel is held to ``ref.decode_ref`` and
``ref.decode_split_ref`` within the same bounds, for groups of 1, 2, 3 and 8
query heads, D = 16, 64, 128 and 256, both dtypes, pos from 0 to past the
cache, and every n_splits; two calls are bitwise equal, a CUDA graph of one
call replays bit for bit at any pos written into the pos tensor in place,
and a sliding window's ring (T = window slots, the absolute pos) attends
what the reference's ring mask does.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.decode_attention import ref as dref

F32_TOL = 2e-5  # float32 sums in other orders, as tests/test_kernels.py


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


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at |x| (float32 tensor)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0**-126))) - 7)


def _within(got, want, dtype) -> bool:
    """float32: within 2e-5; bfloat16: within one bf16 ulp of the larger
    magnitude + 2e-5 (near 0 bf16 keeps float32's noise)."""
    g = got.float()
    if isinstance(want, torch.Tensor):
        w = want.float()
    else:  # a JAX array
        w = torch.from_numpy(np.array(want, np.float32))
    d = (g - w).abs()
    if dtype == torch.float32:
        return bool((d <= F32_TOL).all())
    return bool((d <= _bf16_ulp(torch.maximum(g.abs(), w.abs())) + F32_TOL).all())


# --- the split ranges -----------------------------------------------------------
@pytest.mark.parametrize("n_splits", range(1, 9))
@pytest.mark.parametrize("T", [1, 7, 300, 4352])
def test_split_bounds_cover_the_valid_keys_once(T, n_splits):
    """pos 0, 1, n_splits - 2, T - 1 and past the cache: the ranges tile
    0..min(pos, T-1) in order, sizes differ by at most one, and splits are
    empty only when there are fewer keys than splits."""
    for pos in sorted({0, 1, max(n_splits - 2, 0), T - 1, T + 700}):
        bounds = dref.split_bounds(pos, T, n_splits)
        n = min(pos, T - 1) + 1
        assert len(bounds) == n_splits
        assert bounds[0][0] == 0 and bounds[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
        sizes = [hi - lo for lo, hi in bounds]
        assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1
        assert sum(s == 0 for s in sizes) == max(n_splits - n, 0)


# --- the split arithmetic against the reference ---------------------------------
@pytest.mark.parametrize("shape", [(2, 4, 256, 64), (1, 8, 512, 128)])
@pytest.mark.parametrize("pos_frac", [0.0, 0.4, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_plain_matches_pallas(shape, pos_frac, dtype):
    """GQA (2 query heads a kv head, repeated for the reference's ops.py),
    n_splits 1, 3, 4 and 8 against one Pallas run."""
    import jax.numpy as jnp
    from repro.kernels.decode_attention.ops import decode

    B, H, T, D = shape
    pos = int((T - 1) * pos_frac)
    arrs = _arrays([(B, H, D), (B, H // 2, T, D), (B, H // 2, T, D)], seed=T + int(10 * pos_frac))
    tdt = getattr(torch, dtype)
    want = decode(*[jnp.asarray(a, getattr(jnp, dtype)) for a in arrs], jnp.asarray(pos, jnp.int32))
    q, k, v = _torch(arrs, tdt)
    for n_splits in (1, 3, 4, 8):
        got = dref.decode_split_ref(q, k, v, torch.tensor(pos, dtype=torch.int32), n_splits)
        assert got.dtype == tdt and got.shape == (B, H, D)
        assert _within(got, want, tdt), n_splits


@pytest.mark.parametrize("T,pos", [(1, 0), (7, 3), (100, 57), (300, 299), (300, 1000), (1000, 5)])
def test_split_plain_ragged_matches_reference_oracle(T, pos):
    """Any T, pos past the cache, more splits than keys (empty splits):
    against the reference's float32 oracle, GQA repeated for it."""
    import jax.numpy as jnp
    from repro.kernels.decode_attention.ref import decode_ref

    q, k, v = _arrays([(2, 4, 16), (2, 2, T, 16), (2, 2, T, 16)], seed=T + pos)
    want = decode_ref(jnp.asarray(q), jnp.repeat(jnp.asarray(k), 2, 1),
                      jnp.repeat(jnp.asarray(v), 2, 1), jnp.asarray(pos))
    for n_splits in (1, 2, 5, 8):
        got = dref.decode_split_ref(*_torch([q, k, v], torch.float32),
                                    torch.tensor(pos, dtype=torch.int32), n_splits)
        assert _within(got, want, torch.float32), n_splits


def _faulty_split(q, k, v, pos, n_splits, fault):
    """decode_split_ref with one deliberate fault: ``drop_split`` leaves out
    split 1's state; ``no_rescale`` merges the states with weight 1, not
    exp(m - M)."""
    rep = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).float()
    v = v.repeat_interleave(rep, dim=1).float()
    states = []
    for s, (lo, hi) in enumerate(dref.split_bounds(pos, k.shape[2], n_splits)):
        if fault == "drop_split" and s == 1:
            continue
        sc = torch.einsum("bhd,bhtd->bht", q.float(), k[:, :, lo:hi]) / np.sqrt(q.shape[-1])
        m = sc.amax(-1, keepdim=True)
        p = torch.exp(sc - m)
        states.append((m, p.sum(-1, keepdim=True), torch.einsum("bht,bhtd->bhd", p, v[:, :, lo:hi])))
    mx = torch.stack([m for m, _, _ in states]).amax(0)
    l_sum, acc = 0.0, 0.0
    for m, l, a in states:
        w = torch.ones_like(m) if fault == "no_rescale" else torch.exp(m - mx)
        l_sum, acc = l_sum + l * w, acc + a * w
    return (acc / l_sum.clamp_min(1e-30)).to(q.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fault", ["drop_split", "no_rescale"])
def test_bound_catches_a_faulty_split_version(fault, dtype):
    """At T = 300, pos 299, 4 splits, q x 4 (so that the splits' maxima
    differ): the bound passes decode_split_ref and fails each fault."""
    q, k, v = _torch(_arrays([(2, 4, 16), (2, 2, 300, 16), (2, 2, 300, 16)], seed=11), dtype)
    q = (q.float() * 4).to(dtype)
    pos = torch.tensor(299, dtype=torch.int32)
    want = dref.decode_ref(q, k, v, pos)
    assert _within(dref.decode_split_ref(q, k, v, pos, 4), want, dtype)
    assert not _within(_faulty_split(q, k, v, 299, 4, fault), want, dtype)


# --- the launch plan --------------------------------------------------------------
def test_choose_splits_fills_one_wave():
    """At the serve shape (B, KV) = (4, 8) on 132 SMs: 4 splits at one CTA
    an SM, 8 at two; never above 8 or below 1; as many as fit in one wave."""
    assert dops.choose_splits(4, 8, 132) in (4, 8)
    assert dops.choose_splits(4, 8, 132, ctas_per_sm=1) == 4
    assert dops.choose_splits(4, 8, 132, ctas_per_sm=2) == 8
    for n_sm in (1, 16, 78, 114, 132, 144):
        for per_sm in (1, 2):
            for B in range(1, 9):
                for KV in (1, 2, 8, 32):
                    n = dops.choose_splits(B, KV, n_sm, ctas_per_sm=per_sm)
                    assert 1 <= n <= dops.MAX_SPLITS == 8
                    assert n == 1 or n * B * KV <= n_sm * per_sm  # one wave
                    assert n == 8 or (n + 1) * B * KV > n_sm * per_sm  # and no fewer


@pytest.mark.parametrize("n_splits", [0, 9, -1])
def test_decode_wrapper_rejects_bad_n_splits(n_splits):
    q, k = torch.zeros((1, 4, 16)), torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="n_splits"):
        dops.decode(q, k, k, torch.tensor(3, dtype=torch.int32), n_splits=n_splits)


def test_cpu_path_ignores_n_splits():
    """On the CPU the wrapper is decode_ref, whatever n_splits, and launches
    nothing."""
    q, k, v = _torch(_arrays([(1, 4, 16), (1, 2, 40, 16), (1, 2, 40, 16)], seed=5), torch.float32)
    pos = torch.tensor(20, dtype=torch.int32)
    n = dops.decode.LAUNCHES
    want = dref.decode_ref(q, k, v, pos)
    for n_splits in (None, 1, 8):
        assert torch.equal(dops.decode(q, k, v, pos, n_splits=n_splits), want)
    assert dops.decode.LAUNCHES == n


# --- on the card -------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on a GPU host)")
    return torch.device("cuda")


def _cache(B, H, KV, T, D, dtype, seed, device):
    """q as a (B, 1, H, D) slice and k, v as (B, KV, T, D) views of the
    model's (B, T, KV, D) cache layout."""
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((B, 1, H, D), generator=g, device=device).to(dtype)[:, 0]
    k = torch.randn((B, T, KV, D), generator=g, device=device).to(dtype).transpose(1, 2)
    v = torch.randn((B, T, KV, D), generator=g, device=device).to(dtype).transpose(1, 2)
    return q, k, v


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


POS_CASES = ["0", "1", "splits-1", "mid", "T-1", "past"]


@pytest.mark.cuda
@pytest.mark.parametrize("pos_case", POS_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 3, 8])
def test_decode_kernel_matches_both_plain_versions(cuda, G, D, dtype, pos_case):
    B, KV, T = 2, 2, 1000
    n_splits = dops.choose_splits(B, KV, torch.cuda.get_device_properties(cuda).multi_processor_count)
    pos = {"0": 0, "1": 1, "splits-1": n_splits - 1, "mid": T // 2, "T-1": T - 1,
           "past": T + 300}[pos_case]
    q, k, v = _cache(B, G * KV, KV, T, D, dtype, seed=G * 1000 + D + pos, device=cuda)
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    n = dops.decode.LAUNCHES
    got = dops.decode(q, k, v, p)
    torch.cuda.synchronize()
    assert dops.decode.LAUNCHES == n + 1
    assert got.shape == (B, G * KV, D) and got.dtype == dtype
    assert _within(got, dref.decode_ref(q, k, v, p), dtype)
    assert _within(got, dref.decode_split_ref(q, k, v, p, n_splits), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_splits", range(1, 9))
def test_decode_kernel_any_n_splits(cuda, n_splits, dtype):
    """Every cluster size: ragged column shares of D = 128 (3, 5, 6, 7)."""
    q, k, v = _cache(1, 16, 8, 1000, 128, dtype, seed=n_splits, device=cuda)
    p = torch.tensor(999, dtype=torch.int32, device=cuda)
    got = dops.decode(q, k, v, p, n_splits=n_splits)
    torch.cuda.synchronize()
    assert _within(got, dref.decode_ref(q, k, v, p), dtype)
    assert _within(got, dref.decode_split_ref(q, k, v, p, n_splits), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [300, 511, 512, 4223])
def test_decode_kernel_on_a_ring(cuda, dtype, pos):
    """gemma3's local layers: a ring of T = 512 slots at head_dim 256, group
    4, and the absolute pos. Before the wrap (pos < T) slots 0..pos hold
    the keys, after it every slot does: the kernel's "keys 0..pos, all once
    pos >= T" is the reference's ring mask, with no window mask of its own."""
    q, k, v = _cache(4, 4, 1, 512, 256, dtype, seed=pos, device=cuda)
    p = torch.tensor(pos, dtype=torch.int32, device=cuda)
    got = dops.decode(q, k, v, p)
    torch.cuda.synchronize()
    valid = torch.arange(512, device=cuda) <= (pos if pos < 512 else 511)
    rep = q.shape[1] // k.shape[1]
    kk, vv = (t.repeat_interleave(rep, dim=1).float() for t in (k, v))
    s = torch.einsum("bhd,bhtd->bht", q.float(), kk) / 16.0
    want = torch.einsum("bht,bhtd->bhd", torch.softmax(s.masked_fill(~valid, -torch.inf), -1), vv)
    assert _within(got, want.to(dtype), dtype)
    assert _within(got, dref.decode_ref(q, k, v, p), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_is_bitwise_repeatable(cuda, dtype):
    """The splits merge in rank order and the key groups in group order: two
    calls on the same inputs give the same bits."""
    q, k, v = _cache(4, 16, 8, 4352, 128, dtype, seed=3, device=cuda)
    p = torch.tensor(4351, dtype=torch.int32, device=cuda)
    a = dops.decode(q, k, v, p)
    b = dops.decode(q, k, v, p)
    torch.cuda.synchronize()
    assert torch.equal(_bits(a), _bits(b))


@pytest.mark.cuda
def test_decode_kernel_graph_replays_at_any_pos(cuda):
    """A CUDA graph of one call at the serve shape; pos written in place
    between replays. Each replay equals the eager call bit for bit and holds
    against decode_ref: pos is read on the device, the grid does not move."""
    dtype = torch.bfloat16
    q, k, v = _cache(4, 16, 8, 4352, 128, dtype, seed=4, device=cuda)
    pos = torch.tensor(0, dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        dops.decode(q, k, v, pos)
    torch.cuda.current_stream().wait_stream(side)
    graph = _build.Graph()
    with graph.capture():
        out = dops.decode(q, k, v, pos)
    assert graph.launches == {dops.decode: 1}
    for p in (0, 255, 4095, 4351):
        pos.fill_(p)
        before = dops.decode.LAUNCHES
        graph.replay()
        assert dops.decode.LAUNCHES == before + 1
        eager = dops.decode(q, k, v, torch.tensor(p, dtype=torch.int32, device=cuda))
        torch.cuda.synchronize()
        assert torch.equal(_bits(out), _bits(eager)), p
        assert _within(out, dref.decode_ref(q, k, v, pos), dtype), p
