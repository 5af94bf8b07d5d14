"""Sliding-window attention in the port against the JAX package.

- The flash wrapper's plain version with ``window=w`` (the CPU path) against
  the reference's plain attention ``_sdpa`` with ``causal_mask(S, S, w)``,
  at head_dim 16 and 256, windows 1, 7, 8 and S, on inputs from a numpy
  seed: float32 within 2e-5 (measured 7.2e-7); bfloat16 within 3e-2
  (measured 1.6e-2), the reference's own bf16 tolerance for its attention
  kernels: its ``_sdpa`` rounds the scores and the probabilities to
  bfloat16, the plain version keeps both in float32.
- The plain tiled version (the bf16 kernel's arithmetic, 64-key tiles at
  head_dim 256) within the P-rounding bound of the plain version with a
  window, for windows that start mid-tile and rows whose first tile is
  wholly masked.
- The ring cache of a windowed layer: after a prefill (shorter than the
  window, one short of it, and longer, which rolls the ring) and after
  decode steps across the wrap (pos = T - 2, T - 1, T, ..., 3T + 1), the
  port's cache and outputs against the reference's ``apply_block_prefill``
  and ``decode_attention``, as a share of the largest |value| (outputs
  reach 22): float32 within 1e-5 (measured outputs 3.4e-7, caches 4.3e-8),
  bfloat16 caches within one bf16 ulp (measured 0: the same projections)
  and outputs within 3e-2 (measured 5.6e-3, one bf16 ulp at 22: the
  reference rounds its scores and probabilities to bfloat16).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.models.convert import to_torch

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


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    return 2.0 ** (np.floor(np.log2(np.maximum(x, 2.0**-126))) - 7)


def _qkv(B, H, KV, S, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, h, D)).astype(np.float32) for h in (H, KV, KV)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,S", [(16, 40), (256, 24)])
@pytest.mark.parametrize("window", [1, 7, 8, "S"])
def test_windowed_plain_matches_reference_sdpa(window, D, S, dtype):
    import jax.numpy as jnp
    from repro.models import layers as JL

    w = S if window == "S" else window
    B, H, KV = 2, 4, 1
    q, k, v = _qkv(B, H, KV, S, D, seed=S + D + w)
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (q, k, v))
    want = JL._sdpa(jq, jk, jv, JL.causal_mask(S, S, w), H // KV)  # (B, S, H, D)
    tq, tk, tv = (torch.from_numpy(a).to(getattr(torch, dtype)).transpose(1, 2)
                  for a in (q, k, v))
    got = fops.attention(tq, tk, tv, window=w).transpose(1, 2)  # the CPU path
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])
    # the port's training attention builds the same mask
    assert torch.equal(PL.causal_mask(S, S, w), torch.from_numpy(np.array(
        JL.causal_mask(S, S, w))))


@pytest.mark.parametrize("S,window", [(200, 1), (200, 7), (200, 65), (200, 130), (130, 64)])
def test_windowed_tiled_plain_within_p_rounding_bound(S, window):
    """The kernel's arithmetic (64-key tiles at head_dim 256; the first
    tiles of late rows are wholly masked, and those rows take m = 0 as the
    reference of their exponentials) within 2**-7 attn(q, k, |v|) + one
    bf16 ulp + 2e-5 of the plain version, and finite."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).transpose(1, 2)
               for a in _qkv(1, 4, 1, S, 256, seed=window))
    got = fref.flash_attention_tiled_ref(q, k, v, window=window).float()
    want = fref.flash_attention_ref(q, k, v, window=window).float()
    absv = fref.flash_attention_ref(q.float(), k.float(), v.float().abs(), window=window)
    assert bool(torch.isfinite(got).all())
    ulp = torch.from_numpy(_bf16_ulp(torch.maximum(got.abs(), want.abs()).numpy()))
    assert bool(((got - want).abs() <= 2.0**-7 * absv + ulp + 2e-5).all())
    assert fref.key_tile(256) == 64 and fref.key_tile(128) == 128


def test_window_arguments_are_checked():
    q = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="causal"):
        fops.attention(q, q, q, causal=False, window=4)
    with pytest.raises(ValueError, match="at least 1"):
        fops.attention(q, q, q, window=0)
    # a window of S or more is the full causal attention
    x = torch.from_numpy(_qkv(1, 2, 2, 8, 16, seed=0)[0]).transpose(1, 2)
    assert torch.equal(fops.attention(x, x, x, window=8), fops.attention(x, x, x))
    assert torch.equal(fops.attention(x, x, x, window=100), fops.attention(x, x, x))


@pytest.mark.parametrize("Sq,T", [(3, 8), (8, 8), (13, 8), (16, 8), (21, 8), (5, 5)])
def test_cache_fill_ring_is_the_reference_roll(Sq, T):
    """Position p of the prompt lands in slot p % T, as the reference's
    ``dynamic_update_slice`` of the last min(T, S) entries then ``roll`` by
    S % T (once the ring is full) places it."""
    t = torch.arange(Sq, dtype=torch.float32).reshape(1, Sq, 1, 1)
    got = PT._cache_fill(t, T, ring=True)[0, :, 0, 0]
    keep = min(T, Sq)
    want = np.zeros(T, np.float32)
    want[:keep] = np.arange(Sq - keep, Sq)
    if keep == T:
        want = np.roll(want, Sq % T)
    assert np.array_equal(got.numpy(), want)


def _block(dtype, window=8):
    """One gemma3-reduced local attention block, the reference's and the
    port's, with the reference's params (numpy) and the port's copy."""
    import jax
    import jax.numpy as jnp
    from repro.configs import base as jbase
    from repro.models import transformer as JT
    from repro.models.param_defs import init_tree

    from repro_torch.configs import base as pbase

    args = (64, 4, 1, 16)
    jb = jbase.attn_block(*args, window=window, qk_norm=True)
    pb = pbase.attn_block(*args, window=window, qk_norm=True)
    params = init_tree(JT.block_defs(jb, 64), jax.random.PRNGKey(3))
    params = jax.tree.map(lambda a: a.astype(getattr(jnp, dtype)), params)
    # the norms' scales are drawn too (the reference inits them to ones)
    rng = np.random.default_rng(5)
    for name in ("q_norm", "k_norm"):
        params["attn"][name]["scale"] = jnp.asarray(
            rng.normal(0, 0.3, 16), getattr(jnp, dtype))
    pp = jax.tree.map(lambda a: to_torch(np.asarray(a)), params)
    return jb, pb, params, pp


def _close(got: torch.Tensor, want, dtype, what, out=True):
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    d = np.abs(g - w)
    scale = max(1.0, float(np.abs(w).max()))
    if dtype == "float32":
        assert d.max() <= 1e-5 * scale, (what, float(d.max()))
    elif out:
        assert d.max() <= TOL["bfloat16"] * scale, (what, float(d.max()))
    else:  # cached k, v: the same projections, one rounding apart
        assert (d <= _bf16_ulp(np.maximum(abs(g), abs(w)))).all(), (what, float(d.max()))
    return float(d.max())


@pytest.fixture(scope="module")
def jax_block_fns():
    """The reference's block prefill and attention decode, jitted once (an
    eager JAX op compiles on every call)."""
    import jax
    from repro.models import layers as JL
    from repro.models import transformer as JT

    prefill = jax.jit(lambda b, p, x, pos, cl: JT.apply_block_prefill(
        b, p, x, {"positions": pos, "cache_len": cl}), static_argnums=(0, 4))
    decode = jax.jit(lambda b, p, x, c, pos: JL.decode_attention(
        p["attn"], b.attn, JT._norm_apply(b.norm, p["norm"], x), c, pos), static_argnums=(0,))
    return prefill, decode


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P", [3, 7, 13])
def test_ring_cache_prefill_and_decode_across_the_wrap_match_jax(jax_block_fns, P, dtype):
    import jax.numpy as jnp

    prefill, decode = jax_block_fns
    T, CL, last = 8, 40, 3 * 8 + 1
    jb, pb, jp, pp = _block(dtype)
    rng = np.random.default_rng(P)
    B = 2
    x = rng.standard_normal((B, last + 1, 64)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    pos = np.broadcast_to(np.arange(P)[None], (B, P))
    jy, jc = prefill(jb, jp, jx[:, :P], jnp.asarray(pos), CL)
    py, pc = PT.apply_block_prefill(pb, pp, tx[:, :P], {"positions": torch.from_numpy(pos.copy()),
                                                         "cache_len": CL})
    assert pc["k"].shape == (B, T, 1, 16) == jc["k"].shape
    _close(py, jy, dtype, "prefill")
    for name in ("k", "v"):
        _close(pc[name], jc[name], dtype, f"prefill cache {name}", out=False)
    seen = set()
    for p in range(P, last + 1):
        h = PT._norm_apply(pb.norm, pp["norm"], tx[:, p:p + 1])
        jy, jc = decode(jb, jp, jx[:, p:p + 1], jc, jnp.asarray(p, jnp.int32))
        k_before = pc["k"]
        py, pc = PL.decode_attention(pp["attn"], pb.attn, h, pc,
                                     torch.tensor(p, dtype=torch.int32))
        assert pc["k"] is k_before  # written in place
        _close(py, jy, dtype, f"decode pos {p}")
        for name in ("k", "v"):
            _close(pc[name], jc[name], dtype, f"cache {name} after pos {p}", out=False)
        seen.add(p)
    if P == 3:  # every step of the wrap: the last free slot, the first overwrite, laps
        assert {T - 2, T - 1, T, 3 * T + 1} <= seen


def test_windowed_layer_cache_has_window_slots():
    s = PL.AttnSpec(64, 4, 1, 16, window=8)
    assert PL.init_attn_cache(s, 2, 40)["k"].shape == (2, 8, 1, 16)
    assert PL.init_attn_cache(s, 2, 5)["k"].shape == (2, 5, 1, 16)
    full = PL.AttnSpec(64, 4, 1, 16)
    assert PL.init_attn_cache(full, 2, 40)["v"].shape == (2, 40, 1, 16)
