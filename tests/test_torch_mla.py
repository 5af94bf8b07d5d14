"""The port's MLA (DeepSeek-V2 multi-head latent attention,
``models/layers.py``) against the JAX package's, on the CPU.

Weights and inputs are drawn with numpy from a seed and given to both
packages, at deepseek-v2-lite's reduced width (d 64, 4 heads, kv_lora 32,
qk_nope 16, qk_rope 8, v_head 16) and at its full width (d 2048, 16 heads,
kv_lora 512, 128 / 64 / 128) with few tokens:

- the prefill (the plain, expanded form) against ``apply_mla``;
- the block's cache fill (``apply_block_prefill`` of an "mla" block: the
  normed latents and rotated rope keys in the first slots of a zero cache)
  against the reference's;
- the absorbed decode against ``decode_mla`` from the same cache, several
  steps: its output, and the cache it writes IN PLACE at ``pos`` (only that
  slot changes) against the reference's returned cache.

Bounds: in float32, outputs within 1e-5 of their largest |value| (sums in
other orders; measured at most 7.4e-7, at full width) and the caches,
which come from the same few products, within 1e-6 of theirs. In
bfloat16 (reduced width) both packages round the same intermediates to
bfloat16 but sum in other orders, so a rounding can flip by one bfloat16
ulp and move later ones: outputs within 2 bfloat16 ulps of their largest
|value| (measured 0.005 of it, 0.64 ulp), caches within one ulp of each
element.

Port-only: decoding token by token from an empty cache gives the
prefill's output (float32, 1e-5 of the largest |value|).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")  # the reference; absent on a GPU host
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

WIDTHS = {
    "reduced": dict(d_model=64, n_heads=4, kv_lora=32, qk_nope=16, qk_rope=8, v_head=16),
    "full": dict(d_model=2048, n_heads=16, kv_lora=512, qk_nope=128, qk_rope=64, v_head=128),
}
B, S, CL, STEPS = 2, 12, 16, 3
F32_TOL = 1e-5  # of the largest |value|
CACHE_F32_TOL = 1e-6
BF16_ULPS = 2  # of the largest |value|


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small products only: run torch on one thread, and give the pool back
    afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(spec, dtype, seed=0):
    rng = np.random.default_rng(seed)
    d, h, L_, nope, rope, v = (spec[k] for k in ("d_model", "n_heads", "kv_lora", "qk_nope",
                                                 "qk_rope", "v_head"))

    def draw(*shape, fan):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(1 / np.sqrt(fan))

    p = {"wq": draw(d, h, nope + rope, fan=d), "wdkv": draw(d, L_, fan=d),
         "wk_rope": draw(d, rope, fan=d),
         "kv_norm": {"scale": rng.standard_normal(L_, dtype=np.float32) * np.float32(0.1)},
         "wuk": draw(L_, h, nope, fan=L_), "wuv": draw(L_, h, v, fan=L_),
         "wo": draw(h, v, d, fan=h * v)}
    x = rng.standard_normal((B, S + STEPS, d), dtype=np.float32)
    jd = getattr(jnp, dtype)
    pj = jax.tree.map(lambda a: jnp.asarray(a).astype(jd), p)
    pt = jax.tree.map(lambda a: torch.from_numpy(a).to(getattr(torch, dtype)), p)
    return pj, pt, x


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 2.0**-126))) - 7)


def _within(got: torch.Tensor, want, dtype, cache=False) -> float:
    g, w = got.float().numpy(), _np(want)
    assert g.shape == w.shape
    d = np.abs(g - w)
    scale = float(np.abs(w).max())
    if dtype == "float32":
        assert d.max() <= (CACHE_F32_TOL if cache else F32_TOL) * scale, d.max() / scale
    elif cache:
        assert (d <= _ulp(np.maximum(np.abs(g), np.abs(w)))).all(), d.max()
    else:
        assert d.max() <= BF16_ULPS * _ulp(scale), d.max() / _ulp(scale)
    return float(d.max() / scale)


def _block(spec):
    return T.BlockSpec(kind="mla", mla=L.MLASpec(**spec)), JT.BlockSpec(
        kind="mla", mla=JL.MLASpec(**spec))


CASES = [("reduced", "float32"), ("full", "float32"), ("reduced", "bfloat16")]


@pytest.mark.parametrize("width,dtype", CASES)
def test_prefill_matches_reference(width, dtype, record_property):
    spec = WIDTHS[width]
    pj, pt, x = _params(spec, dtype)
    xs = x[:, :S]
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    want = jax.jit(lambda p, x: JL.apply_mla(p, JL.MLASpec(**spec), x, jnp.asarray(pos)))(
        pj, jnp.asarray(xs).astype(getattr(jnp, dtype)))
    got = L.apply_mla(pt, L.MLASpec(**spec), torch.from_numpy(xs).to(getattr(torch, dtype)),
                      torch.from_numpy(pos.copy()))
    assert got.dtype == getattr(torch, dtype)
    record_property("gap_of_max", _within(got, want, dtype))


def _prefill_both(spec, dtype, pj, pt, x):
    """Both packages' block prefill of the first S tokens into a cache of CL
    slots: (reference y, cache), (port y, cache)."""
    tb, jb = _block(spec)
    jp = {"norm": {"scale": jnp.zeros((spec["d_model"],), getattr(jnp, dtype))}, "mla": pj}
    tp = {"norm": {"scale": torch.zeros(spec["d_model"], dtype=getattr(torch, dtype))},
          "mla": pt}
    xs = x[:, :S]
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).copy()
    want = jax.jit(lambda p, x: JT.apply_block_prefill(
        jb, p, x, {"positions": jnp.asarray(pos), "cache_len": CL}))(
        jp, jnp.asarray(xs).astype(getattr(jnp, dtype)))
    got = T.apply_block_prefill(tb, tp, torch.from_numpy(xs).to(getattr(torch, dtype)),
                                {"positions": torch.from_numpy(pos), "cache_len": CL})
    return (jb, jp, want), (tb, tp, got)


@pytest.mark.parametrize("width,dtype", CASES)
def test_cache_fill_and_absorbed_decode_match_reference(width, dtype, record_property):
    spec = WIDTHS[width]
    pj, pt, x = _params(spec, dtype, seed=1)
    (jb, jp, (jy, jc)), (tb, tp, (ty, tc)) = _prefill_both(spec, dtype, pj, pt, x)
    worst = _within(ty, jy, dtype)
    for name in ("latent", "k_rope"):
        assert tc[name].shape == (B, CL, spec["kv_lora" if name == "latent" else "qk_rope"])
        assert not tc[name][:, S:].any()
        worst = max(worst, _within(tc[name], jc[name], dtype, cache=True))
    decode = jax.jit(lambda p, x, c, pos: JT.apply_block_decode(jb, p, x, c, pos, {}))
    for i in range(STEPS):
        xi = x[:, S + i:S + i + 1]
        jy, jc = decode(jp, jnp.asarray(xi).astype(getattr(jnp, dtype)), jc,
                        jnp.asarray(S + i, jnp.int32))
        before = {k: v.clone() for k, v in tc.items()}
        ty, tc2 = T.apply_block_decode(tb, tp, torch.from_numpy(xi).to(getattr(torch, dtype)), tc,
                                       torch.tensor(S + i, dtype=torch.int32))
        assert tc2 is tc  # written in place, slot S + i only
        for k, v in tc.items():
            changed = (v != before[k]).any(dim=(0, 2)).nonzero().flatten().tolist()
            assert changed in ([S + i], []), (k, changed)
        worst = max(worst, _within(ty, jy, dtype))
        for name in ("latent", "k_rope"):
            worst = max(worst, _within(tc[name], jc[name], dtype, cache=True))
    record_property("gap_of_max", worst)


def test_decode_from_an_empty_cache_matches_prefill():
    spec = WIDTHS["reduced"]
    _, pt, x = _params(spec, "float32", seed=2)
    s = L.MLASpec(**spec)
    xt = torch.from_numpy(x[:, :S])
    want = L.apply_mla(pt, s, xt, torch.arange(S)[None].expand(B, S))
    cache = {"latent": torch.zeros(B, CL, spec["kv_lora"]), "k_rope": torch.zeros(B, CL, spec["qk_rope"])}
    for i in range(S):
        y, cache = L.decode_mla(pt, s, xt[:, i:i + 1], cache, torch.tensor(i, dtype=torch.int32))
        d = float((y[:, 0] - want[:, i]).abs().max())
        assert d <= F32_TOL * float(want[:, i].abs().max()), (i, d)
