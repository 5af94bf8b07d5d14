"""The port's M-RoPE (qwen2-vl) against the JAX package's.

``layers.apply_mrope`` is held to the reference's ``apply_mrope`` on inputs
drawn with numpy, with the three position components drawn apart: float32
within 2e-6 of the output's scale (both rotate in float32; cos and sin of
the same float32 angles differ in their last bit between the two
libraries; measured 7.4e-8). qwen2-vl-reduced (the reference's params
carried across with ``load_jax_params``) is held to the reference model on
a prompt whose positions3 follow Qwen2-VL's rule for an image
(``serve_lm.image_positions3``: a 2 x 4 patch grid after 3 text tokens):
prefill and decode logits in float32 within one bfloat16 ulp + 1e-5
(measured 4.9e-4), in bfloat16 within 0.25 (measured 0.096; the reference
rounds its attention scores and probabilities to bf16 where the port keeps
them in float32, as the kernels do), and the training loss within 1e-5
(float32; measured 4.8e-7). Decode at pos P rotates the token at (P, P, P),
as the reference does, so it equals a prefill of P + 1 tokens whose
positions3 end in (P, P, P). The full config's parameters are
counted at 80 layers and at the 16 that one card serves.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import serve_lm
from repro_torch.configs import build_model, get_config
from repro_torch.models import layers as L
from repro_torch.models.convert import load_jax_params
from repro_torch.models.param_defs import count_params
from repro_torch.models.transformer import lm_active_params, lm_param_defs

ARCH = "qwen2-vl-72b"
B, S, CL, STEPS = 2, 16, 32, 4
GRID = (3, (2, 4))  # text tokens before the image, its patch grid
BF16_TOL = 0.25


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


@pytest.fixture(scope="module")
def jax_model():
    """The reference's reduced model and its params, bf16 and float32."""
    import jax
    import jax.numpy as jnp
    from repro.configs import build_model as jax_build
    from repro.configs import get_config as jax_config

    model = jax_build(jax_config(ARCH, reduced=True))
    params = model.init(0)
    return model, {"bfloat16": params,
                   "float32": jax.tree.map(lambda a: a.astype(jnp.float32), params)}


def _port(params):
    import jax

    return load_jax_params(build_model(get_config(ARCH, reduced=True), device="cpu"),
                           jax.tree.map(np.asarray, params))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    return 2.0 ** (np.floor(np.log2(np.maximum(x, 2.0**-126))) - 7)


def _logits_within(got, want, dtype: str) -> float:
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    d = np.abs(g - w)
    if dtype == "float32":
        assert (d <= _bf16_ulp(np.maximum(abs(g), abs(w))) + 1e-5).all(), float(d.max())
    else:
        assert d.max() <= BF16_TOL, float(d.max())
    return float(d.max())


def _inputs(seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (B, S), dtype=np.int32)
    steps = [rng.integers(0, 256, (B, 1), dtype=np.int32) for _ in range(STEPS)]
    return toks, steps, serve_lm.image_positions3(B, S, *GRID)


@pytest.mark.parametrize("sections,hd", [((16, 24, 24), 128), ((2, 3, 3), 16), ((1, 1, 2), 8)])
def test_apply_mrope_matches_reference(sections, hd):
    import jax.numpy as jnp
    from repro.models.layers import apply_mrope

    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 12, 3, hd)).astype(np.float32)
    p3 = rng.integers(0, 5000, (3, 2, 12)).astype(np.int32)  # t, h, w drawn apart
    want = np.asarray(apply_mrope(jnp.asarray(x), jnp.asarray(p3), 1e6, sections))
    got = L.apply_mrope(torch.from_numpy(x), torch.from_numpy(p3), 1e6, sections)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert np.abs(got.numpy() - want).max() <= 2e-6 * np.abs(want).max()
    # bf16 in, bf16 out: rotated in float32, rounded once
    got16 = L.apply_mrope(torch.from_numpy(x).bfloat16(), torch.from_numpy(p3), 1e6, sections)
    want16 = np.asarray(apply_mrope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(p3), 1e6,
                                    sections), np.float32)
    d = np.abs(got16.float().numpy() - want16)
    assert got16.dtype == torch.bfloat16
    assert (d <= _bf16_ulp(np.abs(want16))).all(), float(d.max())


def test_apply_mrope_with_equal_components_is_rope():
    """With t = h = w, M-RoPE is plain RoPE over the whole head."""
    x = torch.randn((2, 9, 4, 16), generator=torch.Generator().manual_seed(0))
    pos = torch.arange(9)[None].expand(2, 9)
    got = L.apply_mrope(x, pos[None].expand(3, 2, 9), 1e4, (2, 3, 3))
    assert torch.equal(got, L.apply_rope(x, pos, 1e4))


def test_apply_mrope_checks_its_sections():
    with pytest.raises(ValueError, match="head_dim / 2"):
        L.apply_mrope(torch.zeros((1, 2, 1, 16)), torch.zeros((3, 1, 2), dtype=torch.int32),
                      1e6, (2, 3, 2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(jax_model, dtype):
    import jax
    import jax.numpy as jnp

    model, by_dtype = jax_model
    params = by_dtype[dtype]
    port = _port(params)
    toks, steps, p3 = _inputs(seed=5)
    assert (p3[0] != p3[1]).any() and (p3[1] != p3[2]).any()
    jl, jc = jax.jit(lambda p, t, q: model.prefill(p, {"tokens": t, "cache_len": CL,
                                                       "positions3": q}))(
        params, jnp.asarray(toks), jnp.asarray(p3.numpy()))
    pl, pc = port.prefill({"tokens": torch.from_numpy(toks), "cache_len": CL, "positions3": p3})
    assert pl.shape == (B, 1, 256) and pc["g0"][0]["b0"]["k"].shape == (B, CL, 2, 16)
    _logits_within(pl, jl, dtype)
    decode = jax.jit(model.decode_step)
    for i, tok in enumerate(steps):
        jl, jc = decode(params, jc, {"token": jnp.asarray(tok),
                                     "pos": jnp.asarray(S + i, jnp.int32)})
        pl, pc = port.decode_step(pc, {"token": torch.from_numpy(tok), "pos": S + i})
        _logits_within(pl, jl, dtype)
    # the first layer's keys, rotated by the image's positions, at the same slots
    got = pc["g0"][0]["b0"]["k"].float().numpy()
    want = np.asarray(jc["g0"]["b0"]["k"][0], np.float32)
    d = np.abs(got - want)
    if dtype == "float32":
        assert (d <= 1e-5 + 1e-5 * np.abs(want)).all(), float(d.max())
    else:
        assert (d <= _bf16_ulp(np.maximum(abs(got), abs(want)))).all(), float(d.max())


def test_default_positions3_are_the_token_positions(jax_model):
    """Without positions3 both sides rotate every component by the token's
    position (the reference's ``_ctx``)."""
    import jax.numpy as jnp

    model, by_dtype = jax_model
    params = by_dtype["float32"]
    toks, _, _ = _inputs(seed=6)
    jl, _ = model.prefill(params, {"tokens": jnp.asarray(toks)})
    pl, _ = _port(params).prefill({"tokens": torch.from_numpy(toks)})
    _logits_within(pl, jl, "float32")


def test_loss_matches_jax(jax_model):
    """The training loss with an image's positions3 (float32)."""
    import jax.numpy as jnp

    model, by_dtype = jax_model
    params = by_dtype["float32"]
    port = _port(params)
    toks, _, p3 = _inputs(seed=7)
    want, _ = model.loss(params, {"tokens": jnp.asarray(toks),
                                  "positions3": jnp.asarray(p3.numpy())})
    got, _ = port.loss(port.params(), {"tokens": torch.from_numpy(toks), "positions3": p3})
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5


def test_decode_equals_prefill_of_one_more_token():
    """Decode at pos P after a prefill with an image's positions3 against a
    prefill of the P + 1 tokens whose positions3 end in (P, P, P) (float32
    weights: within one bf16 ulp + 1e-5)."""
    port = build_model(get_config(ARCH, reduced=True), device="cpu", seed=3).float()
    toks, steps, p3 = _inputs(seed=8)
    _, cache = port.prefill({"tokens": torch.from_numpy(toks), "cache_len": CL, "positions3": p3})
    logits, _ = port.decode_step(cache, {"token": torch.from_numpy(steps[0]), "pos": S})
    p3_ext = torch.cat([p3, torch.full((3, B, 1), S, dtype=torch.int32)], dim=2)
    ref, _ = port.prefill({"tokens": torch.from_numpy(np.concatenate([toks, steps[0]], 1)),
                           "positions3": p3_ext})
    _logits_within(logits, ref.float().numpy(), "float32")


@pytest.mark.parametrize("layers,n,active", [(80, 72_706_203_648, 71_460_487_168),
                                             (16, 16_534_380_544, 15_288_664_064)])
def test_full_config_param_counts_match_reference(layers, n, active):
    """Counted from the declarations, nothing allocated: all 80 layers and
    the 16 that ``chip_smoke.py`` serves on one card."""
    from repro.configs import get_config as jax_config
    from repro.models.transformer import TransformerLM as JaxLM

    def cut(cfg):
        return dataclasses.replace(cfg, groups=(dataclasses.replace(cfg.groups[0],
                                                                    repeat=layers),))

    cfg = cut(get_config(ARCH))
    ref = JaxLM(cut(jax_config(ARCH)))
    assert count_params(lm_param_defs(cfg)) == n == ref.num_params()
    assert lm_active_params(cfg) == active == ref.num_active_params()


def test_image_positions3_follows_qwen2_vl():
    """Text before the image on all three components, the patches at t = o,
    h = o + row, w = o + column, the text after it from o + max(gh, gw)."""
    p3 = serve_lm.image_positions3(2, 12, 2, (2, 3))
    want = [[0, 1, 2, 2, 2, 2, 2, 2, 5, 6, 7, 8],
            [0, 1, 2, 2, 2, 3, 3, 3, 5, 6, 7, 8],
            [0, 1, 2, 3, 4, 2, 3, 4, 5, 6, 7, 8]]
    assert p3.dtype == torch.int32 and p3.shape == (3, 2, 12)
    assert p3[:, 0].tolist() == want and torch.equal(p3[:, 0], p3[:, 1])
    with pytest.raises(ValueError, match="does not fit"):
        serve_lm.image_positions3(1, 8, 3, (2, 3))


def test_serve_lm_main_runs_qwen2_vl():
    res = serve_lm.main(["--arch", ARCH, "--device", "cpu", "--reduced", "--batch", "2",
                         "--prompt-len", "8", "--tokens", "3"])
    assert res["tokens"].shape == (2, 3) and res["cache"]["g0"][1]["b0"]["k"].shape == (2, 11, 2, 16)
