"""The port's whisper (encoder-decoder) against the JAX package's.

whisper-reduced with the reference's params carried across bit for bit
(``load_jax_params``: ``enc`` and ``dec`` unstacked per layer), on frame
embeddings and tokens drawn with numpy, on the CPU (the attention wrappers
take their plain versions): the encoder output, the prefill's last-token
logits and 8 teacher-forced decode steps. float32 weights: the encoder
output within 2e-5 of its scale (measured 7.8e-6; the reference's own
float32 output lies 6.7e-6 from its float64 one), the logits as close to
the reference run in float64 as the reference's own float32 run, plus one
bf16 ulp (``test_prefill_and_decode_match_jax`` says why a bound of one
bf16 ulp + 1e-5 cannot hold here). bfloat16 weights: logits within 0.25
(measured 0.118; the reference rounds its attention scores and
probabilities to bf16 where the port keeps them in float32, as the kernels
do). Decode at pos P equals a prefill of P + 1 tokens; parameter counts
and axes are the reference's; the cache's layouts are those the decode
kernel takes; ``loss`` raises (whisper's training is a later slice).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import serve_lm
from repro_torch.configs import build_model, get_config
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.models.convert import load_jax_params, to_torch
from repro_torch.models.param_defs import count_params
from repro_torch.models.whisper import whisper_active_params, whisper_axes, whisper_param_defs
from repro_torch.tree import named_leaves, tree_leaves, tree_unflatten

ARCH = "whisper-base"
B, S_ENC, P, CL, STEPS = 2, 24, 5, 16, 8
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
    params = jax.jit(model.init, static_argnums=0)(0)  # drawn under jit: faster than eager
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


def _inputs(seed, dtype):
    """Frames in the weights' dtype, a prompt and the decode steps' tokens."""
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, S_ENC, 64)).astype(np.float32)
    frames = torch.from_numpy(frames).to(getattr(torch, dtype))
    toks = rng.integers(0, 256, (B, P), dtype=np.int32)
    steps = [rng.integers(0, 256, (B, 1), dtype=np.int32) for _ in range(STEPS)]
    return frames, toks, steps


def _jnp(t: torch.Tensor):
    import jax.numpy as jnp

    return jnp.asarray(t.float().numpy(), {torch.float32: jnp.float32,
                                           torch.bfloat16: jnp.bfloat16}[t.dtype])


def test_load_jax_params_is_bitwise(jax_model):
    import jax

    _, by_dtype = jax_model
    for dtype, params in by_dtype.items():
        port = _port(params)
        leaves = jax.tree_util.tree_leaves_with_path(params)
        n = {"enc": len(port.enc), "dec": len(port.dec)}
        assert sum(n.get(p[0].key, 1) for p, _ in leaves) == len(list(port.parameters()))
        for path, leaf in leaves:
            keys = [p.key for p in path]
            arr = np.asarray(leaf)
            if keys[0] in n:
                for li, layer in enumerate(getattr(port, keys[0])):
                    t = layer
                    for k in keys[1:]:
                        t = t[k]
                    assert torch.equal(t, to_torch(arr[li])), (dtype, keys, li)
            elif keys[0] == "pos_dec":
                assert torch.equal(port.pos_dec, to_torch(arr))
            else:
                assert torch.equal(getattr(port, keys[0])[keys[1]], to_torch(arr))


def test_encoder_matches_jax(jax_model):
    model, by_dtype = jax_model
    params = by_dtype["float32"]
    frames, _, _ = _inputs(seed=1, dtype="float32")
    want = np.asarray(model.encode(params, _jnp(frames)))
    got = _port(params).encode(frames).numpy()
    assert got.shape == (B, S_ENC, 64)
    assert np.abs(got - want).max() <= 2e-5 * np.abs(want).max()


def _jax_run(model, params, frames, toks, steps):
    """The reference's prefill and teacher-forced decode steps (jitted):
    its logits (float64 numpy, stacked) and cache."""
    import jax
    import jax.numpy as jnp

    jl, jc = jax.jit(lambda p, t, e: model.prefill(p, {"tokens": t, "enc_embeds": e,
                                                       "cache_len": CL}))(
        params, jnp.asarray(toks), frames)
    decode = jax.jit(model.decode_step)
    out = [np.asarray(jl, np.float64)]
    for i, tok in enumerate(steps):
        jl, jc = decode(params, jc, {"token": jnp.asarray(tok),
                                     "pos": jnp.asarray(P + i, jnp.int32)})
        out.append(np.asarray(jl, np.float64))
    return np.stack(out), jc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(jax_model, dtype):
    """bfloat16: each step's logits within 0.25 of the reference's. float32:
    whisper-reduced's random init (std 1/sqrt(2) on every weight: the
    reference's fan-in over a two-layer stack) amplifies float32 rounding
    until it moves logits of |x| < 0.7 by one or two bf16 ulps (the
    reference's own float32 logits lie up to 2.0e-3 from its float64 ones,
    the port's up to 2.0e-3, the two float32 runs as far apart). So
    each step is held to the reference run in float64: the port no farther
    from it than the reference's float32 run, plus one bf16 ulp of the
    step's largest logit and 1e-5 (measured at most 9.8e-4 over the
    reference's float32 gap, one bf16 ulp at most 3.9e-3). A wrong slot,
    position or mask moves logits by their scale."""
    import jax
    import jax.numpy as jnp

    model, by_dtype = jax_model
    params = by_dtype[dtype]
    port = _port(params)
    frames, toks, steps = _inputs(seed=2, dtype=dtype)
    want, jc = _jax_run(model, params, _jnp(frames), toks, steps)
    pl, pc = port.prefill({"tokens": torch.from_numpy(toks), "enc_embeds": frames,
                           "cache_len": CL})
    assert pl.shape == (B, 1, 256) and pl.dtype == torch.bfloat16
    got = [pl.float().numpy()]
    for i, tok in enumerate(steps):
        pl, pc = port.decode_step(pc, {"token": torch.from_numpy(tok), "pos": P + i})
        got.append(pl.float().numpy())
    got = np.stack(got)
    if dtype == "bfloat16":
        assert np.abs(got - want).max() <= BF16_TOL, float(np.abs(got - want).max())
    else:
        with jax.enable_x64(True):
            p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
            want64, _ = _jax_run(model, p64, jnp.asarray(frames.numpy(), jnp.float64), toks,
                                 steps)
        for i in range(len(got)):
            own = np.abs(want[i] - want64[i]).max()
            bound = own + _bf16_ulp(np.abs(want64[i]).max()) + 1e-5
            assert np.abs(got[i] - want64[i]).max() <= bound, (i, own)
    # the first layer's caches at the reference's slots: self-attention k, v
    # (of the embeddings alone) written up to P + STEPS, each within
    # rounding; the encoder's ek, ev as the prefill made them, in float32
    # within 2e-5 of their scale (the encoder's float32 noise; measured
    # 4.9e-6; in bf16 the reference's bf16 attention scores move
    # them by whole roundings of the encoder)
    for name in ("k", "v", "ek", "ev"):
        got = pc["dec"][0][name].float().numpy()
        want = np.asarray(jc["dec"][name][0], np.float32)
        assert got.shape == want.shape
        d = np.abs(got - want)
        if name in ("ek", "ev"):
            assert dtype == "bfloat16" or d.max() <= 2e-5 * np.abs(want).max(), (name, d.max())
        elif dtype == "float32":
            assert (d <= 1e-5 + 1e-5 * np.abs(want)).all(), (name, float(d.max()))
        else:
            assert (d <= _bf16_ulp(np.maximum(abs(got), abs(want)))).all(), (name, float(d.max()))
    assert not pc["dec"][0]["k"][:, P + STEPS:].any()


def test_decode_equals_prefill_of_one_more_token():
    """Decode at pos P against the last-token logits of a prefill of P + 1
    tokens, float32 weights: within one bf16 ulp + 1e-5."""
    port = build_model(get_config(ARCH, reduced=True), device="cpu", seed=3).float()
    frames, toks, steps = _inputs(seed=3, dtype="float32")
    _, cache = port.prefill({"tokens": torch.from_numpy(toks), "enc_embeds": frames,
                             "cache_len": CL})
    logits, _ = port.decode_step(cache, {"token": torch.from_numpy(steps[0]), "pos": P})
    ref, _ = port.prefill({"tokens": torch.from_numpy(np.concatenate([toks, steps[0]], 1)),
                           "enc_embeds": frames})
    _logits_within(logits, ref.float().numpy(), "float32")


def test_decode_from_an_empty_cache_matches_prefill():
    """init_cache (its encoder entries filled from a prefill), then one
    decode step per prompt token from pos 0: the last step's logits are the
    prefill's (float32 weights)."""
    port = build_model(get_config(ARCH, reduced=True), device="cpu", seed=4).float()
    frames, toks, _ = _inputs(seed=4, dtype="float32")
    ref, filled = port.prefill({"tokens": torch.from_numpy(toks), "enc_embeds": frames,
                                "cache_len": CL})
    cache = port.init_cache(B, CL, S_ENC)
    assert int(cache["enc_last"]) == S_ENC - 1 and cache["dec"][1]["ek"].shape == (B, S_ENC, 4, 16)
    for got, src in zip(cache["dec"], filled["dec"]):
        got["ek"].copy_(src["ek"])
        got["ev"].copy_(src["ev"])
    for i in range(P):
        logits, cache = port.decode_step(cache, {"token": torch.from_numpy(toks[:, i:i + 1]),
                                                 "pos": i})
    _logits_within(logits, ref.float().numpy(), "float32")


def test_cache_layout_fits_the_decode_kernel():
    """The caches the decode kernel reads as (B, KV, T, hd) views: 16-byte
    aligned bases and strides at full width and reduced, and ``enc_last``
    a 0-d int32 tensor on the model's device."""
    for cfg, s_enc in ((get_config(ARCH), 1500), (get_config(ARCH, reduced=True), S_ENC)):
        hd, kv = cfg.head_dim, cfg.kv_heads
        for T in (132, s_enc):
            t = torch.zeros((2, T, kv, hd), dtype=torch.bfloat16).transpose(1, 2)
            assert t.data_ptr() % 16 == 0
            assert all(st * t.element_size() % 16 == 0 for st in t.stride()[:3]), (T, t.stride())
    port = build_model(get_config(ARCH, reduced=True), device="cpu")
    frames, toks, _ = _inputs(seed=5, dtype="bfloat16")
    _, cache = port.prefill({"tokens": torch.from_numpy(toks), "enc_embeds": frames,
                             "cache_len": CL})
    last = cache["enc_last"]
    assert last.dim() == 0 and last.dtype == torch.int32 and int(last) == S_ENC - 1
    for entry in cache["dec"]:
        for name, T in (("k", CL), ("v", CL), ("ek", S_ENC), ("ev", S_ENC)):
            t = entry[name]
            assert t.shape == (B, T, 4, 16) and t.is_contiguous() and t.dtype == torch.bfloat16
            view = t.transpose(1, 2)
            assert all(st * t.element_size() % 16 == 0 for st in view.stride()[:3])


def test_serving_runs_each_attention_through_its_wrapper():
    """On the CPU the wrappers take their plain versions and launch nothing;
    the calls are counted by kind as on the card: flash per encoder layer
    (non-causal), per decoder layer (causal) and per cross-attention
    (Sq != Sk); decode twice per decoder layer and step."""
    calls = {"flash": [], "decode": []}
    flash, decode = fops.attention, dops.decode

    def f(q, k, v, causal=True, window=None):
        calls["flash"].append((causal, q.shape[2], k.shape[2]))
        return flash(q, k, v, causal=causal, window=window)

    def d(q, k, v, pos, n_splits=None):
        calls["decode"].append(k.shape[2])
        return decode(q, k, v, pos, n_splits)

    from repro_torch.models import layers

    port = build_model(get_config(ARCH, reduced=True), device="cpu")
    frames = serve_lm.frame_embeds(64, B, S_ENC, seed=0)
    f0, d0 = fops.attention.LAUNCHES, dops.decode.LAUNCHES
    layers.flash_ops.attention, layers.decode_ops.decode = f, d
    try:
        res = serve_lm.generate(port, torch.zeros((B, P), dtype=torch.int32), 3,
                                enc_embeds=frames)
    finally:
        layers.flash_ops.attention, layers.decode_ops.decode = flash, decode
    assert (fops.attention.LAUNCHES, dops.decode.LAUNCHES) == (f0, d0)
    assert res["tokens"].shape == (B, 3) and frames.dtype == torch.bfloat16
    assert calls["flash"] == [(False, S_ENC, S_ENC)] * 2 + [(True, P, P), (False, P, S_ENC)] * 2
    assert calls["decode"] == [P + 3, S_ENC] * 2 * 2


def test_param_counts_and_axes_match_reference():
    from repro.configs import build_model as jax_build
    from repro.configs import get_config as jax_config

    counts = {}
    for reduced in (False, True):
        ref = jax_build(jax_config(ARCH, reduced=reduced))
        cfg = get_config(ARCH, reduced=reduced)
        port_axes, ref_axes = whisper_axes(cfg), ref.axes()
        assert set(port_axes) == set(ref_axes)
        for k, v in ref_axes.items():
            if k in ("enc", "dec"):
                n = cfg.enc_layers if k == "enc" else cfg.dec_layers
                strip = {b: {n_: a[1:] for n_, a in leaves.items()} for b, leaves in v.items()
                         if isinstance(leaves, dict)}
                assert port_axes[k] == [strip] * n
            else:
                assert port_axes[k] == v
        counts[reduced] = (count_params(whisper_param_defs(cfg)), whisper_active_params(cfg))
        assert counts[reduced] == (ref.num_params(), ref.num_active_params())
    assert counts[False] == (116_792_832, 83_236_352)
    small = build_model(get_config(ARCH, reduced=True), device="cpu")
    assert sum(p.numel() for p in small.parameters()) == counts[True][0]


def test_loss_raises():
    """whisper trains since its slice (the name is the earlier slice's,
    when the loss raised): ``loss`` over the params tree, not the module,
    runs, finite, with a gradient on every leaf; its values and gradients
    against the reference's: tests/test_torch_train_whisper.py."""
    port = build_model(get_config(ARCH, reduced=True), device="cpu")
    params = port.params()
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    batch = {"tokens": torch.arange(1, 13, dtype=torch.int32).reshape(2, 6),
             "enc_embeds": torch.randn(2, 10, 64, generator=torch.Generator().manual_seed(0))
             .to(torch.bfloat16)}
    per_ex, aux = port.loss(tree_unflatten(params, leaves), batch)
    assert per_ex.shape == (2,) and per_ex.dtype == torch.float32 and aux == {}
    assert torch.isfinite(per_ex).all()
    grads = dict(zip([n for n, _ in named_leaves(params)],
                     torch.autograd.grad(per_ex.sum(), leaves)))
    assert all(torch.isfinite(g).all() for g in grads.values())
    # the key biases' exact gradient is 0 (the softmax cancels q . bk)
    assert all(float(g.float().abs().max()) > 0 for n, g in grads.items()
               if not n.endswith("['bk']"))


def test_serve_lm_main_draws_frames():
    """The CLI draws ``--enc-len`` bf16 frames from ``--seed`` (numpy) and
    serves them; without ``--enc-len`` the prompt length."""
    res = serve_lm.main(["--arch", ARCH, "--device", "cpu", "--reduced", "--batch", "2",
                         "--prompt-len", "4", "--enc-len", "24", "--tokens", "3"])
    assert res["tokens"].shape == (2, 3) and res["prefill_logits"].shape == (2, 1, 256)
    assert res["cache"]["dec"][0]["ek"].shape == (2, 24, 4, 16)
    assert int(res["cache"]["enc_last"]) == 23
    res = serve_lm.main(["--arch", ARCH, "--device", "cpu", "--reduced", "--batch", "1",
                         "--prompt-len", "6", "--tokens", "2"])
    assert res["cache"]["dec"][1]["ev"].shape == (1, 6, 4, 16)
    frames = serve_lm.frame_embeds(64, 2, 5, seed=3)
    assert frames.dtype == torch.bfloat16 and torch.equal(frames,
                                                          serve_lm.frame_embeds(64, 2, 5, seed=3))
