"""The port's dense LM serving path against the JAX package's model.

For internlm2, phi4-mini and minitron at ``reduced=True``, the reference's
params are carried into the port bit for bit (``load_jax_params``), and the
port's ``prefill`` and ``decode_step`` logits are held to the reference's
``model.prefill``/``decode_step`` on the same tokens (numpy seed), on the
CPU (the attention wrappers take their plain versions):

- float32 weights: within one bfloat16 ulp per logit plus 1e-5 (both sides compute in
  float32; the logits are bfloat16, so a last-bit difference can round
  either way). Measured max |d| 9.8e-4 at logits up to 1.1,
  at most 3.8e-6 over one ulp.
- bfloat16 weights: within 0.25 (measured max |d| 0.213, on one decode
  step of minitron; 0.05 or less on most steps). That is bfloat16 rounding
  noise, not a fault: the port keeps the attention scores and probabilities
  in float32, as the reference's kernels do, while the reference's model
  rounds them to bfloat16, and the random weights (fan-in over the layer
  axis) make the attention nearly one-hot, so a rounding can move a logit
  far. The reference's own bfloat16 logits lie up to 0.25 from its float32
  ones on inputs of these seeds. The float32 case is the tight check.
"""
import collections
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import serve_lm
from repro_torch.configs import ARCH_IDS, build_model, get_config
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.kernels.linear_scan import ops as sops
from repro_torch.models.convert import load_jax_params, to_torch
from repro_torch.models.transformer import TransformerLM
from repro_torch.tree import tree_leaves, tree_unflatten

DENSE = ("minitron-4b", "phi4-mini-3.8b", "internlm2-1.8b")  # rwkv6-7b: test_torch_rwkv.py
B, S, CL, STEPS = 2, 16, 32, 4
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
def jax_models():
    """The reference's reduced models and params, bf16 and float32."""
    import jax
    import jax.numpy as jnp
    from repro.configs import build_model as jax_build
    from repro.configs import get_config as jax_config

    out = {}
    for arch in DENSE:
        model = jax_build(jax_config(arch, reduced=True))
        params = model.init(0)
        out[arch] = (model, {
            "bfloat16": params,
            "float32": jax.tree.map(lambda a: a.astype(jnp.float32), params),
        })
    return out


def _np_tree(params):
    import jax

    return jax.tree.map(np.asarray, params)


def _port(arch, params):
    return load_jax_params(build_model(get_config(arch, reduced=True), device="cpu"),
                           _np_tree(params))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (B, S), dtype=np.int32)
    steps = [rng.integers(0, 256, (B, 1), dtype=np.int32) for _ in range(STEPS)]
    return toks, steps


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    return 2.0 ** (np.floor(np.log2(np.maximum(x, 2.0**-126))) - 7)


def _logits_within(got: torch.Tensor, want, dtype: str) -> float:
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    d = np.abs(g - w)
    if dtype == "float32":  # one bfloat16 ulp of the larger magnitude, + 1e-5
        assert (d <= _bf16_ulp(np.maximum(abs(g), abs(w))) + 1e-5).all(), float(d.max())
    else:
        assert d.max() <= BF16_TOL, float(d.max())
    return float(d.max())


def test_load_jax_params_is_bitwise(jax_models):
    import jax

    model, by_dtype = jax_models["phi4-mini-3.8b"]  # tied embeddings: no lm_head
    for dtype, params in by_dtype.items():
        port = _port("phi4-mini-3.8b", params)
        leaves = jax.tree_util.tree_leaves_with_path(params)
        n_layers = len(port.groups[0])
        assert sum(n_layers if p[0].key == "g0" else 1 for p, _ in leaves) == len(
            list(port.parameters())
        )
        for path, leaf in leaves:
            keys = [p.key for p in path]
            arr = np.asarray(leaf)
            if keys[0] == "g0":
                for li, layer in enumerate(port.groups[0]):
                    t = layer
                    for k in keys[1:]:
                        t = t[k]
                    assert t.dtype == getattr(torch, dtype)
                    assert np.array_equal(
                        t.view(torch.int16 if dtype == "bfloat16" else torch.int32).numpy(),
                        arr[li].view(np.int16 if dtype == "bfloat16" else np.int32),
                    ), (dtype, keys, li)
            else:
                t = getattr(port, keys[0])[keys[1]]
                assert torch.equal(t, to_torch(arr))


def test_load_jax_params_rejects_a_foreign_tree(jax_models):
    _, by_dtype = jax_models["internlm2-1.8b"]
    port = build_model(get_config("phi4-mini-3.8b", reduced=True), device="cpu")
    with pytest.raises(KeyError):
        load_jax_params(port, _np_tree(by_dtype["bfloat16"]))  # has an lm_head


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_jax(jax_models, arch, dtype):
    import jax
    import jax.numpy as jnp

    model, by_dtype = jax_models[arch]
    params = by_dtype[dtype]
    port = _port(arch, params)
    toks, steps = _inputs(seed=len(arch))
    prefill = jax.jit(lambda p, t: model.prefill(p, {"tokens": t, "cache_len": CL}))
    decode = jax.jit(model.decode_step)
    jl, jc = prefill(params, jnp.asarray(toks))
    pl, pc = port.prefill({"tokens": torch.from_numpy(toks), "cache_len": CL})
    assert pl.shape == (B, 1, get_config(arch, reduced=True).vocab) and pl.dtype == torch.bfloat16
    assert pc["g0"][0]["b0"]["k"].shape == (B, CL, 2, 16)
    _logits_within(pl, jl, dtype)
    for i, tok in enumerate(steps):
        jl, jc = decode(params, jc, {"token": jnp.asarray(tok), "pos": jnp.asarray(S + i, jnp.int32)})
        pl, pc = port.decode_step(pc, {"token": torch.from_numpy(tok), "pos": S + i})
        _logits_within(pl, jl, dtype)
    # the first layer's cache, which sees no attention output yet, holds the
    # reference's keys and values at the same slots (later layers carry the
    # logits' float differences)
    for name in ("k", "v"):
        got = pc["g0"][0]["b0"][name].float().numpy()
        want = np.asarray(jc["g0"]["b0"][name][0], np.float32)
        assert got.shape == want.shape and not got[:, S + STEPS:].any()
        d = np.abs(got - want)
        if dtype == "float32":  # measured 7.6e-6 at values up to 15
            assert (d <= 1e-5 + 1e-5 * np.abs(want)).all(), float(d.max())
        else:
            assert (d <= _bf16_ulp(np.maximum(abs(got), abs(want)))).all(), float(d.max())


@pytest.mark.parametrize("arch", DENSE)
def test_port_prefill_decode_consistency(arch):
    """As tests/test_models_smoke.py:46: decoding one token at pos S equals
    the last-token logits of a prefill of the S+1 tokens (measured max |d|
    below 4e-3 in bfloat16)."""
    port = build_model(get_config(arch, reduced=True), device="cpu", seed=1)
    toks, steps = _inputs(seed=0)
    _, cache = port.prefill({"tokens": torch.from_numpy(toks), "cache_len": CL})
    logits, _ = port.decode_step(cache, {"token": torch.from_numpy(steps[0]), "pos": S})
    ref, _ = port.prefill({"tokens": torch.from_numpy(np.concatenate([toks, steps[0]], 1))})
    assert torch.isfinite(logits.float()).all()
    assert (logits.float() - ref.float()).abs().max().item() < 1e-2


def test_decode_from_an_empty_cache_matches_prefill():
    """init_cache, then one decode step per token from pos 0: the last
    step's logits are the prefill's (float32 weights: one bf16 ulp + 1e-5)."""
    port = build_model(get_config("phi4-mini-3.8b", reduced=True), device="cpu", seed=4).float()
    toks, _ = _inputs(seed=4)
    cache = port.init_cache(B, CL)
    assert cache["g0"][1]["b0"]["k"].dtype == torch.float32
    for i in range(S):
        logits, cache = port.decode_step(cache, {"token": torch.from_numpy(toks[:, i:i + 1]),
                                                 "pos": i})
    ref, _ = port.prefill({"tokens": torch.from_numpy(toks)})
    _logits_within(logits, ref.float().numpy(), "float32")


def test_decode_writes_the_cache_in_place():
    port = build_model(get_config("internlm2-1.8b", reduced=True), device="cpu")
    toks, steps = _inputs(seed=2)
    _, cache = port.prefill({"tokens": torch.from_numpy(toks), "cache_len": CL})
    k = cache["g0"][1]["b0"]["k"]
    before = k.clone()
    _, cache2 = port.decode_step(cache, {"token": torch.from_numpy(steps[0]), "pos": S})
    assert cache2 is cache and cache2["g0"][1]["b0"]["k"] is k
    changed = (k != before).any(dim=(0, 2, 3))
    assert changed.nonzero().flatten().tolist() == [S]


def test_unported_parts_raise():
    """What later slices port raises: block kinds the port does not run.
    Sliding windows and Mamba2 serve since their slice
    (tests/test_torch_sliding.py, test_torch_hybrid_lm.py): a windowed
    layer's cache is its ring; M-RoPE and whisper since theirs
    (tests/test_torch_mrope.py, test_torch_whisper.py). Mamba2 and shared
    blocks, and whisper, train since theirs (tests/test_torch_train_*.py):
    each loss runs, finite, with a gradient on every leaf."""
    cfg = get_config("internlm2-1.8b", reduced=True)
    blocks = cfg.groups[0].blocks
    windowed = dataclasses.replace(blocks[0], attn=dataclasses.replace(blocks[0].attn, window=8))
    cfg_w = dataclasses.replace(cfg, groups=(dataclasses.replace(cfg.groups[0],
                                                                 blocks=(windowed, blocks[1])),))
    port = build_model(cfg_w, device="cpu")
    _, cache = port.prefill({"tokens": torch.zeros((1, 12), dtype=torch.int32), "cache_len": 16})
    assert cache["g0"][0]["b0"]["k"].shape[1] == 8
    cross = dataclasses.replace(blocks[1], kind="cross_attn")
    with pytest.raises(NotImplementedError, match="later slice"):
        build_model(dataclasses.replace(cfg, groups=(dataclasses.replace(
            cfg.groups[0], blocks=(blocks[0], cross)),)), device="cpu")
    tokens = torch.arange(1, 9, dtype=torch.int32)[None]
    for arch, extra in (("zamba2-1.2b", {}),
                        ("whisper-base", {"enc_embeds": torch.randn(1, 8, 64).bfloat16()})):
        model = build_model(get_config(arch, reduced=True), device="cpu")
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(model.params())]
        per_ex, _ = model.loss(tree_unflatten(model.params(), leaves), {"tokens": tokens, **extra})
        assert per_ex.shape == (1,) and torch.isfinite(per_ex).all(), arch
        grads = torch.autograd.grad(per_ex.sum(), leaves, allow_unused=True)
        assert all(g is not None and torch.isfinite(g).all() for g in grads), arch


def test_param_count_of_the_serve_config():
    """internlm2-1.8b at full width, counted from the declaration (no
    allocation); the reference's shape tree gives the same count."""
    from repro.configs import build_model as jax_build

    from repro_torch.models.param_defs import count_params
    from repro_torch.models.transformer import lm_param_defs

    n = count_params(lm_param_defs(get_config("internlm2-1.8b")))
    assert n == 1_889_110_016 == jax_build("internlm2-1.8b").num_params()


def test_serve_lm_main_on_cpu(capsys):
    f0, d0 = fops.attention.LAUNCHES, dops.decode.LAUNCHES
    res = serve_lm.main(["--device", "cpu", "--reduced", "--batch", "2",
                         "--prompt-len", "12", "--tokens", "5"])
    assert res["tokens"].shape == (2, 5) and res["tokens"].dtype == torch.int32
    assert torch.isfinite(res["first_step_logits"].float()).all()
    out = capsys.readouterr().out
    assert "prefill 2x12" in out and "decode 4 steps" in out
    assert (fops.attention.LAUNCHES, dops.decode.LAUNCHES) == (f0, d0)  # CPU: plain versions


def test_greedy_tokens_follow_the_logits():
    """generate's first token is the prefill's argmax, its second the first
    decode step's argmax."""
    model = build_model(get_config("minitron-4b", reduced=True), device="cpu", seed=3)
    prompt = serve_lm.prompt_tokens(256, 2, 10, seed=3)
    res = serve_lm.generate(model, prompt, 3)
    assert torch.equal(res["tokens"][:, 0], res["prefill_logits"][:, -1].argmax(-1).int())
    assert torch.equal(res["tokens"][:, 1], res["first_step_logits"][:, -1].argmax(-1).int())


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_config("internlm2-1.8b", reduced=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TransformerLM(get_config("internlm2-1.8b", reduced=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lm.main(["--reduced", "--tokens", "2"])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", DENSE)
def test_cuda_serving_matches_cpu(arch):
    """The port on the card (kernels) against the port on the CPU (plain
    versions), float32 weights: within one bfloat16 ulp per logit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on a GPU host)")
    import copy

    cpu = build_model(get_config(arch, reduced=True), device="cpu", seed=5).float()
    gpu = copy.deepcopy(cpu).to("cuda")
    toks, steps = _inputs(seed=5)
    f0, d0 = fops.attention.LAUNCHES, dops.decode.LAUNCHES
    outs = []
    for m in (cpu, gpu):
        logits, cache = m.prefill({"tokens": torch.from_numpy(toks), "cache_len": CL})
        seq = [logits.cpu()]
        for i, tok in enumerate(steps):
            logits, cache = m.decode_step(cache, {"token": torch.from_numpy(tok), "pos": S + i})
            seq.append(logits.cpu())
        outs.append(seq)
    assert fops.attention.LAUNCHES - f0 == 2 and dops.decode.LAUNCHES - d0 == 2 * STEPS
    for c, g in zip(*outs):
        _logits_within(g, c.float().numpy(), "float32")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_kernel_launches_count_the_wrapper_calls(arch, monkeypatch):
    """``kernel_launches``, which the card's launch counts are held to,
    counts the attention and scan wrapper calls of a prefill and of each
    decode step (on the CPU each wrapper is called where it launches on the
    card, and takes its plain version)."""
    calls = collections.Counter()

    def counted(name, fn):
        def call(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return call

    for mod, name, key in ((fops, "attention", "flash_attention"),
                           (dops, "decode", "decode_attention"),
                           (sops, "rwkv6_scan", "rwkv6_scan")):
        monkeypatch.setattr(mod, name, counted(key, getattr(mod, name)))
    model = build_model(get_config(arch, reduced=True), device="cpu")
    cfg = model.cfg
    extra = serve_lm.request_inputs(cfg, 1, 6, seed=0, image=(1, (2, 2)))
    serve_lm.generate(model, serve_lm.prompt_tokens(cfg.vocab, 1, 6, seed=0), 3, **extra)
    want = model.kernel_launches()
    expected = collections.Counter(want["prefill"])
    expected.update({k: 2 * n for k, n in want["decode_step"].items()})
    assert +calls == +expected
