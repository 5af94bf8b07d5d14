"""gemma3 (sliding windows, embedding scale) and zamba2 (Mamba2 and shared
blocks) in the port against the JAX package's models.

At ``reduced=True`` the reference's params are carried into the port
(``load_jax_params``, which takes zamba2's ``g{gi}_shared`` trees), and the
port's ``prefill`` and 8 ``decode_step`` logits are held to the
reference's on the same tokens (numpy seed), on the CPU, with a 20-token
prompt: longer than gemma3-reduced's window of 8 (its rings wrap in the
prefill and again while decoding) and no multiple of zamba2-reduced's chunk
of 16 (the pad path of the chunked scan):

- float32 weights: within one bfloat16 ulp per logit plus 1e-5, as the
  dense family (the logits are bfloat16). Measured max |d| 2.4e-4 (gemma3)
  and 2.0e-3 (zamba2) at logits up to 1.3.
- bfloat16 weights: gemma3 within the dense family's 0.25 (measured
  0.037): the reference rounds attention scores and probabilities to
  bfloat16 where the port keeps float32. zamba2 within twice the
  reference's own bf16 noise on the same inputs (its bf16 logits' distance
  from its float32 ones, the same weights cast up), at least 0.25
  (measured 0.18 against a limit of 0.25): each Mamba2 block amplifies its
  input about 400-fold (|x| 0.1 in, 38 out), so one bf16 rounding of a
  block's products moves the logits by tenths, and on other inputs the
  reference's own bf16 logits lie up to 0.69 from its float32 ones. The
  witness is ``test_zamba2_bf16_gap_is_the_models_own_noise``; ROADMAP.md
  queue 3 carries the bound.

The port's own prefill/decode consistency (the reference's
``tests/test_models_smoke.py`` check, with its tolerances: 1e-2 for
gemma3, 0.5 for zamba2; measured 0 and 0.012), the parameter counts of the
full configs against the reference's (from the declarations, nothing
allocated), the registry, and ``serve_lm`` on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import serve_lm
from repro_torch.configs import ARCH_IDS, build_model, get_config
from repro_torch.kernels.decode_attention import ops as dops
from repro_torch.kernels.flash_attention import ops as fops
from repro_torch.models.convert import load_jax_params, to_torch
from repro_torch.models.param_defs import count_params
from repro_torch.models.transformer import lm_active_params, lm_param_defs
from repro_torch.tree import named_leaves, tree_leaves, tree_unflatten

HYBRID = ("gemma3-1b", "zamba2-1.2b")
B, S, CL, STEPS = 2, 20, 40, 8
BF16_TOL = 0.25
WITNESS = 2.0  # zamba2 in bf16: at most twice the reference's own bf16 noise


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
    """The reference's reduced models and params, bf16 and float32, and its
    jitted prefill and decode."""
    import jax
    import jax.numpy as jnp
    from repro.configs import build_model as jax_build
    from repro.configs import get_config as jax_config

    out = {}
    for arch in HYBRID:
        model = jax_build(jax_config(arch, reduced=True))
        # the reference's init under jit: one compile, not one per leaf (its
        # draws differ from the eager init's by a bf16 rounding)
        params = jax.jit(lambda m=model: m.init(0))()
        out[arch] = (model, {
            "bfloat16": params,
            "float32": jax.tree.map(lambda a: a.astype(jnp.float32), params),
        }, jax.jit(lambda p, t, m=model: m.prefill(p, {"tokens": t, "cache_len": CL})),
            jax.jit(model.decode_step))
    return out


def _np_tree(params):
    import jax

    return jax.tree.map(np.asarray, params)


def _port(arch, params):
    return load_jax_params(build_model(get_config(arch, reduced=True), device="cpu"),
                           _np_tree(params))


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    return 2.0 ** (np.floor(np.log2(np.maximum(x, 2.0**-126))) - 7)


def _f32_within(got: torch.Tensor, want) -> float:
    """float32 weights: one bfloat16 ulp of the larger magnitude, + 1e-5."""
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    d = np.abs(g - w)
    assert (d <= _bf16_ulp(np.maximum(abs(g), abs(w))) + 1e-5).all(), float(d.max())
    return float(d.max())


def _runs(model, params, prefill, decode, port, seed):
    """The reference's and the port's logits (STEPS + 1, B, 1, V) of a
    prefill and STEPS decode steps on the inputs of ``seed``, and their
    caches after the last step."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (B, S), dtype=np.int32)
    jl, jc = prefill(params, jnp.asarray(toks))
    pl, pc = port.prefill({"tokens": torch.from_numpy(toks), "cache_len": CL})
    assert pl.shape == (B, 1, 256) and pl.dtype == torch.bfloat16
    ref, out = [np.asarray(jl, np.float32)], [pl.float().numpy()]
    for i in range(STEPS):
        tok = rng.integers(0, 256, (B, 1), dtype=np.int32)
        jl, jc = decode(params, jc, {"token": jnp.asarray(tok), "pos": jnp.asarray(S + i, jnp.int32)})
        pl, pc = port.decode_step(pc, {"token": torch.from_numpy(tok), "pos": S + i})
        ref.append(np.asarray(jl, np.float32))
        out.append(pl.float().numpy())
    return np.stack(ref), np.stack(out), jc, pc


def _bf16_limit(arch, jax_models, seed) -> float:
    """The bf16 bound of ``arch`` on the inputs of ``seed``: gemma3 the dense
    family's 0.25; zamba2 WITNESS times the reference's own bf16 logits'
    distance from its float32 ones (the same weights cast up), at least
    0.25."""
    if arch != "zamba2-1.2b":
        return BF16_TOL
    model, by_dtype, prefill, decode = jax_models[arch]
    ref16 = _runs(model, by_dtype["bfloat16"], prefill, decode, _Null(), seed)[0]
    ref32 = _runs(model, by_dtype["float32"], prefill, decode, _Null(), seed)[0]
    return max(BF16_TOL, WITNESS * float(np.abs(ref16 - ref32).max()))


class _Null:
    """A stand-in port for ``_runs`` when only the reference's logits count."""

    def prefill(self, batch):
        return torch.zeros((B, 1, 256), dtype=torch.bfloat16), None

    def decode_step(self, cache, batch):
        return self.prefill(batch)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", HYBRID)
def test_prefill_and_decode_match_jax(jax_models, arch, dtype):
    model, by_dtype, prefill, decode = jax_models[arch]
    seed = len(arch)
    ref, out, jc, pc = _runs(model, by_dtype[dtype], prefill, decode,
                             _port(arch, by_dtype[dtype]), seed)
    d = np.abs(out - ref)
    if dtype == "float32":  # one bfloat16 ulp of the larger magnitude, + 1e-5
        assert (d <= _bf16_ulp(np.maximum(abs(out), abs(ref))) + 1e-5).all(), float(d.max())
    else:
        assert d.max() <= _bf16_limit(arch, jax_models, seed), float(d.max())
    # the first block's cache sees only the embeddings: the reference's
    # entries in the same slots (a ring for gemma3's local layer)
    first = {"gemma3-1b": ("k", "v"), "zamba2-1.2b": ("conv", "ssm")}[arch]
    for name in first:
        got = pc["g0"][0]["b0"][name].float().numpy()
        want = np.asarray(jc["g0"]["b0"][name][0], np.float32)
        assert got.shape == want.shape, name
        rel = np.abs(got - want).max() / max(1.0, float(np.abs(want).max()))
        assert rel <= (1e-5 if dtype == "float32" else 2e-2), (name, rel)


def test_zamba2_bf16_gap_is_the_models_own_noise(jax_models):
    """The witness of zamba2's bf16 bound (ROADMAP.md queue 3). On the
    inputs of seeds 2 and 4 the reference's own bf16 logits lie 0.38 and
    0.69 from its float32 ones (the same weights cast up): past the dense
    family's 0.25, so no bound near it holds for this model in bf16. The
    port's bf16 logits lie 0.61 and 0.65 from the reference's, within
    WITNESS times that own gap; in float32 the two stay within 2e-3 on the
    same inputs."""
    model, by_dtype, prefill, decode = jax_models["zamba2-1.2b"]
    own = []
    for seed in (2, 4):
        ref16, port16, _, _ = _runs(model, by_dtype["bfloat16"], prefill, decode,
                                    _port("zamba2-1.2b", by_dtype["bfloat16"]), seed)
        ref32, port32, _, _ = _runs(model, by_dtype["float32"], prefill, decode,
                                    _port("zamba2-1.2b", by_dtype["float32"]), seed)
        gap = float(np.abs(ref16 - ref32).max())
        own.append(gap)
        assert np.abs(port16 - ref16).max() <= max(BF16_TOL, WITNESS * gap)
        assert np.abs(port32 - ref32).max() <= 2e-3
    assert min(own) > BF16_TOL, own


@pytest.mark.parametrize("arch,tol", [("gemma3-1b", 1e-2), ("zamba2-1.2b", 0.5)])
def test_port_prefill_decode_consistency(arch, tol):
    """As tests/test_models_smoke.py:46, with its tolerances: decoding one
    token at pos S equals the last-token logits of a prefill of the S + 1
    tokens (bf16; gemma3's rings wrap at S = 16)."""
    port = build_model(get_config(arch, reduced=True), device="cpu", seed=1)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (B, 16), dtype=np.int32)
    tok = rng.integers(0, 256, (B, 1), dtype=np.int32)
    _, cache = port.prefill({"tokens": torch.from_numpy(toks), "cache_len": 32})
    logits, _ = port.decode_step(cache, {"token": torch.from_numpy(tok), "pos": 16})
    ref, _ = port.prefill({"tokens": torch.from_numpy(np.concatenate([toks, tok], 1))})
    assert torch.isfinite(logits.float()).all()
    assert (logits.float() - ref.float()).abs().max().item() < tol


def test_decode_chain_from_an_empty_cache_matches_prefill():
    """float32 weights: init_cache, then one decode step per token from pos
    0 (gemma3's rings wrap at pos 8, zamba2's shared attention keeps its own
    cache per application): the last step's logits are the prefill's
    (one bf16 ulp + 1e-5)."""
    for arch in HYBRID:
        port = build_model(get_config(arch, reduced=True), device="cpu", seed=4).float()
        toks = np.random.default_rng(4).integers(0, 256, (B, 19), dtype=np.int32)
        cache = port.init_cache(B, 24)
        for i in range(19):
            logits, cache = port.decode_step(cache, {"token": torch.from_numpy(toks[:, i:i + 1]),
                                                     "pos": i})
        ref, _ = port.prefill({"tokens": torch.from_numpy(toks)})
        _f32_within(logits, ref.float().numpy())


def test_cache_layout():
    gemma = build_model(get_config("gemma3-1b", reduced=True), device="cpu")
    cache = gemma.init_cache(2, 40)
    assert cache["g0"][0]["b0"]["k"].shape == (2, 8, 1, 16)  # local: the window's ring
    assert cache["g0"][0]["b4"]["k"].shape == (2, 40, 1, 16)  # global: every position
    zamba = build_model(get_config("zamba2-1.2b", reduced=True), device="cpu")
    cache = zamba.init_cache(2, 40)
    layer = cache["g0"][1]
    assert set(layer) == {"b0", "b1", "s0"}  # each layer's own cache of the shared attention
    assert layer["s0"]["k"].shape == (2, 40, 4, 16)
    assert layer["b0"]["ssm"].dtype == torch.float32 and layer["b0"]["ssm"].shape == (2, 2, 16, 64)
    assert layer["b0"]["conv"].shape == (2, 3, 128 + 32)
    assert set(cache["g1"][0]) == {"b0"}
    # the shared blocks are one module: their weights count once
    assert sum(p.numel() for p in zamba.parameters()) == zamba.num_params()
    assert "g0_shared" in zamba.params() and "g1_shared" not in zamba.params()


def test_load_jax_params_takes_the_shared_trees(jax_models):
    _, by_dtype, _, _ = jax_models["zamba2-1.2b"]
    tree = _np_tree(by_dtype["float32"])
    port = _port("zamba2-1.2b", by_dtype["float32"])
    got = port.g0_shared.b0.attn.wq
    assert torch.equal(got, to_torch(tree["g0_shared"]["b0"]["attn"]["wq"]))
    del tree["g0_shared"]
    with pytest.raises(KeyError):
        load_jax_params(build_model(get_config("zamba2-1.2b", reduced=True), device="cpu"), tree)


@pytest.mark.parametrize("arch,n,active", [("gemma3-1b", 999_826_048, 999_824_896),
                                           ("zamba2-1.2b", 1_104_937_856, 1_440_500_608)])
def test_full_config_param_counts_match_reference(arch, n, active):
    """Counted from the declarations, nothing allocated; zamba2's shared
    blocks count once in the parameters and once per application (6) in
    the active ones, as the reference counts them."""
    from repro.configs import build_model as jax_build

    cfg = get_config(arch)
    ref = jax_build(arch)
    assert count_params(lm_param_defs(cfg)) == n == ref.num_params()
    assert lm_active_params(cfg) == active == ref.num_active_params()


def test_registry_names_both_archs():
    from repro.configs import ARCH_IDS as REF_IDS

    assert set(HYBRID) <= set(ARCH_IDS)
    assert list(ARCH_IDS) == [a for a in REF_IDS if a in ARCH_IDS]  # the reference's order
    g = get_config("gemma3-1b")
    assert (g.d_model, g.vocab, g.n_layers, g.embed_scale, g.subquadratic) == (
        1152, 262144, 52, True, True)
    windows = [b.attn.window for grp in g.groups for b in grp.blocks * grp.repeat
               if b.kind == "attn"]
    assert windows.count(512) == 22 and windows.count(None) == 4
    z = get_config("zamba2-1.2b")
    assert sum(b.kind == "mamba2" for grp in z.groups for b in grp.blocks * grp.repeat) == 38
    assert z.groups[0].repeat == 6 and [b.kind for b in z.groups[0].shared] == ["attn", "mlp"]


def test_logit_softcap_matches_jax(jax_models):
    """``ArchConfig.logit_softcap`` (no ported config sets it) against the
    reference's cap on the same config, gemma3-reduced in float32 with a
    cap of 1.0 (the uncapped logits reach 1.16 and the cap moves them by
    up to 0.34; the capped ones reach 0.83): prefill, 8 decode steps
    across the ring's wrap and the training loss, each within the float32
    bound of the uncapped runs (one bf16 ulp + 1e-5; loss within 1e-5).
    Measured max |d| 2.4e-4 in the logits."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from repro.configs import build_model as jax_build
    from repro.configs import get_config as jax_config

    cap = 1.0
    model = jax_build(dataclasses.replace(jax_config("gemma3-1b", reduced=True),
                                          logit_softcap=cap))
    params = jax_models["gemma3-1b"][1]["float32"]
    port = load_jax_params(
        build_model(dataclasses.replace(get_config("gemma3-1b", reduced=True),
                                        logit_softcap=cap), device="cpu"),
        _np_tree(params))
    prefill = jax.jit(lambda p, t: model.prefill(p, {"tokens": t, "cache_len": CL}))
    ref, out, _, _ = _runs(model, params, prefill, jax.jit(model.decode_step), port, 6)
    d = np.abs(out - ref)
    assert (d <= _bf16_ulp(np.maximum(abs(out), abs(ref))) + 1e-5).all(), float(d.max())
    assert 0.5 < np.abs(out).max() <= cap
    toks = np.random.default_rng(7).integers(0, 256, (2, 24), dtype=np.int32)
    want, _ = jax.jit(model.loss)(params, {"tokens": jnp.asarray(toks)})
    got, _ = port.loss(port.params(), {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_training_mamba2_and_shared_blocks_raises():
    """Mamba2 and shared blocks train since their slice (the name is the
    earlier slice's, when the loss raised): the loss runs, finite, with a
    gradient on every leaf, the shared blocks' among them; its values and
    gradients against the reference's: tests/test_torch_train_zamba2.py."""
    port = build_model(get_config("zamba2-1.2b", reduced=True), device="cpu")
    params = port.params()
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    per_ex, aux = port.loss(tree_unflatten(params, leaves),
                            {"tokens": torch.arange(1, 41, dtype=torch.int32).reshape(2, 20)})
    assert per_ex.shape == (2,) and torch.isfinite(per_ex).all() and float(aux["lb_loss"]) == 0
    grads = dict(zip([n for n, _ in named_leaves(params)],
                     torch.autograd.grad(per_ex.sum(), leaves)))
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert all(float(g.abs().max()) > 0 for n, g in grads.items() if n.startswith("['g0_shared']"))


def test_gemma3_loss_matches_jax(jax_models):
    """gemma3's training forward (windowed plain attention, the embedding
    scale) against the reference's loss, float32 weights: within 1e-5 of
    the loss (measured 4.8e-7)."""
    import jax
    import jax.numpy as jnp

    model, by_dtype, _, _ = jax_models["gemma3-1b"]
    params = by_dtype["float32"]
    port = _port("gemma3-1b", params)
    toks = np.random.default_rng(9).integers(0, 256, (2, 24), dtype=np.int32)
    want, _ = jax.jit(model.loss)(params, {"tokens": jnp.asarray(toks)})
    got, _ = port.loss(port.params(), {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", HYBRID)
def test_serve_lm_main_on_cpu(arch, capsys):
    f0, d0 = fops.attention.LAUNCHES, dops.decode.LAUNCHES
    res = serve_lm.main(["--arch", arch, "--device", "cpu", "--reduced", "--batch", "2",
                         "--prompt-len", "12", "--tokens", "5"])
    assert res["tokens"].shape == (2, 5)
    assert torch.isfinite(res["first_step_logits"].float()).all()
    assert "prefill 2x12" in capsys.readouterr().out
    assert (fops.attention.LAUNCHES, dops.decode.LAUNCHES) == (f0, d0)  # CPU: plain versions
