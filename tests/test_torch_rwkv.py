"""The port's rwkv6-7b serving path against the JAX package's model.

At ``reduced=True`` (2 layers of time mix + channel mix, d_model 64, one
head of 64, chunks of 8), the reference's params are carried into the port
bit for bit (``load_jax_params``). The reference's init sets every ``mu_*``
to 1 and ``u`` and ``w0`` to 0, which would leave the token-shift mix and
the bonus term unexercised, so before loading those leaves are overwritten
with values from a numpy seed: mu in [0, 1), u ~ N(0, 0.25), w0 in [-3, 2).
The port's ``prefill`` and ``decode_step`` logits are held to the
reference's on the same tokens, on the CPU (the scan wrapper takes the plain
chunked version, the reference model's own arithmetic):

- float32 weights: within one bfloat16 ulp per logit plus 1e-5 (both sides
  compute in float32, the logits are bfloat16). Measured max |d| 3.9e-3,
  one ulp at logits of 1-1.5, never more than one ulp.
- bfloat16 weights: within 0.1 (measured max |d| 0.023; 0.037 on other
  tokens). The two frameworks round the bf16 activations at other places,
  and the RWKV6 state, float32 but fed by bf16 projections, carries those
  differences along the sequence: the second layer's states differ by 1.9%
  of their scale.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import serve_lm
from repro_torch.configs import build_model, get_config
from repro_torch.kernels.linear_scan import ops as scan_ops
from repro_torch.models import ssm
from repro_torch.models.convert import load_jax_params, to_torch

ARCH = "rwkv6-7b"
B, S, STEPS = 2, 21, 4  # S is no multiple of the reduced config's chunk of 8
BF16_TOL = 0.1


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


def _randomize(tree, rng):
    """The numpy tree with its mu_*, u and w0 leaves redrawn (same dtype)."""
    out = {}
    for name, a in tree.items():
        if isinstance(a, dict):
            out[name] = _randomize(a, rng)
            continue
        if name.startswith("mu_"):
            new = rng.uniform(0.0, 1.0, a.shape)
        elif name == "u":
            new = rng.standard_normal(a.shape) * 0.5
        elif name == "w0":
            new = rng.uniform(-3.0, 2.0, a.shape)
        else:
            out[name] = a
            continue
        out[name] = new.astype(np.float32).astype(a.dtype)
    return out


@pytest.fixture(scope="module")
def jax_rwkv():
    """The reference's reduced model and its params as numpy trees, float32
    and bf16, with mu, u and w0 randomised."""
    import jax
    import jax.numpy as jnp
    from repro.configs import build_model as jax_build
    from repro.configs import get_config as jax_config

    model = jax_build(jax_config(ARCH, reduced=True))
    params = model.init(0)
    trees = {}
    for dtype in ("float32", "bfloat16"):
        tree = jax.tree.map(lambda a: np.asarray(a.astype(getattr(jnp, dtype))), params)
        trees[dtype] = _randomize(tree, np.random.default_rng(7))
    return model, trees


def _port(tree):
    return load_jax_params(build_model(get_config(ARCH, reduced=True), device="cpu"), tree)


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


def _leaves(tree, path=()):
    for name, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (name,))
        else:
            yield path + (name,), v


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def test_load_jax_params_is_bitwise(jax_rwkv):
    _, trees = jax_rwkv
    for dtype, tree in trees.items():
        port = _port(tree)
        n = 0
        for path, arr in _leaves(tree):
            layers = list(port.groups[0]) if path[0] == "g0" else [port]
            for li, t in enumerate(layers):
                for name in path[1:] if path[0] == "g0" else path:
                    t = getattr(t, name)
                want = to_torch(arr[li] if path[0] == "g0" else arr)
                assert t.dtype == getattr(torch, dtype) and torch.equal(_bits(t), _bits(want)), path
                n += 1
        assert n == len(list(port.parameters()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(jax_rwkv, dtype):
    import jax
    import jax.numpy as jnp

    model, trees = jax_rwkv
    params = jax.tree.map(jnp.asarray, trees[dtype])
    port = _port(trees[dtype])
    toks, steps = _inputs(seed=3)
    jl, jc = jax.jit(lambda p, t: model.prefill(p, {"tokens": t}))(params, jnp.asarray(toks))
    pl, pc = port.prefill({"tokens": torch.from_numpy(toks)})
    assert pl.shape == (B, 1, 256) and pl.dtype == torch.bfloat16
    assert pc["g0"][0]["b0"]["state"].shape == (B, 1, 64, 64)
    assert pc["g0"][0]["b0"]["state"].dtype == torch.float32
    _logits_within(pl, jl, dtype)
    decode = jax.jit(model.decode_step)
    for i, tok in enumerate(steps):
        jl, jc = decode(params, jc, {"token": jnp.asarray(tok),
                                     "pos": jnp.asarray(S + i, jnp.int32)})
        pl, pc = port.decode_step(pc, {"token": torch.from_numpy(tok), "pos": S + i})
        _logits_within(pl, jl, dtype)
    # the first time mix sees the embeddings alone: its token shift is the
    # reference's bit for bit, its state within float32 noise
    want = to_torch(np.asarray(jc["g0"]["b0"]["x_prev"][0]))
    assert torch.equal(_bits(pc["g0"][0]["b0"]["x_prev"]), _bits(want))
    got = pc["g0"][0]["b0"]["state"].numpy()
    want = np.asarray(jc["g0"]["b0"]["state"][0])
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()  # measured 2.4e-7


def _block_inputs(seed, T=13, D=64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    x_prev = rng.standard_normal((B, 1, D)).astype(np.float32)
    s0 = rng.standard_normal((B, 1, D, D)).astype(np.float32)
    return x, x_prev, s0


def test_time_and_channel_mix_match_jax(jax_rwkv):
    """The blocks with an initial state and a previous token (which the
    model's prefill never passes), float32: the bonus, the mix and ``wo``
    applied as the reference applies them (measured 4.2e-7 of the scale)."""
    import jax.numpy as jnp
    from repro.models import ssm as jssm

    _, trees = jax_rwkv
    block = trees["float32"]["g0"]
    port = _port(trees["float32"]).groups[0][1]  # layer 1's weights
    jp = {k: {n: jnp.asarray(np.asarray(a)[1]) if not isinstance(a, dict)
              else {"scale": jnp.asarray(np.asarray(a["scale"])[1])}
              for n, a in v.items()} for k, v in
          (("rwkv", block["b0"]["rwkv"]), ("rwkv_ffn", block["b1"]["rwkv_ffn"]))}
    spec = get_config(ARCH, reduced=True).groups[0].blocks[0].rwkv
    jspec = jssm.RWKV6Spec(d_model=64, chunk=spec.chunk)
    x, x_prev, s0 = _block_inputs(seed=11)
    tx, txp, ts0 = (torch.from_numpy(a) for a in (x, x_prev, s0))

    def rel(got, want):
        w = np.asarray(want, np.float32)
        return float(np.abs(got.numpy() - w).max() / np.abs(w).max())

    jy, js, jl = jssm.apply_rwkv6_time(jp["rwkv"], jspec, jnp.asarray(x), jnp.asarray(s0),
                                       jnp.asarray(x_prev))
    py, ps, pl = ssm.apply_rwkv6_time(port["b0"]["rwkv"], spec, tx, ts0, txp)
    assert max(rel(py, jy), rel(ps, js)) <= 1e-5 and torch.equal(pl, tx[:, -1:])
    jy, js, _ = jssm.decode_rwkv6_time(jp["rwkv"], jspec, jnp.asarray(x[:, :1]),
                                       jnp.asarray(s0), jnp.asarray(x_prev))
    state = ts0.clone()
    py, ps, _ = ssm.decode_rwkv6_time(port["b0"]["rwkv"], spec, tx[:, :1], state, txp)
    assert ps is state and max(rel(py, jy), rel(ps, js)) <= 1e-5
    jy, _ = jssm.apply_rwkv6_channel(jp["rwkv_ffn"], jnp.asarray(x), jnp.asarray(x_prev))
    py, _ = ssm.apply_rwkv6_channel(port["b1"]["rwkv_ffn"], tx, txp)
    assert rel(py, jy) <= 1e-5


def test_time_mix_output_is_the_reference_einsum():
    """``einsum("btd,de->btd", y, wo)`` sums wo over e: y * wo.sum(-1), not
    y @ wo (ROADMAP.md queue 3)."""
    y = torch.randn(2, 3, 8, dtype=torch.float64)
    wo = torch.randn(8, 8, dtype=torch.float64)
    p = {"ln_out": {"scale": torch.zeros(8, dtype=torch.float64)}, "wo": wo}
    got = ssm._time_out(p, y)  # the gated output (a gate of ones)
    normed = y * torch.rsqrt(y.square().mean(-1, keepdim=True) + 1e-6)
    assert torch.allclose(got, normed * wo.sum(-1))
    assert not torch.allclose(got, normed @ wo)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_matches_a_prefill_one_token_longer(dtype):
    """As tests/test_models_smoke.py: decoding the token at pos S equals the
    last-token logits of a prefill of the S + 1 tokens, within one bf16 ulp
    + 1e-5 (the step and the chunked scan sum in other orders; measured max
    |d| 0.0 in both dtypes)."""
    port = build_model(get_config(ARCH, reduced=True), device="cpu", seed=1).to(dtype)
    toks, steps = _inputs(seed=0)
    _, cache = port.prefill({"tokens": torch.from_numpy(toks)})
    logits, _ = port.decode_step(cache, {"token": torch.from_numpy(steps[0]), "pos": S})
    ref, _ = port.prefill({"tokens": torch.from_numpy(np.concatenate([toks, steps[0]], 1))})
    assert torch.isfinite(logits.float()).all()
    _logits_within(logits, ref.float().numpy(), "float32")


def test_decode_from_an_empty_cache_matches_prefill():
    """init_cache, then one decode step per token: the last step's logits
    are the prefill's (float32 weights: one bf16 ulp + 1e-5)."""
    port = build_model(get_config(ARCH, reduced=True), device="cpu", seed=4).float()
    toks, _ = _inputs(seed=4)
    cache = port.init_cache(B, S)
    entry = cache["g0"][1]
    assert entry["b0"]["state"].dtype == torch.float32 and entry["b1"]["x_prev"].shape == (B, 1, 64)
    for i in range(S):
        logits, cache = port.decode_step(cache, {"token": torch.from_numpy(toks[:, i:i + 1]),
                                                 "pos": i})
    ref, _ = port.prefill({"tokens": torch.from_numpy(toks)})
    _logits_within(logits, ref.float().numpy(), "float32")


def test_decode_updates_the_cache_in_place():
    port = build_model(get_config(ARCH, reduced=True), device="cpu")
    toks, steps = _inputs(seed=2)
    _, cache = port.prefill({"tokens": torch.from_numpy(toks)})
    entry = cache["g0"][1]
    state, x_prev = entry["b0"]["state"], entry["b1"]["x_prev"]
    before = state.clone(), x_prev.clone()
    _, cache2 = port.decode_step(cache, {"token": torch.from_numpy(steps[0]), "pos": S})
    assert cache2 is cache and cache2["g0"][1]["b0"]["state"] is state
    assert cache2["g0"][1]["b1"]["x_prev"] is x_prev
    assert not torch.equal(state, before[0]) and not torch.equal(x_prev, before[1])
    assert x_prev._base is None  # the prefill's x_prev is a copy, not a view of an activation


def test_param_count_of_rwkv6_7b():
    """rwkv6-7b at full width, counted from the declaration (no
    allocation); the reference's shape tree gives the same count."""
    from repro.configs import build_model as jax_build

    from repro_torch.models.param_defs import count_params
    from repro_torch.models.transformer import lm_param_defs

    n = count_params(lm_param_defs(get_config(ARCH)))
    assert n == 7_534_546_944 == jax_build(ARCH).num_params()
    assert get_config(ARCH).subquadratic


def test_serve_lm_main_on_cpu(capsys):
    n = scan_ops.rwkv6_scan.LAUNCHES
    res = serve_lm.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
                         "--prompt-len", "12", "--tokens", "5"])
    assert res["tokens"].shape == (2, 5) and res["tokens"].dtype == torch.int32
    assert torch.isfinite(res["first_step_logits"].float()).all()
    assert torch.equal(res["tokens"][:, 1], res["first_step_logits"][:, -1].argmax(-1).int())
    out = capsys.readouterr().out
    assert "rwkv6-reduced on cpu" in out and "decode 4 steps" in out
    assert scan_ops.rwkv6_scan.LAUNCHES == n  # CPU: the plain version


@pytest.mark.cuda
def test_cuda_serving_matches_cpu():
    """The port on the card (scan kernel) against the port on the CPU
    (plain chunked scan), float32 weights: within one bfloat16 ulp + 1e-5
    per logit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on a GPU host)")
    import copy

    cpu = build_model(get_config(ARCH, reduced=True), device="cpu", seed=5).float()
    gpu = copy.deepcopy(cpu).to("cuda")
    toks, steps = _inputs(seed=5)
    n = scan_ops.rwkv6_scan.LAUNCHES
    outs = []
    for m in (cpu, gpu):
        logits, cache = m.prefill({"tokens": torch.from_numpy(toks)})
        seq = [logits.cpu()]
        for i, tok in enumerate(steps):
            logits, cache = m.decode_step(cache, {"token": torch.from_numpy(tok), "pos": S + i})
            seq.append(logits.cpu())
        outs.append(seq)
    assert scan_ops.rwkv6_scan.LAUNCHES - n == 2  # one per time-mix layer, prefill only
    for c, g in zip(*outs):
        _logits_within(g, c.float().numpy(), "float32")
