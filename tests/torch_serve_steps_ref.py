"""The comparison of the port's built prefill and decode steps with the
reference's, for ``tests/test_torch_serve_steps*.py`` (two files, each
under 30 s alone on the CPU).

For one arch at its reduced width, the same weights (the port's draw,
carried into the reference's stacked layout) and the same inputs (numpy
seed) go through the reference's ``build_prefill_step`` /
``build_decode_step`` (jitted, on an Auto-axis (1, 1) mesh) and the port's
(on the CPU smoke mesh): the prefill's last-token logits, four
teacher-forced decode steps from each side's own cache, and four from the
reference's cache carried across by ``load_jax_cache`` (bit for bit).
Tolerances are PERF.md's: float32 one bfloat16 ulp + 1e-5; bfloat16 0.25,
rwkv6 0.1, zamba2 twice the reference's own bf16-vs-float32 gap (at least
0.25). whisper's and zamba2's float32 logits are held to the reference run
in float64: no farther from it than the reference's own float32 run, plus
one bf16 ulp of the step's largest logit and 1e-5 (whisper's rule in
PERF.md). zamba2-reduced's Mamba2 blocks amplify float32 rounding as
whisper-reduced's init does: on seed 11's inputs the reference's float32
logits lie 9.8e-4 from its float64 ones and the port's 2.0e-3, and a logit
of -5.3e-4 lies 3.1e-5 from the reference's float32 one, past one bf16 ulp
+ 1e-5 (ROADMAP.md queue 3). The MoE archs run in float32 only: in bf16
two computations can route a token differently (ROADMAP.md queue 3). Both
sides' steps run under their mesh context, so MoE layers take the mesh
path on both. JAX is imported inside the functions.
"""
import numpy as np
import torch

from repro_torch import serve_lm
from repro_torch.configs import build_model, get_config
from repro_torch.configs.registry import ShapeSpec
from repro_torch.launch import steps as psteps
from repro_torch.models.convert import load_jax_cache, to_torch
from repro_torch.tree import named_leaves

B, S, STEPS = 2, 8, 4
CL = S + STEPS
F32_FLOOR = 1e-5
BF16_TOL = {"rwkv6-7b": 0.1}  # 0.25 otherwise
BF16_DEFAULT = 0.25
WITNESS = 2.0  # zamba2 in bf16: twice the reference's own bf16-vs-float32 gap
MOE = ("granite-moe-3b-a800m", "deepseek-v2-lite-16b")
# float32 held to the reference run in float64 (their reduced inits amplify
# float32 rounding past one bf16 ulp between any two float32 runs)
F64_WITNESSED = ("whisper-base", "zamba2-1.2b")
IMAGE = (2, (2, 2))  # qwen2-vl: text tokens before the image, its patch grid


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    return 2.0 ** (np.floor(np.log2(np.maximum(x, 2.0**-126))) - 7)


def _np_leaf(t: torch.Tensor) -> np.ndarray:
    import jax.numpy as jnp

    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(jnp.bfloat16)
    return t.numpy()


def _ref_params(tree):
    """The port's parameter tree (per-layer lists) as the reference's:
    numpy leaves, each list stacked on a leading axis."""
    if isinstance(tree, list):
        layers = [_ref_params(t) for t in tree]
        return _stack_np(layers)
    if isinstance(tree, dict):
        return {k: _ref_params(v) for k, v in tree.items()}
    return _np_leaf(tree.detach())


def _stack_np(layers):
    if isinstance(layers[0], dict):
        return {k: _stack_np([t[k] for t in layers]) for k in layers[0]}
    return np.stack(layers)


def inputs(cfg, seed, dtype):
    """Tokens (B, S), the decode steps' tokens, and the arch's other
    inputs: whisper's frames (B, S, d) in ``dtype``, qwen2-vl's positions3
    with an image."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)
    steps = [rng.integers(0, cfg.vocab, (B, 1), dtype=np.int32) for _ in range(STEPS)]
    extra = {}
    if getattr(cfg, "mrope", False):
        extra["positions3"] = serve_lm.image_positions3(B, S, *IMAGE)
    if hasattr(cfg, "enc_layers"):
        frames = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        extra["enc_embeds"] = torch.from_numpy(frames).to(getattr(torch, dtype))
    return toks, steps, extra


def _jnp(t: torch.Tensor, dtype=None):
    import jax.numpy as jnp

    if t.dtype in (torch.int32, torch.int64):
        return jnp.asarray(t.numpy())
    return jnp.asarray(t.float().numpy(), dtype or {torch.float32: jnp.float32,
                                                    torch.bfloat16: jnp.bfloat16}[t.dtype])


def _ref_run(jmodel, params, toks, steps, extra, f64=False):
    """The reference's built prefill and decode steps (jitted) on an
    Auto-axis (1, 1) mesh: logits (1 + STEPS, B, 1, V) float64 numpy, the
    decode steps' logits from the prefill's cache, and that cache (numpy)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType
    from repro.configs.registry import ShapeSpec as JShape
    from repro.launch import steps as jsteps

    mesh = jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto, AxisType.Auto))
    pre = jsteps.build_prefill_step(jmodel, mesh, JShape("p", S, B, "prefill"))
    dec = jsteps.build_decode_step(jmodel, mesh, JShape("d", CL, B, "decode"))
    batch = {"tokens": jnp.asarray(toks)}
    for k, v in extra.items():
        batch[k] = _jnp(v, jnp.float64 if f64 else None)
    logits, cache = jax.jit(lambda p, b: pre.fn(p, dict(b, cache_len=CL)))(params, batch)
    cache0 = jax.tree.map(np.asarray, cache)
    decode = jax.jit(dec.fn)
    out = [np.asarray(logits, np.float64)]
    for i, tok in enumerate(steps):
        logits, cache = decode(params, cache, {"token": jnp.asarray(tok),
                                               "pos": jnp.asarray(S + i, jnp.int32)})
        out.append(np.asarray(logits, np.float64))
    return np.stack(out), cache0


def _port_run(pre, dec, toks, steps, extra, cache=None):
    """The port's built steps: a prefill (or, given ``cache``, none) and
    the decode steps from its cache; logits (1 + STEPS, B, 1, V) float64
    (the first row zero without a prefill) and the prefill's cache."""
    if cache is None:
        logits, cache = pre.fn({"tokens": torch.from_numpy(toks), "cache_len": CL, **extra})
        first = logits.double().numpy()
    else:
        first = None
    out = [first]
    for i, tok in enumerate(steps):
        logits, cache = dec.fn(cache, {"token": torch.from_numpy(tok), "pos": S + i})
        out.append(logits.double().numpy())
    out[0] = np.zeros_like(out[1]) if first is None else first
    return np.stack(out), cache


def _within_f32(got, want) -> bool:
    d = np.abs(got - want)
    return bool((d <= bf16_ulp(np.maximum(abs(got), abs(want))) + F32_FLOOR).all())


def check_built_steps(arch: str, pmesh) -> None:
    """The module docstring's comparison for ``arch`` (the port's steps on
    ``pmesh``): prefill, four decode steps from each side's own cache, and
    four from the reference's cache (``load_jax_cache``: bit for bit), in
    float32 and (but the MoE archs) bfloat16 weights."""
    import jax
    import jax.numpy as jnp
    from repro.configs import build_model as jax_build
    from repro.configs import get_config as jax_config

    cfg = get_config(arch, reduced=True)
    jmodel = jax_build(jax_config(arch, reduced=True))
    model = build_model(cfg, device="cpu", seed=len(arch))
    params16 = _ref_params(model.params())
    ref32 = None
    for dtype in ("float32",) if arch in MOE else ("float32", "bfloat16"):
        if dtype == "float32":
            model = model.float()
        else:
            model = build_model(cfg, device="cpu", seed=len(arch))
        params = jax.tree.map(lambda a: jnp.asarray(a, getattr(jnp, dtype)), params16)
        toks, steps, extra = inputs(cfg, len(arch), dtype)
        want, jcache = _ref_run(jmodel, params, toks, steps, extra)
        ref32 = want if dtype == "float32" else ref32
        pre = psteps.build_prefill_step(model, pmesh, ShapeSpec("p", S, B, "prefill"))
        dec = psteps.build_decode_step(model, pmesh, ShapeSpec("d", CL, B, "decode"), graph=True)
        got, _ = _port_run(pre, dec, toks, steps, extra)
        loaded = load_jax_cache(model, jcache)
        for name, leaf in named_leaves(loaded):
            if name == "['enc_last']":
                assert int(leaf) == S - 1
                continue
            keys = [k.strip("'") for k in name[1:-1].split("][")]
            ref = jcache[keys[0]]
            for k in keys[2:]:
                ref = ref[k]
            assert torch.equal(leaf, to_torch(np.asarray(ref)[int(keys[1])])), name
        from_ref, _ = _port_run(pre, dec, toks, steps, extra, cache=loaded)
        from_ref[0] = got[0]
        assert dec.decode_graph is not None and dec.decode_graph.cache is loaded
        if dtype == "float32" and arch in F64_WITNESSED:
            with jax.enable_x64(True):
                p64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params16)
                want64, _ = _ref_run(jmodel, p64, toks, steps, extra, f64=True)
            for run in (got, from_ref):
                for i in range(len(run)):
                    own = np.abs(want[i] - want64[i]).max()
                    bound = own + bf16_ulp(np.abs(want64[i]).max()) + F32_FLOOR
                    assert np.abs(run[i] - want64[i]).max() <= bound, (i, own)
        elif dtype == "float32":
            assert _within_f32(got, want), float(np.abs(got - want).max())
            assert _within_f32(from_ref, want), float(np.abs(from_ref - want).max())
        else:
            limit = BF16_TOL.get(arch, BF16_DEFAULT)
            if arch == "zamba2-1.2b":
                limit = max(limit, WITNESS * float(np.abs(want - ref32).max()))
            assert np.abs(got - want).max() <= limit, float(np.abs(got - want).max())
            assert np.abs(from_ref - want).max() <= limit, float(np.abs(from_ref - want).max())


