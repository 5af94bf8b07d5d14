"""The long_500k path of the port on the CPU: decode at positions past the
100,000-slot threshold that switches the step builders to the
long-context rules, and RoPE at positions up to 524,287.

- gemma3, zamba2 and rwkv6 at their reduced widths, batch 1, caches of
  131,072 slots seeded with numpy (keys and values of std 1, the Mamba2
  and RWKV6 states and histories at the scale of a prefill's), decode
  positions 131,064-131,071: the port's ``decode_step`` against the
  reference's (jitted) on the same weights (the port's draw carried
  across) and the same caches, in float32: one bfloat16 ulp of the larger
  logit + 1e-5; zamba2 by the float64 rule (ROADMAP.md queue 3: its Mamba2
  blocks amplify float32 rounding), no farther from the reference run in
  float64 than the reference's own float32 run, plus one bfloat16 ulp and
  1e-5. gemma3-reduced's windowed layers read 8-slot rings at pos mod 8,
  its global layers the whole cache at the absolute pos.
- The same steps through ``build_decode_step`` on the CPU smoke mesh at a
  decode shape of 131,072 slots: the long-context rules (``kv_seq`` over
  ("data", "model")), bit for bit the unbuilt step, logits and caches.
- ``apply_rope`` at positions 0-524,287 against the reference's: the
  float32 angles are the same bits (numpy's inverse frequencies, one
  float32 product); torch's and XLA's CPU cos and sin then differ by at
  most one float32 ulp of the result (5.96e-8) at every position
  measured, at 524,287 as at 4,096, so the rotated values stay within one
  float32 ulp of |x| (ROPE_GAP below holds twice that).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import build_model, get_config
from repro_torch.configs.registry import ShapeSpec
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.steps import build_decode_step
from repro_torch.models import layers
from repro_torch.models.convert import load_jax_cache
from repro_torch.tree import named_leaves
from torch_serve_steps_ref import _ref_params, bf16_ulp

T = 131_072                    # cache slots: past the 100,000 of the long-context rules
POS = range(T - 8, T)          # 131,064 .. 131,071
ARCHS = ("gemma3-1b", "zamba2-1.2b", "rwkv6-7b")
F64_WITNESSED = ("zamba2-1.2b",)
F32_FLOOR = 1e-5
# measured: torch and XLA on the CPU, cos and sin of the same float32
# angles at positions up to 524,287 (theta 1e4 and 1e6, head_dim 16-256),
# at most 5.96e-8 apart (one float32 ulp at 0.5-1), the same at 4,096;
# the rotation q1 cos - q2 sin then within 2 float32 ulps of max |x|
ROPE_TRIG_GAP = 2.0**-24
ROPE_GAP = 2.0**-22


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small products only: run torch on one thread (no numeric effect
    here), and give the pool back afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pmesh():
    """The port's smoke mesh on the CPU (a one-process gloo group),
    destroyed after the module."""
    yield make_smoke_mesh("cpu")
    torch.distributed.destroy_process_group()


def _jax():
    jax = pytest.importorskip("jax")  # the reference; absent on a GPU host
    return jax, jax.numpy


def _seeded_cache(jmodel, seed):
    """The reference's cache of (1, T) in its stacked layout, every leaf
    drawn from numpy: keys and values std 1, states and histories std 0.1
    (float32 numpy arrays)."""
    from repro.models.param_defs import shape_tree

    rng = np.random.default_rng(seed)

    def draw(path_leaf):
        path, leaf = path_leaf
        scale = 1.0 if path.endswith(("['k']", "['v']")) else 0.1
        return (scale * rng.standard_normal(leaf.shape)).astype(np.float32)

    import jax

    shapes = shape_tree(jmodel.cache_defs(1, T))
    flat, treedef = jax.tree_util.tree_flatten_with_path(shapes)
    return jax.tree_util.tree_unflatten(
        treedef, [draw((jax.tree_util.keystr(p), leaf)) for p, leaf in flat])


def _ref_decode(jmodel, params, cache, tokens, dtype):
    """The reference's jitted decode_step at each of POS from ``cache``:
    logits (8, 1, V) float64."""
    jax, jnp = _jax()
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
    cache = jax.tree.map(lambda a: jnp.asarray(a, dtype), cache)
    step = jax.jit(jmodel.decode_step)
    out = []
    for tok, pos in zip(tokens, POS):
        logits, cache = step(params, cache, {"token": jnp.asarray(tok),
                                             "pos": jnp.asarray(pos, jnp.int32)})
        out.append(np.asarray(logits, np.float64)[:, 0])
    return np.stack(out)


def _port_decode(step, cache, tokens):
    out = []
    for tok, pos in zip(tokens, POS):
        logits, cache = step(cache, {"token": torch.from_numpy(tok),
                                     "pos": torch.tensor(pos, dtype=torch.int32)})
        out.append(logits.double().numpy()[:, 0])
    return np.stack(out)


def _setup(arch):
    jax, jnp = _jax()
    from repro.configs import build_model as jax_build
    from repro.configs import get_config as jax_config

    cfg = get_config(arch, reduced=True)
    model = build_model(cfg, device="cpu", seed=len(arch)).float()
    jmodel = jax_build(jax_config(arch, reduced=True))
    params = _ref_params(model.params())
    cache = _seeded_cache(jmodel, seed=len(arch))
    rng = np.random.default_rng(7)
    tokens = [rng.integers(0, cfg.vocab, (1, 1), dtype=np.int32) for _ in POS]
    return model, jmodel, params, cache, tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_long_decode_matches_reference(arch):
    jax, jnp = _jax()
    model, jmodel, params, cache, tokens = _setup(arch)
    want = _ref_decode(jmodel, params, cache, tokens, jnp.float32)
    got = _port_decode(model.decode_step, load_jax_cache(model, cache), tokens)
    assert np.isfinite(got).all() and got.shape == want.shape
    if arch in F64_WITNESSED:
        with jax.enable_x64(True):
            want64 = _ref_decode(jmodel, params, cache, tokens, jnp.float64)
        for i in range(len(POS)):
            own = np.abs(want[i] - want64[i]).max()
            bound = own + bf16_ulp(np.abs(want64[i]).max()) + F32_FLOOR
            assert np.abs(got[i] - want64[i]).max() <= bound, (POS[i], own)
    else:
        d = np.abs(got - want)
        assert (d <= bf16_ulp(np.maximum(abs(got), abs(want))) + F32_FLOOR).all(), d.max()


@pytest.mark.parametrize("arch", ARCHS)
def test_built_long_decode_is_the_unbuilt_step(arch, pmesh):
    _jax()
    model, jmodel, params, cache, tokens = _setup(arch)
    dec = build_decode_step(model, pmesh, ShapeSpec("long", T, 1, "decode"), graph=True)
    assert dec.rules["kv_seq"] == ("data", "model")  # the long-context rules ran
    cache_a, cache_b = load_jax_cache(model, cache), load_jax_cache(model, cache)
    want = _port_decode(model.decode_step, cache_a, tokens)
    got = _port_decode(dec.fn, cache_b, tokens)
    assert np.array_equal(got, want)
    for (name, a), (_, b) in zip(named_leaves(cache_a), named_leaves(cache_b)):
        assert torch.equal(a, b), name
    # the attention caches were written at the absolute pos (rings at pos % 8)
    if arch == "gemma3-1b":
        layer = cache_a["g0"][0]
        assert layer["b0"]["k"].shape[1] == 8 and layer["b4"]["k"].shape[1] == T
        start = load_jax_cache(model, cache)["g0"][0]
        assert not torch.equal(layer["b4"]["k"][:, T - 8:], start["b4"]["k"][:, T - 8:])
        assert torch.equal(layer["b4"]["k"][:, :T - 8], start["b4"]["k"][:, :T - 8])


@pytest.mark.parametrize("theta", (10000.0, 1000000.0))
@pytest.mark.parametrize("hd", (16, 64, 256))
def test_rope_at_long_positions_matches_reference(theta, hd):
    jax, jnp = _jax()
    from repro.models import layers as jlayers

    rng = np.random.default_rng(hd)
    positions = np.array([[0, 1, 4095, 4096, 131071, 262143, 524286, 524287]], np.int32)
    x = rng.standard_normal((1, positions.shape[1], 2, hd)).astype(np.float32)
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(positions), theta).numpy()
    want = np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(positions), theta))
    scale = np.abs(x).max()
    assert np.abs(got - want).max() <= ROPE_GAP * scale
    # the angles are the same float32 bits, their cos and sin one ulp apart
    freqs = torch.from_numpy(layers.rope_freqs(hd, theta))
    ang = torch.from_numpy(positions)[..., None].float() * freqs
    jang = jnp.asarray(positions)[..., None].astype(jnp.float32) * jnp.asarray(
        jlayers.rope_freqs(hd, theta))
    assert np.array_equal(ang.numpy(), np.asarray(jang))
    assert np.abs(torch.cos(ang).numpy() - np.asarray(jnp.cos(jang))).max() <= ROPE_TRIG_GAP
    assert np.abs(torch.sin(ang).numpy() - np.asarray(jnp.sin(jang))).max() <= ROPE_TRIG_GAP


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_long_decode_matches_cpu(arch):
    """On the card: the built long decode step (graph=True, the decode
    kernel on every attention layer at 131,072 slots, float32 weights) from
    a cache drawn with numpy (keys and values std 1, states 0.1), against
    the CPU's plain path on the same weights and cache: within one bf16 ulp
    of the larger logit + 1e-5."""
    import copy

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on a GPU host)")
    from repro_torch.tree import tree_map, tree_unflatten

    cfg = get_config(arch, reduced=True)
    cpu = build_model(cfg, device="cpu", seed=len(arch)).float()
    gpu = copy.deepcopy(cpu).to("cuda")
    rng = np.random.default_rng(len(arch))
    defs = cpu.cache_defs(1, T)
    cache = tree_unflatten(defs, [
        torch.from_numpy(rng.standard_normal(d.shape).astype(np.float32)
                         * (1.0 if name.endswith(("['k']", "['v']")) else 0.1))
        for name, d in named_leaves(defs)])
    tokens = [rng.integers(0, cfg.vocab, (1, 1), dtype=np.int32) for _ in POS]
    want = _port_decode(cpu.decode_step, tree_map(torch.clone, cache), tokens)
    mesh = make_smoke_mesh("cuda")
    try:
        dec = build_decode_step(gpu, mesh, ShapeSpec("long", T, 1, "decode"), graph=True)

        def step(c, batch):
            logits, c = dec.fn(c, {"token": batch["token"].cuda(), "pos": batch["pos"]})
            return logits.cpu(), c

        got = _port_decode(step, tree_map(lambda t: t.cuda(), cache), tokens)
    finally:
        torch.distributed.destroy_process_group()
    d = np.abs(got - want)
    assert (d <= bf16_ulp(np.maximum(abs(got), abs(want))) + F32_FLOOR).all(), d.max()
