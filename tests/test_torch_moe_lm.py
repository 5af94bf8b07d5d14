"""The port's MoE family (granite-moe-3b-a800m, deepseek-v2-lite-16b)
against the JAX package's models, on the CPU, at ``reduced=True``.

The reference's params are carried into the port bit for bit
(``load_jax_params``: router, experts, shared experts and MLA leaves
included), and on the same tokens (numpy seed):

- ``prefill`` and ``decode_step`` logits against the reference's. In
  float32 weights within one bfloat16 ulp per logit + 1e-5 (both compute
  in float32, the logits are bfloat16; routing is the same on both sides).
  In bfloat16 weights within 0.25, the dense family's bound
  (``test_torch_lm.py``; measured at most 0.031 here): bfloat16 rounding
  noise of the near one-hot attention of the reference's init. A routing
  flip between the packages (two gates within a bfloat16 rounding) would
  move a logit by a whole expert's output and fail it.
- ``loss`` (per-example loss, with the load-balance term, and ``lb_loss``)
  and its gradients against ``jax.grad`` of the reference's, float32: the
  per-example loss within 1e-5 of max(1, |loss|) and ``lb_loss`` within
  1e-5 relative (measured at most 2.7e-6 and 2.3e-7), every gradient leaf
  within 5e-3 of that leaf's largest |gradient| (measured 2.0e-3, on
  granite's embedding and attention projections). That is float32 noise
  of the reduced models' near one-hot attention (``test_torch_train_lm.py``
  holds the dense family to 2e-3): on these inputs the reference's float32
  gradients of granite-reduced lie 2.0e-3, and the port's 4.0e-3, of each
  leaf's largest |gradient| from the port's float64 gradients.
- ``num_params`` and ``num_active_params`` at full width equal the
  reference's (counted from the declaration, nothing allocated).
- Port-only: decode at pos S against the last-token logits of a prefill of
  S + 1 tokens, on a copy of the config whose MoE capacity keeps every
  choice (``capacity_factor = num_experts / top_k``): float32 weights
  within 1e-3 (measured 6.1e-5); bfloat16 within 1e-2 for granite
  (measured 0.0, as the dense family) and within the reference's own 0.5
  for deepseek (``test_models_smoke.py``; measured 0.14): there the
  absorbed decode and the expanded prefill of MLA round differently in
  bfloat16, which moves router logits across near ties and flips experts
  (both MoE layers flip a choice on these inputs; none in float32).
  ``serve_lm.main`` on both archs; the train step through
  ``build_train_step`` on the smoke mesh (the MoE mesh path) with
  granite's sharding overrides in its rules.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import serve_lm  # noqa: E402
from repro_torch.configs import ShapeSpec, build_model, get_config  # noqa: E402
from repro_torch.core.sharded import IplsTrainState  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.models.convert import load_jax_params, to_reference_layout  # noqa: E402
from repro_torch.models.param_defs import count_params  # noqa: E402
from repro_torch.models.transformer import lm_active_params, lm_param_defs  # noqa: E402
from repro_torch.tree import named_leaves, tree_leaves, tree_unflatten  # noqa: E402

MOE = ("granite-moe-3b-a800m", "deepseek-v2-lite-16b")
B, S, CL, STEPS = 2, 16, 32, 4
BF16_TOL = 0.25
FULL_COUNTS = {"granite-moe-3b-a800m": (3_298_793_472, 882_872_832),
               "deepseek-v2-lite-16b": (15_706_484_224, 2_451_432_960)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small products: run torch on one thread (no numeric effect:
    both sides of every comparison run in this process), and give the pool
    back afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_models():
    """The reference's reduced models and params, bf16 and float32."""
    jax = pytest.importorskip("jax")  # the reference; absent on a GPU host
    import jax.numpy as jnp
    from repro.configs import build_model as jax_build
    from repro.configs import get_config as jax_config

    out = {}
    for arch in MOE:
        model = jax_build(jax_config(arch, reduced=True))
        params = jax.jit(lambda model=model: model.init(0))()
        out[arch] = (model, {"bfloat16": params,
                             "float32": jax.tree.map(lambda a: a.astype(jnp.float32), params)})
    return out


def _by_name(params) -> dict:
    """A port params tree's leaves by the reference's names (its layers
    stacked), on the CPU."""
    state = IplsTrainState(torch.zeros(()), params, (), torch.zeros(()))
    return dict(named_leaves(to_reference_layout(state).params))


def _np_tree(params):
    import jax

    return jax.tree.map(np.asarray, params)


def _port(arch, params):
    return load_jax_params(build_model(get_config(arch, reduced=True), device="cpu"),
                           _np_tree(params))


def _bf16_ulp(x):
    return 2.0 ** (np.floor(np.log2(np.maximum(x, 2.0**-126))) - 7)


def _logits_within(got, want, dtype) -> float:
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    d = np.abs(g - w)
    if dtype == "float32":
        assert (d <= _bf16_ulp(np.maximum(abs(g), abs(w))) + 1e-5).all(), float(d.max())
    else:
        assert d.max() <= BF16_TOL, float(d.max())
    return float(d.max())


def test_load_jax_params_is_bitwise(jax_models):
    import jax

    for arch in MOE:
        _, by_dtype = jax_models[arch]
        params = by_dtype["bfloat16"]
        port = _port(arch, params)
        state_leaves = _by_name(port.params())
        want = dict(named_leaves(jax.tree.map(np.asarray, params)))
        assert want.keys() == state_leaves.keys()
        kinds = {"router", "wg", "wu", "wd"} | ({"shared", "wuk", "wuv", "wdkv", "wk_rope",
                                                 "kv_norm"} if arch.startswith("deepseek") else set())
        assert all(any(f"'{k}'" in name for name in want) for k in kinds)
        for k, w in want.items():
            got = state_leaves[k]
            assert got.dtype == torch.bfloat16 and tuple(got.shape) == w.shape, k
            assert np.array_equal(got.view(torch.int16).numpy(), w.view(np.int16)), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_jax(jax_models, arch, dtype, record_property):
    import jax
    import jax.numpy as jnp

    model, by_dtype = jax_models[arch]
    params = by_dtype[dtype]
    port = _port(arch, params)
    rng = np.random.default_rng(len(arch))
    toks = rng.integers(0, 256, (B, S), dtype=np.int32)
    steps = [rng.integers(0, 256, (B, 1), dtype=np.int32) for _ in range(STEPS)]
    jl, jc = jax.jit(lambda p, t: model.prefill(p, {"tokens": t, "cache_len": CL}))(
        params, jnp.asarray(toks))
    pl, pc = port.prefill({"tokens": torch.from_numpy(toks), "cache_len": CL})
    assert pl.shape == (B, 1, 256) and pl.dtype == torch.bfloat16
    worst = _logits_within(pl, jl, dtype)
    decode = jax.jit(model.decode_step)
    for i, tok in enumerate(steps):
        jl, jc = decode(params, jc, {"token": jnp.asarray(tok), "pos": jnp.asarray(S + i, jnp.int32)})
        pl, pc = port.decode_step(pc, {"token": torch.from_numpy(tok), "pos": S + i})
        worst = max(worst, _logits_within(pl, jl, dtype))
    record_property("max_abs_logit_diff", worst)


@pytest.mark.parametrize("arch", MOE)
def test_loss_and_grads_match_reference(jax_models, arch, record_property):
    import jax
    import jax.numpy as jnp

    jmodel, by_dtype = jax_models[arch]
    jparams = by_dtype["float32"]
    tokens = np.random.default_rng(0).integers(0, 256, (4, 32)).astype(np.int32)
    batch = {"tokens": jnp.asarray(tokens)}
    j_per_ex, j_aux = jax.jit(lambda p: jmodel.loss(p, batch))(jparams)
    j_grads = jax.jit(jax.grad(lambda p: jmodel.loss(p, batch)[0].mean()))(jparams)
    model = _port(arch, jparams)
    params = model.params()
    alias = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    per_ex, aux = model.loss(tree_unflatten(params, alias), {"tokens": torch.from_numpy(tokens)})
    grads = torch.autograd.grad(per_ex.mean(), alias)
    d_loss = float(np.abs(per_ex.detach().numpy() - np.asarray(j_per_ex)).max())
    lb, j_lb = float(aux["lb_loss"].detach()), float(j_aux["lb_loss"])
    assert j_lb > 0 and d_loss <= 1e-5 * max(1.0, float(np.abs(j_per_ex).max())), d_loss
    assert abs(lb - j_lb) <= 1e-5 * j_lb, (lb, j_lb)
    got = _by_name(tree_unflatten(params, list(grads)))
    want = dict(named_leaves(jax.tree.map(np.asarray, j_grads)))
    assert want.keys() == got.keys()
    worst = 0.0
    for k, w in want.items():
        rel = float(np.abs(got[k].numpy() - w).max()) / max(float(np.abs(w).max()), 1e-30)
        worst = max(worst, rel)
        assert rel <= 5e-3, (k, rel)
    record_property("loss_gap", d_loss)
    record_property("lb_rel_gap", abs(lb - j_lb) / j_lb)
    record_property("grad_gap_of_leaf_max", worst)


@pytest.mark.parametrize("arch", MOE)
def test_param_counts_at_full_width(arch):
    from repro.configs import build_model as jax_build

    cfg = get_config(arch)
    ref = jax_build(arch)
    n, active = FULL_COUNTS[arch]
    assert count_params(lm_param_defs(cfg)) == n == ref.num_params()
    assert lm_active_params(cfg) == active == ref.num_active_params()
    from repro.configs import get_config as jax_config

    small = build_model(get_config(arch, reduced=True), device="cpu")
    assert small.num_active_params() == jax_build(jax_config(arch, reduced=True)).num_active_params()


def lossless(cfg):
    """The config with every MoE capacity at all the choices
    (capacity_factor = num_experts / top_k): nothing is dropped."""
    def block(b):
        if b.kind != "moe":
            return b
        return dataclasses.replace(b, moe=dataclasses.replace(
            b.moe, capacity_factor=b.moe.num_experts / b.moe.top_k))

    return dataclasses.replace(cfg, groups=tuple(
        dataclasses.replace(g, blocks=tuple(block(b) for b in g.blocks)) for g in cfg.groups))


@pytest.mark.parametrize("dtype,bound", [("float32", {"granite-moe-3b-a800m": 1e-3,
                                                      "deepseek-v2-lite-16b": 1e-3}),
                                         ("bfloat16", {"granite-moe-3b-a800m": 1e-2,
                                                       "deepseek-v2-lite-16b": 0.5})],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_decode_matches_prefill_without_drops(arch, dtype, bound):
    """As tests/test_models_smoke.py:46, on the lossless copy: decoding one
    token at pos S equals the last-token logits of a prefill of the S + 1
    tokens (bounds in the module docstring)."""
    port = build_model(lossless(get_config(arch, reduced=True)), device="cpu", seed=1).to(
        getattr(torch, dtype))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, 256, (B, S + 1), dtype=np.int32))
    _, cache = port.prefill({"tokens": toks[:, :S], "cache_len": CL})
    logits, _ = port.decode_step(cache, {"token": toks[:, S:], "pos": S})
    ref, _ = port.prefill({"tokens": toks})
    assert torch.isfinite(logits.float()).all()
    assert (logits.float() - ref.float()).abs().max().item() < bound[arch]


@pytest.mark.parametrize("arch", MOE)
def test_serve_lm_main_on_cpu(arch, capsys):
    f0, d0 = fops.attention.LAUNCHES, dops.decode.LAUNCHES
    res = serve_lm.main(["--arch", arch, "--device", "cpu", "--reduced", "--batch", "2",
                         "--prompt-len", "12", "--tokens", "5"])
    assert res["tokens"].shape == (2, 5) and torch.isfinite(res["first_step_logits"].float()).all()
    assert "decode 4 steps" in capsys.readouterr().out
    assert (fops.attention.LAUNCHES, dops.decode.LAUNCHES) == (f0, d0)


def test_train_step_runs_the_mesh_path_with_the_overrides():
    """granite-reduced through build_train_step on the CPU smoke mesh: the
    rules carry the config's overrides, and an SGD step through the MoE
    mesh path moves the router and reports the load-balance loss."""
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import sgd

    model = build_model(get_config("granite-moe-3b-a800m", reduced=True), device="cpu").float()
    try:
        built = build_train_step(model, make_smoke_mesh("cpu"), ShapeSpec("t", 16, 4, "train"),
                                 optimizer=sgd(0.1))
        assert built.rules["experts"] is None and built.rules["expert_ffn"] == "model"
        state = built.init_state(model.params())
        router = model.groups[0][0]["b1"]["moe"]["router"].clone()
        tokens = np.random.default_rng(0).integers(0, 256, (4, 16)).astype(np.int32)
        state, metrics = built.fn(state, {"tokens": torch.from_numpy(tokens),
                                          "participation": torch.ones(4)})
        assert torch.isfinite(metrics["loss"]) and not torch.equal(
            router, model.groups[0][0]["b1"]["moe"]["router"])
    finally:
        torch.distributed.destroy_process_group()
