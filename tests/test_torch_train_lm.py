"""The port's LM training forward against the JAX package's, on the CPU.

- ``loss`` and its gradients, float32 weights carried across bit for bit
  (``load_jax_params``), on the same tokens (numpy seed), for the dense
  family and qwen2-vl (M-RoPE, with an image's positions3) at
  ``reduced=True``: the per-example loss within 1e-5 (measured
  at most 1.5e-6), every gradient leaf within 2e-3 of that leaf's largest
  |gradient| (measured 6.0e-4 of it, on the embedding table and the
  attention projections). That is float32 noise, which the reduced
  models amplify: their random init (fan-in over the stacked layer axis)
  makes the attention nearly one-hot. The reference's own float32
  gradients lie 1.5e-4 of the embedding's largest gradient from its
  float64 ones on these inputs, the port's 2.3e-4.
- ``input_specs`` and ``shape_applicable``; the entry points' default device; and, on a card
  (``-m cuda``), one train step on the card's smoke mesh against the same
  step on the CPU, for internlm2, gemma3, zamba2, rwkv6 and whisper
  (reduced; measured on an H100: params within 2.7e-5, 5.4e-7, 3.2e-6,
  3.4e-7 and 1.3e-4), no kernel launched.

The other families' losses and gradients: ``test_torch_train_{gemma3,
zamba2,rwkv,whisper}.py``; the train step against the reference's:
``test_torch_train_step.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import serve_lm
from repro_torch.configs import (
    ARCH_IDS,
    ShapeSpec,
    build_model,
    get_config,
    input_specs,
    shape_applicable,
)
from repro_torch.core.sharded import IplsStepConfig, init_state, make_train_step
from repro_torch.examples import train_lm_smoke
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.steps import build_train_step
from repro_torch.models.convert import load_jax_params, to_reference_layout
from repro_torch.optim import sgd
from repro_torch.tree import named_leaves, tree_leaves, tree_unflatten

DENSE = ("internlm2-1.8b", "phi4-mini-3.8b", "minitron-4b")
B, S = 4, 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small products: run torch on one thread (no numeric effect:
    both sides of every comparison run in this process), and give the pool
    back afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def smoke_group():
    """The smoke mesh's one-process group, destroyed after the module."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def _tokens(vocab=256):
    return np.random.default_rng(0).integers(0, vocab, (B, S)).astype(np.int32)


def _jax():
    jax = pytest.importorskip("jax")  # the reference; absent on a GPU host
    return jax, jax.numpy


def _ref_model(arch, dtype="float32"):
    jax, jnp = _jax()
    from repro.configs import build_model as jax_build
    from repro.configs import get_config as jax_config

    model = jax_build(jax_config(arch, reduced=True))
    return model, jax.tree.map(lambda a: a.astype(getattr(jnp, dtype)), model.init(0))


def _grads_by_name(model, params, tokens, extra=None):
    """Per-example loss and the gradients of its mean, by reference name
    (``extra``: M-RoPE's positions3)."""
    leaves = tree_leaves(params)
    alias = [p.detach().requires_grad_(True) for p in leaves]
    per_ex, _ = model.loss(tree_unflatten(params, alias),
                           {"tokens": torch.from_numpy(tokens), **(extra or {})})
    grads = torch.autograd.grad(per_ex.mean(), alias)
    from repro_torch.core.sharded import IplsTrainState

    tree = IplsTrainState(torch.zeros(()), tree_unflatten(params, list(grads)), (),
                          torch.zeros(()))
    return per_ex.detach(), dict(named_leaves(to_reference_layout(tree).params))


def _extra(arch):
    """qwen2-vl's positions3: a 3 x 4-patch image after 5 text tokens."""
    if arch != "qwen2-vl-72b":
        return {}
    return {"positions3": serve_lm.image_positions3(B, S, 5, (3, 4))}


@pytest.mark.parametrize("arch", DENSE + ("qwen2-vl-72b",))
def test_loss_and_grads_match_reference(arch):
    jax, jnp = _jax()
    jmodel, jparams = _ref_model(arch)
    tokens = _tokens()
    extra = _extra(arch)
    batch = {"tokens": jnp.asarray(tokens), **{k: jnp.asarray(v.numpy()) for k, v in extra.items()}}
    j_per_ex = jax.jit(lambda p: jmodel.loss(p, batch)[0])(jparams)
    j_grads = jax.jit(jax.grad(lambda p: jmodel.loss(p, batch)[0].mean()))(jparams)
    model = load_jax_params(build_model(get_config(arch, reduced=True), device="cpu"),
                            jax.tree.map(np.asarray, jparams))
    per_ex, grads = _grads_by_name(model, model.params(), tokens, extra)
    assert per_ex.shape == (B,) and per_ex.dtype == torch.float32
    d_loss = float(np.abs(per_ex.numpy() - np.asarray(j_per_ex)).max())
    assert d_loss <= 1e-5, d_loss
    want = dict(named_leaves(jax.tree.map(np.asarray, j_grads)))
    assert want.keys() == grads.keys()
    worst = 0.0
    for k, w in want.items():
        rel = float(np.abs(grads[k].numpy() - w).max()) / max(float(np.abs(w).max()), 1e-30)
        worst = max(worst, rel)
        assert rel <= 2e-3, (k, rel)
    print(f"{arch}: loss max |d| {d_loss:.3g}, grads max |d| / max |g| {worst:.3g}")


def test_input_specs_match_reference():
    _jax()
    from repro.configs import get_config as jax_config
    from repro.configs.registry import SHAPES as J_SHAPES
    from repro.configs.registry import input_specs as j_input_specs

    for arch in ARCH_IDS:  # whisper's enc_embeds and qwen2-vl's positions3 among them
        for shape in J_SHAPES.values():
            for scale in (None, 8):
                want = j_input_specs(jax_config(arch), shape, reduced_scale=scale)
                got = input_specs(get_config(arch), shape, reduced_scale=scale)
                assert list(got) == list(want)
                for k in got:
                    assert got[k].shape == want[k].shape
                    assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_applicable_matches_reference(arch):
    _jax()
    from repro.configs.registry import SHAPES as J_SHAPES
    from repro.configs.registry import shape_applicable as j_shape_applicable

    for shape in J_SHAPES:
        assert shape_applicable(arch, shape) == j_shape_applicable(arch, shape)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lm_smoke.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_smoke_mesh()


# card vs CPU, params after one SGD step: whisper-reduced's init amplifies
# float32 rounding (test_torch_train_whisper.py), as against the reference
CUDA_STEP_PARAMS_TOL = {"whisper-base": 5e-4}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ("internlm2-1.8b", "gemma3-1b", "zamba2-1.2b", "rwkv6-7b",
                                  "whisper-base"))
def test_cuda_train_step_matches_cpu(arch):
    """One step on the card's smoke mesh (NCCL, a world of one) against the
    same step on the CPU, float32 weights from one seed, SGD 0.5 with clip
    1.0 and accum_steps=2: params within 1e-4 (the grads agree to float32
    noise, products in other orders with TF32 off; whisper 5e-4), step and
    eps exactly, metrics within 1e-3 of max(1, |value|); no kernel
    launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on a GPU host)")
    from repro_torch.kernels.decode_attention import ops as dops
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.linear_scan import ops as sops

    wrappers = (fops.attention, dops.decode, sops.rwkv6_scan)
    cfg = get_config(arch, reduced=True)
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(_tokens(cfg.vocab)), "participation": torch.ones(B)}
    if arch == "whisper-base":
        batch["enc_embeds"] = torch.from_numpy(rng.standard_normal((B, S, cfg.d_model))
                                               .astype(np.float32))
    step_cfg = IplsStepConfig(grad_clip=1.0, accum_steps=2)
    runs = []
    launches = [w.LAUNCHES for w in wrappers]
    for device in ("cpu", "cuda"):
        # drawn on the CPU (a CUDA generator draws other numbers), then moved
        model = build_model(cfg, device="cpu", seed=0).float().to(device)
        if device == "cpu":
            step = make_train_step(model.loss, sgd(0.5), step_cfg, num_agents=1)
            state, metrics = step(init_state(model.params(), sgd(0.5)), batch)
        else:
            built = build_train_step(model, make_smoke_mesh("cuda"), ShapeSpec("t", S, B, "train"),
                                     optimizer=sgd(0.5), step_cfg=step_cfg)
            state, metrics = built.fn(built.init_state(model.params()), batch)
        runs.append((dict(named_leaves(state)), {k: float(v) for k, v in metrics.items()}))
    assert [w.LAUNCHES for w in wrappers] == launches
    (cpu, mc), (gpu, mg) = runs
    assert cpu.keys() == gpu.keys()
    tol = CUDA_STEP_PARAMS_TOL.get(arch, 1e-4)
    worst = 0.0
    for k in cpu:
        d = float((gpu[k].cpu().float() - cpu[k].float()).abs().max())
        worst = max(worst, d) if k.startswith(".params") else worst
        assert d <= (tol if k.startswith(".params") else 0.0), (k, d)
    for k in mc:
        assert abs(mg[k] - mc[k]) <= 1e-3 * max(1.0, abs(mc[k])), k
    print(f"{arch}: card vs CPU params max |d| {worst:.3g}")
