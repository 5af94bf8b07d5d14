"""The port's train step on an LM (``build_train_step``) against the JAX
package's ``make_train_step``, on the CPU.

- Three steps of ``build_train_step`` on the smoke mesh (float32, SGD 0.5,
  clip 1.0, the config of the reference's
  ``test_end_to_end_datacenter_train_step``, which fails in the reference
  on the smoke mesh) against the reference's ``make_train_step(model.loss,
  ...)`` jitted without a mesh, for internlm2-reduced, zamba2-reduced
  (Mamba2 and shared blocks), rwkv6-reduced and whisper-reduced (its frames
  in the batch, from the numpy seed). Each port step starts from the
  reference's state before it (``load_jax_state``): params within 1e-4
  (measured 9.8e-6, 1.2e-5, 8.9e-7), loss within 1e-6 and the grad norm
  within 1e-3 relative (measured 7.9e-4 at most, as the gradients:
  ``test_torch_train_lm.py``). Running free, the losses stay within 1e-3
  relative (measured 3.4e-4: at lr 0.5 the second step's gradient is
  sensitive to the first's rounding) and drop. whisper-reduced's init
  amplifies float32 rounding (``test_torch_train_whisper.py``): its params
  are held to 5e-4 (measured 1.9e-4) and its free-running losses to 5e-3
  (measured 2.3e-3), its loss and grad norm as the others (6.0e-7,
  8.9e-4). In bfloat16 (the reference test's dtype) the port's three
  steps drop the loss, stay finite and end at step 3; its first loss is
  within 1e-4 relative of the reference's (measured 1.9e-5).
- ``load_jax_state`` / ``to_reference_layout`` carry an AdamW state across
  and back bit for bit (internlm2's, zamba2's with its unstacked
  ``g0_shared``, whisper's ``enc`` and ``dec``); the ``train_lm_smoke`` example resumes from its
  checkpoint bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ShapeSpec, build_model, get_config
from repro_torch.core.sharded import IplsStepConfig
from repro_torch.examples import train_lm_smoke
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.steps import build_train_step
from repro_torch.models.convert import load_jax_params, load_jax_state, to_reference_layout
from repro_torch.optim import sgd
from repro_torch.tree import named_leaves, tree_leaves
from torch_train_ref import draw_batch

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


def _port_state(model, ref_state):
    jax, _ = _jax()
    return load_jax_state(model, jax.tree.map(np.asarray, ref_state))


def _built(model, opt, cfg):
    return build_train_step(model, make_smoke_mesh("cpu"), ShapeSpec("smoke", S, B, "train"),
                            optimizer=opt, step_cfg=cfg)


# per arch: params, loss (relative), grad norm (relative), free-running
# losses (relative) of the port's step from the reference's state
STEP_BOUNDS = {
    "internlm2-1.8b": (1e-4, 1e-6, 1e-3, 1e-3),
    "zamba2-1.2b": (1e-4, 1e-6, 1e-3, 1e-3),
    "rwkv6-7b": (1e-4, 1e-6, 1e-3, 1e-3),
    "whisper-base": (5e-4, 1e-6, 1e-3, 5e-3),
}


@pytest.mark.parametrize("arch", list(STEP_BOUNDS))
def test_build_train_step_matches_reference(arch):
    """The port's counterpart of the reference's failing
    test_end_to_end_datacenter_train_step, held to the reference's raw
    make_train_step."""
    jax, jnp = _jax()
    from repro.core import sharded as jsh
    from repro.optim import sgd as jsgd

    jmodel, jparams = _ref_model(arch)
    batch_np = draw_batch(arch, s=S) if arch == "whisper-base" else {"tokens": _tokens()}
    jbatch = {**{k: jnp.asarray(v) for k, v in batch_np.items()},
              "participation": jnp.ones((B,), jnp.float32)}
    batch = {**{k: torch.from_numpy(v) for k, v in batch_np.items()},
             "participation": torch.ones(B)}
    b_params, b_loss, b_gnorm, b_free = STEP_BOUNDS[arch]
    cfg = dict(grad_clip=1.0)
    jstep = jax.jit(jsh.make_train_step(jmodel.loss, jsgd(0.5), jsh.IplsStepConfig(**cfg),
                                        num_agents=1))
    jstate = jsh.init_state(jparams, jsgd(0.5))
    free_model = build_model(get_config(arch, reduced=True), device="cpu")
    free = _port_state(free_model, jstate)
    free_step = _built(free_model, sgd(0.5), IplsStepConfig(**cfg))
    losses, j_losses, worst, gaps = [], [], 0.0, [0.0, 0.0]
    for _ in range(3):
        # from the reference's state before the step
        model = build_model(get_config(arch, reduced=True), device="cpu")
        synced = _port_state(model, jstate)
        synced, m = _built(model, sgd(0.5), IplsStepConfig(**cfg)).fn(synced, batch)
        jstate, jm = jstep(jstate, jbatch)
        want = {n: np.asarray(v) for n, v in named_leaves(jax.tree.map(np.asarray, jstate))}
        got = dict(named_leaves(to_reference_layout(synced)))
        assert want.keys() == got.keys()
        d = max(float(np.abs(got[k].numpy() - want[k]).max()) for k in want)
        worst = max(worst, d)
        assert d <= b_params, d
        gaps[0] = max(gaps[0], abs(float(m["loss"]) - float(jm["loss"])) / float(jm["loss"]))
        gaps[1] = max(gaps[1], abs(float(m["grad_norm"]) - float(jm["grad_norm"]))
                      / float(jm["grad_norm"]))
        assert gaps[0] <= b_loss and gaps[1] <= b_gnorm, gaps
        assert float(m["eps"]) == float(jm["eps"]) == 1.0
        free, fm = free_step.fn(free, batch)
        losses.append(float(fm["loss"]))
        j_losses.append(float(jm["loss"]))
    assert int(free.step) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    rel = max(abs(a - b) / b for a, b in zip(losses, j_losses))
    assert rel <= b_free, (losses, j_losses)
    print(f"{arch}: one step from the reference's state: params max |d| {worst:.3g}, loss "
          f"{gaps[0]:.3g}, grad norm {gaps[1]:.3g} (relative); free-running losses {losses} "
          f"vs {j_losses} (max rel {rel:.3g})")


def test_bf16_train_step_like_reference_system_test():
    """The reference test's own dtype and assertions (bfloat16 weights)."""
    jax, jnp = _jax()
    jmodel, jparams = _ref_model("internlm2-1.8b", "bfloat16")
    tokens = _tokens()
    model = build_model(get_config("internlm2-1.8b", reduced=True), device="cpu", seed=0)
    load_jax_params(model, jax.tree.map(np.asarray, jparams))
    built = _built(model, sgd(0.5), IplsStepConfig(grad_clip=1.0))
    state = built.init_state(model.params())
    batch = {"tokens": torch.from_numpy(tokens), "participation": torch.ones(B)}
    losses = []
    for _ in range(3):
        state, metrics = built.fn(state, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0], losses
    assert int(state.step) == 3 and not np.isnan(losses[-1])
    assert model.params()["g0"][0]["b0"]["attn"]["wq"].dtype == torch.bfloat16  # dtype kept
    j_first = float(jax.jit(lambda p: jmodel.loss(p, {"tokens": jnp.asarray(tokens)})[0].mean())(
        jparams))
    assert abs(losses[0] - j_first) <= 1e-4 * j_first, (losses[0], j_first)


# per arch: a stacked tree, its layer count, and the state's leaf count
# (step, eps, and params, m and v for each parameter)
ROUNDTRIP = {"internlm2-1.8b": ("g0", 2, 3 * 12 + 2),
             "zamba2-1.2b": ("g0", 2, 3 * 38 + 2),    # g0_shared's 9 among the 38
             "whisper-base": ("dec", 2, 3 * 43 + 2)}


@pytest.mark.parametrize("arch", list(ROUNDTRIP))
def test_state_conversion_roundtrip_bitwise(arch):
    """A reference AdamW state (bfloat16 params, float32 moments filled from
    a numpy seed) across to the port and back: the per-layer lists of every
    group (and whisper's ``enc`` and ``dec``) and zamba2's unstacked
    ``g{gi}_shared`` trees, moments included."""
    jax, jnp = _jax()
    from repro.core import sharded as jsh
    from repro.optim import adamw as jadamw

    _, jparams = _ref_model(arch, "bfloat16")
    rng = np.random.default_rng(5)
    jstate = jsh.init_state(jparams, jadamw(1e-2))
    jstate = jstate._replace(
        step=jnp.asarray(3, jnp.int32), eps=jnp.asarray(0.75, jnp.float32),
        opt_state=jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                               jstate.opt_state))
    ref = jax.tree.map(np.asarray, jstate)
    model = build_model(get_config(arch, reduced=True), device="cpu")
    state = load_jax_state(model, ref)
    key, layers, n_leaves = ROUNDTRIP[arch]
    assert len(state.params[key]) == len(state.opt_state[key]) == layers
    assert all(leaf.dtype == torch.float32 for leaf in tree_leaves(state.opt_state))
    if arch == "zamba2-1.2b":  # one copy of the shared blocks, its moments unstacked
        assert state.opt_state["g0_shared"]["b0"]["attn"]["wq"].m.shape \
            == state.params["g0_shared"]["b0"]["attn"]["wq"].shape
    back = dict(named_leaves(to_reference_layout(state)))
    want = dict(named_leaves(ref))
    assert back.keys() == want.keys() and len(want) == n_leaves
    for k, w in want.items():
        got = back[k]
        if got.dtype == torch.bfloat16:
            assert w.dtype.name == "bfloat16"
            assert got.view(torch.int16).numpy().tobytes() == w.view(np.int16).tobytes(), k
        else:
            assert got.numpy().tobytes() == w.tobytes() and got.numpy().dtype == w.dtype, k


def test_train_lm_smoke_example_resumes(tmp_path, capsys):
    args = ["--device", "cpu", "--steps", "101", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path)]
    losses = train_lm_smoke.main(args)
    assert len(losses) == 101 and losses[-1] < losses[0] - 0.3, (losses[0], losses[-1])
    assert (tmp_path / "step_00000100" / "COMMITTED_0").exists()
    resumed = train_lm_smoke.main(args + ["--resume"])
    assert "resumed from step 100" in capsys.readouterr().out
    assert resumed == losses[100:]  # bit for bit the uninterrupted run's last step
