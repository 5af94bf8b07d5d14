"""The port's datacenter mapping (``core/sharded.py``, ``launch/``) against
the JAX package's, in one process on the CPU.

- The six cases of ``tests/test_sharded_equivalence.py``: the eps-weighted
  step, the participation mask and accumulation, each as there (the same
  manual expectations, rtol 1e-5) and against the reference's
  ``make_train_step`` jitted on the same numpy inputs (1e-6 absolute on
  parameters of size ~1; measured 0.0 to 2.4e-7); the ZeRO-1 spec, the
  state shardings and the FSDP shardings equal to the reference's
  ``PartitionSpec``s as tuples on the smoke mesh.
- The logical axes of every ported config equal to the reference's with
  the stacked ``layers`` axis removed, and their specs (``spec_for_leaf``
  over meshes of several shapes, ``tree_shardings`` and
  ``state_shardings`` of the models) equal to the reference's functions'
  on the same leaves.
- The same step without a mesh, on the smoke mesh, and with the ZeRO-1
  specs on the smoke mesh give the same bits.
- ``fsdp=True`` on the smoke mesh (a gather over a world of one is the
  identity) gives the bits of ``fsdp=False`` (RWKV6 training, which once
  raised, runs).

The multi-rank meshes run in ``test_torch_sharded_dist.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")  # the reference; absent on a GPU host
import jax.numpy as jnp
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import build_model as jax_build
from repro.configs import get_config as jax_config
from repro.core import sharded as jsh
from repro.launch.mesh import make_smoke_mesh as jax_smoke_mesh
from repro.optim import adam as jadam
from repro.optim import sgd as jsgd
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core import sharded as psh
from repro_torch.launch.mesh import dp_axes, make_rules, make_smoke_mesh
from repro_torch.models.transformer import lm_axes
from repro_torch.models.whisper import WhisperConfig, whisper_axes
from repro_torch.optim import adam, sgd
from repro_torch.tree import named_leaves, tree_leaves, tree_map, tree_unflatten

STEP_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small products only: run torch on one thread (no numeric effect
    here), and give the pool back afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    """The port's smoke mesh on the CPU (a one-process gloo group),
    destroyed after the module."""
    yield make_smoke_mesh("cpu")
    torch.distributed.destroy_process_group()


def tiny_loss_j(params, batch):
    pred = batch["x"] @ params["w"]
    return jnp.mean(jnp.square(pred - batch["y"]), axis=-1), {}


def tiny_loss(params, batch):
    pred = batch["x"] @ params["w"]
    return (pred - batch["y"]).square().mean(dim=-1), {}


def make_inputs(B=8, D=4):
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((D, D)).astype(np.float32)}
    batch = {
        "x": rng.standard_normal((B, D)).astype(np.float32),
        "y": rng.standard_normal((B, D)).astype(np.float32),
        "participation": np.ones((B,), np.float32),
    }
    return params, batch


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _both_steps(cfg_kw, batch, num_agents=None, opt_pair=(jsgd(0.1), sgd(0.1))):
    """One step of the reference (jitted, no mesh) and of the port (no
    mesh) from the same params: (reference state, metrics), (port ...)."""
    params, _ = make_inputs(B=len(batch["x"]))
    jo, po = opt_pair
    jstep = jax.jit(jsh.make_train_step(tiny_loss_j, jo, jsh.IplsStepConfig(**cfg_kw),
                                        num_agents=num_agents))
    jst, jm = jstep(jsh.init_state(jax.tree.map(jnp.asarray, params), jo),
                    jax.tree.map(jnp.asarray, batch))
    pstep = psh.make_train_step(tiny_loss, po, psh.IplsStepConfig(**cfg_kw),
                                num_agents=num_agents)
    pst, pm = pstep(psh.init_state(_t(params), po), _t(batch))
    d = float(np.abs(pst.params["w"].numpy() - np.asarray(jst.params["w"])).max())
    assert d <= STEP_TOL, d
    print(f"port vs reference step: max |d| {d:.3g}")
    for k in jm:
        assert abs(float(pm[k]) - float(jm[k])) <= STEP_TOL * max(1.0, abs(float(jm[k]))), k
    return (jst, jm), (pst, pm)


def test_eps_weighted_step_matches_manual():
    params, batch = make_inputs()
    _, (st, _) = _both_steps(dict(alpha=0.5, grad_clip=None), batch, num_agents=4)
    # eps (paper): eps1 = 0.5*1 + 0.5/4 = 0.625, applied scale = eps1*r = 2.5
    w = torch.from_numpy(params["w"]).requires_grad_(True)
    (g,) = torch.autograd.grad(tiny_loss({"w": w}, _t(batch))[0].mean(), w)
    want = params["w"] - 2.5 * 0.1 * g.numpy()
    np.testing.assert_allclose(st.params["w"].numpy(), want, rtol=1e-5)
    assert np.isclose(float(st.eps), 0.625)


def test_participation_mask_drops_agents():
    params, batch = make_inputs(B=8)
    batch["participation"] = np.array([1, 1, 1, 1, 0, 0, 0, 0], np.float32)
    _, (st, metrics) = _both_steps(dict(alpha=0.5, grad_clip=None), batch, num_agents=2)
    # equals training on only the first half of the batch
    half = {k: v[:4] for k, v in _t(batch).items()}
    w = torch.from_numpy(params["w"]).requires_grad_(True)
    (g,) = torch.autograd.grad(tiny_loss({"w": w}, half)[0].mean(), w)
    np.testing.assert_allclose(st.params["w"].numpy(), params["w"] - 0.1 * g.numpy(), rtol=1e-5)
    assert np.isclose(float(metrics["participation"]), 0.5)
    # r = 1 participant of 2 agents -> eps = 0.5 + 0.5/1 = 1.0
    assert np.isclose(float(st.eps), 1.0)


@pytest.mark.parametrize("mask", [None, (1, 1, 0, 0, 1, 1, 1, 1)], ids=["all", "partial"])
def test_accumulation_matches_full_batch(mask):
    """As the reference's case (all participating: accumulation equals the
    full batch), and a mask that leaves a microbatch half empty, where the
    port follows the reference's per-microbatch means."""
    _, batch = make_inputs(B=8)
    if mask is not None:
        batch["participation"] = np.array(mask, np.float32)
    _, (s1, _) = _both_steps(dict(use_eps=False, grad_clip=None), batch)
    _, (s2, _) = _both_steps(dict(use_eps=False, grad_clip=None, accum_steps=2), batch)
    if mask is None:
        np.testing.assert_allclose(s1.params["w"].numpy(), s2.params["w"].numpy(), rtol=1e-5)


def test_zero1_spec_adds_data_axis(mesh):
    jmesh = jax_smoke_mesh()
    for args in [(("embed", "ffn"), (64, 128), {"embed": None, "ffn": "model"}, "data"),
                 (("ffn",), (128,), {"ffn": "model"}, "data")]:
        assert psh.spec_for_leaf(*args[:2], mesh, *args[2:]) == tuple(
            jsh.spec_for_leaf(*args[:2], jmesh, *args[2:]))
    # ffn dim maps to model; zero1 adds data on the remaining dim
    spec = psh.spec_for_leaf(("embed", "ffn"), (64, 128), mesh, {"embed": None, "ffn": "model"},
                             "data")
    assert spec == ("data", "model")
    # already-sharded dim gets sub-axis sharding when divisible
    assert psh.spec_for_leaf(("ffn",), (128,), mesh, {"ffn": "model"}, "data") == (
        ("model", "data"),)


def _ref_specs(tree):
    """{keystr: spec tuple} of a reference sharding tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
    return {jax.tree_util.keystr(p): tuple(s.spec) for p, s in flat}


def _port_specs(tree, name=""):
    """{name: spec} of a port spec tree, named as ``jax.tree_util.keystr``
    names the reference's (a spec is a tuple of axis names; dicts, lists
    and NamedTuples are nodes)."""
    if isinstance(tree, dict):
        return {n: s for k in sorted(tree) for n, s in _port_specs(tree[k], f"{name}[{k!r}]").items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {n: s for f, x in zip(tree._fields, tree)
                for n, s in _port_specs(x, f"{name}.{f}").items()}
    if isinstance(tree, list):
        return {n: s for i, x in enumerate(tree) for n, s in _port_specs(x, f"{name}[{i}]").items()}
    return {name: tree}


@pytest.mark.parametrize("fsdp", [False, True], ids=["state", "fsdp"])
def test_state_shardings_match_reference(mesh, fsdp):
    params, _ = make_inputs()
    axes = {"w": ("embed", "ffn")}
    jshapes = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), params)
    ref = jsh.state_shardings(axes, jshapes, jadam(1e-3), jax_smoke_mesh(), fsdp=fsdp)
    got = psh.state_shardings(axes, _t(params), adam(1e-3), mesh, fsdp=fsdp)
    assert _port_specs(got) == _ref_specs(ref)
    if fsdp:
        assert "data" in got.params["w"]  # lightweight storage
    else:
        # params replicated over data (LoadModel layout); opt sharded (ZeRO-1)
        assert "data" not in got.params["w"]
        assert "data" in got.opt_state["w"].m and "data" in got.opt_state["w"].v
    assert got.eps == () and got.step == ()
    assert psh.state_shardings(axes, _t(params), sgd(0.1), mesh).opt_state == ()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_axes_trees_match_reference(arch):
    """Every arch's axes (whisper's through ``whisper_axes``): a stacked
    stack of layers per layer without its ``layers`` axis."""
    for reduced in (True, False):
        ref = jax_build(jax_config(arch, reduced=reduced)).axes()
        cfg = get_config(arch, reduced=reduced)
        if isinstance(cfg, WhisperConfig):
            got = whisper_axes(cfg)
            layers = {"enc": cfg.enc_layers, "dec": cfg.dec_layers}
        else:
            got = lm_axes(cfg)
            layers = {f"g{gi}": g.repeat for gi, g in enumerate(cfg.groups)}
        assert set(got) == set(ref)
        for k in got:
            if k in layers:  # shared blocks (g{gi}_shared): unstacked
                strip = jax.tree.map(lambda a: a[1:], ref[k], is_leaf=lambda x: isinstance(x, tuple))
                assert all(a == ("layers",) + b for a, b in zip(
                    jax.tree.leaves(ref[k], is_leaf=lambda x: isinstance(x, tuple)),
                    jax.tree.leaves(strip, is_leaf=lambda x: isinstance(x, tuple))))
                assert got[k] == [strip] * layers[k]
            else:
                assert got[k] == ref[k]


MESHES = [(1, 1), (2, 1), (4, 1), (2, 2), (16, 16), (2, 16, 16)]
LEAVES = [
    (("embed", "heads", None), (64, 4, 16)), (("heads", None, "embed"), (4, 16, 64)),
    (("embed", "kv_heads", None), (2048, 8, 128)), (("vocab", "embed"), (92544, 2048)),
    (("embed", "ffn"), (2048, 8192)), (("ffn", "embed"), (6, 64)), ((None,), (64,)),
    ((None,), (3,)), (("layers", "embed", "ffn"), (24, 64, 128)), (("batch", "act_seq"), (8, 32)),
]


@pytest.mark.parametrize("shape", MESHES, ids=["x".join(map(str, m)) for m in MESHES])
def test_spec_for_leaf_matches_reference(shape):
    names = ("pod", "data", "model")[-len(shape):]
    jmesh = AbstractMesh(shape, names)
    sizes = dict(zip(names, shape))
    for rules in (jsh.DEFAULT_RULES, dict(jsh.DEFAULT_RULES, **make_rules(_Names(names, shape),
                                                                         "train"))):
        for axes, dims in LEAVES:
            for zero1 in (None, "data"):
                want = tuple(jsh.spec_for_leaf(axes, dims, jmesh, rules, zero1))
                assert psh.spec_for_leaf(axes, dims, sizes, rules, zero1) == want, (axes, dims)


class _Names:
    """A mesh's axis names and sizes, without processes: what ``dp_axes``
    and ``make_rules`` read, and what the spec functions take."""

    def __init__(self, names, shape):
        self.mesh_dim_names, self.shape = tuple(names), tuple(shape)


def test_mesh_helpers_match_reference(mesh):
    from repro.launch import mesh as jmesh

    for names, shape in ((("data", "model"), (16, 16)), (("pod", "data", "model"), (2, 16, 16))):
        fake = _Names(names, shape)
        jm = AbstractMesh(shape, names)
        assert dp_axes(fake) == jmesh.dp_axes(jm)
        for kind in ("train", "prefill", "decode"):
            for long in (False, True):
                assert make_rules(fake, kind, long) == jmesh.make_rules(jm, kind, long)
    assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
    assert psh.mesh_axis_size(mesh, ("data", "model")) == 1


@pytest.mark.parametrize("arch", ("internlm2-1.8b", "phi4-mini-3.8b", "granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b"))
@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (8, 1)], ids=["1x1", "2x1", "8x1"])
def test_model_shardings_match_reference(arch, shape):
    """tree_shardings (compute and ZeRO-1 layouts) and state_shardings of a
    whole model's per-layer leaves: the port's against the reference's
    functions on the same leaves (full-width shapes, nothing allocated),
    with the config's sharding overrides as ``build_train_step`` applies
    them (granite's experts replicated, their ffn dim over "model")."""
    from repro.models.param_defs import shape_tree

    cfg = get_config(arch)
    jmodel = jax_build(jax_config(arch))
    names = ("data", "model")
    jmesh, sizes = AbstractMesh(shape, names), dict(zip(names, shape))
    rules = dict(jsh.DEFAULT_RULES, **make_rules(_Names(names, shape), "train"))
    rules.update(cfg.sharding_overrides)
    assert cfg.sharding_overrides == jax_config(arch).sharding_overrides
    axes = lm_axes(cfg)
    ref_shapes = shape_tree(jmodel.param_defs())
    # per-layer shapes: the reference's stacked ones without the layers axis
    shapes = {k: (v if not k.startswith("g") else
                  [jax.tree.map(lambda s: s.shape[1:], v)] * cfg.groups[int(k[1:])].repeat)
              for k, v in ref_shapes.items()}
    shapes = {k: (jax.tree.map(lambda s: s.shape, v) if not k.startswith("g") else v)
              for k, v in shapes.items()}
    for zero1 in (None, "data"):
        want = jsh.tree_shardings(axes, shapes, jmesh, rules, zero1)
        got = psh.tree_shardings(axes, shapes, sizes, rules, zero1)
        assert _port_specs(got) == _ref_specs(want)
    meta = _meta(shapes)
    got = psh.state_shardings(axes, meta, adam(1e-3), sizes, rules)
    jshapes = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32), shapes,
                           is_leaf=lambda x: isinstance(x, tuple))
    want = jsh.state_shardings(axes, jshapes, jadam(1e-3), jmesh, rules)
    assert _port_specs(got) == _ref_specs(want)


def _meta(shapes):
    """A tree of shape tuples as meta tensors (no storage)."""
    if isinstance(shapes, dict):
        return {k: _meta(v) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_meta(v) for v in shapes]
    return torch.empty(shapes, device="meta")


def _snapshot(state):
    return {n: v.clone() for n, v in named_leaves(state)}


def test_mesh_step_equals_no_mesh_bitwise(mesh):
    """Without a mesh, on the smoke mesh, and on the smoke mesh with the
    ZeRO-1 specs (a world of one): the same bits, with adam, clipping and
    accumulation."""
    params, batch = make_inputs(B=8)
    batch["participation"] = np.array([1, 1, 0, 1, 1, 1, 1, 1], np.float32)
    cfg = psh.IplsStepConfig(grad_clip=0.5, accum_steps=2)
    spec = {"w": psh.spec_for_leaf(("embed", "ffn"), (4, 4), mesh, psh.DEFAULT_RULES, "data")}
    runs = []
    for m, shardings in ((None, None), (mesh, None), (mesh, spec)):
        opt = adam(1e-2)
        step = psh.make_train_step(tiny_loss, opt, cfg, num_agents=1, update_shardings=shardings,
                                   mesh=m)
        st = psh.init_state(_t(params), opt, shardings, m)
        for _ in range(3):
            st, metrics = step(st, _t(batch))
        runs.append((_snapshot(st), {k: v.clone() for k, v in metrics.items()}))
    for s, m in runs[1:]:
        assert s.keys() == runs[0][0].keys()
        assert all(torch.equal(s[k], runs[0][0][k]) for k in s)
        assert all(torch.equal(m[k], runs[0][1][k]) for k in m)


def test_smoke_mesh_refuses_another_backend(mesh, monkeypatch):
    """An existing group whose backend does not fit the device is refused,
    not reused: here the gloo group of the CPU mesh as if it were NCCL."""
    assert make_smoke_mesh("cpu").mesh_dim_names == ("data", "model")  # reused
    monkeypatch.setattr(torch.distributed, "get_backend", lambda *a, **k: "nccl")
    with pytest.raises(ValueError, match="needs 'gloo'"):
        make_smoke_mesh("cpu")


@pytest.mark.cuda
def test_cuda_smoke_mesh_refuses_gloo_group(mesh):
    """A CUDA smoke mesh is not built over the CPU mesh's gloo group."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on a GPU host)")
    with pytest.raises(ValueError, match="needs 'nccl'"):
        make_smoke_mesh("cuda")


def test_unported_modes_raise(mesh):
    """fsdp=True, once refused, runs: on the gloo smoke mesh three AdamW
    steps with two microbatches give the bits of fsdp=False (the stored
    shard of a data axis of 1 is the whole leaf)."""
    params, batch = make_inputs()
    specs = {"w": psh.spec_for_leaf(("embed", "ffn"), (4, 4), mesh, psh.DEFAULT_RULES, "data")}
    runs = []
    for fsdp in (False, True):
        opt = adam(1e-2)
        cfg = psh.IplsStepConfig(grad_clip=0.5, accum_steps=2, fsdp=fsdp)
        step = psh.make_train_step(tiny_loss, opt, cfg, num_agents=1, update_shardings=specs,
                                   mesh=mesh)
        st = psh.init_state(_t(params), opt, specs, mesh, fsdp=fsdp)
        for _ in range(3):
            st, metrics = step(st, _t(batch))
        runs.append((_snapshot(st), {k: v.clone() for k, v in metrics.items()}))
    (s0, m0), (s1, m1) = runs
    assert s0.keys() == s1.keys() and all(torch.equal(s1[k], s0[k]) for k in s0)
    assert all(torch.equal(m1[k], m0[k]) for k in m0)
    from repro_torch.configs import SHAPES, build_model
    from repro_torch.launch.steps import build_step

    model = build_model(get_config("rwkv6-7b", reduced=True), device="cpu")
    # RWKV6 trains since its slice (tests/test_torch_train_rwkv.py): the
    # loss runs, finite, with a gradient on every leaf
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(model.params())]
    per_ex, _ = model.loss(tree_unflatten(model.params(), leaves),
                           {"tokens": torch.arange(1, 9, dtype=torch.int32)[None]})
    assert torch.isfinite(per_ex).all()
    grads = torch.autograd.grad(per_ex.sum(), leaves)
    assert all(torch.isfinite(g).all() for g in grads)
    built = build_step(model, mesh, SHAPES["prefill_32k"])  # ported: specs, nothing allocated
    assert built.arg_shapes[1]["tokens"].shape == (32, 32768) and callable(built.fn)
