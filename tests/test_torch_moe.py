"""The port's MoE layer (``models/layers.py``) against the JAX package's.

Inputs and weights are drawn with numpy from a seed and given to both
packages, in float32, on the CPU.

- The grouped path (``apply_moe`` outside a mesh context) against the
  reference's ``_apply_moe_reference``: at reduced width (d 64, 8 experts,
  top-2) and at granite-moe-3b-a800m's full width (d 1536, 40 experts,
  top-8, d_expert 512) with T = 256 tokens (G = 32 groups of 8, capacity
  4); a router that sends most tokens to three experts (choices dropped);
  exact gate ties (duplicate router columns: the lower expert index wins,
  as ``lax.top_k`` orders ties); T = 21, not a multiple of the 32 groups
  (G = 1); T = 4 (capacity raised to the ``min_capacity`` floor); shared
  experts. Held: the same top-k experts and the same dropped (token,
  choice) pairs, exactly; y within 1e-5 of max |y| (float32 products summed
  in other orders; measured at most 2.0e-6 of max |y|, at full width with
  drops); the load-balance loss within 1e-6 relative (measured at most
  1.9e-7).
- The mesh path (``apply_moe`` under ``activation_sharding``) against the
  reference's ``_apply_moe_shardmap`` on a one-device mesh, the context
  passed in directly: one group, capacity from all the rank's tokens,
  float32 combine; the same checks and bounds.
- The mesh path on a gloo mesh of 2 CPU processes
  (``torch_moe_worker.py``): each rank's output equals the one-process mesh
  path on its half of the batch, bit for bit, its load-balance loss is the
  mean of the halves' (within 1e-7 relative), and the router's gradient of
  that loss is its half's own (``pmean``'s transpose: the mean of the two
  ranks' unit cotangents; within 1e-6 of its largest |value|), so the ranks'
  gradients sum to that of the summed losses.

The grouped and mesh paths are never held against each other: their
capacities differ by design.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")  # the reference; absent on a GPU host
import jax.numpy as jnp  # noqa: E402

import torch_moe_worker as worker  # noqa: E402
from repro.core.sharded import DEFAULT_RULES as JAX_RULES  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.launch.mesh import make_rules, make_smoke_mesh  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.sharding_hooks import activation_sharding  # noqa: E402

Y_TOL = 1e-5  # of max |y|
LB_TOL = 1e-6  # relative

# name: (d_model, experts, top_k, d_expert, capacity factor, shared, batch, seq, router)
CASES = {
    "reduced_T256": (64, 8, 2, 32, 2.0, 0, 4, 64, "random"),
    "reduced_skewed": (64, 8, 2, 32, 2.0, 0, 4, 64, "skewed"),
    "reduced_ties": (64, 8, 2, 32, 2.0, 0, 4, 64, "ties"),
    "reduced_T21_one_group": (64, 8, 2, 32, 2.0, 0, 3, 7, "random"),
    "reduced_T4_min_capacity": (64, 8, 2, 32, 2.0, 0, 4, 1, "random"),
    "reduced_shared": (64, 8, 2, 32, 2.0, 64, 2, 8, "random"),
    "granite_T256": (1536, 40, 8, 512, 1.25, 0, 4, 64, "random"),
    "granite_skewed": (1536, 40, 8, 512, 1.25, 0, 4, 64, "skewed"),
}
MESH_CASES = ("reduced_T256", "reduced_skewed", "reduced_T4_min_capacity", "reduced_shared",
              "granite_T256")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small products only: run torch on one thread, and give the pool back
    afterwards."""
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


def _case(name):
    D, E, K, F, cf, d_shared, B, S, router = CASES[name]
    spec = dict(d_model=D, d_expert=F, num_experts=E, top_k=K, capacity_factor=cf,
                num_shared=2 if d_shared else 0, d_shared=d_shared)
    params, x = worker.inputs(D, E, F, d_shared, B, S, router, seed=len(name))
    return spec, params, x


def _jax(params):
    return jax.tree.map(jnp.asarray, params)


def _torch(params):
    return jax.tree.map(torch.from_numpy, params)


def _ref_routing(pj, s, x, G, C):
    """The reference's top-k experts and kept choices (G, Tg, K), by its own
    operations (``_apply_moe_reference``'s routing and slot positions)."""
    B, S, D = x.shape
    top_i, keep = jax.jit(_ref_slots, static_argnums=(1, 3, 4))(pj, s, jnp.asarray(x), G, C)
    return np.asarray(top_i), np.asarray(keep).reshape(G, B * S // G, s.top_k)


def _ref_slots(pj, s, x, G, C):
    B, S, D = x.shape
    E, K = s.num_experts, s.top_k
    Tg = B * S // G
    xg = x.reshape(G, Tg, D)
    gates = jax.nn.softmax(jnp.einsum("gtd,de->gte", xg, pj["router"]).astype(jnp.float32), -1)
    _, top_i = jax.lax.top_k(gates, K)
    flat_e = top_i.reshape(G, Tg * K)
    order = jnp.argsort(flat_e, axis=1)
    se = jnp.take_along_axis(flat_e, order, axis=1)
    seg = jax.vmap(lambda a: jnp.searchsorted(a, jnp.arange(E), side="left"))(se)
    pos = jnp.arange(Tg * K)[None, :] - jnp.take_along_axis(seg, se, axis=1)
    gi = jnp.broadcast_to(jnp.arange(G)[:, None], (G, Tg * K))
    return top_i, jnp.zeros((G, Tg * K), bool).at[gi, order].set(pos < C)


def _port_routing(pt, s, x, G, C):
    B, S, D = x.shape
    _, _, top_i = L.moe_route(pt, s, torch.from_numpy(x).reshape(G, B * S // G, D))
    return top_i.numpy(), (L.moe_slots(top_i, s.num_experts, C) < C).numpy()


def _check(y, lb, y_ref, lb_ref, record_property):
    y_ref, lb_ref = np.asarray(y_ref), float(lb_ref)
    scale = float(np.abs(y_ref).max())
    d = float(np.abs(y.numpy() - y_ref).max()) / scale
    d_lb = abs(float(lb) - lb_ref) / abs(lb_ref)
    record_property("y_gap_of_max", d)
    record_property("lb_rel_gap", d_lb)
    assert y.shape == y_ref.shape and d <= Y_TOL, d
    assert d_lb <= LB_TOL, d_lb


@pytest.mark.parametrize("name", list(CASES))
def test_grouped_path_matches_reference(name, record_property):
    spec, params, x = _case(name)
    s, js = L.MoESpec(**spec), JL.MoESpec(**spec)
    pj, pt = _jax(params), _torch(params)
    T = x.shape[0] * x.shape[1]
    G, C = L.moe_groups(s, T), L.moe_capacity(s, T // L.moe_groups(s, T))
    want_i, want_keep = _ref_routing(pj, js, x, G, C)
    got_i, got_keep = _port_routing(pt, s, x, G, C)
    assert np.array_equal(got_i, want_i)
    assert np.array_equal(got_keep, want_keep)
    if name.endswith("skewed"):
        assert not want_keep.all()  # choices are dropped
    if name == "reduced_T4_min_capacity":
        assert (G, C) == (1, 4) and want_keep.all()
    if name == "reduced_T21_one_group":
        assert G == 1
    if "T256" in name or name == "reduced_ties":
        assert G == 32 and C == 4
    y_ref, aux = jax.jit(JL._apply_moe_reference, static_argnums=1)(pj, js, jnp.asarray(x))
    y, aux_t = L.apply_moe(pt, s, torch.from_numpy(x))
    _check(y, aux_t["lb_loss"], y_ref, aux["lb_loss"], record_property)
    # serving (prefill, decode) skips the loss: the same y, no loss
    y_serve, aux_serve = L.apply_moe(pt, s, torch.from_numpy(x), with_lb=False)
    assert torch.equal(y_serve, y) and aux_serve["lb_loss"] is None


def test_ties_go_to_the_lower_expert():
    """Duplicate router columns tie three gates exactly on every token: the
    top-2 are the two lower of the three, on both sides."""
    spec, params, x = _case("reduced_ties")
    s = L.MoESpec(**spec)
    _, _, top_i = L.moe_route(_torch(params), s, torch.from_numpy(x))
    assert (top_i == torch.tensor([worker.TIED[0], worker.TIED[1]])).all()


def _jax_mesh_ctx():
    from jax.sharding import Mesh

    jmesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    return jmesh, dict(JAX_RULES, batch="data")


@pytest.mark.parametrize("name", MESH_CASES)
def test_mesh_path_matches_reference(name, mesh, record_property):
    spec, params, x = _case(name)
    s, js = L.MoESpec(**spec), JL.MoESpec(**spec)
    pj, pt = _jax(params), _torch(params)
    T = x.shape[0] * x.shape[1]
    C = L.moe_capacity(s, T)
    want_i, want_keep = _ref_routing(pj, js, x, 1, C)
    got_i, got_keep = _port_routing(pt, s, x, 1, C)
    assert np.array_equal(got_i, want_i) and np.array_equal(got_keep, want_keep)
    if name == "reduced_skewed":
        assert not want_keep.all()
    ctx = _jax_mesh_ctx()
    y_ref, aux = jax.jit(lambda p, x: JL._apply_moe_shardmap(p, js, x, ctx))(pj, jnp.asarray(x))
    rules = make_rules(mesh, "train")
    y, aux_t = L._apply_moe_mesh(pt, s, torch.from_numpy(x), (mesh, rules))
    y = y + (L.apply_mlp(pt["shared"], L.MLPSpec(s.d_model, s.d_shared, s.activation),
                         torch.from_numpy(x)) if s.num_shared else 0)
    _check(y, aux_t, y_ref, aux["lb_loss"], record_property)
    # the same through the entry point, under the mesh context
    with activation_sharding(mesh, rules):
        y2, aux2 = L.apply_moe(pt, s, torch.from_numpy(x))
        y3, aux3 = L.apply_moe(pt, s, torch.from_numpy(x), with_lb=False)
    assert torch.equal(y2, y) and torch.equal(aux2["lb_loss"], aux_t)
    assert torch.equal(y3, y) and aux3["lb_loss"] is None


def test_mesh_path_on_two_processes_equals_each_half(mesh, tmp_path):
    import torch.multiprocessing as mp

    mp.start_processes(worker.run, args=(2, str(tmp_path)), nprocs=2, join=True,
                       start_method="spawn")
    spec, params, x = worker.mesh_case()
    s, pt = L.MoESpec(**spec), _torch(params)
    rules = make_rules(mesh, "train")
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    lbs, grads = [], []
    for r, half in enumerate(np.split(x, 2)):
        router = pt["router"].clone().requires_grad_(True)
        with activation_sharding(mesh, rules):
            want, aux = L.apply_moe(dict(pt, router=router), s, torch.from_numpy(half))
        assert np.array_equal(got[r]["y"], want.detach().numpy()), r
        lbs.append(float(aux["lb_loss"].detach()))
        grads.append(torch.autograd.grad(aux["lb_loss"], router)[0].numpy())
    mean = (lbs[0] + lbs[1]) / 2
    assert lbs[0] != lbs[1]
    for g, grad in zip(got, grads):
        assert abs(float(g["lb"]) - mean) <= 1e-7 * abs(mean), (float(g["lb"]), mean)
        gap = np.abs(g["grad"] - grad).max() / np.abs(grad).max()
        assert gap <= 1e-6, gap


def test_model_axis_above_one_raises():
    """A model axis above 1, once refused, is ported: the model-axis-1 path
    refuses it (``apply_moe`` takes ``_apply_moe_tp`` there), and on a
    model axis of 2 each mode's two rank partials (``moe_rank_partial``:
    expert-parallel, ffn-parallel, replicated) summed in rank order give the
    model-axis-1 layer within 1e-6 on the same routing (the T = 4 case,
    where the capacity floor keeps every choice). The gloo meshes run in
    ``test_torch_tp_moe.py``."""
    class _Mesh:
        mesh_dim_names, shape = ("data", "model"), (1, 2)

    class _One:
        mesh_dim_names, shape = ("data", "model"), (1, 1)

    spec, params, x = _case("reduced_T4_min_capacity")
    s, p, xt = L.MoESpec(**spec), _torch(params), torch.from_numpy(x)
    with pytest.raises(ValueError, match="model"):
        L._apply_moe_mesh(p, s, xt, (_Mesh(), {"batch": "data"}))
    want, _ = L._apply_moe_mesh(p, s, xt, (_One(), {"batch": "data"}))
    if s.num_shared:
        want = want + L.apply_mlp(p["shared"], L.MLPSpec(s.d_model, s.d_shared, s.activation), xt)
    C = L.moe_capacity(s, xt.shape[0] * xt.shape[1])
    for mode, cut in (("expert", lambda w, r: w[r * (w.shape[0] // 2):(r + 1) * (w.shape[0] // 2)]),
                      ("ffn", None), ("replicated", lambda w, r: w)):
        total = torch.zeros(want.shape, dtype=torch.float32)
        for r in range(2):
            q = dict(p)
            if mode == "ffn":
                F = p["wg"].shape[2] // 2
                q.update(wg=p["wg"][..., r * F:(r + 1) * F], wu=p["wu"][..., r * F:(r + 1) * F],
                         wd=p["wd"][:, r * F:(r + 1) * F])
            else:
                q.update({k: cut(p[k], r) for k in ("wg", "wu", "wd")})
            if s.num_shared:
                n = s.d_shared // 2
                sh = p["shared"]
                q["shared"] = {"wg": sh["wg"][:, r * n:(r + 1) * n],
                               "wu": sh["wu"][:, r * n:(r + 1) * n], "wd": sh["wd"][r * n:(r + 1) * n]}
            total += L.moe_rank_partial(q, s, xt, C, mode, r, 2)[0]
        gap = float((total.to(want.dtype).float() - want.float()).abs().max())
        assert gap <= 1e-6, (mode, gap)
