"""The port's optimizers, schedules and aggregation math against the JAX
package's, on the same numpy inputs (seeded), on the CPU.

Tolerances (float32 throughout; measured max |d| in brackets):
- schedules: within 2 float32 ulps at every tested step (the same float32
  operations and true divisions; ``cos`` may round differently, measured
  1 ulp on cosine_warmup, 0 elsewhere);
- optimizers over 5 steps of the same gradients: 1e-6 absolute on
  parameters of size ~1 and on every state leaf (0.0 for sgd, momentum,
  nesterov, adam and adamw; 3.7e-9 for the clipped chain, whose norm sums
  in another order);
- aggregation: ``update_eps`` and ``aggregate_partition``'s eps bit for bit
  (0.0); the means and the decay within 1e-6 (0.0 to 6e-8).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")  # the reference; absent on a GPU host
import jax.numpy as jnp

from repro.core import aggregation as jagg
from repro.optim import optimizers as jopt
from repro.optim import schedules as jsched
from repro_torch.core import aggregation as agg
from repro_torch.optim import optimizers as opt
from repro_torch.optim import schedules as sched
from repro_torch.tree import named_leaves, tree_map

OPT_TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small products only: run torch on one thread (no numeric effect
    here), and give the pool back afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SCHEDULES = [
    ("constant", lambda m: m.constant(3e-4)),
    ("linear_warmup", lambda m: m.linear_warmup(3e-3, 7)),
    ("cosine_warmup", lambda m: m.cosine_warmup(3e-4, 3, 17)),
    ("cosine_warmup_ratio", lambda m: m.cosine_warmup(1e-2, 0, 9, min_ratio=0.3)),
]


@pytest.mark.parametrize("name,make", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedules_match_reference(name, make):
    js, ps = make(jsched), make(sched)
    worst = 0.0
    for step in range(0, 25):
        want = np.asarray(js(jnp.asarray(step, jnp.int32)))
        got = ps(torch.tensor(step, dtype=torch.int32)).numpy()
        assert got.dtype == np.float32 and got.shape == ()
        ulps = float(abs(got - want) / np.spacing(want))
        worst = max(worst, ulps)
        assert ulps <= 2, (name, step, got, want)
    print(f"{name}: max {worst} ulps")


def _tree(rng):
    """A params-like tree of float32 leaves: a dict, a nested dict and a
    per-layer list as the port's models have (the reference's stacked
    leaves unstacked)."""
    return {
        "w": rng.standard_normal((4, 3)).astype(np.float32),
        "b": {"x": rng.standard_normal((5,)).astype(np.float32)},
    }


OPTIMIZERS = [
    ("sgd", lambda m: m.sgd(0.1)),
    ("sgd_sched", lambda m: m.sgd(m_sched(m).linear_warmup(0.1, 3))),
    ("momentum", lambda m: m.momentum(0.05)),
    ("nesterov", lambda m: m.momentum(0.05, beta=0.8, nesterov=True)),
    ("adam", lambda m: m.adam(1e-2)),
    ("adamw", lambda m: m.adamw(m_sched(m).cosine_warmup(1e-2, 2, 5), wd=0.1)),
    ("adamw_clip", lambda m: m.chain_clip(m.adamw(1e-2), 0.5)),
]


def m_sched(m):
    return jsched if m is jopt else sched


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _named(tree):
    return {n: np.asarray(v) for n, v in named_leaves(tree)}


@pytest.mark.parametrize("name,make", OPTIMIZERS, ids=[o[0] for o in OPTIMIZERS])
def test_optimizer_steps_match_reference(name, make):
    rng = np.random.default_rng(7)
    params = _tree(rng)
    jo, po = make(jopt), make(opt)
    jp, pp = _j(params), _t(params)
    js, ps = jo.init(jp), po.init(pp)
    worst = 0.0
    for step in range(5):
        grads = tree_map(lambda a: (a * rng.standard_normal(a.shape)).astype(np.float32),
                         params)
        ju, js = jo.update(_j(grads), js, jp, jnp.asarray(step, jnp.int32))
        pu, ps = po.update(_t(grads), ps, pp, torch.tensor(step, dtype=torch.int32))
        jp = jax.tree.map(lambda p, u: p - u, jp, ju)
        pp = tree_map(lambda p, u: p - u, pp, pu)
        for want, got in ((_named(jp), _named(tree_map(lambda t: t.numpy(), pp))),
                          (_named(js), _named(tree_map(lambda t: t.numpy(), ps)))):
            assert want.keys() == got.keys()
            for k in want:
                d = float(np.abs(want[k] - got[k]).max()) if want[k].size else 0.0
                worst = max(worst, d)
                assert d <= OPT_TOL, (name, step, k, d)
    print(f"{name}: max |d| {worst:.3g}")


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(3)
    tree = _tree(rng)
    jn = jopt.global_norm(_j(tree))
    pn = opt.global_norm(_t(tree))
    assert abs(float(jn) - float(pn)) <= 1e-6 * float(jn)
    jc, _ = jopt.clip_by_global_norm(_j(tree), 0.5)
    pc, _ = opt.clip_by_global_norm(_t(tree), 0.5)
    for k, v in _named(jc).items():
        assert np.abs(v - _named(tree_map(lambda t: t.numpy(), pc))[k]).max() <= 1e-7
    # below the bound nothing changes
    pc, _ = opt.clip_by_global_norm(_t(tree), 1e6)
    assert all(np.array_equal(a, b) for a, b in zip(
        _named(tree).values(), _named(tree_map(lambda t: t.numpy(), pc)).values()))


def test_update_eps_bitwise():
    for alpha in (0.5, 0.3, 0.9):
        js, ps = jagg.init_eps(alpha), agg.init_eps(alpha, device="cpu")
        for r in (4.0, 2.0, 0.0, 1.0, 3.0, 51.0, 7.0, 0.0, 100.0):
            js = jagg.update_eps(js, jnp.asarray(r))
            ps = agg.update_eps(ps, torch.tensor(r))
            assert ps.eps.numpy().tobytes() == np.asarray(js.eps).tobytes(), (alpha, r)
    # a vector of partitions, with zero contributors in some
    js = jagg.EpsState(eps=jnp.ones((5,)), alpha=jnp.asarray(0.5, jnp.float32))
    ps = agg.init_eps(0.5, shape=(5,), device="cpu")
    r = np.array([3, 0, 1, 7, 2], np.float32)
    for _ in range(4):
        js, ps = jagg.update_eps(js, jnp.asarray(r)), agg.update_eps(ps, torch.from_numpy(r))
        assert ps.eps.numpy().tobytes() == np.asarray(js.eps).tobytes()


def test_masked_mean_aggregate_consensus_decay():
    rng = np.random.default_rng(0)
    d = rng.standard_normal((5, 7)).astype(np.float32)
    m = np.array([1, 0, 1, 1, 0], np.float32)
    got = agg.masked_mean(torch.from_numpy(d), torch.from_numpy(m)).numpy()
    assert np.abs(got - np.asarray(jagg.masked_mean(jnp.asarray(d), jnp.asarray(m)))).max() <= 1e-6
    zero = agg.masked_mean(torch.ones(3, 4), torch.zeros(3))
    assert float(zero.abs().max()) == 0.0

    w = rng.standard_normal((7,)).astype(np.float32)
    jw, jst = jagg.aggregate_partition(jnp.asarray(w), jnp.asarray(d), jnp.asarray(m),
                                       jagg.init_eps(0.5))
    pw, pst = agg.aggregate_partition(torch.from_numpy(w), torch.from_numpy(d),
                                      torch.from_numpy(m), agg.init_eps(0.5, device="cpu"))
    assert np.abs(pw.numpy() - np.asarray(jw)).max() <= 1e-6
    assert pst.eps.numpy().tobytes() == np.asarray(jst.eps).tobytes()

    vals = rng.standard_normal((3, 6)).astype(np.float32)
    wts = np.array([1.0, 2.0, 0.5], np.float32)
    for weights in (None, wts):
        want = jagg.replica_consensus(jnp.asarray(vals),
                                      None if weights is None else jnp.asarray(weights))
        got = agg.replica_consensus(torch.from_numpy(vals),
                                    None if weights is None else torch.from_numpy(weights))
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6

    for age in (0, 1, 2, 5):
        want = jagg.apply_staleness_decay(jnp.asarray(d), jnp.asarray(age), beta=0.7)
        got = agg.apply_staleness_decay(torch.from_numpy(d), torch.tensor(age), beta=0.7)
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6


def test_init_eps_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        agg.init_eps(0.5)
    assert agg.init_eps(0.5, device="cpu").eps.device.type == "cpu"
