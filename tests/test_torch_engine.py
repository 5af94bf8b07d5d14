"""The port's round engines against the JAX scalar engine, on the CPU.

Same data, same config, same seeds: per round, ``bytes_total`` and
``active`` exactly equal and accuracy within 5e-3; ``messages_sent`` exactly
equal; final weights within 1e-4 (float32 GEMM sums in other orders, the
bound the reference's own engines are held to). On the int8 wire the codec
rounds that float noise: it is larger than a code step of the small delta
blocks (steps of 4e-6 to 3e-5), so codes differ in many blocks, and a
weight's wire image lands a code step away now and then (on the CPU the
codes differ at 1, 2 or 4 threads, not at 8). There each weight is held to
``test_torch_churn.flip_bound``: 1e-4 plus two code steps of its block
(measured 0.48 of it, max |d| 2**-10, on one thread), and at most 1% of
them beyond 1e-4 (measured 14,176 of 2,218,050, 0.64%; churn's shorter
runs stay under 1e-4 of them). The witness that the codes are the whole
cause: with every code and scale that differs from the reference's set to
the reference's, every weight agrees within the f32 wire's 1e-4 (measured
max 2.3e-5). Also: an unknown engine
raises, the default device is CUDA and raises without one, and nothing in
the port imports JAX or the reference package. The reference is imported
only where it is run, so the cuda-marked test also runs on a GPU host
without JAX.
"""
import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import iid_split, synth_mnist  # bitwise the reference's
from repro_torch.fl import SimConfig, make_simulation
from repro_torch.fl.local_trainer import LocalTrainer
from repro_torch.kernels.ipls_aggregate import ops
from repro_torch.kernels.quantize import ops as q_ops
from repro_torch.p2p.network import LOSSY

REPO = Path(__file__).resolve().parent.parent
PERFECT_CONFIGS = [
    dict(num_agents=5, num_partitions=8, pi=2, rho=2),
    dict(num_agents=4, num_partitions=6, pi=2, rho=1),
    # more agents than partition slots: some agents own nothing
    dict(num_agents=10, num_partitions=6, pi=2, rho=2, eval_agents=3),
    dict(num_agents=6, num_partitions=5, pi=2, rho=3),
]
CHURN = {1: [(2, "offline")], 2: [(4, "leave"), (2, "online")], 3: [(5, "join"), (1, "crash")]}


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
def data():
    return synth_mnist(num_train=1500, num_test=300, seed=0)


_JAX_RUNS = {}


def _jax_run(data, kw, fresh=False):
    """The JAX scalar engine on one config, run once per module (``fresh``:
    run anew, uncached)."""
    from repro.fl import IPLSSimulation as JaxScalar
    from repro.fl import SimConfig as JaxConfig
    from repro.p2p.network import LOSSY as JAX_LOSSY

    key = repr(sorted(kw.items()))
    if fresh or key not in _JAX_RUNS:
        x_tr, y_tr, x_te, y_te = data
        if kw.get("conditions") is LOSSY:  # the reference's own LOSSY object
            kw = dict(kw, conditions=JAX_LOSSY)
        cfg = JaxConfig(**kw)
        shards = iid_split(x_tr, y_tr, cfg.num_agents, seed=0)
        sim = JaxScalar(cfg, shards, x_te, y_te)
        sim.run()
        _JAX_RUNS[key] = sim
    return _JAX_RUNS[key]


def _port_run(data, kw, engine):
    x_tr, y_tr, x_te, y_te = data
    cfg = SimConfig(engine=engine, **kw)
    shards = iid_split(x_tr, y_tr, cfg.num_agents, seed=0)
    sim = make_simulation(cfg, shards, x_te, y_te, device="cpu")
    sim.run()
    return sim


def _weights(sim):
    if hasattr(sim, "agent_weights"):
        return sim.agent_weights()
    live = [a for a, ag in sim.agents.items() if ag.live]
    return np.stack([sim.agents[a].load_model() for a in live])


def _messages(sim):
    return sim.messages_sent if hasattr(sim, "agent_weights") else sim.net.pubsub.messages_sent


def _assert_matches_jax(jsim, psim):
    for mj, mp in zip(jsim.history, psim.history, strict=True):
        assert mj["round"] == mp["round"] and mj["active"] == mp["active"]
        assert mj["bytes_total"] == mp["bytes_total"]
        np.testing.assert_allclose(mp["acc_mean"], mj["acc_mean"], atol=5e-3)
    assert _messages(psim) == jsim.net.pubsub.messages_sent
    w_p, w_j = _weights(psim), _weights(jsim)
    if psim.cfg.wire_dtype == "int8":
        from test_torch_churn import flip_bound

        spec = psim.spec
        diff = np.abs(w_p - w_j)
        assert (diff <= flip_bound(w_j, w_p, spec.offsets(), spec.sizes, 1e-4)).all()
        assert int((diff > 1e-4).sum()) <= 1e-2 * diff.size
    else:
        np.testing.assert_allclose(w_p, w_j, atol=1e-4)


@pytest.mark.parametrize("engine", ["scalar", "vectorized"])
@pytest.mark.parametrize("kw", PERFECT_CONFIGS)
def test_engines_match_jax_scalar_under_perfect(data, kw, engine):
    kw = dict(kw, rounds=4, local_iters=3)
    _assert_matches_jax(_jax_run(data, kw), _port_run(data, kw, engine))


@pytest.mark.parametrize(
    "kw",
    [
        dict(conditions=LOSSY),
        dict(wire_dtype="int8"),
        dict(conditions=LOSSY, churn=CHURN),
    ],
)
def test_scalar_engine_matches_jax_beyond_perfect(data, kw):
    """The scalar engine is the reference's numpy protocol, so lossy
    networks, the int8 wire and churn already run on it."""
    kw = dict(num_agents=5, num_partitions=6, pi=2, rho=2, rounds=4, local_iters=2, **kw)
    jsim = _jax_run(data, kw)
    psim = _port_run(data, kw, "scalar")
    _assert_matches_jax(jsim, psim)
    assert psim.net.pubsub.messages_dropped == jsim.net.pubsub.messages_dropped


def test_int8_weights_beyond_1e4_come_from_the_codes(data, monkeypatch):
    """The int8 case's weights beyond 1e-4 all come from the codes: record
    the reference's codec calls (inputs, codes, scales), run the port with
    each code and scale that differs set to the reference's (its error
    feedback taken from them), and every weight agrees within the f32
    wire's 1e-4. The calls pair up one to one: same count, same sizes."""
    import repro.core.wire as jax_wire

    from repro_torch.core import wire

    kw = dict(num_agents=5, num_partitions=6, pi=2, rho=2, rounds=4, local_iters=2,
              wire_dtype="int8")
    calls = []

    def padded(x, err):
        pad = (-x.shape[0]) % wire.BLOCK
        return np.pad(x.astype(np.float32), (0, pad)) + np.pad(err.astype(np.float32), (0, pad))

    def record(x, err, _orig=jax_wire._np_quantize):
        q, s, e = _orig(x, err)
        calls.append((padded(x, err).size, q.copy(), s.copy()))
        return q, s, e

    monkeypatch.setattr(jax_wire, "_np_quantize", record)
    jsim = _jax_run(data, kw, fresh=True)
    monkeypatch.undo()
    n_calls = [0]

    def snap(x, err, _orig=wire._np_quantize):
        q, s, e = _orig(x, err)
        xb = padded(x, err)
        size, q_ref, s_ref = calls[n_calls[0]]
        n_calls[0] += 1
        assert xb.size == size and q.shape == q_ref.shape
        if (q != q_ref).any() or (s != s_ref).any():
            q, s = q_ref.copy(), s_ref.copy()
            deq = (q.reshape(-1, wire.BLOCK).astype(np.float32) * s[:, None]).reshape(-1)
            e = (xb - deq)[: x.shape[0]]
        return q, s, e

    monkeypatch.setattr(wire, "_np_quantize", snap)
    psim = _port_run(data, kw, "scalar")
    assert n_calls[0] == len(calls)
    np.testing.assert_allclose(_weights(psim), _weights(jsim), atol=1e-4)


def _launches():
    return (
        ops.aggregate_batched.LAUNCHES, ops.aggregate_batched_q.LAUNCHES,
        q_ops.quantize.LAUNCHES, q_ops.dequantize.LAUNCHES,
    )


def test_vectorized_runs_no_kernel_on_cpu(data):
    """On the CPU the kernels take their plain versions: no launch, on the
    PERFECT f32 path and on the event-driven int8 path."""
    before = _launches()
    kw = dict(PERFECT_CONFIGS[0], rounds=1, local_iters=1)
    sim = _port_run(data, kw, "vectorized")
    assert _launches() == before
    assert sim.device_dispatches == 1
    _port_run(data, dict(kw, conditions=LOSSY, wire_dtype="int8"), "vectorized")
    assert _launches() == before


def test_unknown_engine_raises(data):
    x_tr, y_tr, x_te, y_te = data
    cfg = SimConfig(num_agents=4, rounds=2, engine="nope")
    with pytest.raises(ValueError, match="unknown engine"):
        make_simulation(cfg, iid_split(x_tr, y_tr, 4, seed=0), x_te, y_te, "cpu")


def test_default_device_is_cuda_and_raises_without_it(data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    x_tr, y_tr, x_te, y_te = data
    shards = iid_split(x_tr, y_tr, 4, seed=0)
    for engine in ("scalar", "vectorized"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_simulation(SimConfig(num_agents=4, engine=engine), shards, x_te, y_te)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalTrainer(0, x_tr, y_tr)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    bad = [
        (str(f.relative_to(REPO)), mod)
        for f in files
        for mod in _imports(f)
        if mod.split(".")[0] in {"jax", "jaxlib", "repro"}
    ]
    assert bad == []


@pytest.mark.cuda
def test_vectorized_on_cuda_matches_scalar_on_cpu(data):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on a GPU host)")
    kw = dict(PERFECT_CONFIGS[0], rounds=3, local_iters=3)
    x_tr, y_tr, x_te, y_te = data
    shards = iid_split(x_tr, y_tr, kw["num_agents"], seed=0)
    before = ops.aggregate_batched.LAUNCHES
    vsim = make_simulation(SimConfig(engine="vectorized", **kw), shards, x_te, y_te)
    vsim.run()
    assert ops.aggregate_batched.LAUNCHES == before + kw["rounds"]
    _assert_matches_jax(_port_run(data, kw, "scalar"), vsim)
