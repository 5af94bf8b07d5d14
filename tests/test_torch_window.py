"""The port's multi-round windows (``scan_rounds=W``) against its per-round
engine and the JAX engines, on the CPU.

The cases of the reference's ``tests/test_scan.py``, PERFECT and LOSSY, on
both packages. A window regroups rounds and changes no arithmetic, so within
the port every window size gives the per-round run's bits: weights, every
accuracy and every counter, every round. Against the JAX scalar engine and
the JAX windowed engine: traffic counters exact every round, accuracy within
5e-3, weights within 1e-4 (float32 GEMM sums in other orders, the bound of
tests/test_torch_engine.py). On the card each window is one CUDA-graph
replay; the cuda-marked tests hold it to the eager rounds bit for bit.
"""
import dataclasses
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import iid_split, synth_mnist
from repro_torch.fl import SimConfig, make_simulation
from repro_torch.fl.local_trainer import LocalTrainer
from repro_torch.kernels.ipls_aggregate.ops import aggregate_batched, aggregate_batched_q
from repro_torch.kernels.quantize.ops import dequantize, quantize
from repro_torch.models import mlp_mnist
from repro_torch.p2p.network import LOSSY, NetworkConditions

NETS = [
    pytest.param({}, id="perfect"),
    pytest.param(dict(conditions=LOSSY, seed=1), id="lossy"),
]
BASE = dict(num_agents=5, num_partitions=8, pi=2, rho=2, rounds=8, local_iters=3)
TAIL = dict(num_agents=4, num_partitions=6, pi=2, rho=2, rounds=7, local_iters=3)
DEEP = dict(
    num_agents=4, num_partitions=6, pi=2, rho=2, rounds=8, local_iters=3, seed=9,
    conditions=NetworkConditions(loss_prob=0.2, delay_prob=0.5, max_delay_rounds=6),
)
# the int8 wire on the configs of tests/test_torch_int8.py
INT8 = dict(
    num_agents=4, num_partitions=4, pi=2, rho=2, rounds=4, lr=0.1, local_iters=2,
    batch_size=32, eval_agents=2, seed=3, wire_dtype="int8",
)
INT8_NETS = [
    pytest.param(dict(conditions=LOSSY), id="lossy"),
    pytest.param(dict(rounds=2), id="perfect"),
]


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


_RUNS = {}


def _key(engine, kw):
    return (engine, repr(sorted(kw.items())))


def port_run(data, engine="vectorized", device="cpu", **kw):
    """The port on one config, run once per module (runs are deterministic)."""
    key = _key(engine, dict(kw, device=device))
    if key not in _RUNS:
        x_tr, y_tr, x_te, y_te = data
        cfg = SimConfig(engine=engine, **kw)
        sim = make_simulation(
            cfg, iid_split(x_tr, y_tr, cfg.num_agents, seed=0), x_te, y_te, device=device
        )
        sim.run()
        _RUNS[key] = sim
    return _RUNS[key]


def jax_run(data, engine, **kw):
    """The JAX engine on one config, run once per module."""
    from repro.fl import SimConfig as JaxConfig
    from repro.fl import make_simulation as jax_make
    from repro.p2p.network import NetworkConditions as JaxConditions

    key = _key("jax-" + engine, kw)
    if key not in _RUNS:
        if "conditions" in kw:
            kw = dict(kw, conditions=JaxConditions(**dataclasses.asdict(kw["conditions"])))
        x_tr, y_tr, x_te, y_te = data
        cfg = JaxConfig(engine=engine, **kw)
        sim = jax_make(cfg, iid_split(x_tr, y_tr, cfg.num_agents, seed=0), x_te, y_te)
        sim.run()
        _RUNS[key] = sim
    return _RUNS[key]


def weights(sim):
    if hasattr(sim, "agent_weights"):
        return sim.agent_weights()
    return np.stack([sim.agents[a].load_model() for a in sorted(sim.agents)])


def counters(sim):
    if hasattr(sim, "messages_sent"):
        return sim.messages_sent, sim.messages_dropped
    ps = sim.net.pubsub
    return ps.messages_sent, ps.messages_dropped


def assert_bitwise(a, b, evaluated=None):
    """Two port runs: weights, counters and every history entry equal bit
    for bit (``evaluated``: the rounds whose accuracies both computed; the
    others are compared by bytes only)."""
    assert weights(a).tobytes() == weights(b).tobytes()
    assert counters(a) == counters(b)
    assert len(a.history) == len(b.history)
    for ma, mb in zip(a.history, b.history):
        if evaluated is None or ma["round"] in evaluated:
            assert ma == mb
        else:
            assert ma["bytes_total"] == mb["bytes_total"]


def assert_close(ref, sim, atol_w=1e-4):
    """A port run against a JAX run: counters exact every round, accuracy
    within 5e-3, weights within ``atol_w``."""
    for mr, ms in zip(ref.history, sim.history, strict=True):
        assert mr["round"] == ms["round"] and mr["active"] == ms["active"]
        assert mr["bytes_total"] == ms["bytes_total"]
        np.testing.assert_allclose(ms["acc_mean"], mr["acc_mean"], atol=5e-3)
    assert counters(ref) == counters(sim)
    np.testing.assert_allclose(weights(sim), weights(ref), atol=atol_w)


@pytest.mark.parametrize("net", NETS)
def test_window_size_changes_no_bit(data, net):
    """scan_rounds = 0, 1, 4: the same bits, round by round."""
    base = port_run(data, scan_rounds=0, **BASE, **net)
    for W, dispatches in ((1, 8), (4, 2)):
        sim = port_run(data, scan_rounds=W, **BASE, **net)
        assert_bitwise(base, sim)
        assert sim.device_dispatches == dispatches


@pytest.mark.parametrize("net", NETS)
def test_scan8_matches_jax_scalar(data, net):
    """scan_rounds=8 against the JAX scalar engine (the pubsub oracle): the
    whole run is one device program."""
    sim = port_run(data, scan_rounds=8, **BASE, **net)
    assert sim.device_dispatches == 1
    assert_close(jax_run(data, "scalar", **BASE, **net), sim)
    if net:
        assert sim.messages_dropped > 0


@pytest.mark.parametrize("net", NETS)
def test_window_matches_jax_windowed_engine(data, net):
    """The same windows on both packages (the reference's lax.scan)."""
    kw = dict(BASE, scan_rounds=4, **net)
    ref = jax_run(data, "vectorized", **kw)
    sim = port_run(data, **kw)
    assert_close(ref, sim)
    assert sim.device_dispatches == ref.device_dispatches == 2


@pytest.mark.parametrize("net", NETS)
def test_partial_tail_window(data, net):
    """7 rounds in windows of 4: a window of 4, then a tail of 3."""
    base = port_run(data, scan_rounds=0, **TAIL, **net)
    sim = port_run(data, scan_rounds=4, **TAIL, **net)
    assert_bitwise(base, sim)
    assert sim.device_dispatches == 2


def test_deep_delay_ring(data):
    """Delays of up to 6 ticks (two rounds late): a deeper delta ring and
    value-history rings inside windows of 3."""
    base = port_run(data, scan_rounds=0, **DEEP)
    sim = port_run(data, scan_rounds=3, **DEEP)
    assert_bitwise(base, sim)
    assert sim._HD == 3
    assert_close(jax_run(data, "scalar", **DEEP), sim)


@pytest.mark.parametrize("net", NETS)
def test_eval_cadence(data, net):
    """eval_cadence=3 evaluates rounds 2, 5 and the last (7); the others
    reuse the last accuracies. Training and traffic are untouched."""
    base = port_run(data, scan_rounds=0, **BASE, **net)
    sim = port_run(data, scan_rounds=4, eval_cadence=3, **BASE, **net)
    assert_bitwise(base, sim, evaluated={2, 5, 7})
    accs = [m["acc_mean"] for m in sim.history]
    assert accs[:2] == [0.0, 0.0]  # nothing evaluated yet
    assert accs[3:5] == [accs[2]] * 2 and accs[6] == accs[5]


@pytest.mark.parametrize("net", INT8_NETS)
def test_int8_window(data, net):
    """The int8 wire in windows of 3 (LOSSY: a window and a tail of 1): bitwise
    the per-round engine, and within 1e-4 of the JAX scalar engine. (PERFECT
    runs two rounds, as in tests/test_torch_int8.py: from the third on, SGD
    float noise flips single codes, 2**-10, in both of the port's engines.)"""
    kw = dict(INT8, **net)
    base = port_run(data, scan_rounds=0, **kw)
    sim = port_run(data, scan_rounds=3, **kw)
    assert_bitwise(base, sim)
    assert sim.device_dispatches == -(-kw["rounds"] // 3)
    assert_close(jax_run(data, "scalar", **kw), sim)


def test_int8_window_equals_scalar_engine_without_sgd_noise(data, monkeypatch):
    """With the local SGD in float64 (rounded to float32 once a round, the
    fixture of tests/test_torch_int8.py), LOSSY int8 windows equal the port's
    scalar engine, the reference's numpy protocol, bit for bit."""
    sgd = mlp_mnist.sgd_steps_flat_batched
    monkeypatch.setattr(
        mlp_mnist, "sgd_steps_flat_batched",
        lambda W, X, Y, lr, iters, layout: sgd(W.double(), X.double(), Y, lr, iters, layout).float(),
    )
    x_tr, y_tr, x_te, y_te = data
    sims = []
    for engine in ("scalar", "vectorized"):
        cfg = SimConfig(engine=engine, scan_rounds=3, conditions=LOSSY, **INT8)
        sim = make_simulation(cfg, iid_split(x_tr, y_tr, 4, seed=0), x_te, y_te, device="cpu")
        sim.run()
        sims.append(sim)
    ssim, vsim = sims
    assert weights(vsim).tobytes() == weights(ssim).tobytes()
    assert counters(vsim) == counters(ssim)
    assert [h["bytes_total"] for h in vsim.history] == [h["bytes_total"] for h in ssim.history]


def test_negative_scan_rounds_raise(data):
    x_tr, y_tr, x_te, y_te = data
    cfg = SimConfig(num_agents=4, rounds=2, engine="vectorized", scan_rounds=-1)
    with pytest.raises(ValueError):
        make_simulation(cfg, iid_split(x_tr, y_tr, 4, seed=0), x_te, y_te, device="cpu")


def test_scalar_engine_ignores_scan_rounds(data):
    kw = dict(num_agents=4, num_partitions=6, rounds=3, local_iters=3)
    a = port_run(data, "scalar", scan_rounds=0, **kw)
    b = port_run(data, "scalar", scan_rounds=4, **kw)
    assert weights(a).tobytes() == weights(b).tobytes()
    assert a.history == b.history


def test_draw_indices_selects_the_reference_batches(data):
    """draw_indices advances the reference trainer's stream: the rows it
    selects are the samples the reference's draw_batch returns, round after
    round, and the port's draw_batch is built on it."""
    from repro.fl.local_trainer import LocalTrainer as JaxTrainer

    x_tr, y_tr, _, _ = data
    x, y = x_tr[:300], y_tr[:300]
    for agent, bs in ((0, 128), (3, 32), (7, 500)):
        ref = JaxTrainer(agent, x, y, batch_size=bs, seed=2)
        idx = LocalTrainer(agent, x, y, batch_size=bs, seed=2, device="cpu")
        port = LocalTrainer(agent, x, y, batch_size=bs, seed=2, device="cpu")
        for _ in range(3):
            xr, yr = ref.draw_batch()
            sel = idx.draw_indices()
            xp, yp = port.draw_batch()
            assert len(sel) == min(bs, len(x))
            np.testing.assert_array_equal(x[sel], xr)
            np.testing.assert_array_equal(y[sel], yr)
            np.testing.assert_array_equal(xp, xr)
            np.testing.assert_array_equal(yp, yr)


# ---- on the card: each window one CUDA-graph replay ----------------------
def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on a GPU host)")


# the kernels of a device round, by the symbol of the CUDA kernel each launches
KERNELS = {
    aggregate_batched: "ipls_aggregate_batched_kernel",
    aggregate_batched_q: "ipls_aggregate_batched_q_kernel",
    quantize: "quantize_kernel",
    dequantize: "dequantize_kernel",
}


def _launches():
    return {fn: fn.LAUNCHES for fn in KERNELS}


def _replayed_kernels(graph):
    """The kernels one replay of ``graph`` runs on the card, counted by
    symbol in a profile of the replay. A profile can lose its first device
    events late in a process, so it starts with 512 throwaway spin kernels
    of about 10 us each, left out of the count (one of them must have been
    kept). 32 were too few once the ``-m cuda`` run had more graph tests
    before this one: on an H100 the ``deep`` case's profile lost all 32."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        for _ in range(512):
            torch.cuda._sleep(20_000)
        torch.cuda.synchronize()
        graph.replay()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert any("spin_kernel" in n for n in names), "the profile lost its warm-up kernels"
    names = [n for n in names if "spin_kernel" not in n]
    assert names, "the profiler shows no device activity"
    return {
        fn: sum(bool(re.search(rf"(?<!\w){sym}\b", n)) for n in names)
        for fn, sym in KERNELS.items()
    }


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kw",
    [
        pytest.param(dict(TAIL, scan_rounds=4), id="perfect-tail"),
        pytest.param(dict(TAIL, scan_rounds=3, eval_cadence=2, conditions=LOSSY), id="lossy-cadence"),
        pytest.param(dict(DEEP, scan_rounds=3), id="deep"),
        pytest.param(dict(INT8, rounds=5, scan_rounds=2, conditions=LOSSY), id="int8"),
    ],
)
def test_graph_replay_matches_eager_rounds(data, kw):
    """Windows replayed from CUDA graphs against the same rounds run eagerly
    on the card: the same bits. The tail window (or a second evaluation
    pattern) captures a second graph; each replay counts the kernel
    launches its capture recorded (the kernels a profile of one replay
    shows), and the eager warm-up before each capture launches one round's
    kernels for real."""
    _cuda_or_skip()
    eager = port_run(data, device="cuda", **dict(kw, scan_rounds=0))
    before = _launches()
    sim = port_run(data, device="cuda", **kw)
    after = _launches()
    assert_bitwise(eager, sim, evaluated={m["round"] for m in sim.history
                                          if sim._do_eval(m["round"])})
    W, R = kw["scan_rounds"], kw["rounds"]
    assert sim.device_dispatches == -(-R // W)
    assert len(sim.graphs) >= 2
    assert sum(g.graph.replays for g in sim.graphs.values()) == sim.device_dispatches
    # per round: one aggregation; on the int8 wire the quantized one, the
    # delta plane quantized once and qdq_rows twice (3 quantize, 2 dequantize)
    if kw.get("wire_dtype") == "int8":
        per_round = {aggregate_batched_q: 1, quantize: 3, dequantize: 2}
    else:
        per_round = {aggregate_batched: 1}
    for (W_g, _), g in sim.graphs.items():
        assert g.graph.launches == {fn: W_g * n for fn, n in per_round.items()}
    # one eager warm-up round before each capture, then the replays
    n_rounds = len(sim.graphs) + sum(
        g.graph.replays * W_g for (W_g, _), g in sim.graphs.items()
    )
    assert {fn: after[fn] - before[fn] for fn in KERNELS} == {
        fn: per_round.get(fn, 0) * n_rounds for fn in KERNELS
    }
    # what a replay runs on the card, against what its capture recorded
    for g in sim.graphs.values():
        launches = g.graph.launches
        assert _replayed_kernels(g.graph) == {fn: launches.get(fn, 0) for fn in KERNELS}
