"""The port's metric streams: its engines against each other and against the
JAX scalar engine, on the CPU.

Configs: the reference's tests/test_telemetry.py cases (PERFECT rho=3,
LOSSY rho=3, LOSSY rho=2 on the int8 wire: 6 agents, 3 rounds) and
``CHURN_ALL_ACTIONS`` (tests/test_torch_churn.py: offline, leave, online,
join, crash over 8 rounds) on both wires.

- Within the port, with the local SGD in float64 (which removes the float
  noise by which per-agent and batched products differ; see
  tests/test_torch_int8.py): the scalar engine, the batched engine one round
  at a time and the batched engine in windows emit byte-identical JSONL
  streams, the norm columns included, through every churn boundary. With
  ``eval_cadence`` a window's skipped rounds carry the last computed
  accuracies (the oracle round's across a boundary); every other byte is
  the scalar stream's. With float32 SGD, windows equal rounds byte for byte.
- Against the JAX scalar engine (float32 SGD on both sides): every column
  that does not depend on SGD is exact (``round``, ``active``, traffic by
  channel, drops, ``delay_hist``, ``contrib``, ``eps``, the ``*_total``
  counters); ``delta_normsq`` and ``value_normsq`` within a relative 1e-5
  (measured at most 5.6e-7); the accuracies within one test sample, and no
  accuracy differs by a sample (measured 0 of them: the two packages round
  count / n_test one float32 ulp apart). PERFECT rho=3 is held against the
  JAX scalar engine, since the reference's own engines disagree there by one
  ulp of ``value_normsq``.
- Telemetry off against on: weights and history bit for bit, each engine.
- The scalar engine's protocol trace (pid 1) equals JAX's, event for event.

The cuda-marked tests hold the card's windows (CUDA-graph replays) to its
per-round streams and its telemetry-off runs to its on runs, with the same
kernel launches.
"""
import dataclasses
import json
from contextlib import contextmanager

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import iid_split, synth_mnist
from repro_torch.fl import SimConfig, make_simulation
from repro_torch.fl import rounds as port_rounds
from repro_torch.fl import vectorized as port_vec
from repro_torch.kernels.ipls_aggregate.ops import aggregate_batched, aggregate_batched_q
from repro_torch.kernels.quantize.ops import dequantize, quantize
from repro_torch.models import mlp_mnist
from repro_torch.p2p.network import LOSSY, PERFECT
from repro_torch.telemetry import CHANNELS, ROW_KEYS

# the reference's tests/test_telemetry.py config
REF = dict(num_agents=6, num_partitions=5, pi=2, rounds=3, local_iters=2, batch_size=32,
           eval_agents=2)
CHURN_ALL_ACTIONS = {
    1: [(2, "offline")],
    3: [(4, "leave"), (2, "online")],
    4: [(5, "join")],
    6: [(1, "crash")],
}
CHURN = dict(num_agents=5, num_partitions=6, pi=2, rho=2, rounds=8, local_iters=2,
             batch_size=32, conditions=LOSSY, churn=CHURN_ALL_ACTIONS)
# (config, window size of the windowed run)
CASES = {
    "perfect-rho3": (dict(REF, conditions=PERFECT, rho=3), 2),
    "lossy-rho3": (dict(REF, conditions=LOSSY, rho=3), 2),
    "lossy-int8": (dict(REF, conditions=LOSSY, rho=2, wire_dtype="int8"), 2),
    "churn-f32": (CHURN, 3),
    "churn-int8": (dict(CHURN, wire_dtype="int8"), 3),
}
# the columns that do not depend on SGD
SGD_FREE = ("round", "active",
            *(f"{m}_{ch}" for ch in CHANNELS for m in ("msgs", "bytes", "drops")), "drops_offline", "delay_hist", "contrib", "eps", "bytes_total", "msgs_total",
            "drops_total")
NORMS = ("delta_normsq", "value_normsq")
REF_CASES = ["perfect-rho3", "lossy-rho3", "lossy-int8"]
CHURN_CASES = ["churn-f32", "churn-int8"]
# against JAX: the norms' relative tolerance, and the rows whose accuracies
# may differ by one test sample. On the int8 wire under churn the schedule
# amplifies float32 SGD noise into flipped codes (ROADMAP queue 3), which
# move the later rounds' deltas: there 1e-3 (measured 6.1e-4 for
# delta_normsq from round 4 on, 8.3e-7 for value_normsq; 1e-5 holds
# before) and two rows (measured: rounds 6 and 7, one sample each)
NORM_RTOL = {"churn-int8": 1e-3}
ACC_ROWS_OFF = {"churn-int8": 2}
N_TEST = 200


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small products, which torch's thread pool slows down when test
    processes share the cores: one thread (both sides of every comparison
    run in this process, so the CPU sums partition alike), then the pool
    back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return synth_mnist(num_train=900, num_test=N_TEST, seed=0)


@contextmanager
def sgd_in(dtype):
    """Local SGD in ``dtype`` (float64: rounded to float32 once per round)."""
    sgd = mlp_mnist.sgd_steps_flat_batched
    if dtype == "float64":
        mlp_mnist.sgd_steps_flat_batched = (
            lambda W, X, Y, lr, iters, layout:
            sgd(W.double(), X.double(), Y, lr, iters, layout).float()
        )
    try:
        yield
    finally:
        mlp_mnist.sgd_steps_flat_batched = sgd


_RUNS = {}


def port_run(data, engine="scalar", sgd="float32", device="cpu", **kw):
    """The port on one config with telemetry on unless said otherwise, run
    once per module (runs are deterministic)."""
    kw = dict(dict(telemetry=True), **kw)
    key = ("port", engine, sgd, device, repr(sorted(kw.items())))
    if key not in _RUNS:
        x_tr, y_tr, x_te, y_te = data
        cfg = SimConfig(engine=engine, **kw)
        with sgd_in(sgd):
            sim = make_simulation(cfg, iid_split(x_tr, y_tr, cfg.num_agents, seed=0), x_te, y_te,
                                  device=device)
            sim.run()
        _RUNS[key] = sim
    return _RUNS[key]


def jax_run(data, **kw):
    """The JAX scalar engine on one config, telemetry and trace on."""
    from repro.fl import SimConfig as JaxConfig
    from repro.fl import make_simulation as jax_make
    from repro.p2p.network import NetworkConditions as JaxConditions

    key = ("jax", repr(sorted(kw.items())))
    if key not in _RUNS:
        kw = dict(kw, conditions=JaxConditions(**dataclasses.asdict(kw["conditions"])))
        x_tr, y_tr, x_te, y_te = data
        cfg = JaxConfig(telemetry=True, trace=True, **kw)
        sim = jax_make(cfg, iid_split(x_tr, y_tr, cfg.num_agents, seed=0), x_te, y_te)
        sim.run()
        _RUNS[key] = sim
    return _RUNS[key]


def stream(sim):
    lines = sim.recorder.jsonl_lines()
    assert json.loads(lines[0]) == {"schema_version": 1, "meta": {}}
    return lines[1:]


def weights(sim):
    if hasattr(sim, "agent_weights"):
        return sim.agent_weights()
    return np.stack([sim.agents[a].load_model() for a, ag in sim.agents.items() if ag.live])


def assert_rows_account_for_the_counters(sim, rows):
    """Each row's totals are the engine's counters after its round; its
    channel columns add up to the change in those counters."""
    hist = sim.history
    assert [r["round"] for r in rows] == [h["round"] for h in hist]
    for i, (r, h) in enumerate(zip(rows, hist)):
        assert tuple(r) == ROW_KEYS
        assert r["bytes_total"] == h["bytes_total"] and r["active"] == h["active"]
        if i:
            prev = rows[i - 1]
            for m in ("msgs", "bytes"):
                got = sum(r[f"{m}_{ch}"] for ch in CHANNELS)
                assert got == r[f"{m}_total"] - prev[f"{m}_total"]
            assert (sum(r[f"drops_{ch}"] for ch in CHANNELS) + r["drops_offline"]
                    == r["drops_total"] - prev["drops_total"])


def carried(lines, evaluated):
    """The stream a windowed run with eval_cadence gives, from a stream
    that evaluated every round: a round outside ``evaluated`` carries the
    last evaluated round's accuracies (zeros before the first)."""
    out, last = [], None
    for line in lines:
        row = json.loads(line)
        if row["round"] in evaluated:
            last = row
        else:
            acc = {"accs": [0.0] * len(row["accs"]), "acc_mean": 0.0, "acc_std": 0.0,
                   "acc_max": 0.0} if last is None else last
            for k in ("accs", "acc_mean", "acc_std", "acc_max"):
                row[k] = acc[k]
        out.append(json.dumps(row, separators=(",", ":")))
    return out


def check_streams_within_the_port(data, case):
    """Float64 SGD: scalar, batched (one round at a time) and windowed
    streams byte for byte, through every churn boundary (a joiner's rows
    included)."""
    kw, W = CASES[case]
    sims = [port_run(data, "scalar", "float64", **kw),
            port_run(data, "vectorized", "float64", **kw),
            port_run(data, "vectorized", "float64", scan_rounds=W, **kw)]
    s, b, w = (stream(sim) for sim in sims)
    assert len(s) == kw["rounds"]
    assert s == b
    assert b == w
    assert_rows_account_for_the_counters(sims[1], [json.loads(x) for x in b])
    ps = sims[0].net.pubsub
    last = json.loads(s[-1])
    assert (last["msgs_total"], last["drops_total"]) == (ps.messages_sent, ps.messages_dropped)
    if kw.get("churn"):
        assert sims[2]._seed.history, "no round replayed on the oracle"


def check_windows_equal_rounds_with_float32_sgd(data, case):
    kw, W = CASES[case]
    b = port_run(data, "vectorized", **kw)
    w = port_run(data, "vectorized", scan_rounds=W, **kw)
    assert stream(b) == stream(w)
    assert_rows_account_for_the_counters(w, [json.loads(x) for x in stream(w)])


def check_against_the_jax_scalar_engine(data, case):
    """The port's scalar and batched streams against the JAX scalar
    engine's: SGD-free columns exact, norms within a relative 1e-5, no
    accuracy more than one test sample off (and none at all but where
    ACC_ROWS_OFF says)."""
    kw, _ = CASES[case]
    ref = [json.loads(x) for x in jax_run(data, **kw).recorder.jsonl_lines()[1:]]
    for engine, trace in (("scalar", True), ("vectorized", False)):
        rows = [json.loads(x) for x in stream(port_run(data, engine, trace=trace, **kw))]
        assert len(rows) == len(ref) == kw["rounds"]
        rows_off = 0
        for r, j in zip(rows, ref):
            for k in SGD_FREE:
                assert r[k] == j[k], (engine, r["round"], k)
            for k in NORMS:
                np.testing.assert_allclose(r[k], j[k], rtol=NORM_RTOL.get(case, 1e-5),
                                           err_msg=f"{engine} {k}")
            samples = np.abs(np.asarray(r["accs"]) - np.asarray(j["accs"])) * N_TEST
            assert samples.max() < 1.5, (engine, r["round"], r["accs"], j["accs"])
            rows_off += int(samples.max() >= 0.5)
        assert rows_off <= ACC_ROWS_OFF.get(case, 0), (engine, rows_off)


def check_scalar_protocol_trace_equals_jax(data, case):
    """The runs of `check_against_the_jax_scalar_engine`, traced: the
    protocol track event for event; the host track holds the phases."""
    kw, _ = CASES[case]
    sim = port_run(data, "scalar", trace=True, **kw)
    mine = [e for e in sim.recorder.trace.events if e["pid"] == 1]
    ref = [e for e in jax_run(data, **kw).recorder.trace.events if e["pid"] == 1]
    assert len(mine) > 100
    assert mine == ref
    assert {e["name"].split()[0] for e in mine} == {"send", "recv", "drop"}
    host = [e for e in sim.recorder.trace.events if e["pid"] == 2]
    assert {e["name"] for e in host} >= {"fetch", "train", "aggregate", "eval"}


def check_telemetry_off_changes_nothing(data, engine, scan, case):
    """Telemetry off against on (the scalar engine traced too)."""
    kw, _ = CASES[case]
    on = port_run(data, engine, scan_rounds=scan, trace=engine == "scalar", **kw)
    off = port_run(data, engine, scan_rounds=scan, telemetry=False, **kw)
    assert off.recorder is None and off.net.pubsub.telemetry is None
    assert weights(on).tobytes() == weights(off).tobytes()
    assert on.history == off.history
    assert len(on.recorder.rows) == kw["rounds"]


@pytest.mark.parametrize("case", REF_CASES)
def test_streams_byte_identical_within_the_port(data, case):
    check_streams_within_the_port(data, case)


@pytest.mark.parametrize("case", REF_CASES)
def test_windows_equal_rounds_with_float32_sgd(data, case):
    check_windows_equal_rounds_with_float32_sgd(data, case)


@pytest.mark.parametrize("case", REF_CASES)
def test_against_the_jax_scalar_engine(data, case):
    check_against_the_jax_scalar_engine(data, case)


def test_scalar_protocol_trace_equals_jax(data):
    check_scalar_protocol_trace_equals_jax(data, "lossy-rho3")


@pytest.mark.parametrize(
    "engine,scan,case",
    [("scalar", 0, "lossy-int8"), ("vectorized", 0, "lossy-int8"), ("vectorized", 2, "lossy-int8"),
     ("vectorized", 0, "perfect-rho3"), ("vectorized", 2, "perfect-rho3")],
)
def test_telemetry_off_changes_nothing(data, engine, scan, case):
    check_telemetry_off_changes_nothing(data, engine, scan, case)


# ---- on the card ------------------------------------------------------------
def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on a GPU host)")


KERNELS = (aggregate_batched, aggregate_batched_q, quantize, dequantize)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["perfect-rho3", "lossy-int8", "churn-int8"])
def test_windows_equal_rounds_on_the_card(data, case):
    """Windows replayed from CUDA graphs, with the norm metrics in the
    graph, against the same rounds run eagerly on the card: the same
    stream, byte for byte."""
    _cuda_or_skip()
    kw, W = CASES[case]
    eager = port_run(data, "vectorized", device="cuda", **kw)
    sim = port_run(data, "vectorized", device="cuda", scan_rounds=W, **kw)
    assert stream(sim) == stream(eager)
    if not kw.get("churn"):
        assert sim.graphs and all(g.mets is not None for g in sim.graphs.values())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["perfect-rho3", "lossy-int8"])
def test_telemetry_off_changes_nothing_on_the_card(data, case):
    """Telemetry off against on, windows on the card: the same weights and
    history bit for bit, the same kernel launches, and each graph records
    the same protocol kernels."""
    _cuda_or_skip()
    kw, W = CASES[case]
    x_tr, y_tr, x_te, y_te = data
    runs = {}
    for tel in (False, True):
        cfg = SimConfig(engine="vectorized", scan_rounds=W, telemetry=tel, **kw)
        sim = make_simulation(cfg, iid_split(x_tr, y_tr, cfg.num_agents, seed=0), x_te, y_te,
                              device="cuda")
        before = {fn: fn.LAUNCHES for fn in KERNELS}
        sim.run()
        runs[tel] = sim, {fn: fn.LAUNCHES - before[fn] for fn in KERNELS}
    (off, l_off), (on, l_on) = runs[False], runs[True]
    assert weights(on).tobytes() == weights(off).tobytes()
    assert on.history == off.history
    assert l_on == l_off and sum(l_on.values()) > 0
    assert [g.graph.launches for g in on.graphs.values()] == [
        g.graph.launches for g in off.graphs.values()]
    assert all(g.mets is None for g in off.graphs.values())
    assert all(g.mets is not None for g in on.graphs.values())
