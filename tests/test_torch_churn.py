"""The port's batched engine under churn against the JAX engines, on the CPU.

Membership-event rounds replay on the embedded scalar oracle; the rounds
between run batched, one at a time or in windows (``scan_rounds``), after a
re-snapshot of the dense planes. The schedule of the reference's
``tests/test_vectorized.py`` (``CHURN_ALL_ACTIONS``: offline, leave, online,
join, crash) on the LOSSY network, both wires, against the JAX scalar engine
(the JAX batched engine re-jits at every boundary, which would take this
file past its time): ``round``, ``active`` and ``bytes_total`` every round,
``messages_sent``, ``messages_dropped`` and ``agent_ids()`` exactly equal;
accuracy within 5e-3; weights within 1e-4 (float32 GEMM sums in other
orders, the bound of tests/test_torch_engine.py).

On the int8 wire that SGD float noise flips a code now and then: one scale
step of the weight's 1024-block (2**-10 for weights near 0.1). Measured on
the CPU (the port on one thread): f32 6.0e-8 at both window sizes (4.5e-8
on eight threads); int8 9.8e-4 on 9 of 1,774,440 weights (11 on eight
threads), every other weight within 1e-4. The port's scalar engine, which
runs the reference's numpy protocol message by message, differs from the
JAX scalar engine by the same step on 14 weights, and with the SGD noise
removed the batched engine equals it bit for bit
(tests/test_torch_churn_port.py). So on int8 each weight is held to 1e-4
plus two code steps of its block, and at most 1e-4 of the weights may lie
beyond 1e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import iid_split, synth_mnist
from repro_torch.fl import SimConfig, make_simulation
from repro_torch.p2p.network import LOSSY

# tests/test_vectorized.py's schedule
CHURN_ALL_ACTIONS = {
    1: [(2, "offline")],
    3: [(4, "leave"), (2, "online")],
    4: [(5, "join")],
    6: [(1, "crash")],
}
BASE = dict(
    num_agents=5, num_partitions=6, pi=2, rho=2, rounds=8, local_iters=2, batch_size=32,
    seed=0, conditions=LOSSY, churn=CHURN_ALL_ACTIONS,
)
WEIGHT_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The runs here are many small products, which torch's thread pool
    slows down when several test processes share the cores: run the port
    on one thread (the float32 sums it changes are within the bounds above),
    and give the pool back afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return synth_mnist(num_train=1500, num_test=300, seed=0)


_JAX_RUNS = {}


def jax_run(data, engine="scalar", **kw):
    """The JAX engine on one config, run once per module."""
    from repro.fl import SimConfig as JaxConfig
    from repro.fl import make_simulation as jax_make
    from repro.p2p.network import NetworkConditions as JaxConditions

    key = (engine, repr(sorted(kw.items())))
    if key not in _JAX_RUNS:
        x_tr, y_tr, x_te, y_te = data
        cond = JaxConditions(**dataclasses.asdict(kw["conditions"]))
        cfg = JaxConfig(engine=engine, **dict(kw, conditions=cond))
        sim = jax_make(cfg, iid_split(x_tr, y_tr, cfg.num_agents, seed=0), x_te, y_te)
        sim.run()
        _JAX_RUNS[key] = sim
    return _JAX_RUNS[key]


def port_run(data, **kw):
    x_tr, y_tr, x_te, y_te = data
    cfg = SimConfig(engine="vectorized", **kw)
    sim = make_simulation(
        cfg, iid_split(x_tr, y_tr, cfg.num_agents, seed=0), x_te, y_te, device="cpu"
    )
    sim.run()
    return sim


def live_ids(jsim):
    if hasattr(jsim, "agent_ids"):  # the JAX batched engine
        return jsim.agent_ids()
    return [a for a, ag in jsim.agents.items() if ag.live]


def counters(jsim):
    if hasattr(jsim, "agent_ids"):  # its pubsub is current only after an oracle round
        return jsim.messages_sent, jsim.messages_dropped
    return jsim.net.pubsub.messages_sent, jsim.net.pubsub.messages_dropped


def assert_protocol_equal(jsim, sim):
    """Every traffic counter, every round's membership, the live ids."""
    for mj, mp in zip(jsim.history, sim.history, strict=True):
        assert (mj["round"], mj["active"], mj["bytes_total"]) == (
            mp["round"], mp["active"], mp["bytes_total"]
        )
        np.testing.assert_allclose(mp["acc_mean"], mj["acc_mean"], atol=5e-3)
    assert (sim.messages_sent, sim.messages_dropped) == counters(jsim)
    assert sim.messages_dropped > 0  # losses actually happened
    assert sim.agent_ids() == live_ids(jsim)


def flip_bound(w_a, w_b, offsets, sizes, base):
    """Per-weight bound between two int8-wire runs whose local SGD differs by
    float noise: ``base`` plus two code steps of the weight's 1024-block,
    2 * 2**(E - 6) for the block absmax 2**E * m (the larger of the two
    runs'). One flipped code moves a wire image by one step, or by at most
    two steps of the larger scale where the block's absmax crosses a power
    of two between the runs."""
    bound = np.empty_like(w_a)
    amax = np.maximum(np.abs(w_a), np.abs(w_b))
    for off, s in zip(offsets, sizes):
        nb = -(-int(s) // 1024)
        blk = np.zeros((amax.shape[0], nb * 1024), np.float32)
        blk[:, :s] = amax[:, off : off + s]
        bmax = blk.reshape(amax.shape[0], nb, 1024).max(axis=2)
        step = np.exp2(np.floor(np.log2(np.maximum(bmax, 2.0**-120))) - 6)
        bound[:, off : off + s] = np.repeat(2 * step, 1024, axis=1)[:, :s] + base
    return bound


def assert_weights_close(jsim, sim):
    w_j = np.stack([jsim.agents[a].load_model() for a in live_ids(jsim)])
    w_p = sim.agent_weights()
    diff = np.abs(w_p - w_j)
    if sim.cfg.wire_dtype == "int8":
        assert (diff <= flip_bound(w_j, w_p, sim._offsets, sim._sizes, WEIGHT_TOL)).all()
        assert int((diff > WEIGHT_TOL).sum()) <= 1e-4 * diff.size
    else:
        np.testing.assert_allclose(w_p, w_j, atol=WEIGHT_TOL)


@pytest.mark.parametrize("scan", [0, 3])
@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_all_actions_match_jax(data, wire, scan):
    """All five actions, one round at a time and in windows of 3: event
    rounds on the oracle, the spans between re-snapshotted, the windows
    clipped at each event (the spans are rounds 0, 2, 5 and 7, one window
    each)."""
    kw = dict(BASE, wire_dtype=wire)
    jsim = jax_run(data, **kw)
    sim = port_run(data, scan_rounds=scan, **kw)
    assert_protocol_equal(jsim, sim)
    assert_weights_close(jsim, sim)
    assert [h["active"] for h in sim.history] == [5, 4, 4, 4, 5, 5, 4, 4]
    if scan:
        # one dispatch a window; none for the 4 oracle rounds
        assert sim.device_dispatches == 4


def test_ids_differ_from_rows_match_jax(data):
    """Agent 2 leaves and agent 5 joins: the live ids are [0, 1, 3, 4, 5],
    so rows 2-4 hold agents 3-5. The routing (``(round + id) % rho``) and
    every fate draw are keyed by the id, every dense index by the row; a
    mix-up would move messages and fates, and the counters of a lossy run
    would part from the reference's."""
    kw = dict(BASE, churn={2: [(2, "leave"), (5, "join")]}, rounds=6)
    jsim = jax_run(data, **kw)
    sim = port_run(data, scan_rounds=2, **kw)
    assert live_ids(jsim) == [0, 1, 3, 4, 5]
    assert sim._ids == [0, 1, 3, 4, 5] and sim._row_of[5] == 4
    assert_protocol_equal(jsim, sim)
    assert_weights_close(jsim, sim)


def test_eval_cadence_across_boundary_matches_jax_windowed(data):
    """eval_cadence=2 in windows of 3: a round that skips evaluation reuses
    the last accuracies, and after an oracle round those are the oracle's
    (the re-snapshot refreshes them). Against the JAX windowed engine on the
    same schedule: the same rounds skip, with the same values. (The oracle's
    history averages the accuracies in float64, a reused round in float32.)"""
    kw = dict(BASE, scan_rounds=3, eval_cadence=2)
    jsim = jax_run(data, engine="vectorized", **kw)
    sim = port_run(data, **kw)
    accs_j = [h["acc_mean"] for h in jsim.history]
    accs = [h["acc_mean"] for h in sim.history]
    np.testing.assert_allclose(accs, accs_j, atol=5e-3)
    skipped = [r for r in range(kw["rounds"]) if r not in sim._replay_set and not sim._do_eval(r)]
    assert skipped == [0, 2]
    assert accs[0] == accs_j[0] == 0.0  # nothing evaluated yet
    # round 2 reuses the accuracies of the oracle's round 1
    assert accs[1] > 0
    np.testing.assert_allclose([accs[2], accs_j[2]], [accs[1], accs_j[1]], rtol=0, atol=1e-6)
    np.testing.assert_allclose(accs[2], accs_j[2], rtol=0, atol=1e-6)
    assert_protocol_equal(jsim, sim)
