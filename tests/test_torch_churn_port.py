"""The port's batched engine under churn against the port's scalar engine,
and its windows against its rounds, on the CPU.

The scalar engine runs the reference's numpy protocol message by message;
the batched engine replays each membership-event round on it (the embedded
oracle) and runs the rounds between batched. With the local SGD in float64
(the ``float64_sgd`` fixture of tests/test_torch_int8.py), which removes the
float noise by which per-agent and batched products differ, the two agree
bit for bit: every weight, every counter every round, ``active`` and the
live ids, on both wires, one round at a time and in windows, and through
every boundary case: a rho=1 crash and its reassignment, ids that differ
from rows, a harvest deferred by a straggler, a round with every agent
offline, a memoryless rejoin, random plans of all five actions. Accuracies
agree within 1e-6 (the batched engine averages them in float32). Windows
regroup rounds and change no arithmetic: windowed runs equal per-round runs
bit for bit with float32 SGD too. On the card each window is one CUDA-graph
replay, and a graph of one span never replays in the next: the cuda-marked
test holds a windowed churn run to its per-round run bit for bit.
"""
from contextlib import contextmanager

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.api import IPLSAgent, reset_registry
from repro_torch.core.partition import PartitionSpec, PartitionTable
from repro_torch.core.wire import make_wire
from repro_torch.data import iid_split, synth_mnist
from repro_torch.fl import SimConfig, make_simulation
from repro_torch.models import mlp_mnist
from repro_torch.p2p.ipfs_sim import SimIPFS
from repro_torch.p2p.network import LOSSY, PERFECT, NetworkConditions

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
# delays of up to 7 ticks: messages stay in flight across a whole round
DEEP = NetworkConditions(loss_prob=0.2, delay_prob=0.6, max_delay_rounds=7)


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


@contextmanager
def sgd_in_float64():
    """Local SGD in float64, rounded to float32 once per round."""
    sgd = mlp_mnist.sgd_steps_flat_batched
    mlp_mnist.sgd_steps_flat_batched = (
        lambda W, X, Y, lr, iters, layout: sgd(W.double(), X.double(), Y, lr, iters, layout).float()
    )
    try:
        yield
    finally:
        mlp_mnist.sgd_steps_flat_batched = sgd


@pytest.fixture
def float64_sgd():
    with sgd_in_float64():
        yield


def run(data, engine="vectorized", device="cpu", **kw):
    x_tr, y_tr, x_te, y_te = data
    cfg = SimConfig(engine=engine, **kw)
    sim = make_simulation(
        cfg, iid_split(x_tr, y_tr, cfg.num_agents, seed=0), x_te, y_te, device=device
    )
    sim.run()
    return sim


def scalar_weights(ssim):
    ids = [a for a, ag in ssim.agents.items() if ag.live]
    return ids, np.stack([ssim.agents[a].load_model() for a in ids])


def assert_counters_equal(ssim, sim):
    for ms, mv in zip(ssim.history, sim.history, strict=True):
        assert (ms["round"], ms["active"], ms["bytes_total"]) == (
            mv["round"], mv["active"], mv["bytes_total"]
        )
    ps = ssim.net.pubsub
    assert (sim.messages_sent, sim.messages_dropped) == (ps.messages_sent, ps.messages_dropped)


def assert_bitwise_scalar(ssim, sim):
    """The batched run equals the scalar run bit for bit (float64 SGD)."""
    assert_counters_equal(ssim, sim)
    np.testing.assert_allclose(
        [h["acc_mean"] for h in sim.history], [h["acc_mean"] for h in ssim.history], atol=1e-6
    )
    ids, w_s = scalar_weights(ssim)
    assert sim.agent_ids() == ids
    w_v = sim.agent_weights()
    assert w_v.tobytes() == w_s.tobytes(), f"max |d| {np.abs(w_v - w_s).max()}"


def assert_bitwise_runs(a, b):
    """Two batched runs of one schedule: the same bits everywhere."""
    assert a.history == b.history
    assert (a.messages_sent, a.messages_dropped) == (b.messages_sent, b.messages_dropped)
    assert a.agent_ids() == b.agent_ids()
    assert a.agent_weights().tobytes() == b.agent_weights().tobytes()


@pytest.mark.parametrize("scan", [0, 3])
@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_all_actions_bitwise_vs_port_scalar(data, float64_sgd, wire, scan):
    kw = dict(BASE, wire_dtype=wire)
    ssim = run(data, "scalar", **kw)
    sim = run(data, scan_rounds=scan, **kw)
    assert_bitwise_scalar(ssim, sim)
    assert sim.messages_dropped > 0
    # the 4 event rounds replayed on the oracle, and nothing else did
    assert len(sim._seed.history) == 4
    assert sim.device_dispatches == (4 if scan else 4 * 3)  # 2 + 1 bucket a round


@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_windows_equal_rounds_bitwise(data, wire):
    """Float32 SGD: windows of 2, 3 and 8 against one round at a time. A
    window of 8 is clipped at every event round."""
    kw = dict(BASE, wire_dtype=wire)
    eager = run(data, **kw)
    for scan in (2, 3, 8):
        assert_bitwise_runs(eager, run(data, scan_rounds=scan, **kw))


@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_rho1_crash_reassignment(data, float64_sgd, wire):
    """rho=1: the crash orphans agent 1's partitions; the table hands them
    to survivors, which the re-snapshot reads with their seeded states
    (a surviving replica's value, a cached copy or zeros)."""
    kw = dict(BASE, num_agents=4, num_partitions=8, rho=1, rounds=6, seed=2,
              churn={2: [(1, "crash")]}, wire_dtype=wire)
    ssim = run(data, "scalar", **kw)
    for scan in (0, 3):
        sim = run(data, scan_rounds=scan, **kw)
        assert_bitwise_scalar(ssim, sim)
        assert sim.agent_ids() == [0, 2, 3] and (sim._rho == 1).all()


def test_perfect_f32_churn_takes_event_path(data, float64_sgd):
    """Churn sends a PERFECT f32 run onto the event path, whose fate stream
    degenerates to delivered, delay 0."""
    kw = dict(BASE, conditions=PERFECT)
    ssim = run(data, "scalar", **kw)
    sim = run(data, scan_rounds=3, **kw)
    assert sim._lossy and sim._Lu == 0 and "ring" in sim._state
    assert sim.messages_dropped == ssim.net.pubsub.messages_dropped
    assert_bitwise_scalar(ssim, sim)


def test_ids_differ_from_rows(data, float64_sgd):
    """Agent 2 leaves, agent 5 joins: rows 2-4 hold agents 3-5. Routing and
    fates keyed by the ids, dense indices by the rows."""
    kw = dict(BASE, churn={2: [(2, "leave"), (5, "join")]}, rounds=6, wire_dtype="int8")
    ssim = run(data, "scalar", **kw)
    sim = run(data, scan_rounds=2, **kw)
    assert sim.agent_ids() == [0, 1, 3, 4, 5]
    assert list(sim._ids_arr[sim._inst_owner]) == list(sim._inst_owner_id)
    assert (sim._inst_owner != sim._inst_owner_id).any()
    assert_bitwise_scalar(ssim, sim)


@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_deferred_harvest(data, float64_sgd, wire):
    """Delays past one round of ticks, and agent 3 leaves at round 2 with
    messages in flight: the next span's harvest meets a straggler whose
    sender is gone, so one more round replays on the oracle before the span
    starts, and the run still matches."""
    kw = dict(BASE, conditions=DEEP, churn={2: [(3, "leave")], 4: [(1, "offline")],
                                             5: [(1, "online")]}, wire_dtype=wire)
    ssim = run(data, "scalar", **kw)
    for scan in (0, 3):
        sim = run(data, scan_rounds=scan, **kw)
        assert_bitwise_scalar(ssim, sim)
        # 3 event rounds, and at least one round deferred
        assert len(sim._seed.history) > 3


def test_all_offline_round_stays_on_oracle(data, float64_sgd):
    """Every agent offline at round 2: no span can start (no agent trains),
    so rounds 2-3 stay on the oracle until the agents return at round 4."""
    kw = dict(BASE, churn={2: [(a, "offline") for a in range(5)],
                           4: [(a, "online") for a in range(5)]}, rounds=7)
    ssim = run(data, "scalar", **kw)
    sim = run(data, scan_rounds=2, **kw)
    assert [h["active"] for h in sim.history] == [5, 5, 0, 0, 5, 5, 5]
    assert [h["round"] for h in sim._seed.history] == [2, 3, 4]
    assert_bitwise_scalar(ssim, sim)


def test_memoryless_rejoin(data, float64_sgd):
    """memory=False: an agent back online drops its cache and fetches
    every partition again."""
    kw = dict(BASE, memory=False, wire_dtype="int8")
    ssim = run(data, "scalar", **kw)
    assert_bitwise_scalar(ssim, run(data, scan_rounds=3, **kw))


def test_export_import_round_trip():
    """``export_state`` / ``import_state`` on one agent: the state comes back
    as it went out, copied; a partition the agent does not own is ignored,
    and the pending delta buffers reset."""
    reset_registry()
    net = SimIPFS()
    spec = PartitionSpec.even(40, 4)
    table = PartitionTable(4, 2, 1)
    agent = IPLSAgent(0, net, table, spec, wire=make_wire("int8"))
    agent.init(np.arange(40, dtype=np.float32))
    owned = sorted(agent.owned)
    assert owned == [0, 1, 2, 3]
    table.join(1)  # agent 1 takes two partitions from the bootstrap agent
    for k in table.partitions_of(1):
        agent.owned.pop(k)
    kept = sorted(agent.owned)
    gone = sorted(set(owned) - set(kept))
    agent.owned[kept[0]].push_delta(np.ones(10, np.float32))
    agent.cache[gone[0]] = np.full(10, 2.0, np.float32)
    agent._delta_err[gone[0]] = np.full(10, 0.5, np.float32)
    state = agent.export_state()
    assert sorted(state["owned"]) == kept

    vals = {k: (np.full(10, float(k), np.float32), 0.25 + k, 3 + k) for k in owned}
    cache = {gone[0]: np.full(10, 7.0, np.float32)}
    derr = {k: np.full(10, 0.125 * k, np.float32) for k in owned}
    agent.import_state(vals, cache, derr)
    assert sorted(agent.owned) == kept  # the unowned partitions were ignored
    for k in kept:
        st = agent.owned[k]
        np.testing.assert_array_equal(st.value, vals[k][0])
        assert (st.eps, st.version, st.pending_n) == (vals[k][1], vals[k][2], 0)
        assert st.value is not vals[k][0]
    np.testing.assert_array_equal(agent.cache[gone[0]], cache[gone[0]])
    assert agent.cache[gone[0]] is not cache[gone[0]]
    assert sorted(agent._delta_err) == owned
    np.testing.assert_array_equal(agent._delta_err[owned[1]], derr[owned[1]])

    again = agent.export_state()
    for k in kept:
        np.testing.assert_array_equal(again["owned"][k][0], vals[k][0])
        assert again["owned"][k][1:] == vals[k][1:]
    assert again["cache"].keys() == cache.keys()
    agent.import_state(again["owned"], again["cache"], None)  # residuals untouched
    assert sorted(agent._delta_err) == owned
    reset_registry()


# ---- on the card: each window one CUDA-graph replay ----------------------
@pytest.mark.cuda
@pytest.mark.parametrize("wire", ["f32", "int8"])
def test_windowed_churn_on_cuda_equals_rounds(data, wire):
    """Three spans of 4 rounds, windows of 2, around oracle rounds 4 and 9.
    Each span captures its graph at its first window and replays it at its
    second; the re-snapshot drops the graphs of the span before (they would
    replay into that span's state tensors), so every span captures anew.
    Held to the same schedule run one round at a time on the card: the
    same bits everywhere. The device memory in use at each span's end, less
    the span's mail plane, does not grow: the dropped graphs leave nothing
    behind (nor do the captures, whose warm-up rounds share one stream)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on a GPU host)")
    kw = dict(BASE, rounds=14, wire_dtype=wire,
              churn={4: [(2, "offline")], 9: [(2, "online"), (4, "leave"), (5, "join")]})
    eager = run(data, device="cuda", **kw)
    x_tr, y_tr, x_te, y_te = data
    sim = make_simulation(SimConfig(engine="vectorized", scan_rounds=2, **kw),
                          iid_split(x_tr, y_tr, 5, seed=0), x_te, y_te, device="cuda")
    in_use = []
    for lo, hi in ((0, 4), (5, 9), (10, 14)):
        sim.run_window(lo, 2)
        (g,) = sim.graphs.values()
        assert g.graph.replays == 1  # captured in this span
        sim.run_window(lo + 2, 2)
        assert list(sim.graphs.values()) == [g] and g.graph.replays == 2
        torch.cuda.synchronize()
        in_use.append(torch.cuda.memory_allocated() - (0 if sim._mail is None else sim._mail.nbytes))
        if hi < kw["rounds"]:
            sim.run_round(hi)
    # spans 0-3 and 10-13 train the same five shards; the state planes
    # differ by at most the rows of one instance
    assert in_use[2] <= in_use[0] + 8 * 2**20, in_use
    assert sim.device_dispatches == 6 and len(sim._seed.history) == 2
    assert_bitwise_runs(eager, sim)
