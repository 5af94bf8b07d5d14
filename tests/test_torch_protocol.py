"""The port's numpy protocol layer against the reference, bit for bit.

Partition tables, the fate stream and pub/sub traffic counters, the wire
codecs, the synthetic data and splits, and the per-agent batch streams are
host code with no framework arithmetic in them: the port's copies must give
exactly the reference's values.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference; absent on a GPU host

from repro.core import partition as j_partition
from repro.core import wire as j_wire
from repro.data import dirichlet_split as j_dirichlet
from repro.data import iid_split as j_iid
from repro.data import synth_mnist as j_synth
from repro.fl import rounds as j_rounds
from repro.fl.local_trainer import LocalTrainer as JTrainer
from repro.p2p import ipfs_sim as j_ipfs
from repro.p2p import network as j_network
from repro_torch.core import partition as t_partition
from repro_torch.core import wire as t_wire
from repro_torch.data import dirichlet_split as t_dirichlet
from repro_torch.data import iid_split as t_iid
from repro_torch.data import synth_mnist as t_synth
from repro_torch.fl import rounds as t_rounds
from repro_torch.fl.local_trainer import LocalTrainer as TTrainer
from repro_torch.p2p import ipfs_sim as t_ipfs
from repro_torch.p2p import network as t_network


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


def _table_trace(mod, K, pi, rho, A, events):
    t = mod.PartitionTable(K, pi, rho)
    trace = [t.bootstrap(0)]
    for a in range(1, A):
        trace.append(t.join(a))
    for kind, a in events:
        trace.append(t.leave(a) if kind == "leave" else t.fail(a))
    t.validate()
    return trace, t.as_lookup(), {a: t.partitions_of(a) for a in t.agents}


@pytest.mark.parametrize(
    "K, pi, rho, A",
    [(10, 2, 2, 100), (8, 2, 2, 5), (6, 2, 1, 4), (5, 2, 3, 6), (6, 2, 2, 10)],
)
def test_partition_tables_match(K, pi, rho, A):
    events = [("leave", 1), ("fail", A - 1)] if A > 2 else []
    assert _table_trace(t_partition, K, pi, rho, A, events) == _table_trace(
        j_partition, K, pi, rho, A, events
    )
    assert t_partition.PartitionSpec.even(443610, K).sizes == (
        j_partition.PartitionSpec.even(443610, K).sizes
    )


def test_flatten_layout_matches_and_unflatten_takes_tensors():
    import torch

    from repro.models import mlp_mnist as j_mlp
    from repro_torch.models import mlp_mnist as t_mlp

    jv, jl = j_partition.flatten_params(j_mlp.init_params(3))
    tv, tl = t_partition.flatten_params(t_mlp.init_params(3))
    assert jl == tl
    np.testing.assert_array_equal(jv, tv)
    # a (2, N) batch of flat vectors unflattens into (2, *shape) views
    W = torch.from_numpy(np.stack([tv, 2 * tv]))
    p = t_partition.unflatten_params(W, tl)
    ref = j_partition.unflatten_params(jv, jl)
    for name, _ in tl:
        np.testing.assert_array_equal(p[name][0].numpy(), ref[name])
        np.testing.assert_array_equal(p[name][1].numpy(), 2 * ref[name])
        assert p[name].data_ptr() >= W.data_ptr()  # a view, not a copy


def test_fate_stream_matches():
    key = (np.arange(7)[:, None], np.arange(5)[None, :])
    np.testing.assert_array_equal(
        t_network.hash_uniform(3, 2, *key), j_network.hash_uniform(3, 2, *key)
    )
    for cond in [t_network.LOSSY, t_network.NetworkConditions(0.4, 0.5, 6)]:
        jcond = j_network.NetworkConditions(cond.loss_prob, cond.delay_prob, cond.max_delay_rounds)
        for a, b in zip(cond.sample_stream(9, 1, 4, *key), jcond.sample_stream(9, 1, 4, *key)):
            np.testing.assert_array_equal(a, b)


def _pubsub_run(ipfs, network, rounds, keyed):
    """A random publish/send/tick/drain workload, identical for both
    packages; returns every counter and every delivered message."""
    cond = network.NetworkConditions(loss_prob=0.2, delay_prob=0.3, max_delay_rounds=2)
    ps = ipfs.PubSub(cond, seed=5)
    if keyed:
        ps.fate_source = rounds.MessageFates(cond, 5).pubsub_fate
    rng = np.random.default_rng(0)
    topics = ["ipls/update", "ipls/reply", "ipls/fetch", "ipls/replica/1", "ipls/membership"]
    for a in range(6):
        for t in topics:
            if rng.random() < 0.8:
                ps.subscribe(t, a)
    delivered = []
    for step in range(60):
        op = rng.integers(0, 5)
        a, b = (int(x) for x in rng.integers(0, 6, 2))
        topic = topics[int(rng.integers(0, len(topics)))]
        payload = (int(rng.integers(0, 4)), step)
        if op == 0:
            ps.publish(topic, a, payload, nbytes=int(rng.integers(1, 1000)))
        elif op == 1:
            ps.send(topic, a, b, payload, nbytes=int(rng.integers(1, 1000)))
        elif op == 2:
            ps.tick()
        elif op == 3:
            ps.set_offline(a, bool(rng.random() < 0.5))
        else:
            delivered += [(m.topic, m.sender, m.payload, m.sent_round) for m in ps.drain(b)]
    return (
        ps.messages_sent, ps.messages_dropped, dict(ps.bytes_sent), dict(ps.bytes_recv),
        ps.total_bytes(), delivered,
    )


@pytest.mark.parametrize("keyed", [False, True])
def test_pubsub_counters_match(keyed):
    got = _pubsub_run(t_ipfs, t_network, t_rounds, keyed)
    want = _pubsub_run(j_ipfs, j_network, j_rounds, keyed)
    assert got == want
    assert got[1] > 0  # drops happened


@pytest.mark.parametrize("n", [1, 1023, 4097, 44361])
def test_wire_codecs_match(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 2, n)).astype(np.float32)
    err = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    assert t_wire.BLOCK == j_wire.BLOCK
    for dtype in ("f32", "int8"):
        tw, jw = t_wire.make_wire(dtype), j_wire.make_wire(dtype)
        assert t_wire.wire_size(n, dtype) == j_wire.wire_size(n, dtype)
        tv, tn = tw.encode_value(x)
        jv, jn = jw.encode_value(x)
        assert tn == jn
        td, tdn, terr = tw.encode_delta(x, err)
        jd, jdn, jerr = jw.encode_delta(x, err)
        assert tdn == jdn
        for a, b in [(tv, jv), (td, jd)]:
            for pa, pb in zip(a if dtype == "int8" else [a], b if dtype == "int8" else [b]):
                np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(terr, jerr)
        np.testing.assert_array_equal(tw.decode(td), jw.decode(jd))


def test_synthetic_data_and_splits_match():
    t_data = t_synth(num_train=600, num_test=100, seed=4)
    j_data = j_synth(num_train=600, num_test=100, seed=4)
    for a, b in zip(t_data, j_data):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    x, y = t_data[0], t_data[1]
    for split_t, split_j in [(t_iid(x, y, 7, seed=2), j_iid(x, y, 7, seed=2)),
                             (t_dirichlet(x, y, 5, seed=2), j_dirichlet(x, y, 5, seed=2))]:
        assert len(split_t) == len(split_j)
        for (xt, yt), (xj, yj) in zip(split_t, split_j):
            np.testing.assert_array_equal(xt, xj)
            np.testing.assert_array_equal(yt, yj)


@pytest.mark.parametrize("n_local", [50, 300])  # below and above the batch size
def test_draw_batch_streams_match(n_local):
    x, y, _, _ = t_synth(num_train=n_local, num_test=1, seed=1)
    for agent in (0, 3):
        tt = TTrainer(agent, x, y, batch_size=128, seed=7, device="cpu")
        jt = JTrainer(agent, x, y, batch_size=128, seed=7)
        for _ in range(4):
            for a, b in zip(tt.draw_batch(), jt.draw_batch()):
                np.testing.assert_array_equal(a, b)
