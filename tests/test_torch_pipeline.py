"""The port's data pipeline and the public members the port restored,
against the JAX package: batch streams and ``synth_tokens`` bitwise, the
package exports equal as sets, and ``host_metadata(timestamp)``,
``ContentStore.has``/``__len__`` and ``core.api.register``/``lookup`` as the
reference's tests use them."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference; absent on a GPU host

import repro.data as j_data
import repro.fl as j_fl
import repro_torch.data as t_data
import repro_torch.fl as t_fl
from repro.data import pipeline as j_pipeline
from repro_torch.core import api as t_api
from repro_torch.core.partition import PartitionSpec, PartitionTable
from repro_torch.data import pipeline as t_pipeline
from repro_torch.p2p.ipfs_sim import ContentStore, SimIPFS
from repro_torch.p2p.network import PERFECT
from repro_torch.telemetry import host_metadata


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


def _xy(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((n, 5)).astype(np.float32), rng.integers(0, 10, n).astype(np.int32)


def _same_stream(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for (xa, ya), (xb, yb) in zip(a, b):
        assert xa.dtype == xb.dtype and ya.dtype == yb.dtype
        assert np.array_equal(xa, xb) and np.array_equal(ya, yb)


@pytest.mark.parametrize("n, bs, epochs", [(40, 8, 1), (43, 8, 3), (7, 8, 2), (100, 100, 2)])
def test_batch_iterator_finite_epochs_bitwise(n, bs, epochs):
    """Every full batch of each epoch's permutation; the tail (n mod bs
    rows) dropped, and nothing at all when n < bs."""
    x, y = _xy(n)
    got = list(t_pipeline.batch_iterator(x, y, bs, seed=3, epochs=epochs))
    assert len(got) == epochs * (n // bs)
    _same_stream(got, j_pipeline.batch_iterator(x, y, bs, seed=3, epochs=epochs))


def test_batch_iterator_loops_forever_without_epochs():
    x, y = _xy(43)
    take = 5 * (43 // 8) + 2  # across five epoch boundaries
    _same_stream(
        itertools.islice(t_pipeline.batch_iterator(x, y, 8, seed=1), take),
        itertools.islice(j_pipeline.batch_iterator(x, y, 8, seed=1), take),
    )


def test_federated_dataset_per_agent_streams_bitwise():
    """Shards of 30, 5 (below the batch size: clamped to 5) and 17 rows,
    agents drawn interleaved; each agent's stream seeded seed + agent."""
    shards = [_xy(30, 0), _xy(5, 1), _xy(17, 2)]
    t_ds = t_pipeline.FederatedDataset(shards, batch_size=8, seed=4)
    j_ds = j_pipeline.FederatedDataset(shards, batch_size=8, seed=4)
    assert t_ds.num_agents() == j_ds.num_agents() == 3
    order = [0, 1, 1, 2, 0, 0, 1, 2, 2, 2, 0, 1, 0, 0]
    for a in order:
        (xt, yt), (xj, yj) = t_ds.next_batch(a), j_ds.next_batch(a)
        assert len(xt) == min(8, len(shards[a][0]))
        assert np.array_equal(xt, xj) and np.array_equal(yt, yj)


@pytest.mark.parametrize("shape", [(3, 17, 50), (8, 64, 1000), (1, 1, 2)])
def test_synth_tokens_bitwise(shape):
    got = t_data.synth_tokens(*shape, seed=5)
    want = j_data.synth_tokens(*shape, seed=5)
    assert got.dtype == np.int32 and got.shape == shape[:2]
    assert np.array_equal(got, want)


@pytest.mark.parametrize("pair", [(t_fl, j_fl), (t_data, j_data)], ids=["fl", "data"])
def test_exports_equal_the_reference(pair):
    port, ref = pair
    assert set(port.__all__) == set(ref.__all__)
    for name in port.__all__:
        assert callable(getattr(port, name))


def test_host_metadata_takes_a_timestamp():
    assert host_metadata()["timestamp"] is None
    meta = host_metadata("2026-01-02T03:04:05")
    assert meta["timestamp"] == "2026-01-02T03:04:05"
    assert {"torch_version", "gpu_name", "power_limit"} <= set(meta)


def test_content_store_has_and_len():
    s = ContentStore()
    assert len(s) == 0
    cid = s.add(b"hello ipls")
    assert s.has(cid) and not s.has("0" * 64)
    assert cid == s.add(b"hello ipls")  # content-addressed: one entry
    assert len(s) == 1
    s.add(b"another")
    assert len(s) == 2


def test_terminate_uploads_into_the_store_and_registry():
    """As tests/test_dsm_api.py uses them: Terminate uploads the leaver's
    partitions (``len(net.store)``), and the registry resolves live agents
    (``register``/``lookup``)."""
    t_api.reset_registry()
    net = SimIPFS(PERFECT, seed=0)
    spec = PartitionSpec.even(600, 6)
    table = PartitionTable(6, 2, 2)
    w0 = np.arange(600, dtype=np.float32)
    agents = {}
    for a in range(3):
        agents[a] = t_api.IPLSAgent(a, net, table, spec)
        agents[a].init(w0 if a == 0 else None)
    assert [t_api.lookup(a) for a in range(3)] == [agents[0], agents[1], agents[2]]
    held = table.partitions_of(2)
    agents[2].terminate()
    assert len(net.store) >= len(held) > 0
    assert t_api.lookup(2) is None
    t_api.register(agents[2])
    assert t_api.lookup(2) is agents[2]
    t_api.reset_registry()
    assert t_api.lookup(0) is None
