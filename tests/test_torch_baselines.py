"""The port's baselines (``repro_torch.fl.run_centralized``, ``run_gossip``)
against the JAX reference on identical inputs.

Traffic is exact every round; accuracies within 5e-3 and final weights
within 1e-4 of the reference's body (transcribed here with the reference's
``LocalTrainer``), since the port batches the agents' SGD products and JAX
does not. The numpy parts are exact: the FedAvg and segment means are
bitwise ``np.mean(axis=0)``, the peer draws are the reference's draws, and
with the SGD in float64 (rounded to float32 once a round, as
``chip_smoke._float64_sgd`` does) the batched baselines equal a per-agent
loop of the port's own ``LocalTrainer.train_delta`` bit for bit.
"""
import inspect
from contextlib import contextmanager

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")  # the reference; absent on a GPU host

import repro.fl as j_fl
from repro.fl import gossip as j_gossip
from repro.fl.local_trainer import LocalTrainer as JTrainer
from repro_torch.core.partition import PartitionSpec, flatten_params
from repro_torch.data import iid_split, synth_mnist
from repro_torch.fl import centralized, gossip, run_centralized, run_gossip
from repro_torch.fl.local_trainer import LocalTrainer as TTrainer
from repro_torch.models import mlp_mnist

BASE = dict(rounds=3, local_iters=3)
W_TOL = 1e-4
ACC_TOL = 5e-3


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
    x, y, xt, yt = synth_mnist(num_train=1500, num_test=300, seed=0)
    return iid_split(x, y, 4, seed=0), xt, yt


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


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


# -- the reference's bodies, transcribed over a trainer class ---------------
def centralized_loop(Trainer, shards, xt, yt, rounds, local_iters, lr=0.1, batch_size=128,
                     seed=0, **kw):
    """``repro.fl.centralized.run_centralized``'s body; returns its history
    and the final weights."""
    w, _ = flatten_params(mlp_mnist.init_params(seed))
    trainers = [Trainer(a, x, y, lr, local_iters, batch_size, seed, **kw)
                for a, (x, y) in enumerate(shards)]
    history = []
    for rnd in range(rounds):
        deltas = np.stack([t.train_delta(w.copy()) for t in trainers])
        w = w - deltas.mean(axis=0)
        acc = trainers[0].evaluate(w, xt, yt)
        history.append({"round": rnd, "acc_mean": float(acc), "acc_std": 0.0,
                        "acc_max": float(acc),
                        "bytes_total": int((rnd + 1) * 2 * len(shards) * w.nbytes)})
    return history, w


def gossip_loop(Trainer, shards, xt, yt, rounds, local_iters, fanout=2, num_partitions=10,
                lr=0.1, batch_size=128, seed=0, **kw):
    """``repro.fl.gossip.run_gossip``'s body; returns its history and the
    final (A, N) models."""
    rng = np.random.default_rng(seed)
    n = len(shards)
    w0, _ = flatten_params(mlp_mnist.init_params(seed))
    spec = PartitionSpec.even(w0.size, num_partitions)
    offsets = spec.offsets()
    models = [w0.copy() for _ in range(n)]
    trainers = [Trainer(a, x, y, lr, local_iters, batch_size, seed, **kw)
                for a, (x, y) in enumerate(shards)]
    history, total_bytes = [], 0
    for rnd in range(rounds):
        for a in range(n):
            models[a] = models[a] - trainers[a].train_delta(models[a].copy())
        new_models = []
        for a in range(n):
            acc = models[a].copy()
            for k in range(spec.num_partitions):
                lo, hi = offsets[k], offsets[k] + spec.sizes[k]
                peers = rng.choice([p for p in range(n) if p != a], size=min(fanout, n - 1),
                                   replace=False)
                acc[lo:hi] = np.mean([models[p][lo:hi] for p in peers] + [models[a][lo:hi]],
                                     axis=0)
                total_bytes += int(models[a][lo:hi].nbytes * len(peers))
            new_models.append(acc)
        models = new_models
        accs = np.array([trainers[0].evaluate(m, xt, yt) for m in models])
        history.append({"round": rnd, "acc_mean": float(accs.mean()),
                        "acc_std": float(accs.std()), "acc_max": float(accs.max()),
                        "bytes_total": total_bytes})
    return history, np.stack(models)


def _port_last(rounds_fn, *args, **kw):
    """A port round generator run to its end: its history and last state."""
    history, state = [], None
    for h, state in rounds_fn(*args, **kw):
        history.append(h)
    return history, state.cpu().numpy()


def _check_histories(port, ref):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert p["round"] == r["round"]
        assert p["bytes_total"] == r["bytes_total"]
        assert type(p["bytes_total"]) is int
        for key in ("acc_mean", "acc_max", "acc_std"):
            assert abs(p[key] - r[key]) <= ACC_TOL, (key, p, r)


# -- against JAX --------------------------------------------------------------
def test_centralized_matches_jax(data, record_property):
    shards, xt, yt = data
    ref = j_fl.run_centralized(shards, xt, yt, **BASE)
    ref_body, w_ref = centralized_loop(JTrainer, shards, xt, yt, **BASE)
    assert ref_body == ref  # the transcription is the reference
    hist, w = _port_last(centralized._centralized_rounds, shards, xt, yt, BASE["rounds"], 0.1,
                         BASE["local_iters"], 128, 0, "cpu")
    assert hist == run_centralized(shards, xt, yt, **BASE, device="cpu")
    _check_histories(hist, ref)
    d = float(np.abs(w - w_ref).max())
    record_property("max_abs_w_diff", d)
    assert d <= W_TOL, d


@pytest.mark.parametrize("fanout", [1, 2])
def test_gossip_matches_jax(data, fanout, record_property):
    shards, xt, yt = data
    ref = j_fl.run_gossip(shards, xt, yt, fanout=fanout, **BASE)
    ref_body, w_ref = gossip_loop(JTrainer, shards, xt, yt, fanout=fanout, **BASE)
    assert ref_body == ref
    hist, w = _port_last(gossip._gossip_rounds, shards, xt, yt, BASE["rounds"], fanout, 10,
                         0.1, BASE["local_iters"], 128, 0, "cpu")
    assert hist == run_gossip(shards, xt, yt, fanout=fanout, **BASE, device="cpu")
    _check_histories(hist, ref)
    d = float(np.abs(w - w_ref).max())
    record_property("max_abs_w_diff", d)
    assert d <= W_TOL, d


# -- the numpy parts, exactly -------------------------------------------------
def _rows(A, N, seed):
    rng = np.random.default_rng(seed)
    D = (rng.standard_normal((A, N)) * rng.uniform(1e-3, 10.0, (A, 1))).astype(np.float32)
    # signed zeros: columns of -0 only (numpy's sum of them is +0) and of both
    D[:, :4] = -0.0
    D[:, 4:8] = np.where(rng.random((A, 4)) < 0.5, -0.0, 0.0)
    return D


@pytest.mark.parametrize("A", [3, 10, 100])
def test_fedavg_mean_is_numpy_mean_bitwise(A):
    D = _rows(A, 4099, A)
    got = centralized.mean_rows(torch.from_numpy(D).unbind(0)).numpy()
    assert np.array_equal(_bits(got), _bits(D.mean(axis=0)))


@pytest.mark.parametrize("A", [3, 10, 100])
@pytest.mark.parametrize("fanout", [1, 2, 5])
def test_segment_mean_is_numpy_mean_bitwise(A, fanout):
    """The pull over all partitions against the reference's per-agent loop
    on the same pre-pull models and peers."""
    models = _rows(A, 1003, A + fanout)
    spec = PartitionSpec.even(models.shape[1], 7)
    peers = gossip.draw_peers(np.random.default_rng(fanout), A, spec.num_partitions, fanout)
    want = models.copy()
    for a in range(A):
        for k, (lo, s) in enumerate(zip(spec.offsets(), spec.sizes)):
            want[a, lo : lo + s] = np.mean(
                [models[p][lo : lo + s] for p in peers[a, k]] + [models[a][lo : lo + s]], axis=0
            )
    got = gossip.pull_segments(torch.from_numpy(models), torch.from_numpy(peers), spec).numpy()
    assert np.array_equal(_bits(got), _bits(want))


def test_peer_draws_are_the_reference_draws(data, monkeypatch):
    """The reference run's own ``rng.choice`` calls on peer lists, recorded,
    equal ``draw_peers`` round by round (including fanout > n - 1)."""
    shards, xt, yt = data
    for fanout in (2, 5):
        seen = []

        class Spy:
            def __init__(self, rng):
                self._rng = rng

            def choice(self, a, *args, **kw):
                out = self._rng.choice(a, *args, **kw)
                if isinstance(a, list):  # the peer draws; trainers pass an int
                    seen.append(np.asarray(out))
                return out

            def __getattr__(self, name):
                return getattr(self._rng, name)

        make = np.random.default_rng
        monkeypatch.setattr(j_gossip.np.random, "default_rng", lambda *a: Spy(make(*a)))
        j_gossip.run_gossip(shards, xt, yt, rounds=2, fanout=fanout, num_partitions=5,
                            local_iters=1)
        monkeypatch.undo()
        n, F = len(shards), min(fanout, len(shards) - 1)
        rng = np.random.default_rng(0)
        want = np.stack([gossip.draw_peers(rng, n, 5, fanout) for _ in range(2)])
        assert want.shape == (2, n, 5, F)
        assert np.array_equal(np.stack(seen).reshape(want.shape), want)


def test_batched_equals_a_per_agent_port_loop_without_sgd_noise(data):
    """Float64 SGD: the batched baselines equal the reference's per-agent
    loop run with the port's LocalTrainer, bit for bit (weights and
    history)."""
    shards, xt, yt = data
    with sgd_in_float64():
        want_h, want_w = centralized_loop(TTrainer, shards, xt, yt, **BASE, device="cpu")
        hist, w = _port_last(centralized._centralized_rounds, shards, xt, yt, BASE["rounds"],
                             0.1, BASE["local_iters"], 128, 0, "cpu")
        assert np.array_equal(_bits(w), _bits(want_w))
        assert hist == want_h
        for fanout in (1, 2):
            want_h, want_w = gossip_loop(TTrainer, shards, xt, yt, fanout=fanout, **BASE,
                                         device="cpu")
            hist, w = _port_last(gossip._gossip_rounds, shards, xt, yt, BASE["rounds"], fanout,
                                 10, 0.1, BASE["local_iters"], 128, 0, "cpu")
            assert np.array_equal(_bits(w), _bits(want_w))
            assert hist == want_h


def test_uneven_shards_train_in_two_buckets():
    """Shards below the batch size of two sizes: two SGD buckets, each
    agent still on its own stream (float64 SGD, against the port loop)."""
    x, y, xt, yt = synth_mnist(num_train=203, num_test=50, seed=1)
    shards = iid_split(x, y, 4, seed=0)  # 51, 51, 51, 50 rows; batch 51 vs 50
    with sgd_in_float64():
        want_h, want_w = centralized_loop(TTrainer, shards, xt, yt, rounds=2, local_iters=2,
                                          batch_size=64, device="cpu")
        hist, w = _port_last(centralized._centralized_rounds, shards, xt, yt, 2, 0.1, 2, 64, 0,
                             "cpu")
    assert np.array_equal(_bits(w), _bits(want_w))
    assert hist == want_h


@pytest.mark.parametrize("fn", [run_centralized, run_gossip])
def test_device_defaults_to_cuda_and_raises_without_one(data, fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        return
    shards, xt, yt = data
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(shards, xt, yt, rounds=1)
