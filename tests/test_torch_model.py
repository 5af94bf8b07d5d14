"""The port's MNIST MLP and local trainer against the JAX reference.

Initial weights are the same numpy draw (bitwise). Everything downstream of
a matrix product is held to a tolerance: float32 sums in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")  # the reference; absent on a GPU host
import jax.numpy as jnp

from repro.core.partition import flatten_params as j_flatten
from repro.fl.local_trainer import LocalTrainer as JTrainer
from repro.models import mlp_mnist as j_mlp
from repro_torch.data import synth_mnist
from repro_torch.fl.local_trainer import LocalTrainer as TTrainer
from repro_torch.models import mlp_mnist as t_mlp


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
    return synth_mnist(num_train=400, num_test=200, seed=0)


def test_init_params_bitwise():
    for seed in (0, 5):
        t, j = t_mlp.init_params(seed), j_mlp.init_params(seed)
        assert sorted(t) == sorted(j)
        for k in t:
            np.testing.assert_array_equal(t[k], j[k])


def _perturbed_params(seed):
    """w0 with small nonzero biases, so every parameter takes part."""
    rng = np.random.default_rng(seed)
    p = j_mlp.init_params(seed)
    for k in p:
        if k.startswith("b"):
            p[k] = (0.01 * rng.standard_normal(p[k].shape)).astype(np.float32)
    return p


def test_apply_and_loss_match(data):
    x, y = data[2], data[3]
    p = _perturbed_params(1)
    jp = jax.tree.map(jnp.asarray, p)
    tp = t_mlp.params_from_numpy(jp, "cpu")  # JAX arrays carry across as they are
    np.testing.assert_allclose(
        t_mlp.apply(tp, torch.from_numpy(x)).numpy(), np.asarray(j_mlp.apply(jp, x)), atol=1e-6
    )
    t_nll, t_acc = t_mlp.loss_and_acc(tp, torch.from_numpy(x), torch.from_numpy(y))
    j_nll, j_acc = j_mlp.loss_and_acc(jp, x, y)
    np.testing.assert_allclose(float(t_nll), float(j_nll), atol=1e-6)
    assert float(t_acc) == float(j_acc)
    assert float(t_mlp.evaluate(tp, torch.from_numpy(x), torch.from_numpy(y))) == float(
        j_mlp.evaluate(jp, x, y)
    )


def test_train_delta_matches(data):
    """One local training round from the same w_flat on the same batch
    (the draw_batch streams are identical). Measured max |delta diff| on
    this input: 3.0e-8 in both rounds (torch 2.13 CPU against jax 0.9 CPU)."""
    x, y = data[0], data[1]
    w_flat, _ = j_flatten(_perturbed_params(2))
    jt = JTrainer(3, x, y, lr=0.1, local_iters=5, batch_size=64, seed=0)
    tt = TTrainer(3, x, y, lr=0.1, local_iters=5, batch_size=64, seed=0, device="cpu")
    for _ in range(2):  # two rounds: the batch streams advance together
        dj = jt.train_delta(w_flat)
        dt = tt.train_delta(w_flat)
        assert np.abs(dj).max() > 1e-3  # the step moved the weights
        np.testing.assert_allclose(dt, dj, atol=1e-6)
    assert tt.evaluate(w_flat, data[2], data[3]) == jt.evaluate(w_flat, data[2], data[3])


def test_batched_sgd_matches_vmapped_reference(data):
    """sgd_steps_flat_batched over 3 agents against jax.vmap(sgd_steps_flat)."""
    x, y = data[0], data[1]
    rng = np.random.default_rng(9)
    flats, layout = [], None
    for s in range(3):
        v, layout = j_flatten(_perturbed_params(10 + s))
        flats.append(v)
    W = np.stack(flats)
    sel = np.stack([rng.choice(len(x), 32, replace=False) for _ in range(3)])
    X, Y = x[sel], y[sel]
    layout_t = tuple((n, tuple(s)) for n, s in layout)
    want = jax.vmap(lambda w, a, b: j_mlp.sgd_steps_flat(w, a, b, 0.1, 4, layout_t))(W, X, Y)
    got = t_mlp.sgd_steps_flat_batched(
        torch.from_numpy(W), torch.from_numpy(X), torch.from_numpy(Y), 0.1, 4, layout
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
