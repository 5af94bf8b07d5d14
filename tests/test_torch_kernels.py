"""The port's IPLS aggregation kernel module against the JAX Pallas kernel.

On the CPU the wrapper takes the kernel's plain PyTorch version, which must
equal the Pallas kernel run in interpret mode BIT FOR BIT: both sum the
contributor slots in order and apply ``w - eps*acc`` with one rounding.
"Bit for bit" compares bit patterns (``_bits``), not values: a -0 where
the other side has +0 is a different result. The
CUDA kernel itself is held against the plain version on the card
(``-m cuda``), where this file's cuda-marked test runs; JAX is imported
only by the tests that compare with it, since the GPU host has none.
"""
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.ipls_aggregate import ops, ref


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


def _inputs(K, R, N, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N)).astype(np.float32)
    d = rng.standard_normal((K, R, N)).astype(np.float32)
    m = rng.integers(0, 2, (K, R)).astype(np.float32)
    m[K // 2] = 0.0  # a zero-contributor instance must pass w through
    eps = rng.uniform(0.1, 1.0, K).astype(np.float32)
    return w, d, m, eps


def _jax_batched(w, d, m, eps):
    import jax.numpy as jnp

    from repro.kernels.ipls_aggregate.ipls_aggregate import ipls_aggregate_batched

    out = ipls_aggregate_batched(
        jnp.asarray(w), jnp.asarray(d), jnp.asarray(m), jnp.asarray(eps), interpret=True
    )
    return np.asarray(out)


def _bits(a) -> np.ndarray:
    """The float32 bit patterns of a numpy array or a tensor (-0 != +0)."""
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _port(fn, *arrays):
    return fn(*(torch.from_numpy(np.array(a, np.float32)) for a in arrays)).numpy()


@pytest.mark.parametrize("N", [256, 70001])  # 70001: ragged tail
@pytest.mark.parametrize("R", [1, 5, 11])
def test_plain_equals_pallas_interpret_bitwise(N, R):
    w, d, m, eps = _inputs(4, R, N, seed=N + R)
    got = _port(ops.aggregate_batched, w, d, m, eps)
    np.testing.assert_array_equal(_bits(got), _bits(_jax_batched(w, d, m, eps)))
    np.testing.assert_array_equal(_bits(got[2]), _bits(w[2]))


def test_plain_equals_pallas_unequal_sizes_zero_tails():
    """Partitions of unequal true size share one padded width; the zero
    tails stay exactly zero (the engine's (K_inst, R, S) layout)."""
    rng = np.random.default_rng(163)
    K, R, N = 4, 3, 5000
    sizes = [5000, 3777, 1, 4096]
    w = np.zeros((K, N), np.float32)
    d = np.zeros((K, R, N), np.float32)
    for k, s in enumerate(sizes):
        w[k, :s] = rng.standard_normal(s)
        d[k, :, :s] = rng.standard_normal((R, s))
    m = np.ones((K, R), np.float32)
    eps = rng.uniform(0.1, 1.0, K).astype(np.float32)
    got = _port(ops.aggregate_batched, w, d, m, eps)
    np.testing.assert_array_equal(_bits(got), _bits(_jax_batched(w, d, m, eps)))
    for k, s in enumerate(sizes):
        assert np.all(got[k, s:] == 0.0)


@pytest.mark.parametrize("N", [128, 70001])
@pytest.mark.parametrize("R", [1, 8])
def test_single_partition_equals_pallas_interpret_bitwise(N, R):
    """Row 2 of the kernel table, ``ipls_aggregate``: the port runs it as
    the batched kernel at K=1."""
    import jax.numpy as jnp

    from repro.kernels.ipls_aggregate.ipls_aggregate import ipls_aggregate

    w, d, m, eps = _inputs(1, R, N, seed=7 * N + R)
    m[0, 0] = 1.0
    got = _port(ops.aggregate, w[0], d[0], m[0], eps[0])
    want = ipls_aggregate(
        jnp.asarray(w[0]), jnp.asarray(d[0]), jnp.asarray(m[0]), jnp.asarray(eps[0]),
        interpret=True,
    )
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_double_rounding_tie_is_one_rounding():
    """w - eps*acc where the f64 result lands exactly on an f32 tie: a plain
    f64 computation rounds twice and lands one ulp off; fmaf, the Pallas
    kernel (interpret mode) and the plain version agree on the single
    rounding."""
    w = np.array([[1 + 2.0**-23]], np.float32)
    eps = np.array([1 + 2.0**-15], np.float32)
    acc = np.array([[[-(1 - 2.0**-15) * 2.0**-24]]], np.float32)
    m = np.ones((1, 1), np.float32)
    exact = np.float32(1 + 2.0**-23)  # exact value lies just below the tie
    twice = (w.astype(np.float64) - eps.astype(np.float64) * acc[:, 0]).astype(np.float32)
    assert twice[0, 0] == np.float32(1 + 2.0**-22)
    assert _port(ops.aggregate_batched, w, acc, m, eps)[0, 0] == exact
    assert _jax_batched(w, acc, m, eps)[0, 0] == exact


def _round_f32_exact(q: Fraction) -> np.float32:
    """Correct round-to-nearest-even of a rational to float32."""
    f = np.float32(float(q))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    best = min(abs(Fraction(float(c)) - q) for c in cands)
    ties = [c for c in cands if abs(Fraction(float(c)) - q) == best]
    return min(ties, key=lambda c: int(np.array(c).view(np.int32)) & 1)


def test_fma_f32_is_correctly_rounded():
    """fma_f32 against exact rational arithmetic, on products spread over
    40 binades below the addend (where double rounding can strike)."""
    rng = np.random.default_rng(5)
    n = 400
    a = rng.standard_normal(n).astype(np.float32)
    b = (rng.standard_normal(n) * 2.0 ** -rng.integers(0, 40, n)).astype(np.float32)
    c = rng.standard_normal(n).astype(np.float32)
    got = ref.fma_f32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = [
        _round_f32_exact(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
        for x, y, z in zip(a, b, c)
    ]
    np.testing.assert_array_equal(got, np.array(want, np.float32))


@pytest.mark.parametrize(
    "case, exc",
    [
        ("f64", TypeError),
        ("deltas_shape", ValueError),
        ("mask_shape", ValueError),
        ("eps_shape", ValueError),
        ("w_rank", ValueError),
        ("noncontiguous", ValueError),
    ],
)
def test_wrapper_rejects_bad_inputs(case, exc):
    w, d, m, eps = (torch.from_numpy(a) for a in _inputs(3, 2, 16, seed=1))
    if case == "f64":
        w = w.double()
    elif case == "deltas_shape":
        d = d[:, :, :8].contiguous()
    elif case == "mask_shape":
        m = m[:, :1].contiguous()
    elif case == "eps_shape":
        eps = eps[:2]
    elif case == "w_rank":
        w = w.reshape(-1)
    elif case == "noncontiguous":
        d = d.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(exc):
        ops.aggregate_batched(w, d, m, eps)


def test_cpu_path_launches_no_kernel():
    """A CPU tensor takes the plain version and counts no launch."""
    before = ops.aggregate_batched.LAUNCHES
    ops.aggregate_batched(*(torch.from_numpy(a) for a in _inputs(2, 3, 64, seed=2)))
    assert ops.aggregate_batched.LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(20, 51, 44361), (3, 5, 70001), (1, 1, 1)])
def test_cuda_kernel_equals_plain_bitwise(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on a GPU host)")
    w, d, m, eps = (torch.from_numpy(a).cuda() for a in _inputs(*shape, seed=sum(shape)))
    before = ops.aggregate_batched.LAUNCHES
    got = ops.aggregate_batched(w, d, m, eps)
    torch.cuda.synchronize()
    assert ops.aggregate_batched.LAUNCHES == before + 1
    want = ref.ipls_aggregate_batched_ref(w, d, m, eps)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
