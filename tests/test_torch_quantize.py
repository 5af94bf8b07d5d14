"""The port's int8 codec and quantized aggregation against the JAX package.

On the CPU each wrapper takes its kernel's plain PyTorch version, which must
equal the JAX package BIT FOR BIT on inputs made from a numpy seed: the
Pallas ``quantize``/``dequantize`` kernels in interpret mode and the numpy
wire codec (``repro.core.wire._np_quantize``), the jnp row helpers, and the
Pallas ``ipls_aggregate_batched_q`` in interpret mode. The CUDA kernels are
held against the plain versions on the card (``-m cuda``); JAX is imported
only by the tests that compare with it, since the GPU host has none.
"Bit for bit" compares bit patterns (``_bits``): the aggregation's contract
includes the sign of zero, which a comparison of values would not see.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import wire
from repro_torch.kernels.ipls_aggregate import ops as agg_ops
from repro_torch.kernels.ipls_aggregate import ref as agg_ref
from repro_torch.kernels.quantize import ops, ref

SIZES = [1, 1025, 8193, 70001]


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


def _codec_input(n: int, seed: int, subnormal: bool = True) -> tuple:
    """x and err of n values whose blocks cover the codec's edge cases:
    all-zero blocks, blocks below 2**-120 (subnormal values in them unless
    ``subnormal=False``), codes that clip at +-127 and exact .5 ties (half
    to even)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 2.0 ** rng.integers(-30, 30)).astype(np.float32)
    err = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    blocks = [x[i : i + 1024] for i in range(0, n, 1024)]
    e_blocks = [err[i : i + 1024] for i in range(0, n, 1024)]
    for b, (xb, eb) in enumerate(zip(blocks, e_blocks)):
        kind = b % 5
        if kind == 1:  # all zero, err included
            xb[:] = 0.0
            eb[:] = 0.0
        elif kind == 2:  # absmax < 2**-120: a zero block whose values ride err
            mag = rng.uniform(1.0, 2.0, len(xb)) * 2.0 ** (-140 if subnormal else -124)
            xb[:] = (mag * rng.choice([-1.0, 1.0], len(xb))).astype(np.float32)
            eb[:] = 0.0
        elif kind == 3:  # absmax just below 2: 1.999 * 64 rounds to 128, clips
            xb[:] = rng.uniform(-1.999, 1.999, len(xb)).astype(np.float32)
            xb[:2] = [1.999, -1.999][: len(xb[:2])]
            eb[:] = 0.0
        elif kind == 4:  # scale 2**-6: (k + 0.5) / 64 are exact ties
            k = rng.integers(-120, 120, len(xb))
            xb[:] = ((k + 0.5) / 64.0).astype(np.float32)
            xb[0] = 1.5  # absmax in [1, 2): scale 2**-6
            eb[:] = 0.0
    x[0 : min(n, 4)] = np.float32(0.0)
    return x, err


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


def _port_quantize(x, err):
    q, s, ne = ops.quantize(torch.from_numpy(x), torch.from_numpy(err))
    return q.numpy(), s.numpy(), ne.numpy()


@pytest.mark.parametrize("n", SIZES)
def test_quantize_equals_numpy_codec_bitwise(n):
    from repro.core.wire import _np_dequantize, _np_quantize

    x, err = _codec_input(n, seed=n)
    q, s, ne = _port_quantize(x, err)
    q_np, s_np, ne_np = _np_quantize(x, err)
    np.testing.assert_array_equal(_bits(q), _bits(q_np[:n]))
    np.testing.assert_array_equal(_bits(s), _bits(s_np))
    np.testing.assert_array_equal(_bits(ne), _bits(ne_np))
    deq = ops.dequantize(torch.from_numpy(q), torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(_bits(deq), _bits(_np_dequantize(q_np[:n], s_np)))
    # the cases really occur: zero blocks, clipped codes, ties
    if n > 4096:
        assert (s == 0).sum() >= 2 and np.abs(q).max() == 127


@pytest.mark.parametrize("n", SIZES)
def test_quantize_equals_pallas_interpret(n):
    import jax.numpy as jnp

    from repro.kernels.quantize.quantize import dequantize, quantize

    # XLA on the CPU flushes subnormals to zero, so these inputs have none
    x, err = _codec_input(n, seed=3 * n, subnormal=False)
    q, s, ne = _port_quantize(x, err)
    qj, sj, nej = quantize(jnp.asarray(x), jnp.asarray(err), interpret=True)
    np.testing.assert_array_equal(q, np.asarray(qj))
    np.testing.assert_array_equal(s, np.asarray(sj))
    # equal as values: the Pallas kernel forms the residual from the float
    # code, so where x + err is -0 its residual is +0
    np.testing.assert_array_equal(ne, np.asarray(nej))
    deq = ops.dequantize(torch.from_numpy(q), torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(deq, np.asarray(dequantize(qj, sj, interpret=True)))


def test_half_to_even_and_clipping():
    """Ties round to even; |x| just under 2**(E+1) clips to +-127."""
    x = np.zeros(1024, np.float32)
    x[:6] = np.array([1.5, 0.5, 2.5, -0.5, -1.5, 1.999], np.float32) / 64  # x / scale
    x[6] = 1.999  # block absmax: scale 2**-6
    x[7] = -1.999
    q, s, ne = _port_quantize(x, np.zeros_like(x))
    assert s[0] == 2.0**-6
    assert list(q[:8]) == [2, 0, 2, 0, -2, 2, 127, -127]
    np.testing.assert_array_equal(ne[6:8], x[6:8] - np.array([127, -127], np.float32) / 64)


def test_wire_block_constants_agree():
    from repro.core import wire as jwire
    from repro.kernels.ipls_aggregate.ipls_aggregate import QBLOCK

    assert wire.BLOCK == ref.BLOCK == jwire.BLOCK == QBLOCK == 1024


@pytest.mark.parametrize("shape", [(3, 2048), (2, 4, 1024)])
def test_row_helpers_equal_jnp_rows_bitwise(shape):
    import jax.numpy as jnp

    from repro.core import wire as jwire

    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    x[..., :1024] *= 0.0  # a zero block in every row
    err = (rng.standard_normal(shape) * 1e-4).astype(np.float32)
    q, s, ne = wire.quantize_rows(torch.from_numpy(x), torch.from_numpy(err))
    qj, sj, nej = jwire.quantize_rows(jnp.asarray(x), jnp.asarray(err))
    np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(ne.numpy(), np.asarray(nej))
    np.testing.assert_array_equal(
        wire.dequantize_rows(q, s).numpy(), np.asarray(jwire.dequantize_rows(qj, sj))
    )
    np.testing.assert_array_equal(
        wire.qdq_rows(torch.from_numpy(x)).numpy(), np.asarray(jwire.qdq_rows(jnp.asarray(x)))
    )


def _agg_q_inputs(K, R, N, seed, own_on=True):
    """Codes over the full [-127, 127], power-of-two and zero scales, a
    zero-mask instance, and (own_on=False) one instance with own_mask 0."""
    rng = np.random.default_rng(seed)
    nb = -(-N // 1024)
    w = rng.standard_normal((K, N)).astype(np.float32)
    own = rng.standard_normal((K, N)).astype(np.float32)
    q = rng.integers(-127, 128, (K, R, N)).astype(np.int8)
    q.reshape(-1)[:2] = [-127, 127]
    scales = (2.0 ** rng.integers(-20, 2, (K, R, nb))).astype(np.float32)
    scales[rng.random((K, R, nb)) < 0.2] = 0.0
    mask = rng.integers(0, 2, (K, R)).astype(np.float32)
    mask[K // 2] = 0.0
    own_mask = np.ones(K, np.float32)
    if not own_on:
        own_mask[0] = 0.0
    eps = rng.uniform(0.1, 1.0, K).astype(np.float32)
    return w, own, q, scales, mask, own_mask, eps


def _port_agg_q(*arrays):
    return agg_ops.aggregate_batched_q(*(torch.from_numpy(a) for a in arrays)).numpy()


@pytest.mark.parametrize("own_on", [True, False])
@pytest.mark.parametrize("N", [2048, 70001])
@pytest.mark.parametrize("R", [1, 5, 11])
def test_aggregate_q_plain_equals_pallas_interpret_bitwise(R, N, own_on):
    import jax.numpy as jnp

    from repro.kernels.ipls_aggregate.ipls_aggregate import ipls_aggregate_batched_q

    args = _agg_q_inputs(4, R, N, seed=R * N + own_on, own_on=own_on)
    got = _port_agg_q(*args)
    want = ipls_aggregate_batched_q(*(jnp.asarray(a) for a in args), interpret=True)
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(want)))
    w, own, _, _, _, _, eps = args
    # the zero-mask instance sums only its own delta
    np.testing.assert_array_equal(
        _bits(got[2]),
        _bits(agg_ref.fma_f32(*(torch.from_numpy(a) for a in (-eps[2:3], own[2], w[2]))).numpy()),
    )


def _signed_zero_inputs(K, R, N, seed):
    """Inputs on which the sign of zero decides the bits. Every scale is 0 but
    in the last instance, so every slot adds code * 0 * mask, a -0 for a
    negative code (nine in ten here) and a +0 otherwise, and the sum is -0
    only where every term is; w is +-0 in most lanes, so out = fma(-eps,
    acc, w) carries acc's sign. Instance 0: own_mask 0 and a negative own
    (a -0 first term), every slot masked; 1: own_mask 0, one slot unmasked;
    2: own_mask 1 and own +-0; the last: masks at random, own_mask 0, half
    its scales nonzero. Skipping a masked slot, or adding in another order
    than the slots', changes bits here."""
    rng = np.random.default_rng(seed)
    nb = -(-N // 1024)
    w = np.where(rng.random((K, N)) < 0.5, -0.0, 0.0).astype(np.float32)
    w[:, ::7] = rng.standard_normal(w[:, ::7].shape)
    own = -rng.uniform(0.5, 1.0, (K, N)).astype(np.float32)
    own[2] = np.where(rng.random(N) < 0.5, -0.0, 0.0)
    q = rng.integers(-127, 1, (K, R, N)).astype(np.int8)
    q[rng.random((K, R, N)) < 0.1] = 7
    scales = np.zeros((K, R, nb), np.float32)
    scales[-1] = np.where(rng.random((R, nb)) < 0.5, 0.0, 2.0 ** -7)
    mask = np.zeros((K, R), np.float32)
    mask[1, R // 2] = 1.0
    mask[2:] = rng.integers(0, 2, (K - 2, R))
    own_mask = np.array([0.0, 0.0] + [1.0] * (K - 3) + [0.0], np.float32)
    eps = rng.uniform(0.1, 1.0, K).astype(np.float32)
    return w, own, q, scales, mask, own_mask, eps


@pytest.mark.parametrize("N", [1024, 3000])
def test_aggregate_q_signed_zeros_plain_equals_pallas_bitwise(N):
    """R = 8, a whole slot tile of the Pallas kernel: it pads R to a multiple
    of 8 with zero slots, which add +0 and so turn an all -0 sum into +0
    where the slots proper (and the plain version) leave -0."""
    import jax.numpy as jnp

    from repro.kernels.ipls_aggregate.ipls_aggregate import ipls_aggregate_batched_q

    args = _signed_zero_inputs(4, 8, N, seed=N)
    got = _port_agg_q(*args)
    want = np.asarray(ipls_aggregate_batched_q(*(jnp.asarray(a) for a in args), interpret=True))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    zeros = got == 0
    assert np.signbit(got[zeros]).any() and (~np.signbit(got[zeros])).any()


@pytest.mark.parametrize("N", [1024, 3000])
@pytest.mark.parametrize("R", [5, 6])  # 6 = 198 % 8: the main_int8 path's last slot tile
def test_aggregate_q_signed_zeros_ragged_r_vs_pallas(R, N):
    """At R % 8 != 0 the Pallas kernel pads R with zero slots, and each adds
    +0. The sums then differ in one known place. Take a lane where w is -0 and
    every real term (the own term and every slot's) is -0. The plain version
    (and the CUDA kernel) sums to -0 and gives fma(-eps, -0, -0) = +0. The
    Pallas kernel sums to +0 and gives -0 - eps*(+0) = -0. Every other lane
    is equal bit for bit."""
    import jax.numpy as jnp

    from repro.kernels.ipls_aggregate.ipls_aggregate import ipls_aggregate_batched_q

    args = _signed_zero_inputs(4, R, N, seed=N + R)
    w, own, q, scales, mask, own_mask, _ = args
    got = np.ascontiguousarray(_port_agg_q(*args)).view(np.uint32)
    want = np.asarray(ipls_aggregate_batched_q(*(jnp.asarray(a) for a in args), interpret=True))
    want = np.ascontiguousarray(want).view(np.uint32)
    lane_scales = np.repeat(scales, 1024, axis=2)[..., :N]  # (K, R, N)
    terms = [own_mask[:, None] * own] + [
        mask[:, r, None] * (q[:, r].astype(np.float32) * lane_scales[:, r]) for r in range(R)]
    minus_zero = [(t == 0) & np.signbit(t) for t in terms]
    known = np.logical_and.reduce(minus_zero) & (w == 0) & np.signbit(w)
    assert known.any()
    np.testing.assert_array_equal(got[~known], want[~known])
    assert (got[known] == 0).all() and (want[known] == 0x80000000).all()


@pytest.mark.parametrize(
    "fn, case, exc",
    [
        ("quantize", "dtype", TypeError),
        ("quantize", "device", ValueError),
        ("quantize", "noncontiguous", ValueError),
        ("quantize", "err_shape", ValueError),
        ("dequantize", "dtype", TypeError),
        ("dequantize", "device", ValueError),
        ("dequantize", "scales_len", ValueError),
        ("aggregate_q", "dtype", TypeError),
        ("aggregate_q", "device", ValueError),
        ("aggregate_q", "noncontiguous", ValueError),
        ("aggregate_q", "scales_len", ValueError),
    ],
)
def test_wrappers_reject_bad_inputs(fn, case, exc):
    x = torch.randn(3000)
    err = torch.zeros(3000)
    if fn == "quantize":
        wrapper, args = ops.quantize, [x, err]
        if case == "dtype":
            args[0] = x.double()
        elif case == "device":
            args[1] = err.to("meta")
        elif case == "noncontiguous":
            args[0] = torch.randn(6000)[::2]
        elif case == "err_shape":
            args[1] = err[:2999]
    elif fn == "dequantize":
        wrapper, args = ops.dequantize, list(ops.quantize(x, err)[:2])
        if case == "dtype":
            args[0] = args[0].to(torch.int16)
        elif case == "device":
            args[1] = args[1].to("meta")
        elif case == "scales_len":
            args[1] = args[1][:2]
    else:
        wrapper = agg_ops.aggregate_batched_q
        args = [torch.from_numpy(a) for a in _agg_q_inputs(3, 2, 3000, seed=1)]
        if case == "dtype":
            args[2] = args[2].to(torch.int32)
        elif case == "device":
            args[3] = args[3].to("meta")
        elif case == "noncontiguous":
            args[2] = args[2].transpose(0, 1).contiguous().transpose(0, 1)
        elif case == "scales_len":
            args[3] = args[3][:, :, :2].contiguous()
    with pytest.raises(exc):
        wrapper(*args)


def test_cpu_path_launches_no_kernel():
    """CPU tensors take the plain versions and count no launch."""
    before = (ops.quantize.LAUNCHES, ops.dequantize.LAUNCHES, agg_ops.aggregate_batched_q.LAUNCHES)
    q, s, _ = ops.quantize(torch.randn(5000), torch.zeros(5000))
    ops.dequantize(q, s)
    _port_agg_q(*_agg_q_inputs(2, 3, 5000, seed=2))
    after = (ops.quantize.LAUNCHES, ops.dequantize.LAUNCHES, agg_ops.aggregate_batched_q.LAUNCHES)
    assert after == before


@pytest.mark.parametrize("S, ptr_offset, want", [
    (45056, 0, 8), (45064, 0, 8), (45060, 0, 4), (70001, 0, 1), (1, 0, 1),
    (45056, 4, 4), (45056, 2, 1),  # the codes' first element 4 or 2 bytes past 16
])
def test_choose_lanes(S, ptr_offset, want):
    """The first preferred lane count that divides S and that the codes'
    alignment allows (the float32 tensors' too, at 16 bytes)."""
    base = torch.zeros(S + 32, dtype=torch.int8)
    off = (-base.data_ptr()) % 16 + ptr_offset
    q = base[off:off + S]
    assert q.data_ptr() % 16 == ptr_offset
    assert agg_ops.choose_lanes(S, q, torch.zeros(4)) == want


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on a GPU host)")


@pytest.mark.cuda
@pytest.mark.parametrize("n", SIZES + [100 * 10 * 45056])
def test_cuda_codec_equals_plain_bitwise(n):
    _need_cuda()
    x, err = (torch.from_numpy(a).cuda() for a in _codec_input(n, seed=n))
    before = (ops.quantize.LAUNCHES, ops.dequantize.LAUNCHES)
    q, s, ne = ops.quantize(x, err)
    deq = ops.dequantize(q, s)
    torch.cuda.synchronize()
    assert (ops.quantize.LAUNCHES, ops.dequantize.LAUNCHES) == (before[0] + 1, before[1] + 1)
    q_r, s_r, ne_r = ref.quantize(x, err)
    assert torch.equal(q, q_r) and torch.equal(s, s_r)
    assert torch.equal(ne.view(torch.int32), ne_r.view(torch.int32))
    assert torch.equal(deq.view(torch.int32), ref.dequantize(q_r, s_r).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(20, 198, 45056), (3, 5, 70001), (7, 11, 1)])
def test_cuda_aggregate_q_equals_plain_bitwise(shape):
    _need_cuda()
    args = [torch.from_numpy(a).cuda() for a in _agg_q_inputs(*shape, seed=sum(shape), own_on=False)]
    before = agg_ops.aggregate_batched_q.LAUNCHES
    got = agg_ops.aggregate_batched_q(*args)
    torch.cuda.synchronize()
    assert agg_ops.aggregate_batched_q.LAUNCHES == before + 1
    want = agg_ref.ipls_aggregate_batched_q_ref(*args)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 15, 16, 17, 1023, 1024, 1025, 4104, 45060, 70001])
@pytest.mark.parametrize("R", [1, 5])
def test_cuda_aggregate_q_lane_edges_bitwise(S, R):
    """Every lane width the wrapper picks (8 at S = 16, 1024, 4104; 4 at
    45060; 1 elsewhere), R = 1, and the all-masked instance (K // 2)."""
    _need_cuda()
    args = [torch.from_numpy(a).cuda() for a in _agg_q_inputs(5, R, S, seed=S + R, own_on=False)]
    got = agg_ops.aggregate_batched_q(*args)
    want = agg_ref.ipls_aggregate_batched_q_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("R", [5, 8])
@pytest.mark.parametrize("N", [1024, 45056, 45060, 45057])
def test_cuda_aggregate_q_signed_zeros_bitwise(N, R):
    """The signed-zero inputs at each lane width the wrapper picks (8 at N =
    1024 and 45056, 4 at 45060, 1 at 45057): the kernel against the plain
    version, bit for bit."""
    _need_cuda()
    args = [torch.from_numpy(a).cuda() for a in _signed_zero_inputs(4, R, N, seed=N + R)]
    got = agg_ops.aggregate_batched_q(*args)
    want = agg_ref.ipls_aggregate_batched_q_ref(*args)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (N, R)
