"""The port's RWKV6 linear scan against the JAX package's.

On the CPU the wrapper (``ops.rwkv6_scan``) takes the plain chunked version,
``ref.rwkv6_chunked``; ``ref.rwkv6_ref`` is the step-by-step oracle. Inputs
come from a numpy seed, with log-decays drawn over the model's whole clip
range, -exp(U(-8, 4)) in [-54.6, -3.35e-4], and its two edges. Errors are
measured against the output's scale, max |want| (at least 1): float32 sums
in other orders differ by a few ulps of the largest terms, whatever the
size of one element.

- ``rwkv6_ref`` against the reference's oracle (``kernels/linear_scan/
  ref.py``): within 1e-5 of the scale (measured 2.0e-7).
- ``rwkv6_chunked`` against the reference model's ``rwkv6_chunked``
  (``models/ssm.py``), ragged T and a nonzero initial state: within 5e-5 of
  the scale (measured 1.4e-5; the pair form sums up to Q products per
  term, in another order than XLA's).
- The wrapper against the Pallas kernel in interpret mode at the shapes of
  ``tests/test_kernels.py`` (chunks of 64 on both sides): float32 within
  1e-4 of the scale (measured 3.4e-5: two pair forms of 64-step chunks,
  each about 1e-5 of the scale from a float64 result at these decays),
  bfloat16 within the reference test's 5e-2 (measured 1.7e-3).
- Any chunk length computes the same function: within 5e-5 of the scale
  of the step oracle (measured 1.7e-5).
- ``rwkv6_split_ref``, the step form in the CUDA kernel's order (16-step
  chunks, row-group partials of the readout summed in group order), against
  the JAX step oracle and the Pallas kernel in interpret mode: within
  SCAN_TOL = 3e-5 of the scale, the bound the kernel is held to on the
  card. ``_faulty_split`` shows that the bound catches a dropped row slice,
  a skipped decay and a stale step at a chunk boundary.

On the card (``-m cuda``) the CUDA kernel is held against both plain
versions: within 3e-5 of the scale in float32 (chip_smoke.py's bound;
measured 6.0e-6 there), and within one bf16 ulp more in bfloat16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.linear_scan import ops, ref

EDGES = (-np.exp(4.0), -np.exp(-8.0))  # the model's clip range of log-decays
SCAN_TOL = 3e-5  # the kernel against its plain versions (chip_smoke.py), of the scale


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


def _arrays(B, T, H, K, seed, state=True):
    """r, k, v, logw (B, T, H, K), u (H, K) and an initial state (or None),
    float32 numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, K)).astype(np.float32) for _ in range(3))
    logw = -np.exp(rng.uniform(-8.0, 4.0, (B, T, H, K))).astype(np.float32)
    logw.reshape(-1)[:2] = EDGES
    u = (rng.standard_normal((H, K)) * 0.5).astype(np.float32)
    s0 = rng.standard_normal((B, H, K, K)).astype(np.float32) if state else None
    return r, k, v, logw, u, s0


def _torch(arrs, dtype="float32"):
    """r, k, v in ``dtype``, the rest float32 (None stays None)."""
    out = [torch.from_numpy(a) if a is not None else None for a in arrs]
    out[:3] = [t.to(getattr(torch, dtype)) for t in out[:3]]
    return out


def _jax(arrs, dtype="float32"):
    import jax.numpy as jnp

    out = [jnp.asarray(a) if a is not None else None for a in arrs]
    out[:3] = [a.astype(getattr(jnp, dtype)) for a in out[:3]]
    return out


def _rel(got, want) -> float:
    """max |got - want| over the scale max(1, max |want|)."""
    g = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape
    return float(np.abs(g - w).max() / max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("B,T,H,K", [(2, 37, 2, 16), (1, 100, 1, 64), (2, 1, 2, 64)])
@pytest.mark.parametrize("state", [False, True])
def test_step_oracle_matches_jax(B, T, H, K, state):
    from repro.kernels.linear_scan.ref import rwkv6_ref

    arrs = _arrays(B, T, H, K, seed=T + state, state=state)
    jo, js = rwkv6_ref(*_jax(arrs)[:5], *_jax(arrs)[5:] if state else ())
    po, ps = ref.rwkv6_ref(*_torch(arrs))
    assert po.dtype == ps.dtype == torch.float32 and ps.shape == (B, H, K, K)
    assert _rel(po, jo) <= 1e-5 and _rel(ps, js) <= 1e-5


@pytest.mark.parametrize("T,chunk", [(1, 8), (13, 8), (37, 16), (100, 64), (64, 64)])
def test_chunked_matches_jax_model(T, chunk):
    import jax.numpy as jnp
    from repro.models.ssm import rwkv6_chunked

    arrs = _arrays(2, T, 2, 32, seed=chunk + T)
    j = _jax(arrs)
    jo, js = rwkv6_chunked(*j[:5], chunk, j[5])
    t = _torch(arrs)
    po, ps = ref.rwkv6_chunked(*t[:5], chunk, t[5])
    assert jo.dtype == jnp.float32 and po.dtype == torch.float32
    assert _rel(po, jo) <= 5e-5 and _rel(ps, js) <= 5e-5


@pytest.mark.parametrize("shape", [(1, 64, 2, 32), (2, 128, 2, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wrapper_matches_pallas_interpret(shape, dtype):
    """The reference's kernel (Q = 64, T % 64 == 0, no initial state),
    run as tests/test_kernels.py runs it."""
    from repro.kernels.linear_scan.ops import linear_scan

    arrs = _arrays(*shape, seed=sum(shape), state=False)
    for a in arrs[:3]:
        a *= 0.5  # the reference test's input scale
    want, want_s = linear_scan(*_jax(arrs, dtype)[:5], use_kernel=True, interpret=True)
    got, got_s = ops.rwkv6_scan(*_torch(arrs, dtype)[:5], chunk=64)
    assert got.dtype == getattr(torch, dtype) and got_s.dtype == torch.float32
    tol = 1e-4 if dtype == "float32" else 5e-2
    assert _rel(got, want) <= tol and _rel(got_s, want_s) <= tol


@pytest.mark.parametrize("chunk", [1, 7, 64, 500])
def test_chunk_length_does_not_change_the_function(chunk):
    arrs = _torch(_arrays(2, 100, 2, 16, seed=chunk))
    want, want_s = ref.rwkv6_ref(*arrs)
    got, got_s = ops.rwkv6_scan(*arrs[:5], chunk, arrs[5])
    assert _rel(got, want) <= 5e-5 and _rel(got_s, want_s) <= 5e-5


def test_wrapper_rounds_the_float32_result_once():
    """bf16 in: out is the plain float32 result rounded to bf16, the state
    stays float32 (the reference's y.astype(x.dtype))."""
    arrs = _torch(_arrays(2, 29, 2, 64, seed=5), "bfloat16")
    out, state = ops.rwkv6_scan(*arrs[:5], 8, arrs[5])
    o32, s32 = ref.rwkv6_chunked(*arrs[:5], 8, arrs[5])
    assert out.dtype == torch.bfloat16 and torch.equal(out, o32.to(torch.bfloat16))
    assert state.dtype == torch.float32 and torch.equal(state, s32)


def _args():
    r = torch.zeros((1, 4, 2, 64))
    return [r, r.clone(), r.clone(), r.clone(), torch.zeros((2, 64))]


@pytest.mark.parametrize(
    "mutate,err",
    [
        (lambda r, k, v, w, u: (r.half(), k.half(), v.half(), w, u), TypeError),
        (lambda r, k, v, w, u: (r, k.bfloat16(), v, w, u), TypeError),  # k != r's dtype
        (lambda r, k, v, w, u: (r, k, v, w.bfloat16(), u), TypeError),  # logw not float32
        (lambda r, k, v, w, u: (r, k, v[..., :32], w, u), ValueError),  # v's shape
        (lambda r, k, v, w, u: (r, k, v, w, u[0]), ValueError),  # u's shape
        (lambda r, k, v, w, u: (r[0], k[0], v[0], w[0], u), ValueError),  # 3-D
        (lambda r, k, v, w, u: (r[:, :0], k[:, :0], v[:, :0], w[:, :0], u), ValueError),
    ],
)
def test_wrapper_rejects_bad_inputs(mutate, err):
    with pytest.raises(err):
        ops.rwkv6_scan(*mutate(*_args()), chunk=8)


def test_wrapper_rejects_bad_state_and_chunk():
    args = _args()
    with pytest.raises(ValueError):
        ops.rwkv6_scan(*args, chunk=8, init_state=torch.zeros((1, 2, 64, 32)))
    with pytest.raises(TypeError):
        ops.rwkv6_scan(*args, chunk=8, init_state=torch.zeros((1, 2, 64, 64)).double())
    with pytest.raises(ValueError):
        ops.rwkv6_scan(*args, chunk=0)


def test_cpu_tensors_launch_nothing():
    n = ops.rwkv6_scan.LAUNCHES
    ops.rwkv6_scan(*_args(), chunk=8)
    assert ops.rwkv6_scan.LAUNCHES == n
    assert ops._lib is None  # nothing was built either


@pytest.mark.parametrize("T,state,dtype", [
    (1, True, "float32"), (15, True, "float32"), (16, False, "float32"),
    (17, False, "float32"), (33, True, "float32"), (100, True, "float32"),
    (37, True, "bfloat16"), (64, False, "bfloat16"),
])
def test_split_ref_matches_jax_oracle(T, state, dtype):
    """The kernel's order against the reference's step oracle, the inputs
    rounded to ``dtype`` on both sides."""
    from repro.kernels.linear_scan.ref import rwkv6_ref

    arrs = _arrays(2, T, 3, 64, seed=T, state=state)
    j = _jax(arrs, dtype)
    jo, js = rwkv6_ref(*[a.astype("float32") for a in j[:3]], *j[3:5], *j[5:] if state else ())
    po, ps = ref.rwkv6_split_ref(*_torch(arrs, dtype))
    assert po.dtype == ps.dtype == torch.float32 and po.shape == (2, T, 3, 64)
    assert _rel(po, jo) <= SCAN_TOL and _rel(ps, js) <= SCAN_TOL


@pytest.mark.parametrize("shape", [(1, 64, 2, 64), (2, 128, 2, 64)])
def test_split_ref_matches_pallas_interpret(shape):
    """The Pallas kernel (Q = 64, no initial state) in float32, run as
    tests/test_kernels.py runs it."""
    from repro.kernels.linear_scan.ops import linear_scan

    arrs = _arrays(*shape, seed=sum(shape) + 1, state=False)
    for a in arrs[:3]:
        a *= 0.5  # the reference test's input scale
    want, want_s = linear_scan(*_jax(arrs)[:5], use_kernel=True, interpret=True)
    got, got_s = ref.rwkv6_split_ref(*_torch(arrs)[:5])
    assert _rel(got, want) <= SCAN_TOL and _rel(got_s, want_s) <= SCAN_TOL


def _faulty_split(r, k, v, logw, u, init_state, fault):
    """rwkv6_split_ref with one deliberate fault: ``drop_rows``
    leaves the last row group's partial out of every readout; ``skip_decay``
    leaves the state undecayed at step 15, the last of the first chunk;
    ``chunk_boundary`` runs the first step of every later chunk on the
    previous step's inputs (a stale buffer at the boundary)."""
    B, T, H, K = r.shape
    rows, G = ref.ROWS, K // ref.ROWS
    S = init_state.clone()
    ys = []
    for c0 in range(0, T, ref.CHUNK_STEPS):
        idx = list(range(c0, min(c0 + ref.CHUNK_STEPS, T)))
        if fault == "chunk_boundary" and c0 > 0:
            idx[0] = c0 - 1
        rc, kc, vc, lc = (a[:, idx] for a in (r, k, v, logw))
        wc = torch.exp(lc)
        bonus = ref._bonus_tree(rc, u, kc)
        parts = []
        for s, t in enumerate(range(c0, c0 + len(idx))):
            parts.append(torch.einsum("bhgi,bhgij->bhgj", rc[:, s].reshape(B, H, G, rows),
                                      S.reshape(B, H, G, rows, K)))
            decay = 1.0 if (fault == "skip_decay" and t == 15) else wc[:, s][..., None]
            S = S * decay + kc[:, s][..., :, None] * vc[:, s][..., None, :]
        P = torch.stack(parts, dim=1)
        y = P[..., 0, :]
        for g in range(1, G - 1 if fault == "drop_rows" else G):
            y = y + P[..., g, :]
        ys.append(y + bonus[..., None] * vc)
    return torch.cat(ys, dim=1), S


@pytest.mark.parametrize("T", [17, 4097])
@pytest.mark.parametrize("fault", ["drop_rows", "skip_decay", "chunk_boundary"])
def test_scan_bound_catches_a_faulty_split_version(T, fault):
    """At T = 17 (one chunk and a one-step tail) and 4,097 the bound passes
    the split version and fails each fault, in the output or the state."""
    arrs = _torch(_arrays(1, T, 2, 64, seed=T))
    want, want_s = ref.rwkv6_ref(*arrs)

    def gap(got, got_s):
        return max(_rel(got, want), _rel(got_s, want_s))

    assert gap(*ref.rwkv6_split_ref(*arrs)) <= SCAN_TOL
    assert gap(*_faulty_split(*arrs, fault)) > SCAN_TOL


# --- on the card: the kernel against its plain versions ----------------------------
def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at |x| (float32 tensor)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0**-126))) - 7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m cuda on a GPU host)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,state", [
    (1, 1, 2, True), (2, 100, 3, True), (2, 300, 1, False), (1, 1025, 2, True),
])
def test_kernel_matches_plain(cuda, dtype, B, T, H, state):
    arrs = [a.to(cuda) if a is not None else None
            for a in _torch(_arrays(B, T, H, 64, seed=T + H, state=state), dtype)]
    r, k, v = (a.transpose(1, 2).contiguous().transpose(1, 2) for a in arrs[:3])  # strided
    n = ops.rwkv6_scan.LAUNCHES
    got, got_s = ops.rwkv6_scan(r, k, v, *arrs[3:5], 16, arrs[5])
    torch.cuda.synchronize()
    assert ops.rwkv6_scan.LAUNCHES == n + 1 and got.dtype == r.dtype
    for want, want_s in (ref.rwkv6_ref(*arrs), ref.rwkv6_chunked(*arrs[:5], 16, arrs[5])):
        scale = max(1.0, want.abs().max().item())
        bound = 3e-5 * scale
        if dtype == "bfloat16":  # one rounding of the float32 result apart, at most
            bound = bound + _bf16_ulp(want)
        assert bool(((got.float() - want).abs() <= bound).all())
        assert (got_s - want_s).abs().max().item() <= 3e-5 * max(1.0, want_s.abs().max().item())


def _cuda_arrays(cuda, B, T, H, dtype, state, layout, seed):
    """Inputs on the card: ``contiguous``; ``strided`` (transposed views of
    (B, H, T, 64) tensors); or ``misaligned`` (rows one element past a
    16-byte boundary, the kernel's element-load path)."""
    arrs = [a.to(cuda) if a is not None else None
            for a in _torch(_arrays(B, T, H, 64, seed=seed, state=state), dtype)]
    if layout == "strided":
        arrs[:4] = [a.transpose(1, 2).contiguous().transpose(1, 2) for a in arrs[:4]]
    elif layout == "misaligned":
        def shift(a):
            base = torch.empty((B, T, H, 65), dtype=a.dtype, device=cuda)
            base[..., 1:] = a
            return base[..., 1:]
        arrs[:4] = [shift(a) for a in arrs[:4]]
    return arrs


def _within_scan_tol(got, got_s, want, want_s):
    scale = max(1.0, want.abs().max().item())
    bound = SCAN_TOL * scale
    if got.dtype == torch.bfloat16:  # one rounding of the float32 result apart, at most
        bound = bound + _bf16_ulp(want)
    scale_s = max(1.0, want_s.abs().max().item())
    return (bool(((got.float() - want).abs() <= bound).all())
            and (got_s - want_s).abs().max().item() <= SCAN_TOL * scale_s)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,state,layout", [
    (2, 1, 3, True, "contiguous"), (2, 15, 2, False, "strided"), (1, 16, 2, True, "contiguous"),
    (2, 17, 1, True, "strided"), (1, 4097, 2, False, "contiguous"),
    (1, 4097, 1, True, "strided"), (2, 33, 2, True, "misaligned"),
])
def test_kernel_matches_split_ref_at_chunk_edges(cuda, dtype, B, T, H, state, layout):
    """T at and around the 16-step chunk, one head, with and without the
    initial state, strided and misaligned rows: the kernel against the step
    oracle and the split version within SCAN_TOL; two calls bitwise equal."""
    arrs = _cuda_arrays(cuda, B, T, H, dtype, state, layout, seed=T + 7 * H)
    n = ops.rwkv6_scan.LAUNCHES
    got, got_s = ops.rwkv6_scan(*arrs[:5], 16, arrs[5])
    again, again_s = ops.rwkv6_scan(*arrs[:5], 16, arrs[5])
    torch.cuda.synchronize()
    assert ops.rwkv6_scan.LAUNCHES == n + 2
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), again.view(bits))
    assert torch.equal(got_s.view(torch.int32), again_s.view(torch.int32))
    for want, want_s in (ref.rwkv6_ref(*arrs), ref.rwkv6_split_ref(*arrs)):
        assert _within_scan_tol(got, got_s, want, want_s)
