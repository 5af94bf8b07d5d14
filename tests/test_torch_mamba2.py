"""The port's Mamba2 (``models/ssm.py``) against the JAX package's.

Inputs come from a numpy seed and go through the reference's functions and
the port's on the CPU (the reference computes its chunked scan with einsums
and no Pallas kernel; so does the port):

- ``ssd_chunked`` with T a multiple of the chunk, T past it (the pad path:
  dt = 0 steps), T below it (one chunk of T), with and without a float32
  initial state: float32 within 1e-5 of the outputs' and states' scale
  max(1, max |want|) (measured 1.9e-7 outputs, 2.4e-7 states); bfloat16
  within 2e-2 of it (measured 3.5e-3 outputs, 4.3e-3 states: the products'
  bf16 outputs are rounded by two libraries, and the scan carries its
  state in bfloat16).
- ``apply_mamba2`` and ``decode_mamba2`` with the reference's leaves and its
  one- and zero-initialised ``A_log``, ``dt_bias``, ``D``, ``conv_b`` and
  the norm's scale redrawn (so that decay, step size and bias are not
  trivial): float32 within 1e-5 of the scale (measured 2.5e-7 prefill,
  3.2e-7 decode, 2.1e-7 the states), the convolution history within 1e-6
  of its scale; bfloat16 within 2e-2 of the scale (measured 8.2e-3
  prefill, 1.1e-2 decode, 7.8e-3 the states), the history within one bf16
  ulp.
- In the port alone, float32: a decode chain from a chunked prefill's
  state equals the chunked prefill of the longer sequence (measured 2.5e-7
  of the scale; held to 1e-5), and decode updates its cache in place.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.models import ssm as PS
from repro_torch.models.convert import to_torch

F32_TOL, BF16_TOL = 1e-5, 2e-2


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


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    return 2.0 ** (np.floor(np.log2(np.maximum(x, 2.0**-126))) - 7)


def _within(got: torch.Tensor, want, tol: float, what: str) -> float:
    """max |got - want| over the scale max(1, max |want|), held to tol."""
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    rel = float(np.abs(g - w).max()) / max(1.0, float(np.abs(w).max()))
    assert rel <= tol, (what, rel)
    return rel


def _ssd_inputs(B, T, H, P, N, seed, state):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, T, H, P)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (B, T, H)).astype(np.float32)
    A = -np.exp(rng.normal(0.0, 0.5, H)).astype(np.float32)
    Bm = rng.standard_normal((B, T, N)).astype(np.float32)
    Cm = rng.standard_normal((B, T, N)).astype(np.float32)
    s0 = rng.standard_normal((B, H, N, P)).astype(np.float32) if state else None
    return xh, dt, A, Bm, Cm, s0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("T,chunk", [(32, 16), (37, 16), (10, 16), (48, 8)])
def test_ssd_chunked_matches_jax(T, chunk, state, dtype):
    import jax.numpy as jnp
    from repro.models import ssm as JS

    xh, dt, A, Bm, Cm, s0 = _ssd_inputs(2, T, 3, 8, 5, seed=T + chunk, state=state)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jy, jf = JS.ssd_chunked(jnp.asarray(xh, jd), jnp.asarray(dt), jnp.asarray(A),
                            jnp.asarray(Bm, jd), jnp.asarray(Cm, jd), chunk,
                            None if s0 is None else jnp.asarray(s0))
    py, pf = PS.ssd_chunked(torch.from_numpy(xh).to(td), torch.from_numpy(dt),
                            torch.from_numpy(A), torch.from_numpy(Bm).to(td),
                            torch.from_numpy(Cm).to(td), chunk,
                            None if s0 is None else torch.from_numpy(s0))
    # the dtypes the reference's promotions give: a float32 state makes
    # float32 outputs
    assert str(py.dtype)[6:] == str(jy.dtype) and str(pf.dtype)[6:] == str(jf.dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    _within(py, jy, tol, "y")
    _within(pf, jf, tol, "final state")


def _params(s, dtype, seed):
    """The reference's Mamba2 leaves, with the zero and one inits redrawn:
    (the reference's tree of arrays, the port's tree of tensors)."""
    import jax
    import jax.numpy as jnp
    from repro.models import ssm as JS
    from repro.models.param_defs import init_tree

    params = init_tree(JS.init_mamba2(s), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    H, C = s.n_heads, s.d_inner + 2 * s.d_state
    params["A_log"] = jnp.asarray(rng.normal(0.0, 0.5, H))
    params["dt_bias"] = jnp.asarray(rng.normal(-1.0, 0.5, H))
    params["D"] = jnp.asarray(rng.normal(1.0, 0.2, H))
    params["conv_b"] = jnp.asarray(rng.normal(0.0, 0.1, C))
    params["norm"]["scale"] = jnp.asarray(rng.normal(0.0, 0.2, s.d_inner))
    params = jax.tree.map(lambda a: a.astype(getattr(jnp, dtype)), params)
    return params, jax.tree.map(lambda a: to_torch(np.asarray(a)), params)


def _spec(chunk=16):
    from repro.models import ssm as JS

    return (JS.Mamba2Spec(d_model=32, d_state=8, head_dim=16, chunk=chunk),
            PS.Mamba2Spec(d_model=32, d_state=8, head_dim=16, chunk=chunk))


@pytest.fixture(scope="module")
def jax_mamba_fns():
    """The reference's prefill (with its conv tail) and decode, jitted once."""
    import jax
    import jax.numpy as jnp
    from repro.models import ssm as JS

    def prefill(s, p, x):
        y, final = JS.apply_mamba2(p, s, x)
        xi, Bm, Cm, _, _ = JS._split_inproj(s, jnp.einsum("btd,de->bte", x, p["w_in"]))
        tail = jnp.concatenate([xi, Bm, Cm], axis=-1)[:, -(s.d_conv - 1):, :]
        return y, {"conv": tail, "ssm": final.astype(jnp.float32)}

    return (jax.jit(prefill, static_argnums=(0,)),
            jax.jit(lambda s, p, x, c: JS.decode_mamba2(p, s, x, c, 0), static_argnums=(0,)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [16, 21])
def test_apply_and_decode_mamba2_match_jax(jax_mamba_fns, T, dtype):
    import jax.numpy as jnp

    prefill, decode = jax_mamba_fns
    js, ps = _spec()
    jp, pp = _params(js, dtype, seed=T)
    rng = np.random.default_rng(T)
    x = rng.standard_normal((2, T + 6, 32)).astype(np.float32)
    jx, tx = jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jy, jc = prefill(js, jp, jx[:, :T])
    py, pf, xin = PS.prefill_mamba2(pp, ps, tx[:, :T])
    assert torch.equal(PS.apply_mamba2(pp, ps, tx[:, :T])[0], py)
    _within(py, jy, tol, "prefill y")
    pc = {"conv": PS.mamba2_conv_tail(ps, xin), "ssm": pf.float()}
    _within(pc["ssm"], jc["ssm"], tol, "prefill state")
    assert np.array_equal(pc["conv"].float().numpy(), np.asarray(jc["conv"], np.float32))
    for t in range(T, T + 6):
        jy, jc = decode(js, jp, jx[:, t:t + 1], jc)
        py, pc = PS.decode_mamba2(pp, ps, tx[:, t:t + 1], pc, t)
        _within(py, jy, tol, f"decode y at {t}")
        _within(pc["ssm"], jc["ssm"], tol, f"decode state at {t}")
        g, w = pc["conv"].float().numpy(), np.asarray(jc["conv"], np.float32)
        assert (np.abs(g - w) <= _bf16_ulp(np.maximum(abs(g), abs(w))) * (dtype != "float32")
                + 1e-6 * np.abs(w).max()).all(), f"conv history at {t}"


@pytest.mark.parametrize("P,n", [(16, 5), (21, 12), (2, 4)])
def test_decode_chain_equals_chunked_prefill(P, n):
    """float32: prefill P tokens (chunked scan), decode n more from its
    state, against the chunked prefill of all P + n tokens; the decode
    writes its cache in place. P = 2 < d_conv - 1 pads the history."""
    _, ps = _spec(chunk=8)
    _, pp = _params(ps, "float32", seed=P)
    rng = np.random.default_rng(P + n)
    x = torch.from_numpy(rng.standard_normal((2, P + n, 32)).astype(np.float32))
    want, _ = PS.apply_mamba2(pp, ps, x)
    y, final, xin = PS.prefill_mamba2(pp, ps, x[:, :P])
    cache = {"conv": PS.mamba2_conv_tail(ps, xin), "ssm": final.float()}
    assert cache["conv"].shape == (2, ps.d_conv - 1, ps.d_inner + 2 * ps.d_state)
    conv, ssm = cache["conv"], cache["ssm"]
    outs = [y]
    for t in range(P, P + n):
        out, c2 = PS.decode_mamba2(pp, ps, x[:, t:t + 1], cache, t)
        assert c2 is cache and c2["conv"] is conv and c2["ssm"] is ssm
        outs.append(out)
    got = torch.cat(outs, dim=1)
    _within(got, want.numpy(), F32_TOL, "decode chain vs prefill")


def test_cache_defs():
    _, ps = _spec()
    defs = PS.init_mamba2_cache(ps, 3, torch.bfloat16)
    assert defs["conv"].shape == (3, 3, 64 + 16) and defs["conv"].dtype == torch.bfloat16
    assert defs["ssm"].shape == (3, 4, 8, 16) and defs["ssm"].dtype == torch.float32
