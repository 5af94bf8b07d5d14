"""The one-process Mamba2 and RWKV6 functions of ``repro_torch.models.ssm``
run through per-head pieces (``mamba2_heads``, ``decode_mamba2_heads``,
``rwkv6_time_heads``, ``rwkv6_time_decode_heads``,
``rwkv6_channel_part``/``_gate``), the same pieces a rank runs on a "model"
axis above 1. This file pins them to the arithmetic they replaced, kept
below as a frozen copy (``_frozen_*``, on the module's unchanged helpers:
``_split_inproj``, ``_causal_conv``, ``ssd_chunked``, ``_time_inputs``,
the scan wrapper and its chunked form): in float32 and bfloat16, the
prefill, one decode step and its in-place cache, the training forward and
its gradients in every parameter and the input, bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402

from test_torch_tp import one_torch_thread  # noqa: E402,F401

DTYPES = [torch.float32, torch.bfloat16]
B, T = 2, 12


# -- the frozen copy ---------------------------------------------------------


def _frozen_gated_out(params, y, xh, z, dtype):
    h = y.float().add_(params["D"].to(z.dtype).float()[:, None] * xh.float())
    h = h.reshape(*z.shape[:-1], -1).mul_(F.silu(z.float()))
    return rms_norm(params["norm"], h).to(dtype) @ params["w_out"].to(dtype)


def _frozen_prefill_mamba2(params, s, x):
    di, ns = s.d_inner, s.d_state
    xi, Bm, Cm, z, dt = S._split_inproj(s, x @ params["w_in"])
    xBC_in = torch.cat([xi, Bm, Cm], dim=-1)
    xBC = S._causal_conv(xBC_in, params["conv_w"], params["conv_b"])
    xi, Bm, Cm = xBC[..., :di], xBC[..., di:di + ns], xBC[..., di + ns:]
    xh = xi.reshape(*xi.shape[:2], s.n_heads, s.head_dim)
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    y, final = S.ssd_chunked(xh, dt, A, Bm, Cm, s.chunk)
    return _frozen_gated_out(params, y, xh, z, x.dtype), final, xBC_in


def _frozen_decode_mamba2(params, s, x, cache):
    Bsz = x.shape[0]
    di, ns, H, P = s.d_inner, s.d_state, s.n_heads, s.head_dim
    xi, Bm, Cm, z, dt = S._split_inproj(s, x @ params["w_in"])
    conv = cache["conv"]
    hist = torch.cat([conv, torch.cat([xi, Bm, Cm], dim=-1).to(conv.dtype)], dim=1)
    w = params["conv_w"].float()
    out = hist[:, 0].float() * w[0]
    for i in range(1, s.d_conv):
        out += hist[:, i].float() * w[i]
    xBC = F.silu(out.add_(params["conv_b"].float()))
    conv.copy_(hist[:, 1:])
    xh = xBC[:, :di].reshape(Bsz, H, P)
    Bm, Cm = xBC[:, di:di + ns], xBC[:, di + ns:]
    dt1 = F.softplus(dt[:, 0].float() + params["dt_bias"].float())
    A = -torch.exp(params["A_log"].float())
    state = cache["ssm"]
    state.mul_(torch.exp(dt1 * A)[..., None, None]).add_(
        Bm[:, None, :, None] * (xh * dt1[..., None])[:, :, None, :])
    y = torch.einsum("bn,bhnp->bhp", Cm, state)
    return _frozen_gated_out(params, y, xh, z, x.dtype)


def _frozen_time_out(params, y, g):
    y = rms_norm(params["ln_out"], y * g)
    return torch.einsum("btd,de->btd", y, params["wo"])


def _frozen_apply_rwkv6_time(params, s, x):
    Bsz, Tn, D = x.shape
    H, K = s.n_heads, s.head_dim
    r, k, v, g, logw = S._time_inputs(params, x, S._token_shift(x))
    u = params["u"].float().reshape(H, K)
    y, final = S.scan_ops.rwkv6_scan(
        r.view(Bsz, Tn, H, K), k.view(Bsz, Tn, H, K), v.view(Bsz, Tn, H, K),
        logw.view(Bsz, Tn, H, K), u, s.chunk, None)
    return _frozen_time_out(params, y.reshape(Bsz, Tn, D), g), final


def _frozen_train_rwkv6_time(params, s, x):
    Bsz, Tn, D = x.shape
    H, K = s.n_heads, s.head_dim
    r, k, v, g, logw = S._time_inputs(params, x, S._token_shift(x))
    u = params["u"].float().reshape(H, K)
    y, _ = S.scan_ref.rwkv6_chunked(*(a.reshape(Bsz, Tn, H, K) for a in (r, k, v, logw)), u,
                                    s.chunk)
    return _frozen_time_out(params, y.reshape(Bsz, Tn, D).to(x.dtype), g)


def _frozen_decode_rwkv6_time(params, s, x, state, x_prev):
    Bsz, _, D = x.shape
    H, K = s.n_heads, s.head_dim
    r, k, v, g, logw = S._time_inputs(params, x, x_prev)
    w = torch.exp(logw).reshape(Bsz, H, K)
    u = params["u"].float().reshape(H, K)
    r32, k32, v32 = (a.reshape(Bsz, H, K).float() for a in (r, k, v))
    out = torch.einsum("bhk,bhkv->bhv", r32, state) + (r32 * u * k32).sum(-1, keepdim=True) * v32
    state.mul_(w[..., None]).add_(k32[..., :, None] * v32[..., None, :])
    return _frozen_time_out(params, out.reshape(Bsz, 1, D).to(x.dtype), g)


def _frozen_apply_rwkv6_channel(params, x, x_prev=None):
    xs = S._token_shift(x, x_prev)
    xk = S._mix(x, xs, params["mu_k"].to(x.dtype))
    xr = S._mix(x, xs, params["mu_r"].to(x.dtype))
    kv = F.relu(xk @ params["wk"]).square() @ params["wv"]
    return torch.sigmoid(xr @ params["wr"]) * kv


# -- inputs --------------------------------------------------------------------


def _draw(rng, shape, scale, dtype, shift=0.0):
    return torch.from_numpy(rng.standard_normal(shape) * scale + shift).to(dtype)


def _leaves(tree, dtype, rng, scales):
    """Every leaf of the tree of ParamDefs drawn from ``rng`` (normal, the
    leaf's scale or ``scales[name]`` as (scale, shift)) in ``dtype``."""
    out = {}
    for k, d in sorted(tree.items()):
        if isinstance(d, dict):
            out[k] = _leaves(d, dtype, rng, scales)
            continue
        scale, shift = scales.get(k, (1.0 / np.sqrt(d.shape[0]), 0.0))
        out[k] = _draw(rng, d.shape, scale, dtype, shift)
    return out


def _mamba2(dtype, seed=0):
    s = S.Mamba2Spec(d_model=32, d_state=8, head_dim=16, chunk=4)
    rng = np.random.default_rng(seed)
    p = _leaves(S.init_mamba2(s), dtype, rng,
                {"A_log": (0.5, 0.0), "D": (0.5, 1.0), "dt_bias": (0.5, 0.0),
                 "conv_b": (0.1, 0.0), "scale": (0.1, 0.0), "conv_w": (0.5, 0.0)})
    return s, p, _draw(rng, (B, T, s.d_model), 1.0, dtype), _draw(rng, (B, 1, s.d_model), 1.0,
                                                                  dtype)


def _rwkv6(dtype, seed=1):
    s = S.RWKV6Spec(d_model=64, head_dim=16, decay_lora=8, chunk=4)
    rng = np.random.default_rng(seed)
    mix = {f"mu_{n}": (0.3, 0.5) for n in "rkvwg"}
    p = _leaves(S.init_rwkv6_time(s), dtype, rng,
                dict(mix, u=(0.5, 0.0), w0=(0.5, 0.0), scale=(0.1, 0.0)))
    c = _leaves(S.init_rwkv6_channel(s, 128), dtype, rng, mix)
    return s, p, c, _draw(rng, (B, T, s.d_model), 1.0, dtype), _draw(rng, (B, 1, s.d_model), 1.0,
                                                                     dtype)


def _grads(fn, params, x):
    """fn's output and its gradients in every leaf of ``params`` and in x
    against a fixed output gradient."""
    leaves = {}

    def grad_copy(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = grad_copy(v, prefix + k + ".")
            else:
                out[k] = leaves[prefix + k] = v.detach().clone().requires_grad_(True)
        return out

    p = grad_copy(params)
    xg = x.detach().clone().requires_grad_(True)
    y = fn(p, xg)
    w = torch.from_numpy(np.random.default_rng(7).standard_normal(y.shape)).to(y.dtype)
    names = sorted(leaves)
    grads = torch.autograd.grad((y.float() * w.float()).sum(), [leaves[n] for n in names] + [xg],
                                allow_unused=True)
    return y.detach(), dict(zip(names + ["x"], grads))


def _equal_grads(got, want):
    for name in want[1]:
        a, b = got[1][name], want[1][name]
        assert (a is None) == (b is None), name
        assert a is None or torch.equal(a, b), name
    assert torch.equal(got[0], want[0])


# -- the pins ------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
def test_mamba2_prefill_and_decode_pinned(dtype):
    s, p, x, tok = _mamba2(dtype)
    with torch.no_grad():
        y, final, xBC_in = S.prefill_mamba2(p, s, x)
        fy, ffinal, fxBC_in = _frozen_prefill_mamba2(p, s, x)
        assert torch.equal(y, fy) and torch.equal(final, ffinal)
        assert torch.equal(xBC_in, fxBC_in)
        tail = S.mamba2_conv_tail(s, xBC_in)
        cache = {"conv": tail.clone(), "ssm": final.float().clone()}
        frozen = {"conv": tail.clone(), "ssm": final.float().clone()}
        for _ in range(3):  # the in-place cache carries from step to step
            yd, _ = S.decode_mamba2(p, s, tok, cache, None)
            assert torch.equal(yd, _frozen_decode_mamba2(p, s, tok, frozen))
            assert torch.equal(cache["conv"], frozen["conv"])
            assert torch.equal(cache["ssm"], frozen["ssm"])


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
def test_mamba2_training_gradients_pinned(dtype):
    s, p, x, _ = _mamba2(dtype, seed=2)
    _equal_grads(_grads(lambda q, xx: S.apply_mamba2(q, s, xx)[0], p, x),
                 _grads(lambda q, xx: _frozen_prefill_mamba2(q, s, xx)[0], p, x))


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
def test_rwkv6_prefill_and_decode_pinned(dtype):
    s, p, c, x, tok = _rwkv6(dtype)
    with torch.no_grad():
        y, final, x_last = S.apply_rwkv6_time(p, s, x)
        fy, ffinal = _frozen_apply_rwkv6_time(p, s, x)
        assert torch.equal(y, fy) and torch.equal(final, ffinal)
        state, frozen = final.clone(), final.clone()
        x_prev = x_last
        for _ in range(3):
            yd, _, _ = S.decode_rwkv6_time(p, s, tok, state, x_prev)
            assert torch.equal(yd, _frozen_decode_rwkv6_time(p, s, tok, frozen, x_prev))
            assert torch.equal(state, frozen)
            x_prev, tok = tok, tok.flip(-1)
        yc, _ = S.apply_rwkv6_channel(c, x)
        assert torch.equal(yc, _frozen_apply_rwkv6_channel(c, x))
        yc, _ = S.apply_rwkv6_channel(c, tok, x_last)
        assert torch.equal(yc, _frozen_apply_rwkv6_channel(c, tok, x_last))


@pytest.mark.parametrize("dtype", DTYPES, ids=["float32", "bfloat16"])
def test_rwkv6_training_gradients_pinned(dtype):
    s, p, c, x, _ = _rwkv6(dtype, seed=3)
    _equal_grads(_grads(lambda q, xx: S.train_rwkv6_time(q, s, xx), p, x),
                 _grads(lambda q, xx: _frozen_train_rwkv6_time(q, s, xx), p, x))
    _equal_grads(_grads(lambda q, xx: S.apply_rwkv6_channel(q, xx)[0], c, x),
                 _grads(lambda q, xx: _frozen_apply_rwkv6_channel(q, xx), c, x))
