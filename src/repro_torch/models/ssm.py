"""State-space and linear-recurrence blocks: Mamba2 (SSD, arXiv:2405.21060)
and RWKV6 ("Finch", arXiv:2404.05892).

Port of the reference's ``models/ssm.py``. Both have a chunked parallel form
for prefill and a recurrent form for decode, with the state in the cache
updated in place.

Mamba2: an input projection, a depthwise causal convolution, the SSD scan
and a gated RMS norm before the output projection. The reference computes
its chunked scan (``ssd_chunked``) with einsums and no Pallas kernel, so
plain PyTorch is its counterpart here, with the reference's casts: the
intra-chunk weights, the chunk-state weights and the carried state's decays
exp(g) are cast to the inputs' dtype before their products, the
three-operand products are taken in the order opt_einsum gives the
reference (the weights times the smaller of B, C first), and the scan
carries its state in the inputs' dtype unless an initial state says
otherwise. Decode keeps the SSM state in float32. The elementwise chains
between products (the convolution and its SiLU, the scan's step, the skip
and gate before the norm) run in float32 and round once to the activations'
dtype, as the reference's fused XLA computations do: rounding each op of
them to bfloat16 left the port's bf16 logits twice as far from float32 as
the reference's.

Training differentiates the same forms under autograd (per layer under
``torch.utils.checkpoint``, ``models/transformer.py``). The scan's
elementwise chain over its (B, nc, Q, Q, H) weights runs in place only
where autograd is off (the prefill's peak); with grad enabled it takes the
same ops in the same order out of place, so both give the same bits.

RWKV6: a linear recurrence with a data-dependent decay per channel (the
time mix) and a channel mix. The prefill runs the recurrence through the
linear-scan wrapper (``kernels/linear_scan``): on CUDA tensors the
hand-written kernel, on CPU tensors the plain port of the reference's
chunked scan. Training (``train_rwkv6_time``) differentiates that chunked
scan, ``ref.rwkv6_chunked``, on either device. Decode is one recurrent step
in plain PyTorch, as in the reference. The reference's arithmetic is kept
where it is unusual: every ``mu_*`` leaf is initialised to ones (its
``init_leaf`` ignores ``scale``), and the time mix's output is
``einsum("btd,de->btd", y, wo)``, which sums ``wo`` over ``e`` and scales y
elementwise (``y * wo.sum(-1)``), not ``y @ wo`` (ROADMAP.md queue 3).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.linear_scan import ops as scan_ops
from repro_torch.kernels.linear_scan import ref as scan_ref
from repro_torch.models.layers import _span, init_rmsnorm, rms_norm
from repro_torch.models.param_defs import ParamDef

# ---------------------------------------------------------------------------
# Mamba2 (SSD: the state-space duality chunked algorithm)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Mamba2Spec:
    d_model: int
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def init_mamba2(s: Mamba2Spec) -> Dict[str, Any]:
    di, ns, nh = s.d_inner, s.d_state, s.n_heads
    conv_dim = di + 2 * ns
    return {
        # order: [x (di), B (ns), C (ns), z (di), dt (nh)]
        "w_in": ParamDef((s.d_model, 2 * di + 2 * ns + nh), ("embed", "ffn")),
        "conv_w": ParamDef((s.d_conv, conv_dim), ("conv", None), scale=0.5),
        "conv_b": ParamDef((conv_dim,), (None,), init="zeros"),
        "A_log": ParamDef((nh,), (None,), init="zeros"),
        "D": ParamDef((nh,), (None,), init="ones"),
        "dt_bias": ParamDef((nh,), (None,), init="zeros"),
        "norm": init_rmsnorm(di),
        "w_out": ParamDef((di, s.d_model), ("ffn", "embed")),
    }


def _split_inproj(s: Mamba2Spec, zxbcdt: torch.Tensor):
    """x (di), B (ns), C (ns), z (di), dt (nh): views of the projection."""
    di, ns = s.d_inner, s.d_state
    return (zxbcdt[..., :di], zxbcdt[..., di:di + ns], zxbcdt[..., di + ns:di + 2 * ns],
            zxbcdt[..., di + 2 * ns:2 * di + 2 * ns], zxbcdt[..., 2 * di + 2 * ns:])


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution along the sequence, then SiLU. xBC
    (B, T, C), w (K, C): the reference's sum of K shifted products, in its
    order, in float32, rounded once to xBC's dtype."""
    K, T = w.shape[0], xBC.shape[1]
    pad, w32 = F.pad(xBC, (0, 0, K - 1, 0)).float(), w.float()
    out = pad[:, :T] * w32[0]
    for i in range(1, K):
        out += pad[:, i:i + T] * w32[i]
    return F.silu(out.add_(b.float())).to(xBC.dtype)


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, init_state=None):
    """SSD chunked scan. xh (B, T, H, P) inputs; dt (B, T, H) positive step
    sizes (float32); A (H,) negative decay rates (float32); Bm, Cm (B, T, N)
    input and output projections (one group). Returns (y (B, T, H, P),
    final state (B, H, N, P)). A T that is no multiple of the chunk is
    padded with dt = 0 steps (decay 1, no contribution: the state is
    unaffected) and cut back. Within a chunk the quadratic form
    att[i, j] = C_i.B_j exp(g_i - g_j) dt_j (j <= i, the exponent clamped
    at 0 as the reference clamps it for its backward pass); across chunks
    the recurrence over the chunk states, a loop of nc steps."""
    Bsz, T, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, T)
    if T % Q:
        padn = Q - T % Q

        def pad(a):
            return F.pad(a, (0, 0) * (a.dim() - 2) + (0, padn))

        y, final = ssd_chunked(pad(xh), pad(dt), A, pad(Bm), pad(Cm), chunk, init_state)
        return y[:, :T], final
    nc = T // Q
    xc = xh.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)

    g = torch.cumsum(dtc * A, dim=2)  # (B, nc, Q, H) cumulative log-decay, float32
    CB = torch.einsum("bcin,bcjn->bcij", Cc, Bc)  # (B, nc, Q, Q)
    # att = (CB * where(causal, exp(min(g_i - g_j, 0)), 0)) * dt_j
    att = g[:, :, :, None, :] - g[:, :, None, :, :]
    masked = ~torch.ones(Q, Q, dtype=torch.bool, device=xh.device).tril()[None, None, :, :, None]
    if torch.is_grad_enabled():  # autograd keeps exp's output: no op may overwrite it
        att = att.clamp_max(0.0).exp().masked_fill(masked, 0.0) * CB[..., None] * dtc[:, :, None]
    else:  # the same ops in the same order, in one buffer (the prefill's peak)
        att.clamp_max_(0.0).exp_().masked_fill_(masked, 0.0)
        att.mul_(CB[..., None]).mul_(dtc[:, :, None])
    y = torch.einsum("bcijh,bcjhp->bcihp", att.to(xh.dtype), xc)
    del att, CB

    # chunk summary states: S_c = sum_j exp(g_last - g_j) dt_j B_j x_j^T
    last = g[:, :, -1:, :]  # (B, nc, 1, H)
    w_j = (torch.exp(last - g) * dtc).to(xh.dtype)
    wB = w_j[..., None] * Bc[:, :, :, None, :]  # (B, nc, Q, H, N)
    S = torch.einsum("bcjhn,bcjhp->bchnp", wB, xc)  # (B, nc, H, N, P)
    del wB

    # the recurrence over the chunk states: the state entering each chunk,
    # each step in float32 and rounded once to the carried dtype
    chunk_decay = torch.exp(last[:, :, 0, :])  # (B, nc, H)
    state = init_state if init_state is not None else xh.new_zeros((Bsz, H, N, P))
    carried = torch.promote_types(state.dtype, S.dtype)
    prevs = []
    for c in range(nc):
        prevs.append(state)
        state = (state.float() * chunk_decay[:, c, :, None, None]).add_(S[:, c].float())
        state = state.to(carried)
    S_prev = torch.stack(prevs, dim=1)  # (B, nc, H, N, P)
    del S, prevs

    # the carried state's contribution: y_i += exp(g_i) C_i . S_prev
    eC = torch.exp(g).to(xh.dtype)[..., None] * Cc[:, :, :, None, :]  # (B, nc, Q, H, N)
    ct = torch.promote_types(eC.dtype, S_prev.dtype)  # a float32 state promotes, as in JAX
    y_inter = torch.einsum("bcihn,bchnp->bcihp", eC.to(ct), S_prev.to(ct))
    return y.to(ct).add_(y_inter).reshape(Bsz, T, H, P), state


def prefill_mamba2(params, s: Mamba2Spec, x: torch.Tensor):
    """``apply_mamba2``, and the convolution's input (B, T, conv_dim), whose
    last d_conv - 1 rows the decode cache keeps."""
    di, ns = s.d_inner, s.d_state
    with _span("mamba2.in"):
        xi, Bm, Cm, z, dt = _split_inproj(s, x @ params["w_in"])
        xBC_in = torch.cat([xi, Bm, Cm], dim=-1)
        xBC = _causal_conv(xBC_in, params["conv_w"], params["conv_b"])
        xi, Bm, Cm = xBC[..., :di], xBC[..., di:di + ns], xBC[..., di + ns:]
        xh = xi.reshape(*xi.shape[:2], s.n_heads, s.head_dim)
        dt = F.softplus(dt.float() + params["dt_bias"].float())
        A = -torch.exp(params["A_log"].float())
    with _span("mamba2.ssd"):
        y, final = ssd_chunked(xh, dt, A, Bm, Cm, s.chunk)
    with _span("mamba2.out"):
        out = _gated_out(params, y, xh, z, x.dtype)
        return out, final, xBC_in


def _gated_out(params, y, xh, z, dtype):
    """The skip, the gate, the norm and the output projection: (y + D xh)
    silu(z), normed, in float32, rounded once to ``dtype`` (the block
    input's) before ``w_out``."""
    h = y.float().add_(params["D"].to(z.dtype).float()[:, None] * xh.float())
    h = h.reshape(*z.shape[:-1], -1).mul_(F.silu(z.float()))
    return rms_norm(params["norm"], h).to(dtype) @ params["w_out"].to(dtype)


def apply_mamba2(params, s: Mamba2Spec, x: torch.Tensor):
    """Prefill over x (B, T, D) from a zero state: (y (B, T, D), the final
    SSM state (B, H, N, P) in x's dtype)."""
    y, final, _ = prefill_mamba2(params, s, x)
    return y, final


def mamba2_conv_tail(s: Mamba2Spec, xBC_in: torch.Tensor) -> torch.Tensor:
    """The decode cache's convolution history after a prefill: the last
    d_conv - 1 rows of the convolution's input, zeros in front of a prompt
    shorter than that (the causal padding), as an owned copy."""
    K1 = s.d_conv - 1
    tail = xBC_in[:, -K1:]
    if tail.shape[1] < K1:
        tail = F.pad(tail, (0, 0, K1 - tail.shape[1], 0))
    return tail.clone()


def init_mamba2_cache(s: Mamba2Spec, batch: int, dtype=torch.bfloat16):
    conv_dim = s.d_inner + 2 * s.d_state
    return {
        "conv": ParamDef((batch, s.d_conv - 1, conv_dim), ("batch", None, None), init="zeros",
                         dtype=dtype),
        "ssm": ParamDef((batch, s.n_heads, s.d_state, s.head_dim),
                        ("batch", "heads", None, None), init="zeros", dtype=torch.float32),
    }


def decode_mamba2(params, s: Mamba2Spec, x: torch.Tensor, cache: Dict[str, torch.Tensor], pos):
    """One token x (B, 1, D). Unlike the reference, which returns a new
    cache, this updates ``cache`` IN PLACE: the convolution history
    (B, d_conv - 1, conv_dim) shifts by one row, and the float32 SSM state
    (B, H, N, P) takes ``state * exp(dt A) + dt B x^T``; the readout uses
    the new state. ``pos`` is unused (the state carries the position).
    Returns (y (B, 1, D), cache)."""
    B = x.shape[0]
    di, ns, H, P = s.d_inner, s.d_state, s.n_heads, s.head_dim
    with _span("mamba2.in"):
        xi, Bm, Cm, z, dt = _split_inproj(s, x @ params["w_in"])
        conv = cache["conv"]
        hist = torch.cat([conv, torch.cat([xi, Bm, Cm], dim=-1).to(conv.dtype)], dim=1)
        # the convolution, its SiLU and the state's inputs in float32: the
        # reference's fused step rounds none of them
        w = params["conv_w"].float()
        out = hist[:, 0].float() * w[0]
        for i in range(1, s.d_conv):
            out += hist[:, i].float() * w[i]
        xBC = F.silu(out.add_(params["conv_b"].float()))
        conv.copy_(hist[:, 1:])
        xh = xBC[:, :di].reshape(B, H, P)
        Bm, Cm = xBC[:, di:di + ns], xBC[:, di + ns:]
        dt1 = F.softplus(dt[:, 0].float() + params["dt_bias"].float())  # (B, H)
        A = -torch.exp(params["A_log"].float())
    with _span("mamba2.ssd"):
        state = cache["ssm"]
        state.mul_(torch.exp(dt1 * A)[..., None, None]).add_(
            Bm[:, None, :, None] * (xh * dt1[..., None])[:, :, None, :])
        y = torch.einsum("bn,bhnp->bhp", Cm, state)
    with _span("mamba2.out"):
        return _gated_out(params, y, xh, z, x.dtype), cache


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RWKV6Spec:
    d_model: int
    head_dim: int = 64
    decay_lora: int = 64
    chunk: int = 128  # the chunked scan's: CPU prefill and training (the kernel ignores it)

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim


def init_rwkv6_time(s: RWKV6Spec) -> Dict[str, Any]:
    d = s.d_model
    return {
        # token-shift interpolation weights (static per-stream mixes; the
        # decay lora below is the data-dependent part that defines RWKV6)
        "mu_r": ParamDef((d,), (None,), init="ones", scale=0.5),
        "mu_k": ParamDef((d,), (None,), init="ones", scale=0.5),
        "mu_v": ParamDef((d,), (None,), init="ones", scale=0.5),
        "mu_w": ParamDef((d,), (None,), init="ones", scale=0.5),
        "mu_g": ParamDef((d,), (None,), init="ones", scale=0.5),
        "wr": ParamDef((d, d), ("embed", "heads")),
        "wk": ParamDef((d, d), ("embed", "heads")),
        "wv": ParamDef((d, d), ("embed", "heads")),
        "wg": ParamDef((d, d), ("embed", "heads")),
        # data-dependent decay: w_t = exp(-exp(w0 + tanh(x w1) w2))
        "w0": ParamDef((d,), (None,), init="zeros"),
        "w1": ParamDef((d, s.decay_lora), ("embed", None), scale=0.1),
        "w2": ParamDef((s.decay_lora, d), (None, "heads"), scale=0.1),
        "u": ParamDef((d,), (None,), init="zeros"),  # bonus for the current token
        "ln_out": init_rmsnorm(d),
        "wo": ParamDef((d, d), ("heads", "embed")),
    }


def _token_shift(x: torch.Tensor, x_prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The previous-token stream: x_prev is the last token of the previous
    segment (decode) or zeros (the start of a sequence)."""
    if x_prev is None:
        x_prev = torch.zeros_like(x[:, :1])
    return torch.cat([x_prev, x[:, :-1]], dim=1)


def _mix(x, xs, mu):
    return x + (xs - x) * mu  # lerp toward the shifted stream


def _time_inputs(params, x: torch.Tensor, xs: torch.Tensor):
    """The time mix's projections of x (B, T, D) and its shifted stream xs:
    r, k, v and the gate g (B, T, D) in x's dtype, and the log-decay
    logw = -exp(clip(w0 + tanh(xw w1) w2, -8, 4)) (B, T, D) in float32."""
    xr, xk, xv, xw, xg = (_mix(x, xs, params[f"mu_{n}"].to(x.dtype)) for n in "rkvwg")
    r = xr @ params["wr"]
    k = xk @ params["wk"]
    v = xv @ params["wv"]
    g = F.silu(xg @ params["wg"])
    dd = torch.tanh(xw @ params["w1"]) @ params["w2"]
    logw = -torch.exp(torch.clamp(params["w0"].float() + dd.float(), -8.0, 4.0))
    return r, k, v, g, logw


def _time_out(params, y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Gate, normalise and apply ``wo`` as the reference does (ssm.py:355):
    the subscripts sum ``wo`` over e, so this scales y by ``wo.sum(-1)``."""
    y = rms_norm(params["ln_out"], y * g)
    return torch.einsum("btd,de->btd", y, params["wo"])


def apply_rwkv6_time(params, s: RWKV6Spec, x: torch.Tensor, init_state=None, x_prev=None):
    """Prefill over x (B, T, D). Returns (y (B, T, D), the float32 final
    state (B, H, K, K), x's last token (B, 1, D), a view)."""
    B, T, D = x.shape
    H, K = s.n_heads, s.head_dim
    r, k, v, g, logw = _time_inputs(params, x, _token_shift(x, x_prev))
    u = params["u"].float().reshape(H, K)
    y, final = scan_ops.rwkv6_scan(
        r.view(B, T, H, K), k.view(B, T, H, K), v.view(B, T, H, K), logw.view(B, T, H, K), u,
        s.chunk, init_state,
    )  # y in x's dtype: the float32 result rounded once
    return _time_out(params, y.reshape(B, T, D), g), final, x[:, -1:]


def train_rwkv6_time(params, s: RWKV6Spec, x: torch.Tensor) -> torch.Tensor:
    """The time mix's training forward over x (B, T, D) from a zero state,
    differentiable: the reference's ``apply_rwkv6_time`` through its chunked
    scan (``scan_ref.rwkv6_chunked``, chunks of ``s.chunk``) under autograd,
    then the gate, the norm and ``wo`` as ``_time_out``. The prefill's scan
    kernel has no backward; the chunked form is what the reference trains
    through, the same choice as the plain ``_sdpa`` for attention."""
    B, T, D = x.shape
    H, K = s.n_heads, s.head_dim
    r, k, v, g, logw = _time_inputs(params, x, _token_shift(x))
    u = params["u"].float().reshape(H, K)
    with _span("rwkv6.chunked"):
        y, _ = scan_ref.rwkv6_chunked(*(a.reshape(B, T, H, K) for a in (r, k, v, logw)), u,
                                      s.chunk)
    return _time_out(params, y.reshape(B, T, D).to(x.dtype), g)


def decode_rwkv6_time(params, s: RWKV6Spec, x, state, x_prev):
    """One token. x, x_prev: (B, 1, D); state: (B, H, K, K) float32. Unlike
    the reference, which returns a new state, this updates ``state`` IN
    PLACE: the readout uses the old state, then ``state.mul_(w).add_(k v^T)``.
    Returns (y (B, 1, D), state, x)."""
    B, _, D = x.shape
    H, K = s.n_heads, s.head_dim
    r, k, v, g, logw = _time_inputs(params, x, x_prev)
    w = torch.exp(logw).reshape(B, H, K)
    u = params["u"].float().reshape(H, K)
    r32, k32, v32 = (a.reshape(B, H, K).float() for a in (r, k, v))
    out = torch.einsum("bhk,bhkv->bhv", r32, state) + (r32 * u * k32).sum(-1, keepdim=True) * v32
    state.mul_(w[..., None]).add_(k32[..., :, None] * v32[..., None, :])
    return _time_out(params, out.reshape(B, 1, D).to(x.dtype), g), state, x


def init_rwkv6_channel(s: RWKV6Spec, d_ff: int) -> Dict[str, Any]:
    d = s.d_model
    return {
        "mu_k": ParamDef((d,), (None,), init="ones", scale=0.5),
        "mu_r": ParamDef((d,), (None,), init="ones", scale=0.5),
        "wk": ParamDef((d, d_ff), ("embed", "ffn")),
        "wv": ParamDef((d_ff, d), ("ffn", "embed")),
        "wr": ParamDef((d, d), ("embed", None)),
    }


def apply_rwkv6_channel(params, x: torch.Tensor, x_prev=None):
    """Squared-ReLU channel mix over x (B, T, D), the token shift from
    x_prev (decode) or zeros. Returns (y, x's last token (B, 1, D), a view)."""
    xs = _token_shift(x, x_prev)
    xk = _mix(x, xs, params["mu_k"].to(x.dtype))
    xr = _mix(x, xs, params["mu_r"].to(x.dtype))
    kv = F.relu(xk @ params["wk"]).square() @ params["wv"]
    return torch.sigmoid(xr @ params["wr"]) * kv, x[:, -1:]
