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

On a "model" mesh axis above 1 (the last section) each block runs on the
rank's heads where they divide the axis: the one-process functions above
are those pieces over every head (``mamba2_heads``, ``rwkv6_time_heads``,
``rwkv6_channel_part``, ...) with the norm over the whole width.

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
from repro_torch.models import sharding_hooks as SH
from repro_torch.models.layers import _span, init_rmsnorm, rms_norm
from repro_torch.models.param_defs import ParamDef
from repro_torch.tree import tree_map

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


def _inproj_cols(s: Mamba2Spec, h0: int, Hl: int):
    """The in-projection's columns that heads [h0, h0 + Hl) read, in the
    order [x, B, C, z, dt] (all of them for every head)."""
    di, ns, P = s.d_inner, s.d_state, s.head_dim
    return ((h0 * P, (h0 + Hl) * P), (di, di + 2 * ns),
            (di + 2 * ns + h0 * P, di + 2 * ns + (h0 + Hl) * P),
            (2 * di + 2 * ns + h0, 2 * di + 2 * ns + h0 + Hl))


def mamba2_heads(params, s: Mamba2Spec, x: torch.Tensor, h0: int, Hl: int):
    """Mamba2 over heads [h0, h0 + Hl) of x (B, T, D), whole over the
    sequence, up to the norm (every head: ``prefill_mamba2``; a rank's heads
    on a model axis above 1): the in-projection columns of those heads of
    the whole ``w_in`` (their x, z and dt; B and C whole), the convolution
    over their channels, the SSD scan of the heads and the skip and gate.
    ``params`` hold ``w_in`` whole and the replicated leaves. Returns (g
    (B, T, Hl P) float32, the input of the norm; the final state (B, Hl, N, P) in x's dtype; the convolution's
    input of its channels (B, T, Hl P + 2 N))."""
    ns, P = s.d_state, s.head_dim
    w_in, conv_w, conv_b = params["w_in"], params["conv_w"], params["conv_b"]
    if Hl < s.n_heads:
        cols = _inproj_cols(s, h0, Hl)
        w_in = torch.cat([w_in[:, a:b] for a, b in cols], dim=1)
        chans = torch.cat([torch.arange(a, b, device=x.device) for a, b in cols[:2]])
        conv_w, conv_b = conv_w[:, chans], conv_b[chans]
    heads = slice(h0, h0 + Hl)
    with _span("mamba2.in"):
        proj = x @ w_in
        w = Hl * P
        xi, Bm, Cm = proj[..., :w], proj[..., w:w + ns], proj[..., w + ns:w + 2 * ns]
        z, dt = proj[..., w + 2 * ns:2 * w + 2 * ns], proj[..., 2 * w + 2 * ns:]
        xBC_in = torch.cat([xi, Bm, Cm], dim=-1)
        xBC = _causal_conv(xBC_in, conv_w, conv_b)
        xi, Bm, Cm = xBC[..., :w], xBC[..., w:w + ns], xBC[..., w + ns:]
        xh = xi.reshape(*xi.shape[:2], Hl, P)
        dt = F.softplus(dt.float() + params["dt_bias"][heads].float())
        A = -torch.exp(params["A_log"][heads].float())
    with _span("mamba2.ssd"):
        y, final = ssd_chunked(xh, dt, A, Bm, Cm, s.chunk)
    with _span("mamba2.out"):  # the skip and the gate, in float32
        h = y.float().add_(params["D"][heads].to(z.dtype).float()[:, None] * xh.float())
        return h.reshape(*z.shape[:-1], -1).mul_(F.silu(z.float())), final, xBC_in


def prefill_mamba2(params, s: Mamba2Spec, x: torch.Tensor):
    """``apply_mamba2``, and the convolution's input (B, T, conv_dim), whose
    last d_conv - 1 rows the decode cache keeps: every head of
    ``mamba2_heads``, then the norm and the output projection."""
    g, final, xBC_in = mamba2_heads(params, s, x, 0, s.n_heads)
    with _span("mamba2.out"):
        return _norm_out(params, g, x.dtype), final, xBC_in


def _norm_out(params, g, dtype):
    """The gated norm's RMS norm of g (float32, the skip and gate applied),
    rounded once to ``dtype`` (the block input's) before ``w_out``."""
    return rms_norm(params["norm"], g).to(dtype) @ params["w_out"].to(dtype)


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


def _decode_conv(params, s: Mamba2Spec, conv: torch.Tensor, xBC_new: torch.Tensor):
    """One token's convolution: the history (B, d_conv - 1, conv_dim) takes
    ``xBC_new`` (B, 1, conv_dim) IN PLACE; returns the convolution and its
    SiLU (B, conv_dim) in float32 (the reference's fused step rounds
    none of them)."""
    hist = torch.cat([conv, xBC_new.to(conv.dtype)], dim=1)
    w = params["conv_w"].float()
    out = hist[:, 0].float() * w[0]
    for i in range(1, s.d_conv):
        out += hist[:, i].float() * w[i]
    conv.copy_(hist[:, 1:])
    return F.silu(out.add_(params["conv_b"].float()))


def decode_mamba2_heads(params, s: Mamba2Spec, proj: torch.Tensor, cache, h0: int, Hl: int):
    """A decode step over heads [h0, h0 + Hl) up to the norm (every head:
    ``decode_mamba2``; a rank's heads on a model axis above 1): ``proj``
    (B, 1, N) the token's whole in-projection. The convolution history
    (whole) takes every channel; the float32 state of the heads
    (B, Hl, N, P) takes ``state * exp(dt A) + dt B x^T`` and is read out
    by C. Both IN PLACE. Returns g (B, 1, Hl P) float32."""
    B = proj.shape[0]
    di, ns, P = s.d_inner, s.d_state, s.head_dim
    heads = slice(h0, h0 + Hl)
    with _span("mamba2.in"):
        xi, Bm, Cm, z, dt = _split_inproj(s, proj)
        xBC = _decode_conv(params, s, cache["conv"], torch.cat([xi, Bm, Cm], dim=-1))
        xh = xBC[:, h0 * P:(h0 + Hl) * P].reshape(B, Hl, P)
        Bm, Cm = xBC[:, di:di + ns], xBC[:, di + ns:]
        dt1 = F.softplus(dt[:, 0, heads].float() + params["dt_bias"][heads].float())
        A = -torch.exp(params["A_log"][heads].float())
    with _span("mamba2.ssd"):
        state = cache["ssm"]
        state.mul_(torch.exp(dt1 * A)[..., None, None]).add_(
            Bm[:, None, :, None] * (xh * dt1[..., None])[:, :, None, :])
        y = torch.einsum("bn,bhnp->bhp", Cm, state)
    with _span("mamba2.out"):  # the skip and the gate, in float32
        h = y.float().add_(params["D"][heads].to(z.dtype).float()[:, None] * xh.float())
        return h.reshape(B, 1, -1).mul_(F.silu(z[..., h0 * P:(h0 + Hl) * P].float()))


def decode_mamba2(params, s: Mamba2Spec, x: torch.Tensor, cache: Dict[str, torch.Tensor], pos):
    """One token x (B, 1, D). Unlike the reference, which returns a new
    cache, this updates ``cache`` IN PLACE: the convolution history
    (B, d_conv - 1, conv_dim) shifts by one row, and the float32 SSM state
    (B, H, N, P) takes ``state * exp(dt A) + dt B x^T``; the readout uses
    the new state (every head of ``decode_mamba2_heads``). ``pos`` is
    unused (the state carries the position). Returns (y (B, 1, D),
    cache)."""
    with _span("mamba2.in"):
        proj = x @ params["w_in"]
    g = decode_mamba2_heads(params, s, proj, cache, 0, s.n_heads)
    with _span("mamba2.out"):
        return _norm_out(params, g, x.dtype), cache


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


def _time_out(params, yg: torch.Tensor) -> torch.Tensor:
    """Normalise the gated output yg and apply ``wo`` as the reference does
    (ssm.py:355): the subscripts sum ``wo`` over e, so this scales the
    normed yg by ``wo.sum(-1)``."""
    return torch.einsum("btd,de->btd", rms_norm(params["ln_out"], yg), params["wo"])


def rwkv6_time_heads(params, s: RWKV6Spec, x: torch.Tensor, xs: torch.Tensor,
                     init_state=None, train: bool = False):
    """The time mix up to its norm over the heads its leaves hold (every
    head with whole leaves; a rank's with ``rwkv6_rank_params``): x (B, T,
    D) and its shifted stream xs, whole; r, k, v, the gate and the
    log-decays of those columns, the recurrence of those heads through the
    scan wrapper (``train``: the plain chunked scan under autograd), times
    the gate. Returns (yg (B, T, Dl) in x's dtype, the
    norm's input; the float32 final state (B, Hl, K, K), None in
    training)."""
    B, T, _ = x.shape
    K = s.head_dim
    r, k, v, g, logw = _time_inputs(params, x, xs)
    Hl = r.shape[-1] // K
    u = params["u"].float().reshape(Hl, K)
    heads = [a.reshape(B, T, Hl, K) for a in (r, k, v, logw)]
    if train:
        with _span("rwkv6.chunked"):
            y, final = scan_ref.rwkv6_chunked(*heads, u, s.chunk)
        y, final = y.to(x.dtype), None
    else:
        y, final = scan_ops.rwkv6_scan(*heads, u, s.chunk, init_state)
    return y.reshape(B, T, -1) * g, final


def rwkv6_time_decode_heads(params, s: RWKV6Spec, x, x_prev, state):
    """A decode step of the time mix up to its norm over the heads its
    leaves hold: the readout from the old state, then the state of those
    heads (B, Hl, K, K) updated IN PLACE. Returns yg (B, 1, Dl)."""
    B = x.shape[0]
    K = s.head_dim
    r, k, v, g, logw = _time_inputs(params, x, x_prev)
    Hl = r.shape[-1] // K
    w = torch.exp(logw).reshape(B, Hl, K)
    u = params["u"].float().reshape(Hl, K)
    r32, k32, v32 = (a.reshape(B, Hl, K).float() for a in (r, k, v))
    out = torch.einsum("bhk,bhkv->bhv", r32, state) + (r32 * u * k32).sum(-1, keepdim=True) * v32
    state.mul_(w[..., None]).add_(k32[..., :, None] * v32[..., None, :])
    return out.reshape(B, 1, -1).to(x.dtype) * g


def apply_rwkv6_time(params, s: RWKV6Spec, x: torch.Tensor, init_state=None, x_prev=None):
    """Prefill over x (B, T, D): every head of ``rwkv6_time_heads`` through
    the scan wrapper, then the norm and ``wo``. Returns (y (B, T, D), the
    float32 final state (B, H, K, K), x's last token (B, 1, D), a view)."""
    yg, final = rwkv6_time_heads(params, s, x, _token_shift(x, x_prev), init_state)
    return _time_out(params, yg), final, x[:, -1:]


def train_rwkv6_time(params, s: RWKV6Spec, x: torch.Tensor) -> torch.Tensor:
    """The time mix's training forward over x (B, T, D) from a zero state,
    differentiable: the reference's ``apply_rwkv6_time`` through its chunked
    scan (``scan_ref.rwkv6_chunked``, chunks of ``s.chunk``) under autograd,
    then the gate, the norm and ``wo``. The prefill's scan kernel has no
    backward; the chunked form is what the reference trains through, the
    same choice as the plain ``_sdpa`` for attention."""
    return _time_out(params, rwkv6_time_heads(params, s, x, _token_shift(x), train=True)[0])


def decode_rwkv6_time(params, s: RWKV6Spec, x, state, x_prev):
    """One token. x, x_prev: (B, 1, D); state: (B, H, K, K) float32. Unlike
    the reference, which returns a new state, this updates ``state`` IN
    PLACE: the readout uses the old state, then ``state.mul_(w).add_(k v^T)``
    (every head of ``rwkv6_time_decode_heads``). Returns (y (B, 1, D),
    state, x)."""
    return _time_out(params, rwkv6_time_decode_heads(params, s, x, x_prev, state)), state, x


def init_rwkv6_channel(s: RWKV6Spec, d_ff: int) -> Dict[str, Any]:
    d = s.d_model
    return {
        "mu_k": ParamDef((d,), (None,), init="ones", scale=0.5),
        "mu_r": ParamDef((d,), (None,), init="ones", scale=0.5),
        "wk": ParamDef((d, d_ff), ("embed", "ffn")),
        "wv": ParamDef((d_ff, d), ("ffn", "embed")),
        "wr": ParamDef((d, d), ("embed", None)),
    }


def rwkv6_channel_part(params, x: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """A rank's part of the channel mix's value path: relu(xk wk)^2 wv over
    its ``wk`` columns and ``wv`` rows (a partial sum where they are
    split). x, xs (B, T, D) whole."""
    xk = _mix(x, xs, params["mu_k"].to(x.dtype))
    return F.relu(xk @ params["wk"]).square() @ params["wv"]


def rwkv6_channel_gate(params, x: torch.Tensor, xs: torch.Tensor, kv: torch.Tensor):
    """The receptance gate of rows x (their shifted stream xs) on the summed
    value path kv: sigmoid(xr wr) kv, ``wr`` whole."""
    return torch.sigmoid(_mix(x, xs, params["mu_r"].to(x.dtype)) @ params["wr"]) * kv


def apply_rwkv6_channel(params, x: torch.Tensor, x_prev=None):
    """Squared-ReLU channel mix over x (B, T, D), the token shift from
    x_prev (decode) or zeros. Returns (y, x's last token (B, 1, D), a view)."""
    xs = _token_shift(x, x_prev)
    return rwkv6_channel_gate(params, x, xs, rwkv6_channel_part(params, x, xs)), x[:, -1:]


# ---------------------------------------------------------------------------
# a "model" mesh axis above 1
# ---------------------------------------------------------------------------
#
# Each block takes its normed input whole over the sequence (the block
# gathers it: recurrent over time) and hands back the rank's rows. A rank
# runs its heads where the heads divide the axis: ``mamba2_heads``,
# ``decode_mamba2_heads``, ``rwkv6_time_heads``, ``rwkv6_time_decode_heads``
# and ``rwkv6_channel_part`` above, then the norm over the whole width
# below (``mamba2_norm_out``, ``rwkv6_time_out``), the collectives outside
# them, so that one process can run every rank's part and combine them as
# the collectives do. Elsewhere (a layout whose split does not hold whole
# heads) every split leaf is gathered whole and every rank runs the block
# whole, keeping its rows: the one-process result on any layout the specs
# give.


def sum_squares(x: torch.Tensor) -> torch.Tensor:
    """The float32 squares of x summed over its last dim (keepdim): a
    rank's share of an RMS norm's mean over a width split over the axis."""
    return x.float().square().sum(dim=-1, keepdim=True)


def rms_norm_parts(scale: torch.Tensor, x: torch.Tensor, ss: torch.Tensor, width: int,
                   eps: float = 1e-6) -> torch.Tensor:
    """``layers.rms_norm`` of the columns ``x`` of a row of ``width``
    columns, given the float32 sum of squares ``ss`` of the whole row and
    ``scale`` at x's columns; in float32, cast back to x's dtype."""
    y = x.float() * torch.rsqrt(ss / width + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def _tree(params) -> Dict[str, Any]:
    """A block's parameters as a dict (a module's ``ParamTree`` or a train
    step's dict), to take replaced leaves."""
    return params.as_dict() if hasattr(params, "as_dict") else dict(params)


def _whole(t: torch.Tensor, dim: int, full: int, tp) -> torch.Tensor:
    """A leaf whole: gathered over "model" along ``dim`` where it is split
    (its gradient reduce-scattered back as a sum over the ranks)."""
    return t if t.shape[dim] == full else SH.gather_seq(t, tp, dim)


def _rows(t: torch.Tensor, tp) -> torch.Tensor:
    Sl = t.shape[1] // tp.size
    return t[:, tp.rank * Sl:(tp.rank + 1) * Sl]


def _whole_rows(y: torch.Tensor, partial: bool, tp) -> torch.Tensor:
    """A block's output of every row, where the sequence does not split
    over the axis: a part summed over "model" in float32, then cast; else
    the output every rank computed alike."""
    return SH.sum_model(y.float(), tp).to(y.dtype) if partial else y


def _inputs_whole(params, x, parts: bool, tp):
    """A block's leaves and input x on a sequence that does not split over
    the axis, in training: x entering the ranks' ``parts`` of the output
    (``SH.to_parts``), or, where every rank computes the block alike, every
    leaf counting once in the gradients (``SH.once_over_model``)."""
    if not torch.is_grad_enabled():
        return params, x
    if parts:
        return params, SH.to_parts(x, tp)
    return tree_map(lambda t: SH.once_over_model(t, tp), params), x


def mamba2_norm_out(scale: torch.Tensor, w_out: torch.Tensor, g: torch.Tensor, ss: torch.Tensor,
                    width: int, dtype) -> torch.Tensor:
    """The gated RMS norm and the output projection of the columns ``g`` of
    the norm's input (``ss`` the float32 squares of the whole width summed;
    ``scale`` and ``w_out``'s rows at g's columns), rounded to ``dtype``
    before ``w_out``: a partial sum of the block's output where g is a
    share of the width."""
    return rms_norm_parts(scale, g, ss, width).to(dtype) @ w_out.to(dtype)


def _mamba2_layout(s: Mamba2Spec, tp):
    """(first head, heads) of this rank: its share where the heads divide
    the axis, else every head."""
    if s.n_heads % tp.size == 0:
        Hl = s.n_heads // tp.size
        return tp.rank * Hl, Hl
    return 0, s.n_heads


def _mamba2_out(params, s: Mamba2Spec, g, tp, dtype):
    """The norm and output projection of a rank's g: (the output, whether it
    is a partial sum over the ranks). On the rank's heads the squares are
    summed over the axis; on every head (g whole) the rank's rows of
    ``w_out`` take its columns of g where ``w_out`` is split."""
    di = s.d_inner
    ss = sum_squares(g)
    wl = params["w_out"].shape[0]
    if g.shape[-1] < di:
        ss = SH.sum_parts(ss, tp)
        c0 = tp.rank * wl
    else:
        c0 = tp.rank * wl if wl < di else 0
        g = g[..., c0:c0 + wl]
    scale = params["norm"]["scale"][c0:c0 + wl]
    return mamba2_norm_out(scale, params["w_out"], g, ss, di, dtype), wl < di


def apply_mamba2_tp(params, s: Mamba2Spec, x: torch.Tensor, tp, with_cache: bool = False,
                    whole: bool = False):
    """Mamba2 on a "model" axis above 1, differentiable: x (B, T, D) whole
    over the sequence on every rank. ``w_in`` is gathered whole (its
    columns split without regard to heads; the weight, 2 d_model N bytes,
    is smaller than its output over the data rank's tokens), each rank
    runs its heads (``mamba2_heads``), the norm's squares are summed over
    the axis (``sum_parts``) and the row-parallel output (the rank's part
    rounded once to x's dtype by its product) reduce-scattered in float32
    into the rank's rows, then cast: the parts summed as
    ``moe_rank_partial``'s are, one rounding after the sum. Returns (y
    (B, T/M, D), and with ``with_cache`` the final state of the rank's
    heads (B, Hl, N, P) and the convolution history (B, d_conv - 1,
    conv_dim), whole on every rank). With ``whole`` (a sequence that does
    not split over the axis) y is every row (B, T, D) (``_whole_rows``)."""
    N = 2 * s.d_inner + 2 * s.d_state + s.n_heads
    p = dict(_tree(params), w_in=_whole(params["w_in"], 1, N, tp))
    h0, Hl = _mamba2_layout(s, tp)
    if whole:
        p, x = _inputs_whole(p, x, params["w_out"].shape[0] < s.d_inner, tp)
    g, final, _ = mamba2_heads(p, s, x, h0, Hl)
    y, partial = _mamba2_out(p, s, g, tp, x.dtype)
    if whole:
        y = _whole_rows(y, partial, tp)
    else:
        y = SH.scatter_seq(y.float(), tp).to(x.dtype) if partial else _rows(y, tp)
    if not with_cache:
        return y
    conv_dim = s.d_inner + 2 * s.d_state
    tail = mamba2_conv_tail(s, x[:, -(s.d_conv - 1):] @ p["w_in"][:, :conv_dim])
    return y, final, tail


def decode_mamba2_tp(params, s: Mamba2Spec, x: torch.Tensor, cache, tp) -> torch.Tensor:
    """``decode_mamba2`` on a "model" axis above 1 (no gradient): the
    token's in-projection columns gathered (a token's are fewer bytes than
    the weight), the rank's heads (``decode_mamba2_heads``), the norm's
    squares and the row-parallel output summed over the axis (in float32,
    then cast, as in ``apply_mamba2_tp``). The cache
    holds the rank's heads' state and the whole convolution history.
    Returns y (B, 1, D), whole on every rank."""
    N = 2 * s.d_inner + 2 * s.d_state + s.n_heads
    proj = x @ params["w_in"]
    if proj.shape[-1] < N:
        proj = SH.gather_model(proj, tp, proj.dim() - 1)
    g = decode_mamba2_heads(params, s, proj, cache, *_mamba2_layout(s, tp))
    y, partial = _mamba2_out(params, s, g, tp, x.dtype)
    return SH.sum_model(y.float(), tp).to(x.dtype) if partial else y


def rwkv6_rank_params(params, tp) -> Dict[str, Any]:
    """A rank's time-mix leaves where its heads divide the axis: the column
    slices it holds of ``wr``, ``wk``, ``wv``, ``wg``, ``w2`` and the rows
    of ``wo``, with the replicated ``w0``, ``u`` and ``ln_out`` cut to its
    columns (the ``mu_*`` and ``w1`` act on the whole input)."""
    Dl = params["wr"].shape[1]
    cols = slice(tp.rank * Dl, (tp.rank + 1) * Dl)
    return dict(_tree(params), w0=params["w0"][cols], u=params["u"][cols],
                ln_out={"scale": params["ln_out"]["scale"][cols]})


def rwkv6_time_out(params, yg: torch.Tensor, ss: torch.Tensor, width: int) -> torch.Tensor:
    """The time mix's norm (``ss`` the float32 squares of the whole width
    summed) and ``wo`` of a rank's columns yg: ``wo``'s rows of those
    columns summed over its output dim, so the result is the rank's columns
    of the block's output, whole."""
    y = rms_norm_parts(params["ln_out"]["scale"], yg, ss, width)
    return torch.einsum("btd,de->btd", y, params["wo"])


def _rwkv6_whole(params, s: RWKV6Spec, tp):
    """The time mix's leaves whole (each split one gathered over "model")."""
    D = s.d_model
    return dict(_tree(params), wo=_whole(params["wo"], 0, D, tp),
                **{k: _whole(params[k], 1, D, tp) for k in ("wr", "wk", "wv", "wg", "w2")})


def apply_rwkv6_time_tp(params, s: RWKV6Spec, x: torch.Tensor, tp, train: bool = False,
                        whole: bool = False):
    """The time mix on a "model" axis above 1: x (B, T, D) whole over the
    sequence on every rank. Where the heads divide the axis, the rank's
    heads (``rwkv6_time_heads``; the prefill's scan kernel at (B, T, H/M,
    K)), the norm's squares summed over the axis (``sum_parts``), the
    rank's columns of the output, whole rows, laid out as the rank's rows
    by one all-to-all (``cols_to_rows``; ``wo`` contracts nothing over its
    split dim, so no reduce-scatter of a sum applies). Otherwise the leaves
    gathered whole and the block run whole, the rank's rows kept. Returns
    (y (B, T/M, D), the final state of the rank's heads (every head where
    they do not divide), None in ``train``). With ``whole`` (a sequence
    that does not split over the axis) y is every row: the ranks' columns
    gathered (``SH.gather_alike``), or the block's own output."""
    if s.n_heads % tp.size:
        p = _rwkv6_whole(params, s, tp)
        if whole:
            p, x = _inputs_whole(p, x, False, tp)
        keep = (lambda y: y) if whole else (lambda y: _rows(y, tp))
        if train:
            return keep(train_rwkv6_time(p, s, x)), None
        y, final, _ = apply_rwkv6_time(p, s, x)
        return keep(y), final
    if whole:
        params, x = _inputs_whole(params, x, True, tp)
    p = rwkv6_rank_params(params, tp)
    yg, final = rwkv6_time_heads(p, s, x, _token_shift(x), train=train)
    y = rwkv6_time_out(p, yg, SH.sum_parts(sum_squares(yg), tp), s.d_model)
    if whole:
        return SH.gather_alike(y, tp, y.dim() - 1), final
    return SH.cols_to_rows(y, tp), final


def decode_rwkv6_time_tp(params, s: RWKV6Spec, x, state, x_prev, tp) -> torch.Tensor:
    """``decode_rwkv6_time`` on a "model" axis above 1 (no gradient): the
    rank's heads, their state (B, H/M, K, K) updated in place, the norm's
    squares summed over the axis and the ranks' columns gathered; where the
    heads do not divide, the leaves gathered whole and the step run whole
    (the state whole). Returns y (B, 1, D), whole on every rank."""
    if s.n_heads % tp.size:
        return decode_rwkv6_time(_rwkv6_whole(params, s, tp), s, x, state, x_prev)[0]
    p = rwkv6_rank_params(params, tp)
    yg = rwkv6_time_decode_heads(p, s, x, x_prev, state)
    y = rwkv6_time_out(p, yg, SH.sum_parts(sum_squares(yg), tp), s.d_model)
    return SH.gather_model(y, tp, y.dim() - 1)


def apply_rwkv6_channel_tp(params, d_ff: int, x: torch.Tensor, tp, x_prev=None,
                           whole: bool = False):
    """The channel mix on a "model" axis above 1: x (B, T, D) whole over the
    sequence on every rank (its token shift reads the row before each
    rank's first). Where ``wk`` and ``wv`` are split, the rank's part is
    reduce-scattered into its rows (a decode step, ``x_prev`` given: summed
    over the axis), in float32 and then cast, as ``apply_mamba2_tp``'s;
    else the whole value path, the rank's rows kept. The
    gate on the rank's rows (``wr`` replicated). Returns the rank's rows
    (B, T/M, D), or in decode the token's whole row. With ``whole`` (a
    sequence that does not split over the axis) every row: the value path's
    parts summed over the axis (x entering them by ``SH.to_parts``), the
    gate, which every rank computes alike, counting ``mu_r`` and ``wr``
    once in the gradients."""
    xs = _token_shift(x, x_prev)
    split = params["wk"].shape[1] < d_ff
    if x_prev is not None:
        kv = rwkv6_channel_part(params, x, xs)
        return rwkv6_channel_gate(params, x, xs,
                                  SH.sum_model(kv.float(), tp).to(x.dtype) if split else kv)
    if whole:
        gate, _ = _inputs_whole({k: params[k] for k in ("mu_r", "wr")}, x, False, tp)
        if split:
            _, xp = _inputs_whole(params, x, True, tp)
            kv = _whole_rows(rwkv6_channel_part(params, xp, _token_shift(xp)), True, tp)
        else:
            value, _ = _inputs_whole(params, x, False, tp)
            kv = rwkv6_channel_part(value, x, xs)
        return rwkv6_channel_gate(gate, x, xs, kv)
    kv = rwkv6_channel_part(params, x, xs)
    kv = SH.scatter_seq(kv.float(), tp).to(x.dtype) if split else _rows(kv, tp)
    return rwkv6_channel_gate(params, _rows(x, tp), _rows(xs, tp), kv)
