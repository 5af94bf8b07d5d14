"""RWKV6 ("Finch", arXiv:2404.05892) blocks: the time mix, a linear
recurrence with a data-dependent decay per channel, and the channel mix.

Port of the RWKV6 half of the reference's ``models/ssm.py``; Mamba2 belongs
to a later slice (ROADMAP.md queue 1). The prefill runs the recurrence
through the linear-scan wrapper (``kernels/linear_scan``): on CUDA tensors
the hand-written kernel, on CPU tensors the plain port of the reference's
chunked scan. Decode is one recurrent step in plain PyTorch, as in the
reference, with the state in the cache updated in place.

The reference's arithmetic is kept where it is unusual: every ``mu_*``
leaf is initialised to ones (its ``init_leaf`` ignores ``scale``), and the
time mix's output is ``einsum("btd,de->btd", y, wo)``, which sums ``wo``
over ``e`` and scales y elementwise (``y * wo.sum(-1)``), not ``y @ wo``
(ROADMAP.md queue 3).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.linear_scan import ops as scan_ops
from repro_torch.models.layers import init_rmsnorm, rms_norm
from repro_torch.models.param_defs import ParamDef


@dataclasses.dataclass(frozen=True)
class RWKV6Spec:
    d_model: int
    head_dim: int = 64
    decay_lora: int = 64
    chunk: int = 128  # chunk length of the CPU path's chunked scan (the kernel ignores it)

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
