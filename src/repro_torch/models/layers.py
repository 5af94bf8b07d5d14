"""Transformer layers of the dense LM family: norms, RoPE, GQA attention,
gated and plain MLPs, embeddings.

Port of the reference's ``models/layers.py`` (dense parts). Each block is a
pair of functions, ``init_<block>`` (a nested dict of ``ParamDef``) and an
apply function over a ``ParamTree``. Layouts are the reference's:
activations (B, S, D), heads (B, S, H, hd), KV cache (B, T, KV, hd).

Serving attention goes through the port's kernels: prefill through the
flash attention wrapper, decode through the flash-decode wrapper. On CUDA
tensors those launch the hand-written CUDA kernels; on CPU tensors they take
the plain versions. The kernels have no backward, so training attention
(``apply_attention``) is the reference's own plain form, ``_sdpa``: two
products and a float32 softmax, differentiated by autograd. Sliding
windows, M-RoPE, MLA and MoE belong to later slices and raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.param_defs import ParamDef
from repro_torch.models.sharding_hooks import shard_act

_LATER = "is not ported yet: it belongs to a later slice of the port (ROADMAP.md queue 1)"

# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int) -> Dict[str, ParamDef]:
    return {"scale": ParamDef((d,), (None,), init="ones")}


def rms_norm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """In float32, scaled by ``1 + scale``, cast back to x's dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(x.dtype)


def init_layernorm(d: int) -> Dict[str, ParamDef]:
    return {
        "scale": ParamDef((d,), (None,), init="ones"),
        "bias": ParamDef((d,), (None,), init="zeros"),
    }


def layer_norm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(rotary_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, rotary_dim, 2, dtype=np.float32) / rotary_dim))


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(rotary_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_freqs`` on ``device``, copied there once: a copy from pageable
    host memory on every call would stall the host at each layer."""
    return torch.from_numpy(rope_freqs(rotary_dim, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, hd), rotated over all of hd; positions: broadcastable to
    (..., S), any integer dtype, on x's device (a device tensor: no host
    sync)."""
    hd = x.shape[-1]
    freqs = _rope_freqs_on(hd, theta, x.device)  # (hd/2,)
    ang = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xr = x.float()
    x1, x2 = xr[..., : hd // 2], xr[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def apply_mrope(*args, **kwargs):
    raise NotImplementedError(f"M-RoPE (qwen2-vl) {_LATER}")


# ---------------------------------------------------------------------------
# attention (full causal GQA)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_heads: int
    kv_heads: int
    head_dim: int
    window: Optional[int] = None        # sliding-window size (None = full)
    rope: str = "std"                    # "std" | "mrope" | "none"
    rope_theta: float = 10000.0
    qk_norm: bool = False
    bias: bool = False


def _check_spec(s: AttnSpec) -> None:
    if s.window is not None:
        raise NotImplementedError(f"sliding-window attention {_LATER}")
    if s.rope == "mrope":
        apply_mrope()
    if s.rope not in ("std", "none"):
        raise ValueError(f"unknown rope {s.rope!r}")


def init_attention(s: AttnSpec) -> Dict[str, Any]:
    d, h, kv, hd = s.d_model, s.n_heads, s.kv_heads, s.head_dim
    defs: Dict[str, Any] = {
        "wq": ParamDef((d, h, hd), ("embed", "heads", None)),
        "wk": ParamDef((d, kv, hd), ("embed", "kv_heads", None)),
        "wv": ParamDef((d, kv, hd), ("embed", "kv_heads", None)),
        "wo": ParamDef((h, hd, d), ("heads", None, "embed")),
    }
    if s.bias:
        defs["bq"] = ParamDef((h, hd), ("heads", None), init="zeros")
        defs["bk"] = ParamDef((kv, hd), ("kv_heads", None), init="zeros")
        defs["bv"] = ParamDef((kv, hd), ("kv_heads", None), init="zeros")
    if s.qk_norm:
        defs["q_norm"] = init_rmsnorm(hd)
        defs["k_norm"] = init_rmsnorm(hd)
    return defs


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk"): one matrix product over the flattened heads."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).view(*x.shape[:-1], h, k)


def _proj_qkv(params, s: AttnSpec, x: torch.Tensor):
    q = _heads(x, params["wq"])
    k = _heads(x, params["wk"])
    v = _heads(x, params["wv"])
    if s.bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if s.qk_norm:
        q = rms_norm(params["q_norm"], q)
        k = rms_norm(params["k_norm"], k)
    return q, k, v


def _rope_qk(s: AttnSpec, q, k, positions):
    if s.rope == "std":
        q = apply_rope(q, positions, s.rope_theta)
        k = apply_rope(k, positions, s.rope_theta)
    return q, k


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") for out (B, S, H, hd) laid out contiguously."""
    h, k, d = wo.shape
    return out.reshape(*out.shape[:-2], h * k) @ wo.reshape(h * k, d)


def prefill_attention(params, s: AttnSpec, x: torch.Tensor, positions: torch.Tensor):
    """Full-sequence causal self-attention. Returns (y (B, S, D), k, v), k and
    v (B, S, KV, hd) for the cache. The attention itself is one call of the
    flash-attention wrapper on (B, H, S, hd) views of the (B, S, H, hd)
    projections: no copy, no repeat of the KV heads."""
    _check_spec(s)
    q, k, v = _proj_qkv(params, s, x)
    q, k = _rope_qk(s, q, k, positions)
    out = flash_ops.attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    )  # (B, H, S, hd) with q's (B, S, H, hd) strides
    return _out_proj(out.transpose(1, 2), params["wo"]), k, v


def _sdpa(q, k, v, mask, n_rep: int) -> torch.Tensor:
    """The reference's plain attention: q (B, S, H, hd); k, v (B, T, KV, hd);
    mask broadcastable to (B, 1, S, T). Scores in q's dtype, then float32
    (scaled, masked, softmax), probabilities back in q's dtype."""
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=2)
        v = v.repeat_interleave(n_rep, dim=2)
    scale = 1.0 / np.sqrt(q.shape[-1])
    logits = torch.einsum("bshk,bthk->bhst", q, k).float() * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhst,bthk->bshk", probs, v)


def causal_mask(S: int, T: int, window: Optional[int] = None, offset: int = 0,
                device="cpu") -> torch.Tensor:
    """(1, 1, S, T) bool mask; ``offset`` is the position of query row 0
    within the T axis."""
    qi = torch.arange(S, device=device)[:, None] + offset
    kj = torch.arange(T, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m = m & (kj > qi - window)
    return m[None, None]


def apply_attention(params, s: AttnSpec, x: torch.Tensor, positions: torch.Tensor,
                    mask: Optional[torch.Tensor] = None):
    """Full-sequence causal self-attention for training, differentiable:
    ``_sdpa``, never a kernel. The activations take the reference's
    sequence-parallel layout (q sharded over the sequence, k and v
    gathered): the identity on a mesh whose model axis is 1
    (``sharding_hooks``)."""
    _check_spec(s)
    S = x.shape[1]
    q, k, v = _proj_qkv(params, s, x)
    q, k = _rope_qk(s, q, k, positions)
    q = shard_act(q, ("batch", "act_seq", None, None))
    k = shard_act(k, ("batch", None, None, None))
    v = shard_act(v, ("batch", None, None, None))
    if mask is None:
        mask = causal_mask(S, S, s.window, device=x.device)
    out = _sdpa(q, k, v, mask, s.n_heads // s.kv_heads)
    return _out_proj(out, params["wo"])


def init_attn_cache(s: AttnSpec, batch: int, seq_len: int, dtype=torch.bfloat16):
    """KV cache defs for decode: full layers keep ``seq_len`` positions."""
    _check_spec(s)
    shape = (batch, seq_len, s.kv_heads, s.head_dim)
    axes = ("batch", "kv_seq", "kv_heads", None)
    return {
        "k": ParamDef(shape, axes, init="zeros", dtype=dtype),
        "v": ParamDef(shape, axes, init="zeros", dtype=dtype),
    }


def decode_attention(
    params,
    s: AttnSpec,
    x: torch.Tensor,                  # (B, 1, D) the new token
    cache: Dict[str, torch.Tensor],   # k, v (B, T, KV, hd)
    pos: torch.Tensor,                # () int32 on x's device: tokens already cached
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One new token against the KV cache. Unlike the reference, which
    returns a new cache, this writes the token's k and v into ``cache`` IN
    PLACE at slot ``pos`` and returns the same dict. ``pos`` stays on the
    device: the cache write, RoPE and the kernel read it there, so the step
    needs no host sync."""
    _check_spec(s)
    B = x.shape[0]
    q, k_new, v_new = _proj_qkv(params, s, x)
    positions = pos.reshape(1, 1).expand(B, 1)
    q, k_new = _rope_qk(s, q, k_new, positions)
    kc, vc = cache["k"], cache["v"]
    if kc.dtype != q.dtype:
        raise ValueError(f"cache dtype {kc.dtype} != activation dtype {q.dtype}")
    slot = pos.reshape(1).long()
    kc.index_copy_(1, slot, k_new)
    vc.index_copy_(1, slot, v_new)
    out = decode_ops.decode(q[:, 0], kc.transpose(1, 2), vc.transpose(1, 2), pos)  # (B, H, hd)
    return _out_proj(out[:, None], params["wo"]), cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    d_model: int
    d_ff: int
    activation: str = "silu"  # silu (SwiGLU) | gelu (GeGLU) | relu2
    gated: bool = True        # False = plain 2-matrix MLP (e.g. Nemotron relu2)


def init_mlp(s: MLPSpec) -> Dict[str, Any]:
    defs = {
        "wu": ParamDef((s.d_model, s.d_ff), ("embed", "ffn")),
        "wd": ParamDef((s.d_ff, s.d_model), ("ffn", "embed")),
    }
    if s.gated:
        defs["wg"] = ParamDef((s.d_model, s.d_ff), ("embed", "ffn"))
    return defs


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    if name == "relu2":
        return F.relu(x).square()
    raise ValueError(name)


def apply_mlp(params, s: MLPSpec, x: torch.Tensor) -> torch.Tensor:
    if s.gated:
        h = _act(s.activation, x @ params["wg"]) * (x @ params["wu"])
    else:
        h = _act(s.activation, x @ params["wu"])
    return h @ params["wd"]


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------


def init_embedding(vocab: int, d_model: int) -> Dict[str, Any]:
    return {"table": ParamDef((vocab, d_model), ("vocab", "embed"), init="embed", scale=0.02)}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]
