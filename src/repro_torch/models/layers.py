"""Transformer layers: norms, RoPE and M-RoPE, GQA, sliding-window,
bidirectional and cross attention, MLA, gated and plain MLPs, MoE with
sort-based capacity dispatch, embeddings.

Port of the reference's ``models/layers.py``. Each block is a pair of
functions, ``init_<block>`` (a nested dict of ``ParamDef``) and an apply
function over a ``ParamTree``. Layouts are the reference's: activations
(B, S, D), heads (B, S, H, hd), KV cache (B, T, KV, hd), MLA cache (B, T,
kv_lora) and (B, T, qk_rope). A sliding-window layer's KV cache is a ring
of min(seq_len, window) slots: the token at position p lives in slot
p % T, as in the reference.

Serving attention goes through the port's kernels: prefill through the
flash attention wrapper, decode through the flash-decode wrapper. On CUDA
tensors those launch the hand-written CUDA kernels; on CPU tensors they take
the plain versions. The kernels have no backward, so training attention
(``apply_attention``) is the reference's own plain form, ``_sdpa``: two
products and a float32 softmax, differentiated by autograd. MLA and MoE
are plain PyTorch, as in the reference (MLA's q/k and v head sizes differ,
which the attention kernels do not take). Whisper's encoder attention is
the flash kernel without the causal mask, its cross-attention the flash
kernel with the encoder's keys (query and key lengths differ) in the
prefill and the flash-decode kernel over all of them in decode.

On a "model" mesh axis above 1 (tensor parallelism) a layer holds its
rank's shards and its layout follows them: attention (causal, over a
sliding window, with RoPE or M-RoPE) and MLA whose query heads divide the
axis are head-parallel (the block input whole over the sequence, the
rank's heads, a partial output that the caller reduces; MLA's latent and
rope key computed whole on every rank), otherwise sequence-parallel (the
rank's query rows at their offset against k and v, or MLA's latent and
rope key, gathered over the sequence; the prefill through the flash
kernel at a query offset, over the window too); the MLP's columns then
rows are split over ``ffn`` where it divides. Decode attends over the
rank's slots of a sequence-split cache (a full cache, a window's ring, or
MLA's latent cache) and merges the ranks' partials by their log-sum-exp:
attention through the decode kernel's partial form
(``_decode_attention_cp``), MLA in plain PyTorch (``_decode_mla_cp``).
The ranks of that merge are the decode step's context-parallel group
(``sharding_hooks.context_parallel``): the "model" axis, or under the
long-context rules the data x model ranks of a pod, a "model" axis of 1
included; the heads' gathers stay on "model".
The layout changes are ``sharding_hooks``'s. The MoE block takes the
reference's three modes (``moe_mode``: expert-parallel, ffn-parallel,
replicated) on the data rank's whole sequence: each rank's float32 part
(``moe_rank_partial``) summed over the axis into its rows
(``_apply_moe_tp``).
"""
from __future__ import annotations

import dataclasses
import functools
from contextlib import nullcontext
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.profiler import record_function

from repro_torch.core.sharded import model_size
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import sharding_hooks
from repro_torch.models.param_defs import ParamDef
from repro_torch.models.sharding_hooks import shard_act
from repro_torch.tree import tree_map

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


@functools.lru_cache(maxsize=None)
def _mrope_components(sections: Tuple[int, int, int], device: torch.device) -> torch.Tensor:
    """The position component (0, 1, 2 for t, h, w) of each frequency pair,
    on ``device``, copied there once."""
    return torch.from_numpy(np.repeat(np.arange(3), sections)).to(device)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float = 1000000.0,
                sections: Tuple[int, int, int] = (16, 24, 24)) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE, in float32: x (..., S, H, hd);
    positions3 (3, ..., S) the (t, h, w) ids, on x's device. The rotary
    spectrum ``rope_freqs(hd, theta)`` is cut into three sections of
    ``sections`` frequency pairs, each rotated by its own component's
    positions."""
    hd = x.shape[-1]
    if 2 * sum(sections) != hd:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to head_dim / 2 = {hd // 2}")
    freqs = _rope_freqs_on(hd, theta, x.device)  # (hd/2,)
    comp = _mrope_components(tuple(sections), x.device)  # (hd/2,)
    pos = positions3.float().index_select(0, comp).movedim(0, -1)  # (..., S, hd/2)
    ang = pos * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x32 = x.float()
    x1, x2 = x32[..., : hd // 2], x32[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA: causal, sliding-window, bidirectional, cross)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_heads: int
    kv_heads: int
    head_dim: int
    window: Optional[int] = None        # sliding-window size (None = full)
    causal: bool = True                  # False for encoder self-attention
    rope: str = "std"                    # "std" | "mrope" | "none"
    rope_theta: float = 10000.0
    qk_norm: bool = False
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    bias: bool = False


def _check_spec(s: AttnSpec) -> None:
    if s.window is not None and s.window < 1:
        raise ValueError(f"window must be at least 1, got {s.window}")
    if s.rope not in ("std", "mrope", "none"):
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


def _pick(w: torch.Tensor, kv, dim: int) -> torch.Tensor:
    """Heads ``kv`` (a slice or an index tensor) of ``w`` along ``dim``."""
    if isinstance(kv, slice):
        return w.narrow(dim, kv.start, kv.stop - kv.start)
    return w.index_select(dim, kv)


def _proj_qkv(params, s: AttnSpec, x: torch.Tensor, kv=None):
    """q, k, v of x (B, S, D) on the heads that the parameters hold (a
    rank's shard on a tensor-parallel mesh); ``kv`` (a slice or an index
    tensor) takes only those kv heads of whole k and v weights."""
    wk, wv = params["wk"], params["wv"]
    if kv is not None:
        wk, wv = _pick(wk, kv, 1), _pick(wv, kv, 1)
    q = _heads(x, params["wq"])
    k = _heads(x, wk)
    v = _heads(x, wv)
    if s.bias:
        bk, bv = params["bk"], params["bv"]
        if kv is not None:
            bk, bv = _pick(bk, kv, 0), _pick(bv, kv, 0)
        q = q + params["bq"]
        k = k + bk
        v = v + bv
    if s.qk_norm:
        q = rms_norm(params["q_norm"], q)
        k = rms_norm(params["k_norm"], k)
    return q, k, v


def _rope_qk(s: AttnSpec, q, k, positions):
    """RoPE of q and k: ``positions`` (B, S) for "std", (3, B, S) for
    "mrope"; "none" leaves them as they are."""
    if s.rope == "std":
        q = apply_rope(q, positions, s.rope_theta)
        k = apply_rope(k, positions, s.rope_theta)
    elif s.rope == "mrope":
        q = apply_mrope(q, positions, s.rope_theta, s.mrope_sections)
        k = apply_mrope(k, positions, s.rope_theta, s.mrope_sections)
    return q, k


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") for out (B, S, H, hd) laid out contiguously."""
    h, k, d = wo.shape
    return out.reshape(*out.shape[:-2], h * k) @ wo.reshape(h * k, d)


def _flash(q, k, v, causal: bool = True, window: Optional[int] = None,
           q_offset: Optional[int] = None) -> torch.Tensor:
    """The flash-attention wrapper on (B, H, S, hd) views of (B, S, heads,
    hd) tensors: no copy, no repeat of the KV heads. Returns (B, Sq, H, hd)
    laid out contiguously."""
    kw = {} if q_offset is None else {"q_offset": q_offset}
    out = flash_ops.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              causal=causal, window=window, **kw)
    return out.transpose(1, 2)  # the kernel's output has q's (B, S, H, hd) strides


def prefill_attention(params, s: AttnSpec, x: torch.Tensor, positions: torch.Tensor):
    """Full-sequence self-attention: causal (over the layer's window if it
    has one) or, for an encoder (``s.causal`` False), bidirectional.
    Returns (y (B, S, D), k, v), k and v (B, S, KV, hd) for the cache. The
    attention itself is one call of the flash-attention wrapper. On a
    tensor-parallel mesh (``_prefill_attention_tp``) y is the rank's part
    and k, v are whole (every kv head, every position)."""
    _check_spec(s)
    tp = sharding_hooks.tensor_parallel()
    if tp is not None:
        return _prefill_attention_tp(params, s, x, positions, tp)
    return prefill_attention_whole(params, s, x, positions)


def prefill_attention_whole(params, s: AttnSpec, x: torch.Tensor, positions: torch.Tensor):
    """``prefill_attention`` over every row of x and every head the weights
    hold, whatever the mesh: one process's, or a tensor-parallel rank's
    where the rows do not split (whisper)."""
    q, k, v = _proj_qkv(params, s, x)
    q, k = _rope_qk(s, q, k, positions)
    out = _flash(q, k, v, causal=s.causal, window=s.window)
    return _out_proj(out, params["wo"]), k, v


def cross_kv(params, s: AttnSpec, enc: torch.Tensor):
    """The encoder output's keys and values for cross-attention, each
    (B, S_enc, KV, hd) with their biases: computed once per request and
    kept in the cache."""
    k = _heads(enc, params["wk"])
    v = _heads(enc, params["wv"])
    if s.bias:
        k, v = k + params["bk"], v + params["bv"]
    return k, v


def _cross_q(params, s: AttnSpec, x: torch.Tensor) -> torch.Tensor:
    q = _heads(x, params["wq"])
    return q + params["bq"] if s.bias else q


def cross_attention(params, s: AttnSpec, x: torch.Tensor, ek: torch.Tensor,
                    ev: torch.Tensor) -> torch.Tensor:
    """Decoder rows x (B, Sq, D) against every key of the encoder's ek, ev
    (B, S_enc, KV, hd), no mask and no RoPE: one call of the flash-attention
    wrapper with Sq query rows and S_enc keys."""
    out = _flash(_cross_q(params, s, x), ek, ev, causal=False)
    return _out_proj(out, params["wo"])


def decode_cross_attention(params, s: AttnSpec, x: torch.Tensor, ek: torch.Tensor,
                           ev: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """One decoder token x (B, 1, D) against every key of the encoder's ek,
    ev (B, S_enc, KV, hd): the flash-decode wrapper with ``last`` a 0-d
    int32 device tensor holding S_enc - 1 (keys 0..S_enc-1), made once per
    cache, so the step needs no host sync."""
    q = _cross_q(params, s, x)
    out = decode_ops.decode(q[:, 0], ek.transpose(1, 2), ev.transpose(1, 2), last)
    return _out_proj(out[:, None], params["wo"])


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


def _head_layout(params, s: AttnSpec, tp):
    """On a tensor-parallel mesh: None where the query heads are whole
    (sequence-parallel attention), else (kv, n_rep) for the rank's heads:
    ``kv`` None when the kv heads are split too (the rank's own), else the
    kv heads its query heads read from whole k and v weights (a slice, or
    an index tensor where its heads straddle groups unevenly), and the
    query heads per kv head among them."""
    Hl = params["wq"].shape[1]
    if Hl == s.n_heads:
        return None
    if params["wk"].shape[1] < s.kv_heads:
        return None, Hl // params["wk"].shape[1]
    # the kv heads are whole only where the axis does not divide them, so
    # the rank's Hl query heads never span whole groups of n_rep
    n_rep = s.n_heads // s.kv_heads
    h0 = tp.rank * Hl
    if n_rep % Hl == 0:
        return slice(h0 // n_rep, h0 // n_rep + 1), Hl
    return torch.arange(h0, h0 + Hl, device=params["wq"].device) // n_rep, 1


def _apply_attention_tp(params, s: AttnSpec, x, positions, tp):
    """Training attention on a tensor-parallel mesh. Head-parallel: x (B,
    S, D) whole over the sequence, ``positions`` (B, S); returns the
    rank's heads' part of the output projection (the caller
    reduce-scatters it). Sequence-parallel: x the rank's rows (B, S/M, D)
    at ``positions``; k and v gathered over the sequence, the causal mask
    at the rows' offset; returns the rows' output."""
    heads = _head_layout(params, s, tp)
    if heads is None:
        Sl = x.shape[1]
        q, k, v = _proj_qkv(params, s, x)
        q, k = _rope_qk(s, q, k, positions)
        k = sharding_hooks.gather_seq(k, tp)
        v = sharding_hooks.gather_seq(v, tp)
        mask = (causal_mask(Sl, k.shape[1], s.window, offset=tp.rank * Sl, device=x.device)
                if s.causal else None)
        n_rep = s.n_heads // s.kv_heads
    else:
        kv, n_rep = heads
        q, k, v = _proj_qkv(params, s, x, kv)
        q, k = _rope_qk(s, q, k, positions)
        mask = causal_mask(x.shape[1], x.shape[1], s.window, device=x.device) if s.causal else None
    with _span("sdpa"):
        out = _sdpa(q, k, v, mask, n_rep)
    return _out_proj(out, params["wo"])


def _prefill_attention_tp(params, s: AttnSpec, x, positions, tp):
    """``prefill_attention`` on a tensor-parallel mesh, as
    ``_apply_attention_tp`` lays it out, through the flash kernel: the
    rank's heads over the whole sequence, or its query rows at their
    offset (``q_offset``) against the gathered keys. Returns (y, k, v) with
    k and v whole for the cache."""
    heads = _head_layout(params, s, tp)
    if heads is None:
        Sl = x.shape[1]
        q, k, v = _proj_qkv(params, s, x)
        q, k = _rope_qk(s, q, k, positions)
        k = sharding_hooks.gather_model(k, tp, 1)
        v = sharding_hooks.gather_model(v, tp, 1)
        # an encoder's rows see every key: no offset
        out = _flash(q, k, v, causal=s.causal, window=s.window,
                     q_offset=tp.rank * Sl if s.causal else None)
        return _out_proj(out, params["wo"]), k, v
    kv, _ = heads
    q, k, v = _proj_qkv(params, s, x)  # every kv head the weights hold
    q, k = _rope_qk(s, q, k, positions)
    if kv is None:  # the rank's own kv heads; the cache takes all of them
        ka, va = k, v
        k = sharding_hooks.gather_model(k, tp, 2)
        v = sharding_hooks.gather_model(v, tp, 2)
    else:
        ka, va = _pick(k, kv, 2), _pick(v, kv, 2)
    out = _flash(q, ka, va, causal=s.causal, window=s.window)
    return _out_proj(out, params["wo"]), k, v


def apply_attention(params, s: AttnSpec, x: torch.Tensor, positions: torch.Tensor,
                    mask: Optional[torch.Tensor] = None):
    """Full-sequence self-attention for training, differentiable: causal
    (over the layer's window if it has one) or, for an encoder (``s.causal``
    False), bidirectional; ``_sdpa``, never a kernel. The activations take
    the reference's sequence-parallel layout (q sharded over the sequence,
    k and v gathered): the identity on a mesh whose model axis is 1
    (``sharding_hooks``); above 1, ``_apply_attention_tp``."""
    _check_spec(s)
    tp = sharding_hooks.tensor_parallel()
    if tp is not None and mask is None:
        return _apply_attention_tp(params, s, x, positions, tp)
    return attention_whole(params, s, x, positions, mask)


def attention_whole(params, s: AttnSpec, x: torch.Tensor, positions: torch.Tensor,
                    mask: Optional[torch.Tensor] = None):
    """``apply_attention`` over every row of x and every head the weights
    hold, whatever the mesh: one process's, or a tensor-parallel rank's
    where the rows do not split (whisper)."""
    S = x.shape[1]
    q, k, v = _proj_qkv(params, s, x)
    q, k = _rope_qk(s, q, k, positions)
    q = shard_act(q, ("batch", "act_seq", None, None))
    k = shard_act(k, ("batch", None, None, None))
    v = shard_act(v, ("batch", None, None, None))
    if mask is None and s.causal:
        mask = causal_mask(S, S, s.window, device=x.device)
    with _span("sdpa"):
        out = _sdpa(q, k, v, mask, s.n_heads // s.kv_heads)
    return _out_proj(out, params["wo"])


def attn_cache_len(s: AttnSpec, seq_len: int) -> int:
    """The slots of a layer's KV cache: a sliding-window layer keeps only
    its window (a ring), a full layer ``seq_len``."""
    return min(seq_len, s.window) if s.window is not None else seq_len


def init_attn_cache(s: AttnSpec, batch: int, seq_len: int, dtype=torch.bfloat16):
    """KV cache defs for decode: sliding-window layers keep
    min(seq_len, window) slots (a ring), full layers ``seq_len``."""
    _check_spec(s)
    shape = (batch, attn_cache_len(s, seq_len), s.kv_heads, s.head_dim)
    axes = ("batch", "kv_seq", "kv_heads", None)
    return {
        "k": ParamDef(shape, axes, init="zeros", dtype=dtype),
        "v": ParamDef(shape, axes, init="zeros", dtype=dtype),
    }


def _decode_positions(s: AttnSpec, pos: torch.Tensor, B: int) -> torch.Tensor:
    """The decode token's positions for ``_rope_qk``: ``pos`` as (B, 1) or,
    for M-RoPE, on all three components (3, B, 1), as the reference rotates
    a text token."""
    positions = pos.reshape(1, 1).expand(B, 1)
    return positions[None].expand(3, B, 1) if s.rope == "mrope" else positions


def decode_attention(
    params,
    s: AttnSpec,
    x: torch.Tensor,                  # (B, 1, D) the new token
    cache: Dict[str, torch.Tensor],   # k, v (B, T, KV, hd)
    pos: torch.Tensor,                # () int32 on x's device: tokens already cached
    slots: Optional[int] = None,      # the whole cache's slots (None: in the step's layout)
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One new token against the KV cache. Unlike the reference, which
    returns a new cache, this writes the token's k and v into ``cache`` IN
    PLACE at slot ``pos`` (a sliding-window layer's ring: ``pos % T``) and
    returns the same dict. The kernel takes the absolute ``pos``: keys
    0..pos, all T slots once pos >= T, which for a ring is the reference's
    mask (every slot valid once the ring has wrapped, else slots 0..pos).
    ``pos`` stays on the device: the cache write, RoPE and the kernel read
    it there, so the step needs no host sync. M-RoPE rotates the token at
    ``pos`` on all three components, as the reference does (a text token's
    positions advance together). Under a decode step whose context-parallel
    group is above 1 (``sharding_hooks.context_parallel``: "model", or
    ("data", "model") under the long-context rules) the cache is that
    rank's share of the slots (``_decode_attention_cp``), unless ``slots``,
    the whole cache's, says that the rank holds all of them (a cache whose
    slots do not divide the group, beside others that do: each layer
    decodes in its own layout, ``decode_attention_local``)."""
    _check_spec(s)
    cp = sharding_hooks.context_parallel()
    if cp is not None and (slots is None or cache["k"].shape[1] < slots):
        return _decode_attention_cp(params, s, x, cache, pos,
                                    sharding_hooks.tensor_parallel(), cp)
    return decode_attention_local(params, s, x, cache, pos)


def decode_attention_local(params, s: AttnSpec, x, cache, pos, tp=None):
    """``decode_attention`` over a cache that this rank holds whole over
    its slots (where the reference's specs keep them whole: the step's
    batch takes "data", or the slots do not divide the axis), on the heads
    its weights hold: all of them; or, on a tensor-parallel mesh (``tp``,
    by default the step's "model" axis), its own, over its own kv heads'
    cache (the kv heads split too) or over the kv heads they read of a
    whole cache (``_whole_cache_heads``)."""
    q, k_new, v_new = _proj_qkv(params, s, x)
    q, k_new = _rope_qk(s, q, k_new, _decode_positions(s, pos, x.shape[0]))
    kc, vc = cache["k"], cache["v"]
    if kc.dtype != q.dtype:
        raise ValueError(f"cache dtype {kc.dtype} != activation dtype {q.dtype}")
    slot = (pos % kc.shape[1] if s.window is not None else pos).reshape(1).long()
    kc.index_copy_(1, slot, k_new)
    vc.index_copy_(1, slot, v_new)
    Hl, KVc = q.shape[2], kc.shape[2]
    if Hl == KVc * (s.n_heads // s.kv_heads) or KVc == 1:
        out = decode_ops.decode(q[:, 0], kc.transpose(1, 2), vc.transpose(1, 2), pos)  # (B, H, hd)
    else:
        out = _whole_cache_heads(q[:, 0], kc, vc, pos, s, tp or sharding_hooks.tensor_parallel())
    return _out_proj(out[:, None], params["wo"]), cache


def whole_cache_groups(h0: int, Hl: int, n_rep: int):
    """The kv heads that query heads h0..h0+Hl-1 read (kv head h // n_rep),
    each with the slice of those query heads that read it: [(kv head,
    slice of the Hl heads)], in head order. One entry where all of them
    fall in one kv head; where they straddle kv heads, one per kv head
    touched."""
    out = []
    for g in range(h0 // n_rep, (h0 + Hl - 1) // n_rep + 1):
        lo, hi = max(h0, g * n_rep), min(h0 + Hl, (g + 1) * n_rep)
        out.append((g, slice(lo - h0, hi - h0)))
    return out


def _whole_cache_heads(q, kc, vc, pos, s: AttnSpec, tp):
    """A rank's query heads q (B, Hl, hd) (heads tp.rank Hl.. of
    ``s.n_heads``) over a whole cache kc, vc (B, T, KV, hd) of several kv
    heads: one decode call per kv head they read (``whole_cache_groups``),
    on that kv head's slice of the cache, a strided view (no copy), its
    GQA group the rank's heads that read it; the outputs concatenated in
    head order (B, Hl, hd)."""
    Hl = q.shape[1]
    outs = [decode_ops.decode(q[:, hs], kc[:, :, g:g + 1].transpose(1, 2),
                              vc[:, :, g:g + 1].transpose(1, 2), pos)
            for g, hs in whole_cache_groups(tp.rank * Hl, Hl, s.n_heads // s.kv_heads)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _owned_slot(pos: torch.Tensor, T: int, cp, ring: bool):
    """The token's slot in a cache of N T slots split over the N ranks of
    the context-parallel group ``cp`` (rank r slots [r T, (r+1) T)): slot
    ``pos`` of a full cache, ``pos % (N T)`` of a ring. Returns (this
    rank's slot of it, clamped into 0..T-1: a (1,) index, and whether this
    rank owns it), both on the device: no host sync."""
    glob = pos.reshape(1).long()
    if ring:
        glob = glob % (cp.size * T)
    local = glob - cp.rank * T
    return local.clamp(0, T - 1), (local >= 0) & (local < T)


def _write_owned(cache: torch.Tensor, slot, own, new: torch.Tensor) -> None:
    """``new`` into ``cache``'s ``slot`` along dim 1 where this rank owns
    it, else what the slot holds back (every rank runs the same ops)."""
    own = own.reshape((1,) * cache.dim())
    cache.index_copy_(1, slot, torch.where(own, new.to(cache.dtype), cache.index_select(1, slot)))


def _decode_attention_cp(params, s: AttnSpec, x, cache, pos, tp, cp):
    """Context-parallel decode over the N ranks of ``cp`` (the "model" axis,
    or ("data", "model") flattened under the long-context rules): rank r
    holds slots [r T, (r+1) T) of a cache of N T slots (k, v (B, T, KV,
    hd), every kv head): a full cache or a sliding-window layer's ring. The
    token's q, k and v are gathered over the heads where ``tp`` (the
    "model" axis, None when it is 1) splits them (small tensors), the rank
    that owns its slot (``pos``, or ``pos % (N T)`` on a ring) writes k and
    v there (the others write back what they hold: no host sync), each
    rank runs the decode kernel's partial form over its slots (global slot
    ``r T + j`` attended when it is at most ``pos``: on a ring, every slot
    once it has wrapped, as ``decode_attention``), and the ranks' partials
    are merged by their log-sum-exp in rank order (float32, rounded to q's
    dtype once). M-RoPE rotates the token at ``pos`` on all three
    components. Returns the output projection of the rank's heads (a
    partial sum the caller all-reduces over "model") or, where the heads
    are whole, of all of them."""
    q, k_new, v_new = _proj_qkv(params, s, x)
    q, k_new = _rope_qk(s, q, k_new, _decode_positions(s, pos, x.shape[0]))
    if q.shape[2] < s.n_heads:
        q = sharding_hooks.gather_model(q, tp, 2)
    if k_new.shape[2] < s.kv_heads:
        k_new = sharding_hooks.gather_model(k_new, tp, 2)
        v_new = sharding_hooks.gather_model(v_new, tp, 2)
    kc, vc = cache["k"], cache["v"]
    if kc.dtype != q.dtype:
        raise ValueError(f"cache dtype {kc.dtype} != activation dtype {q.dtype}")
    T = kc.shape[1]
    slot, own = _owned_slot(pos, T, cp, ring=s.window is not None)
    _write_owned(kc, slot, own, k_new)
    _write_owned(vc, slot, own, v_new)
    merged = merge_over(cp, *decode_ops.decode(q[:, 0], kc.transpose(1, 2), vc.transpose(1, 2),
                                               pos, slot0=cp.rank * T, return_lse=True),
                        q.dtype)  # (B, H, hd)
    wo = params["wo"]
    Hl = wo.shape[0]
    if Hl < s.n_heads:
        merged = merged[:, tp.rank * Hl:(tp.rank + 1) * Hl]
    return _out_proj(merged[:, None], wo), cache


def merge_over(cp, out: torch.Tensor, lse: torch.Tensor, dtype) -> torch.Tensor:
    """The N ranks' float32 partials (out (B, H, D), lse (B, H)) of one
    cache, gathered over ``cp`` and merged in rank order by their
    log-sum-exp, cast to ``dtype`` once (``decode_ops.merge_partials``)."""
    outs = sharding_hooks.gather_model(out[None], cp, 0)
    lses = sharding_hooks.gather_model(lse[None], cp, 0)
    return decode_ops.merge_partials(outs, lses, dtype)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MLASpec:
    d_model: int
    n_heads: int
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128
    rope_theta: float = 10000.0


def init_mla(s: MLASpec) -> Dict[str, Any]:
    d, h = s.d_model, s.n_heads
    return {
        "wq": ParamDef((d, h, s.qk_nope + s.qk_rope), ("embed", "heads", None)),
        "wdkv": ParamDef((d, s.kv_lora), ("embed", None)),
        "wk_rope": ParamDef((d, s.qk_rope), ("embed", None)),
        "kv_norm": init_rmsnorm(s.kv_lora),
        "wuk": ParamDef((s.kv_lora, h, s.qk_nope), (None, "heads", None)),
        "wuv": ParamDef((s.kv_lora, h, s.v_head), (None, "heads", None)),
        "wo": ParamDef((h, s.v_head, d), ("heads", None, "embed")),
    }


def _mla_q(params, s: MLASpec, x, positions):
    """q_nope (B, S, H, nope) and the rotated q_rope (B, S, H, rope)."""
    q = _heads(x, params["wq"])
    return q[..., : s.qk_nope], apply_rope(q[..., s.qk_nope:], positions, s.rope_theta)


def _mla_kv(params, s: MLASpec, x, positions):
    """What the cache keeps of each token: the normed latent (B, S, kv_lora)
    and the rotated key part shared by all heads (B, S, qk_rope)."""
    latent = rms_norm(params["kv_norm"], x @ params["wdkv"])
    k_rope = apply_rope((x @ params["wk_rope"])[:, :, None, :], positions, s.rope_theta)
    return latent, k_rope[:, :, 0, :]


def _masked_softmax(logits, valid, dtype, scale):
    """The reference's float32 softmax of ``logits`` (in the activations'
    dtype) times ``scale``, invalid keys at finfo(float32).min, back in
    ``dtype``. In place where autograd allows: at full width the scores are
    the prefill's largest tensors."""
    l32 = logits.float()
    l32.mul_(scale)
    l32.masked_fill_(~valid, torch.finfo(torch.float32).min)
    return torch.softmax(l32, dim=-1).to(dtype)


def _mla_scale(s: MLASpec) -> float:
    return 1.0 / np.sqrt(s.qk_nope + s.qk_rope)


def prefill_mla(params, s: MLASpec, x: torch.Tensor, positions: torch.Tensor):
    """Training / prefill MLA in the plain (expanded) form. Returns
    (y (B, S, D), latent, k_rope), the last two for the cache, whole over
    the sequence.

    On a tensor-parallel mesh (the reference's specs: ``wq``, ``wuk``,
    ``wuv`` and ``wo`` split over "heads", ``wdkv``, ``wk_rope`` and
    ``kv_norm`` whole) the layout follows the weights: where the heads are
    split (head-parallel) x is whole over the sequence and y is the rank's
    heads' part of the output projection (the caller reduce-scatters it);
    where they are whole (sequence-parallel) x is the rank's rows at
    ``positions``, the latent and k_rope are gathered over the sequence and
    the causal mask sits at the rows' offset."""
    return _prefill_mla(params, s, x, positions, sharding_hooks.tensor_parallel())


def prefill_mla_whole(params, s: MLASpec, x: torch.Tensor, positions: torch.Tensor):
    """``prefill_mla`` over every row of x and every head the weights hold,
    whatever the mesh: a tensor-parallel rank's where the rows do not split
    (nothing gathered)."""
    return _prefill_mla(params, s, x, positions, None)


def _prefill_mla(params, s: MLASpec, x, positions, tp):
    with _span("mla"):
        Sl, offset = x.shape[1], 0
        q_nope, q_rope = _mla_q(params, s, x, positions)
        latent, k_rope = _mla_kv(params, s, x, positions)
        if tp is not None and params["wq"].shape[1] == s.n_heads:
            latent = sharding_hooks.gather_seq(latent, tp)
            k_rope = sharding_hooks.gather_seq(k_rope, tp)
            offset = tp.rank * Sl
        S = latent.shape[1]
        k_nope = torch.einsum("bsl,lhk->bshk", latent, params["wuk"])
        val = torch.einsum("bsl,lhk->bshk", latent, params["wuv"])
        # the rope part's key is shared by the heads: the reference's broadcast
        logits = torch.einsum("bshk,bthk->bhst", q_nope, k_nope)
        logits += torch.einsum("bshk,btk->bhst", q_rope, k_rope)
        del k_nope
        probs = _masked_softmax(logits, causal_mask(Sl, S, offset=offset, device=x.device),
                                x.dtype, _mla_scale(s))
        del logits
        out = torch.einsum("bhst,bthk->bshk", probs, val)
        return _out_proj(out, params["wo"]), latent, k_rope


def apply_mla(params, s: MLASpec, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    return prefill_mla(params, s, x, positions)[0]


def init_mla_cache(s: MLASpec, batch: int, seq_len: int, dtype=torch.bfloat16):
    return {
        "latent": ParamDef((batch, seq_len, s.kv_lora), ("batch", "kv_seq", None), init="zeros",
                           dtype=dtype),
        "k_rope": ParamDef((batch, seq_len, s.qk_rope), ("batch", "kv_seq", None), init="zeros",
                           dtype=dtype),
    }


def mla_decode_inputs(params, s: MLASpec, x, pos):
    """What an absorbed MLA decode step computes of its token x (B, 1, D)
    at ``pos``: q_lat (B, 1, H, kv_lora), the query taken into the latent
    space (q_nope wuk), and the rotated q_rope (B, 1, H, qk_rope), on the
    heads the weights hold; the token's normed latent (B, 1, kv_lora) and
    k_rope (B, 1, qk_rope) for the cache."""
    positions = pos.reshape(1, 1).expand(x.shape[0], 1)
    q_nope, q_rope = _mla_q(params, s, x, positions)
    latent_new, k_rope_new = _mla_kv(params, s, x, positions)
    q_lat = torch.einsum("bshk,lhk->bshl", q_nope, params["wuk"])
    return q_lat, q_rope, latent_new, k_rope_new


def mla_heads_out(params, o_lat: torch.Tensor) -> torch.Tensor:
    """The output projection of o_lat (B, 1, H, kv_lora) on the heads the
    weights hold: (o_lat wuv) wo, (B, 1, D)."""
    out = torch.einsum("bshl,lhk->bshk", o_lat, params["wuv"])
    return _out_proj(out, params["wo"])


def decode_mla(params, s: MLASpec, x, cache, pos, slots: Optional[int] = None):
    """Absorbed-form MLA decode: the query is taken into the latent space
    (q_nope wuk) and scored against the latent cache directly, a step
    costing O(T (kv_lora + qk_rope) H) instead of re-expanding K and V.
    As ``decode_attention``, the token's latent and k_rope are written into
    ``cache`` IN PLACE at slot ``pos`` (a 0-d device tensor: no host sync).
    Under a decode step whose context-parallel group is above 1 the cache
    is that rank's share of the slots (``_decode_mla_cp``), unless
    ``slots``, the whole cache's, says that the rank holds all of them;
    then, as on one process, on the heads the weights hold (a rank's: a
    part the caller sums over "model")."""
    cp = sharding_hooks.context_parallel()
    if cp is not None and (slots is None or cache["latent"].shape[1] < slots):
        return _decode_mla_cp(params, s, x, cache, pos, sharding_hooks.tensor_parallel(), cp)
    with _span("mla"):
        q_lat, q_rope, latent_new, k_rope_new = mla_decode_inputs(params, s, x, pos)
        latent, k_rope = cache["latent"], cache["k_rope"]
        slot = pos.reshape(1).long()
        latent.index_copy_(1, slot, latent_new.to(latent.dtype))
        k_rope.index_copy_(1, slot, k_rope_new.to(k_rope.dtype))
        logits = torch.einsum("bshl,btl->bhst", q_lat, latent)
        logits += torch.einsum("bshk,btk->bhst", q_rope, k_rope)
        valid = torch.arange(latent.shape[1], device=x.device) <= pos
        probs = _masked_softmax(logits, valid, x.dtype, _mla_scale(s))
        o_lat = torch.einsum("bhst,btl->bshl", probs, latent)
        return mla_heads_out(params, o_lat), cache


def mla_partial(s: MLASpec, q_lat, q_rope, latent, k_rope, pos, slot0: int):
    """One slice of a sequence-split MLA cache (a rank's share of a
    context-parallel decode), plain PyTorch as the reference's MLA: q_lat
    (B, 1, H, kv_lora), q_rope (B, 1, H, qk_rope); latent (B, T, kv_lora)
    and k_rope (B, T, qk_rope) holding global slots slot0..slot0+T-1, those
    at most ``pos`` attended. The scores as ``decode_mla``'s (products in
    the activations' dtype, then float32, scaled); returns (o_lat (B, H,
    kv_lora), lse (B, H)), float32: the slice's normalised latent output
    and the log-sum-exp of its scores, 0 and -inf for a slice with no valid
    slot (the decode kernel's partial form), which
    ``decode_ops.merge_partials`` merges."""
    logits = torch.einsum("bshl,btl->bhst", q_lat, latent)
    logits += torch.einsum("bshk,btk->bhst", q_rope, k_rope)
    s32 = logits[:, :, 0].float() * _mla_scale(s)
    valid = torch.arange(latent.shape[1], device=latent.device) + int(slot0) <= pos
    s32 = s32.masked_fill(~valid, float("-inf"))
    lse = torch.logsumexp(s32, dim=-1)
    p = torch.exp(s32 - torch.where(torch.isinf(lse), 0.0, lse)[..., None])
    return torch.einsum("bht,btl->bhl", p, latent.float()), lse


def _decode_mla_cp(params, s: MLASpec, x, cache, pos, tp, cp):
    """Context-parallel absorbed MLA decode over the N ranks of ``cp``: rank
    r holds slots [r T, (r+1) T) of latent and k_rope caches of N T slots.
    Each rank computes q_lat and q_rope of its heads, gathered over
    "model" where ``tp`` splits them (small tensors); the
    token's latent and k_rope (whole weights) are written by the rank that
    owns slot ``pos`` (no host sync); each rank's float32 partial over its
    slots for every head (``mla_partial``) is gathered and merged in rank
    order by log-sum-exp (``decode_ops.merge_partials``), rounded to the
    activations' dtype once; then ``wuv`` and ``wo`` of the rank's heads:
    a partial sum the caller all-reduces (or, where the heads are whole,
    the output). The reference rounds its probabilities to the
    activations' dtype before the product with the latent; the merge of
    float32 partials rounds once, at the end."""
    with _span("mla"):
        q_lat, q_rope, latent_new, k_rope_new = mla_decode_inputs(params, s, x, pos)
        Hl = q_lat.shape[2]
        if Hl < s.n_heads:
            q_lat = sharding_hooks.gather_model(q_lat, tp, 2)
            q_rope = sharding_hooks.gather_model(q_rope, tp, 2)
        latent, k_rope = cache["latent"], cache["k_rope"]
        T = latent.shape[1]
        slot, own = _owned_slot(pos, T, cp, ring=False)
        _write_owned(latent, slot, own, latent_new)
        _write_owned(k_rope, slot, own, k_rope_new)
        merged = merge_over(cp, *mla_partial(s, q_lat, q_rope, latent, k_rope, pos, cp.rank * T),
                            x.dtype)  # (B, H, kv_lora)
        if Hl < s.n_heads:
            merged = merged[:, tp.rank * Hl:(tp.rank + 1) * Hl]
        return mla_heads_out(params, merged[:, None]), cache


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
# MoE with sort-based capacity dispatch
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    d_expert: int
    num_experts: int
    top_k: int
    num_shared: int = 0
    d_shared: int = 0                 # shared-expert hidden size (total)
    capacity_factor: float = 1.25
    # GShard-style floor on per-expert capacity (capped at T*K): without it a
    # decode step (T = batch) rounds its capacity to about 1 and drops
    # colliding tokens that a prefill keeps
    min_capacity: int = 4
    activation: str = "silu"
    renorm: bool = True
    # dispatch groups: routing and capacity are computed per group (the
    # reference's layout for sharding the token space over its DP axes)
    groups: int = 32


def init_moe(s: MoESpec) -> Dict[str, Any]:
    defs: Dict[str, Any] = {
        "router": ParamDef((s.d_model, s.num_experts), ("embed", "experts"), scale=0.1),
        "wg": ParamDef((s.num_experts, s.d_model, s.d_expert), ("experts", "embed", "expert_ffn")),
        "wu": ParamDef((s.num_experts, s.d_model, s.d_expert), ("experts", "embed", "expert_ffn")),
        "wd": ParamDef((s.num_experts, s.d_expert, s.d_model), ("experts", "expert_ffn", "embed")),
    }
    if s.num_shared > 0:
        defs["shared"] = init_mlp(MLPSpec(s.d_model, s.d_shared, s.activation))
    return defs


def moe_capacity(s: MoESpec, tokens: int) -> int:
    """Slots per expert for ``tokens`` routed tokens: the capacity factor
    over the balanced load, floored at ``min_capacity`` (capped at all the
    choices). Host ints only."""
    K = s.top_k
    return max(int(np.ceil(tokens * K / s.num_experts * s.capacity_factor)),
               min(s.min_capacity, tokens * K))


def moe_groups(s: MoESpec, tokens: int) -> int:
    """The reference's group rule: ``groups`` when they divide the tokens
    and each group holds at least E/K tokens, else one group."""
    E, K = s.num_experts, s.top_k
    if s.groups > 0 and tokens % s.groups == 0 and tokens >= s.groups * max(E // K, 1):
        return s.groups
    return 1


def moe_route(params, s: MoESpec, xg: torch.Tensor):
    """Router of (..., T, D) tokens: float32 gates (..., T, E), the top-k
    gates (renormalised, the sum floored at 1e-9) and their experts
    (..., T, K). Ties go to the lower expert index, as ``lax.top_k``
    orders them: a stable descending sort, not ``torch.topk``."""
    gates = torch.softmax((xg @ params["router"]).float(), dim=-1)
    top_i = torch.argsort(gates, dim=-1, descending=True, stable=True)[..., : s.top_k]
    top_v = gates.gather(-1, top_i)
    if s.renorm:
        top_v = top_v / top_v.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return gates, top_v, top_i


def moe_slots(top_i: torch.Tensor, num_experts: int, C: int) -> torch.Tensor:
    """Each (group, token, choice)'s capacity slot: its rank among the
    group's choices of the same expert, in token order (a stable sort of
    the expert ids, then the first index of each expert by
    ``searchsorted``), or C where that rank reaches the capacity (dropped).
    top_i (G, Tg, K) -> (G, Tg, K) int64, fixed shapes and no host sync."""
    G, Tg, K = top_i.shape
    flat_e = top_i.reshape(G, Tg * K)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = flat_e.gather(1, order)
    experts = torch.arange(num_experts, device=top_i.device).expand(G, num_experts).contiguous()
    seg_start = torch.searchsorted(se, experts, side="left")
    pos = torch.arange(Tg * K, device=top_i.device) - seg_start.gather(1, se)
    pos_c = torch.where(pos < C, pos, C)
    return torch.empty_like(pos_c).scatter_(1, order, pos_c).view(G, Tg, K)


def _moe_routed(params, s: MoESpec, xg: torch.Tensor, C: int, f32_combine: bool,
                with_lb: bool = True, experts: Optional[Tuple[int, int]] = None,
                cast: bool = True):
    """The routed experts of tokens xg (G, Tg, D), C slots an expert in each
    group. Returns (y (G, Tg, D) in xg's dtype, the Switch load-balance loss
    of these tokens, or None without ``with_lb``: serving drops it, and the
    choices (G, Tg, K)).

    ``experts`` = (e0, n): the weights hold experts e0 .. e0 + n - 1 only
    (expert parallelism): the slots of the others' choices are not kept
    (they take the parking row, as the reference's), so y is this rank's
    part of the output. With ``cast=False`` (and ``f32_combine``) y stays
    float32: a part that a sum over ranks completes.

    Dispatch is a permutation: each kept choice's token row is copied into
    its slot of an (E, G * C) slot plane (one extra parking row takes the
    dropped ones), the three expert products run as batched GEMMs over E,
    and the combine gathers each choice's output row (the parking row reads
    0) and weights it by its gate: in xg's dtype (the grouped path's
    einsum), or, with ``f32_combine``, each product in xg's dtype summed in
    float32 (the mesh path's scatter-add, here a sum over the K choices)."""
    G, Tg, D = xg.shape
    E, K = s.num_experts, s.top_k
    e0, n_local = experts if experts is not None else (0, E)
    with _span("moe.route"):
        gates, top_v, top_i = moe_route(params, s, xg)
        lb = None
        if with_lb:  # E * sum_e (mean gate of e) (share of the choices on e)
            counts = torch.zeros(E, dtype=torch.int64, device=xg.device).index_add_(
                0, top_i.reshape(-1), torch.ones_like(top_i.reshape(-1)))
            me = gates.reshape(-1, E).mean(dim=0)
            lb = E * (me * (counts.float() / (G * Tg) / K)).sum()
    with _span("moe.dispatch"):
        pos = moe_slots(top_i, E, C)
        kept = pos < C
        local = top_i
        if experts is not None:  # only this rank's experts' choices
            local = top_i - e0
            kept = kept & (local >= 0) & (local < n_local)
        park = n_local * G * C
        g_idx = torch.arange(G, device=xg.device)[:, None, None]
        row = torch.where(kept, (local * G + g_idx) * C + pos, park)  # (G, Tg, K)
        contrib = xg[:, :, None, :].expand(G, Tg, K, D).reshape(-1, D)
        buf = xg.new_zeros((park + 1, D)).index_copy_(0, row.reshape(-1), contrib)
        xe = buf[:park].view(n_local, G * C, D)
    with _span("moe.experts"):
        h = (_act(s.activation, xe @ params["wg"]) * (xe @ params["wu"])) @ params["wd"]
    with _span("moe.combine"):
        # a dropped choice reads 0 (the reference's zero parking slot)
        picked = torch.where(kept[..., None], h.reshape(park, D)[row.clamp_max(park - 1)], 0)
        w = top_v.to(xg.dtype)
        if f32_combine:
            y = (picked * w[..., None]).float().sum(dim=2)
            y = y.to(xg.dtype) if cast else y
        else:
            y = torch.einsum("gtkd,gtk->gtd", picked, w)
    return y, lb, top_i


def _span(name: str):
    """A named range in a torch.profiler trace (whose kernels a profile can
    sum); nothing, at no cost, when no profiler runs."""
    return record_function(name) if torch.autograd._profiler_enabled() else nullcontext()


def apply_moe(params, s: MoESpec, x: torch.Tensor, with_lb: bool = True,
              seq_split: bool = True) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Routed MoE (+ shared experts) of x (B, S, D). Returns (y, {"lb_loss"}),
    the loss None without ``with_lb`` (prefill and decode: nothing reads it).
    Inside a mesh context (``sharding_hooks.activation_sharding``) the mesh
    path runs, as the reference's ``shard_map`` schedule; outside it the
    grouped path. The two differ in their capacities by design. On a
    "model" axis above 1 x is the data rank's whole sequence (gathered by
    the block) and y this rank's rows of the output (``seq_split``; a
    decode token's whole row without it): ``_apply_moe_tp``."""
    ctx = sharding_hooks._CTX.get()
    tp = sharding_hooks.tensor_parallel() if ctx is not None else None
    if tp is not None:
        return _apply_moe_tp(params, s, x, ctx, tp, with_lb, seq_split)
    if ctx is not None:
        y, lb = _apply_moe_mesh(params, s, x, ctx, with_lb)
    else:
        y, lb = _apply_moe_grouped(params, s, x, with_lb)
    if s.num_shared > 0:
        with _span("moe.shared"):
            y = y + apply_mlp(params["shared"], MLPSpec(s.d_model, s.d_shared, s.activation), x)
    return y, {"lb_loss": lb}


def _apply_moe_grouped(params, s: MoESpec, x: torch.Tensor, with_lb: bool = True):
    """The reference's grouped path: the T = B S tokens in G groups
    (``moe_groups``), routing, capacity and dispatch per group, the
    load-balance loss over all of them."""
    B, S, D = x.shape
    G = moe_groups(s, B * S)
    Tg = B * S // G
    y, lb, _ = _moe_routed(params, s, x.reshape(G, Tg, D), moe_capacity(s, Tg),
                           f32_combine=False, with_lb=with_lb)
    return y.reshape(B, S, D), lb


def _apply_moe_mesh(params, s: MoESpec, x: torch.Tensor, ctx, with_lb: bool = True):
    """The reference's mesh path (``_apply_moe_shardmap``) on this process's
    rows, on a model axis of 1: each data rank dispatches its own T_loc =
    B_loc S tokens, in one group with capacity from T_loc, combines in
    float32, and the load-balance loss is the mean over the data-parallel
    ranks (``pmean``: ``_MeanOverGroups``). The reference's expert- and
    ffn-parallel modes are this same arithmetic there; a model axis above 1
    is ``_apply_moe_tp``'s."""
    mesh, rules = ctx
    if model_size(mesh) > 1:
        raise ValueError("a 'model' axis above 1 takes _apply_moe_tp (apply_moe picks it)")
    B, S, D = x.shape
    y, lb, _ = _moe_routed(params, s, x.reshape(1, B * S, D), moe_capacity(s, B * S),
                           f32_combine=True, with_lb=with_lb)
    return y.reshape(B, S, D), _mean_over_dp(lb, ctx)


def _mean_over_dp(lb, ctx):
    """The load-balance loss's mean over the data-parallel ranks (the
    reference's ``pmean``; None stays None)."""
    mesh, rules = ctx
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    dp = rules.get("batch")
    axes = [a for a in (dp if isinstance(dp, tuple) else (dp,) if dp else ())
            if sizes.get(a, 1) > 1]
    if axes and lb is not None:
        n = int(np.prod([sizes[a] for a in axes]))
        lb = _MeanOverGroups.apply(lb, [mesh.get_group(a) for a in axes], n)
    return lb


def moe_mode(s: MoESpec, rules: dict, M: int) -> str:
    """The reference's mode of the routed experts on a "model" axis of M:
    "expert" (the rules put ``experts`` on "model" and E % M == 0: each rank
    holds E / M experts), "ffn" (else ``expert_ffn`` on "model" and d_expert
    % M == 0: each rank holds a slice of every expert's hidden dim) or
    "replicated". ``spec_for_leaf`` cuts the weights by the same rules."""
    if M > 1 and rules.get("experts") == "model" and s.num_experts % M == 0:
        return "expert"
    if M > 1 and rules.get("expert_ffn") == "model" and s.d_expert % M == 0:
        return "ffn"
    return "replicated"


def moe_rank_partial(params, s: MoESpec, x: torch.Tensor, C: int, mode: str, rank: int,
                     M: int, with_lb: bool = True):
    """One "model" rank's float32 part of the MoE block over the data
    rank's tokens x (B, S, D), as a function of its weight slices: the sum
    of the M ranks' parts is the block's output (before its cast). Returns
    (part (B, S, D) float32, the load-balance loss, the choices (B S, K)).

    ``params`` hold the whole router (every rank routes alike) and this
    rank's slices for ``mode`` (``moe_mode``): "expert" its E / M experts,
    whose choices alone it computes (another rank's expert takes the
    parking slot); "ffn" every expert's hidden columns of this rank (``wg``
    and ``wu`` columns, ``wd`` rows: a partial product); "replicated" whole
    weights, counted on rank 0 only. The shared experts likewise: column-
    then row-parallel where their hidden dim is split, else on rank 0. The
    capacity C is the data rank's (from B S tokens), the same on every
    rank. No collective runs here, and the buffers' shapes depend on nothing
    but the mode: a rank that no token chose runs the same operations."""
    B, S, D = x.shape
    E_loc = s.num_experts // M if mode == "expert" else s.num_experts
    experts = (rank * E_loc, E_loc) if mode == "expert" else None
    y, lb, top_i = _moe_routed(params, s, x.reshape(1, B * S, D), C, f32_combine=True,
                               with_lb=with_lb, experts=experts, cast=False)
    if mode == "replicated" and rank != 0:
        y = torch.zeros_like(y)
    part = y.reshape(B, S, D)
    if s.num_shared > 0:
        with _span("moe.shared"):
            sh = params["shared"]
            if sh["wu"].shape[1] < s.d_shared or rank == 0:
                part = part + apply_mlp(sh, MLPSpec(s.d_model, sh["wu"].shape[1], s.activation),
                                        x).float()
    return part, lb, top_i[0]


def _check_moe_slices(params, s: MoESpec, mode: str, M: int) -> None:
    """The weights' shapes must be those of ``mode``'s slices."""
    E, F = params["wg"].shape[0], params["wg"].shape[2]
    want = {"expert": (s.num_experts // M, s.d_expert), "ffn": (s.num_experts, s.d_expert // M),
            "replicated": (s.num_experts, s.d_expert)}[mode]
    if (E, F) != want:
        raise ValueError(f"MoE weights of {E} experts x {F} hidden on a model axis of {M}: "
                         f"{mode} mode holds {want[0]} x {want[1]} (build the model on the mesh)")


def _apply_moe_tp(params, s: MoESpec, x: torch.Tensor, ctx, tp, with_lb: bool,
                  seq_split: bool):
    """The reference's mesh path on a "model" axis above 1: x (B, S, D) is
    the data rank's whole sequence on every rank of the axis. In expert-
    and ffn-parallel mode (or with split shared experts) each rank's float32
    part (``moe_rank_partial``) is summed over the axis and cast: a
    reduce-scatter into the rank's rows (``seq_split``), or an all-reduce
    (decode's one token a row). In replicated mode with whole shared
    experts there is no sum: every rank computes the block as a model axis
    of 1 does and keeps its rows. An expert-parallel router (its columns
    split over the axis) is gathered first, so every rank routes alike;
    the load-balance loss, alike on every rank, counts once in the
    gradients (``once_over_model``), then takes its mean over the data
    ranks. Without ``seq_split`` (a decode token, or a sequence that does
    not split over the axis) x, the same on every rank, enters the ranks'
    parts by ``to_parts``, and where every rank computes the whole block
    alike its leaves count once."""
    mesh, rules = ctx
    B, S, D = x.shape
    mode = moe_mode(s, rules, tp.size)
    _check_moe_slices(params, s, mode, tp.size)
    C = moe_capacity(s, B * S)
    p = {k: params[k] for k in ("router", "wg", "wu", "wd") + (("shared",) if s.num_shared else ())}
    if p["router"].shape[1] < s.num_experts:
        p["router"] = sharding_hooks.gather_seq(p["router"], tp, dim=1)
    split_shared = s.num_shared > 0 and p["shared"]["wu"].shape[1] < s.d_shared
    alike = mode == "replicated" and not split_shared
    if not seq_split and torch.is_grad_enabled():  # training on a sequence that does not split
        if alike:
            p = tree_map(lambda t: sharding_hooks.once_over_model(t, tp), p)
        else:
            x = sharding_hooks.to_parts(x, tp)
    if alike:
        y, lb, _ = _moe_routed(p, s, x.reshape(1, B * S, D), C, f32_combine=True,
                               with_lb=with_lb)
        y = y.reshape(B, S, D)
        if s.num_shared > 0:
            with _span("moe.shared"):
                y = y + apply_mlp(p["shared"], MLPSpec(s.d_model, s.d_shared, s.activation), x)
        if seq_split:
            Sl = S // tp.size
            y = y[:, tp.rank * Sl:(tp.rank + 1) * Sl]
    else:
        part, lb, _ = moe_rank_partial(p, s, x, C, mode, tp.rank, tp.size, with_lb)
        summed = (sharding_hooks.scatter_seq(part, tp) if seq_split
                  else sharding_hooks.sum_model(part, tp))
        y = summed.to(x.dtype)
    if lb is not None:
        lb = sharding_hooks.once_over_model(lb, tp)
    return y, {"lb_loss": _mean_over_dp(lb, ctx)}


def _sum_over(x: torch.Tensor, groups) -> torch.Tensor:
    for g in groups:
        dist.all_reduce(x, group=g)
    return x


class _MeanOverGroups(torch.autograd.Function):
    """The mean of a tensor over the ranks of process groups (the
    reference's ``pmean``). Its gradient is the mean of the ranks'
    gradients, as ``pmean``'s transpose: each rank's loss depends on every
    rank's input."""

    @staticmethod
    def forward(ctx, x, groups, n):
        ctx.groups, ctx.n = groups, n
        return _sum_over(x.clone(), groups) / n

    @staticmethod
    def backward(ctx, grad):
        return _sum_over(grad.clone(), ctx.groups) / ctx.n, None, None


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------


def init_embedding(vocab: int, d_model: int) -> Dict[str, Any]:
    return {"table": ParamDef((vocab, d_model), ("vocab", "embed"), init="embed", scale=0.02)}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def embed_vocab_parallel(params, tokens: torch.Tensor, tp, seq_split: bool) -> torch.Tensor:
    """The lookup of a table whose rows (the vocab) are split over "model":
    each rank looks up the tokens of its rows (0 for the others), and the
    ranks' lookups are summed over the axis, into the rank's rows of the
    sequence (``seq_split``: a reduce-scatter, the sequence-parallel
    residual) or whole (an all-reduce: decode's one token). Exactly one
    rank holds each token, so the sum is the lookup, bit for bit."""
    table = params["table"]
    Vl = table.shape[0]
    idx = tokens.long() - tp.rank * Vl
    own = (idx >= 0) & (idx < Vl)
    e = torch.where(own[..., None], table[idx.clamp(0, Vl - 1)],
                    torch.zeros((), dtype=table.dtype, device=table.device))
    return sharding_hooks.scatter_seq(e, tp) if seq_split else sharding_hooks.sum_model(e, tp)
