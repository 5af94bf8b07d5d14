"""Plain PyTorch version of the flash-attention kernel.

The function of the reference's Pallas kernel (``kernels/flash_attention/
flash_attention.py``, with the GQA repeat of its ``ops.py``): float32
logits scaled by 1/sqrt(D), masked to ``finfo(float32).min`` above the
diagonal, a float32 softmax and a float32 product with V, cast to q's dtype
at the end. The CPU path of the port and the tests use it; on the card the
CUDA kernel is held against it.
"""
from __future__ import annotations

import math

import torch

NEG_INF = torch.finfo(torch.float32).min
TILE = 128  # keys per tile of the bf16 kernel (kTileRows in csrc/flash_attention.cu)


def flash_attention_ref(q, k, v, causal: bool = True) -> torch.Tensor:
    """q: (B, H, S, D); k, v: (B, KV, S, D) with H % KV == 0. Returns
    (B, H, S, D) in q's dtype."""
    rep = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).float()
    v = v.repeat_interleave(rep, dim=1).float()
    S = q.shape[2]
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k) * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        ii = torch.arange(S, device=q.device)
        logits = logits.masked_fill(ii[None, :] > ii[:, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs, v).to(q.dtype)


def flash_attention_tiled_ref(q, k, v, causal: bool = True) -> torch.Tensor:
    """The bf16 CUDA kernel's arithmetic in plain PyTorch, on no path: keys
    in tiles of ``TILE`` with a running float32 max m, sum l and accumulator;
    per tile p = exp(s - m) in float32, l from that float32 p, and P rounded
    to bfloat16 before the product with V (as tensor-core flash kernels
    do); l clamped at 1e-30 and the output cast to q's dtype. Against
    ``flash_attention_ref`` only P's rounding differs (each p within a
    relative 2**-8), so every output is within 2**-8 * attn(q, k, |v|).
    Its float32 p differ from the kernel's in their last bits, so some
    entries of P round one bf16 ulp apart: against the kernel it is exact
    only up to the same 2**-8, from each side."""
    rep = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).float()
    v = v.repeat_interleave(rep, dim=1).float()
    qf = q.float() * (1.0 / math.sqrt(q.shape[-1]))
    B, H, S, D = q.shape
    m = torch.full((B, H, S, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, H, S, 1), device=q.device)
    acc = torch.zeros((B, H, S, D), device=q.device)
    rows = torch.arange(S, device=q.device)[:, None]
    for k0 in range(0, S, TILE):
        s = torch.einsum("bhsd,bhtd->bhst", qf, k[:, :, k0 : k0 + TILE])
        if causal:
            cols = torch.arange(k0, min(k0 + TILE, S), device=q.device)[None, :]
            s = s.masked_fill(cols > rows, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        p16 = p.to(torch.bfloat16).float()
        acc = acc * alpha + torch.einsum("bhst,bhtd->bhsd", p16, v[:, :, k0 : k0 + TILE])
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)
