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
