"""Plain PyTorch version of the flash-decode kernels.

The function of the reference's Pallas kernel (``kernels/decode_attention/
decode_attention.py``, with the GQA repeat of its ``ops.py``): one query per
(batch, head) against the cache, float32 logits scaled by 1/sqrt(D), keys
after ``pos`` masked to ``finfo(float32).min``, a float32 softmax and a
float32 product with V, cast to q's dtype at the end. The CPU path of the
port and the tests use it; on the card the CUDA kernels are held against it.
"""
from __future__ import annotations

import math

import torch

NEG_INF = torch.finfo(torch.float32).min


def decode_ref(q, k, v, pos) -> torch.Tensor:
    """q: (B, H, D); k, v: (B, KV, T, D) with H % KV == 0; pos: () integer
    tensor (or int), keys 0..pos attended. Returns (B, H, D) in q's dtype."""
    rep = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).float()
    v = v.repeat_interleave(rep, dim=1).float()
    T = k.shape[2]
    logits = torch.einsum("bhd,bhtd->bht", q.float(), k) * (1.0 / math.sqrt(q.shape[-1]))
    valid = torch.arange(T, device=q.device) <= torch.as_tensor(pos, device=q.device)
    logits = logits.masked_fill(~valid, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bht,bhtd->bhd", probs, v).to(q.dtype)
