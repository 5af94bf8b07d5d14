"""Plain PyTorch version of the flash-decode kernels.

The function of the reference's Pallas kernel (``kernels/decode_attention/
decode_attention.py``, with the GQA repeat of its ``ops.py``): one query per
(batch, head) against the cache, float32 logits scaled by 1/sqrt(D), keys
after ``pos`` masked to ``finfo(float32).min``, a float32 softmax and a
float32 product with V, cast to q's dtype at the end. The CPU path of the
port and the tests use it; on the card the CUDA kernel is held against it.
``decode_split_ref`` is the kernel's arithmetic (per-split softmax states
merged in rank order), on no path: the tests hold it, and the kernel, to
the same bounds.
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


def split_bounds(pos: int, T: int, n_splits: int) -> list:
    """The key range [lo, hi) of each split, as the kernel computes it: the
    n = min(pos, T - 1) + 1 valid keys cut into ``n_splits`` balanced
    ranges, split s taking [n*s // n_splits, n*(s+1) // n_splits). Sizes
    differ by at most one; a range is empty when n < n_splits."""
    n = max(min(int(pos), T - 1), -1) + 1
    return [(n * s // n_splits, n * (s + 1) // n_splits) for s in range(n_splits)]


def decode_split_ref(q, k, v, pos, n_splits: int) -> torch.Tensor:
    """``decode_ref`` as the kernel computes it: each split's (m, l, acc)
    over its keys (``split_bounds``), m the max score, l = sum exp(s - m),
    acc = sum exp(s - m) v; an empty split m = finfo(float32).min, l = 0,
    acc = 0. The splits merge in rank order: M = max m, w = exp(m - M),
    o = sum w acc / max(sum w l, 1e-30), cast to q's dtype."""
    rep = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).float()
    v = v.repeat_interleave(rep, dim=1).float()
    qf = q.float()
    B, H, D = q.shape

    def zeros(*shape):
        return torch.zeros(shape, device=q.device)

    states = []
    for lo, hi in split_bounds(int(pos), k.shape[2], n_splits):
        if lo == hi:
            states.append((zeros(B, H, 1) + NEG_INF, zeros(B, H, 1), zeros(B, H, D)))
            continue
        s = torch.einsum("bhd,bhtd->bht", qf, k[:, :, lo:hi]) * (1.0 / math.sqrt(D))
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        states.append((m, p.sum(-1, keepdim=True), torch.einsum("bht,bhtd->bhd", p, v[:, :, lo:hi])))
    mx = torch.stack([m for m, _, _ in states]).amax(0)
    l_sum, acc = zeros(B, H, 1), zeros(B, H, D)
    for m, l, a in states:  # rank order
        w = torch.exp(m - mx)
        l_sum = l_sum + l * w
        acc = acc + a * w
    return (acc / l_sum.clamp_min(1e-30)).to(q.dtype)
