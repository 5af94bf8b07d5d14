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

The partial form (``decode_partial_ref``) is one rank's share of a cache
split over the sequence (a context-parallel decode): local slot j holds
global key ``slot0 + j``, keys up to ``pos`` are attended, and it returns
the slice's normalised output and the log-sum-exp of its scaled scores,
both float32 (0 and -inf for a slice with no valid key).
``merge_partials`` merges the ranks' partials by their log-sum-exp in rank
order, in float32, rounded to the output dtype once: the plain version of
``ops.merge_partials``, which the context-parallel decode calls.
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


def decode_partial_ref(q, k, v, pos, slot0: int = 0):
    """One slice of a sequence-split cache: q (B, H, D); k, v (B, KV, T, D)
    holding global keys slot0..slot0+T-1; keys whose global index is at
    most ``pos`` attended. Returns (out (B, H, D), lse (B, H)), float32:
    the slice's normalised output and ln sum_t exp(s_t) of its scaled
    scores s_t; a slice with no valid key gives 0 and -inf."""
    rep = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).float()
    v = v.repeat_interleave(rep, dim=1).float()
    T = k.shape[2]
    s = torch.einsum("bhd,bhtd->bht", q.float(), k) * (1.0 / math.sqrt(q.shape[-1]))
    glob = torch.arange(T, device=q.device) + int(slot0)
    valid = glob <= torch.as_tensor(pos, device=q.device)
    s = s.masked_fill(~valid, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.where(valid, torch.exp(s - torch.where(torch.isinf(lse), 0.0, lse)[..., None]), 0.0)
    return torch.einsum("bht,bhtd->bhd", p, v), lse


def merge_partials(outs, lses, dtype=torch.float32) -> torch.Tensor:
    """The ranks' partials (``decode_partial_ref``'s or the kernel's) of
    one query merged by their log-sum-exp, in rank order: outs (M, B, H, D)
    and lses (M, B, H) float32 (or sequences of them). With L = max lse,
    w_r = exp(lse_r - L), o = sum_r w_r out_r / sum_r w_r, in float32, cast
    to ``dtype`` once."""
    outs = torch.stack(list(outs)) if not isinstance(outs, torch.Tensor) else outs
    lses = torch.stack(list(lses)) if not isinstance(lses, torch.Tensor) else lses
    mx = lses.amax(0)
    mx = torch.where(torch.isinf(mx), 0.0, mx)
    num = torch.zeros_like(outs[0])
    den = torch.zeros_like(lses[0])
    for r in range(outs.shape[0]):  # rank order
        w = torch.exp(lses[r] - mx)
        num = num + outs[r] * w[..., None]
        den = den + w
    return (num / den.clamp_min(1e-30)[..., None]).to(dtype)
