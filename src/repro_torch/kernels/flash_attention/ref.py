"""Plain PyTorch version of the flash-attention kernel.

The function of the reference's Pallas kernel (``kernels/flash_attention/
flash_attention.py``, with the GQA repeat of its ``ops.py``): float32
logits scaled by 1/sqrt(D), masked to ``finfo(float32).min`` above the
diagonal (and, with a sliding ``window``, at and below ``window`` keys back:
key j is seen by row i when i - window < j <= i, the reference's
``causal_mask``), a float32 softmax and a float32 product with V, cast to
q's dtype at the end. Without a mask the query and key lengths may differ
(whisper's cross-attention: every row sees every key). With a causal
``q_offset`` they may differ too: query row i is at position q_offset + i
against keys 0..Sk-1 (a sequence-parallel rank's rows of a prefill), over
the window q_offset + i - window < j <= q_offset + i where there is one
(the reference's ``causal_mask(Sq, Sk, window, offset)``). The CPU path of
the port and the tests use it; on the card the CUDA kernel is held against
it.
"""
from __future__ import annotations

import math

import torch

NEG_INF = torch.finfo(torch.float32).min
TILE = 128  # keys per tile of the bf16 kernel (kTileRows in csrc/flash_attention.cu)
TILE_D256 = 64  # at head_dim 256 (Layout<256>::kKeys: 227 KB hold no 128-key tiles)


def key_tile(D: int) -> int:
    """Keys per tile of the bf16 kernel at head_dim D."""
    return TILE_D256 if D == 256 else TILE


def check_lengths(Sq: int, Sk: int, causal: bool, window, q_offset=None) -> None:
    """A mask (causal or a window) pairs query row i with key i: raise
    ValueError unless Sq == Sk there. With a ``q_offset`` (causal, with or
    without a window) row i is at position q_offset + i: the rows must lie
    within the Sk keys."""
    if q_offset is not None:
        if not causal:
            raise ValueError("a query offset needs causal attention")
        if q_offset < 0 or q_offset + Sq > Sk:
            raise ValueError(f"query rows at {q_offset}..{q_offset + Sq - 1} lie outside "
                             f"the {Sk} keys")
        return
    if (causal or window is not None) and Sq != Sk:
        raise ValueError(f"causal or windowed attention needs as many queries as keys, "
                         f"got {Sq} and {Sk}")


def masked(S: int, causal: bool, window, device, rows=None, cols=None) -> torch.Tensor:
    """(len(rows), len(cols)) bool, True where key j is hidden from query
    row i: j > i (causal), j <= i - window (a sliding window); rows and
    cols default to 0..S-1."""
    i = (torch.arange(S, device=device) if rows is None else rows)[:, None]
    j = (torch.arange(S, device=device) if cols is None else cols)[None, :]
    out = torch.zeros((i.shape[0], j.shape[1]), dtype=torch.bool, device=device)
    if causal:
        out |= j > i
    if window is not None:
        out |= j <= i - window
    return out


def _rows(S: int, q_offset, device):
    return torch.arange(S, device=device) + (q_offset or 0)


def flash_attention_ref(q, k, v, causal: bool = True, window=None, q_offset=None) -> torch.Tensor:
    """q: (B, H, Sq, D); k, v: (B, KV, Sk, D) with H % KV == 0 (Sq == Sk
    when causal or windowed, but for a causal ``q_offset``: row i at
    position q_offset + i); ``window`` None (full causal) or the keys each
    row sees (with an offset too). Returns (B, H, Sq, D) in q's dtype."""
    S = q.shape[2]
    check_lengths(S, k.shape[2], causal, window, q_offset)
    rep = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).float()
    v = v.repeat_interleave(rep, dim=1).float()
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k) * (1.0 / math.sqrt(q.shape[-1]))
    if causal or window is not None:
        logits = logits.masked_fill(
            masked(S, causal, window, q.device, _rows(S, q_offset, q.device),
                   torch.arange(k.shape[2], device=q.device)), NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs, v).to(q.dtype)


def flash_attention_tiled_ref(q, k, v, causal: bool = True, window=None,
                              q_offset=None) -> torch.Tensor:
    """The bf16 CUDA kernel's arithmetic in plain PyTorch, on no path: keys
    in tiles of ``key_tile(D)`` with a running float32 max m, sum l and
    accumulator; per tile p = exp(s - m) in float32, l from that float32 p,
    and P rounded to bfloat16 before the product with V (as tensor-core
    flash kernels do); l clamped at 1e-30 and the output cast to q's dtype.
    A row that has seen only masked keys takes m = 0 as its reference, so
    its masked scores give p = 0 (the kernel's guard: no exp(0) = 1 from
    two equal maxima). Against
    ``flash_attention_ref`` only P's rounding differs (each p within a
    relative 2**-8), so every output is within 2**-8 * attn(q, k, |v|).
    Its float32 p differ from the kernel's in their last bits, so some
    entries of P round one bf16 ulp apart: against the kernel it is exact
    only up to the same 2**-8, from each side. Shapes (and ``q_offset``)
    as ``flash_attention_ref``."""
    B, H, S, D = q.shape
    Sk = k.shape[2]
    check_lengths(S, Sk, causal, window, q_offset)
    rep = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).float()
    v = v.repeat_interleave(rep, dim=1).float()
    qf = q.float() * (1.0 / math.sqrt(q.shape[-1]))
    m = torch.full((B, H, S, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, H, S, 1), device=q.device)
    acc = torch.zeros((B, H, S, D), device=q.device)
    rows = _rows(S, q_offset, q.device)
    tile = key_tile(D)
    for k0 in range(0, Sk, tile):
        s = torch.einsum("bhsd,bhtd->bhst", qf, k[:, :, k0 : k0 + tile])
        if causal or window is not None:
            cols = torch.arange(k0, min(k0 + tile, Sk), device=q.device)
            s = s.masked_fill(masked(S, causal, window, q.device, rows, cols), NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_ref = torch.where(m_new == NEG_INF, 0.0, m_new)
        alpha = torch.exp(m - m_ref)
        p = torch.exp(s - m_ref)
        l = l * alpha + p.sum(-1, keepdim=True)
        p16 = p.to(torch.bfloat16).float()
        acc = acc * alpha + torch.einsum("bhst,bhtd->bhsd", p16, v[:, :, k0 : k0 + tile])
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)
