"""Plain PyTorch versions of the IPLS aggregation kernel.

Semantics (shared with the CUDA kernel and the scalar engine):
``w - eps * masked_SUM(deltas)``, the sum taken slot by slot in order and the
update rounded once, as one fmaf does. The 1/r normalization lives in the eps
recursion, never in the reduction. An all-zero mask row leaves w unchanged.

The CPU path of the engine and the tests use these; on the card they are
what the kernel is held against, bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quantize.ref import BLOCK


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a*b + c`` with ONE rounding to nearest, as ``fmaf`` does.

    The f64 product of two f32 values is exact. The f64 sum is rounded to
    odd (TwoSum gives the exact error; an inexact sum with an even last bit
    steps one ulp towards the exact value), and rounding a round-to-odd
    value with 53 >= 24 + 2 bits to f32 is the correctly rounded result
    (Boldo and Melquiond). A plain f64 sum would round twice and, where the
    f64 sum lands exactly on an f32 tie, differ from fmaf by one ulp."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bp = s - c64
    err = (c64 - (s - bp)) + (p - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def ipls_aggregate_batched_ref(
    w: torch.Tensor,       # (K, S) partition values
    deltas: torch.Tensor,  # (K, R, S) deltas per partition per contributor slot
    mask: torch.Tensor,    # (K, R) 1.0 where the contribution arrived
    eps: torch.Tensor,     # (K,) staleness weight per partition
) -> torch.Tensor:
    """Per-partition ``w - eps * masked_sum(deltas)``: the kernel's
    arithmetic, operation for operation (multiply and add each rounded,
    then one fused update)."""
    acc = torch.zeros_like(w)
    for r in range(deltas.shape[1]):
        acc = acc + mask[:, r, None] * deltas[:, r]
    return fma_f32(-eps[:, None], acc, w)


def ipls_aggregate_batched_q_ref(
    w: torch.Tensor,         # (K, S) partition values
    own: torch.Tensor,       # (K, S) the holder's own (never quantized) delta
    q: torch.Tensor,         # (K, R, S) int8 wire codes of the remote deltas
    scales: torch.Tensor,    # (K, R, ceil(S/BLOCK)) float32 per-block pow2 scales
    mask: torch.Tensor,      # (K, R) 1.0 where the remote contribution arrived
    own_mask: torch.Tensor,  # (K,) 1.0 where the holder's own delta takes part
    eps: torch.Tensor,       # (K,) staleness weight per partition
) -> torch.Tensor:
    """Quantized-input form, with the arithmetic of the reference's Pallas
    kernel operation for operation: the own delta first, then slot by slot
    ``acc + mask * (code * scale)`` (the dequantize is exact), then one fused
    update."""
    S = w.shape[1]
    acc = own_mask[:, None] * own
    for r in range(q.shape[1]):
        scale = scales[:, r].repeat_interleave(BLOCK, dim=1)[:, :S]
        acc = acc + mask[:, r, None] * (q[:, r].to(torch.float32) * scale)
    return fma_f32(-eps[:, None], acc, w)
