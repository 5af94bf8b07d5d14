"""Plain PyTorch versions of the block-int8 codec kernels.

Semantics of the reference's ``kernels/quantize/ref.py``: N values (any N)
become N int8 codes plus ``ceil(N / BLOCK)`` float32 per-block scales. A
block's scale is the power of two ``2**(E-6)`` for its absmax ``m * 2**E``,
read off the exponent bits, so ``absmax / scale`` lies in [64, 128); blocks
whose biased exponent is at most 6 (absmax below ``2**-120``, all-zero
blocks included) get scale 0 and all-zero codes. Codes are
``clip(round_half_even(x / scale), -127, 127)`` and the residual is
``x - code * scale``. Every operation is exact in float32 except ``x + err``,
which rounds once, so the CUDA kernels are held to these bit for bit.

The CPU path of the engine and the tests use these; on the card they are
what the kernels are held against.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

BLOCK = 1024
_EMIN = 6  # biased exponents <= this quantize to the zero block


def num_blocks(n: int) -> int:
    return -(-n // BLOCK)


def _pow2_scales(absmax: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scale, inv_scale), both exact powers of two, from the exponent bits
    of a non-negative float32 absmax."""
    e0 = absmax.view(torch.int32) >> 23
    zero = e0 <= _EMIN
    e0c = torch.clamp(e0, min=_EMIN + 1)
    scale = ((e0c - _EMIN) << 23).view(torch.float32)
    inv = (((127 + 133) - e0c) << 23).view(torch.float32)
    z = torch.zeros((), dtype=torch.float32, device=absmax.device)
    return torch.where(zero, z, scale), torch.where(zero, z, inv)


def quantize(x: torch.Tensor, err: torch.Tensor):
    """x, err: (N,) float32. Returns (q (N,) int8, scales (ceil(N/BLOCK),)
    float32, new_err (N,) float32). The ragged tail is padded with zeros."""
    n = x.shape[0]
    pad = (-n) % BLOCK
    xb = (F.pad(x, (0, pad)) + F.pad(err, (0, pad))).reshape(-1, BLOCK)
    absmax = xb.abs().amax(dim=1)
    scale, inv = _pow2_scales(absmax)
    q = torch.clamp(torch.round(xb * inv[:, None]), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale[:, None]
    new_err = (xb - deq).reshape(-1)[:n]
    return q.reshape(-1)[:n], scale, new_err


def dequantize(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """q: (N,) int8, scales: (ceil(N/BLOCK),) float32. Returns (N,) float32
    ``q * scale`` (exact: scales are powers of two or zero)."""
    n = q.shape[0]
    qb = F.pad(q, (0, (-n) % BLOCK)).reshape(-1, BLOCK).to(torch.float32)
    return (qb * scales[:, None]).reshape(-1)[:n]
