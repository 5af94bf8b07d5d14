"""Wire codecs: how partition payloads travel the simulated network.

Counterpart of ``repro.core.wire``: the numpy codec, bit for bit, and the
row helpers that quantize whole device planes of the batched engine through
the codec kernels (``kernels/quantize``).

Two formats, selected by ``SimConfig.wire_dtype``:

  * ``"f32"``  — raw float32 values; N values cost 4N bytes.
  * ``"int8"`` — block-int8 with per-block power-of-two scales (the
    ``kernels/quantize`` format): N values cost N + 4*ceil(N/BLOCK) bytes,
    ~4x less. Delta (UpdateModel) sends carry an error-feedback residual so
    quantization noise telescopes instead of biasing convergence
    (Karimireddy et al., arXiv:1901.09847); value transfers (fetch replies,
    replica publishes) are stateless — every holder of the same version must
    put the identical payload on the wire.

Why power-of-two scales instead of the usual ``absmax/127``: every codec op
becomes EXACT in f32 — ``x * 2**-e`` scales without rounding, ``q * 2**e``
dequantizes without rounding, and the residual ``x - q*2**e`` subtracts an
exactly-representable product. That makes the codec bit-stable under any
compiler fusion (no reciprocal rewrites of a division, no FMA contraction of
an inexact product), which is what lets the scalar oracle (numpy), a
batched device engine and a device kernel produce identical bits from
identical inputs — the engine-equivalence tests rely on it. The cost is a
quantization step up to 2x coarser than ``absmax/127`` (the scale rounds UP
to the next power of two); error feedback absorbs the difference.

Per block of 1024 values: ``e`` is chosen so ``absmax/scale`` lands in
[64, 128) (``scale = 2**(E-6)`` for ``absmax = m * 2**E``), codes clip to
[-127, 127]. Blocks whose absmax falls below ``2**-120`` (including all-zero
blocks) transmit scale 0 and all-zero codes; their values ride the error
residual instead.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from repro_torch.kernels.quantize.ops import dequantize, quantize

BLOCK = 1024  # must match repro.core.wire.BLOCK (asserted in tests)

# Biased-exponent threshold below which a block is sent as all-zeros: the
# inverse scale 2**(6-E) must stay a normal f32, which needs e0 >= 7.
_EMIN = 6

# What travels in a pubsub payload slot: raw f32 values, or (codes, scales).
WirePayload = Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]


def num_blocks(n: int) -> int:
    return -(-n // BLOCK)


def wire_size(n: int, wire_dtype: str) -> int:
    """Closed-form wire bytes of one n-element payload."""
    if wire_dtype == "int8":
        return n + 4 * num_blocks(n)
    return 4 * n


def _np_pow2_scales(absmax: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(scale, inv_scale) per block, both exact powers of two (numpy)."""
    bits = np.ascontiguousarray(absmax, np.float32).view(np.int32)
    e0 = bits >> 23  # biased exponent; absmax >= 0 so the sign bit is clear
    zero = e0 <= _EMIN
    e0c = np.maximum(e0, _EMIN + 1)
    scale = ((e0c - _EMIN) << 23).astype(np.int32).view(np.float32)
    inv = (((127 + 133) - e0c) << 23).astype(np.int32).view(np.float32)
    z32 = np.float32(0.0)
    return np.where(zero, z32, scale), np.where(zero, z32, inv)


def _np_quantize(x: np.ndarray, err: np.ndarray):
    """Blockwise int8 quantize, numpy — bit-exact with the reference codec
    (all ops are exact, see module docstring)."""
    n = x.shape[0]
    pad = (-n) % BLOCK
    xb = np.pad(x.astype(np.float32), (0, pad)) + np.pad(err.astype(np.float32), (0, pad))
    xb = xb.reshape(-1, BLOCK)
    absmax = np.max(np.abs(xb), axis=1)
    scale, inv = _np_pow2_scales(absmax)
    q = np.clip(np.round(xb * inv[:, None]), -127, 127).astype(np.int8)
    deq = q.astype(np.float32) * scale[:, None]
    new_err = (xb - deq).reshape(-1)[:n]
    return q.reshape(-1), scale, new_err


def _np_dequantize(q: np.ndarray, scales: np.ndarray) -> np.ndarray:
    n = q.shape[0]
    pad = (-n) % BLOCK
    qb = np.pad(q, (0, pad)).reshape(-1, BLOCK).astype(np.float32)
    return (qb * scales[:, None]).reshape(-1)[:n]


class F32Wire:
    """Identity codec: payloads are the f32 values themselves."""

    dtype = "f32"

    def encode_value(self, x: np.ndarray) -> Tuple[WirePayload, int]:
        payload = np.array(x, dtype=np.float32)  # copy: wire snapshot, not a view
        return payload, payload.nbytes

    def encode_delta(self, x, err) -> Tuple[WirePayload, int, np.ndarray]:
        payload, nb = self.encode_value(x)
        return payload, nb, err

    def decode(self, payload: WirePayload) -> np.ndarray:
        return np.asarray(payload, dtype=np.float32)


class Int8Wire:
    """Block-int8 codec: payloads are (codes int8, per-block pow2 scales)."""

    dtype = "int8"

    def encode_value(self, x: np.ndarray) -> Tuple[WirePayload, int]:
        n = x.shape[0]
        q, s, _ = _np_quantize(np.asarray(x, dtype=np.float32), np.zeros(n, np.float32))
        q = q[:n]
        return (q, s), q.nbytes + s.nbytes

    def encode_delta(self, x, err) -> Tuple[WirePayload, int, np.ndarray]:
        n = x.shape[0]
        q, s, new_err = _np_quantize(np.asarray(x, dtype=np.float32), err)
        q = q[:n]
        return (q, s), q.nbytes + s.nbytes, new_err

    def decode(self, payload: WirePayload) -> np.ndarray:
        q, s = payload
        return _np_dequantize(q, s)


def make_wire(wire_dtype: str):
    if wire_dtype == "f32":
        return F32Wire()
    if wire_dtype == "int8":
        return Int8Wire()
    raise ValueError(f"unknown wire_dtype {wire_dtype!r} (expected 'f32' or 'int8')")


# ---------------------------------------------------------------------------
# Row helpers for the batched engine: quantize whole (..., M) planes, M a
# multiple of BLOCK (partition tails padded with zeros quantize to zero
# blocks, matching the scalar codec's per-slice padding exactly). Each row is
# whole blocks, so the flattened plane goes through the codec kernels in ONE
# launch and quantizes exactly as its rows would one by one.
# ---------------------------------------------------------------------------


def _flat(t: torch.Tensor) -> torch.Tensor:
    if t.shape[-1] % BLOCK:
        raise ValueError(f"rows of {t.shape[-1]} values are not whole {BLOCK}-blocks")
    return t.contiguous().reshape(-1)


def quantize_rows(x: torch.Tensor, err: torch.Tensor):
    """x, err: (..., M) float32, M % BLOCK == 0. Returns (q int8 (..., M),
    scales float32 (..., M//BLOCK), new_err float32 (..., M))."""
    shp = x.shape
    q, scales, new_err = quantize(_flat(x), _flat(err))
    return q.reshape(shp), scales.reshape(*shp[:-1], shp[-1] // BLOCK), new_err.reshape(shp)


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """q: (..., M) int8, scales: (..., M//BLOCK) float32. Returns float32
    (..., M)."""
    return dequantize(_flat(q), scales.contiguous().reshape(-1)).reshape(q.shape)


def qdq_rows(x: torch.Tensor) -> torch.Tensor:
    """Stateless quantize->dequantize: what a value payload looks like after
    one trip over the int8 wire."""
    q, scales, _ = quantize_rows(x, torch.zeros_like(x))
    return dequantize_rows(q, scales)
