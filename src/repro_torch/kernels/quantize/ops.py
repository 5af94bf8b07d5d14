"""Wrappers of the hand-written block-int8 codec kernels (csrc/quantize.cu).

The device of the input decides the path and nothing else: a CUDA tensor
launches the CUDA kernel (or raises if it cannot be built or launched); a
CPU tensor takes the plain PyTorch version in ``ref.py``. There is no
fallback from one to the other. The library is compiled with ``nvcc`` at
first use (``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import build_library, count_launch, launch, plain
from repro_torch.kernels.quantize import ref
from repro_torch.kernels.quantize.ref import num_blocks

_SRC = Path(__file__).resolve().parent / "csrc" / "quantize.cu"
_lib = None  # the loaded shared library, once built


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the codec library."""
    global _lib
    if _lib is None:
        lib = build_library(_SRC)
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.quantize_f32_int8.argtypes = [ptr] * 5 + [i64, ptr]
        lib.quantize_f32_int8.restype = ctypes.c_int
        lib.dequantize_int8_f32.argtypes = [ptr] * 3 + [i64, ptr]
        lib.dequantize_int8_f32.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(named, dtypes, device) -> None:
    for (name, t), dtype in zip(named.items(), dtypes):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if next(iter(named.values())).shape[0] < 1:
        raise ValueError("empty payload")


def quantize(x: torch.Tensor, err: torch.Tensor):
    """Block-int8 quantize of ``x + err``: x, err (N,) float32, contiguous,
    on one device. Returns (codes (N,) int8, scales (ceil(N/1024),) float32,
    new_err (N,) float32)."""
    _check({"x": x, "err": err}, (torch.float32, torch.float32), x.device)
    if err.shape != x.shape:
        raise ValueError(f"err must be {tuple(x.shape)}, got {tuple(err.shape)}")
    if x.device.type == "cpu":
        return plain("quantize", ref.quantize, x, err)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    lib = build()
    n = x.shape[0]
    q = torch.empty(n, dtype=torch.int8, device=x.device)
    scales = torch.empty(num_blocks(n), dtype=torch.float32, device=x.device)
    new_err = torch.empty_like(x)
    launch(
        "quantize", lib.quantize_f32_int8, q.data_ptr(), scales.data_ptr(),
        new_err.data_ptr(), x.data_ptr(), err.data_ptr(), n, device=x.device,
    )
    count_launch(quantize)
    return q, scales, new_err


def dequantize(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``codes * scale`` per 1024-block: q (N,) int8, scales (ceil(N/1024),)
    float32, contiguous, on one device. Returns (N,) float32."""
    _check({"q": q, "scales": scales}, (torch.int8, torch.float32), q.device)
    if scales.shape[0] != num_blocks(q.shape[0]):
        raise ValueError(
            f"scales must have {num_blocks(q.shape[0])} entries, got {scales.shape[0]}"
        )
    if q.device.type == "cpu":
        return plain("dequantize", ref.dequantize, q, scales)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    lib = build()
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    launch(
        "dequantize", lib.dequantize_int8_f32, out.data_ptr(), q.data_ptr(),
        scales.data_ptr(), q.shape[0], device=q.device,
    )
    count_launch(dequantize)
    return out


quantize.LAUNCHES = 0  # kernel launches, counted where they happen
dequantize.LAUNCHES = 0
