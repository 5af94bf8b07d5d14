"""Wrapper of the hand-written flash-decode kernels (csrc/decode_attention.cu).

The device of the input decides the path and nothing else: a CUDA tensor
launches the CUDA kernels (or raises if they cannot be built or launched); a
CPU tensor takes the plain PyTorch version in ``ref.py``. There is no
fallback from one to the other. The library is compiled with ``nvcc`` at
first use (``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import build_library, launch
from repro_torch.kernels.decode_attention import ref
from repro_torch.kernels.flash_attention.ops import DTYPES, check_attention_args

_SRC = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
_lib = None  # the loaded shared library, once built
CHUNK = 256  # keys per block of the partial pass (csrc: kChunk)
MAX_GROUP = 8  # query heads per kv head (csrc: kMaxG)


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the flash-decode library."""
    global _lib
    if _lib is None:
        lib = build_library(_SRC)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_fwd.argtypes = [ptr] * 7 + [i32] * 6 + [ptr, ptr]
        lib.decode_attention_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor):
    """One query per (batch, head) against a KV cache: q (B, H, D); k, v
    (B, KV, T, D) with H % KV == 0 and H / KV <= 8, any strides with D
    contiguous, float32 or bfloat16; ``pos`` a 0-d int32 tensor on q's
    device: keys 0..pos are attended (all of them if pos >= T). Returns
    (B, H, D) in q's dtype. On CUDA, ``pos`` is read by the kernels on the
    device (no host sync), and k and v must be 16-byte aligned, with strides
    of whole 16-byte units."""
    check_attention_args(q, k, v, kv_name="the cache")
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"q must be 3-D and k, v 4-D, got {tuple(q.shape)}, {tuple(k.shape)}")
    if not isinstance(pos, torch.Tensor) or pos.dim() != 0 or pos.dtype != torch.int32:
        raise TypeError("pos must be a 0-d int32 tensor")
    if pos.device != q.device:
        raise ValueError(f"pos is on {pos.device}, q is on {q.device}")
    B, H, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    if T < 1:
        raise ValueError("empty cache")
    if q.device.type == "cpu":
        return ref.decode_ref(q, k, v, pos)
    if H // KV > MAX_GROUP:
        raise ValueError(f"H / KV = {H // KV} exceeds {MAX_GROUP} query heads per kv head")
    size = k.element_size()
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(s * size % 16 for s in t.stride()[:3]):
            raise ValueError(f"{name} must be 16-byte aligned with 16-byte strides")
    lib = build()
    n_chunks = -(-T // CHUNK)
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    part_acc = torch.empty((B, H, n_chunks, D), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B, H, n_chunks, 2), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 8)(*q.stride()[:2], *k.stride()[:3], *v.stride()[:3])
    launch(
        "decode_attention", lib.decode_attention_fwd, out.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        DTYPES[q.dtype], B, H, KV, T, D, ctypes.cast(strides, ctypes.c_void_p), device=q.device,
    )
    decode.LAUNCHES += 1
    return out


decode.LAUNCHES = 0  # wrapper calls that launched the kernels (partials + combine)
