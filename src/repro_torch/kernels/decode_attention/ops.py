"""Wrapper of the hand-written flash-decode kernel (csrc/decode_attention.cu).

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

from repro_torch.kernels._build import build_library, launch
from repro_torch.kernels.decode_attention import ref
from repro_torch.kernels.flash_attention.ops import DTYPES, check_attention_args

_SRC = Path(__file__).resolve().parent / "csrc" / "decode_attention.cu"
_lib = None  # the loaded shared library, once built
MAX_GROUP = 8  # query heads per kv head (csrc: kMaxG)
MAX_SPLITS = 8  # CTAs of one (batch, kv head), one cluster: the portable size (csrc: kMaxSplits)
CTAS_PER_SM = 1  # clusters are sized for this many CTAs an SM (see choose_splits)
_sm_counts: dict = {}  # device index -> its number of SMs


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the flash-decode library."""
    global _lib
    if _lib is None:
        lib = build_library(_SRC)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.decode_attention_fwd.argtypes = [ptr] * 5 + [i32] * 7 + [ptr, ptr]
        lib.decode_attention_fwd.restype = ctypes.c_int
        lib.decode_attention_smem_bytes.argtypes = []
        lib.decode_attention_smem_bytes.restype = ctypes.c_int
        _lib = lib
    return _lib


def choose_splits(B: int, KV: int, n_sm: int, ctas_per_sm: int = CTAS_PER_SM) -> int:
    """The CTAs (key splits) of each (batch, kv head): as many as fill the
    card's ``n_sm * ctas_per_sm`` CTA slots in about one wave, at least 1 and
    at most ``MAX_SPLITS``. On 132 SMs at (B, KV) = (4, 8): 4 at one CTA an
    SM, 8 at two."""
    return max(1, min(MAX_SPLITS, n_sm * ctas_per_sm // (B * KV)))


def decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor,
           n_splits: int | None = None):
    """One query per (batch, head) against a KV cache: q (B, H, D); k, v
    (B, KV, T, D) with H % KV == 0 and H / KV <= 8, any strides with D
    contiguous, float32 or bfloat16; ``pos`` a 0-d int32 tensor on q's
    device: keys 0..pos are attended (all of them if pos >= T). Returns
    (B, H, D) in q's dtype. On CUDA, ``pos`` is read by the kernel on the
    device (no host sync), and k and v must be 16-byte aligned, with strides
    of whole 16-byte units. ``n_splits`` (1..8) sets the CTAs of each
    (batch, kv head); None takes ``choose_splits`` for the card. The result
    does not depend on it beyond float32 rounding."""
    check_attention_args(q, k, v, kv_name="the cache")
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"q must be 3-D and k, v 4-D, got {tuple(q.shape)}, {tuple(k.shape)}")
    if not isinstance(pos, torch.Tensor) or pos.dim() != 0 or pos.dtype != torch.int32:
        raise TypeError("pos must be a 0-d int32 tensor")
    if pos.device != q.device:
        raise ValueError(f"pos is on {pos.device}, q is on {q.device}")
    if n_splits is not None and not 1 <= n_splits <= MAX_SPLITS:
        raise ValueError(f"n_splits must be in 1..{MAX_SPLITS}, got {n_splits}")
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
    if n_splits is None:
        dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
        if dev not in _sm_counts:
            _sm_counts[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
        n_splits = choose_splits(B, KV, _sm_counts[dev])
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_int64 * 8)(*q.stride()[:2], *k.stride()[:3], *v.stride()[:3])
    launch(
        "decode_attention", lib.decode_attention_fwd, out.data_ptr(), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), pos.data_ptr(), DTYPES[q.dtype], B, H, KV, T, D, n_splits,
        ctypes.cast(strides, ctypes.c_void_p), device=q.device,
    )
    decode.LAUNCHES += 1
    return out


decode.LAUNCHES = 0  # wrapper calls that launched the kernel (one launch each)
