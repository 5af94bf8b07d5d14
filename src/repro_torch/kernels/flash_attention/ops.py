"""Wrapper of the hand-written flash-attention kernel (csrc/flash_attention.cu).

The device of the input decides the path and nothing else: a CUDA tensor
launches the CUDA kernel (or raises if it cannot be built or launched); a
CPU tensor takes the plain PyTorch version in ``ref.py``. There is no
fallback from one to the other. On the card, bfloat16 runs the tensor-core
kernel (TMA loads, ``wgmma``; P rounded to bf16 before the product with V)
and float32 the CUDA-core kernel (float32 throughout). The library is
compiled with ``nvcc`` at first use (``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import build_library, count_launch, forbid_grad, launch, plain
from repro_torch.kernels.flash_attention import ref

_SRC = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_lib = None  # the loaded shared library, once built
HEAD_DIMS = (16, 64, 128, 256)  # the kernels' instantiations: the ported configs' head sizes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the flash-attention library."""
    global _lib
    if _lib is None:
        lib = build_library(_SRC)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [ptr] * 4 + [i32] * 10 + [ptr, ptr]
        lib.flash_attention_fwd.restype = ctypes.c_int
        lib.flash_attention_smem_bytes.argtypes = [i32, i32]
        lib.flash_attention_smem_bytes.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_attention_args(q, k, v, kv_name: str = "k, v") -> None:
    """The checks both attention wrappers share: one device and dtype,
    float32 or bfloat16, head_dim contiguous (on CUDA in HEAD_DIMS; the plain
    versions take any), H % KV == 0."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q is on {q.device}")
        if t.shape[-1] != q.shape[-1]:
            raise ValueError(f"head_dim of {name} is {t.shape[-1]}, of q {q.shape[-1]}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last (head_dim) dimension")
    if k.shape != v.shape:
        raise ValueError(f"{kv_name} shapes differ: {tuple(k.shape)} vs {tuple(v.shape)}")
    if q.shape[0] != k.shape[0]:
        raise ValueError(f"batch of q is {q.shape[0]}, of {kv_name} {k.shape[0]}")
    if k.shape[1] < 1 or q.shape[1] % k.shape[1] != 0:
        raise ValueError(f"q heads ({q.shape[1]}) must be a multiple of kv heads ({k.shape[1]})")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if q.device.type == "cuda" and q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head_dim {q.shape[-1]} not in the kernels' {HEAD_DIMS}")


def check_tma_layout(*tensors) -> None:
    """The bfloat16 kernel loads its tiles with TMA, which takes base
    addresses and strides that are multiples of 16 bytes: raise ValueError
    for any other layout (there is no other kernel to switch to)."""
    for t in tensors:
        size = t.element_size()
        if t.data_ptr() % 16 or any(st * size % 16 for st in t.stride()[:-1]):
            raise ValueError(
                f"the bf16 kernel needs 16-byte aligned base and strides, got address "
                f"{t.data_ptr():#x} and strides {tuple(t.stride())} of {size}-byte elements"
            )


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
              window: int | None = None, q_offset: int | None = None):
    """Softmax attention, causal by default: q (B, H, Sq, D), k and v
    (B, KV, Sk, D) with H % KV == 0, any strides with D contiguous (bfloat16
    on CUDA: 16-byte aligned, ``check_tma_layout``), float32 or bfloat16,
    any Sq, Sk >= 1. Query head h reads kv head h // (H / KV). Causal (row
    i sees keys j <= i) or with a ``window`` (causal only: row i sees keys
    i - window < j <= i, the reference's sliding window) needs Sq == Sk,
    else ValueError; ``causal=False`` sees every key, and Sq and Sk may
    differ (cross-attention). A causal ``q_offset`` (a host int) puts query
    row i at position q_offset + i against keys 0..Sk-1, which must hold
    them (q_offset + Sq <= Sk): a sequence-parallel rank's rows of a
    prefill; with a ``window`` too, row i sees keys q_offset + i - window <
    j <= q_offset + i (gemma3's local layers on a model axis that its heads
    do not divide). Query tiles skip the key tiles past their last row and
    before their first row's window. Launches at an offset count in
    ``attention.OFFSET_LAUNCHES``, the others in ``attention.LAUNCHES``. Returns (B, H, Sq, D) in q's dtype; on CUDA with q's strides, so for a
    transposed (B, S, H, D) q the result transposes back to a contiguous
    tensor."""
    forbid_grad("attention", q, k, v)
    check_attention_args(q, k, v)
    if window is not None:
        if not causal:
            raise ValueError("a sliding window needs causal attention")
        if int(window) < 1:
            raise ValueError(f"window must be at least 1, got {window}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q, k, v must be 4-D, got {tuple(q.shape)}, {tuple(k.shape)}")
    if q.shape[2] < 1 or k.shape[2] < 1:
        raise ValueError("empty sequence")
    if q_offset is not None:
        q_offset = int(q_offset)
    ref.check_lengths(q.shape[2], k.shape[2], causal, window, q_offset)
    if q.device.type == "cpu":
        return plain("flash_attention", ref.flash_attention_ref, q, k, v, causal=causal,
                     window=window, q_offset=q_offset)
    B, H, S, D = q.shape
    Sk = k.shape[2]
    if B * H > 65535:
        raise ValueError(f"B * H = {B * H} exceeds the grid's 65535")
    if q.dtype == torch.bfloat16:
        check_tma_layout(q, k, v)
    lib = build()
    out = torch.empty_like(q)  # q's strides (dense, non-overlapping inputs)
    strides = (ctypes.c_int64 * 12)(
        *(s for t in (out, q, k, v) for s in t.stride()[:3])
    )
    launch(
        "flash_attention", lib.flash_attention_fwd, out.data_ptr(), q.data_ptr(),
        k.data_ptr(), v.data_ptr(), DTYPES[q.dtype], B, H, k.shape[1], S, Sk, D, int(causal),
        min(int(window), Sk) if window is not None else 0, q_offset or 0,
        ctypes.cast(strides, ctypes.c_void_p), device=q.device,
    )
    count_launch(attention, "LAUNCHES" if q_offset is None else "OFFSET_LAUNCHES")
    return out


attention.LAUNCHES = 0  # kernel launches, counted where they happen
attention.OFFSET_LAUNCHES = 0  # the same, of calls at a causal query offset
