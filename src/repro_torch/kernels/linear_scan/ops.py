"""Wrapper of the hand-written RWKV6 linear-scan kernel (csrc/linear_scan.cu).

The device of the input decides the path and nothing else: a CUDA tensor
launches the CUDA kernel (or raises if it cannot be built or launched); a
CPU tensor takes the plain chunked version in ``ref.py``, the reference
model's own arithmetic. There is no fallback from one to the other. The
library is compiled with ``nvcc`` at first use (``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels._build import build_library, count_launch, forbid_grad, launch, plain
from repro_torch.kernels.flash_attention.ops import DTYPES
from repro_torch.kernels.linear_scan import ref

_SRC = Path(__file__).resolve().parent / "csrc" / "linear_scan.cu"
_lib = None  # the loaded shared library, once built
HEAD_SIZE = 64  # the kernel's K = V (csrc: kK), every RWKV6 config's head size
# a block per (batch, head) of this many threads, each holding ref.ROWS x 2 state
# elements (csrc: kThreads, kRT, kCT), two blocks an SM (its __launch_bounds__)
THREADS = HEAD_SIZE * HEAD_SIZE // (ref.ROWS * 2)
BLOCKS_PER_SM = 2


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the linear-scan library."""
    global _lib
    if _lib is None:
        lib = build_library(_SRC)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rwkv6_scan_fwd.argtypes = [ptr] * 8 + [i32] * 4 + [ptr, ptr]
        lib.rwkv6_scan_fwd.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(r, k, v, logw, u, chunk, init_state) -> None:
    if r.dtype not in DTYPES:
        raise TypeError(f"r must be float32 or bfloat16, got {r.dtype}")
    if r.dim() != 4:
        raise ValueError(f"r, k, v and logw must be (B, T, H, K), got r {tuple(r.shape)}")
    B, T, H, K = r.shape
    if T < 1:
        raise ValueError("empty sequence")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {r.device}")
    for name, t, dtype, shape in (
        ("k", k, r.dtype, r.shape), ("v", v, r.dtype, r.shape),
        ("logw", logw, torch.float32, r.shape), ("u", u, torch.float32, (H, K)),
        ("init_state", init_state, torch.float32, (B, H, K, K)),
    ):
        if t is None:
            continue
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r is on {r.device}")
    if not isinstance(chunk, int) or chunk < 1:
        raise ValueError(f"chunk must be a positive int, got {chunk!r}")


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
               u: torch.Tensor, chunk: int, init_state=None):
    """The RWKV6 recurrence (``ref.py``): r, k, v (B, T, H, K) float32 or
    bfloat16, logw (B, T, H, K) float32 log-decays, u (H, K) float32, an
    optional float32 initial state (B, H, K, K); any T >= 1. Returns (out
    (B, T, H, K) in r's dtype, the float32 final state (B, H, K, K)).

    On CUDA the kernel runs the step form for K = 64 and ignores ``chunk``;
    r, k, v and logw may have any strides with K contiguous; u and the
    initial state must be contiguous; a readout's partial sums are added
    in ``ref.rwkv6_split_ref``'s order. On the CPU,
    ``ref.rwkv6_chunked`` with chunks of ``chunk`` steps (the reference
    model's memory knob; any K), its float32 output rounded once to r's
    dtype."""
    forbid_grad("rwkv6_scan", r, k, v, logw, u, init_state)
    _check(r, k, v, logw, u, chunk, init_state)
    if r.device.type == "cpu":
        out, state = plain("rwkv6_scan", ref.rwkv6_chunked, r, k, v, logw, u, chunk, init_state)
        return out.to(r.dtype), state
    B, T, H, K = r.shape
    if K != HEAD_SIZE:
        raise ValueError(f"head size {K}: the kernel takes {HEAD_SIZE}")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the grid's 65535")
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dimension")
    for name, t in (("u", u), ("init_state", init_state)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = build()
    out = torch.empty((B, T, H, K), dtype=r.dtype, device=r.device)
    state = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    strides = (ctypes.c_int64 * 15)(*(s for t in (out, r, k, v, logw) for s in t.stride()[:3]))
    launch(
        "rwkv6_scan", lib.rwkv6_scan_fwd, out.data_ptr(), state.data_ptr(), r.data_ptr(),
        k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
        None if init_state is None else init_state.data_ptr(), DTYPES[r.dtype], B, T, H,
        ctypes.cast(strides, ctypes.c_void_p), device=r.device,
    )
    count_launch(rwkv6_scan)
    return out, state


rwkv6_scan.LAUNCHES = 0  # kernel launches, counted where they happen
