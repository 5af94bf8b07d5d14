"""Wrappers of the hand-written IPLS aggregation kernel (csrc/ipls_aggregate.cu).

The device of the input decides the path and nothing else: a CUDA tensor
launches the CUDA kernel (or raises if it cannot be built or launched); a
CPU tensor takes the plain PyTorch version in ``ref.py``. There is no
fallback from one to the other.

The kernel is compiled with ``nvcc`` at first use into ``build/`` beside
this file (named by a hash of the source and flags, so an edited source is
rebuilt) and loaded with ``ctypes``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels.ipls_aggregate.ref import ipls_aggregate_batched_ref

_SRC = Path(__file__).resolve().parent / "csrc" / "ipls_aggregate.cu"
_BUILD_DIR = _SRC.parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
_lib = None  # the loaded shared library, once built


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    tag = hashlib.sha256(_SRC.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD_DIR / f"libipls_aggregate-{tag}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {_SRC.name}:\n{proc.stderr}")
        os.replace(tmp, so)  # atomic: concurrent builders never see a partial file
    lib = ctypes.CDLL(str(so))
    fn = lib.ipls_aggregate_batched_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _check(w, deltas, mask, eps) -> None:
    tensors = {"w": w, "deltas": deltas, "mask": mask, "eps": eps}
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != w.device:
            raise ValueError(f"{name} is on {t.device}, w on {w.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if w.dim() != 2 or w.shape[0] < 1 or w.shape[1] < 1:
        raise ValueError(f"w must be (K, S) with K, S >= 1, got {tuple(w.shape)}")
    K, S = w.shape
    if deltas.dim() != 3 or deltas.shape[0] != K or deltas.shape[2] != S:
        raise ValueError(f"deltas must be ({K}, R, {S}), got {tuple(deltas.shape)}")
    R = deltas.shape[1]
    if tuple(mask.shape) != (K, R):
        raise ValueError(f"mask must be ({K}, {R}), got {tuple(mask.shape)}")
    if tuple(eps.shape) != (K,):
        raise ValueError(f"eps must be ({K},), got {tuple(eps.shape)}")
    if K > 65535 or max(R, S) >= 2**31:
        raise ValueError(f"shape {(K, R, S)} exceeds the kernel's grid")


def aggregate_batched(w, deltas, mask, eps):
    """``w[k] - eps[k] * sum_r mask[k,r] * deltas[k,r]`` for K partition
    instances in one launch: w (K,S), deltas (K,R,S), mask (K,R), eps (K,),
    all float32 and contiguous on one device. Returns a new (K,S) tensor.
    Partitions of unequal true size share the padded S with zero tails,
    which stay zero."""
    _check(w, deltas, mask, eps)
    if w.device.type == "cpu":
        return ipls_aggregate_batched_ref(w, deltas, mask, eps)
    if w.device.type != "cuda":
        raise ValueError(f"unsupported device {w.device}")
    lib = build()
    K, S = w.shape
    R = deltas.shape[1]
    out = torch.empty_like(w)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.ipls_aggregate_batched_f32(
            out.data_ptr(), w.data_ptr(), deltas.data_ptr(), mask.data_ptr(),
            eps.data_ptr(), K, R, S, stream,
        )
    if err != 0:
        raise RuntimeError(f"ipls_aggregate_batched launch failed: CUDA error {err}")
    aggregate_batched.LAUNCHES += 1
    return out


aggregate_batched.LAUNCHES = 0  # kernel launches, counted where they happen


def aggregate(w, deltas, mask, eps):
    """Single-partition form (the reference's ``ipls_aggregate``): w (S,),
    deltas (R,S), mask (R,), eps () — the batched kernel at K=1, so its
    launches count in ``aggregate_batched.LAUNCHES``."""
    out = aggregate_batched(
        w.reshape(1, -1), deltas.unsqueeze(0), mask.reshape(1, -1), eps.reshape(1)
    )
    return out.reshape(w.shape)
