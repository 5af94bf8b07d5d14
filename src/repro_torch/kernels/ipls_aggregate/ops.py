"""Wrappers of the hand-written IPLS aggregation kernels (csrc/ipls_aggregate.cu).

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
from repro_torch.kernels.ipls_aggregate.ref import (
    ipls_aggregate_batched_q_ref,
    ipls_aggregate_batched_ref,
)
from repro_torch.kernels.quantize.ref import num_blocks

_SRC = Path(__file__).resolve().parent / "csrc" / "ipls_aggregate.cu"
_lib = None  # the loaded shared library, once built


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = build_library(_SRC)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ipls_aggregate_batched_f32.argtypes = [ptr] * 5 + [i32] * 3 + [ptr]
        lib.ipls_aggregate_batched_f32.restype = ctypes.c_int
        lib.ipls_aggregate_batched_q_f32.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
        lib.ipls_aggregate_batched_q_f32.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_tensors(tensors, int8=()) -> None:
    w = tensors["w"]
    for name, t in tensors.items():
        dtype = torch.int8 if name in int8 else torch.float32
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != w.device:
            raise ValueError(f"{name} is on {t.device}, w on {w.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check(w, deltas, mask, eps) -> None:
    _check_tensors({"w": w, "deltas": deltas, "mask": mask, "eps": eps})
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
        return plain("ipls_aggregate_batched", ipls_aggregate_batched_ref, w, deltas, mask, eps)
    if w.device.type != "cuda":
        raise ValueError(f"unsupported device {w.device}")
    K, S = w.shape
    out = torch.empty_like(w)
    launch(
        "ipls_aggregate_batched", build().ipls_aggregate_batched_f32, out.data_ptr(),
        w.data_ptr(), deltas.data_ptr(), mask.data_ptr(), eps.data_ptr(), K,
        deltas.shape[1], S, device=w.device,
    )
    count_launch(aggregate_batched)
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


LANES = (8, 4, 1)  # lanes a thread of the quantized kernel owns (csrc: launch_q<L>), widest first


def choose_lanes(S: int, *tensors) -> int:
    """The first lane count of ``LANES`` that divides S and to
    which the tensors' first elements are aligned (16 bytes for the float32
    ones where it is 4 or more): every code row is then one aligned vector
    per thread."""
    for lanes in LANES:
        if S % lanes == 0 and all(
            t.data_ptr() % (lanes if t.dtype == torch.int8 else (16 if lanes >= 4 else 4)) == 0
            for t in tensors
        ):
            return lanes
    return 1


def aggregate_batched_q(w, own, q, scales, mask, own_mask, eps):
    """Quantized-wire form (the reference's ``ipls_aggregate_batched_q``):
    ``w[k] - eps[k] * (own_mask[k]*own[k] + sum_r mask[k,r] * q[k,r]*scale)``
    in one launch. w, own (K,S) float32; q (K,R,S) int8 codes; scales
    (K,R,ceil(S/1024)) float32 per-block power-of-two scales; mask (K,R);
    own_mask, eps (K,); all contiguous on one device. Returns a new (K,S)
    tensor. On CUDA each thread owns ``choose_lanes`` adjacent lanes; every
    width gives the same bits."""
    _check_tensors(
        {"w": w, "own": own, "q": q, "scales": scales, "mask": mask,
         "own_mask": own_mask, "eps": eps},
        int8=("q",),
    )
    if w.dim() != 2 or w.shape[0] < 1 or w.shape[1] < 1:
        raise ValueError(f"w must be (K, S) with K, S >= 1, got {tuple(w.shape)}")
    K, S = w.shape
    if own.shape != w.shape:
        raise ValueError(f"own must be ({K}, {S}), got {tuple(own.shape)}")
    if q.dim() != 3 or q.shape[0] != K or q.shape[2] != S:
        raise ValueError(f"q must be ({K}, R, {S}), got {tuple(q.shape)}")
    R, NB = q.shape[1], num_blocks(S)
    if tuple(scales.shape) != (K, R, NB):
        raise ValueError(f"scales must be ({K}, {R}, {NB}), got {tuple(scales.shape)}")
    if tuple(mask.shape) != (K, R):
        raise ValueError(f"mask must be ({K}, {R}), got {tuple(mask.shape)}")
    for name, t in (("own_mask", own_mask), ("eps", eps)):
        if tuple(t.shape) != (K,):
            raise ValueError(f"{name} must be ({K},), got {tuple(t.shape)}")
    if K > 65535 or max(R, S) >= 2**31:
        raise ValueError(f"shape {(K, R, S)} exceeds the kernel's grid")
    if w.device.type == "cpu":
        return plain("ipls_aggregate_batched_q", ipls_aggregate_batched_q_ref, w, own, q,
                     scales, mask, own_mask, eps)
    if w.device.type != "cuda":
        raise ValueError(f"unsupported device {w.device}")
    out = torch.empty_like(w)
    launch(
        "ipls_aggregate_batched_q", build().ipls_aggregate_batched_q_f32, out.data_ptr(),
        w.data_ptr(), own.data_ptr(), q.data_ptr(), scales.data_ptr(), mask.data_ptr(),
        own_mask.data_ptr(), eps.data_ptr(), K, R, S, NB, choose_lanes(S, w, own, q, out),
        device=w.device,
    )
    count_launch(aggregate_batched_q)
    return out


aggregate_batched_q.LAUNCHES = 0
