"""Device-side metric math shared by all engines.

Counterpart of ``repro.telemetry.device``. The streams of the scalar,
batched and windowed engines agree byte for byte, the float32 norm columns
included, so every engine must run the SAME reduction: ``torch.sum`` of one
contiguous float32 tensor of one shape on one device is one program, on the
card as on the CPU (there, within one process: the CPU sum splits its work
by thread count). The batched engine computes ``metric_pair`` inside its
device round, as an auxiliary output (captured into the window's CUDA
graph); the scalar engine calls ``host_normsq`` on planes of the same shape
moved to the same device: the (n_active, N) delta rows in training order and
the (K_inst, S) value plane.
"""
from __future__ import annotations

import numpy as np
import torch


def normsq(x: torch.Tensor) -> torch.Tensor:
    """Sum of squares, float32 in, float32 scalar out."""
    return torch.sum(x * x)


def metric_pair(delta_plane: torch.Tensor, value_plane: torch.Tensor) -> torch.Tensor:
    """The per-round (delta_normsq, value_normsq) auxiliary output of the
    batched engine, as one (2,) float32 tensor."""
    return torch.stack([normsq(delta_plane), normsq(value_plane)])


def host_normsq(x: np.ndarray, device) -> float:
    """The scalar engine's entry point: ``normsq`` of ``x`` as a contiguous
    float32 tensor on ``device``, read back as a Python float (exact)."""
    t = torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)
    return float(normsq(t))
