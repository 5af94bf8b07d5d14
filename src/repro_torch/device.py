"""Device selection for the port's entry points.

Every entry point takes a ``device`` argument that defaults to CUDA. A CUDA
device that does not exist is an error: nothing falls back to the CPU. The
CPU runs only when the caller asks for it, as the tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """Validate ``device`` ("cuda", "cuda:N", "cpu" or a torch.device).

    On CUDA this also pins float32 matrix products to full float32: TF32
    (about three decimal digits) is off for cuBLAS and cuDNN, so the port's
    SGD matches the reference within the stated weight tolerances."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA device is available; "
                "pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (expected cuda or cpu)")
    return dev
