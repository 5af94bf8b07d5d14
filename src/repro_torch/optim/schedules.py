"""Learning-rate schedules: functions of the step counter (a 0-d int32
tensor) giving a 0-d float32 tensor on the step's device.

Port of the reference's ``optim/schedules.py``, in its float32 arithmetic.
Divisions divide by a tensor on the step's device: a division by a Python
number is a multiplication by its reciprocal on CUDA, which can differ in
the last bit.
"""
from __future__ import annotations

import math

import torch


def fdiv(x: torch.Tensor, d) -> torch.Tensor:
    """``x / d`` as a true float division on any device (``d`` a number or
    a tensor)."""
    if not isinstance(d, torch.Tensor):
        d = torch.full((), d, dtype=x.dtype, device=x.device)
    return x / d


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32, device=step.device)


def linear_warmup(peak_lr: float, warmup_steps: int):
    def sched(step):
        step = step.float()
        return peak_lr * torch.clamp(fdiv(step + 1.0, max(warmup_steps, 1)), max=1.0)

    return sched


def cosine_warmup(peak_lr: float, warmup_steps: int, total_steps: int, min_ratio: float = 0.1):
    def sched(step):
        step = step.float()
        warm = peak_lr * torch.clamp(fdiv(step + 1.0, max(warmup_steps, 1)), max=1.0)
        prog = torch.clamp(
            fdiv(step - warmup_steps, max(total_steps - warmup_steps, 1)), 0.0, 1.0
        )
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)

    return sched
