"""The roofline of the port's built steps on NVIDIA H100 cards: the
reference's ``roofline/`` names, with ``analyze_step`` (a built step
counted on fake tensors, ``cost.py``) in place of ``analyze_compiled`` and
``collective_bytes`` (one collective's ring accounting) in place of
``collective_bytes_from_hlo``."""
from repro_torch.roofline.analysis import (
    HW,
    HardwareSpec,
    RooflineReport,
    collective_bytes,
    model_flops_for,
)
from repro_torch.roofline.cost import analyze_step, count_step, fake_world

__all__ = [
    "HW",
    "HardwareSpec",
    "RooflineReport",
    "analyze_step",
    "collective_bytes",
    "count_step",
    "fake_world",
    "model_flops_for",
]
