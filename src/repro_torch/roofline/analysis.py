"""Three-term roofline of a built step on NVIDIA H100 cards.

    compute term    = bf16 FLOPs / (chips * bf16 FLOP/s)
                      + float32 FLOPs / (chips * float32 FLOP/s)
    memory term     = bytes / (chips * HBM rate)
    collective term = collective bytes / link rate

Port of the reference's ``roofline/analysis.py``. The reference reads its
FLOPs, bytes and collectives from XLA's compiled HLO; the port traces the
built step once on fake tensors (``roofline/cost.py``) and hands the
counts to the same report. Collective bytes are per-device wire bytes with
the reference's ring accounting:

    all-gather:         output bytes   (each device receives ~N(1-1/n))
    reduce-scatter:     input bytes    (each device sends ~N(1-1/n))
    all-reduce:         2 * input bytes (reduce-scatter + all-gather phases)
    all-to-all:         input bytes
    collective-permute: output bytes

Hardware: the H100 SXM5 80 GB data sheet (dense bf16 on the tensor cores;
float32 outside them, TF32 off as the port keeps it; HBM3; NVLink 4 per
direction). The reference's tpu-v5e figures are not carried over.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                    "collective-permute")


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str = "h100-sxm5-80gb"
    peak_flops: float = 989e12        # bf16 FLOP/s per card, dense tensor cores
    f32_flops: float = 67e12          # float32 FLOP/s per card, CUDA cores (TF32 off)
    hbm_bw: float = 3.35e12           # bytes/s per card
    link_bw: float = 450e9            # bytes/s per card and direction, NVLink 4


HW = HardwareSpec()


def collective_bytes(kind: str, in_bytes: float, out_bytes: float) -> float:
    """Per-device wire bytes of one collective (ring accounting, as the
    reference's ``collective_bytes_from_hlo`` counts each HLO instruction)."""
    if kind == "all-gather":
        return out_bytes
    if kind == "reduce-scatter":
        return in_bytes
    if kind == "all-reduce":
        return 2 * in_bytes
    if kind == "all-to-all":
        return in_bytes or out_bytes
    if kind == "collective-permute":
        return out_bytes
    raise ValueError(f"unknown collective {kind!r}; one of {COLLECTIVE_KINDS}")


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float                 # global FLOPs: the traced step's dots, times chips
    hlo_bytes: float                 # global bytes read and written
    collective_bytes: Dict[str, float]
    model_flops: float               # 6 * N_active * tokens (train), 2 * ... (forward)
    hlo_flops_f32: float = 0.0       # the part of hlo_flops in float32 dots (the f32 rate)
    peak_bytes_per_device: Optional[float] = None
    hw: HardwareSpec = dataclasses.field(default_factory=lambda: HW)

    @property
    def compute_s(self) -> float:
        half = self.hlo_flops - self.hlo_flops_f32
        return (half / self.hw.peak_flops + self.hlo_flops_f32 / self.hw.f32_flops) / self.chips

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / (self.chips * self.hw.hbm_bw)

    @property
    def collective_s(self) -> float:
        # collective bytes are already per-device wire bytes
        return sum(self.collective_bytes.values()) / self.hw.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time: max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / max(self.hlo_flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS-based MFU at the roofline step time."""
        return self.model_flops / (self.chips * self.hw.peak_flops * max(self.step_time_s, 1e-12))

    def row(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "hlo_flops": self.hlo_flops,
            "hlo_flops_f32": self.hlo_flops_f32,
            "useful_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "bytes_per_device": self.peak_bytes_per_device,
        }


def model_flops_for(model, shape_kind: str, seq_len: int, global_batch: int) -> float:
    """MODEL_FLOPS = 6·N_active·tokens (train) or 2·N_active·tokens (fwd)."""
    n = model.num_active_params()
    if shape_kind == "train":
        return 6.0 * n * seq_len * global_batch
    if shape_kind == "prefill":
        return 2.0 * n * seq_len * global_batch
    # decode: one token per sequence
    return 2.0 * n * global_batch
