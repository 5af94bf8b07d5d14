"""KW04 fire: a wrapper whose CPU branch calls its plain version directly,
so plain_hooks (the roofline's counting) never see the call."""
import torch

from repro_torch.kernels._build import build_library, count_launch, launch
from repro_torch.kernels.quantize import ref


def build():
    return build_library(None)


def dequantize(q, scales):
    if q.device.type == "cpu":
        return ref.dequantize(q, scales)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    launch("dequantize", build().dequantize_int8_f32, out.data_ptr(), q.data_ptr(),
           scales.data_ptr(), q.shape[0], device=q.device)
    count_launch(dequantize)
    return out


dequantize.LAUNCHES = 0
