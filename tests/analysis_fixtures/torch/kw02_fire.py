"""KW02 fire: one wrapper launches without counting, another counts in a
counter that is never set to 0."""
import torch

from repro_torch.kernels._build import build_library, count_launch, launch, plain
from repro_torch.kernels.quantize import ref


def build():
    return build_library(None)


def dequantize(q, scales):
    if q.device.type == "cpu":
        return plain("dequantize", ref.dequantize, q, scales)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    launch("dequantize", build().dequantize_int8_f32, out.data_ptr(), q.data_ptr(),
           scales.data_ptr(), q.shape[0], device=q.device)
    return out


def quantize(x, err):
    if x.device.type == "cpu":
        return plain("quantize", ref.quantize, x, err)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    launch("quantize", build().quantize_f32_int8, q.data_ptr(), x.data_ptr(), err.data_ptr(),
           x.shape[0], device=x.device)
    count_launch(quantize, "FAST_LAUNCHES")
    return q


quantize.LAUNCHES = 0
