"""KW01 fire: a wrapper whose launch sits in a try that falls back to the
plain version when the kernel cannot be built or launched."""
import torch

from repro_torch.kernels._build import build_library, count_launch, launch, plain
from repro_torch.kernels.quantize import ref


def build():
    return build_library(None)


def dequantize(q, scales):
    if q.device.type == "cpu":
        return plain("dequantize", ref.dequantize, q, scales)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    try:
        launch("dequantize", build().dequantize_int8_f32, out.data_ptr(), q.data_ptr(),
               scales.data_ptr(), q.shape[0], device=q.device)
    except RuntimeError:
        return ref.dequantize(q.cpu(), scales.cpu()).to(q.device)  # the fallback
    count_launch(dequantize)
    return out


dequantize.LAUNCHES = 0
