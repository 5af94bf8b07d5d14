"""No-fire twin of the capture pack: captured code branches on shapes,
dtypes and host values only, branches on the device with torch.where, and
reads the host clock and values outside the capture region."""
import time

import torch


def step(x: torch.Tensor, out: torch.Tensor, scale: float, bias=None) -> None:
    if x.shape[0] > 1 and x.dtype == torch.float32 and scale > 0:
        out.copy_(torch.where(x > 0, x * scale, x))
    else:
        out.copy_(x)
    if bias is not None:
        out.add_(bias)
    n = int(x.numel())
    assert n == out.numel() and x.device == out.device


def run(graph, x, out):
    t0 = time.perf_counter()
    with graph.capture():
        step(x, out, 2.0)
    graph.replay()
    total = out.sum().item()
    return time.perf_counter() - t0, total
