"""CG01 fire: host syncs in code captured into a CUDA graph: float() of a
tensor in a function the region calls, .item() and torch.cuda.synchronize()
in the region itself."""
import torch


def _scale(x: torch.Tensor) -> float:
    return float(x.abs().amax())


def capture_step(graph, x: torch.Tensor, out: torch.Tensor) -> None:
    with graph.capture():
        out.copy_(x / _scale(x))
        print(out.sum().item())
        torch.cuda.synchronize()
