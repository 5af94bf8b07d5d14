"""CG03 fire: Python branches on tensors in captured code — an if on a
norm, an assert on a sum and a conditional expression on a max: the graph
keeps whichever branch the capture took."""
import torch


def clip(x: torch.Tensor, limit: float) -> torch.Tensor:
    norm = torch.linalg.vector_norm(x)
    if norm > limit:
        x = x * (limit / norm)
    assert x.sum() != 0
    return x if x.max() > 0 else -x


def capture_clip(graph, x, out):
    with graph.capture():
        out.copy_(clip(x, 1.0))
