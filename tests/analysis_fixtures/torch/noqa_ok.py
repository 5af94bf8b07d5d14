"""Suppression fixture (Python): each violation carries a reasoned noqa —
the file must analyze clean, proving same-line and preceding-comment
placement."""
import torch


def _peek(x: torch.Tensor) -> float:
    # repro: noqa[CG01] fixture: demonstrates preceding-comment suppression
    return float(x.sum())


def body(graph, x: torch.Tensor, out: torch.Tensor) -> None:
    with graph.capture():
        out.copy_(x * _peek(x))
        if x.max() > 0:  # repro: noqa[CG03] fixture: demonstrates same-line suppression
            out.neg_()
