"""IPLS aggregation math (paper §2.2, UpdateModel).

Port of the reference's ``core/aggregation.py``. A responsible agent
receives, for its partition k, deltas from r contributing agents, and
applies

    w_k <- w_k - eps * mean_contrib(delta_k)
    eps <- alpha * eps + (1 - alpha) * (1 / r)

The reduction of the r deltas is the masked mean (FedAvg's), which makes
IPLS equal centralized FedAvg under perfect connectivity. Every function
is a pure function of tensors. ``(1 - alpha) / r`` divides tensors: a
Python number over a tensor is a reciprocal times it in PyTorch, which can
differ from the reference's quotient in the last bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.device import resolve_device


class EpsState(NamedTuple):
    """Per-partition staleness weight state."""

    eps: torch.Tensor  # scalar or per-partition vector
    alpha: torch.Tensor  # scalar smoothing in (0, 1)


def init_eps(alpha: float = 0.5, shape=(), device="cuda") -> EpsState:
    """eps = 1 of ``shape`` and the smoothing ``alpha``, on ``device``
    (CUDA by default; raises without one: pass ``device="cpu"``)."""
    device = resolve_device(device)
    return EpsState(
        eps=torch.ones(shape, dtype=torch.float32, device=device),
        alpha=torch.tensor(alpha, dtype=torch.float32, device=device),
    )


def update_eps(state: EpsState, r) -> EpsState:
    """eps <- alpha*eps + (1-alpha)*(1/r); r == 0 keeps eps unchanged."""
    r = torch.as_tensor(r, dtype=torch.float32, device=state.eps.device)
    safe_r = r.clamp_min(1.0)
    new = state.alpha * state.eps + (1.0 - state.alpha) / safe_r
    return EpsState(eps=torch.where(r > 0, new, state.eps), alpha=state.alpha)


def masked_mean(deltas: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``deltas`` (A, ...) over axis 0 counting only rows with
    mask (A,) == 1; 0 if nobody contributed."""
    mask = mask.to(deltas.dtype)
    r = mask.sum()
    total = torch.einsum("a,a...->...", mask, deltas)
    return torch.where(r > 0, total / r.clamp_min(1.0), torch.zeros_like(total))


def aggregate_partition(
    w_k: torch.Tensor,
    deltas: torch.Tensor,
    mask: torch.Tensor,
    eps_state: EpsState,
) -> "tuple[torch.Tensor, EpsState]":
    """One IPLS aggregation step for one partition: subtract the masked-mean
    delta scaled by eps, then update eps from the contributor count r."""
    r = mask.float().sum()
    agg = masked_mean(deltas, mask)
    return w_k - eps_state.eps * agg, update_eps(eps_state, r)


def replica_consensus(values: torch.Tensor, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Merge rho replica copies (rho, ...) of a partition into one value:
    the (weighted) mean, uniform by default."""
    if weights is None:
        return values.mean(dim=0)
    weights = weights / weights.sum().clamp_min(1e-12)
    return torch.einsum("r,r...->...", weights, values)


def apply_staleness_decay(delta: torch.Tensor, age_rounds: torch.Tensor, beta: float = 0.5):
    """Down-weight a late-arriving delta by beta**age."""
    base = torch.tensor(beta, dtype=delta.dtype, device=delta.device)
    return delta * torch.pow(base, torch.as_tensor(age_rounds, device=delta.device).to(delta.dtype))
