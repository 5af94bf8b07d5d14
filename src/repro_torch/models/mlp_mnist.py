"""The paper's evaluation model: a 4-layer MLP, 785x500x100x10.

(785 = 784 pixels + bias, i.e. standard 784-in layers with biases.)
Counterpart of ``repro.models.mlp_mnist`` in PyTorch. ``init_params`` is the
same numpy draw, so the initial weights are bitwise equal; parameters
flatten deterministically (sorted dict order) for the IPLS partition plane.

Every function takes parameters with optional leading agent dimensions:
``w{i}`` of shape (..., fan_in, fan_out) and ``b{i}`` of shape (..., fan_out).
With an agent dimension A, the products run as batched matrix products
(``torch.matmul`` on 3-D operands is ``torch.bmm``), one per layer for all
agents at once.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.partition import unflatten_params

LAYERS = [(784, 500), (500, 100), (100, 10)]


def init_params(seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    params: Dict[str, np.ndarray] = {}
    for i, (fan_in, fan_out) in enumerate(LAYERS):
        bound = float(np.sqrt(6.0 / (fan_in + fan_out)))
        params[f"w{i}"] = rng.uniform(-bound, bound, size=(fan_in, fan_out)).astype(np.float32)
        params[f"b{i}"] = np.zeros((fan_out,), np.float32)
    return params


def params_from_numpy(params: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """Copy a parameter dict (numpy, or anything ``np.asarray`` reads, such
    as the reference's arrays) onto ``device`` as float32 tensors."""
    return {
        k: torch.tensor(np.asarray(v, np.float32), device=device)
        for k, v in params.items()
    }


def apply(params, x: torch.Tensor) -> torch.Tensor:
    """Logits (..., B, 10). ``x`` is (B, 784), shared by every agent, or
    (A, B, 784), one batch per agent."""
    h = x
    n = len(LAYERS)
    for i in range(n):
        h = torch.matmul(h, params[f"w{i}"]) + params[f"b{i}"].unsqueeze(-2)
        if i < n - 1:
            h = torch.relu(h)
    return h


def loss_and_acc(params, x: torch.Tensor, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean NLL and accuracy over the batch, one value per agent."""
    logits = apply(params, x)
    logp = torch.log_softmax(logits, dim=-1)
    yy = y.long().expand(logits.shape[:-1])
    nll = -torch.gather(logp, -1, yy.unsqueeze(-1)).squeeze(-1).mean(-1)
    acc = (torch.argmax(logits, dim=-1) == yy).float().mean(-1)
    return nll, acc


def sgd_steps_flat_batched(
    W: torch.Tensor,
    X: torch.Tensor,
    Y: torch.Tensor,
    lr: float,
    iters: int,
    layout: Sequence[Tuple[str, Tuple[int, ...]]],
) -> torch.Tensor:
    """``iters`` plain SGD steps for every agent at once on the flat weights.

    W (A, N) float32, X (A, B, 784), Y (A, B). The counterpart of
    ``jax.vmap(sgd_steps_flat)``: the layers are views of W, the loss is the
    sum over agents of each agent's mean NLL (so agent a's gradient is that
    of its own loss), and the gradients w.r.t. the views are concatenated
    back into the flat layout. Returns the new (A, N) weights."""
    for _ in range(iters):
        W = W.detach().requires_grad_(True)
        params = unflatten_params(W, layout)
        views = [params[name] for name, _ in layout]
        nll, _ = loss_and_acc(params, X, Y)
        grads = torch.autograd.grad(nll.sum(), views)
        g = torch.cat([gi.reshape(W.shape[0], -1) for gi in grads], dim=1)
        W = W.detach() - lr * g
    return W.detach()


def evaluate(params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Accuracy on (x, y), one value per agent."""
    with torch.no_grad():
        return loss_and_acc(params, x, y)[1]
