"""Per-agent local optimisation (the paper's M.fit(d_i, SGD) line).

Counterpart of ``repro.fl.local_trainer``: the trainer takes and returns
FLAT numpy weight vectors and runs its SGD on ``device``. The batch
selection stream (``draw_indices``) is the reference's numpy stream exactly,
so both packages train on the same samples.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core.partition import flatten_params, unflatten_params
from repro_torch.device import resolve_device
from repro_torch.models import mlp_mnist


@dataclasses.dataclass
class LocalTrainer:
    agent_id: int
    x: np.ndarray
    y: np.ndarray
    lr: float = 0.1
    local_iters: int = 10
    batch_size: int = 128
    seed: int = 0
    device: torch.device | str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._layout = None
        self._rng = np.random.default_rng(self.seed + 1000 * (self.agent_id + 1))

    def layout(self):
        if self._layout is None:
            _, self._layout = flatten_params(mlp_mnist.init_params(0))
        return self._layout

    def draw_indices(self) -> np.ndarray:
        """Advance this agent's private RNG stream by one round's batch
        selection and return the rows of the shard it selects. The single
        source of truth for the per-round data order: the vectorized engine
        draws through this same method and gathers the rows from its
        device-resident copy of the shards, which is what keeps the two
        engines' SGD inputs identical."""
        bs = min(self.batch_size, len(self.x))
        return self._rng.choice(len(self.x), size=bs, replace=False)

    def draw_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        """One round's batch: the rows ``draw_indices`` selects."""
        sel = self.draw_indices()
        return self.x[sel], self.y[sel]

    def train_delta(self, w_flat: np.ndarray) -> np.ndarray:
        """Run local SGD from w_flat; return delta = w_before - w_after
        (the paper's convention: holders apply w <- w - eps*delta)."""
        xb, yb = self.draw_batch()
        W = torch.as_tensor(w_flat.astype(np.float32), device=self.device)[None]
        X = torch.as_tensor(xb, device=self.device)[None]
        Y = torch.as_tensor(yb, device=self.device)[None]
        new = mlp_mnist.sgd_steps_flat_batched(W, X, Y, self.lr, self.local_iters, self.layout())
        return w_flat - new[0].cpu().numpy()

    def evaluate(self, w_flat: np.ndarray, x, y) -> float:
        """Accuracy of w_flat on (x, y), numpy arrays or tensors on the
        trainer's device."""
        w = torch.as_tensor(w_flat.astype(np.float32), device=self.device)
        params = unflatten_params(w, self.layout())
        x = torch.as_tensor(x, device=self.device)
        y = torch.as_tensor(y, device=self.device)
        return float(mlp_mnist.evaluate(params, x, y))
