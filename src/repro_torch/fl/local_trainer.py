"""Per-agent local optimisation (the paper's M.fit(d_i, SGD) line).

Counterpart of ``repro.fl.local_trainer``: the trainer takes and returns
FLAT numpy weight vectors and runs its SGD on ``device``. The batch
selection stream (``draw_indices``) is the reference's numpy stream exactly,
so both packages train on the same samples. ``TrainingRows`` trains many
trainers as one batch on the device (the batched engine, the baselines).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

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


class TrainingRows:
    """Trainers whose local SGD runs as one batch on the device: row ``a`` of
    an (A, N) weight matrix trains on trainer ``a``'s batches.

    Batch rows are drawn through each trainer's ``draw_indices`` in row
    order (the reference's per-agent numpy streams, so the SGD inputs are
    those of a per-agent loop) and gathered from the shards, copied to the
    device once and concatenated. Trainers of equal batch size form a
    bucket (``iid_split``'s shard sizes differ by at most one, so there are
    at most two, contiguous), one batched SGD call each."""

    def __init__(self, trainers: Sequence[LocalTrainer], device):
        self.trainers = list(trainers)
        bs = [min(tr.batch_size, len(tr.x)) for tr in self.trainers]
        self.buckets: List[Tuple[int, int]] = []
        start = 0
        for a in range(1, len(bs) + 1):
            if a == len(bs) or bs[a] != bs[start]:
                self.buckets.append((start, a))
                start = a
        self.x_all = torch.as_tensor(np.concatenate([tr.x for tr in self.trainers]), device=device)
        self.y_all = torch.as_tensor(np.concatenate([tr.y for tr in self.trainers]), device=device)
        self._off = np.cumsum([0] + [len(tr.x) for tr in self.trainers[:-1]])

    def draw_indices(self) -> List[np.ndarray]:
        """One round's batch rows into the concatenated shards: one (A_b,
        bs_b) array per bucket, every trainer's stream advanced once."""
        rows = [tr.draw_indices() + off for tr, off in zip(self.trainers, self._off)]
        return [np.stack(rows[lo:hi]) for lo, hi in self.buckets]

    def gather(self, idx) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """The stacked batches per bucket at ``draw_indices``' rows (host
        arrays or device tensors), gathered on the device."""
        return [self.x_all[i] for i in idx], [self.y_all[i] for i in idx]

    def sgd(self, W, Xs, Ys, lr: float, iters: int, layout) -> torch.Tensor:
        """Every row's local SGD from the (A, N) weights ``W``; returns the
        new (A, N) weights."""
        parts = [
            mlp_mnist.sgd_steps_flat_batched(W[lo:hi], Xs[b], Ys[b], lr, iters, layout)
            for b, (lo, hi) in enumerate(self.buckets)
        ]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
