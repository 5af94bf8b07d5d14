"""Batching / iteration utilities, deterministic from seeds.

Counterpart of ``repro.data.pipeline``: host-side numpy, the same draws, so
the streams are bitwise the reference's (one ``default_rng(seed)``
permutation per epoch, the tail that does not fill a batch dropped).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import numpy as np


def batch_iterator(
    x: np.ndarray, y: np.ndarray, batch_size: int, seed: int = 0, epochs: int | None = None
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Shuffled minibatch stream; loops forever when epochs is None."""
    rng = np.random.default_rng(seed)
    epoch = 0
    n = len(x)
    while epochs is None or epoch < epochs:
        perm = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            sel = perm[i : i + batch_size]
            yield x[sel], y[sel]
        epoch += 1


@dataclasses.dataclass
class FederatedDataset:
    """Per-agent shards + a deterministic per-agent batch stream."""

    shards: List[Tuple[np.ndarray, np.ndarray]]
    batch_size: int
    seed: int = 0

    def __post_init__(self):
        self._iters: Dict[int, Iterator] = {}

    def num_agents(self) -> int:
        return len(self.shards)

    def next_batch(self, agent: int) -> Tuple[np.ndarray, np.ndarray]:
        if agent not in self._iters:
            x, y = self.shards[agent]
            bs = min(self.batch_size, len(x))
            self._iters[agent] = batch_iterator(x, y, bs, seed=self.seed + agent)
        return next(self._iters[agent])
