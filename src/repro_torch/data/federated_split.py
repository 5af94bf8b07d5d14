"""Federated dataset partitioning across agents.

The paper splits MNIST uniformly: '60000/|A| samples ... the probability of
one sample to belong to one class is the same for every agent' (IID). We also
provide the standard Dirichlet non-IID split for beyond-paper experiments.
Counterpart of ``repro.data.federated_split`` (bitwise equal shards).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def iid_split(
    x: np.ndarray, y: np.ndarray, num_agents: int, seed: int = 0
) -> List[Tuple[np.ndarray, np.ndarray]]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(x))
    shards = np.array_split(perm, num_agents)
    return [(x[s], y[s]) for s in shards]


def dirichlet_split(
    x: np.ndarray,
    y: np.ndarray,
    num_agents: int,
    alpha: float = 0.5,
    seed: int = 0,
    num_classes: int | None = None,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Non-IID: each class's samples distributed over agents ~ Dirichlet(alpha)."""
    rng = np.random.default_rng(seed)
    if num_classes is None:
        num_classes = int(y.max()) + 1
    idx_per_agent: List[List[int]] = [[] for _ in range(num_agents)]
    for c in range(num_classes):
        idx_c = np.where(y == c)[0]
        rng.shuffle(idx_c)
        props = rng.dirichlet([alpha] * num_agents)
        cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
        for a, chunk in enumerate(np.split(idx_c, cuts)):
            idx_per_agent[a].extend(chunk.tolist())
    out = []
    for a in range(num_agents):
        sel = np.array(sorted(idx_per_agent[a]), dtype=int)
        out.append((x[sel], y[sel]))
    return out
