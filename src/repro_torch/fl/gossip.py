"""Segmented-gossip baseline (Hu et al., arXiv:1908.07782) — the related-work
comparison in paper §4.

Every agent keeps a full local model. Each round: local SGD, then pull each
*segment* (partition) from ``fanout`` random peers and average. Unlike IPLS
there is no responsibility/ownership: every agent stores the whole model and
per-segment traffic grows with the fanout.

Counterpart of ``repro.fl.gossip``, batched on the device: the A models are
one (A, N) float32 tensor, local SGD is one batched call, and the pull is,
per partition, a row gather of the (A, size_k) slice for each peer slot and
then self, so a round launches O(K * fanout) pulls, not O(A * K). The peer
draws are the reference's numpy stream, drawn up front as one (A, K, F)
array a round; the arithmetic is the reference's float32 arithmetic, in its
order.
"""
from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np
import torch

from repro_torch.core.partition import PartitionSpec, flatten_params, unflatten_params
from repro_torch.device import resolve_device
from repro_torch.fl.centralized import make_trainers, mean_rows
from repro_torch.fl.local_trainer import TrainingRows
from repro_torch.models import mlp_mnist
from repro_torch.telemetry import NULL_TIMER
from repro_torch.telemetry.timing import device_phase

# models evaluated at once: the first hidden layer of a chunk is
# (EVAL_CHUNK, test rows, 500) float32, 0.5 GB at 10,000 test rows
EVAL_CHUNK = 25


def draw_peers(rng: np.random.Generator, n: int, num_partitions: int, fanout: int) -> np.ndarray:
    """One round's peers, (n, K, F) with F = min(fanout, n - 1): for each
    agent and then each partition, the reference's draw of distinct peers
    other than the agent, in draw order."""
    F = min(fanout, n - 1)
    peers = np.empty((n, num_partitions, F), np.int64)
    for a in range(n):
        for k in range(num_partitions):
            peers[a, k] = rng.choice([p for p in range(n) if p != a], size=F, replace=False)
    return peers


def pull_segments(models: torch.Tensor, peers: torch.Tensor, spec: PartitionSpec) -> torch.Tensor:
    """Every agent's model after the segment pull: segment k of row a is the
    mean of the pre-pull segments of ``peers[a, k]`` (in order) and of a's
    own, as ``np.mean`` reduces them."""
    out = torch.empty_like(models)
    for k, (lo, size) in enumerate(zip(spec.offsets(), spec.sizes)):
        seg = models[:, lo : lo + size]
        out[:, lo : lo + size] = mean_rows(
            [seg[peers[:, k, f]] for f in range(peers.shape[2])] + [seg]
        )
    return out


def evaluate_rows(models: torch.Tensor, layout, x_te, y_te) -> np.ndarray:
    """Test accuracy of each row of the (A, N) ``models``, as float64."""
    accs = [
        mlp_mnist.evaluate(unflatten_params(models[lo : lo + EVAL_CHUNK], layout), x_te, y_te)
        for lo in range(0, models.shape[0], EVAL_CHUNK)
    ]
    return torch.cat(accs).cpu().numpy().astype(np.float64)


def _gossip_rounds(
    shards, x_test, y_test, rounds, fanout, num_partitions, lr, local_iters, batch_size,
    seed, device, timer=NULL_TIMER,
) -> Iterator[Tuple[dict, torch.Tensor]]:
    """``run_gossip``'s rounds one by one: each round's history entry and
    the (A, N) models after it. ``timer`` (a telemetry.PhaseTimer) times the
    phases draws (host), sgd, pull and eval."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = len(shards)
    w0, layout = flatten_params(mlp_mnist.init_params(seed))
    spec = PartitionSpec.even(w0.size, num_partitions)
    rows = TrainingRows(make_trainers(shards, lr, local_iters, batch_size, seed, dev), dev)
    models = torch.as_tensor(w0, device=dev).repeat(n, 1)
    x_te = torch.as_tensor(x_test, device=dev)
    y_te = torch.as_tensor(y_test, device=dev)
    total_bytes = 0
    for rnd in range(rounds):
        with device_phase(timer, "draws", dev):
            peers = draw_peers(rng, n, spec.num_partitions, fanout)
            batch_idx = rows.draw_indices()
        with device_phase(timer, "sgd", dev):
            new = rows.sgd(models, *rows.gather(batch_idx), lr, local_iters, layout)
            # the reference's models[a] - delta, delta = models[a] - new
            models = models - (models - new)
            del new
        with device_phase(timer, "pull", dev):
            models = pull_segments(models, torch.as_tensor(peers, device=dev), spec)
        # each peer ships its own copy of each segment
        total_bytes += sum(
            models.element_size() * size * peers.shape[2] for size in spec.sizes
        ) * n
        with device_phase(timer, "eval", dev):
            accs = evaluate_rows(models, layout, x_te, y_te)
        yield {
            "round": rnd,
            "acc_mean": float(accs.mean()),
            "acc_std": float(accs.std()),
            "acc_max": float(accs.max()),
            "bytes_total": total_bytes,
        }, models


def run_gossip(
    shards: List[Tuple[np.ndarray, np.ndarray]],
    x_test: np.ndarray,
    y_test: np.ndarray,
    rounds: int = 40,
    fanout: int = 2,
    num_partitions: int = 10,
    lr: float = 0.1,
    local_iters: int = 10,
    batch_size: int = 128,
    seed: int = 0,
    device="cuda",
) -> List[dict]:
    """Segmented gossip over ``shards`` for ``rounds`` rounds on ``device``;
    one history dict a round (round, acc_mean/std/max over the agents,
    bytes_total)."""
    return [
        h for h, _ in _gossip_rounds(
            shards, x_test, y_test, rounds, fanout, num_partitions, lr, local_iters,
            batch_size, seed, device,
        )
    ]
