"""Centralized FL (FedAvg) baseline — the paper's comparison target (Fig 2).

A server holds W; every round each agent computes its local delta from the
same W; the server applies the mean delta. Identical local-trainer settings
to the IPLS simulation so the comparison isolates decentralisation itself.

Counterpart of ``repro.fl.centralized``, batched on the device: every agent
starts a round from the one W, so all A agents' local SGD is one batched
call on W repeated to (A, N), on the batches each agent's ``LocalTrainer``
draws (``TrainingRows``). The mean delta is reduced as numpy reduces it
(``mean_rows``), so with the same deltas the update is bit for bit the
reference's.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.partition import flatten_params, unflatten_params
from repro_torch.device import resolve_device
from repro_torch.fl.local_trainer import LocalTrainer, TrainingRows
from repro_torch.models import mlp_mnist


def mean_rows(rows: Sequence[torch.Tensor]) -> torch.Tensor:
    """``np.mean(rows, axis=0)`` in float32, bit for bit: numpy adds the rows
    one after another, in order, to its identity +0 (so an all -0 column
    gives +0), then divides once by their count. The divisor is a filled
    tensor: PyTorch on CUDA multiplies by the reciprocal of a Python-number
    divisor, which can be an ulp off a true divide."""
    acc = rows[0] + 0.0
    for r in rows[1:]:
        acc += r
    return acc / torch.full_like(acc, float(len(rows)))


def make_trainers(shards, lr, local_iters, batch_size, seed, device) -> List[LocalTrainer]:
    """One LocalTrainer per shard, as the reference's baselines build them
    (each owns agent ``a``'s batch stream)."""
    return [
        LocalTrainer(a, x, y, lr, local_iters, batch_size, seed, device=device)
        for a, (x, y) in enumerate(shards)
    ]


def _centralized_rounds(
    shards, x_test, y_test, rounds, lr, local_iters, batch_size, seed, device
) -> Iterator[Tuple[dict, torch.Tensor]]:
    """``run_centralized``'s rounds one by one: each round's history entry
    and the server's (N,) weights after it."""
    dev = resolve_device(device)
    w_np, layout = flatten_params(mlp_mnist.init_params(seed))
    w = torch.as_tensor(w_np, device=dev)
    trainers = make_trainers(shards, lr, local_iters, batch_size, seed, dev)
    rows = TrainingRows(trainers, dev)
    x_te = torch.as_tensor(x_test, device=dev)
    y_te = torch.as_tensor(y_test, device=dev)
    A = len(shards)
    for rnd in range(rounds):
        W = w.repeat(A, 1)
        # each agent's delta as train_delta computes it: w_before - w_after
        deltas = W - rows.sgd(W, *rows.gather(rows.draw_indices()), lr, local_iters, layout)
        w = w - mean_rows(deltas.unbind(0))
        acc = float(mlp_mnist.evaluate(unflatten_params(w, layout), x_te, y_te))
        yield {
            "round": rnd,
            "acc_mean": acc,
            "acc_std": 0.0,
            "acc_max": acc,
            # server traffic: every agent uploads + downloads the full model
            "bytes_total": int((rnd + 1) * 2 * A * w.element_size() * w.numel()),
        }, w


def run_centralized(
    shards: List[Tuple[np.ndarray, np.ndarray]],
    x_test: np.ndarray,
    y_test: np.ndarray,
    rounds: int = 40,
    lr: float = 0.1,
    local_iters: int = 10,
    batch_size: int = 128,
    seed: int = 0,
    device="cuda",
) -> List[dict]:
    """FedAvg over ``shards`` for ``rounds`` rounds on ``device``; one history
    dict a round (round, acc_mean, acc_std, acc_max, bytes_total)."""
    return [
        h for h, _ in _centralized_rounds(
            shards, x_test, y_test, rounds, lr, local_iters, batch_size, seed, device
        )
    ]
