"""Deterministic synthetic datasets (an MNIST stand-in that needs no download).

``synth_mnist`` produces an MNIST-shaped 10-class problem: each class has a
prototype image built from smooth random blobs; samples are prototypes +
per-sample deformation + pixel noise, clipped to [0, 1]. It is learnable to
high accuracy by the paper's 784-500-100-10 MLP, hard enough that accuracy
climbs over tens of rounds (like Fig 2), and exactly reproducible from the
seed.

Counterpart of ``repro.data.synthetic`` (``synth_mnist``, ``synth_tokens``):
the same numpy draws, so the arrays are bitwise equal.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _class_prototypes(rng: np.random.Generator, num_classes: int, side: int = 28) -> np.ndarray:
    """Smooth blob prototypes, one per class."""
    protos = np.zeros((num_classes, side, side), np.float32)
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32)
    for c in range(num_classes):
        img = np.zeros((side, side), np.float32)
        for _ in range(4):  # a few gaussian strokes per class
            cx, cy = rng.uniform(4, side - 4, size=2)
            sx, sy = rng.uniform(2.0, 5.0, size=2)
            amp = rng.uniform(0.6, 1.0)
            img += amp * np.exp(-(((xx - cx) / sx) ** 2 + ((yy - cy) / sy) ** 2))
        protos[c] = img / max(img.max(), 1e-6)
    return protos


def synth_mnist(
    num_train: int = 60000,
    num_test: int = 10000,
    num_classes: int = 10,
    seed: int = 0,
    noise: float = 0.25,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (x_train, y_train, x_test, y_test); x flattened to 784."""
    rng = np.random.default_rng(seed)
    protos = _class_prototypes(rng, num_classes)
    side = protos.shape[-1]

    def make(n: int, rng: np.random.Generator):
        y = rng.integers(0, num_classes, size=n)
        x = protos[y].copy()
        # per-sample smooth deformation: random shift + scale
        shifts = rng.integers(-2, 3, size=(n, 2))
        for i in range(n):
            x[i] = np.roll(x[i], tuple(shifts[i]), axis=(0, 1))
        x *= rng.uniform(0.7, 1.3, size=(n, 1, 1)).astype(np.float32)
        x += noise * rng.standard_normal((n, side, side)).astype(np.float32)
        x = np.clip(x, 0.0, 1.0)
        return x.reshape(n, side * side).astype(np.float32), y.astype(np.int32)

    x_tr, y_tr = make(num_train, rng)
    x_te, y_te = make(num_test, rng)
    return x_tr, y_tr, x_te, y_te


def synth_tokens(
    num_sequences: int,
    seq_len: int,
    vocab: int,
    seed: int = 0,
) -> np.ndarray:
    """Markov-ish synthetic token stream for LM smoke training: next token is
    a noisy function of the previous one, so there is signal to learn.
    (num_sequences, seq_len) int32, bitwise ``repro.data.synth_tokens``."""
    rng = np.random.default_rng(seed)
    # sparse deterministic successor table + noise
    successor = rng.integers(0, vocab, size=vocab)
    toks = np.empty((num_sequences, seq_len), np.int32)
    cur = rng.integers(0, vocab, size=num_sequences)
    for t in range(seq_len):
        toks[:, t] = cur
        noise = rng.random(num_sequences) < 0.2
        cur = np.where(noise, rng.integers(0, vocab, size=num_sequences), successor[cur])
    return toks
