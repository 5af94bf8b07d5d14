"""Seeded network-condition models for the IPFS substrate simulation.

Counterpart of ``repro.p2p.network`` (numpy, bit for bit): per-message loss
with prob ``loss_prob`` and a capped geometric delay in ticks.

Two sampling modes:

  * ``sample(rng)``        — sequential per-message draws from a shared
    Generator (order-dependent);
  * ``sample_stream(...)`` — counter-based draws keyed by integer message
    coordinates (channel, round, sender, partition, peer): each message's
    fate is a pure hash of its key, so the scalar pubsub and a batched
    engine read the same values in any order;
  * ``sample_stream_window(...)`` — the same draws for a window of rounds
    at once.
"""
from __future__ import annotations

import dataclasses

import numpy as np

_U64 = np.uint64
_GOLDEN = _U64(0x9E3779B97F4A7C15)
_MIX = _U64(0xD1B54A32D192ED03)
_INV_2_53 = float(2.0**-53)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer on uint64 arrays (wraparound arithmetic)."""
    z = (x + _GOLDEN).astype(_U64)
    z = (z ^ (z >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> _U64(27))) * _U64(0x94D049BB133111EB)
    return z ^ (z >> _U64(31))


def hash_uniform(*components) -> np.ndarray:
    """Broadcast integer components to a common shape and hash them into
    float64 uniforms in [0, 1). Pure function of the components."""
    with np.errstate(over="ignore"):  # uint64 wraparound is the point
        arrs = np.broadcast_arrays(*[np.asarray(c, np.uint64) for c in components])
        h = np.zeros(arrs[0].shape, _U64)
        for a in arrs:
            h = _splitmix64(h ^ (a * _MIX))
        return (h >> _U64(11)).astype(np.float64) * _INV_2_53


@dataclasses.dataclass(frozen=True)
class NetworkConditions:
    loss_prob: float = 0.0
    delay_prob: float = 0.0
    max_delay_rounds: int = 2

    def sample(self, rng: np.random.Generator) -> tuple[bool, int]:
        """Returns (delivered, delay_rounds) for one message."""
        if self.loss_prob > 0 and rng.random() < self.loss_prob:
            return False, 0
        delay = 0
        if self.delay_prob > 0:
            while delay < self.max_delay_rounds and rng.random() < self.delay_prob:
                delay += 1
        return True, delay

    def sample_stream(self, seed: int, *key) -> tuple[np.ndarray, np.ndarray]:
        """Batched counter-based fates: ``key`` components are integers or
        integer arrays (broadcast together); returns (delivered, delay)
        arrays of the broadcast shape. The last hash component is a draw
        slot: 0 decides loss, 1..max_delay_rounds decide the capped
        geometric delay."""
        u_loss = hash_uniform(seed, *key, 0)
        delivered = (
            u_loss >= self.loss_prob if self.loss_prob > 0
            else np.ones(u_loss.shape, bool)
        )
        delay = np.zeros(u_loss.shape, np.int64)
        if self.delay_prob > 0:
            for slot in range(1, self.max_delay_rounds + 1):
                u = hash_uniform(seed, *key, slot)
                # capped geometric: delay += 1 while every earlier draw hit
                delay += np.where((u < self.delay_prob) & (delay == slot - 1), 1, 0)
        delay = np.where(delivered, delay, 0)
        return delivered, delay

    def sample_stream_window(
        self, seed: int, channel: int, rounds, *key
    ) -> tuple[np.ndarray, np.ndarray]:
        """Windowed batch draw: a whole window of rounds' fates as
        ``(W, *broadcast(key))`` arrays. ``rounds`` is a 1-D array of round
        indices; the other key components broadcast as in ``sample_stream``.
        Fates are pure hashes of their coordinates, so row ``w`` equals
        ``sample_stream(seed, channel, rounds[w], *key)`` exactly."""
        rounds = np.asarray(rounds, np.int64)
        if key:
            b = np.broadcast(*[np.asarray(c) for c in key])
            rounds = rounds.reshape(rounds.shape + (1,) * b.ndim)
        return self.sample_stream(seed, channel, rounds, *key)


PERFECT = NetworkConditions()
# "imperfect connectivity" setting used in the paper-matching experiments
LOSSY = NetworkConditions(loss_prob=0.15, delay_prob=0.25, max_delay_rounds=2)
