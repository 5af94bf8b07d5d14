"""In-process IPFS substitute: content-addressed store + pub/sub topics.

Counterpart of ``repro.p2p.ipfs_sim``: the same store, topics, per-message
loss/delay, traffic counters and telemetry taps, message for message.
Delivery is pulled by the simulation calling ``tick()``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.p2p.network import PERFECT, NetworkConditions


class ContentStore:
    """Content-addressed storage: CID = sha256 of the payload bytes."""

    def __init__(self) -> None:
        self._blobs: Dict[str, bytes] = {}

    def add(self, data: bytes) -> str:
        cid = hashlib.sha256(data).hexdigest()
        self._blobs[cid] = data
        return cid

    def cat(self, cid: str) -> bytes:
        if cid not in self._blobs:
            raise KeyError(f"unknown CID {cid[:12]}…")
        return self._blobs[cid]

    def has(self, cid: str) -> bool:
        return cid in self._blobs

    def __len__(self) -> int:
        return len(self._blobs)


@dataclasses.dataclass
class Message:
    topic: str
    sender: int
    payload: Any
    sent_round: int
    deliver_round: int
    nbytes: int
    # every in-flight message is addressed to exactly one recipient: loss and
    # delay are sampled per subscriber at publish time
    recipient: int = -1


class PubSub:
    """Topic-based pub/sub with per-message loss/delay and traffic metering."""

    def __init__(self, conditions: NetworkConditions = PERFECT, seed: int = 0):
        self.conditions = conditions
        self.rng = np.random.default_rng(seed)
        self._subs: Dict[str, List[int]] = defaultdict(list)
        self._inflight: List[Message] = []
        self._inbox: Dict[int, List[Message]] = defaultdict(list)
        self.round = 0
        self.bytes_sent: Dict[int, int] = defaultdict(int)
        self.bytes_recv: Dict[int, int] = defaultdict(int)
        self.messages_sent = 0
        self.messages_dropped = 0
        self._offline: set[int] = set()
        # optional keyed fate source: (topic, sender, recipient, payload,
        # round) -> (delivered, delay); None = the sequential Generator stream
        self.fate_source: Optional[
            Callable[[str, int, int, Any, int], Tuple[bool, int]]
        ] = None
        # optional MetricsRecorder tap (repro_torch.telemetry). None = every
        # tap site is a single check; the counters above stay authoritative
        self.telemetry = None

    def _fate(self, topic: str, sender: int, recipient: int, payload: Any) -> Tuple[bool, int]:
        if self.fate_source is not None:
            return self.fate_source(topic, sender, recipient, payload, self.round)
        return self.conditions.sample(self.rng)

    # -- membership of the transport --------------------------------------
    def subscribe(self, topic: str, agent: int) -> None:
        if agent not in self._subs[topic]:
            self._subs[topic].append(agent)

    def unsubscribe(self, topic: str, agent: int) -> None:
        if agent in self._subs[topic]:
            self._subs[topic].remove(agent)

    def set_offline(self, agent: int, offline: bool) -> None:
        if offline:
            self._offline.add(agent)
        else:
            self._offline.discard(agent)

    def is_offline(self, agent: int) -> bool:
        return agent in self._offline

    # -- data plane --------------------------------------------------------
    def publish(self, topic: str, sender: int, payload: Any, nbytes: int) -> None:
        tel = self.telemetry
        if sender in self._offline:
            self.messages_dropped += 1
            if tel is not None:
                tel.on_offline_drop(self.round)
            return
        self.messages_sent += 1
        self.bytes_sent[sender] += nbytes
        if tel is not None:
            tel.on_send(topic, self.round, sender, nbytes)
        for agent in self._subs[topic]:
            if agent == sender:
                continue
            delivered, delay = self._fate(topic, sender, agent, payload)
            if not delivered:
                self.messages_dropped += 1
                if tel is not None:
                    tel.on_fate(topic, self.round, sender, agent, False, delay)
                continue
            if agent in self._offline:
                self.messages_dropped += 1
                if tel is not None:
                    tel.on_offline_drop(self.round)
                continue
            if tel is not None:
                tel.on_fate(topic, self.round, sender, agent, True, delay)
            self._inflight.append(
                Message(topic, sender, payload, self.round, self.round + delay, nbytes, agent)
            )

    def send(self, topic: str, sender: int, recipient: int, payload: Any, nbytes: int) -> None:
        """Directed message (UpdateModel request/reply); same loss/delay model."""
        tel = self.telemetry
        if sender in self._offline:
            self.messages_dropped += 1
            if tel is not None:
                tel.on_offline_drop(self.round)
            return
        self.messages_sent += 1
        self.bytes_sent[sender] += nbytes
        if tel is not None:
            tel.on_send(topic, self.round, sender, nbytes)
        delivered, delay = self._fate(topic, sender, recipient, payload)
        if not delivered:
            self.messages_dropped += 1
            if tel is not None:
                tel.on_fate(topic, self.round, sender, recipient, False, delay)
            return
        if recipient in self._offline:
            self.messages_dropped += 1
            if tel is not None:
                tel.on_offline_drop(self.round)
            return
        if tel is not None:
            tel.on_fate(topic, self.round, sender, recipient, True, delay)
        self._inflight.append(
            Message(topic, sender, payload, self.round, self.round + delay, nbytes, recipient)
        )

    def tick(self) -> None:
        """Advance one tick: deliver everything due now."""
        tel = self.telemetry
        still: List[Message] = []
        for msg in self._inflight:
            if msg.deliver_round > self.round:
                still.append(msg)
                continue
            agent = msg.recipient
            if agent in self._offline:
                self.messages_dropped += 1
                if tel is not None:
                    tel.on_offline_drop(self.round)
                continue
            self._inbox[agent].append(msg)
            self.bytes_recv[agent] += msg.nbytes
            if tel is not None:
                tel.on_delivery(
                    msg.topic, msg.sent_round, self.round, msg.sender, agent, msg.nbytes
                )
        self._inflight = still
        self.round += 1

    def drain(self, agent: int, topic_prefix: str = "") -> List[Message]:
        box = self._inbox[agent]
        if not topic_prefix:
            out, self._inbox[agent] = box, []
            return out
        out = [m for m in box if m.topic.startswith(topic_prefix)]
        self._inbox[agent] = [m for m in box if not m.topic.startswith(topic_prefix)]
        return out

    def total_bytes(self) -> int:
        return sum(self.bytes_sent.values())


class SimIPFS:
    """The bundle an IPLS agent sees: one shared store + one shared pubsub."""

    def __init__(self, conditions: NetworkConditions = PERFECT, seed: int = 0):
        self.store = ContentStore()
        self.pubsub = PubSub(conditions, seed)

    def tick(self) -> None:
        self.pubsub.tick()
