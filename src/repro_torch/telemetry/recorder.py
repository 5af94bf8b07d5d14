"""MetricsRecorder: one structured per-round metric stream for every engine.

Counterpart of ``repro.telemetry.recorder``: the same taps, rows and bytes.
Two feeding styles, one schema (``telemetry.schema.TELEMETRY_SCHEMA``):

  * the scalar pubsub taps ``on_send`` / ``on_fate`` / ``on_delivery`` /
    ``on_offline_drop`` per message (the recorder maps topic + tick counter
    onto the channel exactly like ``MessageFates.pubsub_fate`` maps fates);
  * the batched engine's control plane calls ``on_channel`` /
    ``on_offline_drops`` / ``on_delays`` / ``on_delivered`` with whole
    channel batches per round.

Both end with ONE ``finish_round(...)`` call per round per engine, which
folds the accumulated traffic with the round's state metrics into an
ordered row. Traffic is keyed by round, so a window's control plane may
tap all its rounds before the first of them finishes. Rows and their JSONL
serialization are byte for byte identical across the port's engines under
identical configs (tests/test_torch_telemetry_engines.py).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.api import (
    FETCH_TOPIC,
    REPLICA_TOPIC,
    REPLY_TOPIC,
    UPDATE_TOPIC,
)
from repro_torch.telemetry.schema import CHANNELS, ROW_KEYS, SCHEMA_VERSION
from repro_torch.telemetry.timing import PhaseTimer
from repro_torch.telemetry.trace import TraceWriter


class MetricsRecorder:
    def __init__(
        self,
        *,
        ticks_per_round: int,
        max_delay_ticks: int,
        trace: Optional[TraceWriter] = None,
    ):
        self.rows: List[dict] = []
        self.trace = trace
        self.timer = PhaseTimer(trace=trace)
        self._ticks = int(ticks_per_round)
        self._bins = int(max_delay_ticks) + 1
        self._acc: Dict[int, dict] = {}  # round -> in-progress traffic row

    # -- traffic accumulator -------------------------------------------------
    def _blank(self) -> dict:
        d: dict = {}
        for ch in CHANNELS:
            d[f"msgs_{ch}"] = 0
            d[f"bytes_{ch}"] = 0
            d[f"drops_{ch}"] = 0
        d["drops_offline"] = 0
        d["delay_hist"] = [0] * self._bins
        return d

    def _traffic(self, rnd: int) -> dict:
        tr = self._acc.get(rnd)
        if tr is None:
            tr = self._acc[rnd] = self._blank()
        return tr

    def _channel(self, topic: str, counter: int) -> str:
        """Topic + tick phase -> channel name; the same mapping
        ``MessageFates.pubsub_fate`` uses for fate keys."""
        if topic == UPDATE_TOPIC:
            return "update"
        if topic == FETCH_TOPIC:
            return "fetch"
        if topic == REPLY_TOPIC:
            return "fetch_reply" if counter % self._ticks == 1 else "update_reply"
        if topic.startswith(REPLICA_TOPIC):
            return "replica"
        return "member"

    # -- scalar pubsub taps (one call per message) ---------------------------
    def on_send(self, topic: str, counter: int, sender: int, nbytes: int) -> None:
        ch = self._channel(topic, counter)
        tr = self._traffic(counter // self._ticks)
        tr[f"msgs_{ch}"] += 1
        tr[f"bytes_{ch}"] += int(nbytes)
        if self.trace is not None:
            self.trace.instant(f"send {ch}", counter, sender, {"bytes": int(nbytes)})

    def on_fate(
        self,
        topic: str,
        counter: int,
        sender: int,
        recipient: int,
        delivered: bool,
        delay: int,
    ) -> None:
        ch = self._channel(topic, counter)
        tr = self._traffic(counter // self._ticks)
        if delivered:
            tr["delay_hist"][int(delay)] += 1
        else:
            tr[f"drops_{ch}"] += 1
            if self.trace is not None:
                self.trace.instant(f"drop {ch}", counter, recipient)

    def on_delivery(
        self,
        topic: str,
        sent_counter: int,
        counter: int,
        sender: int,
        recipient: int,
        nbytes: int,
    ) -> None:
        # trace-only: channel named by the SEND tick (delayed replies keep
        # their phase), timestamped at the delivery tick
        if self.trace is not None:
            ch = self._channel(topic, sent_counter)
            self.trace.instant(
                f"recv {ch}", counter, recipient, {"from": int(sender)}
            )

    def on_offline_drop(self, counter: int) -> None:
        self._traffic(counter // self._ticks)["drops_offline"] += 1

    # -- batched control-plane feeds (one call per channel batch) ------------
    def on_offline_drops(self, rnd: int, count: int) -> None:
        """Batch form of on_offline_drop keyed by round: the batched control
        plane accounts a channel's offline-endpoint drops in one call per
        round rather than per message."""
        if count:
            self._traffic(rnd)["drops_offline"] += int(count)

    def on_channel(
        self, rnd: int, channel: str, msgs: int, nbytes: int, drops: int
    ) -> None:
        tr = self._traffic(rnd)
        tr[f"msgs_{channel}"] += int(msgs)
        tr[f"bytes_{channel}"] += int(nbytes)
        tr[f"drops_{channel}"] += int(drops)

    def on_delays(self, rnd: int, delays) -> None:
        """Fold an array of delivered-message delays (ticks) into the
        round's histogram."""
        delays = np.asarray(delays)
        if delays.size == 0:
            return
        hist = self._traffic(rnd)["delay_hist"]
        for d, n in zip(*np.unique(delays, return_counts=True)):
            hist[int(d)] += int(n)

    def on_delivered(self, rnd: int, delay: int, count: int) -> None:
        if count:
            self._traffic(rnd)["delay_hist"][int(delay)] += int(count)

    # -- the one emission site per engine ------------------------------------
    def finish_round(
        self,
        *,
        round: int,
        active: int,
        contrib,
        eps,
        delta_normsq: float,
        value_normsq: float,
        accs,
        bytes_total: int,
        msgs_total: int,
        drops_total: int,
    ) -> None:
        tr = self._acc.pop(round, None)
        if tr is None:
            tr = self._blank()
        accs32 = np.asarray(accs, np.float32)
        a64 = accs32.astype(np.float64)
        row = {
            "round": int(round),
            "active": int(active),
            **tr,
            "contrib": [int(x) for x in contrib],
            "eps": [float(x) for x in eps],
            "delta_normsq": float(delta_normsq),
            "value_normsq": float(value_normsq),
            "accs": [float(x) for x in accs32],
            "acc_mean": float(a64.mean()),
            "acc_std": float(a64.std()),
            "acc_max": float(a64.max()),
            "bytes_total": int(bytes_total),
            "msgs_total": int(msgs_total),
            "drops_total": int(drops_total),
        }
        assert tuple(row) == ROW_KEYS  # schema drift is a bug, not data
        self.rows.append(row)

    # -- serialization --------------------------------------------------------
    def jsonl_lines(self, meta: Optional[dict] = None) -> List[str]:
        """Line 1: stream header (schema version + caller metadata); then
        one compact-JSON row per round. Identical rows serialize to
        identical bytes (insertion order is schema order)."""
        head = {"schema_version": SCHEMA_VERSION, "meta": meta or {}}
        lines = [json.dumps(head, separators=(",", ":"))]
        lines += [json.dumps(r, separators=(",", ":")) for r in self.rows]
        return lines

    def write_jsonl(self, path: str, meta: Optional[dict] = None) -> None:
        with open(path, "w") as f:
            f.write("\n".join(self.jsonl_lines(meta)) + "\n")
