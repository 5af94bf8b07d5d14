"""The shared per-round metric schema: the single source of truth.

Counterpart of ``repro.telemetry.schema``, key for key and in the same
order, so a stream written by either package loads in the other's report.
Every engine (the scalar pubsub engine, the batched engine one round at a
time and in windows) emits exactly these keys per round, in this order,
with values that agree byte for byte across the port's engines under
identical configs (tests/test_torch_telemetry_engines.py).

Traffic keys are accumulated by the recorder's taps (the scalar pubsub
calls them per message, the batched control plane per channel batch); the
remaining keys arrive through one ``finish_round`` call per round. The
derived keys (``acc_mean``/``acc_std``/``acc_max``) are computed by the
recorder from ``accs``, so every engine shares one float path.
"""
from __future__ import annotations

from typing import Dict, Tuple

SCHEMA_VERSION = 1

# message channels, in fate-stream order (fl/rounds.py CH_* constants)
CHANNELS: Tuple[str, ...] = (
    "fetch",
    "fetch_reply",
    "update",
    "update_reply",
    "replica",
    "member",
)

# keys an engine passes to MetricsRecorder.finish_round
FINISH_KEYS: Tuple[str, ...] = (
    "round",
    "active",
    "contrib",
    "eps",
    "delta_normsq",
    "value_normsq",
    "accs",
    "bytes_total",
    "msgs_total",
    "drops_total",
)


def _traffic_schema() -> Dict[str, str]:
    out: Dict[str, str] = {}
    for ch in CHANNELS:
        out[f"msgs_{ch}"] = f"{ch} messages sent this round"
        out[f"bytes_{ch}"] = f"{ch} payload bytes sent this round"
        out[f"drops_{ch}"] = f"{ch} messages lost to the fate stream this round"
    return out


# ordered key -> description catalogue
TELEMETRY_SCHEMA: Dict[str, str] = {
    "round": "training round index",
    "active": "live, online agents this round",
    **_traffic_schema(),
    "drops_offline": "messages dropped because an endpoint was offline (churn)",
    "delay_hist": "histogram of delivered-message delays in ticks, 0..max_delay",
    "contrib": "per-(partition, replica-slot) contributor count r, k-major",
    "eps": "per-instance staleness weight eps after this round's recursion",
    "delta_normsq": "sum of squares of all agents' local-SGD deltas (f32)",
    "value_normsq": "sum of squares of the post-merge partition value plane (f32)",
    "accs": "per-evaluated-agent test accuracy (f32)",
    "acc_mean": "mean of accs (f64 over the f32 values)",
    "acc_std": "std of accs (f64 over the f32 values)",
    "acc_max": "max of accs",
    "bytes_total": "cumulative wire bytes since construction (== pubsub)",
    "msgs_total": "cumulative messages sent since construction (== pubsub)",
    "drops_total": "cumulative messages dropped since construction (== pubsub)",
}

ROW_KEYS: Tuple[str, ...] = tuple(TELEMETRY_SCHEMA)
