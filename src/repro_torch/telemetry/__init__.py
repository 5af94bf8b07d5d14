"""Observability for the port, counterpart of ``repro.telemetry``: structured
per-round metrics, protocol event traces and per-phase wall timing. Off by
default: engines hold ``NULL_TIMER`` and skip every tap, and the batched
engine's device rounds run exactly the kernels they run without telemetry
(no auxiliary output in the captured graphs).
"""
from repro_torch.telemetry.recorder import MetricsRecorder
from repro_torch.telemetry.schema import (
    CHANNELS,
    FINISH_KEYS,
    ROW_KEYS,
    SCHEMA_VERSION,
    TELEMETRY_SCHEMA,
)
from repro_torch.telemetry.timing import NULL_TIMER, PhaseTimer, host_metadata
from repro_torch.telemetry.trace import TraceWriter

__all__ = [
    "MetricsRecorder",
    "TraceWriter",
    "PhaseTimer",
    "NULL_TIMER",
    "host_metadata",
    "SCHEMA_VERSION",
    "CHANNELS",
    "FINISH_KEYS",
    "ROW_KEYS",
    "TELEMETRY_SCHEMA",
]
