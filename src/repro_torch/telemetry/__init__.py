"""Observability for the port. This slice carries the phase timers; the
metric recorder, trace writer and schema come with the telemetry slice."""
from repro_torch.telemetry.timing import NULL_TIMER, PhaseTimer, host_metadata

__all__ = ["NULL_TIMER", "PhaseTimer", "host_metadata"]
