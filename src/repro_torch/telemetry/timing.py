"""Per-phase wall timers: phase-level attribution for the round engines.

Counterpart of ``repro.telemetry.timing``. ``PhaseTimer.phase(name)`` is a
context manager accumulating count/seconds per phase; with a ``TraceWriter``
attached every phase also lands as a Chrome trace "X" (complete) event on
the host wall-clock track. ``NULL_TIMER`` is what engines hold by default —
its ``phase()`` is a shared no-op context manager, so the disabled-path
cost is one attribute lookup per phase.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Optional


class PhaseTimer:
    """Accumulates wall seconds per named phase.

    ``sync`` tells engines to ``torch.cuda.synchronize()`` at the end of
    device phases, so asynchronous launches cannot leak timed work across
    phases — only honest when a timer is actually attached.
    """

    sync = True

    def __init__(self, trace=None):
        self.trace = trace
        self.totals: Dict[str, list] = {}  # name -> [count, seconds]

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            ent = self.totals.setdefault(name, [0, 0.0])
            ent[0] += 1
            ent[1] += dt
            if self.trace is not None:
                self.trace.host_span(name, t0, dt)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {"count": c, "total_s": s, "mean_s": s / max(c, 1)}
            for name, (c, s) in sorted(self.totals.items())
        }


class _NullTimer:
    sync = False
    totals: Dict[str, list] = {}

    @contextmanager
    def phase(self, name: str):
        yield

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {}


NULL_TIMER = _NullTimer()


@contextmanager
def device_phase(timer, name: str, device):
    """``timer.phase(name)`` around device work: with a syncing timer on a
    CUDA ``device``, the device is synchronized at the phase's end, so its
    queued work cannot leak into the next phase."""
    with timer.phase(name):
        yield
        if timer.sync and device.type == "cuda":
            import torch

            torch.cuda.synchronize(device)


def host_metadata(timestamp: Optional[str] = None) -> Dict[str, object]:
    """Environment stamp for measurements: torch and CUDA versions, and the
    GPU's name and power limit (a card set below its maximum runs slower
    under load, so every device number travels with it). The timestamp is
    passed in by the caller, so library code stays clock-free."""
    import os
    import platform
    import subprocess
    import sys

    import numpy as np
    import torch

    meta: Dict[str, object] = {
        "cpu_count": os.cpu_count(),
        "platform": platform.platform(),
        "python": sys.version.split()[0],
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "numpy_version": np.__version__,
        "gpu_name": None,
        "gpu_count": 0,
        "power_limit": None,
        "timestamp": timestamp,
    }
    if torch.cuda.is_available():
        meta["gpu_name"] = torch.cuda.get_device_name(0)
        meta["gpu_count"] = torch.cuda.device_count()
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, timeout=30, check=True,
            )
            meta["power_limit"] = out.stdout.strip().splitlines()[0]
        except (OSError, subprocess.SubprocessError, IndexError):
            meta["power_limit"] = "not read"
    return meta
