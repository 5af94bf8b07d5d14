"""Chrome trace-event JSON writer (perfetto / chrome://tracing viewable).

Counterpart of ``repro.telemetry.trace``. Two tracks:

  * pid 1 "protocol (simulated ticks)": instant events for every scalar
    pubsub send, delivery and drop, one tid per agent, with the simulated
    tick counter as the timebase (1 tick = 1000 trace-us, so a round spans
    4 ms on the timeline and delayed deliveries land visibly in later
    rounds);
  * pid 2 "host (wall clock)": complete ("X") spans for the engine phases
    recorded by ``PhaseTimer`` (fate draw, control plane, device rounds,
    window replays, evaluation), in microseconds since the writer was made.

The output is the standard ``{"traceEvents": [...]}`` JSON object; open it
at https://ui.perfetto.dev or chrome://tracing.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

PID_PROTOCOL = 1
PID_HOST = 2

# one simulated tick = this many trace-timeline microseconds
TICK_US = 1000


class TraceWriter:
    def __init__(self) -> None:
        self.events: List[dict] = []
        self._t0 = time.perf_counter()

    # -- protocol track (simulated time) -----------------------------------
    def instant(
        self,
        name: str,
        tick: int,
        tid: int,
        args: Optional[Dict[str, object]] = None,
    ) -> None:
        ev = {
            "name": name,
            "ph": "i",
            "s": "t",
            "ts": tick * TICK_US,
            "pid": PID_PROTOCOL,
            "tid": int(tid),
        }
        if args:
            ev["args"] = args
        self.events.append(ev)

    # -- host track (wall clock) -------------------------------------------
    def host_span(self, name: str, t0: float, dur_s: float, tid: int = 0) -> None:
        self.events.append(
            {
                "name": name,
                "ph": "X",
                "ts": (t0 - self._t0) * 1e6,
                "dur": dur_s * 1e6,
                "pid": PID_HOST,
                "tid": int(tid),
            }
        )

    # -- output --------------------------------------------------------------
    def to_dict(self) -> dict:
        meta = [
            {
                "name": "process_name",
                "ph": "M",
                "pid": PID_PROTOCOL,
                "args": {"name": "protocol (simulated ticks)"},
            },
            {
                "name": "process_name",
                "ph": "M",
                "pid": PID_HOST,
                "args": {"name": "host (wall clock)"},
            },
        ]
        return {"traceEvents": meta + self.events, "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)
