"""PR02 no-fire: this fixture path ends in ``repro_torch/fl/vectorized.py``
so the port's declared-symmetry entries apply — counters bumped inside a
declared function are clean. Functions the table declares but this
partial file omits are skipped, not stale."""


class VectorizedEngine:
    def __init__(self):
        self.messages_sent = 0
        self.messages_dropped = 0
        self._bytes_total = 0

    def _run_round_lossy(self, ctl):
        self.messages_sent += ctl["msgs"]
        self.messages_dropped += ctl["drops"]
        self._bytes_total += ctl["nbytes"]
