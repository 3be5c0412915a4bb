"""Log-bucket histogram — a copy of ``LogHistogram`` alone from
``ceph_tpu.core.perf_counters`` (the device profiler's launch-time
histogram).  The rest of that module (counters, gauges, the daemon
registry) comes with the control plane.
"""

from __future__ import annotations

import math
import time


class LogHistogram:
    """2-D logarithmic histogram (reference PerfHistogram): axis-x is
    the observed value, axis-y an optional secondary dimension.

    Metric→trace exemplars (OpenMetrics): when the caller hands a
    trace id alongside the observation, the histogram keeps the
    SLOWEST (largest-x) exemplar per x-bucket per window — the trace
    a burning `_bucket` line links to.  The window resets wholesale
    every ``exemplar_window`` seconds so exemplars never outlive the
    tracer ring that can still resolve them."""

    def __init__(self, x_buckets: int = 32, y_buckets: int = 1,
                 exemplar_window: float = 60.0):
        self.x_buckets = x_buckets
        self.y_buckets = y_buckets
        self.data = [[0] * x_buckets for _ in range(y_buckets)]
        self.exemplar_window = float(exemplar_window)
        # x-bucket -> {"trace_id", "value", "ts"} (wall clock)
        self.exemplars: dict[int, dict] = {}
        self._exemplar_win_start = 0.0

    @staticmethod
    def _bucket(v: float, n: int) -> int:
        if v <= 0:
            return 0
        return min(int(math.log2(v + 1)), n - 1)

    def add(self, x: float, y: float = 0, trace_id: str | None = None):
        xb = self._bucket(x, self.x_buckets)
        yb = self._bucket(y, self.y_buckets)
        self.data[yb][xb] += 1
        if trace_id:
            now = time.time()
            if now - self._exemplar_win_start >= self.exemplar_window:
                self.exemplars = {}
                self._exemplar_win_start = now
            ex = self.exemplars.get(xb)
            if ex is None or x >= ex["value"]:
                self.exemplars[xb] = {"trace_id": trace_id,
                                      "value": x, "ts": now}

    def dump(self) -> dict:
        out = {"x_buckets": self.x_buckets,
               "y_buckets": self.y_buckets,
               "values": self.data}
        if self.exemplars:
            out["exemplars"] = {str(b): dict(ex)
                                for b, ex in self.exemplars.items()}
        return out
