"""PerfCounters — daemon metrics (counters, gauges, averages, 2-D
log-bucket histograms).

The port's copy of ``ceph_tpu.core.perf_counters``.

Reference behavior re-created (``src/common/perf_counters.{h,cc}``;
SURVEY.md §3.1/§6.5): counters built once via a builder, updated
lock-free on the hot path (here: GIL-atomic int ops), dumped as JSON
through the admin socket and scraped by the mgr for the prometheus
exporter.  ``time_avg`` pairs (sum, count) so readers compute stable
averages; histograms use logarithmic buckets on both axes.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

U64 = "u64"          # monotonically increasing counter
GAUGE = "gauge"      # instantaneous value
TIME_AVG = "timeavg"  # (sum_seconds, count)
HISTOGRAM = "hist"   # 2-D log buckets (value x count-per-call)


@dataclass
class _Counter:
    name: str
    kind: str
    desc: str = ""
    value: float = 0
    sum: float = 0.0
    count: int = 0
    hist: "LogHistogram | None" = None


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


class PerfCounters:
    def __init__(self, name: str):
        self.name = name
        self._counters: dict[str, _Counter] = {}
        # no lock by design: updates are single int/float ops (GIL-
        # atomic); dump() may observe a (sum, count) pair mid-update,
        # which metrics readers tolerate — the reference makes the same
        # tradeoff with relaxed atomics

    # -- updates (hot path) ------------------------------------------------
    def inc(self, name: str, by: float = 1):
        self._counters[name].value += by

    def dec(self, name: str, by: float = 1):
        c = self._counters[name]
        assert c.kind == GAUGE, "dec only valid on gauges"
        c.value -= by

    def set(self, name: str, value: float):
        self._counters[name].value = value

    def tinc(self, name: str, seconds: float):
        c = self._counters[name]
        c.sum += seconds
        c.count += 1

    def hinc(self, name: str, x: float, y: float = 0,
             trace_id: str | None = None):
        self._counters[name].hist.add(x, y, trace_id=trace_id)

    def get(self, name: str) -> float:
        return self._counters[name].value

    def avg(self, name: str) -> float:
        c = self._counters[name]
        return c.sum / c.count if c.count else 0.0

    # -- dump --------------------------------------------------------------
    def dump(self) -> dict:
        out = {}
        for c in self._counters.values():
            if c.kind == TIME_AVG:
                out[c.name] = {"avgcount": c.count, "sum": c.sum}
            elif c.kind == HISTOGRAM:
                out[c.name] = c.hist.dump()
            else:
                out[c.name] = c.value
        return {self.name: out}

    def dump_histograms(self) -> dict:
        """HISTOGRAM counters only (reference `perf histogram dump`)."""
        return {self.name: {c.name: c.hist.dump()
                            for c in self._counters.values()
                            if c.kind == HISTOGRAM}}

    def schema(self) -> dict:
        return {self.name: {c.name: {"type": c.kind, "desc": c.desc}
                            for c in self._counters.values()}}


class PerfCountersBuilder:
    def __init__(self, name: str):
        self._pc = PerfCounters(name)

    def add_u64_counter(self, name: str, desc: str = ""):
        self._pc._counters[name] = _Counter(name, U64, desc)
        return self

    def add_u64(self, name: str, desc: str = ""):
        self._pc._counters[name] = _Counter(name, GAUGE, desc)
        return self

    def add_time_avg(self, name: str, desc: str = ""):
        self._pc._counters[name] = _Counter(name, TIME_AVG, desc)
        return self

    def add_histogram(self, name: str, desc: str = "",
                      x_buckets: int = 32, y_buckets: int = 1):
        self._pc._counters[name] = _Counter(
            name, HISTOGRAM, desc,
            hist=LogHistogram(x_buckets, y_buckets))
        return self

    def create_perf_counters(self) -> PerfCounters:
        return self._pc


class PerfCountersCollection:
    """Per-process registry (CephContext::get_perfcounters_collection):
    every subsystem logger lands here; the admin socket's `perf dump`
    walks it."""

    def __init__(self):
        self._loggers: dict[str, PerfCounters] = {}

    def add(self, pc: PerfCounters):
        self._loggers[pc.name] = pc

    def remove(self, name: str):
        self._loggers.pop(name, None)

    def dump(self) -> dict:
        out = {}
        for pc in self._loggers.values():
            out.update(pc.dump())
        return out

    def schema(self) -> dict:
        out = {}
        for pc in self._loggers.values():
            out.update(pc.schema())
        return out
