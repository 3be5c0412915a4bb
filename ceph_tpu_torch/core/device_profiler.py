"""Per-launch device profiler — port of ``ceph_tpu.core.device_profiler``.

Every device entry point (GF(2^8) encode, CRC-32C digest, parity
recheck, CRUSH batch map, the batch engine's megabatches) brackets its
kernel launches with :meth:`DeviceProfiler.start` /
:meth:`_Launch.finish`.  The two timestamps split a launch's wall time
into

* **dispatch** — host time until the (asynchronous) call returned:
  staging, table lookups, kernel enqueue; and
* **compute** — the host's further wait at the fence: ``ceph_tpu``
  waits in ``jax.block_until_ready``; here a CUDA event, recorded on
  the current stream when the launch is marked :meth:`_Launch.dispatched`
  (or at ``finish`` when it was not), is synchronized at
  ``finish(out=tensor)``.  The event waits for this stream's work
  only, never for other streams (no ``torch.cuda.synchronize()``).

Each sample also records bytes in/out, batch occupancy (useful rows
against padded rows), cache-hit tags, and the **idle gap** since the
previous launch ended (a device that is mostly gap is starved by the
host, not by work).

Samples land in a bounded ring and fold into per-kernel, per-lane and
total aggregates plus a log2 histogram of launch wall time.
Attribution is thread-local: a caller ``bind()``\\ s its profiler
around code that calls into the device libraries, and the libraries
ask :func:`DeviceProfiler.active`.

Nested instrumented calls (a scrub recheck that encodes through
``GFLinear``) record only the **outermost** launch: an inner ``start``
while a launch is open on this thread returns ``None``, so bytes and
time are never counted twice.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any

import torch

from .perf_counters import LogHistogram

# launch wall-time histogram: log2 buckets of microseconds, 2^31 us
# (~35 min) ceiling — same shape the op-latency histogram uses so the
# mgr/exporter quantile code is shared
LAUNCH_HIST_BUCKETS = 32

_tls = threading.local()


class _Launch:
    """One open launch; ``finish`` closes it and records the sample."""

    __slots__ = ("_prof", "kernel", "t0", "t_dispatch",
                 "bytes_in", "bytes_used", "rows", "rows_used",
                 "tags", "_overlap", "_event")

    def __init__(self, prof: "DeviceProfiler", kernel: str,
                 bytes_in: int, rows: int, rows_used: int,
                 tags: dict[str, Any], bytes_used: int | None = None,
                 overlap: bool = False):
        self._prof = prof
        self.kernel = kernel
        self.t0 = time.monotonic()
        self.t_dispatch = 0.0
        self.bytes_in = int(bytes_in)
        self.bytes_used = int(bytes_in if bytes_used is None
                              else bytes_used)
        self.rows = int(rows)
        self.rows_used = int(rows_used)
        self.tags = tags
        self._overlap = overlap
        self._event = None

    def dispatched(self) -> None:
        """Mark the end of the (async) dispatch phase *now*, and record
        the fence event on the current CUDA stream.  A later ``finish``
        then attributes everything past this point to compute — the
        engine dispatches a flight, keeps working, and fences it
        launches later."""
        self.t_dispatch = time.monotonic() - self.t0
        if torch.cuda.is_initialized():
            self._event = torch.cuda.Event()
            self._event.record()

    def finish(self, out: Any = None, bytes_out: int = 0,
               **tags) -> None:
        """Close the launch.

        Called right after the (possibly async) device call returned;
        the time to here is *dispatch* (unless :meth:`dispatched`
        already marked it).  If ``out`` holds CUDA tensors (one, or a
        tuple or list of them), the host waits at the fence — the event
        :meth:`dispatched` recorded, else one recorded now on the
        current stream of ``out``'s device — and that wait is
        *compute*.  Call sites that already read the result back
        (``.cpu()``) pass ``out=None`` with the fence implicit in their
        own copy: compute is then folded into dispatch, which is the
        honest reading, since the host blocked for it.
        """
        now = time.monotonic()
        if self.t_dispatch <= 0.0:
            self.t_dispatch = now - self.t0
        cuda = _cuda_tensors(out)
        if cuda:
            event = self._event
            if event is None:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(cuda[0].device))
            event.synchronize()
            now = time.monotonic()
        compute = max(0.0, (now - self.t0) - self.t_dispatch)
        if tags:
            self.tags.update(tags)
        self._prof._record(self, compute, now, int(bytes_out))

    def abort(self) -> None:
        """Discard an open launch (device call raised) so the
        thread-local nesting flag doesn't stick."""
        if not self._overlap:
            _tls.in_launch = False


def _cuda_tensors(out) -> list:
    """The CUDA tensors in ``out`` (a tensor, or a tuple or list)."""
    if isinstance(out, torch.Tensor):
        return [out] if out.is_cuda else []
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _cuda_tensors(o)]
    return []


class DeviceProfiler:
    """Bounded ring of per-launch samples + per-kernel aggregates."""

    def __init__(self, name: str = "", ring_size: int = 1024,
                 enabled: bool = False, perf=None):
        self.name = name
        self.enabled = bool(enabled)
        self.perf = perf        # a PerfCounters with the device_* counters
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=max(1, int(ring_size)))
        self._last_end: float | None = None   # for the idle-gap series
        self._agg: dict[str, dict] = {}
        self._lanes: dict[str, dict] = {}
        self._hist = LogHistogram(LAUNCH_HIST_BUCKETS)
        self._totals = self._zero_agg()

    # -- lifecycle ---------------------------------------------------------

    @staticmethod
    def _zero_agg() -> dict:
        return {"launches": 0, "dispatch_s": 0.0, "compute_s": 0.0,
                "bytes_in": 0, "bytes_used": 0, "bytes_out": 0,
                "rows": 0, "rows_used": 0, "cache_hits": 0,
                "gap_s": 0.0, "gaps": 0}

    def set_enabled(self, v: bool) -> None:
        self.enabled = bool(v)

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._agg.clear()
            self._lanes.clear()
            self._totals = self._zero_agg()
            self._hist = LogHistogram(LAUNCH_HIST_BUCKETS)
            self._last_end = None

    # -- thread-local attribution (same pattern as the tracer) -------------

    def bind(self) -> "_Bind":
        """Context manager: device calls on this thread attribute here."""
        return _Bind(self)

    @classmethod
    def active(cls) -> "DeviceProfiler":
        """The profiler bound to this thread, else the process default."""
        p = getattr(_tls, "profiler", None)
        return p if p is not None else default_profiler()

    # -- recording ---------------------------------------------------------

    def start(self, kernel: str, bytes_in: int = 0, rows: int = 0,
              rows_used: int = 0, bytes_used: int | None = None,
              overlap: bool = False,
              **tags) -> _Launch | None:
        """Open a launch; returns ``None`` when disabled or nested so
        call sites stay zero-alloc on the fast path.

        ``bytes_used`` — the member-payload bytes inside ``bytes_in``
        (size-bucket padding is the difference); defaults to
        ``bytes_in`` so ordinary launches read as fully occupied.

        ``overlap=True`` — the call site keeps several launches open
        at once (the batch engine's double-buffered flights) and
        guarantees no nested instrumented calls of its own; such a
        launch neither consults nor sets the thread-local nesting
        flag."""
        if not self.enabled:
            return None
        if not overlap:
            if getattr(_tls, "in_launch", False):
                return None         # outermost wins: no double counting
            _tls.in_launch = True
        return _Launch(self, kernel, bytes_in, rows,
                       max(rows_used, 0) or rows, tags,
                       bytes_used=bytes_used, overlap=overlap)

    def _record(self, lnch: _Launch, compute: float, t_end: float,
                bytes_out: int) -> None:
        if not lnch._overlap:
            _tls.in_launch = False
        dispatch = lnch.t_dispatch
        total = (t_end - lnch.t0)
        cache_hit = bool(lnch.tags.get("cache_hit"))
        sample = {
            "kernel": lnch.kernel,
            "start": lnch.t0,
            "dispatch_s": dispatch,
            "compute_s": compute,
            "total_s": total,
            "bytes_in": lnch.bytes_in,
            "bytes_used": lnch.bytes_used,
            "bytes_out": bytes_out,
            "rows": lnch.rows,
            "rows_used": lnch.rows_used,
            "tags": lnch.tags,
        }
        with self._lock:
            gap = None
            if self._last_end is not None and lnch.t0 > self._last_end:
                gap = lnch.t0 - self._last_end
            self._last_end = t_end
            sample["gap_s"] = gap
            self._ring.append(sample)
            aggs = [self._agg.setdefault(lnch.kernel, self._zero_agg()),
                    self._totals]
            lane = lnch.tags.get("lane")
            if lane is not None:
                aggs.append(self._lanes.setdefault(str(lane),
                                                   self._zero_agg()))
            for agg in aggs:
                agg["launches"] += 1
                agg["dispatch_s"] += dispatch
                agg["compute_s"] += compute
                agg["bytes_in"] += lnch.bytes_in
                agg["bytes_used"] += lnch.bytes_used
                agg["bytes_out"] += bytes_out
                agg["rows"] += lnch.rows
                agg["rows_used"] += lnch.rows_used
                if cache_hit:
                    agg["cache_hits"] += 1
                if gap is not None:
                    agg["gap_s"] += gap
                    agg["gaps"] += 1
            self._hist.add(int(total * 1e6))
        if self.perf is not None:
            try:
                self.perf.inc("device_launches")
                self.perf.tinc("device_dispatch", dispatch)
                self.perf.tinc("device_compute", compute)
                self.perf.inc("device_bytes_in", lnch.bytes_in)
                self.perf.inc("device_bytes_out", bytes_out)
                self.perf.hinc("device_launch_hist", int(total * 1e6))
            except KeyError:
                pass            # daemon built without device counters

    # -- surfaces ----------------------------------------------------------

    def samples(self) -> list[dict]:
        with self._lock:
            return [dict(s) for s in self._ring]

    def aggregate(self) -> dict:
        """Cheap summary of every launch recorded (ceph_tpu's keys)."""
        with self._lock:
            kernels = {k: dict(v) for k, v in self._agg.items()}
            lanes = {k: dict(v) for k, v in self._lanes.items()}
            tot = dict(self._totals)
            hist = list(self._hist.data[0])
        t = tot["dispatch_s"] + tot["compute_s"]
        return {
            "name": self.name,
            "enabled": self.enabled,
            "kernels": kernels,
            "lanes": lanes,
            # per-device aggregates: the port drives one device
            # (multi-device is ROADMAP item 7), so there are none
            "devices": {},
            "totals": tot,
            "launch_hist_us": hist,
            "dispatch_overhead_ratio":
                (tot["dispatch_s"] / t) if t > 0 else 0.0,
            "occupancy_ratio":
                (tot["rows_used"] / tot["rows"]) if tot["rows"] else 1.0,
            "byte_occupancy_ratio":
                (tot["bytes_used"] / tot["bytes_in"])
                if tot["bytes_in"] else 1.0,
            "idle_gap_avg_s":
                (tot["gap_s"] / tot["gaps"]) if tot["gaps"] else 0.0,
        }

    def dump(self) -> dict:
        d = self.aggregate()
        d["ring"] = self.samples()
        return d

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


class _Bind:
    __slots__ = ("_prof", "_prev")

    def __init__(self, prof: DeviceProfiler):
        self._prof = prof
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_tls, "profiler", None)
        _tls.profiler = self._prof
        return self._prof

    def __exit__(self, *exc):
        _tls.profiler = self._prev
        return False


_default: DeviceProfiler | None = None
_default_lock = threading.Lock()


def default_profiler() -> DeviceProfiler:
    """Process-wide fallback profiler (disabled until someone enables
    it) — used by direct library calls outside any daemon."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = DeviceProfiler(name="process")
    return _default
