"""Per-daemon span collector — port of ``ceph_tpu.core.tracer``
(reference ``src/common/tracer.cc``).

The reference links Jaeger/OpenTelemetry and attaches blkin-style op
traces to every layer of the op path.  This reproduction keeps the
Dapper model — a span is ``(trace_id, span_id, parent_id, name,
start, duration, tags, events, daemon)`` — but collects spans into an
in-process ring per daemon instead of shipping them to an agent.

Cost model: when tracing is disabled ``Tracer.start_span`` returns
``None`` without allocating anything, so every call site guards with
``if span is not None`` and the disabled op path stays span-free.
Context rides the message JSON as a two-key dict
(``{"t": trace_id, "s": span_id}``) — the compact analogue of the
trace/span id pair the reference packs into the message header.

Spans use ``time.monotonic()`` for start/duration; all daemons of a
``MiniCluster`` share one process, so starts are directly comparable
and ``chrome_trace`` can emit absolute microsecond timestamps for
chrome://tracing without clock alignment.
"""

from __future__ import annotations

import collections
import random
import threading
import time
import uuid


def _new_id() -> str:
    return uuid.uuid4().hex[:16]


class Span:
    """One timed operation; finish() files it into the tracer ring."""

    __slots__ = ("_tracer", "trace_id", "span_id", "parent_id", "name",
                 "daemon", "start", "duration", "tags", "events",
                 "links")

    def __init__(self, tracer: "Tracer", trace_id: str, span_id: str,
                 parent_id: str | None, name: str,
                 tags: dict | None = None):
        self._tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.daemon = tracer.daemon
        self.start = time.monotonic()
        self.duration: float | None = None
        self.tags = dict(tags) if tags else {}
        self.events: list = []          # [offset_s, name] pairs
        self.links: list = []           # [{"t","s"}] causal, non-parent

    def set_tag(self, key: str, value) -> None:
        self.tags[key] = value

    def event(self, name: str) -> None:
        """Point-in-time annotation (mark_event / resend / backoff)."""
        self.events.append([time.monotonic() - self.start, name])

    def ctx(self) -> dict:
        """Wire form carried in message fields."""
        return {"t": self.trace_id, "s": self.span_id}

    def add_link(self, other) -> None:
        """Causal cross-trace reference (OTel span link): background
        work (scrub, recovery) points at the op or event that
        triggered it without joining its trace.  ``other`` is a Span,
        a wire ctx dict, or None (ignored)."""
        if isinstance(other, Span):
            self.links.append(other.ctx())
        elif isinstance(other, dict) and other.get("t"):
            self.links.append({"t": other["t"], "s": other.get("s")})

    def finish(self) -> None:
        if self.duration is not None:       # idempotent
            return
        self.duration = time.monotonic() - self.start
        self._tracer._finish(self)

    def dump(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "daemon": self.daemon,
            "start": self.start,
            "duration": self.duration,
            "tags": dict(self.tags),
            "events": [list(e) for e in self.events],
            "links": [dict(l) for l in self.links],
        }


class Tracer:
    """Per-daemon collector: bounded ring of finished spans.

    ``perf``, when attached, receives a
    ``tinc("<layer>_span_duration", dur)`` per finished span keyed by
    the span's ``layer`` tag — the per-layer time-avg counters the
    exporter scrapes.  Unknown counter names are ignored so callers
    can tag freely.

    Two throttles keep tracing affordable under load (reference
    head-sampling; ``tracer_sampling_rate`` / ``tracer_span_budget``
    options).  Both apply at trace ROOTS only: a sampled-out root
    returns None and — since children pass the parent span/ctx — the
    whole op allocates no spans anywhere, while accepted traces stay
    complete.  The budget is a per-second token count refilled on the
    wall-clock second boundary; the counters are unsynchronized on
    purpose (a race overshoots by at most a few spans, and the hot
    path takes no lock).  Sampling draws from ``rng`` (a
    ``random.Random``; the caller seeds it to replay a sampling run).
    """

    MAX_PINNED_TRACES = 32

    def __init__(self, daemon: str = "", ring_size: int = 4096,
                 enabled: bool = False, perf=None,
                 sampling_rate: float = 1.0, span_budget: int = 0,
                 tail_slow_s: float = 0.0,
                 rng: random.Random | None = None):
        self.daemon = daemon
        self.rng = rng if rng is not None else random.Random()
        self.enabled = bool(enabled)
        self.perf = perf
        self.sampling_rate = float(sampling_rate)
        self.span_budget = int(span_budget)     # roots/sec; 0 = off
        # tail sampling: a root closing slower than this (or with an
        # error tag) retroactively pins its whole trace against ring
        # eviction — head sampling decides cheaply at admission, the
        # tail pass rescues the traces worth keeping (0 = off)
        self.tail_slow_s = float(tail_slow_s)
        self._budget_sec = 0
        self._budget_used = 0
        self._spans: collections.deque = collections.deque(
            maxlen=max(1, int(ring_size)))
        # trace_id → [Span]; insertion-ordered, oldest trace evicted
        self._pinned: dict[str, list] = {}
        self._lock = threading.Lock()

    # -- span lifecycle -------------------------------------------------

    def _admit_root(self) -> bool:
        if self.sampling_rate < 1.0 and \
                self.rng.random() >= self.sampling_rate:
            return False
        budget = self.span_budget
        if budget > 0:
            sec = int(time.monotonic())
            if sec != self._budget_sec:
                self._budget_sec = sec
                self._budget_used = 0
            if self._budget_used >= budget:
                return False
            self._budget_used += 1
        return True

    def start_span(self, name: str, parent=None,
                   tags: dict | None = None) -> Span | None:
        """New span, or None (no allocation) when tracing is off or
        the root is sampled out / over budget.

        ``parent`` may be a live ``Span``, a wire ctx dict
        (``{"t":..,"s":..}``), or None to root a fresh trace.
        """
        if not self.enabled:
            return None
        if isinstance(parent, Span):
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif isinstance(parent, dict) and parent.get("t"):
            trace_id, parent_id = parent["t"], parent.get("s")
        else:
            if not self._admit_root():
                return None
            trace_id, parent_id = _new_id(), None
        return Span(self, trace_id, _new_id(), parent_id, name, tags)

    def _finish(self, span: Span) -> None:
        with self._lock:
            if span.trace_id in self._pinned:
                # trace already rescued: late children join it directly
                self._pinned[span.trace_id].append(span)
            else:
                self._spans.append(span)
                if span.parent_id is None and self._should_pin(span):
                    self._pin_locked(span.trace_id)
        perf = self.perf
        if perf is not None:
            layer = span.tags.get("layer", "op")
            try:
                perf.tinc(f"{layer}_span_duration", span.duration)
            except KeyError:
                pass                    # layer without a counter

    # -- tail sampling ---------------------------------------------------

    def _should_pin(self, root: Span) -> bool:
        if root.tags.get("error"):
            return True
        return (self.tail_slow_s > 0
                and (root.duration or 0.0) > self.tail_slow_s)

    def _pin_locked(self, trace_id: str) -> None:
        """Move every span of ``trace_id`` out of the eviction ring
        into the pinned store (caller holds the lock)."""
        keep, mine = collections.deque(maxlen=self._spans.maxlen), []
        for s in self._spans:
            (mine if s.trace_id == trace_id else keep).append(s)
        self._spans = keep
        self._pinned[trace_id] = mine
        while len(self._pinned) > self.MAX_PINNED_TRACES:
            self._pinned.pop(next(iter(self._pinned)))

    # -- inspection -----------------------------------------------------

    def dump(self) -> list[dict]:
        with self._lock:
            spans = list(self._spans)
            for group in self._pinned.values():
                spans.extend(group)
        return [s.dump() for s in spans]

    def spans_for(self, trace_id: str) -> list[dict]:
        return [d for d in self.dump() if d["trace_id"] == trace_id]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._pinned.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans) + sum(
                len(g) for g in self._pinned.values())


def _otlp_value(v) -> dict:
    """One OTLP AnyValue."""
    if isinstance(v, bool):
        return {"boolValue": v}
    if isinstance(v, int):
        return {"intValue": str(v)}
    if isinstance(v, float):
        return {"doubleValue": v}
    return {"stringValue": str(v)}


def _otlp_attrs(tags: dict) -> list[dict]:
    return [{"key": str(k), "value": _otlp_value(v)}
            for k, v in tags.items()]


def otlp_trace(spans: list[dict]) -> dict:
    """OTLP/JSON-shaped export (OpenTelemetry ExportTraceServiceRequest):
    one resourceSpans entry per daemon (``service.name``), spans with
    padded 128-bit traceId / 64-bit spanId hex, nanosecond Unix
    timestamps, attributes, events and links.

    ``spans`` are ``Span.dump()`` dicts on the shared monotonic
    clock; one wall-clock offset computed here converts them all, so
    relative timing is preserved exactly.
    """
    offset = time.time() - time.monotonic()
    by_daemon: dict[str, list[dict]] = {}
    for s in spans:
        by_daemon.setdefault(s.get("daemon") or "?", []).append(s)
    resource_spans = []
    for daemon in sorted(by_daemon):
        otlp_spans = []
        for s in by_daemon[daemon]:
            start_ns = int((offset + s["start"]) * 1e9)
            end_ns = int((offset + s["start"]
                          + (s["duration"] or 0.0)) * 1e9)
            rec = {
                "traceId": s["trace_id"].ljust(32, "0"),
                "spanId": s["span_id"].ljust(16, "0"),
                "name": s["name"],
                "kind": 1,              # SPAN_KIND_INTERNAL
                "startTimeUnixNano": str(start_ns),
                "endTimeUnixNano": str(end_ns),
                "attributes": _otlp_attrs(s.get("tags") or {}),
            }
            if s.get("parent_id"):
                rec["parentSpanId"] = s["parent_id"].ljust(16, "0")
            if s.get("events"):
                rec["events"] = [
                    {"timeUnixNano":
                     str(int((offset + s["start"] + off) * 1e9)),
                     "name": name}
                    for off, name in s["events"]]
            if s.get("links"):
                rec["links"] = [
                    {"traceId": (l.get("t") or "").ljust(32, "0"),
                     "spanId": (l.get("s") or "").ljust(16, "0")}
                    for l in s["links"]]
            otlp_spans.append(rec)
        resource_spans.append({
            "resource": {"attributes": _otlp_attrs(
                {"service.name": daemon,
                 "service.namespace": "ceph-tpu"})},
            "scopeSpans": [{
                "scope": {"name": "ceph_tpu.tracer", "version": "1"},
                "spans": otlp_spans}],
        })
    return {"resourceSpans": resource_spans}


def chrome_trace(spans: list[dict]) -> dict:
    """Chrome trace_event JSON for chrome://tracing / Perfetto.

    ``spans`` are ``Span.dump()`` dicts (typically from
    ``MiniCluster.collect_trace``).  Each daemon becomes a pid with a
    process_name metadata record; spans become complete ("X") events
    with microsecond ts/dur on the shared monotonic clock.
    """
    daemons = sorted({s.get("daemon") or "?" for s in spans})
    pids = {d: i + 1 for i, d in enumerate(daemons)}
    events: list[dict] = [
        {"ph": "M", "name": "process_name", "pid": pids[d], "tid": 0,
         "args": {"name": d}}
        for d in daemons
    ]
    for s in spans:
        args = {"trace_id": s["trace_id"], "span_id": s["span_id"],
                "parent_id": s["parent_id"], **s.get("tags", {})}
        if s.get("events"):
            args["events"] = [f"+{off * 1e3:.3f}ms {name}"
                              for off, name in s["events"]]
        if s.get("links"):
            args["links"] = [f"{l.get('t')}/{l.get('s')}"
                             for l in s["links"]]
        events.append({
            "ph": "X",
            "name": s["name"],
            "cat": s.get("tags", {}).get("layer", "op"),
            "pid": pids[s.get("daemon") or "?"],
            "tid": 1,
            "ts": round(s["start"] * 1e6, 3),
            "dur": round((s["duration"] or 0.0) * 1e6, 3),
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}
