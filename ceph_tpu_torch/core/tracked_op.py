"""TrackedOp / OpTracker — in-flight op tracking and slow-op warnings.

The port's copy of ``ceph_tpu.core.tracked_op``.

Reference behavior re-created (``src/common/TrackedOp.{h,cc}``;
SURVEY.md §3.1/§6.1): every request entering a daemon is wrapped in a
tracked op that records event timestamps ("queued", "reached_pg",
"commit_sent"...); the tracker can dump ops-in-flight, keeps a bounded
history of completed ops (the `dump_historic_ops` admin command), and
flags ops alive past a complaint age (slow-op health warnings).
"""

from __future__ import annotations

import collections
import threading
import time


class TrackedOp:
    def __init__(self, tracker: "OpTracker", desc: str):
        self._tracker = tracker
        self.description = desc
        self.initiated_at = time.monotonic()
        self.events: list[tuple[float, str]] = [(0.0, "initiated")]
        self.completed_at: float | None = None
        self.span = None        # tracer.Span when tracing is on

    def mark_event(self, name: str):
        self.events.append((time.monotonic() - self.initiated_at, name))
        if self.span is not None:
            self.span.event(name)

    def finish(self):
        self.mark_event("done")
        self.completed_at = time.monotonic()
        if self.span is not None:
            self.span.finish()
        self._tracker._complete(self)

    @property
    def age(self) -> float:
        end = self.completed_at if self.completed_at is not None \
            else time.monotonic()
        return end - self.initiated_at

    def dump(self) -> dict:
        return {
            "description": self.description,
            "age": round(self.age, 6),
            "events": [{"time": round(t, 6), "event": e}
                       for t, e in self.events],
        }


class OpTracker:
    def __init__(self, history_size: int = 20,
                 complaint_time: float = 30.0,
                 history_duration: float = 600.0):
        self._inflight: dict[int, TrackedOp] = {}
        self._history: collections.deque[TrackedOp] = collections.deque(
            maxlen=history_size)
        self._seq = 0
        self._lock = threading.Lock()
        self.complaint_time = complaint_time
        self.history_duration = history_duration

    def create_request(self, desc: str) -> TrackedOp:
        op = TrackedOp(self, desc)
        with self._lock:
            self._seq += 1
            op._id = self._seq
            self._inflight[op._id] = op
        return op

    def _complete(self, op: TrackedOp):
        with self._lock:
            self._inflight.pop(op._id, None)
            self._history.append(op)
            self._prune_locked()

    def _prune_locked(self):
        """Drop history entries completed longer ago than
        ``history_duration`` (reference osd_op_history_duration)."""
        if self.history_duration <= 0:
            return
        horizon = time.monotonic() - self.history_duration
        while self._history and \
                (self._history[0].completed_at or 0.0) < horizon:
            self._history.popleft()

    # -- introspection (admin socket commands) -----------------------------
    def dump_ops_in_flight(self) -> dict:
        with self._lock:
            ops = [op.dump() for op in self._inflight.values()]
        return {"num_ops": len(ops), "ops": ops}

    def dump_historic_ops(self) -> dict:
        with self._lock:
            self._prune_locked()
            ops = [op.dump() for op in self._history]
        return {"num_ops": len(ops), "ops": ops}

    def dump_historic_ops_by_duration(self) -> dict:
        """History sorted longest-duration first (reference
        ``dump_historic_ops_by_duration``)."""
        with self._lock:
            self._prune_locked()
            ops = sorted(self._history, key=lambda op: op.age,
                         reverse=True)
            ops = [op.dump() for op in ops]
        return {"num_ops": len(ops), "ops": ops}

    def get_slow_ops(self) -> list[TrackedOp]:
        with self._lock:
            return [op for op in self._inflight.values()
                    if op.age > self.complaint_time]

    def slow_summary(self) -> dict:
        """Compact slow-op report for the mon/mgr stat pipeline:
        count + worst age (+ its description, for operators chasing
        the stuck op from `ceph health detail`)."""
        slow = self.get_slow_ops()
        if not slow:
            return {"count": 0, "oldest_age": 0.0, "oldest_desc": ""}
        worst = max(slow, key=lambda op: op.age)
        return {"count": len(slow),
                "oldest_age": round(worst.age, 3),
                "oldest_desc": worst.description}
