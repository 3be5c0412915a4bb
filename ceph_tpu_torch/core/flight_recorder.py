"""Per-daemon black-box flight recorder (reference: aircraft FDR +
``src/pybind/mgr/crash``'s post-mortem metadata).

The port's copy of ``ceph_tpu.core.flight_recorder``.

Every daemon that owns durable state journals a bounded timeline of
what it was doing — recent spans, clog tail, perf-counter deltas,
profiler aggregates, armed-crash-injector state — to an append-only
sidecar file next to its WAL, framed exactly like the WAL itself
(``os_store.walog`` CRC32C records, tolerate-corrupted-tail rule).
The file needs no mount to read: a parent process, or the offline
``tools/blackbox_tool.py``, can reconstruct the last seconds of a
SIGKILLed daemon from the raw bytes alone.

Design rules:

- **Always-on cheap.** Hot-path callers use :meth:`note`, a lock-free
  in-memory ring append; framed I/O happens only on the periodic
  :meth:`snap` (ticker cadence) and on rare :meth:`event` calls
  (crash-imminent markers), which write+flush so the OS page cache —
  which survives SIGKILL — holds them at the instant of death.
- **Crash detection mirrors WALStore.** A ``<path>.dirty`` marker is
  created at :meth:`open` and removed only by a clean :meth:`close`.
  A surviving marker at the next open means the previous incarnation
  died uncleanly; :meth:`open` returns its reconstructed timeline and
  preserves the dead file as ``<path>.crash`` for offline readers.
- **Bounded.** When the sidecar exceeds ``max_bytes`` it rotates to
  ``<path>.old`` (one prior generation kept); readers stitch
  ``.old`` + current back into one timeline.

Record payloads are compact JSON, one dict per framed record, tagged
``{"t": "boot" | "snap" | "event" | "close"}``.  Every record carries
the writer's ``time.monotonic()`` stamp; the boot record pairs it with
``time.time()`` so offline readers rebase the whole timeline onto the
wall clock — the same wall/mono alignment the procs-mode readiness
files and asok dump headers carry for live cross-process merges.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import uuid
from collections import deque

from ..os_store import walog

# mon config-key namespace shared by the mgr crash module, the OSD's
# revive-time report post, and the mon-side RECENT_CRASH evaluator
CRASH_KEY_PREFIX = "mgr/crash/"


def crash_id_for(entity: str, stamp: float) -> str:
    """Reference crash-id scheme: UTC timestamp + short entity hash."""
    return "%s_%s" % (
        time.strftime("%Y-%m-%d_%H:%M:%S", time.gmtime(stamp)),
        hashlib.sha1(f"{entity}{stamp}".encode()).hexdigest()[:12])


def _perf_delta(prev: dict, cur: dict) -> dict:
    """Delta two nested perf dumps: plain numbers subtract,
    ``{avgcount, sum}`` pairs subtract member-wise, histograms and
    anything non-numeric are skipped (the full dump is available live
    over the asok; the black box wants rates, not state)."""
    out: dict = {}
    for sect, counters in cur.items():
        if not isinstance(counters, dict):
            continue
        psect = prev.get(sect) or {}
        dsect = {}
        for name, val in counters.items():
            pval = psect.get(name)
            if isinstance(val, (int, float)):
                d = val - (pval if isinstance(pval, (int, float))
                           else 0)
                if d:
                    dsect[name] = round(d, 6) \
                        if isinstance(d, float) else d
            elif (isinstance(val, dict) and "avgcount" in val
                  and "sum" in val):
                pav = pval if isinstance(pval, dict) else {}
                dc = val["avgcount"] - pav.get("avgcount", 0)
                ds = val["sum"] - pav.get("sum", 0.0)
                if dc or ds:
                    dsect[name] = {"avgcount": dc,
                                   "sum": round(ds, 6)}
        if dsect:
            out[sect] = dsect
    return out


class FlightRecorder:
    """Append-only black box for one daemon.

    Thread-safe: :meth:`note` appends to a bounded deque without the
    file lock; :meth:`snap`/:meth:`event`/:meth:`close` serialize on
    one lock around the framed append.
    """

    def __init__(self, path: str, daemon: str = "?", *,
                 max_bytes: int = 1 << 20, tail_events: int = 64,
                 tail_spans: int = 64, tail_clog: int = 32,
                 enabled: bool = True):
        self.path = path
        self.daemon = daemon
        self.max_bytes = int(max_bytes)
        self.tail_events = int(tail_events)
        self.tail_spans = int(tail_spans)
        self.tail_clog = int(tail_clog)
        self.enabled = bool(enabled)
        self.nonce = uuid.uuid4().hex[:16]
        self._dirty_path = path + ".dirty"
        self._lock = threading.Lock()
        self._file = None
        self._size = 0
        self._marks: deque = deque(maxlen=4096)
        self._prev_perf: dict = {}
        # overhead accounting (bench's blackbox_overhead_pct source)
        self._records = 0
        self._bytes = 0
        self._io_s = 0.0

    # -- lifecycle --------------------------------------------------------
    def open(self) -> dict | None:
        """Start a new incarnation.  Returns the previous
        incarnation's crash info (see :func:`crash_info`) when a stale
        ``.dirty`` marker shows it died uncleanly, else ``None``."""
        prior = None
        if os.path.exists(self._dirty_path):
            prior = crash_info(self.path)
            # preserve the dead incarnation for offline readers; the
            # fresh file below starts empty
            for src, dst in ((self.path + ".old",
                              self.path + ".crash.old"),
                             (self.path, self.path + ".crash")):
                try:
                    os.replace(src, dst)
                except OSError:
                    pass
        with self._lock:
            self._file = open(self.path, "ab")
            self._size = self._file.tell()
            with open(self._dirty_path, "w") as f:
                f.write(self.nonce)
            walog.fsync_dir(self.path)
            self._append_locked({
                "t": "boot", "daemon": self.daemon,
                "nonce": self.nonce, "pid": os.getpid(),
                "wall": time.time()}, flush=True)
        return prior

    def close(self) -> None:
        """Clean shutdown: final record, drop the dirty marker."""
        with self._lock:
            if self._file is None:
                return
            self._append_locked({"t": "close"}, flush=True)
            self._file.close()
            self._file = None
            try:
                os.unlink(self._dirty_path)
            except OSError:
                pass
            walog.fsync_dir(self.path)

    # -- hot path ---------------------------------------------------------
    def note(self, name: str, **fields) -> None:
        """In-memory mark; journaled by the next :meth:`snap`.  This
        is the per-op call: one bounded deque append, no I/O."""
        if not self.enabled:
            return
        fields["n"] = name
        fields["m"] = time.monotonic()
        self._marks.append(fields)

    def event(self, name: str, **fields) -> None:
        """Durable timeline event: framed append + flush NOW.  The OS
        page cache survives SIGKILL, so an event written a microsecond
        before ``kill -9`` is readable from the corpse.  Reserved for
        rare moments (crash-imminent markers, store errors)."""
        if not self.enabled or self._file is None:
            return
        fields["t"] = "event"
        fields["name"] = name
        with self._lock:
            self._append_locked(fields, flush=True)

    def snap(self, *, spans=None, clog=None, perf=None,
             profiler=None, crash=None) -> None:
        """Periodic snapshot (ticker cadence): drains the mark ring
        and journals the recent-state tails in one framed record."""
        if not self.enabled or self._file is None:
            return
        marks = []
        while self._marks:
            try:
                marks.append(self._marks.popleft())
            except IndexError:
                break
        rec: dict = {"t": "snap"}
        if marks:
            rec["marks"] = marks[-self.tail_events:]
            rec["marks_total"] = len(marks)
        if spans:
            rec["spans"] = spans[-self.tail_spans:]
        if clog:
            rec["clog"] = clog[-self.tail_clog:]
        if perf is not None:
            delta = _perf_delta(self._prev_perf, perf)
            self._prev_perf = perf
            if delta:
                rec["perf_delta"] = delta
        if profiler:
            rec["profiler"] = profiler
        if crash:
            rec["crash_injector"] = crash
        with self._lock:
            self._append_locked(rec, flush=True)
            self._maybe_rotate_locked()

    # -- internals --------------------------------------------------------
    def _append_locked(self, rec: dict, *, flush: bool) -> None:
        if self._file is None:
            return
        rec.setdefault("mono", time.monotonic())
        t0 = time.monotonic()
        buf = walog.encode_record(
            json.dumps(rec, separators=(",", ":"),
                       default=str).encode())
        self._file.write(buf)
        if flush:
            self._file.flush()
        self._size += len(buf)
        self._records += 1
        self._bytes += len(buf)
        self._io_s += time.monotonic() - t0

    def _maybe_rotate_locked(self) -> None:
        if self._size <= self.max_bytes or self._file is None:
            return
        self._file.close()
        os.replace(self.path, self.path + ".old")
        self._file = open(self.path, "ab")
        self._size = 0
        # continuation boot record: same nonce, fresh wall/mono pair
        self._append_locked({
            "t": "boot", "daemon": self.daemon, "nonce": self.nonce,
            "pid": os.getpid(), "wall": time.time(),
            "rotated": True}, flush=True)

    def stats(self) -> dict:
        return {"path": self.path, "enabled": self.enabled,
                "nonce": self.nonce, "records": self._records,
                "bytes": self._bytes,
                "io_seconds": round(self._io_s, 6),
                "pending_marks": len(self._marks),
                "size": self._size}


# -- offline readers (no mount, no daemon) --------------------------------
def read_records(path: str) -> tuple[list[dict], dict]:
    """Parse a black box (``.old`` generation first, then current)
    into record dicts.  Returns ``(records, tail)`` where ``tail`` is
    the current file's tolerate-corrupted-tail verdict."""
    records: list[dict] = []
    for p in (path + ".old", path):
        payloads, _good, tail = walog.scan_path(p)
        for raw in payloads:
            try:
                rec = json.loads(raw)
            except ValueError:
                continue
            if isinstance(rec, dict):
                records.append(rec)
    return records, tail


def timeline(path: str) -> list[dict]:
    """Flatten a black box into chronological timeline entries, each
    stamped with a wall-clock ``stamp`` rebased from the writer's
    monotonic clock via the nearest preceding boot record."""
    records, tail = read_records(path)
    entries: list[dict] = []
    offset = 0.0

    def stamp(mono):
        return round(offset + float(mono or 0.0), 6)

    for rec in records:
        kind = rec.get("t")
        mono = rec.get("mono", 0.0)
        if kind == "boot":
            offset = float(rec.get("wall", 0.0)) - float(mono or 0.0)
            entries.append({
                "type": "boot", "stamp": stamp(mono),
                "daemon": rec.get("daemon"),
                "nonce": rec.get("nonce"), "pid": rec.get("pid"),
                "rotated": bool(rec.get("rotated"))})
        elif kind == "snap":
            for m in rec.get("marks") or []:
                e = {k: v for k, v in m.items()
                     if k not in ("n", "m")}
                e.update({"type": "mark", "name": m.get("n"),
                          "stamp": stamp(m.get("m"))})
                entries.append(e)
            summary = {"type": "snap", "stamp": stamp(mono)}
            for key in ("perf_delta", "profiler", "crash_injector"):
                if key in rec:
                    summary[key] = rec[key]
            if rec.get("spans"):
                summary["spans"] = len(rec["spans"])
            if rec.get("clog"):
                summary["clog"] = [c.get("message") if
                                   isinstance(c, dict) else c
                                   for c in rec["clog"]]
            entries.append(summary)
        elif kind == "event":
            e = {k: v for k, v in rec.items()
                 if k not in ("t", "mono")}
            e.update({"type": "event", "stamp": stamp(mono)})
            entries.append(e)
        elif kind == "close":
            entries.append({"type": "close", "stamp": stamp(mono)})
    if tail.get("status") != "clean":
        entries.append({"type": "torn_tail",
                        "stamp": entries[-1]["stamp"]
                        if entries else 0.0,
                        "tail": tail})
    return entries


def crash_info(path: str) -> dict:
    """Post-mortem summary of a dead daemon's black box: identity,
    tail of the timeline, and the last crash-imminent event if the
    injector announced one before death."""
    records, tail = read_records(path)
    boots = [r for r in records if r.get("t") == "boot"]
    last_boot = boots[-1] if boots else {}
    tl = timeline(path)
    events = [e for e in tl if e["type"] == "event"]
    crash_point = None
    for e in reversed(events):
        if e.get("name") == "crash_point":
            crash_point = {"point": e.get("point"), "n": e.get("n")}
            break
    clean = any(r.get("t") == "close" for r in records[-1:])
    return {"daemon": last_boot.get("daemon"),
            "nonce": last_boot.get("nonce"),
            "pid": last_boot.get("pid"),
            "records": len(records), "tail": tail,
            "clean_close": clean,
            "events": tl[-64:], "crash_point": crash_point}
