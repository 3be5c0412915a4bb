"""MonitorDBStore — the mon's durable versioned KV store.

The port's copy of ``ceph_tpu.mon.store``.

Reference behavior re-created (``src/mon/MonitorDBStore.h``; SURVEY.md
§3.4): a prefixed KV store (one namespace per service: "paxos",
"osdmap", "auth", ...) with atomic multi-op transactions, backing both
Paxos state (proposals, commit points) and each service's versioned
maps.  The reference sits on RocksDB; here: an in-memory dict + an
append-only write-ahead log replayed on open — same atomicity
contract (a transaction is one WAL record, applied all-or-nothing).

Records use the CRC-framed format shared with the OSD's ``WALStore``
(``os_store/walog.py``), so the torn/corrupt-tail recovery rule is one
implementation across both daemons: open scans forward, stops at the
first damaged frame, truncates the damage away, and ``replay_stats``
reports what was recovered.
"""

from __future__ import annotations

import base64
import json
import os
import threading

from ..os_store import walog


class StoreTransaction:
    def __init__(self):
        self.ops: list[tuple[str, str, str, bytes | None]] = []

    def put(self, prefix: str, key, value):
        if isinstance(value, str):
            value = value.encode()
        elif isinstance(value, (int, float)):
            value = str(value).encode()
        self.ops.append(("put", prefix, str(key), bytes(value)))
        return self

    def erase(self, prefix: str, key):
        self.ops.append(("erase", prefix, str(key), None))
        return self

    def erase_range(self, prefix: str, first, last):
        """erase keys in [first, last) — used for trim."""
        self.ops.append(("erase_range", prefix, str(first),
                         str(last).encode()))
        return self

    def empty(self) -> bool:
        return not self.ops


class MonitorDBStore:
    def __init__(self, path: str | None = None, *, sync: bool = True):
        """path=None ⇒ volatile (tests); else `path` is the WAL file."""
        self._data: dict[str, dict[str, bytes]] = {}
        self._lock = threading.Lock()
        self._path = path
        self._sync = sync
        self._wal = None
        self.replay_stats: dict | None = None
        if path is not None:
            if os.path.exists(path):
                self._replay(path)
            self._wal = open(path, "ab")

    # -- durability --------------------------------------------------------
    def _replay(self, path: str):
        payloads, good_off, tail = walog.scan_path(path)
        for payload in payloads:
            self._apply(json.loads(payload.decode()))
        if tail["status"] != "clean":
            # shared torn-tail rule: the last good record wins; drop
            # the damage before this process appends after it
            walog.truncate_tail(path, good_off)
        self.replay_stats = {"records": len(payloads),
                             "tail": dict(tail)}

    def _apply(self, rec):
        for op in rec:
            kind, prefix, key = op[0], op[1], op[2]
            table = self._data.setdefault(prefix, {})
            if kind == "put":
                table[key] = base64.b64decode(op[3])
            elif kind == "erase":
                table.pop(key, None)
            elif kind == "erase_range":
                last = base64.b64decode(op[3]).decode()
                for k in [k for k in table
                          if _natural(key) <= _natural(k) < _natural(last)]:
                    table.pop(k)

    def apply_transaction(self, t: StoreTransaction):
        rec = []
        for kind, prefix, key, value in t.ops:
            rec.append([kind, prefix, key,
                        base64.b64encode(value).decode()
                        if value is not None else None])
        with self._lock:
            if self._wal is not None:
                self._wal.write(walog.encode_record(
                    json.dumps(rec, separators=(",", ":")).encode()))
                self._wal.flush()
                if self._sync:
                    os.fsync(self._wal.fileno())
            self._apply(rec)

    def close(self):
        if self._wal is not None:
            self._wal.close()
            self._wal = None

    # -- reads -------------------------------------------------------------
    def get(self, prefix: str, key) -> bytes | None:
        with self._lock:
            return self._data.get(prefix, {}).get(str(key))

    def get_str(self, prefix: str, key) -> str | None:
        v = self.get(prefix, key)
        return v.decode() if v is not None else None

    def get_int(self, prefix: str, key, default: int = 0) -> int:
        v = self.get(prefix, key)
        return int(v) if v is not None else default

    def exists(self, prefix: str, key) -> bool:
        return self.get(prefix, key) is not None

    def keys(self, prefix: str) -> list[str]:
        with self._lock:
            return sorted(self._data.get(prefix, {}), key=_natural)


def _natural(k: str):
    """Version keys are ints-as-strings; sort them numerically."""
    return (0, int(k)) if k.lstrip("-").isdigit() else (1, k)
