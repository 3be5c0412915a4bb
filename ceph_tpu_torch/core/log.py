"""Subsystem logging with a crash-dump ring — the dout/Log analog.

The port's copy of ``ceph_tpu.core.log``.

Reference behavior re-created (``src/log/Log.{h,cc}``,
``src/common/dout.h``, ``src/common/subsys.h``; SURVEY.md §3.1/§6.5):

- per-subsystem (level, gather_level) pairs: entries above `level` are
  not printed but entries up to `gather_level` are still RECORDED in a
  bounded in-memory ring, dumped on crash or on demand — the "recent
  events" post-mortem that makes field debugging possible;
- cheap level check before formatting (the dout macro's gate);
- pluggable sink (stderr/file/callback) so daemons and tests differ
  only in sink.
"""

from __future__ import annotations

import collections
import sys
import threading
import time
import traceback
from dataclasses import dataclass

DEFAULT_SUBSYS = {
    # name: (level, gather_level) — mirrors the reference's defaults
    # pattern (print little, gather more)
    "none": (0, 5),
    "ec": (1, 5),
    "crush": (1, 5),
    "osd": (1, 5),
    "ms": (0, 5),
    "mon": (1, 5),
    "paxos": (1, 5),
    "client": (1, 5),
    "objecter": (0, 5),
    "mds": (1, 5),
    "rgw": (1, 5),
    "rbd": (1, 5),
    "mgr": (1, 5),
    "tpu": (1, 5),
}


@dataclass
class Entry:
    stamp: float
    subsys: str
    level: int
    thread: str
    message: str

    def format(self) -> str:
        ts = time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(self.stamp))
        frac = f"{self.stamp % 1:.6f}"[1:]
        return (f"{ts}{frac} {self.thread} {self.level:2d} "
                f"{self.subsys}: {self.message}")


class Log:
    def __init__(self, ring_size: int = 10000, sink=None):
        self._subsys = dict(DEFAULT_SUBSYS)
        self._ring: collections.deque[Entry] = collections.deque(
            maxlen=ring_size)
        self._lock = threading.Lock()
        self._sink = sink if sink is not None else sys.stderr

    # -- levels ------------------------------------------------------------
    def set_level(self, subsys: str, level: int,
                  gather: int | None = None):
        cur = self._subsys.get(subsys, (1, 5))
        self._subsys[subsys] = (level, cur[1] if gather is None else gather)

    def should_log(self, subsys: str, level: int) -> bool:
        lvl, gather = self._subsys.get(subsys, (1, 5))
        return level <= max(lvl, gather)

    # -- emit --------------------------------------------------------------
    def dout(self, subsys: str, level: int, message: str):
        lvl, gather = self._subsys.get(subsys, (1, 5))
        if level > lvl and level > gather:
            return
        entry = Entry(time.time(), subsys, level,
                      threading.current_thread().name, str(message))
        with self._lock:
            self._ring.append(entry)
        if level <= lvl:
            print(entry.format(), file=self._sink)

    def derr(self, subsys: str, message: str):
        self.dout(subsys, -1, message)

    # -- post-mortem -------------------------------------------------------
    def dump_recent(self, out=None) -> int:
        """Flush the gathered ring (crash handler / `log dump` admin
        command).  Returns number of entries dumped."""
        out = out if out is not None else self._sink
        with self._lock:
            entries = list(self._ring)
            self._ring.clear()
        print(f"--- begin dump of recent events ({len(entries)}) ---",
              file=out)
        for e in entries:
            print(e.format(), file=out)
        print("--- end dump of recent events ---", file=out)
        return len(entries)

    def install_crash_handler(self):
        """Dump the ring on unhandled exceptions (signal_handler.cc's
        role, scoped to what a Python process can intercept)."""
        prev = sys.excepthook

        def hook(tp, value, tb):
            print("".join(traceback.format_exception(tp, value, tb)),
                  file=self._sink)
            self.dump_recent()
            prev(tp, value, tb)

        sys.excepthook = hook


_global_log: Log | None = None


def global_log() -> Log:
    global _global_log
    if _global_log is None:
        _global_log = Log()
    return _global_log


def dout(subsys: str, level: int, message: str):
    global_log().dout(subsys, level, message)
