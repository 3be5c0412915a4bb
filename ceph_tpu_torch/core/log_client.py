"""Daemon-side cluster log (reference ``src/common/LogClient.cc``).

The port's copy of ``ceph_tpu.core.log_client``.

Every daemon keeps a small local ring of clog entries and batches the
unsent tail to the monitor as an ``MLog`` message — the mon's
``LogMonitor`` commits them through paxos and serves
``ceph log last [n]``.  Transport failures are tolerated: entries
stay queued and ride the next flush (the reference resends
unacknowledged log entries the same way).
"""

from __future__ import annotations

import collections
import threading
import time

PRIO = ("debug", "info", "warn", "error")


class LogClient:
    """Ring + batched ``MLog`` uplink.

    ``send_fn`` takes one message (typically ``MonClient.send``); it
    may raise on a down mon — the batch is requeued.
    """

    def __init__(self, name: str, send_fn=None, *,
                 channel: str = "cluster", ring_size: int = 100):
        self.name = name
        self.channel = channel
        self.send_fn = send_fn
        self._ring: collections.deque = collections.deque(
            maxlen=max(1, int(ring_size)))
        self._pending: list[dict] = []
        self._lock = threading.Lock()

    # -- producers ------------------------------------------------------

    def do_log(self, prio: str, text: str,
               channel: str | None = None) -> dict:
        entry = {"stamp": time.time(), "name": self.name,
                 "channel": channel or self.channel,
                 "prio": prio if prio in PRIO else "info",
                 "text": str(text)}
        with self._lock:
            self._ring.append(entry)
            self._pending.append(entry)
        return entry

    def debug(self, text: str) -> dict:
        return self.do_log("debug", text)

    def info(self, text: str) -> dict:
        return self.do_log("info", text)

    def warn(self, text: str) -> dict:
        return self.do_log("warn", text)

    def error(self, text: str) -> dict:
        return self.do_log("error", text)

    def audit(self, text: str, prio: str = "info") -> dict:
        """Entry on the ``audit`` channel (reference LogChannel
        ``audit`` — administrative actions, kept in the mon's
        separate audit ring)."""
        return self.do_log(prio, text, channel="audit")

    # -- uplink ---------------------------------------------------------

    def flush(self) -> int:
        """Send the pending batch; returns entries shipped (0 if the
        mon is unreachable — they stay pending)."""
        with self._lock:
            if not self._pending or self.send_fn is None:
                return 0
            batch, self._pending = self._pending, []
        from ..mon import messages as M      # lazy: core below mon
        try:
            self.send_fn(M.MLog(entries=batch))
        except (ConnectionError, OSError):
            with self._lock:
                self._pending = batch + self._pending
            return 0
        return len(batch)

    # -- inspection -----------------------------------------------------

    def last(self, n: int = 20) -> list[dict]:
        with self._lock:
            return list(self._ring)[-max(0, int(n)):]
