"""Threading primitives: Throttle, SafeTimer, Finisher, thread pools.

The port's copy of ``ceph_tpu.core.threading_utils``.

Reference behavior re-created (``src/common/Throttle.cc``,
``src/common/Timer.cc``, ``src/common/Finisher.{h,cc}``,
``src/common/WorkQueue.{h,cc}``; SURVEY.md §3.1):

- `Throttle`: a counted budget; `get(c)` blocks while the budget is
  exhausted, `put(c)` releases — backpressure for in-flight bytes/ops;
- `SafeTimer`: schedule callables at a deadline, cancelable, one
  dispatch thread;
- `Finisher`: completions queue drained by a dedicated thread so I/O
  threads never run user callbacks;
- `ShardedThreadPool`: N workers, work sharded by key (PG-affinity in
  the OSD: one shard's items run in submission order).
"""

from __future__ import annotations

import heapq
import itertools
import queue
import threading
import time
from typing import Callable


class Throttle:
    def __init__(self, name: str, max_: int):
        self.name = name
        self._max = max_
        self._count = 0
        self._cv = threading.Condition()

    def get(self, c: int = 1, timeout: float | None = None) -> bool:
        """Block until c units fit under max (c > max is allowed through
        alone, as the reference does for oversized requests)."""
        with self._cv:
            deadline = None if timeout is None else time.monotonic() + \
                timeout
            while self._count > 0 and self._count + c > self._max:
                remain = None if deadline is None else \
                    deadline - time.monotonic()
                if remain is not None and remain <= 0:
                    return False
                self._cv.wait(remain)
            self._count += c
            return True

    def get_or_fail(self, c: int = 1) -> bool:
        with self._cv:
            if self._count > 0 and self._count + c > self._max:
                return False
            self._count += c
            return True

    def put(self, c: int = 1):
        with self._cv:
            self._count -= c
            if self._count < 0:
                raise ValueError(f"throttle {self.name} underflow")
            self._cv.notify_all()

    @property
    def current(self) -> int:
        return self._count

    def past_midpoint(self) -> bool:
        return self._count >= self._max / 2


class SafeTimer:
    def __init__(self, name: str = "timer"):
        self._heap: list = []
        self._counter = itertools.count()
        self._cv = threading.Condition()
        self._stop = False
        self._cancelled: set[int] = set()
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def add_event_after(self, delay: float, cb: Callable[[], None]) -> int:
        return self.add_event_at(time.monotonic() + delay, cb)

    def add_event_at(self, when: float, cb: Callable[[], None]) -> int:
        with self._cv:
            token = next(self._counter)
            heapq.heappush(self._heap, (when, token, cb))
            self._cv.notify()
            return token

    def cancel_event(self, token: int) -> bool:
        with self._cv:
            for (_, t, _cb) in self._heap:
                if t == token:
                    self._cancelled.add(token)
                    return True
            return False

    def shutdown(self):
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=5)

    def _run(self):
        while True:
            with self._cv:
                while not self._stop and (
                        not self._heap
                        or self._heap[0][0] > time.monotonic()):
                    if self._stop:
                        break
                    timeout = None if not self._heap else max(
                        self._heap[0][0] - time.monotonic(), 0)
                    self._cv.wait(timeout)
                if self._stop:
                    return
                when, token, cb = heapq.heappop(self._heap)
                if token in self._cancelled:
                    self._cancelled.discard(token)
                    continue
            try:
                cb()
            except Exception:  # noqa: BLE001 — timer thread must survive
                import traceback
                traceback.print_exc()


class Finisher:
    def __init__(self, name: str = "finisher"):
        self._q: queue.Queue = queue.Queue()
        self._drained = threading.Condition()
        self._inflight = 0
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._stop = False
        self._thread.start()

    def queue(self, cb: Callable[[], None]):
        with self._drained:
            self._inflight += 1
        self._q.put(cb)

    def wait_for_empty(self, timeout: float | None = None) -> bool:
        with self._drained:
            return self._drained.wait_for(
                lambda: self._inflight == 0, timeout)

    def shutdown(self):
        self._stop = True
        self._q.put(None)
        self._thread.join(timeout=5)

    def _run(self):
        while True:
            cb = self._q.get()
            if cb is None and self._stop:
                return
            try:
                if cb is not None:
                    cb()
            except Exception:  # noqa: BLE001
                import traceback
                traceback.print_exc()
            finally:
                with self._drained:
                    self._inflight -= 1
                    if self._inflight == 0:
                        self._drained.notify_all()


class ShardedThreadPool:
    """N workers; items are sharded by key so one shard executes in
    order (the OSD's PG-affine op queue shape)."""

    def __init__(self, num_shards: int = 4, name: str = "tp"):
        self.num_shards = num_shards
        self._queues = [queue.Queue() for _ in range(num_shards)]
        self._threads = []
        self._stop = False
        self._drained = threading.Condition()
        self._inflight = 0
        for i in range(num_shards):
            t = threading.Thread(target=self._run, args=(i,),
                                 name=f"{name}-{i}", daemon=True)
            t.start()
            self._threads.append(t)

    def queue(self, shard_key, fn: Callable[[], None]):
        shard = hash(shard_key) % self.num_shards
        with self._drained:
            self._inflight += 1
        self._queues[shard].put(fn)

    def wait_for_empty(self, timeout: float | None = None) -> bool:
        with self._drained:
            return self._drained.wait_for(
                lambda: self._inflight == 0, timeout)

    def shutdown(self):
        self._stop = True
        for q in self._queues:
            q.put(None)
        for t in self._threads:
            t.join(timeout=5)

    def _run(self, shard: int):
        q = self._queues[shard]
        while True:
            fn = q.get()
            if fn is None and self._stop:
                return
            try:
                if fn is not None:
                    fn()
            except Exception:  # noqa: BLE001
                import traceback
                traceback.print_exc()
            finally:
                with self._drained:
                    self._inflight -= 1
                    if self._inflight == 0:
                        self._drained.notify_all()
