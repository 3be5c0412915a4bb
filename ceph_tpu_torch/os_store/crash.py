"""Seeded power-loss injection for the durable OSD data path.

The port's copy of ``ceph_tpu.os_store.crash``.

The storage-side twin of ``msg/fault.py``: where the fault fabric
decides deterministically whether a *message* is dropped, the
``CrashInjector`` decides whether the OSD "loses power" at a named
point inside the WAL commit pipeline.  The verdict for occurrence
``n`` of point ``p`` is a pure function of ``(seed, osd, p, n)`` —
the same seed replays the identical crash schedule, and ``preview()``
computes the schedule without consuming it, so a test can predict
exactly which append will die before running the workload.

Crash points, in pipeline order (what stable storage keeps at each):

- ``pre_append``            — power cut before the record is written:
                              the log keeps only the fsynced prefix.
- ``mid_record``            — cut partway through the append: the
                              fsynced prefix plus a *torn* record
                              fragment that recovery must discard.
- ``post_append_pre_fsync`` — record written but still in page cache:
                              gone, same surviving bytes as pre_append.
- ``post_fsync_pre_apply``  — record is durable but the crash lands
                              before the in-memory apply: replay must
                              surface it (durable-but-unacked is the
                              one legal "extra" state).
- ``mid_compaction``        — cut after the checkpoint temp file is
                              written but before the rename: the old
                              log must remain authoritative.
- ``kill9``                 — process death, not power loss: in procs
                              mode the store SIGKILLs its own process
                              before the next append, so the page
                              cache (every appended record) survives
                              and only in-memory state is lost; in
                              threaded mode it degrades to the
                              pre_append power cut.
"""

from __future__ import annotations

import random

from .objectstore import StoreError

CRASH_POINTS = (
    "pre_append",
    "mid_record",
    "post_append_pre_fsync",
    "post_fsync_pre_apply",
    "mid_compaction",
    "kill9",
)


class SimulatedPowerLoss(StoreError):
    """Raised out of the store when an injected crash point fires: the
    process-level stand-in for the node going dark mid-commit."""


class CrashInjector:
    """Deterministic, seeded power-loss scheduler for one OSD's store.

    ``decide(point)`` consumes one occurrence and returns the verdict;
    ``preview(point, count)`` returns upcoming verdicts without
    consuming anything; ``arm(point, n)`` forces occurrence ``n`` of
    ``point`` to fire regardless of probability — the sweep tests use
    arming for exact placement and probabilities for soak-style runs.
    """

    def __init__(self, seed: int = 0, osd: str = "?"):
        self.seed = int(seed)
        self.osd = str(osd)
        self.probs: dict[str, float] = {}
        self.counters: dict[str, int] = {p: 0 for p in CRASH_POINTS}
        self.fired: list[tuple[str, int]] = []
        self._armed: set[tuple[str, int]] = set()

    # -- configuration ------------------------------------------------
    @staticmethod
    def _check_point(point: str) -> str:
        if point not in CRASH_POINTS:
            raise ValueError(
                f"unknown crash point {point!r}; one of {CRASH_POINTS}")
        return point

    def arm(self, point: str, n: int | None = None) -> None:
        """Force occurrence ``n`` of ``point`` to crash (default: the
        next one)."""
        self._check_point(point)
        if n is None:
            n = self.counters[point]
        self._armed.add((point, int(n)))

    def disarm(self, point: str | None = None) -> None:
        if point is None:
            self._armed.clear()
        else:
            self._armed = {a for a in self._armed if a[0] != point}

    def set_prob(self, point: str, prob: float) -> None:
        self.probs[self._check_point(point)] = float(prob)

    # -- verdicts -----------------------------------------------------
    def _verdict(self, point: str, n: int) -> bool:
        # pure in (seed, osd, point, n): no shared RNG stream, so the
        # schedule is immune to reordering of other points' traffic
        if (point, n) in self._armed:
            return True
        prob = self.probs.get(point, 0.0)
        if prob <= 0.0:
            return False
        return random.Random(
            f"{self.seed}|{self.osd}|{point}|{n}").random() < prob

    def decide(self, point: str) -> bool:
        """Consume one occurrence of ``point``; True means crash now."""
        self._check_point(point)
        n = self.counters[point]
        self.counters[point] = n + 1
        verdict = self._verdict(point, n)
        if verdict:
            self.fired.append((point, n))
        return verdict

    def preview(self, point: str, count: int = 1,
                start: int | None = None) -> list[bool]:
        """Verdicts for occurrences ``start..start+count`` of ``point``
        without advancing any counter (default start: current
        counter)."""
        self._check_point(point)
        if start is None:
            start = self.counters[point]
        return [self._verdict(point, n) for n in range(start, start + count)]

    def describe(self) -> dict:
        return {
            "seed": self.seed,
            "osd": self.osd,
            "probs": dict(self.probs),
            "armed": sorted(self._armed),
            "counters": dict(self.counters),
            "fired": list(self.fired),
        }
