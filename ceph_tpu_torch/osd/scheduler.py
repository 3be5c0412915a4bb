"""Op schedulers — priority dequeue of OSD work.

The port's copy of ``ceph_tpu.osd.scheduler``.

Reference behavior re-created (``src/osd/scheduler/OpScheduler.h``,
``src/osd/scheduler/mClockScheduler.cc`` + ``src/dmclock/``,
``src/common/WeightedPriorityQueue.h``; SURVEY.md §3.5): incoming work
is classified (client ops, peer sub-ops, recovery, scrub, background)
and drained by a scheduler that keeps recovery storms from burying
client I/O.  Two flavors behind ``osd_op_queue``:

- **wpq** (`WeightedPriorityQueue`): deterministic weighted
  round-robin — each class accrues credit += weight per dequeue
  round, the non-empty class with the most credit is served and pays
  cost 1.  Within a class, FIFO.

- **mclock** (`MClockScheduler`): dmclock-style QoS.  Every op gets
  three tags at arrival — reservation (spaced 1/res apart: the
  guaranteed minimum rate), proportional (spaced 1/weight: the excess
  share), limit (spaced 1/lim: the cap).  Dequeue serves, in order:
  any op whose reservation tag is due (earliest first — this is what
  makes the minimum unconditionally hold under adverse load), else
  the earliest proportional tag among classes not past their limit.
  Peering traffic bypasses QoS entirely (the control plane IS the
  failure detector's dependency; the reference gives it
  ``op_scheduler_class::immediate``).
"""

from __future__ import annotations

import collections
import threading
import time

# priority classes (reference op_scheduler_class)
CLIENT = "client"          # MOSDOp
SUBOP = "subop"            # replication / EC sub-writes + reads
PEERING = "peering"        # maps/queries/notifies/logs — never starved
RECOVERY = "recovery"      # pushes/pulls/backfill
SCRUB = "scrub"            # scrub maps

DEFAULT_WEIGHTS = {
    PEERING: 1000,          # control plane preempts everything
    CLIENT: 63,
    SUBOP: 63,
    RECOVERY: 5,
    SCRUB: 2,
}


class WeightedPriorityQueue:
    """Blocking multi-class queue with weighted fair dequeue."""

    def __init__(self, weights: dict[str, int] | None = None):
        self.weights = dict(weights or DEFAULT_WEIGHTS)
        self._queues: dict[str, collections.deque] = {
            c: collections.deque() for c in self.weights}
        self._credit: dict[str, float] = {c: 0.0 for c in self.weights}
        self._cv = threading.Condition()
        self._closed = False

    def enqueue(self, klass: str, item, **_dmc_ignored):
        with self._cv:
            if klass not in self._queues:
                self._queues[klass] = collections.deque()
                self._credit[klass] = 0.0
                self.weights.setdefault(klass, 1)
            self._queues[klass].append(item)
            self._cv.notify()

    def dequeue(self, timeout: float | None = None):
        """→ (class, item) or None on timeout/close."""
        with self._cv:
            while True:
                nonempty = [c for c, q in self._queues.items() if q]
                if nonempty:
                    for c in nonempty:
                        self._credit[c] += self.weights[c]
                    best = max(nonempty, key=lambda c: self._credit[c])
                    self._credit[best] -= sum(
                        self.weights[c] for c in nonempty)
                    return best, self._queues[best].popleft()
                if self._closed:
                    return None
                if not self._cv.wait(timeout):
                    return None

    def account(self, klass: str, cost: float = 1.0):
        """Charge out-of-band work to a class (the batch engine's
        reconstruct-lane flushes bypass the queue — the device work
        already happened — but must still debit the class's fair
        share so subsequent queued work of that class defers)."""
        with self._cv:
            if klass not in self._credit:
                self._queues.setdefault(klass, collections.deque())
                self.weights.setdefault(klass, 1)
                self._credit[klass] = 0.0
            self._credit[klass] -= float(cost)

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def __len__(self):
        with self._cv:
            return sum(len(q) for q in self._queues.values())

    def depths(self) -> dict[str, int]:
        with self._cv:
            return {c: len(q) for c, q in self._queues.items() if q}


_MCLOCK_FALLBACK = (0.0, 1.0, 0.0)      # unknown classes: weight-only
_INF = float("inf")


def default_mclock_profiles() -> dict[str, tuple[float, float,
                                                 float]]:
    """The balanced profile, read from the option-table defaults so
    there is exactly ONE source of truth for the per-class
    (res ops/s, weight, limit ops/s) triples (0 ⇒ no reservation /
    no limit): client and replication sub-ops share the bulk,
    recovery gets a floor so it always makes progress but a ceiling
    so a storm cannot take over, scrub is best-effort."""
    from ..core.config import ConfigProxy
    from ..core.options import build_options
    return profiles_from_config(ConfigProxy(build_options()))


class MClockScheduler:
    """dmclock single-server scheduler with the same blocking-queue
    surface as `WeightedPriorityQueue` (enqueue/dequeue/close/len/
    depths), so the OSD op worker is scheduler-agnostic.

    `clock` is injectable so tests drive virtual time and assert the
    reservation/limit behavior deterministically.
    """

    @staticmethod
    def _normalize(profiles):
        """dmclock invariant: reservation ≤ limit.  The reservation
        path serves whenever its tag is due, bypassing the limit
        check, so res > lim would silently void the cap — clamp to
        keep the operator's ceiling authoritative."""
        out = {}
        for klass, (res, wgt, lim) in profiles.items():
            if lim > 0:
                res = min(res, lim)
            out[klass] = (res, wgt, lim)
        return out

    def __init__(self,
                 profiles: dict[str, tuple[float, float, float]]
                 | None = None,
                 clock=time.monotonic,
                 client_qos: dict[str, tuple[float, float, float]]
                 | None = None):
        self.profiles = self._normalize(
            profiles or default_mclock_profiles())
        # per-tenant overrides inside the CLIENT class (reference
        # dmclock's per-client ClientInfo, exposed upstream through
        # rgw qos / the mclock client profiles): a tenant named here
        # gets its own (res, wgt, lim) — including a PRIVATE limit
        # stream, so capping an aggressor tenant never throttles the
        # victim sharing the class
        self.client_qos = self._normalize(dict(client_qos or {}))
        self._client_lim_prev: dict[str, float] = {}
        self.clock = clock
        # per (class, client): deque of (r_tag, p_tag, l_tag, item)
        # — distributed dmclock tracks R/P tags per client within a
        # class (reference dmclock ClientRec); client None = the
        # class-wide anonymous stream (sub-ops, recovery, scrub).
        # The LIMIT stream stays per CLASS: the operator's ceiling is
        # a class budget and must not multiply with client count.
        self._queues: dict[tuple, collections.deque] = {}
        self._prev: dict[tuple, tuple[float, float]] = {}
        self._lim_prev: dict[str, float] = {}
        self._last_seen: dict[tuple, float] = {}
        self._peering: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._closed = False

    # idle per-client state is erased after this long (reference
    # dmclock ClientRec idle/erase ages) — without it, every client
    # entity ever seen leaves a tag tuple and an empty deque behind
    IDLE_PURGE_S = 60.0

    def enqueue(self, klass: str, item, client=None, delta: int = 1,
                rho: int = 1):
        """`delta`/`rho` are the distributed-dmclock feedback: how
        many of this client's requests completed ANYWHERE (delta) /
        under reservation anywhere (rho) since its last request to
        this server.  The tags advance by rho/res and delta/weight —
        a client already getting its reservation from other servers
        progresses its reservation tag here faster, so the aggregate
        reserved rate across servers stays ≈ res instead of res × N
        (reference src/dmclock TagCalc)."""
        with self._cv:
            if klass == PEERING:
                self._peering.append(item)
                self._cv.notify()
                return
            now = self.clock()
            res, wgt, lim = self.profiles.get(klass, _MCLOCK_FALLBACK)
            override = (klass == CLIENT
                        and client in self.client_qos)
            if override:
                res, wgt, lim = self.client_qos[client]
            key = (klass, client)
            pr, pp = self._prev.get(key, (-_INF, -_INF))
            pl = (self._client_lim_prev.get(client, -_INF) if override
                  else self._lim_prev.get(klass, -_INF))
            delta = max(int(delta), 1)
            rho = max(int(rho), 1)
            r = max(now, pr + rho / res) if res > 0 else _INF
            p = max(now, pp + delta / max(wgt, 1e-9))
            lt = max(now, pl + 1.0 / lim) if lim > 0 else 0.0
            self._prev[key] = (r if res > 0 else pr, p)
            if override:
                self._client_lim_prev[client] = lt
            else:
                self._lim_prev[klass] = lt
            self._last_seen[key] = now
            self._queues.setdefault(key,
                                    collections.deque()).append(
                (r, p, lt, item))
            self._cv.notify()

    def _pick(self, now: float):
        """→ (klass, item) to serve now, or (None, wake_at)."""
        if self._peering:
            return PEERING, self._peering.popleft()
        best_r = best_p = None
        wake = _INF
        stale = []
        for key, q in self._queues.items():
            if not q:
                if now - self._last_seen.get(key, now) \
                        > self.IDLE_PURGE_S:
                    stale.append(key)
                continue
            r_tag, p_tag, l_tag, _ = q[0]
            # the class-wide limit gates BOTH phases: per-client
            # reservations must not aggregate past the operator's
            # class ceiling (deviation from pure dmclock, where the
            # reservation bypasses the limit — there the limit is
            # per-client too)
            if l_tag <= now and r_tag <= now:
                if best_r is None or r_tag < best_r[0]:
                    best_r = (r_tag, key)
            elif r_tag < _INF:
                wake = min(wake, max(r_tag, min(l_tag, _INF)))
            if l_tag <= now:
                if best_p is None or p_tag < best_p[0]:
                    best_p = (p_tag, key)
            else:
                wake = min(wake, l_tag)
        for key in stale:       # erase idle per-client state
            del self._queues[key]
            self._prev.pop(key, None)
            self._last_seen.pop(key, None)
            if key[0] == CLIENT:
                self._client_lim_prev.pop(key[1], None)
        choice = best_r or best_p
        if choice is None:
            return None, wake
        key = choice[1]
        _, _, _, item = self._queues[key].popleft()
        self._last_seen[key] = now
        # report which phase served the op (reference PhaseType in
        # the dmclock response): the client tracker turns it into rho
        try:
            item._dmc_phase = ("reservation" if choice is best_r
                               else "priority")
        except AttributeError:
            pass        # plain tuples/ints in unit tests
        return key[0], item

    def dequeue(self, timeout: float | None = None):
        """→ (class, item) or None on timeout/close."""
        deadline = (None if timeout is None
                    else self.clock() + timeout)
        with self._cv:
            while True:
                now = self.clock()
                klass, item_or_wake = self._pick(now)
                if klass is not None:
                    return klass, item_or_wake
                if self._closed and not len(self):
                    return None
                if deadline is not None and now >= deadline:
                    return None
                # sleep until the earliest due tag, the deadline, or a
                # new arrival — whichever first (wake > now holds: any
                # due tag would have been picked above)
                waits = [w - now for w in (item_or_wake, deadline)
                         if w is not None and w < _INF]
                self._cv.wait(min(waits) if waits else None)

    def account(self, klass: str, cost: float = 1.0):
        """Charge ``cost`` completed-elsewhere ops to a class's QoS
        streams (reference: dmclock's delta/rho feedback, here fed by
        the batch engine's reconstruct-lane flushes).  The class limit
        tag and the anonymous stream's reservation/proportional tags
        advance by cost/rate, so NEW arrivals of that class space out
        as if the lane's megabatch had been served from the queue —
        already-queued items keep the tags they got at enqueue."""
        with self._cv:
            if klass == PEERING or cost <= 0:
                return
            now = self.clock()
            res, wgt, lim = self.profiles.get(klass, _MCLOCK_FALLBACK)
            if lim > 0:
                pl = self._lim_prev.get(klass, -_INF)
                self._lim_prev[klass] = max(now, pl) + cost / lim
            key = (klass, None)
            pr, pp = self._prev.get(key, (-_INF, -_INF))
            if res > 0:
                pr = max(now, pr) + cost / res
            pp = max(now, pp) + cost / max(wgt, 1e-9)
            self._prev[key] = (pr, pp)
            self._last_seen[key] = now
            self._cv.notify_all()

    def reload_profiles(self, profiles: dict[str, tuple[float, float,
                                                        float]]):
        """Apply new QoS triples to a LIVE scheduler (runtime
        `config set osd_mclock_scheduler_*`).  Already-queued ops
        keep their tags; new arrivals use the new spacing (max(now,
        prev+1/rate) re-converges immediately)."""
        with self._cv:
            self.profiles.update(self._normalize(profiles))
            self._cv.notify_all()

    def set_client_qos(self, client_qos: dict[str, tuple[float, float,
                                                         float]]):
        """Replace the per-tenant override map on a live scheduler
        (runtime `config set osd_mclock_scheduler_client_qos`).
        Tenants dropped from the map fall back to the class-wide
        triple; their private limit stream is forgotten."""
        with self._cv:
            self.client_qos = self._normalize(dict(client_qos))
            for c in list(self._client_lim_prev):
                if c not in self.client_qos:
                    del self._client_lim_prev[c]
            self._cv.notify_all()

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def __len__(self):
        with self._cv:
            return (len(self._peering)
                    + sum(len(q) for q in self._queues.values()))

    def depths(self) -> dict[str, int]:
        with self._cv:
            d: dict[str, int] = {}
            for (c, _client), q in self._queues.items():
                if q:
                    d[c] = d.get(c, 0) + len(q)
            if self._peering:
                d[PEERING] = len(self._peering)
            return d


def profiles_from_config(config) -> dict[str, tuple[float, float,
                                                    float]]:
    """Read the osd_mclock_scheduler_* option family."""
    out = {}
    for klass, opt in ((CLIENT, "client"), (SUBOP, "subop"),
                       (RECOVERY, "recovery"), (SCRUB, "scrub")):
        out[klass] = (
            float(config.get(f"osd_mclock_scheduler_{opt}_res")),
            float(config.get(f"osd_mclock_scheduler_{opt}_wgt")),
            float(config.get(f"osd_mclock_scheduler_{opt}_lim")))
    return out


def client_qos_from_config(config) -> dict[str, tuple[float, float,
                                                      float]]:
    """Parse osd_mclock_scheduler_client_qos: JSON
    ``{tenant: [res, wgt, lim]}``.  Untrusted operator input —
    malformed JSON or triples degrade to no overrides / skip the
    entry rather than killing the daemon."""
    import json
    text = str(config.get("osd_mclock_scheduler_client_qos") or "")
    if not text.strip():
        return {}
    try:
        raw = json.loads(text)
    except ValueError:
        return {}
    out = {}
    if isinstance(raw, dict):
        for tenant, triple in raw.items():
            try:
                res, wgt, lim = (float(triple[0]), float(triple[1]),
                                 float(triple[2]))
            except (TypeError, ValueError, IndexError, KeyError):
                continue
            out[str(tenant)] = (res, wgt, lim)
    return out


def make_op_queue(config):
    """The `osd_op_queue` seam (reference OpScheduler::make_scheduler):
    the option enum is honest — "mclock" builds the QoS scheduler,
    and the osd_mclock_scheduler_* knobs stay live via config
    observers (a `config set` on a running daemon retunes the queue,
    matching the reference's runtime-adjustable dmclock options)."""
    kind = config.get("osd_op_queue")
    if kind == "mclock":
        q = MClockScheduler(profiles_from_config(config),
                            client_qos=client_qos_from_config(config))

        def _retune(_name, _val):
            q.reload_profiles(profiles_from_config(config))

        def _retune_qos(_name, _val):
            q.set_client_qos(client_qos_from_config(config))

        for opt in ("client", "subop", "recovery", "scrub"):
            for suffix in ("res", "wgt", "lim"):
                config.add_observer(
                    f"osd_mclock_scheduler_{opt}_{suffix}", _retune)
        config.add_observer("osd_mclock_scheduler_client_qos",
                            _retune_qos)
        return q
    return WeightedPriorityQueue()
