"""Objecter — the client op engine.

The port's copy of ``ceph_tpu.osdc.objecter``.

Reference behavior re-created (``src/osdc/Objecter.{h,cc}``; SURVEY.md
§3.8, §4.1):

- ``_calc_target``: object → PG (rjenkins str hash + ``ceph_stable_mod``
  fold) → acting primary, all computed client-side from the cached,
  subscription-updated OSDMap — no lookup service anywhere, the CRUSH
  contract;
- in-flight op tracking: every op keeps its computed target; each new
  map epoch recomputes targets and **resends** ops whose primary moved
  (or that raced an interval change and got EAGAIN), so map churn
  mid-workload loses nothing — duplicate delivery is absorbed by the
  PG-log reqid dup detection on the OSD;
- connection resets requeue every op targeted at that OSD.
"""

from __future__ import annotations

import random
import threading
import time

from ..core.tracer import Tracer
from ..mon.client import MonClient
from ..msg import Dispatcher, EntityAddr, Messenger
from ..osd import messages as M
from ..osd.osdmap import OSDMap, PGid
from ..tools.osdmaptool import shared_osdmap_from_dict


class _Op:
    __slots__ = ("tid", "pool", "oid", "ops", "on_reply", "pgid",
                 "target_osd", "attempts", "submitted", "direct",
                 "next_resend", "resend_delay", "span", "qos_client",
                 "pg_pin")

    def __init__(self, tid, pool, oid, ops, on_reply, direct=False,
                 qos_client=None):
        self.tid = tid
        self.pool = pool
        self.oid = oid
        self.ops = ops
        self.on_reply = on_reply
        self.pgid: PGid | None = None
        self.target_osd = -1
        self.attempts = 0
        self.submitted = time.monotonic()
        self.direct = direct        # skip cache-tier overlay redirect
        # a PG-addressed op (pgls) names no object: every send, the
        # resends included, goes to this PG's primary
        self.pg_pin: PGid | None = None
        # exponential-backoff resend schedule (reset on map advance)
        self.next_resend = 0.0
        self.resend_delay = 0.0
        self.span = None            # objecter op span when tracing
        self.qos_client = qos_client    # tenant tag for mClock


class BackoffRegistry:
    """Client-side mirror of the OSDs' per-PG backoffs (reference
    ``Objecter::OSDSession`` backoff map).

    Keyed ``(osd, pgid_str)``.  An entry parks every op targeting that
    (OSD, PG): ``_send_op`` and the resend ticker skip parked ops, so
    a wounded PG sees zero traffic instead of a resend storm.  Entries
    die three ways: the OSD's unblock, a map advance past the entry's
    epoch (the PG re-targets), or the safety expiry — the block/
    unblock ride the same faulty network as everything else, so a
    lost unblock must not strand ops forever.
    """

    def __init__(self, expire_s: float = 10.0):
        self.expire_s = expire_s
        self._entries: dict[tuple[int, str], dict] = {}

    def add(self, osd: int, pgid: str, bid, epoch: int) -> bool:
        """→ True if this (osd, pg) was not already blocked."""
        fresh = (osd, pgid) not in self._entries
        self._entries[(osd, pgid)] = {
            "id": bid, "epoch": epoch or 0,
            "since": time.monotonic()}
        return fresh

    def remove(self, osd: int, pgid: str, bid=None) -> bool:
        e = self._entries.get((osd, pgid))
        if e is None:
            return False
        if bid is not None and e["id"] != bid:
            return False    # stale unblock from an older block cycle
        del self._entries[(osd, pgid)]
        return True

    def blocked(self, osd: int, pgid) -> bool:
        e = self._entries.get((osd, str(pgid)))
        if e is None:
            return False
        if time.monotonic() - e["since"] > self.expire_s:
            # safety expiry: the unblock may have been lost on the
            # wire — resume (slow) resends rather than hang forever
            del self._entries[(osd, str(pgid))]
            return False
        return True

    def prune(self, epoch: int) -> list[tuple[int, str]]:
        """Map advance: drop backoffs registered under older epochs —
        the op re-targets against the new map (reference: backoffs are
        per past-interval)."""
        dead = [k for k, e in self._entries.items()
                if e["epoch"] < epoch]
        for k in dead:
            del self._entries[k]
        return dead

    def clear_osd(self, osd: int):
        for k in [k for k in self._entries if k[0] == osd]:
            del self._entries[k]

    def count(self) -> int:
        return len(self._entries)


class Objecter(Dispatcher):
    def __init__(self, monmap, entity: str = "client.objecter", *,
                 resend_interval: float = 2.0,
                 resend_max: float = 16.0,
                 resend_jitter: float = 0.25,
                 backoff_expire: float = 10.0, auth=None,
                 tracing: bool = False, tracer_ring: int = 4096,
                 tracer_sampling_rate: float = 1.0,
                 tracer_span_budget: int = 0):
        # a per-session nonce joins the entity name in every reqid:
        # two sessions of the same client name must never collide in
        # the OSDs' dup-op log (the reference's osd_reqid_t carries
        # the session GID the mon hands out at authentication)
        import uuid
        self.entity = f"{entity}:{uuid.uuid4().hex[:12]}"
        self.monc = MonClient(monmap, entity=entity, auth=auth)
        self.msgr = Messenger(
            entity, **(auth.msgr_kwargs(entity) if auth else {}))
        self.msgr.add_dispatcher(self)
        # op tracing: the root span of every client op starts here;
        # its ctx rides the MOSDOp so the OSD's spans join the trace
        self.tracer = Tracer(daemon=entity, ring_size=tracer_ring,
                             enabled=tracing,
                             sampling_rate=tracer_sampling_rate,
                             span_budget=tracer_span_budget)
        self.msgr.tracer = self.tracer
        self.osdmap = OSDMap()
        self.lock = threading.RLock()
        self._tid = 0
        self._watch_id = 0
        self.watch_cbs: dict[str, object] = {}
        self.inflight: dict[int, _Op] = {}
        self._osd_cons: dict[int, object] = {}
        # distributed-dmclock client tracker (reference src/dmclock
        # ServiceTracker): global completion counters + the snapshot
        # taken at the last send to each OSD; the difference rides
        # each MOSDOp as (delta, rho)
        self._dmc_total = 0
        self._dmc_res = 0
        self._dmc_osd_snap: dict[int, tuple[int, int]] = {}
        # per-thread tenant QoS tag: the RGW front door serves many
        # tenants over ONE objecter, so the tag rides thread-local
        # state (set around each request) and is captured onto the op
        # at submit — resends keep the original tenant attribution
        self._qos_local = threading.local()
        self._map_waiters: list[threading.Event] = []
        # server-directed backoffs (MOSDBackoff): ops targeting a
        # blocked (osd, pg) park here instead of resending.  Must
        # exist BEFORE the osdmap callback is hooked up — _on_osdmap
        # prunes it, and the first map can land on the dispatch
        # thread while __init__ is still running
        self.backoffs = BackoffRegistry(expire_s=backoff_expire)
        self.monc.on_osdmap = self._on_osdmap
        self.monc.sub_want("osdmap")
        # op resend tick: an op can be dropped server-side by an
        # interval change racing its execution (the OSD clears backend
        # state on re-peering); periodic resend makes every op
        # eventually complete — duplicates are absorbed by PG-log
        # reqid dup detection (reference: Objecter op resend +
        # osd_op_complaint/backoff machinery)
        self._resend_interval = resend_interval
        self._resend_max = resend_max
        self._resend_jitter = resend_jitter
        self._rng = random.Random()
        self._stop = threading.Event()
        self._ticker = threading.Thread(
            target=self._resend_loop, name=f"{entity}-resend",
            daemon=True)
        self._ticker.start()

    @staticmethod
    def _idempotent(op) -> bool:
        """Writes dedup via reqid and reads are harmless to repeat;
        `notify` re-delivers to every watcher on each send, so it may
        only be resent when its target actually moved (the old
        primary can no longer complete it)."""
        return not any(o.get("op") == "notify" for o in op.ops)

    def _next_resend(self, op: _Op, now: float):
        """Advance the op's exponential-backoff resend schedule:
        delay doubles per periodic resend up to resend_max, with
        ±jitter so a wounded cluster's retries decorrelate instead of
        arriving in fixed-period volleys."""
        op.resend_delay = min(
            max(op.resend_delay, self._resend_interval) * 2,
            self._resend_max)
        spread = 1.0 + self._resend_jitter * (
            2.0 * self._rng.random() - 1.0)
        op.next_resend = now + op.resend_delay * spread

    def _reset_resend(self, op: _Op, now: float | None = None):
        """New information arrived (map advance, unblock, reset):
        resend promptly again and restart the backoff ramp."""
        now = time.monotonic() if now is None else now
        op.resend_delay = self._resend_interval
        op.next_resend = now + self._resend_interval

    def _resend_loop(self):
        # tick finer than the base interval: backoff deadlines and
        # expiring server backoffs land between interval multiples
        tick = min(0.25, self._resend_interval / 2)
        while not self._stop.wait(tick):
            now = time.monotonic()
            with self.lock:
                for op in list(self.inflight.values()):
                    if now < op.next_resend:
                        continue
                    if self.backoffs.blocked(op.target_osd, op.pgid):
                        continue    # parked: the server said stop
                    pgid, primary = self._op_target(op)
                    moved = (pgid != op.pgid
                             or primary != op.target_osd)
                    if moved or self._idempotent(op):
                        op.submitted = now
                        self._next_resend(op, now)
                        self._send_op(op)

    def wait_for_osdmap(self, min_epoch: int = 1, timeout: float = 10.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self.lock:
                if self.osdmap.epoch >= min_epoch:
                    return
            time.sleep(0.02)
        raise TimeoutError("no osdmap")

    def shutdown(self):
        self._stop.set()
        self.monc.shutdown()
        self.msgr.shutdown()

    # -- map flow ----------------------------------------------------------
    def _on_osdmap(self, epoch: int, map_dict: dict, newest: int = 0):
        with self.lock:
            if epoch <= self.osdmap.epoch:
                return
            self.osdmap = shared_osdmap_from_dict(map_dict)
            # a map advance releases backoffs from older epochs: the
            # blocked PG re-targets under the new map (and the OSD
            # re-blocks us if it still can't serve)
            self.backoffs.prune(epoch)
            # epoch-driven resend (reference Objecter::handle_osd_map
            # → _scan_requests): every in-flight op re-targets and
            # resends on a map advance — OSDs silently drop ops from
            # older intervals, and dup detection makes the resend
            # idempotent, so eager resend beats waiting for the
            # periodic ticker
            for op in list(self.inflight.values()):
                self._reset_resend(op)      # fresh info: restart ramp
                if self._idempotent(op):
                    self._send_op(op)       # re-targets internally
                else:
                    pgid, primary = self._op_target(op)
                    if pgid != op.pgid or primary != op.target_osd:
                        self._send_op(op)
            for ev in self._map_waiters:
                ev.set()
            self._map_waiters.clear()

    # -- target computation ------------------------------------------------
    def _calc_target(self, pool: int, oid: str) -> tuple[PGid, int]:
        raw = self.osdmap.object_locator_to_pg(oid, pool)
        pgid = self.osdmap.raw_pg_to_pg(raw)
        _up, _upp, _acting, primary = \
            self.osdmap.pg_to_up_acting_osds(pgid)
        return pgid, primary

    def _op_target(self, op: _Op) -> tuple[PGid, int]:
        """The op's PG and primary under the current map: its pinned
        PG for a PG-addressed op, else the PG its name hashes to."""
        if op.pg_pin is not None:
            return op.pg_pin, self.osdmap.pg_to_up_acting_osds(
                op.pg_pin)[3]
        return self._calc_target(
            self._effective_pool(op.pool, op.direct), op.oid)

    # -- submission --------------------------------------------------------
    def set_qos_tag(self, tag: str | None):
        """Tag every op submitted from THIS thread with a tenant/uid
        for mClock client classification (None clears).  The tag is
        per-thread, not per-objecter: a concurrent gateway sets it
        after auth and clears it in the worker's finally."""
        self._qos_local.tag = tag

    def get_qos_tag(self) -> str | None:
        return getattr(self._qos_local, "tag", None)

    def op_submit(self, pool: int, oid: str, ops: list[dict],
                  on_reply, direct: bool = False) -> int:
        with self.lock:
            self._tid += 1
            op = _Op(self._tid, pool, oid, list(ops), on_reply,
                     direct=direct, qos_client=self.get_qos_tag())
            op.span = self.tracer.start_span(
                f"objecter_op:{oid}",
                tags={"layer": "objecter", "pool": pool,
                      "ops": ",".join(str(o.get("op")) for o in op.ops)})
            self._reset_resend(op, op.submitted)
            self.inflight[op.tid] = op
            self._send_op(op)
            return op.tid

    def _effective_pool(self, pool: int, direct: bool) -> int:
        """Cache-tier overlay redirect (reference Objecter
        _calc_target read_tier/write_tier handling): client ops on a
        base pool with an overlay land on the cache pool.  Resolved
        per send, so map-change resends re-honor it; `direct` (the
        tiering agent / flush path) bypasses it."""
        if direct:
            return pool
        p = self.osdmap.pools.get(pool)
        if p is not None and p.read_tier >= 0 \
                and p.read_tier in self.osdmap.pools:
            return p.read_tier
        return pool

    def _send_op(self, op: _Op):
        # the CRUSH mapping itself is a traced child: per-send so
        # resends show their (possibly new) target computation
        cspan = None if op.span is None else self.tracer.start_span(
            "crush_map", parent=op.span, tags={"layer": "crush"})
        pgid, primary = self._op_target(op)
        if cspan is not None:
            cspan.set_tag("pgid", str(pgid))
            cspan.set_tag("primary", primary)
            cspan.finish()
        op.pgid, op.target_osd = pgid, primary
        if primary >= 0 and self.backoffs.blocked(primary, pgid):
            if op.span is not None:
                op.span.event("backoff_parked")
            return   # parked: released by unblock / map advance
        op.attempts += 1
        if op.span is not None and op.attempts > 1:
            op.span.event(f"resend:{op.attempts - 1}")
        if primary < 0:
            return   # no primary this epoch: wait for the next map
        con = self._osd_con(primary)
        if con is None:
            return
        pool = self.osdmap.pools.get(op.pool)
        snapc = None
        if pool is not None and pool.snap_seq:
            snapc = {"seq": pool.snap_seq,
                     "snaps": sorted(pool.snaps, reverse=True)}
        st, sr = self._dmc_osd_snap.get(primary, (0, 0))
        dmc = {"delta": max(1, self._dmc_total - st),
               "rho": max(1, self._dmc_res - sr)}
        self._dmc_osd_snap[primary] = (self._dmc_total, self._dmc_res)
        try:
            con.send_message(M.MOSDOp(
                tid=op.tid, client=self.entity, pgid=str(pgid),
                oid=op.oid, epoch=self.osdmap.epoch, ops=op.ops,
                flags=0, snapc=snapc, dmc=dmc,
                qos_client=op.qos_client,
                trace=None if op.span is None else op.span.ctx()))
        except ConnectionError:
            self._osd_cons.pop(primary, None)

    def _osd_con(self, osd: int):
        addr_s = self.osdmap.osd_addrs.get(osd)
        if not addr_s:
            return None
        cached = self._osd_cons.get(osd)
        if cached is not None:
            cached_addr, con = cached
            if cached_addr == addr_s and not con._closed:
                return con
            con.mark_down()   # stale incarnation: reconnect fresh
        host, _, port = addr_s.rpartition(":")
        con = self.msgr.connect_to_lazy(EntityAddr(host, int(port)))
        self._osd_cons[osd] = (addr_s, con)
        return con

    # -- replies -----------------------------------------------------------
    def ms_dispatch(self, msg) -> bool:
        if isinstance(msg, M.MOSDBackoff):
            peer = getattr(msg.connection, "peer_name", None) or ""
            try:
                osd = int(peer.rsplit(".", 1)[1])
            except (IndexError, ValueError):
                return True     # not an osd session; stale/garbled
            with self.lock:
                if msg.op == "block":
                    self.backoffs.add(osd, msg.pgid, msg.id,
                                      msg.epoch or 0)
                    for op in self.inflight.values():
                        if op.span is not None and \
                                op.target_osd == osd and \
                                str(op.pgid) == msg.pgid:
                            op.span.event("backoff_block")
                else:
                    if self.backoffs.remove(osd, msg.pgid, msg.id):
                        # released: resend everything parked on this
                        # (osd, pg) right away — non-idempotent ops
                        # included, since a backoff means the server
                        # dropped the op without executing it (same
                        # unconditional-resend precedent as
                        # ms_handle_reset)
                        now = time.monotonic()
                        for op in list(self.inflight.values()):
                            if op.target_osd == osd and \
                                    str(op.pgid) == msg.pgid:
                                op.submitted = now
                                self._reset_resend(op, now)
                                self._send_op(op)
            return True
        if isinstance(msg, M.MWatchNotify):
            # a notify fired on an object this client watches: run the
            # registered callback, ack back up the same connection
            # (reference watch/notify client protocol)
            cb = self.watch_cbs.get(msg.watch_id)
            reply = None
            if cb is not None:
                try:
                    reply = cb(msg.notify_id, msg.oid,
                               bytes.fromhex(msg.data or ""))
                except Exception:
                    reply = None
            try:
                msg.connection.send_message(M.MWatchNotifyAck(
                    oid=msg.oid, pgid=msg.pgid,
                    notify_id=msg.notify_id, watch_id=msg.watch_id,
                    reply=reply if isinstance(reply, (str, int,
                                                      type(None)))
                    else str(reply)))
            except (ConnectionError, AttributeError):
                pass
            return True
        if not isinstance(msg, M.MOSDOpReply):
            return False
        with self.lock:
            op = self.inflight.get(msg.tid)
            if op is None:
                return True
            if msg.rc == -11:
                # wrong/new primary: retry after the next map (or a
                # short delay if our map is already newer)
                if msg.epoch is not None and \
                        msg.epoch > self.osdmap.epoch:
                    return True   # our map push will trigger resend
                t = threading.Timer(0.1, self._retry, args=(msg.tid,))
                t.daemon = True
                t.start()
                return True
            del self.inflight[msg.tid]
            # dmclock feedback: count exactly one completion per
            # LOGICAL op (a duplicate reply from a resend race finds
            # the op already gone above and must not inflate the next
            # delta/rho)
            self._dmc_total += 1
            if getattr(msg, "dmc_phase", None) == "reservation":
                self._dmc_res += 1
        if op.span is not None:
            # the reply echoes the OSD-side span ctx: nest the
            # client's receive under the server's op span when
            # present so the cross-daemon trace reads send→serve→recv
            rspan = self.tracer.start_span(
                "wire_recv",
                parent=getattr(msg, "trace", None) or op.span,
                tags={"layer": "wire", "rc": msg.rc})
            if rspan is not None:
                rspan.finish()
            op.span.set_tag("rc", msg.rc)
            op.span.set_tag("attempts", op.attempts)
            op.span.finish()
        op.on_reply(msg.rc, msg.outs, msg.results,
                    tuple(msg.version or (0, 0)))
        return True

    def _retry(self, tid: int):
        with self.lock:
            op = self.inflight.get(tid)
            if op is not None:
                self._send_op(op)

    def ms_handle_reset(self, con):
        with self.lock:
            victims = [o for o, (_a, c) in self._osd_cons.items()
                       if c is con]
            now = time.monotonic()
            for o in victims:
                del self._osd_cons[o]
                # backoffs are per-session state on the OSD; a reset
                # session's blocks are gone with it
                self.backoffs.clear_osd(o)
            for op in self.inflight.values():
                if op.target_osd in victims:
                    self._reset_resend(op, now)
                    self._send_op(op)

    # -- sync convenience --------------------------------------------------
    def operate(self, pool: int, oid: str, ops: list[dict],
                timeout: float = 10.0, direct: bool = False):
        """→ (rc, outs, results, version) with resend-until-timeout."""
        ev = threading.Event()
        box: list = []

        def on_reply(rc, outs, results, version):
            box.append((rc, outs, results, version))
            ev.set()

        tid = self.op_submit(pool, oid, ops, on_reply, direct=direct)
        if not ev.wait(timeout):
            with self.lock:
                op = self.inflight.pop(tid, None)
                if op is not None and op.span is not None:
                    op.span.set_tag("timeout", True)
                    op.span.finish()
            raise TimeoutError(
                f"osd op on {oid!r} (pool {pool}) timed out")
        return box[0]
