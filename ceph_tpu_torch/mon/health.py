"""HealthMonitor — structured, diffable, mutable cluster health.

The port's copy of ``ceph_tpu.mon.health``.

Reference behavior re-created (``src/mon/HealthMonitor.{h,cc}``,
``src/mon/health_check.h``; SURVEY.md §3.4): health is a set of
registered **checks**, each an evaluator producing
``{code, severity(WARN/ERR), summary, detail[], count}``.  The
service re-evaluates on the leader's tick, diffs against the previous
committed report and, on transitions, emits cluster-log entries
(``Health check failed: …`` / ``Health check cleared: …``) plus an
event-stream push; every mon keeps a bounded history ring served by
``ceph health history``.

Mutes (``ceph health mute <code> [ttl] [--sticky]``) are persisted
through the mon store: a muted check drops out of the ``HEALTH_*``
rollup but still rides the report flagged ``muted``.  Non-sticky
mutes auto-expire when the check clears or worsens (count increase),
sticky ones only on TTL expiry or explicit unmute — the reference's
semantics.

``evaluate_checks`` is a pure function of a ``HealthContext`` so
bench.py can time a 4k-OSD evaluation without a Monitor.
"""

from __future__ import annotations

import collections
import json
import time

from ..osd.osdmap import CLUSTER_FLAGS
from .pgmap import PG_STALE_GRACE, LegacyPGMap, PGMap  # noqa: F401
from .service import PaxosService

# PG_NOT_SCRUBBED: warn when a PG's effective scrub stamp is older
# than this (reference: osd_scrub_interval × mon_warn ratio).  Module
# constants so tests can shrink them without threading config through
# the pure evaluators.
SCRUB_WARN_INTERVAL = 1.5 * 86400.0
NEARFULL_RATIO = 0.85    # OSD_NEARFULL: bytes_used / bytes_total
# RECENT_CRASH: unarchived crash reports younger than this warn
# (reference mgr/crash warn_recent_interval: two weeks)
RECENT_CRASH_AGE = 14 * 86400.0
# SLO_BURN_RATE / TELEMETRY_ANOMALY: the mgr alerts module posts
# firing alerts into this config-key namespace (the crash-report
# pattern) and the evaluators below read them back — so alerts get
# mutes, TTLs, `ceph -w` transitions and history for free
ALERT_KEY_PREFIX = "alerts/"


# -- evaluators --------------------------------------------------------------

class HealthContext:
    """Everything one health evaluation reads, decoupled from the
    Monitor so checks stay pure functions (and benchable at synthetic
    scale)."""

    def __init__(self, *, osdmap, pgmap: PGMap, monmap_ranks=(),
                 quorum=(), crashes=(), alerts=(),
                 now: float | None = None):
        self.osdmap = osdmap
        self.pgmap = pgmap
        self.monmap_ranks = list(monmap_ranks)
        self.quorum = list(quorum)
        # crash-report summaries from the mgr/crash config-key
        # namespace: {"entity", "timestamp", "archived"} each
        self.crashes = list(crashes)
        # firing mgr alerts from the alerts/ config-key namespace:
        # {"name", "check", "severity", "summary", "firing"} each
        self.alerts = list(alerts)
        self.now = time.time() if now is None else now
        self.total_pgs = sum(p.pg_num for p in osdmap.pools.values())
        self.states = pgmap.states(total_expected=self.total_pgs,
                                   now=self.now)


CHECKS: list = []


def health_check(fn):
    """Register an evaluator: HealthContext → check dict or None."""
    CHECKS.append(fn)
    return fn


def _check(code, severity, summary, detail, count=None):
    return {"code": code, "severity": severity, "summary": summary,
            "detail": list(detail),
            "count": len(detail) if count is None else int(count)}


@health_check
def _mon_down(ctx):
    quorum = set(ctx.quorum)
    absent = [r for r in ctx.monmap_ranks if r not in quorum]
    if not absent or not quorum:
        return None
    return _check(
        "MON_DOWN", "WARN",
        f"{len(absent)}/{len(ctx.monmap_ranks)} mons out of quorum",
        [f"mon.{r} not in quorum" for r in absent])


@health_check
def _osd_down(ctx):
    m = ctx.osdmap
    down = [o for o in range(m.max_osd)
            if m.exists(o) and not m.is_up(o)]
    if not down:
        return None
    return _check("OSD_DOWN", "WARN", f"{len(down)} osds down",
                  [f"osd.{o} down" for o in down])


@health_check
def _osd_store_error(ctx):
    # OSD_STORE_ERROR: an OSD's backing store failed a WAL append or
    # fsync (ENOSPC, injected power loss) — it degraded to EIO-and-
    # mark-down instead of crashing, and its last stats report carries
    # the error string.  ERR severity: acked durability is gone on
    # that OSD until an operator intervenes (fsck, mkfs, replace).
    bad = [(o, st["store_error"])
           for o, st in sorted(ctx.pgmap.osd_stats.items())
           if st.get("store_error")]
    if not bad:
        return None
    return _check(
        "OSD_STORE_ERROR", "ERR",
        f"{len(bad)} osd(s) with objectstore write failures",
        [f"osd.{o}: {err}" for o, err in bad])


@health_check
def _slow_ops(ctx):
    # SLOW_OPS: OSDs report op_tracker slow-op counts in their
    # osd_stats (reference health check of the same name) — per-OSD
    # attribution + the worst blocked age cluster-wide
    m = ctx.osdmap
    slow_osds = []
    for o, st in sorted(ctx.pgmap.osd_stats.items()):
        if ctx.now - st.get("stamp", 0.0) > PG_STALE_GRACE and \
                not (o < m.max_osd and m.is_up(o)):
            continue    # dead OSD's last report: not "slow"
        s = st.get("slow_ops") or {}
        if int(s.get("count", 0)) > 0:
            slow_osds.append((o, int(s["count"]),
                              float(s.get("oldest_age", 0.0)),
                              s.get("oldest_desc", "")))
    if not slow_osds:
        return None
    n_slow = sum(c for _o, c, _a, _d in slow_osds)
    worst = max(a for _o, _c, a, _d in slow_osds)
    return _check(
        "SLOW_OPS", "WARN",
        f"{n_slow} slow ops, oldest one blocked for {worst:.0f} sec, "
        "daemons [" + ",".join(f"osd.{o}" for o, _c, _a, _d
                               in slow_osds) + "] have slow ops",
        [f"osd.{o}: {c} slow ops, oldest {a:.1f}s"
         + (f" ({d})" if d else "")
         for o, c, a, d in slow_osds],
        count=n_slow)


@health_check
def _osdmap_flags(ctx):
    m = ctx.osdmap
    flags_set = sorted(n for n, bit in CLUSTER_FLAGS.items()
                       if m.flags & bit)
    if not flags_set:
        return None
    return _check("OSDMAP_FLAGS", "WARN",
                  f"{','.join(flags_set)} flag(s) set",
                  [f"{f} is set" for f in flags_set])


@health_check
def _pool_full(ctx):
    m = ctx.osdmap
    full_pools = [n for n, pid in m.pool_name.items()
                  if m.pools[pid].full]
    if not full_pools:
        return None
    return _check("POOL_FULL", "WARN",
                  f"{len(full_pools)} pool(s) over quota",
                  [f"pool '{n}' is full (quota)"
                   for n in sorted(full_pools)])


@health_check
def _pg_degraded(ctx):
    degraded = {s: n for s, n in ctx.states.items()
                if "active" in s and "clean" not in s}
    if not degraded:
        return None
    return _check("PG_DEGRADED", "WARN",
                  f"{sum(degraded.values())} pgs not clean",
                  [f"{n} pgs {s}" for s, n in sorted(degraded.items())],
                  count=sum(degraded.values()))


@health_check
def _pg_availability(ctx):
    unhealthy = {s: n for s, n in ctx.states.items()
                 if s not in ("active", "active+clean")}
    stuck = {s: n for s, n in unhealthy.items()
             if s.split("+")[0] in ("peering", "incomplete",
                                    "down", "stale", "unknown")}
    if not stuck:
        return None
    return _check("PG_AVAILABILITY", "WARN",
                  f"{sum(stuck.values())} pgs stuck "
                  f"({'/'.join(sorted(stuck))})",
                  [f"{n} pgs {s}" for s, n in sorted(stuck.items())],
                  count=sum(stuck.values()))


@health_check
def _pg_damaged(ctx):
    # scrub found inconsistencies that repair has not cleared yet —
    # the one stock ERR-severity check (reference PG_DAMAGED).  Both
    # PGMap flavors expose the reduction; the dict fallback keeps
    # duck-typed stand-ins working.
    dmg = getattr(ctx.pgmap, "damaged", None)
    if dmg is not None:
        bad = dmg()
    else:
        bad = sorted((pgid, int(st.get("scrub_errors", 0)))
                     for pgid, st in ctx.pgmap.pg_stats.items()
                     if int(st.get("scrub_errors", 0)) > 0)
    if not bad:
        return None
    total = sum(n for _pgid, n in bad)
    return _check("PG_DAMAGED", "ERR",
                  f"{len(bad)} pgs inconsistent "
                  f"({total} scrub errors)",
                  [f"pg {pgid} has {n} scrub errors"
                   for pgid, n in bad],
                  count=total)


@health_check
def _degraded_stretch_mode(ctx):
    # stretch cluster lost (or is recovering from losing) a site:
    # min_size was dropped so writes continue on the survivors
    # (reference DEGRADED_STRETCH_MODE / RECOVERING_STRETCH_MODE)
    m = ctx.osdmap
    if not getattr(m, "degraded_stretch_mode", False):
        return None
    recovering = bool(getattr(m, "recovering_stretch_mode", False))
    site = getattr(m, "stretch_degraded_site", "") or "?"
    if recovering:
        summary = (f"stretch mode recovering: site '{site}' is back, "
                   "waiting for PGs to go clean")
        detail = [f"site '{site}' rejoined; full replication will be "
                  "restored once recovery completes"]
    else:
        summary = (f"stretch cluster degraded: site '{site}' is down, "
                   "writes continue at reduced min_size")
        detail = [f"no OSD of site '{site}' is up"]
    return _check("DEGRADED_STRETCH_MODE", "WARN", summary, detail,
                  count=1)


@health_check
def _pg_not_scrubbed(ctx):
    # effective stamp (max of last scrub and PG creation) reported by
    # the primary; never-reported PGs are PG_AVAILABILITY's problem.
    # SCRUB_WARN_INTERVAL is read at call time (tests monkeypatch it)
    # and passed into the masked reduction.
    sl = getattr(ctx.pgmap, "scrub_late", None)
    if sl is not None:
        late = sl(ctx.now, SCRUB_WARN_INTERVAL)
    else:
        late = sorted(
            (pgid, ctx.now - float(st["last_scrub_stamp"]))
            for pgid, st in ctx.pgmap.pg_stats.items()
            if st.get("last_scrub_stamp") is not None
            and ctx.now - float(st["last_scrub_stamp"])
            > SCRUB_WARN_INTERVAL)
    if not late:
        return None
    return _check(
        "PG_NOT_SCRUBBED", "WARN",
        f"{len(late)} pgs not scrubbed in time",
        [f"pg {pgid} not scrubbed for {age:.0f}s"
         for pgid, age in late])


@health_check
def _osd_nearfull(ctx):
    m = ctx.osdmap
    near = []
    for o, st in sorted(ctx.pgmap.osd_stats.items()):
        if ctx.now - st.get("stamp", 0.0) > PG_STALE_GRACE and \
                not (o < m.max_osd and m.is_up(o)):
            continue    # dead OSD's last report: capacity is moot
        total = int(st.get("bytes_total", 0))
        if total <= 0:
            continue
        ratio = int(st.get("bytes_used", 0)) / total
        if ratio >= NEARFULL_RATIO:
            near.append((o, ratio))
    if not near:
        return None
    return _check(
        "OSD_NEARFULL", "WARN",
        f"{len(near)} nearfull osd(s)",
        [f"osd.{o} is near full ({r:.0%} used)" for o, r in near])


@health_check
def _recent_crash(ctx):
    # RECENT_CRASH (reference mgr/crash health check): unarchived
    # crash reports younger than the warn window.  `ceph crash
    # archive`/`archive-all` stamps them silent; old reports age out.
    recent = [c for c in getattr(ctx, "crashes", ())
              if not c.get("archived")
              and ctx.now - float(c.get("timestamp") or 0.0)
              < RECENT_CRASH_AGE]
    if not recent:
        return None
    entities = sorted({c.get("entity", "?") for c in recent})
    return _check(
        "RECENT_CRASH", "WARN",
        f"{len(recent)} daemon crash(es) in recent history",
        [f"{c.get('entity', '?')} crashed at "
         f"{c.get('timestamp')}" for c in recent],
        count=len(entities))


def _alert_check(ctx, code: str, what: str):
    """Shared evaluator for the mgr-alert-fed checks: group the
    firing alerts of one check code into a single health check whose
    severity is the worst member's."""
    firing = [a for a in getattr(ctx, "alerts", ())
              if a.get("firing") and a.get("check") == code]
    if not firing:
        return None
    severity = ("ERR" if any(a.get("severity") == "ERR"
                             for a in firing) else "WARN")
    return _check(
        code, severity,
        f"{len(firing)} {what} alert(s) firing",
        [f"{a.get('name', '?')}: {a.get('summary', '')}"
         for a in sorted(firing, key=lambda a: a.get("name", ""))])


@health_check
def _slo_burn_rate(ctx):
    return _alert_check(ctx, "SLO_BURN_RATE", "SLO burn-rate")


@health_check
def _telemetry_anomaly(ctx):
    return _alert_check(ctx, "TELEMETRY_ANOMALY", "telemetry-anomaly")


def evaluate_checks(ctx: HealthContext) -> list[dict]:
    """Run every registered evaluator; order is registration order
    (stable, so reports diff cleanly)."""
    out = []
    for fn in CHECKS:
        chk = fn(ctx)
        if chk is not None:
            out.append(chk)
    return out


def rollup(checks: list[dict]) -> str:
    status = "HEALTH_OK"
    for c in checks:
        if c.get("severity") == "ERR":
            return "HEALTH_ERR"
        status = "HEALTH_WARN"
    return status


def _code_states(report) -> dict:
    out = {}
    for c in (report or {}).get("checks") or []:
        out[c["code"]] = ("active", c)
    for c in (report or {}).get("muted") or []:
        out[c["code"]] = ("muted", c)
    return out


def diff_reports(old, new) -> list[dict]:
    """Per-code transitions between two reports → history/event
    entries (no stamps; the observer stamps on arrival)."""
    evs = []
    o, n = _code_states(old), _code_states(new)
    status = (new or {}).get("status", "HEALTH_OK")
    for code in sorted(set(o) | set(n)):
        ost = o.get(code, (None, None))[0]
        nst, chk = n.get(code, (None, None))
        if ost == nst:
            continue
        if nst is None:
            chk = o[code][1]
            state = "cleared"
        elif ost is None:
            state = "failed" if nst == "active" else "muted"
        else:
            state = "muted" if nst == "muted" else "unmuted"
        evs.append({"code": code,
                    "severity": chk.get("severity", "WARN"),
                    "state": state,
                    "summary": chk.get("summary", ""),
                    "status": status})
    return evs


# -- the service -------------------------------------------------------------

class HealthMonitor(PaxosService):
    NAME = "health"
    HISTORY_MAX = 128
    # count/summary-only refreshes (ages ticking up, recovery counts
    # draining) re-stage at most this often; transitions (code set,
    # rollup or mute changes) always stage immediately
    REFRESH_INTERVAL = 2.0

    def __init__(self, mon):
        super().__init__(mon)
        self.report: dict | None = None
        self.mutes: dict[str, dict] = {}
        self.history: collections.deque = collections.deque(
            maxlen=self.HISTORY_MAX)
        self._last_staged = 0.0

    # -- committed-state refresh (every quorum member) -------------------

    def update_from_store(self):
        blob = self.mon.store.get_str(self.prefix, "mutes")
        self.mutes = json.loads(blob) if blob else {}
        blob = self.mon.store.get_str(self.prefix, "report")
        new = json.loads(blob) if blob else None
        if new is None or new == self.report:
            return
        old, self.report = self.report, new
        now = time.time()
        for ev in diff_reports(old, new):
            ev["stamp"] = now
            self.history.append(ev)
            self.mon.push_event("health", ev)
        if new.get("status") != (old or {}).get("status"):
            # rollup transition as its own record: a watcher awaiting
            # HEALTH_OK keys off data["status"] without parsing codes
            self.mon.push_event("health", {
                "stamp": now, "state": "rollup", "code": None,
                "severity": None, "summary": "",
                "status": new.get("status")})

    def on_election_start(self):
        # a reaped-but-uncommitted mute edit died with the proposal
        # queue: fall back to the committed copy
        super().on_election_start()
        blob = self.mon.store.get_str(self.prefix, "mutes")
        self.mutes = json.loads(blob) if blob else {}
        self._last_staged = 0.0

    # -- evaluation (leader) ---------------------------------------------

    def _context(self, now: float) -> HealthContext:
        mon = self.mon
        osdmap = mon.services["osdmap"].osdmap
        mon.pgmap.prune(set(osdmap.pools))
        return HealthContext(
            osdmap=osdmap, pgmap=mon.pgmap,
            monmap_ranks=mon.monmap.ranks(),
            quorum=mon.elector.quorum or [],
            crashes=self._crash_summaries(),
            alerts=self._alert_summaries(), now=now)

    def _crash_summaries(self) -> list[dict]:
        """Crash-report summaries straight off the committed
        config-key store (the mgr crash module's namespace) — the
        RECENT_CRASH feed needs no mgr round-trip."""
        from ..core.flight_recorder import CRASH_KEY_PREFIX
        cfg = self.mon.services.get("config")
        if cfg is None:
            return []
        out = []
        for key in self.mon.store.keys(cfg.prefix):
            if not key.startswith(CRASH_KEY_PREFIX):
                continue
            blob = self.mon.store.get_str(cfg.prefix, key)
            try:
                rep = json.loads(blob or "")
            except ValueError:
                continue
            if isinstance(rep, dict):
                out.append({"entity": rep.get("entity"),
                            "timestamp": rep.get("timestamp"),
                            "archived": rep.get("archived")})
        return out

    def _alert_summaries(self) -> list[dict]:
        """Firing mgr alerts off the committed config-key store (the
        alerts module's namespace) — the SLO_BURN_RATE /
        TELEMETRY_ANOMALY feed needs no mgr round-trip."""
        cfg = self.mon.services.get("config")
        if cfg is None:
            return []
        out = []
        for key in self.mon.store.keys(cfg.prefix):
            if not key.startswith(ALERT_KEY_PREFIX):
                continue
            blob = self.mon.store.get_str(cfg.prefix, key)
            try:
                rep = json.loads(blob or "")
            except ValueError:
                continue
            if isinstance(rep, dict):
                out.append(rep)
        return out

    def _compose(self, checks: list[dict]) -> dict:
        active, muted = [], []
        for c in checks:
            m = self.mutes.get(c["code"])
            if m:
                muted.append(dict(c, muted=True, mute=dict(m)))
            else:
                active.append(c)
        return {"status": rollup(active), "checks": active,
                "muted": muted}

    def _reap_mutes(self, now: float, checks: list[dict]) -> bool:
        """TTL expiry always unmutes; non-sticky mutes also die when
        the check clears or worsens past the muted count."""
        codes = {c["code"]: c for c in checks}
        changed = False
        for code, m in list(self.mutes.items()):
            expires = float(m.get("expires") or 0)
            if expires and now >= expires:
                del self.mutes[code]
                changed = True
            elif not m.get("sticky"):
                if code not in codes:
                    del self.mutes[code]
                    changed = True
                elif int(codes[code].get("count", 0)) > \
                        int(m.get("count") or 0):
                    del self.mutes[code]
                    changed = True
        return changed

    def _evaluate_and_stage(self, now: float, *, force: bool = False):
        checks = evaluate_checks(self._context(now))
        mutes_changed = self._reap_mutes(now, checks)
        report = self._compose(checks)
        if report == self.report and not mutes_changed and not force:
            return
        old = self.report
        significant = (
            force or mutes_changed or old is None
            or report["status"] != old["status"]
            or {c["code"] for c in report["checks"]} !=
               {c["code"] for c in old["checks"]}
            or {c["code"] for c in report.get("muted", [])} !=
               {c["code"] for c in old.get("muted", [])})
        if not significant and \
                now - self._last_staged < self.REFRESH_INTERVAL:
            return
        self._last_staged = now
        if mutes_changed:
            self.stage("put", "mutes", json.dumps(self.mutes))
        self.stage("put", "report", json.dumps(report))
        entries = []
        for ev in diff_reports(old, report):
            text = {
                "failed": f"Health check failed: {ev['code']} "
                          f"({ev['summary']})",
                "cleared": f"Health check cleared: {ev['code']}",
                "muted": f"Health check muted: {ev['code']}",
                "unmuted": f"Health check unmuted: {ev['code']}",
            }[ev["state"]]
            prio = "info" if ev["state"] != "failed" else \
                ("error" if ev["severity"] == "ERR" else "warn")
            entries.append({"stamp": now,
                            "name": f"mon.{self.mon.rank}",
                            "channel": "cluster", "prio": prio,
                            "text": text})
        if old is not None and old["status"] != "HEALTH_OK" and \
                report["status"] == "HEALTH_OK":
            entries.append({"stamp": now,
                            "name": f"mon.{self.mon.rank}",
                            "channel": "cluster", "prio": "info",
                            "text": "Cluster is now healthy"})
        if entries:
            # stages on the log service and proposes (both services'
            # pending ops ride out as their own paxos values)
            self.mon.services["log"]._stage_entries(entries)
        else:
            self.mon.propose()

    def tick(self):
        self._evaluate_and_stage(time.time())

    # -- commands --------------------------------------------------------

    def _live_report(self) -> dict:
        """A fresh evaluation composed with the current mutes.

        ``ceph health``/``status`` must never lag the PG state they
        are rendered next to: the committed report only advances on
        the tick→paxos path, so under load a cluster that just went
        clean could still serve the stale WARN for a beat.  Reads
        stay read-only (no staging/propose here — a proposal would
        make the audit detector classify ``health`` as mutating);
        transitions, history, and the event stream still key off the
        committed copy in ``_evaluate_and_stage``."""
        return self._compose(evaluate_checks(self._context(time.time())))

    def dispatch_command(self, cmd):
        prefix = cmd.get("prefix", "")
        if prefix == "pg dump":
            self.mon.pgmap.prune(
                set(self.mon.services["osdmap"].osdmap.pools))
            # materialized plain dicts: the reply is JSON-encoded on
            # the wire, and the array PGMap's view doesn't serialize
            pgm = self.mon.pgmap
            stats = pgm.dump() if hasattr(pgm, "dump") else \
                {k: dict(v) for k, v in pgm.pg_stats.items()}
            return 0, "", {"pg_stats": stats,
                           "osd_stats": {
                               str(o): s for o, s in
                               pgm.osd_stats.items()}}
        if prefix == "pg summary":
            # the O(pools + offenders) aggregate the mgr-side loops
            # (exporter scrapes, progress/telemetry ticks) consume
            # instead of materializing a full per-PG dump
            m = self.mon.services["osdmap"].osdmap
            total_pgs = sum(p.pg_num for p in m.pools.values())
            out = self.mon.pgmap.summary(
                live_pools=set(m.pools), now=time.time(),
                total_expected=total_pgs)
            names = {str(pid): name
                     for name, pid in m.pool_name.items()}
            for pid, row in out.get("pools", {}).items():
                if pid in names:
                    row["name"] = names[pid]
            return 0, "", out
        if prefix == "pg list-inconsistent-obj":
            # the `rados list-inconsistent-obj` backend: the primary's
            # last scrub report as carried by MPGStats into the PGMap
            pgid = str(cmd.get("pgid", ""))
            st = self.mon.pgmap.pg_stats.get(pgid)
            if st is None:
                return -2, f"no stats for pg {pgid!r}", None
            return 0, "", {
                "epoch": self.mon.services["osdmap"].osdmap.epoch,
                "inconsistents": st.get("inconsistent_objects", [])}
        if prefix == "df":
            # per-pool usage from PGMap (reference `ceph df`:
            # PGMap::dump_cluster_stats + per-pool sums)
            osdsvc = self.mon.services["osdmap"]
            m = osdsvc.osdmap
            usage = self.mon.pgmap.pool_usage(set(m.pools))
            dedup = self.mon.pgmap.dedup_totals()
            dedup_ratio = (dedup["referenced_bytes"]
                           / dedup["stored_bytes"]
                           if dedup["stored_bytes"] else 1.0)
            out = {"pools": []}
            for name, pid in sorted(m.pool_name.items()):
                pool = m.pools.get(pid)
                row = usage.get(pid, [0, 0, 0])
                stored, logical = row[1], row[2]
                prow = {
                    "name": name, "id": pid,
                    "pg_num": pool.pg_num if pool else 0,
                    "objects": row[0],
                    # bytes_used stays the PHYSICAL footprint
                    # (post-compression), mirroring the reference's
                    # USED vs STORED split in `ceph df detail`
                    "bytes_used": stored,
                    "bytes_logical": logical,
                    "compress_ratio": (logical / stored
                                       if stored else 1.0)}
                if pool is not None and getattr(pool, "dedup_enable",
                                                False):
                    # the chunk index is store-global, so the per-pool
                    # ratio is the cluster chunk index's ratio (one
                    # dedup domain per cluster, like the reference's
                    # single chunk pool per base pool tier)
                    prow["dedup_ratio"] = dedup_ratio
                out["pools"].append(prow)
            out["total_objects"] = sum(p["objects"]
                                       for p in out["pools"])
            out["total_bytes_used"] = sum(p["bytes_used"]
                                          for p in out["pools"]) \
                + dedup["stored_bytes"]
            out["total_bytes_logical"] = sum(p["bytes_logical"]
                                             for p in out["pools"])
            out["dedup"] = dict(dedup, ratio=dedup_ratio)
            return 0, "", out
        if prefix == "osd df":
            # per-osd utilization (reference `ceph osd df`)
            osdsvc = self.mon.services["osdmap"]
            m = osdsvc.osdmap
            rows = []
            for o, st in sorted(self.mon.pgmap.osd_stats.items()):
                rows.append({
                    "osd": o,
                    "up": m.is_up(o) if o < m.max_osd else False,
                    "num_pgs": int(st.get("num_pgs", 0)),
                    "ops": int(st.get("op", 0))})
            return 0, "", {"nodes": rows}
        if prefix == "health mute":
            code = str(cmd.get("code", "")).strip().upper()
            if not code:
                return -22, "health mute: code required", None
            ttl = float(cmd.get("ttl") or 0)
            sticky = bool(cmd.get("sticky"))
            now = time.time()
            present = _code_states(self._live_report()).get(code)
            if present is None and not sticky:
                return (-2, f"health check {code} not present "
                        "(pass sticky to mute in advance)", None)
            self.mutes[code] = {
                "expires": now + ttl if ttl > 0 else 0,
                "sticky": sticky,
                "count": int(present[1].get("count", 0))
                if present else 0}
            self.stage("put", "mutes", json.dumps(self.mutes))
            self._evaluate_and_stage(now, force=True)
            return 0, f"muted {code}", None
        if prefix == "health unmute":
            code = str(cmd.get("code", "")).strip().upper()
            if code not in self.mutes:
                return -2, f"health check {code} is not muted", None
            del self.mutes[code]
            self.stage("put", "mutes", json.dumps(self.mutes))
            self._evaluate_and_stage(time.time(), force=True)
            return 0, f"unmuted {code}", None
        if prefix == "health history":
            return 0, "", {"events": [dict(e) for e in self.history]}
        if prefix in ("health", "health detail", "status", "pg stat"):
            osdsvc = self.mon.services["osdmap"]
            m = osdsvc.osdmap
            self.mon.pgmap.prune(set(m.pools))
            total_pgs = sum(p.pg_num for p in m.pools.values())
            states = self.mon.pgmap.states(total_expected=total_pgs)
            if prefix == "pg stat":
                return 0, "", {"num_pgs": total_pgs, "states": states}
            report = self._live_report()
            status = report["status"]
            out = {"health": status,
                   "checks": [dict(c) for c in report["checks"]],
                   "muted": [dict(c) for c in report.get("muted", [])]}
            if prefix == "health detail":
                out["mutes"] = {c: dict(m_)
                                for c, m_ in self.mutes.items()}
            if prefix == "status":
                out.update({
                    "quorum": self.mon.elector.quorum,
                    "leader": self.mon.elector.leader,
                    "monmap_epoch": self.mon.monmap.epoch,
                    "osdmap_epoch": m.epoch,
                    "num_osds": m.max_osd,
                    "num_up_osds": m.num_up_osds(),
                    "pools": sorted(m.pool_name),
                    "num_pgs": total_pgs,
                    "pg_states": states,
                    "num_objects": self.mon.pgmap.num_objects(),
                })
            return 0, status, out
        return None
