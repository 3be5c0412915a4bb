"""The in-process cluster harnesses (vstart.sh analog).

The port's copy of ``ceph_tpu.vstart``: ``MiniCluster`` — N mons + M
OSDs on localhost sockets, started from nothing, with helpers to
kill/revive daemons — and ``ScaleHarness``, the million-PG control
plane without daemons.  ``MiniCluster(device=...)`` hands its device to
every OSD (``None`` → the card, raising without one; ``"cpu"`` runs the
kernels' plain versions).

Threaded mode only: ``procs=True`` (one OS process a daemon) and the
mgr, MDS/CephFS and RGW methods wait for the service-heads slice
(ROADMAP).
"""

from __future__ import annotations

import os
import queue
import random
import shutil
import socket
import tempfile
import time

from .mon.monitor import MonMap, Monitor
from .msg import EntityAddr
from .msg.fault import site_pairs
from .os_store import CrashInjector, WALStore
from .osd.daemon import OSDaemon
from .osdc.librados import Rados
from .utils.device import resolve_device


def health_event(code: str, state: str):
    """Predicate factory for ``game_day`` phases / watcher loops:
    matches the health event where `code` transitions to `state`
    ("failed" / "cleared"), or — for state "rollup:HEALTH_OK" style —
    a rollup event reaching that status.

    Catch-up snapshots also satisfy the predicate when they already
    show the target state: a watcher whose session mon died mid-drill
    re-hunts and re-subscribes, and the transition it was blocking on
    may only be visible as the fresh snapshot's contents."""
    if state.startswith("rollup:"):
        want = state.split(":", 1)[1]

        def _rollup(ev):
            d = ev["data"]
            return (ev["kind"] == "health"
                    and d.get("state") in ("rollup", "snapshot")
                    and d.get("status") == want)
        return _rollup

    def _pred(ev):
        if ev["kind"] != "health":
            return False
        d = ev["data"]
        if d.get("state") == "snapshot":
            present = code in (d.get("checks") or [])
            return present if state == "failed" else \
                (not present if state == "cleared" else False)
        return d.get("code") == code and d.get("state") == state
    return _pred


def _free_ports(n: int) -> list[int]:
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


class ClusterWatcher:
    """Live cluster event feed (the `ceph -w` transport): health
    transitions, clog entries and progress updates arrive in order on
    an internal queue via a mon "events" subscription."""

    def __init__(self, monmap, auth=None):
        from .mon.client import MonClient
        self._q: queue.Queue = queue.Queue()
        self.monc = MonClient(monmap, entity="client.watch", auth=auth)
        self.monc.on_event = self._on_event
        self.monc.sub_want("events", 0)
        self.seen: list[dict] = []

    def _on_event(self, kind, data, stamp):
        self._q.put({"kind": kind, "data": data or {}, "stamp": stamp})

    def next(self, timeout: float = 10.0) -> dict:
        """Block for the next event → {"kind", "data", "stamp"}."""
        try:
            ev = self._q.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError("no cluster event within timeout")
        self.seen.append(ev)
        return ev

    def close(self):
        self.monc.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MiniCluster:
    def __init__(self, n_mons: int = 3, n_osds: int = 3, *,
                 osd_stores=None, mon_stores=None,
                 osd_config: dict | None = None,
                 secure: bool = False,
                 stretch_sites: dict[str, list[int]] | None = None,
                 mon_sites: dict[int, str] | None = None,
                 tiebreaker_mon: int = -1,
                 fault_seed: int | None = None,
                 procs: bool = False,
                 crash_probs: dict[str, float] | None = None,
                 device=None):
        if procs:
            raise NotImplementedError(
                "MiniCluster(procs=True) is not ported yet: process "
                "mode waits for the service-heads slice (ROADMAP)")
        # every OSD's device work (batch engine, EC codes, scrub) runs
        # here; resolved first, so a missing card fails before any
        # daemon starts
        self.device = resolve_device(device)
        # option overrides applied to every OSD BEFORE construction
        # (some, e.g. osd_op_queue, are consumed in the ctor)
        self._osd_config = dict(osd_config or {})
        # per-point crash probabilities applied to every OSD's
        # CrashInjector (the seed makes the schedule reproducible)
        self.crash_probs = {k: float(v)
                            for k, v in (crash_probs or {}).items()}
        # secure=True: one ClusterAuth (the deployed-keyring analog)
        # shared by every daemon and client; all messengers run
        # ms_mode=secure (AES-GCM frames) — reference ProtocolV2
        # secure mode cluster-wide
        self.auth = None
        if secure:
            from .core.auth import ClusterAuth
            self.auth = ClusterAuth()
        # stretch topology: OSD site membership drives the CRUSH
        # hierarchy (enable_stretch_mode) and the site fault fabric;
        # mons are spread round-robin across the sites with the last
        # rank as tiebreaker unless the caller places them explicitly
        self.stretch_sites = {s: sorted(o) for s, o
                              in (stretch_sites or {}).items()}
        if self.stretch_sites and mon_sites is None:
            names = sorted(self.stretch_sites)
            if tiebreaker_mon < 0:
                tiebreaker_mon = n_mons - 1
            mon_sites = {}
            k = 0
            for r in range(n_mons):
                if r == tiebreaker_mon:
                    mon_sites[r] = "tiebreaker"
                else:
                    mon_sites[r] = names[k % len(names)]
                    k += 1
        self.fault_seed = fault_seed
        ports = _free_ports(n_mons)
        self.monmap = MonMap(mons={r: EntityAddr("127.0.0.1", ports[r])
                                   for r in range(n_mons)},
                             sites=dict(mon_sites or {}),
                             tiebreaker=tiebreaker_mon)
        self.mons = [Monitor(r, self.monmap,
                             store=mon_stores[r] if mon_stores else None,
                             auth=self.auth)
                     for r in range(n_mons)]
        self._osd_stores = osd_stores
        # durable backing (osd_objectstore=walstore, the default):
        # per-OSD WAL files in a throwaway dir, paths remembered so a
        # power-lossed OSD cold-remounts the SAME log on revive
        self._wal_dir: str | None = None
        self._wal_paths: dict[int, str] = {}
        self.osds: dict[int, OSDaemon] = {}
        self.n_osds = n_osds
        self._clients: list[Rados] = []
        # (injector, src, dst) triples the site primitives installed,
        # so heal_sites removes exactly what it added
        self._site_rules: list[tuple] = []

    # -- lifecycle ---------------------------------------------------------
    def start(self, timeout: float = 30.0) -> "MiniCluster":
        if self.fault_seed is not None:
            # one logged seed reseeds every daemon injector: verdicts
            # are pure functions of (seed, src, dst, n), so a whole
            # site event replays from this number alone
            for m in self.mons:
                m.msgr.faults.seed = int(self.fault_seed)
                m.msgr.faults.rng = random.Random(int(self.fault_seed))
        for m in self.mons:
            m.start()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if any(m.is_leader for m in self.mons):
                break
            time.sleep(0.02)
        else:
            raise TimeoutError("no mon leader")
        for i in range(self.n_osds):
            self.start_osd(i)
        return self

    def osd_replay_stats(self, i: int) -> dict:
        """The WAL cold-remount damage report of a (revived) OSD."""
        return dict(getattr(self.osds[i].store, "replay_stats",
                            None) or {})

    def profiler_dump(self, i: int) -> dict:
        """One OSD's device-profiler dump (the ``profiler dump`` asok
        command, without the socket)."""
        d = self.osds[i].profiler.dump()
        d["clock"] = {"wall": time.time(), "mono": time.monotonic()}
        return d

    def blackbox_path(self, i: int) -> str:
        """Flight-recorder sidecar path for one OSD — readable
        offline (tools/blackbox_tool.py) even while the daemon is a
        corpse, since WAL paths persist across crash/revive."""
        return self._wal_path(i) + ".bbox"

    def pg_primary(self, pgid) -> int:
        """Acting-primary OSD id for one PG, from the live daemons."""
        from .osd.osdmap import PGid
        if isinstance(pgid, str):
            pgid = PGid.parse(pgid)
        for osd in self.osds.values():
            with osd.lock:
                pg = osd.pgs.get(pgid)
                if pg is not None and pg.is_primary:
                    return osd.whoami
        raise KeyError(f"no live primary for {pgid}")

    def _wal_path(self, i: int) -> str:
        p = self._wal_paths.get(i)
        if p is None:
            if self._wal_dir is None:
                # Prefer tmpfs for the throwaway default WAL dir:
                # power loss here is simulated by truncation, so the
                # semantics are identical, but group-commit fsyncs
                # don't pay the ext4 journal (~2ms each).
                base = "/dev/shm" if os.path.isdir("/dev/shm") else None
                self._wal_dir = tempfile.mkdtemp(
                    prefix="ceph-tpu-torch-wal-", dir=base)
            p = os.path.join(self._wal_dir, f"osd.{i}.wal")
            self._wal_paths[i] = p
        return p

    def _default_store(self, i: int):
        """Fresh store for an OSD with no saved object: a WALStore on
        the OSD's WAL path (so a cold restart replays whatever an
        earlier incarnation committed) unless osd_objectstore asks for
        RAM only.  Every WALStore carries a CrashInjector seeded from
        the cluster fault seed — same seed, same crash schedule."""
        if self._osd_config.get("osd_objectstore",
                                "walstore") != "walstore":
            return None     # OSDaemon defaults to MemStore
        inj = CrashInjector(seed=int(self.fault_seed or 0),
                            osd=f"osd.{i}")
        for point, prob in (self.crash_probs or {}).items():
            inj.set_prob(point, prob)
        return WALStore(
            self._wal_path(i),
            sync_mode=self._osd_config.get("osd_wal_sync_mode",
                                           "batch"),
            name=f"osd.{i}",
            crash=inj,
            compact_min_records=int(self._osd_config.get(
                "osd_wal_compact_min_records", 0)))

    def start_osd(self, i: int, timeout: float = 30.0):
        store = None
        if self._osd_stores:
            store = (self._osd_stores.get(i)
                     if isinstance(self._osd_stores, dict)
                     else self._osd_stores[i])
        if store is None:
            store = self._default_store(i)
        cfg = None
        if self._osd_config:
            from .core.config import ConfigProxy
            from .core.options import build_options
            cfg = ConfigProxy(build_options())
            for k, v in self._osd_config.items():
                cfg.set(k, v)
        osd = OSDaemon(i, self.monmap, store=store, config=cfg,
                       auth=self.auth, device=self.device)
        if self.fault_seed is not None:
            osd.msgr.faults.seed = int(self.fault_seed)
            osd.msgr.faults.rng = random.Random(int(self.fault_seed))
        osd.start(wait_for_up=True, timeout=timeout)
        self.osds[i] = osd
        return osd

    def _halt_osd(self, i: int) -> OSDaemon:
        """Stop one OSD's threads and sockets without unmounting its
        store (the shared first half of a kill and a crash)."""
        osd = self.osds.pop(i)
        osd.running = False
        osd.op_queue.close()
        osd.timer.shutdown()
        osd.admin_socket.shutdown()
        osd.monc.shutdown()
        osd.msgr.shutdown()
        return osd

    def kill_osd(self, i: int):
        """Hard-stop an OSD (keeps its store object for a revive)."""
        osd = self._halt_osd(i)
        # a kill is the harness's controlled hard-stop, not a crash
        # drill (that's crash_osd) — close the black box cleanly so
        # the revive doesn't synthesize a crash report and trip
        # RECENT_CRASH
        if osd.flight_recorder is not None:
            try:
                osd.flight_recorder.close()
            except Exception:   # noqa: BLE001 — recorder never
                pass            # blocks a kill
        # deliberately NOT umounting: a revive remounts the same store
        if self._osd_stores is None:
            self._osd_stores = {}
        if not isinstance(self._osd_stores, dict):
            self._osd_stores = {j: s for j, s in
                                enumerate(self._osd_stores)}
        self._osd_stores[i] = osd.store

    def revive_osd(self, i: int, timeout: float = 30.0) -> OSDaemon:
        return self.start_osd(i, timeout=timeout)

    def crash_osd(self, i: int, hard: bool = False):
        """Crash one OSD so ``revive_osd`` must cold-remount from the
        WAL path alone (``kill_osd`` deliberately keeps the store).

        ``hard=False`` is a power cut: stable storage keeps only the
        fsynced WAL prefix (plus any torn fragment an injected crash
        left).  ``hard=True`` is process death (``kill -9``): the OS
        survives, so the page cache — every appended record, fsynced
        or not — is still there on remount; only in-memory daemon
        state is lost."""
        osd = self._halt_osd(i)
        store = osd.store
        path = getattr(store, "_path", None)
        if path is not None:
            self._wal_paths[i] = path
        pl = getattr(store,
                     "process_death" if hard else "power_loss", None)
        if pl is not None:
            pl()
        else:
            try:
                store.umount()      # RAM store: everything is lost
            except Exception:
                pass
        if isinstance(self._osd_stores, dict):
            self._osd_stores.pop(i, None)
        elif self._osd_stores is not None:
            self._osd_stores = {j: s for j, s in
                                enumerate(self._osd_stores) if j != i}

    def power_loss(self, revive: bool = True,
                   timeout: float = 60.0) -> dict:
        """Whole-cluster power-loss drill: cut power to every running
        OSD at once, then (by default) cold-restart each from its WAL
        path.  → {osd: replay_stats} for the revived OSDs."""
        crashed = sorted(self.osds)
        for i in crashed:
            self.crash_osd(i)
        report: dict[int, dict] = {}
        if revive:
            for i in crashed:
                self.revive_osd(i, timeout=timeout)
                report[i] = self.osd_replay_stats(i)
        return report

    def dedup_leak_check(self) -> list[str]:
        """Refcount balance audit over every live OSD store: each
        fingerprint's refcount must equal its live manifest references
        and zero-ref chunks must be gone (deletes balance to zero).
        Engages only on stores that ever ingested a chunk."""
        from .compress import dedup as dd
        problems = []
        for i, osd in sorted(self.osds.items()):
            store = osd.store
            try:
                if dd.DEDUP_COLL not in store.list_collections():
                    continue
            except Exception:
                continue
            problems += [f"osd.{i}: {p}"
                         for p in dd.verify_refcounts(store)]
        return problems

    def stop(self):
        try:
            dedup_problems = self.dedup_leak_check()
        except Exception:
            dedup_problems = []
        for c in self._clients:
            try:
                c.shutdown()
            except Exception:
                pass
        for osd in list(self.osds.values()):
            try:
                osd.shutdown()
            except Exception:
                pass
        for m in self.mons:
            try:
                m.shutdown()
            except Exception:
                pass
        if self._wal_dir is not None:
            shutil.rmtree(self._wal_dir, ignore_errors=True)
            self._wal_dir = None
        if dedup_problems:
            raise AssertionError("dedup refcount leak at teardown: "
                                 + "; ".join(dedup_problems))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- clients -----------------------------------------------------------
    def rados(self, name: str = "client.admin",
              config=None) -> Rados:
        """config: optional ConfigProxy carrying client knobs
        (objecter_resend_*, objecter_backoff_expire)."""
        r = Rados(self.monmap, name=name, auth=self.auth,
                  config=config).connect()
        self._clients.append(r)
        return r

    # -- fault fabric ------------------------------------------------------
    def partition_osds(self, a: int, b: int, *,
                       bidirectional: bool = True):
        """Netsplit osd.a ⇸ osd.b via their messengers' fault
        injectors.  Directed by default semantics of the injector: a's
        sends to b are blackholed; bidirectional=True (the usual
        split) also installs b ⇸ a.  Heartbeats, sub-ops and peering
        traffic all die on the partitioned edges while both daemons
        keep talking to the mons — the classic netsplit."""
        self.osds[a].msgr.faults.partition(f"osd.{b}")
        if bidirectional:
            self.osds[b].msgr.faults.partition(f"osd.{a}")

    def isolate_osd(self, i: int):
        """Partition osd.i from every OTHER osd (mon links stay up)."""
        for j, osd in self.osds.items():
            if j == i:
                continue
            self.osds[i].msgr.faults.partition(f"osd.{j}")
            osd.msgr.faults.partition(f"osd.{i}")

    def heal_netsplit(self):
        """Remove every osd→osd partition rule installed above
        (blanket probabilistic rules from ms_inject_* are kept)."""
        for i, osd in self.osds.items():
            for j in self.osds:
                if j != i:
                    osd.msgr.faults.heal(dst=f"osd.{j}")

    # -- stretch / site fault fabric ---------------------------------------
    def site_daemons(self, site: str) -> list[str]:
        """Entity names of every daemon placed in `site`: its mons
        (monmap placement) and its OSDs (stretch_sites)."""
        ents = [f"mon.{r}" for r, s in sorted(self.monmap.sites.items())
                if s == site]
        ents += [f"osd.{o}"
                 for o in self.stretch_sites.get(site, [])]
        return ents

    def _entity_injectors(self) -> dict:
        """entity name → that live daemon's FaultInjector."""
        inj = {m.name: m.msgr.faults for m in self.mons}
        inj.update({f"osd.{i}": osd.msgr.faults
                    for i, osd in self.osds.items()})
        return inj

    def enable_stretch_mode(self, rados=None) -> dict:
        """Switch the cluster to stretch mode: two-datacenter CRUSH
        map, stretch rule, every replicated pool size=4/min_size=2.
        Requires the cluster to have been built with
        ``stretch_sites`` (and, for tiebreaker quorum semantics, an
        odd mon count with the tiebreaker rank)."""
        if len(self.stretch_sites) != 2:
            raise ValueError("stretch mode needs exactly 2 sites")
        r = rados or self.rados()
        tb = (f"mon.{self.monmap.tiebreaker}"
              if self.monmap.tiebreaker >= 0 else "")
        rc, outs, out = r.mon_command({
            "prefix": "osd enable-stretch-mode",
            "sites": {s: list(o)
                      for s, o in self.stretch_sites.items()},
            "tiebreaker": tb})
        if rc != 0:
            raise RuntimeError(f"enable-stretch-mode failed: {outs}")
        return out or {}

    def _install(self, inj_map, src: str, dst: str, **kw):
        inj = inj_map.get(src)
        if inj is None:
            return      # daemon currently dead: nothing to install on
        if kw:
            inj.set_rule(src, dst, **kw)
        else:
            inj.partition(dst, src=src)
        self._site_rules.append((inj, src, dst))

    def partition_sites(self, a: str, b: str):
        """Cut every inter-site daemon link between sites `a` and `b`
        (both directions) — the WAN-cut drill.  Intra-site traffic and
        links to daemons outside either site (e.g. the tiebreaker mon)
        keep flowing, which is exactly what lets the surviving side
        keep quorum."""
        inj = self._entity_injectors()
        for s, d in site_pairs(self.site_daemons(a),
                               self.site_daemons(b)):
            self._install(inj, s, d)

    def blackout_site(self, site: str):
        """Whole-site power loss without killing the processes: the
        site's daemons stop talking to ANYONE (clients included) and
        everyone stops reaching them.  Survivors' failure reports mark
        the site's OSDs down; its mons drop out of quorum."""
        inj = self._entity_injectors()
        dead = self.site_daemons(site)
        for d_ent in dead:
            # outbound blanket cut — replies to clients die too
            self._install(inj, d_ent, "*")
        for s_ent in inj:
            if s_ent in dead:
                continue
            for d_ent in dead:
                self._install(inj, s_ent, d_ent)

    def slow_wan(self, a: str, b: str, *, delay: float = 0.5,
                 delay_ms: float = 80.0, reorder: float = 0.0,
                 reorder_ms: float = 120.0, drop: float = 0.0):
        """Degrade (not cut) the inter-site link: delay/reorder/drop
        probabilities applied ONLY to inter-site pairs, in both
        directions.  Intra-site latency is untouched."""
        inj = self._entity_injectors()
        for s, d in site_pairs(self.site_daemons(a),
                               self.site_daemons(b)):
            self._install(inj, s, d, delay=delay, delay_ms=delay_ms,
                          reorder=reorder, reorder_ms=reorder_ms,
                          drop=drop)

    def heal_sites(self):
        """Remove exactly the rules the site primitives installed."""
        for inj, src, dst in self._site_rules:
            inj.heal(src=src, dst=dst)
        self._site_rules.clear()

    def preview_site_schedule(self, a: str, b: str,
                              count: int = 32) -> dict[str, list]:
        """The deterministic fault schedule every inter-site pair
        would see for its next `count` messages — pure (no counter
        advance).  Equal seeds + equal rules ⇒ equal schedules: the
        acceptance hook for site-event replay."""
        inj = self._entity_injectors()
        out = {}
        for s, d in site_pairs(self.site_daemons(a),
                               self.site_daemons(b)):
            if s in inj:
                out[f"{s}>{d}"] = inj[s].preview(s, d, count)
        return out

    def game_day(self, phases, *, timeout: float = 60.0) -> list[dict]:
        """Run a scripted site-disaster drill.

        Each phase is ``{"name", "action": fn(cluster)|None,
        "until": fn(event)->bool|None, "timeout": s}``: fire the
        action, then (if `until` is given) consume the live `ceph -w`
        event stream until the predicate matches.  Returns per-phase
        wall-clock timings — the bench stretch leg reads
        ``site_failover_detect_s`` and ``site_heal_convergence_s``
        straight out of this report."""
        report = []
        with self.watch() as w:
            for ph in phases:
                name = ph.get("name", "?")
                t0 = time.monotonic()
                action = ph.get("action")
                if action is not None:
                    action(self)
                until = ph.get("until")
                if until is not None:
                    deadline = time.monotonic() + \
                        float(ph.get("timeout", timeout))
                    while True:
                        left = deadline - time.monotonic()
                        if left <= 0:
                            raise TimeoutError(
                                f"game day phase {name!r} never "
                                "reached its target event")
                        ev = w.next(timeout=left)
                        if until(ev):
                            break
                report.append({"phase": name,
                               "elapsed_s": time.monotonic() - t0})
        return report

    # -- cluster helpers ---------------------------------------------------
    def watch(self) -> ClusterWatcher:
        """Subscribe to the mon event stream (health / clog /
        progress) — the `ceph -w` feed.  Caller closes."""
        return ClusterWatcher(self.monmap, auth=self.auth)

    def wait_for_health_ok(self, timeout: float = 30.0):
        """Block until the cluster reports HEALTH_OK, driven entirely
        by the event stream — no status polling.  The subscription
        snapshot answers immediately when already healthy."""
        with self.watch() as w:
            deadline = time.monotonic() + timeout
            while True:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError("cluster never reached "
                                       "HEALTH_OK")
                ev = w.next(timeout=left)
                if ev["kind"] == "health" and \
                        ev["data"].get("status") == "HEALTH_OK":
                    return

    def wait_for_clean(self, timeout: float = 30.0):
        """Wait until every PG on every live OSD is active (+clean when
        it owns recovery state)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            states = []
            for osd in self.osds.values():
                with osd.lock:
                    states.extend(pg.state for pg in osd.pgs.values()
                                  if osd.whoami == pg.primary)
            if states and all(s in ("active", "active+clean")
                              for s in states):
                return
            time.sleep(0.05)
        raise TimeoutError(f"cluster never went clean: {states}")

    def scrub_pg(self, pgid, timeout: float = 20.0, *,
                 deep: bool = True) -> int:
        """Scrub one PG on its primary; wait for completion and
        subsequent repair to settle.  Returns the error count the
        scrub found (0 = clean).  deep=False runs a shallow scrub
        (metadata only — no payload digests, no parity recheck).

        A scrub that ends without a verdict raises ``RuntimeError``:
        the primary gave up on a peer that never sent its map
        (``PG.check_scrub_timeout``) or the interval changed under it.
        Its ``scrub_errors`` is then the previous scrub's count, which
        ceph_tpu's ``scrub_pg`` returns as this one's."""
        primary = None
        for osd in self.osds.values():
            with osd.lock:
                pg = osd.pgs.get(pgid)
                if pg is not None and pg.is_primary:
                    primary = osd
                    before = pg.last_scrub
                    break
        if primary is None:
            raise KeyError(f"no primary for {pgid}")
        deadline = time.monotonic() + timeout
        while not primary.scrub_pg(pgid, deep=deep):
            # refused while writes are in flight — retry
            if time.monotonic() > deadline:
                raise TimeoutError(f"scrub of {pgid} never started")
            time.sleep(0.05)
        while time.monotonic() < deadline:
            with primary.lock:
                pg = primary.pgs[pgid]
                if not pg.scrubbing:
                    if pg.last_scrub == before:
                        raise RuntimeError(
                            f"scrub of {pgid} on osd.{primary.whoami} "
                            f"was aborted: no verdict")
                    return pg.scrub_errors
            time.sleep(0.05)
        raise TimeoutError(f"scrub of {pgid} never finished")

    # -- tracing -----------------------------------------------------------
    def collect_trace(self, trace_id: str,
                      format: str = "spans"):
        """Merge one trace's spans from every daemon and client ring,
        ordered by start time.

        The in-process rings share one monotonic clock, so the spans
        merge as they are.

        ``format="spans"`` (default) returns the raw span dicts —
        feed them to ``core.tracer.chrome_trace`` for chrome://tracing;
        ``format="otlp"`` returns the OTLP/JSON resource/scope/span
        shape; ``format="chrome"`` the Chrome trace_event JSON."""
        spans: list[dict] = []
        for osd in self.osds.values():
            spans.extend(osd.tracer.spans_for(trace_id))
        for r in self._clients:
            if r.objecter is not None:
                spans.extend(r.objecter.tracer.spans_for(trace_id))
        spans.sort(key=lambda s: s["start"])
        if format == "otlp":
            from .core.tracer import otlp_trace
            return otlp_trace(spans)
        if format == "chrome":
            from .core.tracer import chrome_trace
            return chrome_trace(spans)
        return spans

    def export_chrome_trace(self, trace_id: str) -> dict:
        """chrome://tracing JSON for one trace."""
        from .core.tracer import chrome_trace
        return chrome_trace(self.collect_trace(trace_id))

    def wait_for_osd_down(self, i: int, timeout: float = 20.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for osd in self.osds.values():
                with osd.lock:
                    if osd.osdmap.max_osd > i and \
                            not osd.osdmap.is_up(i):
                        return
            time.sleep(0.05)
        raise TimeoutError(f"osd.{i} never marked down")


class ScaleHarness:
    """Synthetic million-PG control plane — no daemons, no sockets.

    Stands up the mon/mgr aggregation state (OSDMap + array PGMap +
    per-OSD stats) for ``n_osds``/``pg_num`` directly, the way a
    vstart cluster would look after every OSD reported once, so the
    health/summary/balancer passes can be exercised and timed at
    scales no in-process cluster could reach (4096 OSDs, 2^20 PGs).
    Placement is either one batched CRUSH evaluation of the whole pool
    (``placement="crush"``: the port's ``BatchMapper`` on ``device``,
    ``None`` meaning the card, raising without one) or collision-free
    uniform sampling (``"synthetic"``, the default — mapping cost
    stays out of control-plane timings).

    Everything is deterministic in ``seed``: two harnesses built with
    the same arguments hold bit-identical state, which is what lets
    the tier-1 equality test run the array and legacy paths on twins.
    """

    STATE_MIX = (
        ("active+clean", 0.97),
        ("active+undersized+degraded", 0.015),
        ("active+remapped+backfilling", 0.008),
        ("active+clean+scrubbing", 0.004),
        ("down", 0.002),
        ("incomplete", 0.001),
    )

    def __init__(self, n_osds: int = 4096, pg_num: int = 1 << 20, *,
                 size: int = 3, seed: int = 0,
                 placement: str = "synthetic",
                 down_osds: int = 0,
                 damaged_frac: float = 1e-4,
                 scrub_late_frac: float = 1e-3,
                 stale_frac: float = 0.0,
                 scrub_interval: float | None = None,
                 now: float | None = None, device=None):
        import numpy as np
        from .crush.map import build_flat_map
        from .mon import health
        from .mon.pgmap import PGMap
        from .osd.osdmap import EXISTS, UP, OSDMap

        self.now = time.time() if now is None else now
        self.n_osds, self.pg_num, self.size = n_osds, pg_num, size
        rng = np.random.default_rng(seed)

        m = OSDMap(crush=build_flat_map(n_osds), max_osd=n_osds)
        m.epoch = 1
        for o in range(n_osds):
            m.osd_state[o] = EXISTS | UP
        for o in range(down_osds):
            m.mark_down(o)
        self.pool = m.create_pool("scale", pg_num=pg_num, size=size,
                                  crush_rule=0)
        self.osdmap = m

        if placement == "crush":
            from .tools.osdmaptool import map_pool_pgs
            self.placements = np.asarray(
                map_pool_pgs(m, self.pool, device=device), dtype=np.int64)
        elif placement == "synthetic":
            self.placements = self._sample_placements(rng)
        else:
            raise ValueError(f"placement={placement!r}")

        # -- pg_stats: one vectorized ingest --------------------------
        names = [s for s, _w in self.STATE_MIX]
        probs = np.array([w for _s, w in self.STATE_MIX])
        codes = rng.choice(len(names), size=pg_num,
                           p=probs / probs.sum())
        interval = health.SCRUB_WARN_INTERVAL \
            if scrub_interval is None else scrub_interval
        lss = self.now - rng.uniform(0.0, 0.5 * interval, pg_num)
        late = rng.random(pg_num) < scrub_late_frac
        lss[late] = self.now - interval * (2.0 + rng.random(late.sum()))
        errs = np.zeros(pg_num, dtype=np.int64)
        dmg = rng.random(pg_num) < damaged_frac
        errs[dmg] = rng.integers(1, 5, dmg.sum())
        degraded = np.isin(codes,
                           [names.index("active+undersized+degraded"),
                            names.index("active+remapped+backfilling")])
        stamp = np.full(pg_num, self.now)
        if stale_frac:
            stale = rng.random(pg_num) < stale_frac
            stamp[stale] = self.now - 10 * health.PG_STALE_GRACE

        pgm = PGMap()
        pgm.ingest_columns(
            self.pool.id, np.arange(pg_num, dtype=np.int64),
            state_names=names, state_codes=codes, stamp=stamp,
            num_objects=rng.integers(0, 2000, pg_num),
            num_bytes=rng.integers(0, 1 << 24, pg_num),
            log_size=rng.integers(0, 100, pg_num),
            missing=np.where(degraded,
                             rng.integers(1, 50, pg_num), 0),
            backfill_remaining=np.where(
                degraded, rng.integers(0, 200, pg_num), 0),
            scrub_errors=errs,
            last_scrub_stamp=lss,
            osd=self.placements[:, 0],
        )
        for o in range(n_osds):
            pgm.osd_stats[o] = {
                "kb": 1 << 20, "kb_used": 1 << 19,
                "bytes_total": 1 << 30, "bytes_used": 1 << 29,
                "op": 100 * o, "op_w": 60 * o, "op_r": 40 * o,
                "stamp": self.now,
            }
        self.pgmap = pgm

    def _sample_placements(self, rng):
        """[pg_num, size] uniform OSD ids, no repeats within a row
        (resample colliding rows until clean — a handful of passes at
        size=3 vs thousands of OSDs)."""
        import numpy as np
        place = rng.integers(0, self.n_osds,
                             size=(self.pg_num, self.size),
                             dtype=np.int64)
        while True:
            srt = np.sort(place, axis=1)
            dup = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
            if not dup.any():
                return place
            place[dup] = rng.integers(0, self.n_osds,
                                      size=(int(dup.sum()), self.size),
                                      dtype=np.int64)

    # -- control-plane entry points -----------------------------------
    def health_context(self):
        from .mon.health import HealthContext
        return HealthContext(osdmap=self.osdmap, pgmap=self.pgmap,
                             monmap_ranks=[0], quorum=[0],
                             now=self.now)

    def evaluate(self) -> list[dict]:
        """One full health pass: states histogram + every registered
        evaluator over the array PGMap."""
        from .mon.health import evaluate_checks
        return evaluate_checks(self.health_context())

    def summary(self) -> dict:
        return self.pgmap.summary(live_pools={self.pool.id},
                                  now=self.now,
                                  total_expected=self.pg_num)

    def legacy_pgmap(self):
        """Dict-backed twin of the array map (materializes every row
        — meant for the fast equality tier, not the 1M smoke)."""
        from .mon.pgmap import LegacyPGMap
        lm = LegacyPGMap()
        lm.pg_stats = self.pgmap.dump()
        lm.osd_stats = {o: dict(st)
                        for o, st in self.pgmap.osd_stats.items()}
        return lm

    def balancer(self):
        """UpmapBalancer over the injected placements (no CRUSH
        recompute); pick the round implementation via
        ``optimize(use_arrays=...)``."""
        from .mgr.balancer import UpmapBalancer
        return UpmapBalancer(self.osdmap, self.pool.id,
                             placements=self.placements)
