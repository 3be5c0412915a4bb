"""MDS daemon — the CephFS metadata server.

The port's copy of ``ceph_tpu.mds.daemon``.

Reference behavior re-created (``src/mds/MDSRank.cc``, ``Server.cc``,
``MDCache.cc``, ``MDLog.cc``; SURVEY.md §3.9):

- **standby → active**: beacons to the mons; the MDSMonitor promotes a
  standby into a filesystem's rank 0 and everyone learns it from the
  FSMap (beacon timeout = failover, reference MDSMonitor::tick);
- **metadata in RADOS**: each directory is a *dirfrag object* in the
  metadata pool (``<ino-hex>.00000000``) whose omap maps dentry name →
  inode record — the reference's CDir backing store exactly;
- **write-ahead journal** (reference MDLog): every mutation appends an
  event to the journal object's omap and is acknowledged from the
  journal, not the dirfrags; dirty dirfrags flush lazily and the
  journal trims behind them.  A newly-active MDS **replays** the
  journal into the backing store before serving — metadata acked
  before a crash survives the failover;
- **sessions + request dedup**: journal events carry (client, tid);
  replay rebuilds the completed-request set so a client resending
  across a failover gets its original answer, not EEXIST (reference
  session completed_requests);
- **never on the data path**: file bytes flow client↔OSD through the
  striper; the MDS only tracks size/mtime via setattr (cap flush
  analog) and purges data objects on unlink.
"""

from __future__ import annotations

import json
import threading
import time

from ..mon import messages as MM
from ..mon.client import MonClient
from ..msg import Dispatcher, Messenger
from ..osdc.librados import IoCtx, ObjectNotFound, Rados
from . import messages as M
from .fsmap import FSMap, STATE_ACTIVE

ROOT_INO = 1
INO_CHUNK = 128          # inode numbers claimed per journal event
JHEAD = "mds{rank}_journal"
INOTABLE = "mds{rank}_inotable"
INODES = "mds_inodes"   # multi-link inode rows (size/mtime/nlink) —
# SHARED across ranks: ino spaces are rank-disjoint so rows never
# collide, and a subtree re-homed by a max_mds change keeps its
# hard-link state visible to the new owner


def dirfrag_oid(ino: int, frag: int = 0) -> str:
    """Fragment object of a directory (reference CDir backing store:
    ``<ino-hex>.<frag-hex>``); fragment 0 is also where an over-size
    directory's fragtree row lives."""
    return f"{ino:x}.{frag:08x}"


# the fragtree row inside fragment 0's omap.  NUL is illegal in a
# dentry name, so this key can never collide with a real entry.
FRAGTREE_KEY = "\x00fragtree"
DIRFRAG_MAX = 256               # split ceiling (2^8 fragments)


def frag_of(name: str, nfrags: int) -> int:
    """Dentry → fragment (reference ceph_frag hash placement; a
    power-of-two modulo keeps redistribution local on split: a row in
    frag f moves to f or f+old_n, nowhere else)."""
    import zlib
    return zlib.crc32(name.encode()) % nfrags if nfrags > 1 else 0


def data_oid(ino: int, objno: int) -> str:
    """File data object name (reference ``<ino-hex>.<objno-08x>``)."""
    return f"{ino:x}.{objno:08x}"


SNAPS_OID = "mds_snaps"     # registry omap: "<dino-hex>\0<name>" → json


def snap_manifest_oid(snapid: int, ino: int) -> str:
    """Frozen dentry table of directory `ino` as of snapshot
    `snapid` (reference: snapshotted metadata lives in the dirfrag
    objects keyed by snapid; a separate manifest object is the
    eager-copy analog)."""
    return f"snapmeta.{snapid}.{ino:x}"


def _now() -> float:
    return time.time()


class MDSDaemon(Dispatcher):
    def __init__(self, name: str, monmap, *,
                 beacon_interval: float = 0.4,
                 flush_interval: float = 2.0, auth=None):
        self.name = name
        self.monmap = monmap
        self.auth = auth
        self.beacon_interval = beacon_interval
        self.flush_interval = flush_interval
        self.monc = MonClient(monmap, entity=f"mds.{name}",
                              auth=auth)
        self.msgr = Messenger(
            f"mds.{name}",
            **(auth.msgr_kwargs(f"mds.{name}") if auth else {}))
        self.msgr.add_dispatcher(self)
        self.lock = threading.RLock()
        self.state = "boot"           # boot / standby / active
        self.fsmap = FSMap()
        self.rank = -1
        self.fscid = -1
        self.addr = None
        self.running = False
        self._beacon_seq = 0
        self._thread: threading.Thread | None = None
        # active-state machinery
        self.rados: Rados | None = None
        self.meta: IoCtx | None = None
        self.data: IoCtx | None = None
        # dir ino → {dentry: inode record}; dirty deltas per dir
        self._dirs: dict[int, dict[str, dict]] = {}
        self._frags_cache: dict[int, int] = {}
        # split a dirfrag when its entry count exceeds this
        # (reference mds_bal_split_size)
        self.dirfrag_split_size = 10000
        self._dirty_set: dict[int, dict[str, dict]] = {}
        self._dirty_rm: dict[int, set[str]] = {}
        self._jseq = 0                # next journal event seq
        self._jfirst = 0              # lowest unflushed journal seq
        self._completed: dict[tuple[str, int], dict] = {}
        self._next_ino = 0
        self._ino_limit = 0
        self._last_flush = 0.0
        self.sessions: dict[str, int] = {}
        # observability (reference: every daemon has PerfCounters +
        # an AdminSocket — `ceph daemon mds.X perf dump / session ls`)
        from ..core.admin_socket import AdminSocket, default_path
        from ..core.perf_counters import PerfCountersBuilder
        pb = PerfCountersBuilder(f"mds.{name}")
        pb.add_u64_counter("request", "client requests served")
        pb.add_u64_counter("reply", "client replies sent")
        pb.add_u64_counter("journal_events", "journal events appended")
        pb.add_u64_counter("replays", "journal replays performed")
        self.perf = pb.create_perf_counters()
        self.admin_socket = AdminSocket(default_path(f"mds.{name}"))
        self.admin_socket.register(
            "perf dump", lambda c: self.perf.dump(),
            "dump perf counters")
        self.admin_socket.register(
            "status", lambda c: {
                "name": self.name, "state": self.state,
                "rank": self.rank, "fscid": self.fscid,
                "journal_seq": self._jseq,
                "cached_dirs": len(self._dirs)},
            "daemon status")
        self.admin_socket.register(
            "session ls", lambda c: [
                {"client": cl, "seq": seq}
                for cl, seq in sorted(self.sessions.items())],
            "open client sessions")
        from ..core.mempool import dump_mempools
        self.admin_socket.register(
            "dump_mempools", lambda c: dump_mempools(),
            "per-pool allocation accounting")

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        self.addr = self.msgr.bind()
        self.admin_socket.start()
        self.running = True
        self.monc.on_fsmap = self._on_fsmap
        self.monc.sub_want("fsmap", 0)
        self._send_beacon()
        self.state = "standby"
        self._thread = threading.Thread(
            target=self._beacon_loop, name=f"mds.{self.name}-beacon",
            daemon=True)
        self._thread.start()
        return self

    def shutdown(self):
        self.running = False
        with self.lock:
            if self.state == "active":
                try:
                    self._flush(trim=True)
                except Exception:     # noqa: BLE001 — fs may be gone
                    pass
        if self.rados is not None:
            self.rados.shutdown()
            self.rados = None
        self.admin_socket.shutdown()
        self.monc.shutdown()
        self.msgr.shutdown()

    def kill(self):
        """Hard-stop without flushing — the failover test's crash:
        journaled-but-unflushed metadata must survive via replay."""
        self.running = False
        self.admin_socket.shutdown()
        if self.rados is not None:
            self.rados.shutdown()
            self.rados = None
        self.monc.shutdown()
        self.msgr.shutdown()

    def _send_beacon(self):
        self._beacon_seq += 1
        self.monc.send(MM.MMDSBeacon(
            name=self.name, addr=[self.addr.host, self.addr.port],
            state=self.state, seq=self._beacon_seq))

    def _beacon_loop(self):
        while self.running:
            self._send_beacon()
            with self.lock:
                if self.state == "active" and self.meta is not None \
                        and _now() - self._last_flush \
                        > self.flush_interval:
                    try:
                        self._flush(trim=True)
                    except Exception:   # noqa: BLE001 — cluster churn;
                        pass            # journal still has everything
                elif self.state != "active":
                    # a transiently failed activation retries while
                    # the map still names us active (pools may have
                    # been mid-create on the first attempt)
                    me = self.fsmap.mds_info.get(self.name)
                    if me is not None and me.state == STATE_ACTIVE:
                        try:
                            self._activate(me.fscid, me.rank)
                        except Exception:   # noqa: BLE001
                            pass
            time.sleep(self.beacon_interval)

    # -- fsmap consumption -------------------------------------------------
    def _on_fsmap(self, epoch: int, fsmap_dict: dict):
        with self.lock:
            self.fsmap = FSMap.from_dict(fsmap_dict)
            # subtree ownership is a pure function of max_mds: when it
            # changes, flush everything journaled to the dirfrags and
            # drop caches so the NEW owner of any re-homed subtree
            # reads current state from RADOS (the static-partition
            # stand-in for the reference Migrator's export flush)
            if self.state == "active" and self.meta is not None:
                fs = self.fsmap.filesystems.get(self.fscid)
                if fs is not None and \
                        fs.max_mds != getattr(self, "_last_max_mds",
                                              fs.max_mds):
                    try:
                        self._flush(trim=True)
                    except Exception:   # noqa: BLE001
                        pass
                    self._dirs.clear()
                    self._frags_cache.clear()
                    if getattr(self, "_inode_cache", None):
                        self._inode_cache.clear()
                    if self.rank == 0:
                        # a live shrink orphans demoted ranks'
                        # journals (their daemons may be dead):
                        # adopt them now, not only at activation
                        try:
                            self._replay_orphan_journals(fs.max_mds)
                        except Exception:   # noqa: BLE001
                            pass
                if fs is not None:
                    self._last_max_mds = fs.max_mds
            me = self.fsmap.mds_info.get(self.name)
            if me is not None and me.state == STATE_ACTIVE \
                    and self.state != "active":
                try:
                    self._activate(me.fscid, me.rank)
                except Exception:   # noqa: BLE001 — pools may still be
                    # creating; the next fsmap push (or beacon-driven
                    # re-promotion) retries
                    self.state = "standby"
            elif (me is None or me.state != STATE_ACTIVE) \
                    and self.state == "active":
                # mon failed us (partition zombie): drop rank, the
                # reference respawns — we fall back to standby
                self._deactivate()

    # -- activation / journal replay --------------------------------------
    def _activate(self, fscid: int, rank: int):
        fs = self.fsmap.filesystems[fscid]
        try:
            self.rados = Rados(self.monmap,
                               name=f"client.mds-{self.name}",
                               auth=self.auth).connect()
            self.meta = IoCtx(self.rados, fs.metadata_pool, "")
            self.data = IoCtx(self.rados, fs.data_pool, "")
            self.rank = rank
            self.fscid = fscid
            self._last_max_mds = fs.max_mds
            self._dirs.clear()
            self._frags_cache.clear()
            self._dirty_set.clear()
            self._dirty_rm.clear()
            self._completed.clear()
            self._replay_journal()
            if rank == 0:
                self._replay_orphan_journals(fs.max_mds)
            self._load_inotable()
        except Exception:
            if self.rados is not None:
                self.rados.shutdown()
                self.rados = None
            self.meta = self.data = None
            raise
        self.state = "active"
        self._last_flush = _now()
        self._send_beacon()

    def _deactivate(self):
        if self.meta is not None:
            try:
                # a demoted rank's journaled metadata must land in the
                # dirfrags — nobody replays a demoted rank's journal
                # while it stays within max_mds bounds
                self._flush(trim=True)
            except Exception:   # noqa: BLE001 — pools may be gone
                pass
        self.state = "standby"
        self.rank = -1
        self._dirs.clear()
        self._frags_cache.clear()
        self._dirty_set.clear()
        self._dirty_rm.clear()
        self.sessions.clear()
        if self.rados is not None:
            self.rados.shutdown()
            self.rados = None
        self.meta = self.data = None

    @property
    def _journal_oid(self) -> str:
        return JHEAD.format(rank=max(self.rank, 0))

    @property
    def _inotable_oid(self) -> str:
        return INOTABLE.format(rank=max(self.rank, 0))

    @property
    def _inodes_oid(self) -> str:
        return INODES

    # -- multi-link inode rows --------------------------------------------
    # (reference: a hard link makes the inode shared — the reference
    # keeps the inode on the primary dentry and "remote" dentries
    # reference it by ino; here shared inodes move into an inode-row
    # omap and every dentry becomes a remote stub)
    def _inode_row(self, ino: int) -> dict | None:
        cache = getattr(self, "_inode_cache", None)
        if cache is None:
            cache = self._inode_cache = {}
        if ino in cache:
            return cache[ino]
        try:
            raw = self.meta.omap_get(self._inodes_oid).get(str(ino))
        except ObjectNotFound:
            raw = None
        row = json.loads(raw.decode()) if raw else None
        cache[ino] = row
        return row

    def _inode_apply(self, sub: list):
        """'iset'/'irm' journal sub-ops write through (idempotent)."""
        cache = getattr(self, "_inode_cache", None)
        if cache is None:
            cache = self._inode_cache = {}
        if sub[0] == "iset":
            _, ino, row = sub
            cache[int(ino)] = row
            self.meta.omap_set(self._inodes_oid, {
                str(ino): json.dumps(row).encode()})
        elif sub[0] == "irm":
            _, ino = sub
            cache[int(ino)] = None
            try:
                self.meta.omap_rm_keys(self._inodes_oid, [str(ino)])
            except ObjectNotFound:
                pass

    def _resolve_rec(self, rec: dict) -> dict:
        """Overlay the shared inode row onto a remote dentry stub."""
        if rec and rec.get("remote"):
            row = self._inode_row(rec["ino"])
            if row:
                rec = dict(rec, **row)
        return rec

    def _replay_journal(self):
        """Apply every journaled event to the backing dirfrags, then
        trim (reference MDLog replay on rank takeover)."""
        self.perf.inc("replays")
        try:
            entries = self.meta.omap_get(self._journal_oid)
        except ObjectNotFound:
            self._jseq = self._jfirst = 1
            return
        seqs = sorted(int(k[1:]) for k in entries if k.startswith("e"))
        for seq in seqs:
            ev = json.loads(entries[f"e{seq:020d}"].decode())
            self._apply_event(ev)
            if ev.get("client") is not None:
                self._completed[(ev["client"], ev["tid"])] = \
                    ev.get("reply", {"rc": 0})
        self._jseq = (seqs[-1] + 1) if seqs else 1
        self._jfirst = seqs[0] if seqs else self._jseq
        self._flush(trim=True)

    def _replay_orphan_journals(self, max_mds: int):
        """Shrink with a dead rank: its journal would be orphaned
        (acked metadata lost).  Rank 0 adopts journals of every rank
        >= max_mds at activation — events are idempotent sub-op lists,
        so replay + trim is safe (reference: the stopping rank drains
        its own journal; a dead one is recovered the same way)."""
        for r in range(max_mds, 16):
            oid = JHEAD.format(rank=r)
            try:
                entries = self.meta.omap_get(oid)
            except ObjectNotFound:
                continue
            seqs = sorted(int(k[1:]) for k in entries
                          if k.startswith("e"))
            for seq in seqs:
                ev = json.loads(entries[f"e{seq:020d}"].decode())
                self._apply_event(ev)
                if ev.get("client") is not None:
                    self._completed[(ev["client"], ev["tid"])] = \
                        ev.get("reply", {"rc": 0})
            if seqs:
                self._flush()
                try:
                    self.meta.omap_rm_keys(
                        oid, [f"e{s:020d}" for s in seqs])
                except ObjectNotFound:
                    pass

    def _apply_event(self, ev: dict):
        """Events are lists of idempotent sub-ops, safe to re-apply."""
        for sub in ev["subs"]:
            kind = sub[0]
            if kind == "set":
                _, dino, name, rec = sub
                self._dir(dino)[name] = rec
                self._dirty_set.setdefault(dino, {})[name] = rec
                self._dirty_rm.get(dino, set()).discard(name)
            elif kind == "rm":
                _, dino, name = sub
                self._dir(dino).pop(name, None)
                self._dirty_rm.setdefault(dino, set()).add(name)
                self._dirty_set.get(dino, {}).pop(name, None)
            elif kind in ("iset", "irm"):
                self._inode_apply(sub)
            elif kind == "inotable":
                _, limit = sub
                cur = self._backing_inotable()
                if limit > cur:
                    self.meta.omap_set(self._inotable_oid,
                                       {"next": str(limit).encode()})
                self._ino_limit = max(self._ino_limit, limit)

    # -- inode table -------------------------------------------------------
    def _backing_inotable(self) -> int:
        try:
            kv = self.meta.omap_get(self._inotable_oid)
            return int(kv.get("next", b"0"))
        except ObjectNotFound:
            return 0

    def _load_inotable(self):
        # rank-disjoint inode number spaces (reference: per-rank
        # inotables partition a prealloc range): rank r allocates from
        # r << 40, so two ranks can never mint the same ino
        rank_base = (max(self.rank, 0) << 40) + ROOT_INO + 1
        base = max(self._backing_inotable(), rank_base,
                   self._ino_limit)
        self._next_ino = base
        self._ino_limit = base

    def _alloc_ino(self) -> tuple[int, list]:
        """→ (ino, extra journal sub-ops claiming a fresh chunk)."""
        subs = []
        if self._next_ino >= self._ino_limit:
            self._ino_limit = self._next_ino + INO_CHUNK
            subs.append(["inotable", self._ino_limit])
        ino = self._next_ino
        self._next_ino += 1
        return ino, subs

    # -- dirfrag cache -----------------------------------------------------
    def _nfrags(self, ino: int) -> int:
        """Fragment count from the directory's fragtree row (frag 0);
        1 ⇒ unfragmented."""
        n = self._frags_cache.get(ino)
        if n is None:
            try:
                row = self.meta.omap_get(
                    dirfrag_oid(ino), keys=[FRAGTREE_KEY]
                ).get(FRAGTREE_KEY)
                n = int(json.loads(bytes(row))["nfrags"]) if row else 1
            except ObjectNotFound:
                n = 1
            self._frags_cache[ino] = n
        return n

    def _dir(self, ino: int) -> dict[str, dict]:
        d = self._dirs.get(ino)
        if d is None:
            d = self._read_dir_backing(ino)
            self._dirs[ino] = d
        return d

    def _read_dir_backing(self, ino: int) -> dict[str, dict]:
        """Uncached merged view of every fragment.  A row found in a
        fragment its hash no longer points at is an interrupted
        split's leftover: the correctly-placed copy wins the merge and
        the stale one is removed on the spot (self-healing — without
        this, a later unlink would only reach the new home and the
        stale copy would resurrect on the next cache drop)."""
        # fragment 0 carries the fragtree row: one read serves both
        # the count and the rows (the split-count probe and the data
        # read used to be two round trips)
        try:
            raw0 = self.meta.omap_get(dirfrag_oid(ino, 0))
        except ObjectNotFound:
            raw0 = {}
        ft = raw0.get(FRAGTREE_KEY)
        nf = int(json.loads(bytes(ft))["nfrags"]) if ft else 1
        self._frags_cache[ino] = nf
        d: dict[str, dict] = {}
        stale: dict[int, list[str]] = {}

        def absorb(f: int, raw: dict):
            for k, v in raw.items():
                if k == FRAGTREE_KEY:
                    continue
                if frag_of(k, nf) != f:
                    # never authoritative: the split wrote the new
                    # home BEFORE bumping the fragtree, so a live row
                    # always has a correctly-placed copy
                    stale.setdefault(f, []).append(k)
                    continue
                d[k] = json.loads(v.decode())

        absorb(0, raw0)
        for f in range(1, nf):
            try:
                absorb(f, self.meta.omap_get(dirfrag_oid(ino, f)))
            except ObjectNotFound:
                continue
        # NB: rows a pre-bump-interrupted split left in [nf, 2nf) are
        # NOT probed here — they are invisible to reads (loops stop at
        # nf) and _maybe_split sanitizes its target fragments before
        # merging, so they can never resurrect.  Probing them from a
        # reader would both cost an extra round trip per load and race
        # the OWNER rank's in-flight split (sweeping rows it just
        # wrote, before the bump makes them authoritative).
        for f, names in stale.items():
            try:
                self.meta.omap_rm_keys(dirfrag_oid(ino, f),
                                       sorted(names))
            except Exception:   # noqa: BLE001 — healing is best-effort
                pass
        return d

    def _journal(self, subs: list, client=None, tid=None, reply=None):
        ev = {"subs": subs, "client": client, "tid": tid}
        if reply is not None:
            ev["reply"] = reply
        self.perf.inc("journal_events")
        seq = self._jseq
        self._jseq += 1
        self.meta.omap_set(self._journal_oid,
                           {f"e{seq:020d}": json.dumps(ev).encode()})
        for sub in subs:
            if sub[0] == "inotable":
                # table claims apply to backing immediately — a chunk
                # must never be re-handed after replay
                cur = self._backing_inotable()
                if sub[1] > cur:
                    self.meta.omap_set(self._inotable_oid,
                                       {"next": str(sub[1]).encode()})

    def _flush(self, trim: bool = False):
        """Write dirty dirfrag deltas to their fragment objects (each
        dentry routed by hash); optionally trim the journal entries
        they cover (reference MDLog trim).  Over-size directories
        split afterwards."""
        upto = self._jseq
        touched = set()
        for dino, sets in list(self._dirty_set.items()):
            if sets:
                nf = self._nfrags(dino)
                per: dict[int, dict] = {}
                for n, r in sets.items():
                    per.setdefault(frag_of(n, nf), {})[n] = \
                        json.dumps(r).encode()
                for f, rows in per.items():
                    self.meta.omap_set(dirfrag_oid(dino, f), rows)
                touched.add(dino)
            self._dirty_set.pop(dino, None)
        for dino, rms in list(self._dirty_rm.items()):
            if rms:
                nf = self._nfrags(dino)
                per_rm: dict[int, list] = {}
                for n in rms:
                    per_rm.setdefault(frag_of(n, nf), []).append(n)
                for f, names in per_rm.items():
                    try:
                        self.meta.omap_rm_keys(dirfrag_oid(dino, f),
                                               sorted(names))
                    except ObjectNotFound:
                        pass
            self._dirty_rm.pop(dino, None)
        for dino in touched:
            self._maybe_split(dino)
        if trim and upto > self._jfirst:
            keys = [f"e{s:020d}" for s in range(self._jfirst, upto)]
            try:
                self.meta.omap_rm_keys(self._journal_oid, keys)
            except ObjectNotFound:
                pass
            self._jfirst = upto
        self._last_flush = _now()

    def _maybe_split(self, dino: int):
        """Double the fragment count when a directory outgrows the
        split size (reference MDBalancer/CDir::split).  Redistribution
        is local by construction: a dentry in frag f moves to f or
        f + old_n (exactly, for power-of-two counts).  Crash safety:
        (1) write moved rows to their NEW fragments, (2) bump the
        fragtree, (3) remove the old copies — an interruption leaves
        at worst a row duplicated in its old fragment, which
        _read_dir_backing detects by re-hashing and lazily removes."""
        old_n = self._nfrags(dino)
        d = self._dir(dino)
        if old_n >= DIRFRAG_MAX or \
                len(d) <= self.dirfrag_split_size * old_n:
            return
        new_n = old_n * 2
        per: dict[int, dict[str, bytes]] = {}
        for name, rec in d.items():
            per.setdefault(frag_of(name, new_n), {})[name] = \
                json.dumps(rec).encode()
        # (1) the moved rows land in their new homes first — after
        # dropping any leftovers a previously-interrupted split left
        # there (omap_set merges; a stale row would otherwise ride
        # into the new fragment as a resurrected dentry)
        for f in range(old_n, new_n):
            try:
                existing = set(self.meta.omap_get(
                    dirfrag_oid(dino, f)))
            except ObjectNotFound:
                existing = set()
            dead = sorted(existing - set(per.get(f, {}))
                          - {FRAGTREE_KEY})
            if dead:
                self.meta.omap_rm_keys(dirfrag_oid(dino, f), dead)
            if per.get(f):
                self.meta.omap_set(dirfrag_oid(dino, f), per[f])
        # (2) only now does the fragtree say the split happened
        self.meta.omap_set(dirfrag_oid(dino, 0), {
            FRAGTREE_KEY: json.dumps({"nfrags": new_n}).encode()})
        self._frags_cache[dino] = new_n
        # (3) drop the moved rows from their old fragments
        for f in range(old_n):
            dead = sorted(per.get(f + old_n, {}))
            if dead:
                try:
                    self.meta.omap_rm_keys(dirfrag_oid(dino, f), dead)
                except ObjectNotFound:
                    pass

    def _remove_dir_backing(self, ino: int):
        """Remove every fragment object of a (now empty) directory."""
        for f in range(max(self._nfrags(ino), 1)):
            try:
                self.meta.remove(dirfrag_oid(ino, f))
            except ObjectNotFound:
                pass
        self._frags_cache.pop(ino, None)

    # -- dispatch ----------------------------------------------------------
    def ms_dispatch(self, msg) -> bool:
        if isinstance(msg, M.MClientSession):
            with self.lock:
                if msg.op == "request_open":
                    self.sessions[msg.client] = msg.seq or 0
                    op = "open"
                else:
                    self.sessions.pop(msg.client, None)
                    op = "close"
            try:
                msg.connection.send_message(M.MClientSession(
                    op=op, client=msg.client, seq=msg.seq))
            except ConnectionError:
                pass
            return True
        if isinstance(msg, M.MClientRequest):
            with self.lock:
                self.perf.inc("request")
                rc, outs, result = self._handle_request(msg)
            try:
                msg.connection.send_message(M.MClientReply(
                    tid=msg.tid, rc=rc, outs=outs, result=result))
                self.perf.inc("reply")
            except ConnectionError:
                pass
            return True
        return False

    def _handle_request(self, msg) -> tuple[int, str, object]:
        if self.state != "active":
            return -108, "mds not active", None      # ESHUTDOWN analog
        key = (msg.client, msg.tid)
        if key in self._completed:
            done = self._completed[key]
            return done.get("rc", 0), "", done.get("result")
        args = msg.args or {}
        # dentry-name hygiene, enforced once for every op: NUL is the
        # fragtree row's namespace (FRAGTREE_KEY) and '/' would break
        # path resolution — both are illegal in POSIX names anyway.
        # ""/"."/".." are refused only for mutations: the read path
        # deliberately uses name="" for the root lookup
        mutating = msg.op not in ("lookup", "getattr", "readdir")
        for k in ("name", "sname", "dname"):
            n = args.get(k)
            if not isinstance(n, str):
                continue
            if "\x00" in n or "/" in n or \
                    (mutating and n in ("", ".", "..")):
                return -22, f"invalid dentry name {n!r}", None
        handler = getattr(self, f"_op_{msg.op}", None)
        if handler is None:
            return -22, f"unknown mds op {msg.op!r}", None
        try:
            rc, outs, result = handler(args, msg.client, msg.tid)
        except ObjectNotFound:
            return -2, "metadata object vanished", None
        except Exception as e:      # noqa: BLE001 — a RADOS error
            # (pool churn, mon timeout) must become a reply, not a
            # swallowed dispatcher exception the client times out on
            return -5, f"mds op {msg.op!r} failed: {e!r}", None
        return rc, outs, result

    # -- read ops ----------------------------------------------------------
    @staticmethod
    def _root_rec() -> dict:
        return {"ino": ROOT_INO, "type": "dir", "size": 0, "mtime": 0}

    def _op_lookup(self, args, client, tid):
        dino, name = args["dir"], args["name"]
        if dino == ROOT_INO and name == "":
            return 0, "", self._root_rec()
        rec = self._dir(dino).get(name)
        if rec is None:
            return -2, f"no dentry {name!r}", None
        return 0, "", self._resolve_rec(rec)

    _op_getattr = _op_lookup

    def _op_readdir(self, args, client, tid):
        d = self._dir(args["dir"])
        return 0, "", sorted([name, self._resolve_rec(rec)]
                             for name, rec in d.items())

    # -- mutations (journaled, deduped) ------------------------------------
    def _mutate(self, subs, client, tid, result=None):
        self._journal(subs, client=client, tid=tid,
                      reply={"rc": 0, "result": result})
        for s in [s for s in subs if s[0] != "inotable"]:
            self._apply_cache(s)
        self._completed[(client, tid)] = {"rc": 0, "result": result}
        return 0, "", result

    def _apply_cache(self, sub):
        if sub[0] == "set":
            _, dino, name, rec = sub
            self._dir(dino)[name] = rec
            self._dirty_set.setdefault(dino, {})[name] = rec
            self._dirty_rm.get(dino, set()).discard(name)
        elif sub[0] == "rm":
            _, dino, name = sub
            self._dir(dino).pop(name, None)
            self._dirty_rm.setdefault(dino, set()).add(name)
            self._dirty_set.get(dino, {}).pop(name, None)
        elif sub[0] in ("iset", "irm"):
            self._inode_apply(sub)

    def _op_mkdir(self, args, client, tid):
        dino, name = args["dir"], args["name"]
        if name in self._dir(dino):
            return -17, f"{name!r} exists", None
        ino, extra = self._alloc_ino()
        rec = {"ino": ino, "type": "dir", "size": 0, "mtime": _now()}
        return self._mutate(extra + [["set", dino, name, rec]],
                            client, tid, rec)

    def _op_create(self, args, client, tid):
        dino, name = args["dir"], args["name"]
        existing = self._dir(dino).get(name)
        if existing is not None:
            if args.get("excl"):
                # O_CREAT|O_EXCL: EEXIST whatever the dentry is —
                # including a (possibly dangling) symlink (POSIX)
                return -17, f"{name!r} exists", None
            if existing["type"] != "file":
                return -21, f"{name!r} is a directory", None
            return 0, "", self._resolve_rec(existing)
        ino, extra = self._alloc_ino()
        rec = {"ino": ino, "type": "file", "size": 0, "mtime": _now()}
        if args.get("layout"):
            rec["layout"] = args["layout"]
        return self._mutate(extra + [["set", dino, name, rec]],
                            client, tid, rec)

    def _op_setattr(self, args, client, tid):
        dino, name = args["dir"], args["name"]
        rec = self._dir(dino).get(name)
        if rec is None:
            return -2, f"no dentry {name!r}", None
        if rec.get("remote"):
            # shared inode: attrs live on the inode row so every
            # link sees them (reference: inode, not dentry, state)
            row = dict(self._inode_row(rec["ino"]) or {})
            for fld in ("size", "mtime"):
                if args.get(fld) is not None:
                    row[fld] = args[fld]
            rc = self._mutate([["iset", rec["ino"], row]], client,
                              tid, dict(rec, **row))
            return rc
        rec = dict(rec)
        for fld in ("size", "mtime"):
            if args.get(fld) is not None:
                rec[fld] = args[fld]
        return self._mutate([["set", dino, name, rec]], client, tid, rec)

    def _op_unlink(self, args, client, tid):
        dino, name = args["dir"], args["name"]
        rec = self._dir(dino).get(name)
        if rec is None:
            return -2, f"no dentry {name!r}", None
        if rec["type"] == "dir":
            return -21, f"{name!r} is a directory", None
        if rec.get("remote"):
            subs, purge_rec = self._drop_remote_link(rec)
            rc = self._mutate([["rm", dino, name]] + subs, client, tid)
            if purge_rec is not None:
                self._purge_file(purge_rec)
            return rc
        rc = self._mutate([["rm", dino, name]], client, tid)
        if rec["type"] == "file":
            self._purge_file(rec)
        return rc

    def _drop_remote_link(self, rec: dict):
        """One link to a shared inode goes away: → (journal subs,
        purge_rec-or-None) — shared by unlink and rename-overwrite so
        the nlink bookkeeping cannot diverge between them."""
        row = dict(self._inode_row(rec["ino"]) or {"nlink": 1})
        nlink = int(row.get("nlink", 1)) - 1
        if nlink > 0:
            row["nlink"] = nlink
            return [["iset", rec["ino"], row]], None
        return [["irm", rec["ino"]]], dict(rec, **row)

    def _op_link(self, args, client, tid):
        """Hard link: args {tdir, tname} (existing file) + {dir, name}
        (new dentry).  Both dentries become remote stubs over a shared
        inode row (reference: primary + remote dentry on one inode)."""
        tdino, tname = args["tdir"], args["tname"]
        dino, name = args["dir"], args["name"]
        target = self._dir(tdino).get(tname)
        if target is None:
            return -2, f"no dentry {tname!r}", None
        if target["type"] != "file":
            return -1, "hard links to non-files are not allowed", None
        if name in self._dir(dino):
            return -17, f"{name!r} exists", None
        subs = []
        if target.get("remote"):
            row = dict(self._inode_row(target["ino"]) or {"nlink": 1})
            row["nlink"] = int(row.get("nlink", 1)) + 1
            stub = dict(target)
        else:
            row = {"size": target.get("size", 0),
                   "mtime": target.get("mtime", 0), "nlink": 2}
            stub = {k: v for k, v in target.items()
                    if k not in ("size", "mtime")}
            stub["remote"] = True
            subs.append(["set", tdino, tname, stub])
        subs.append(["iset", target["ino"], row])
        subs.append(["set", dino, name, stub])
        return self._mutate(subs, client, tid,
                            self._resolve_rec(stub))

    def _op_symlink(self, args, client, tid):
        dino, name = args["dir"], args["name"]
        if name in self._dir(dino):
            return -17, f"{name!r} exists", None
        ino, extra = self._alloc_ino()
        rec = {"ino": ino, "type": "symlink",
               "target": str(args["target"]), "size": 0,
               "mtime": _now()}
        return self._mutate(extra + [["set", dino, name, rec]],
                            client, tid, rec)

    # -- snapshots (.snap; reference SnapServer + snaprealms) --------------
    # The data plane rides pool snapshots (OSD-side COW clones, exactly
    # the reference's SnapContext machinery); the metadata plane is an
    # eager copy of the subtree's RESOLVED dentry tables into manifest
    # objects (the reference COWs dirfrags lazily per snapid — same
    # observable behavior, simpler recovery story).
    def _data_pool_ioctx(self):
        from ..osdc.librados import IoCtx
        pid = self.data.pool_id
        pname = self.data.objecter.osdmap.pools[pid].name
        return IoCtx(self.rados, pid, pname)

    def _snap_registry(self) -> dict[str, dict]:
        try:
            rows = self.meta.omap_get(SNAPS_OID)
        except ObjectNotFound:
            return {}
        return {k: json.loads(bytes(v)) for k, v in rows.items()}

    def _op_mksnap(self, args, client, tid):
        from ..osdc.librados import Error as RadosError
        dino, name = args["dir"], args["name"]
        if dino == ROOT_INO and \
                getattr(self, "_last_max_mds", 1) > 1:
            # "/" spans subtree ranks; freezing it would need a
            # cross-rank journal flush (reference: snap realms span
            # ranks via the SnapServer's global table) — refuse
            # loudly rather than snapshot other ranks' unflushed state
            return (-22, "snapshot of / needs max_mds=1 "
                         "(subtrees span ranks)", None)
        key = f"{dino:x}\x00{name}"
        if key in self._snap_registry():
            return -17, f"snapshot {name!r} exists", None
        # journaled-but-unflushed metadata must reach the backing
        # store first: the manifest copy below reads the dirfrags
        # (this op was routed to the subtree's OWNER rank, so our
        # journal is the only one covering it)
        self._flush(trim=True)
        psnap = f"cfs-{dino:x}-{name}"
        ioctx = self._data_pool_ioctx()
        try:
            ioctx.create_snap(psnap)
        except RadosError:
            # a crash between pool-snap creation and the registry
            # write left this pool snap behind: adopt it instead of
            # poisoning the name forever
            pass
        snapid = ioctx.snap_lookup(psnap)
        stack = [dino]
        while stack:
            d = stack.pop()
            rows = {}
            for n, rec in self._dir(d).items():
                rec = self._resolve_rec(rec)
                rows[n] = json.dumps(rec).encode()
                if rec["type"] == "dir":
                    stack.append(rec["ino"])
            if rows:
                self.meta.omap_set(snap_manifest_oid(snapid, d), rows)
        info = {"snapid": snapid, "pool_snap": psnap,
                "created": _now()}
        self.meta.omap_set(SNAPS_OID, {
            key: json.dumps(info).encode()})
        result = dict(info, name=name)
        # journal the completion so a client RESEND (lost reply,
        # failover) replays the original answer instead of -17
        self._journal([], client=client, tid=tid,
                      reply={"rc": 0, "result": result})
        self._completed[(client, tid)] = {"rc": 0, "result": result}
        return 0, "", result

    def _op_rmsnap(self, args, client, tid):
        dino, name = args["dir"], args["name"]
        key = f"{dino:x}\x00{name}"
        info = self._snap_registry().get(key)
        if info is None:
            return -2, f"no snapshot {name!r}", None
        snapid = info["snapid"]
        # drop the manifests by walking the frozen tree itself
        stack = [dino]
        while stack:
            d = stack.pop()
            try:
                rows = self.meta.omap_get(snap_manifest_oid(snapid, d))
            except ObjectNotFound:
                continue
            for v in rows.values():
                rec = json.loads(bytes(v))
                if rec.get("type") == "dir":
                    stack.append(rec["ino"])
            try:
                self.meta.remove(snap_manifest_oid(snapid, d))
            except ObjectNotFound:
                pass
        try:
            self._data_pool_ioctx().remove_snap(info["pool_snap"])
        except Exception:   # noqa: BLE001 — pool snap may be gone
            pass
        self.meta.omap_rm_keys(SNAPS_OID, [key])
        self._journal([], client=client, tid=tid,
                      reply={"rc": 0, "result": None})
        self._completed[(client, tid)] = {"rc": 0, "result": None}
        return 0, "", None

    def _op_lssnap(self, args, client, tid):
        dino = args["dir"]
        pre = f"{dino:x}\x00"
        out = [dict(info, name=k[len(pre):])
               for k, info in self._snap_registry().items()
               if k.startswith(pre)]
        return 0, "", sorted(out, key=lambda s: s["snapid"])

    def _op_snapinfo(self, args, client, tid):
        key = f"{args['dir']:x}\x00{args['snap']}"
        info = self._snap_registry().get(key)
        if info is None:
            return -2, f"no snapshot {args['snap']!r}", None
        return 0, "", dict(info, name=args["snap"])

    def _op_snap_readdir(self, args, client, tid):
        try:
            rows = self.meta.omap_get(
                snap_manifest_oid(args["snapid"], args["dir"]))
        except ObjectNotFound:
            rows = {}
        return 0, "", sorted(
            [n, json.loads(bytes(v))] for n, v in rows.items())

    def _op_snap_lookup(self, args, client, tid):
        try:
            rows = self.meta.omap_get(
                snap_manifest_oid(args["snapid"], args["dir"]),
                keys=[args["name"]])
        except ObjectNotFound:
            rows = {}
        row = rows.get(args["name"])
        if row is None:
            return -2, f"no snapped dentry {args['name']!r}", None
        return 0, "", json.loads(bytes(row))

    def _subtree_owner(self, top_name: str) -> int:
        """The rank owning a top-level directory's subtree (the
        static partition rule clients route by)."""
        import zlib
        fs = self.fsmap.filesystems.get(self.fscid)
        n = max(1, fs.max_mds) if fs is not None else 1
        return zlib.crc32(top_name.encode()) % n

    def _op_rmdir(self, args, client, tid):
        dino, name = args["dir"], args["name"]
        rec = self._dir(dino).get(name)
        if rec is None:
            return -2, f"no dentry {name!r}", None
        if rec["type"] != "dir":
            return -20, f"{name!r} is not a directory", None
        if dino == ROOT_INO and \
                self._subtree_owner(name) != self.rank:
            # the dir's CONTENTS are another rank's subtree: check
            # emptiness on a FRESH uncached read (our cached copy can
            # be stale and must never stick — the owner's unflushed
            # journal window remains the slice's known gap vs the
            # reference's cross-MDS slave requests)
            self._dirs.pop(rec["ino"], None)
            self._frags_cache.pop(rec["ino"], None)
            if self._read_dir_backing(rec["ino"]):
                return -39, f"{name!r} not empty", None
        elif self._dir(rec["ino"]):
            return -39, f"{name!r} not empty", None
        rc = self._mutate([["rm", dino, name]], client, tid)
        self._remove_dir_backing(rec["ino"])
        self._dirs.pop(rec["ino"], None)
        return rc

    def _descends_from(self, root_ino: int, needle: int) -> bool:
        """True if `needle` is `root_ino` or inside its subtree."""
        stack = [root_ino]
        while stack:
            ino = stack.pop()
            if ino == needle:
                return True
            stack.extend(r["ino"] for r in self._dir(ino).values()
                         if r["type"] == "dir")
        return False

    def _op_rename(self, args, client, tid):
        sdino, sname = args["sdir"], args["sname"]
        ddino, dname = args["ddir"], args["dname"]
        rec = self._dir(sdino).get(sname)
        if rec is None:
            return -2, f"no dentry {sname!r}", None
        if rec["type"] == "dir" and \
                self._descends_from(rec["ino"], ddino):
            # POSIX EINVAL: a directory cannot move into its own
            # subtree (the detached cycle would orphan it)
            return -22, f"{sname!r} is an ancestor of the target", None
        target = self._dir(ddino).get(dname)
        purge = None
        if target is not None and \
                not (sdino == ddino and sname == dname):
            if target["type"] == "dir":
                if target["ino"] == rec["ino"]:
                    return 0, "", rec       # rename onto itself
                if rec["type"] != "dir":
                    return -21, f"{dname!r} is a directory", None
                if self._dir(target["ino"]):
                    return -39, f"{dname!r} not empty", None
            elif rec["type"] == "dir":
                return -20, f"{dname!r} is not a directory", None
            else:
                purge = target
        subs = [["rm", sdino, sname], ["set", ddino, dname, rec]]
        purge_rec = None
        if purge is not None:
            if purge.get("remote"):
                extra, purge_rec = self._drop_remote_link(purge)
                subs.extend(extra)
            elif purge["type"] == "file":
                purge_rec = purge
        rc = self._mutate(subs, client, tid, rec)
        if purge_rec is not None:
            self._purge_file(purge_rec)
        return rc

    def _purge_file(self, rec: dict):
        """Delete a dead file's data objects (reference purge queue —
        synchronous here; the namespace op already committed)."""
        from ..osdc.striper import FileLayout
        layout = rec.get("layout") or {}
        osize = layout.get("object_size", FileLayout.object_size)
        nobj = max(1, -(-int(rec.get("size", 0)) // osize))
        for objno in range(nobj):
            try:
                self.data.remove(data_oid(rec["ino"], objno))
            except ObjectNotFound:
                pass
