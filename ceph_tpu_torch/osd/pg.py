"""PG — placement group: peering, op engine, recovery, backends.

The port's copy of ``ceph_tpu.osd.pg``.

Reference behavior re-created (``src/osd/PG.{h,cc}``,
``src/osd/PeeringState.cc``, ``src/osd/PrimaryLogPG.cc``,
``src/osd/PGBackend.h``, ``src/osd/ReplicatedBackend.cc``,
``src/osd/ECBackend.cc``; SURVEY.md §3.5, §4.1–4.3):

- **Peering** (GetInfo → GetLog → Active): on every interval change the
  primary queries acting peers' ``pg_info``, adopts the authoritative
  log (highest ``last_update``), derives per-peer missing sets from log
  divergence, and activates the acting set;
- **Op engine**: client ``MOSDOp`` batches execute on the primary only;
  writes stamp an eversion, append a log entry, and fan out through the
  backend; duplicate requests are answered from the log (reqid dup
  detection); ops touching degraded objects wait for recovery
  (``wait_for_degraded_object``);
- **ReplicatedBackend**: primary-copy — apply locally, ship the same
  transaction in ``MOSDRepOp`` to every acting replica, ack the client
  when all commit;
- **ECBackend**: objects are erasure-coded through the port's EC
  plugins (``ceph_tpu_torch.ec``) on the daemon's device, writes and
  degraded reads through its ``BatchEngine``; shard *i* of every
  stripe lives in collection
  ``<pgid>s<i>`` on acting[i]; reads gather ``minimum_to_decode``
  shards and decode (systematic fast path reads data shards straight
  through); degraded objects reconstruct missing chunks from k
  survivors — the §4.3 all-gather path;
- **Recovery**: log-based — push newer objects to stale peers, pull
  what the primary itself lacks; EC recovery reconstructs the missing
  shard's chunk instead of copying it.

Threading: every entry point runs under the owning daemon's lock
(mirroring the reference's per-PG lock discipline); backends never
block on network replies — completions are continuation callbacks
fired by the reply dispatch path.
"""

from __future__ import annotations

import json
import time

import numpy as np

from ..crush.map import CRUSH_ITEM_NONE
from ..ec.interface import ECProfile
from ..ec.registry import create_erasure_code
from ..os_store import Transaction
from ..osd.osdmap import PGid
from ..scrub import engine as scrub_engine
# a shard's host CRC-32C (the read-side hinfo check, the hinfo of a
# reconstructed or unbatched chunk): crc32c bit for bit, at numpy speed
from ..scrub.crc32c import crc32c_blocks as crc32c
from . import messages as M
from .types import (DELETE, LogEntry, MODIFY, PGInfo, PGLog, ZERO)

META_OID = "_meta"          # per-PG meta object (info+log in omap)
SNAPMAP_OID = "_snapmapper"  # snap id → clone index (reference SnapMapper)
_SNAP_SEP = "\x00snap\x00"   # head oid + sep + seq = clone object name


def snap_clone_oid(oid: str, seq: int) -> str:
    return f"{oid}{_SNAP_SEP}{seq}"


def is_snap_clone(name: str) -> bool:
    return _SNAP_SEP in name


def _obj_meta(version, size: int, hinfo: int | None = None,
              extra: dict | None = None) -> bytes:
    """Object "_" attribute.  ``size`` is always the LOGICAL length;
    storage-efficiency extras describe the physical form: ``stored``
    (physical payload bytes), ``comp`` (compression header), ``dedup``
    (chunk manifest ``[[fp, len], ...]``)."""
    d = {"version": list(version), "size": size}
    if hinfo is not None:
        d["hinfo"] = hinfo
    if extra:
        d.update(extra)
    return json.dumps(d).encode()


def _meta_extra(meta: dict | None) -> dict | None:
    """The storage-efficiency extras of an existing "_" meta (to carry
    through rewrites that don't change the payload)."""
    if not meta:
        return None
    out = {k: meta[k] for k in ("stored", "comp", "dedup") if k in meta}
    return out or None


class PG:
    """One placement group as seen by one OSD (primary or replica).

    For EC pools each acting member instantiates the PG with its own
    ``shard`` index; collections are per-shard.
    """

    def __init__(self, daemon, pgid: PGid, pool):
        self.daemon = daemon
        self.pgid = pgid
        self.pool = pool
        self.acting: list[int] = []
        self.up: list[int] = []
        self.primary: int = -1
        self.shard: int = -1            # my index in acting (EC); -1 repl
        self.state = "reset"
        self.interval_epoch = 0
        self.info = PGInfo(pgid=str(pgid))
        self.log = PGLog()
        self.missing: dict[str, tuple | None] = {}
        # primary-only peering/recovery state
        self.peer_info: dict[int, PGInfo] = {}
        self.peer_missing: dict[int, dict[str, tuple | None]] = {}
        # what each peer SAYS it misses (exchanged during peering;
        # reference pg_missing_t) — unioned into peer_missing at
        # activation because the log diff can't see gaps behind an
        # already-adopted log
        self.peer_reported_missing: dict[int, dict] = {}
        # acting peers that confirmed THIS interval's activation (they
        # notify back on activate); _resend_activation skips them
        self.peer_activated: set[int] = set()
        self.waiting_for_active: list = []
        # RADOS backoff sessions (reference PG::Backoff): client
        # connections we told to block for this PG — released (unblock
        # sent) on activation; keyed by connection identity so one
        # block per session no matter how many ops raced in
        self.backoffs: dict[int, tuple[object, int]] = {}
        self._backoff_id = 0
        self._promote_waiters: dict[str, list] = {}
        self.waiting_for_object: dict[str, list] = {}
        self._queried: set[int] = set()
        # closed acting intervals, maintained by the daemon from the
        # full map history (reference PastIntervals); peering refuses
        # to activate while a maybe-went-rw interval since
        # last_epoch_started has no gathered representative
        self.past_intervals: list[dict] = []
        self._probe_targets: set[int] = set()
        # scrub state (primary-driven; reference src/osd/scrubber/)
        self.scrubbing = False
        self.last_scrub = 0.0
        self.last_deep_scrub = 0.0
        self.scrub_errors = 0
        self._scrub_tid = 0
        self._scrub_deep = True
        self._scrub_maps: dict[int, dict] = {}
        self._scrub_waiting: set[int] = set()
        # list-inconsistent-obj report from the last scrub that found
        # errors (primary; cleared by a clean scrub)
        self.inconsistent_objects: list[dict] = []
        # periodic scrub scheduling baseline: a never-scrubbed PG
        # waits a full interval from creation (no startup storm)
        self._scrub_stamp_floor = time.time()
        self._pulls: dict[int, str] = {}       # pull_tid → oid
        self._pull_tid = 0
        self._held_cache: list[int] | None = None   # see _held_shards
        # backfill (reference PrimaryLogPG backfill scan): peers whose
        # gap exceeds the log are refilled by walking the collection
        # in batches behind a cursor, not one giant synchronous push
        self.backfill_targets: dict[int, dict] = {}
        # watch/notify (reference src/osd/Watch.h): primary-resident
        # sessions oid → {watch_id: connection}; notifies pend until
        # every watcher acks (or the timeout fires)
        self.watchers: dict[str, dict[str, object]] = {}
        self._notifies: dict[int, dict] = {}
        self._notify_id = 0
        # storage-efficiency caches (codec keyed by pool algorithm,
        # chunker by the daemon's CDC target — both cheap to rebuild)
        self._codec_cache = None
        self._chunker_cache = None
        self.backend = (ECBackend(self) if pool.is_erasure()
                        else ReplicatedBackend(self))

    # -- identity ----------------------------------------------------------
    @property
    def is_primary(self) -> bool:
        return self.primary == self.daemon.whoami

    def cid_for_shard(self, shard: int) -> str:
        if self.pool.is_erasure():
            return f"{self.pgid}s{shard}"
        return str(self.pgid)

    @property
    def cid(self) -> str:
        return self.cid_for_shard(max(self.shard, 0))

    def acting_live(self) -> list[int]:
        """Acting members that are actually up in the current map."""
        m = self.daemon.osdmap
        return [o for o in self.acting
                if o != CRUSH_ITEM_NONE and m.is_up(o)]

    # -- storage efficiency (pool compression / dedup) ---------------------
    # The pool flags live on the OSDMap pool entry (self.pool is
    # refreshed on every map advance), so `osd pool set` takes effect
    # on the next write without touching the PG.  Reference:
    # BlueStore inline compression modes + the tiering-based dedup
    # engine (manifest objects over a refcounted chunk store).
    @property
    def compression_on(self) -> bool:
        mode = getattr(self.pool, "compression_mode", "none")
        return (mode in ("aggressive", "force")
                and bool(getattr(self.pool, "compression_algorithm",
                                 "")))

    @property
    def dedup_on(self) -> bool:
        return (bool(getattr(self.pool, "dedup_enable", False))
                and not self.pool.is_erasure())

    @property
    def efficiency_on(self) -> bool:
        return self.compression_on or self.dedup_on

    def _codec(self):
        from ..compress.registry import create_codec
        name = getattr(self.pool, "compression_algorithm", "") or "rle"
        if self._codec_cache is None or self._codec_cache.name != name:
            self._codec_cache = create_codec(name)
        return self._codec_cache

    def _chunker(self):
        if self._chunker_cache is None:
            from ..compress.chunker import Chunker
            avg = int(self.daemon.config.get("osd_dedup_chunk_avg")
                      or 4096)
            self._chunker_cache = Chunker(avg_size=avg)
        return self._chunker_cache

    def seal_payload(self, data: bytes, span, done):
        """Turn a logical payload into its stored form through the
        batch engine's comp lane.  ``done(err, stored, extra, ingest)``:
        ``stored`` = bytes to write to the object (b"" for dedup —
        the manifest in ``extra`` IS the object), ``extra`` = meta
        extras dict or None (None ⇒ plain object, bit-identical to
        efficiency-off), ``ingest`` = [(fp, frame)] chunk payloads the
        txn must dedup_ingest."""
        engine = self.daemon.batch_engine
        data = bytes(data)
        if self.dedup_on:
            mode = ("force" if getattr(self.pool, "compression_mode",
                                       "none") == "force"
                    else "aggressive")
            compress = self.compression_on

            def _chunked(comp):
                if comp.error is not None:
                    done(comp.error, None, None, None)
                    return
                spans = comp.value
                manifest = [[fp, ln] for _off, ln, fp in spans]
                uniq: dict[str, bytes] = {}
                for off, ln, fp in spans:
                    if fp not in uniq:
                        uniq[fp] = data[off:off + ln]
                self._seal_chunks(engine, manifest, uniq, compress,
                                  mode, span, done)

            engine.submit_fingerprint(self._chunker(), data, span=span,
                                      callback=_chunked)
            return
        if self.compression_on:
            mode = ("force" if getattr(self.pool, "compression_mode",
                                       "none") == "force"
                    else "aggressive")

            def _compressed(comp):
                if comp.error is not None:
                    done(comp.error, None, None, None)
                    return
                blob, hdr = comp.value
                if hdr is None:      # didn't shrink → stored verbatim
                    done(None, blob, None, [])
                else:
                    done(None, blob,
                         {"stored": len(blob), "comp": hdr}, [])

            engine.submit_compress(self._codec(), data, mode=mode,
                                   span=span, callback=_compressed)
            return
        done(None, data, None, [])

    def _seal_chunks(self, engine, manifest, uniq, compress, mode,
                     span, done):
        """Dedup phase 2: frame each unique chunk (compressing when
        the pool also enables compression — chunking happens on RAW
        content so identical chunks dedup across compression modes)."""
        from ..compress import dedup as dd
        if not uniq:
            done(None, b"", {"stored": 0, "dedup": manifest}, [])
            return
        if not compress:
            raws = {fp: dd.frame_raw(c) for fp, c in uniq.items()}
            # one ingest per manifest ENTRY (dup fps repeat): the
            # refcount invariant counts references, not unique chunks
            done(None, b"", {"stored": 0, "dedup": manifest},
                 [(fp, raws[fp]) for fp, _ln in manifest])
            return
        codec = self._codec()
        state = {"left": len(uniq), "err": None}
        frames: dict[str, bytes] = {}
        lock = self.daemon.lock

        def _one(fp, chunk):
            def _cb(comp):
                with lock:
                    if comp.error is not None:
                        if state["err"] is None:
                            state["err"] = comp.error
                    else:
                        blob, hdr = comp.value
                        frames[fp] = (dd.frame_raw(chunk) if hdr is None
                                      else dd.frame_sealed(blob, hdr))
                    state["left"] -= 1
                    if state["left"] == 0:
                        if state["err"] is not None:
                            done(state["err"], None, None, None)
                        else:
                            done(None, b"",
                                 {"stored": 0, "dedup": manifest},
                                 [(fp, frames[fp])
                                  for fp, _ln in manifest
                                  if fp in frames])
            engine.submit_compress(codec, chunk, mode=mode, span=span,
                                   callback=_cb)

        for fp, chunk in list(uniq.items()):
            _one(fp, chunk)

    def unseal_payload(self, raw, meta: dict | None) -> bytes:
        """Stored form → logical bytes (host path: expansion is
        np.repeat/zlib, nothing for the card)."""
        engine = self.daemon.batch_engine
        meta = meta or {}
        manifest = list(meta.get("dedup") or [])
        if manifest:
            from ..compress import dedup as dd
            store = self.daemon.store
            parts = []
            for fp, ln in manifest:
                frame = store.read(dd.DEDUP_COLL, dd.chunk_oid(fp))
                payload, hdr = dd.unframe(frame)
                chunk = (bytes(payload) if hdr is None
                         else engine.decompress(payload, hdr))
                if len(chunk) != ln:
                    raise ValueError(
                        f"dedup chunk {fp}: {len(chunk)} != {ln}")
                parts.append(chunk)
            return b"".join(parts)
        if "comp" in meta:
            stored = int(meta.get("stored", len(bytes(raw))))
            return engine.decompress(bytes(raw)[:stored], meta["comp"])
        return bytes(raw)

    # -- EC shard reality (split / re-placement) ---------------------------
    def _held_shards(self) -> list[int]:
        """Which shard collections on THIS OSD hold actual object
        data.  After a split or pgp_num re-placement the assigned
        shard can differ from the held one — peering advertises this
        so the primary can re-home reconstruction (see PGInfo).
        Cached: the store scan is O(objects); invalidated on interval
        change / split, extended in place on local writes."""
        if not self.pool.is_erasure():
            return []
        if self._held_cache is None:
            out = []
            for s in range(self.pool.size):
                cid = self.cid_for_shard(s)
                if not self.daemon.store.collection_exists(cid):
                    continue
                try:
                    objs = self.daemon.store.list_objects(cid)
                except KeyError:
                    continue
                if any(o not in (META_OID, SNAPMAP_OID) for o in objs):
                    out.append(s)
            self._held_cache = out
        return list(self._held_cache)

    def _note_local_object_write(self):
        """First write into the assigned shard collection makes it
        'held' — keep the cache truthful without a rescan."""
        if self._held_cache is not None and self.shard >= 0 \
                and self.shard not in self._held_cache:
            self._held_cache.append(self.shard)

    def _info_dict(self) -> dict:
        d = self.info.to_dict()
        if self.pool.is_erasure():
            d["shards_held"] = self._held_shards()
        return d

    def _ec_inventory(self) -> dict[str, tuple]:
        """oid → version for every object this PG should hold: the
        log's surviving writes, plus anything in locally held shard
        collections the (possibly trimmed) log no longer mentions."""
        inv: dict[str, tuple] = {}
        for e in self.log.entries:
            if e.op == DELETE:
                inv.pop(e.oid, None)
            else:
                inv[e.oid] = e.version
        store = self.daemon.store
        for s in self._held_shards():
            cid = self.cid_for_shard(s)
            for oid in store.list_objects(cid):
                if oid in (META_OID, SNAPMAP_OID) or oid in inv:
                    continue
                try:
                    meta = json.loads(bytes(store.getattr(cid, oid,
                                                          "_")))
                    inv[oid] = tuple(meta.get("version", ZERO))
                except KeyError:
                    inv[oid] = ZERO
        return inv

    # -- persistence -------------------------------------------------------
    def _persist_meta(self, txn: Transaction | None = None) -> Transaction:
        t = txn if txn is not None else Transaction()
        t.omap_setkeys(self.cid, META_OID, {
            "info": json.dumps(self.info.to_dict()).encode(),
            "log": json.dumps(self.log.to_dict()).encode(),
            # the missing set MUST survive a restart (reference:
            # pg_missing_t is persisted in the pg-log omap): a revived
            # OSD that kept its adopted log but forgot what bytes it
            # lacks would claim completeness it doesn't have, and the
            # object would silently never be recovered
            "missing": json.dumps(
                {o: list(v) if v is not None else None
                 for o, v in self.missing.items()}).encode()})
        return t

    def load_from_store(self):
        store = self.daemon.store
        try:
            meta = store.omap_get(self.cid, META_OID)
        except KeyError:
            return
        if "info" in meta:
            self.info = PGInfo.from_dict(json.loads(meta["info"]))
        if "log" in meta:
            self.log = PGLog.from_dict(json.loads(meta["log"]))
        if "missing" in meta:
            self.missing = {
                o: tuple(v) if v is not None else None
                for o, v in json.loads(meta["missing"]).items()}

    def create_onstore(self):
        if not self.daemon.store.collection_exists(self.cid):
            t = Transaction().create_collection(self.cid)
            t.touch(self.cid, META_OID)
            self.daemon.store.queue_transaction(self._persist_meta(t))

    # =======================================================================
    # peering (reference PeeringState: GetInfo → GetLog → Activate)
    # =======================================================================
    def advance_map(self, up, up_primary, acting, acting_primary, epoch):
        new_acting = list(acting)
        if new_acting != self.acting or acting_primary != self.primary:
            self.acting = new_acting
            self.up = list(up)
            self.primary = acting_primary
            if self.daemon.whoami in new_acting:
                self.shard = new_acting.index(self.daemon.whoami)
                # a PG first materialized as a stray (probe answer) has
                # no collection yet; becoming acting means we will hold
                # data, so make sure it exists before any txn lands
                self.create_onstore()
            self.interval_epoch = epoch
            self.info.same_interval_since = epoch
            self.state = "peering" if self.is_primary else "stray"
            # drop cross-interval op state; clients resend on map change
            self.scrubbing = False
            self._scrub_maps.clear()
            self._scrub_waiting.clear()
            self.backend.on_change()
            self._held_cache = None
            self.peer_info.clear()
            self.peer_missing.clear()
            self.peer_reported_missing.clear()
            self.peer_activated.clear()
            self._queried.clear()
            self._pulls.clear()     # re-pull in the new interval
            self.backfill_targets.clear()   # re-scan, pushes are
                                            # version-guarded anyway
            if self.is_primary:
                self._start_peering()
        elif self.daemon.whoami == self.primary and \
                self.state in ("reset", "stray", "down", "incomplete"):
            # same interval, but we never got going (e.g. min_size
            # regained without an acting change, or a prior-interval
            # holder came back up without changing our acting set)
            self._start_peering()
        elif self.state.startswith("active") and \
                self.waiting_for_active:
            from .osdmap import CLUSTER_FLAGS
            if not (self.daemon.osdmap.flags &
                    CLUSTER_FLAGS["pause"]):
                # an unpause epoch (same interval) releases the ops
                # the pause gate queued
                waiters, self.waiting_for_active = \
                    self.waiting_for_active, []
                for fn in waiters:
                    fn()

    def _peer_osds(self) -> list[int]:
        me = self.daemon.whoami
        return [o for o in dict.fromkeys(self.acting_live()) if o != me]

    def _prior_interval_osds(self) -> set[int]:
        """Up members of maybe-went-rw intervals since our
        last_epoch_started (reference PeeringState::build_prior's
        probe set): they may hold acknowledged writes the current
        acting set never saw, so GetInfo must include them."""
        m = self.daemon.osdmap
        me = self.daemon.whoami
        targets: set[int] = set()
        les = self.info.last_epoch_started
        for iv in self.past_intervals:
            if iv["last"] < les or not iv["maybe_went_rw"]:
                continue
            for o in iv["acting"]:
                if o != CRUSH_ITEM_NONE and o != me and m.is_up(o):
                    targets.add(o)
        return targets

    def _start_peering(self):
        self.state = "peering"
        if len(self.acting_live()) < max(1, self.pool.min_size):
            self.state = "down"      # not enough members to go active
            return
        probe = set(self._peer_osds()) | self._prior_interval_osds()
        self._probe_targets = probe
        if not probe:
            if self._check_prior_intervals():
                self._activate()
            else:
                self.state = "incomplete"
            return
        for o in probe:
            self._queried.add(o)
            self.daemon.send_to_osd(o, M.MOSDPGQuery(
                pgid=str(self.pgid), epoch=self.daemon.osdmap.epoch,
                kind="info", since=None,
                from_osd=self.daemon.whoami))

    def _check_prior_intervals(self) -> bool:
        """True when every maybe-went-rw past interval since the
        newest known last_epoch_started has at least one member among
        the gathered infos (self + peers) — i.e. no interval's
        acknowledged writes can be invisible to this peering round
        (reference PeeringState 'incomplete'/'down' gating)."""
        les = max([self.info.last_epoch_started] +
                  [pi.last_epoch_started
                   for pi in self.peer_info.values()])
        known = {self.daemon.whoami} | set(self.peer_info)
        for iv in self.past_intervals:
            if iv["last"] < les or not iv["maybe_went_rw"]:
                continue
            members = [o for o in iv["acting"] if o != CRUSH_ITEM_NONE]
            if members and not any(o in known for o in members):
                return False
        return True

    def _missing_dict(self) -> dict:
        """Wire form of the local missing set (reference pg_missing_t
        travels with peering info): only MODIFY gaps — missing deletes
        self-resolve at activation."""
        return {o: list(v) for o, v in self.missing.items()
                if v is not None}

    def handle_query(self, msg: M.MOSDPGQuery):
        """Replica side: answer info/log queries."""
        if msg.kind == "info":
            self.daemon.send_to_osd(msg.from_osd, M.MOSDPGNotify(
                pgid=str(self.pgid), epoch=self.daemon.osdmap.epoch,
                info=self._info_dict(), from_osd=self.daemon.whoami,
                missing=self._missing_dict()))
        elif msg.kind == "log":
            since = tuple(msg.since) if msg.since else ZERO
            entries = [e.to_dict() for e in self.log.entries_after(since)]
            self.daemon.send_to_osd(msg.from_osd, M.MOSDPGLog(
                pgid=str(self.pgid), epoch=self.daemon.osdmap.epoch,
                info=self._info_dict(), entries=entries,
                activate=False, from_osd=self.daemon.whoami,
                missing=self._missing_dict()))

    def handle_notify(self, msg: M.MOSDPGNotify):
        """Primary side: collect peer infos (GetInfo), and while
        ACTIVE, activation acks — the peer confirms it activated and
        reports what it still misses."""
        if self.is_primary and self.state == "active" and \
                msg.from_osd in self.acting:
            if (msg.epoch or 0) < self.interval_epoch:
                # stale ack from a prior interval delivered after
                # on_change: counting it would mark the peer activated
                # in THIS interval (so _resend_activation never
                # re-delivers) and union a stale missing set — mirror
                # the stale-activation gate in handle_pg_log
                return
            self.peer_activated.add(msg.from_osd)
            self.peer_info[msg.from_osd] = PGInfo.from_dict(msg.info)
            pm = self.peer_missing.setdefault(msg.from_osd, {})
            changed = False
            for oid, ver in (msg.missing or {}).items():
                if oid not in pm:
                    pm[oid] = tuple(ver)
                    changed = True
            if changed:
                self._kick_recovery()
            return
        if not self.is_primary or self.state not in ("peering",
                                                     "incomplete"):
            return
        self.peer_info[msg.from_osd] = PGInfo.from_dict(msg.info)
        # the peer's own missing set: a log diff alone can't see it —
        # log adoption advances last_update BEFORE the bytes arrive,
        # so a peer re-peering mid-recovery looks complete by version
        # while still lacking objects (reference: pg_missing_t is
        # exchanged during peering, not derived)
        self.peer_reported_missing[msg.from_osd] = {
            o: tuple(v) for o, v in (msg.missing or {}).items()}
        # only wait on probe targets that are still up — a target that
        # died mid-gather is re-probed (or re-gated) by the tick retry
        m = self.daemon.osdmap
        pending = {o for o in self._probe_targets if m.is_up(o)}
        if set(self.peer_info) >= pending:
            self._choose_authoritative()

    def _choose_authoritative(self):
        """GetLog: adopt the best log if a peer is ahead of us — but
        first refuse to proceed while a prior rw interval has no
        gathered representative (acknowledged writes could be lost)."""
        if not self._check_prior_intervals():
            self.state = "incomplete"
            return
        self.state = "peering"
        best_osd, best = self.daemon.whoami, self.info
        for o, pi in self.peer_info.items():
            if pi.last_update > best.last_update:
                best_osd, best = o, pi
        if best_osd == self.daemon.whoami:
            self._activate()
        else:
            # best may be a stray from a prior interval — its log (and
            # via recovery, its objects) flow back into the acting set
            self.daemon.send_to_osd(best_osd, M.MOSDPGQuery(
                pgid=str(self.pgid), epoch=self.daemon.osdmap.epoch,
                kind="log", since=list(self.info.last_update),
                from_osd=self.daemon.whoami))

    def _merge_authoritative(self, info: PGInfo, entries: list[LogEntry]):
        """Adopt a better peer's log: newer entries become local missing
        (we have the journal but not yet the bytes) — reference
        PGLog::merge_log."""
        for e in entries:
            if e.version <= self.log.head:
                continue
            self.log.add(e)
            if e.op == MODIFY:
                # pg_missing_t semantics: missing means the STORE
                # lacks the bytes — a push/backfill may already have
                # delivered this version before the log caught up
                if self.backend._object_version(e.oid) >= e.version:
                    self.missing.pop(e.oid, None)
                else:
                    self.missing[e.oid] = e.version
            elif e.op == DELETE:
                self.missing[e.oid] = None
        self.info.last_update = max(self.info.last_update,
                                    info.last_update)
        self.daemon.store.queue_transaction(self._persist_meta())

    def handle_log(self, msg: M.MOSDPGLog):
        entries = [LogEntry.from_dict(e) for e in msg.entries or []]
        info = PGInfo.from_dict(msg.info)
        if msg.activate:
            if (msg.epoch or 0) < self.interval_epoch:
                # stale activation from a deposed primary (it can be
                # re-sent on a tick): must not flip this newer
                # interval's state
                return
            # replica activation: adopt authoritative log
            self._merge_authoritative(info, entries)
            self.info.last_epoch_started = max(
                self.info.last_epoch_started, info.last_epoch_started)
            self.state = "active"
            self._apply_local_deletes()
            self.daemon.store.queue_transaction(self._persist_meta())
            # activation ACK: fresh info + missing back to the primary
            # (lets it stop re-sending and learn post-adoption gaps)
            self.daemon.send_to_osd(msg.from_osd, M.MOSDPGNotify(
                pgid=str(self.pgid), epoch=self.daemon.osdmap.epoch,
                info=self._info_dict(), from_osd=self.daemon.whoami,
                missing=self._missing_dict()))
        else:
            if not self.is_primary or self.state != "peering":
                return
            if msg.missing is not None:
                self.peer_reported_missing[msg.from_osd] = {
                    o: tuple(v) for o, v in msg.missing.items()}
            self._merge_authoritative(info, entries)
            self._activate()

    def _apply_local_deletes(self):
        """Missing deletes need no recovery: apply them now."""
        for oid in [o for o, v in self.missing.items() if v is None]:
            if self.daemon.store.exists(self.cid, oid):
                self.daemon.store.queue_transaction(
                    Transaction().remove(self.cid, oid))
            del self.missing[oid]

    def _activate(self):
        """Primary: compute peer missing, activate acting set, kick
        recovery (reference PeeringState::Active + activate())."""
        # before going rw, our up_thru must reach this interval so a
        # FUTURE peering can tell this interval might have accepted
        # writes (reference PeeringState::need_up_thru / MOSDAlive);
        # stay in peering until the bumped map arrives — the tick
        # retries and the request is idempotent
        daemon = self.daemon
        if daemon.osdmap.up_thru(daemon.whoami) < self.interval_epoch:
            daemon.request_up_thru(self.interval_epoch)
            self.state = "peering"
            return
        # this interval went rw: record it so future peerings know the
        # cutoff below which past intervals no longer matter
        self.info.last_epoch_started = max(
            self.info.last_epoch_started, self.interval_epoch)
        self._apply_local_deletes()
        self.peer_missing = {}
        for o in self._peer_osds():
            pi = self.peer_info.get(o)
            plu = pi.last_update if pi else ZERO
            if plu < self.log.tail:
                # journal no longer covers the peer: backfill — walk
                # the collection behind a cursor in bounded batches
                # (reference backfill scan in PrimaryLogPG); pushes
                # racing live writes are version-guarded on apply
                pm: dict[str, tuple | None] = {}
                # objs=None: the scan initializes lazily in
                # _kick_backfill, AFTER the primary has recovered its
                # own missing objects — a snapshot taken now would
                # omit them and the prune would delete the target's
                # only copies
                self.backfill_targets[o] = {"cursor": "",
                                            "pending": set(),
                                            "objs": None}
            else:
                pm = self.log.missing_for(plu)
            # union what the peer itself reported missing: bytes it
            # never received under a log it already adopted
            for oid, ver in (self.peer_reported_missing.get(o)
                             or {}).items():
                if oid not in pm:
                    pm[oid] = ver
            self.peer_missing[o] = pm
            entries = (self.log.entries_after(plu)
                       if plu >= self.log.tail else
                       [e for e in self.log.entries])
            self.daemon.send_to_osd(o, M.MOSDPGLog(
                pgid=str(self.pgid), epoch=self.daemon.osdmap.epoch,
                info=self._info_dict(),
                entries=[e.to_dict() for e in entries],
                activate=True, from_osd=self.daemon.whoami))
        if self.pool.is_erasure():
            # split / pgp_num re-placement can permute shard
            # assignments: a member whose ASSIGNED shard collection is
            # empty (its data lives under another shard id) needs its
            # whole chunk set reconstructed, invisible to the log diff
            # above because logs match (reference: EC PGs are
            # per-shard entities; this recreates the shard-granular
            # missing set)
            inv = None
            if self.shard not in self._held_shards():
                inv = self._ec_inventory()
                for oid, ver in inv.items():
                    self.missing.setdefault(oid, ver)
            for o in self._peer_osds():
                pi = self.peer_info.get(o)
                if pi is None or pi.shards_held is None:
                    continue
                if self.acting.index(o) not in pi.shards_held:
                    if inv is None:
                        inv = self._ec_inventory()
                    if inv:
                        self.peer_missing[o] = dict(inv)
        self.state = "active"
        self.daemon.store.queue_transaction(self._persist_meta())
        self.release_backoffs()
        waiters, self.waiting_for_active = self.waiting_for_active, []
        for fn in waiters:
            fn()
        self._kick_recovery()

    def _resend_activation(self):
        """Re-send the activation log to acting peers (idempotent).
        An activation can race a peer's own map advance — the peer
        lands back in 'stray' for the same interval and nothing else
        would ever deliver it (reference: peering machine re-drives
        activation; acting peers ack and the primary retries)."""
        for o in self._peer_osds():
            if o in self.peer_activated:
                continue        # confirmed: no traffic needed
            pi = self.peer_info.get(o)
            plu = pi.last_update if pi else ZERO
            entries = (self.log.entries_after(plu)
                       if plu >= self.log.tail else
                       list(self.log.entries))
            self.daemon.send_to_osd(o, M.MOSDPGLog(
                pgid=str(self.pgid), epoch=self.daemon.osdmap.epoch,
                info=self._info_dict(),
                entries=[e.to_dict() for e in entries],
                activate=True, from_osd=self.daemon.whoami))

    def _list_objects(self, include_snaps: bool = False) -> list[str]:
        """Head objects by default; include_snaps adds clone objects
        (backfill/scrub want them — pgls and clients never do)."""
        try:
            objs = self.daemon.store.list_objects(self.cid)
        except KeyError:
            return []
        return [o for o in objs
                if o not in (META_OID, SNAPMAP_OID)
                and (include_snaps or not is_snap_clone(o))]

    # =======================================================================
    # recovery (log-based push/pull; EC reconstructs chunks)
    # =======================================================================
    def is_degraded_object(self, oid: str) -> bool:
        if oid in self.missing:
            return True
        return any(oid in pm for pm in self.peer_missing.values())

    @staticmethod
    def _supersedes_object(msg: M.MOSDOp) -> bool:
        """True when the op REPLACES the object wholesale — it needs
        none of the missing bytes, and applying it heals the degraded
        state (every member gets the fresh full copy and drops its
        missing entry).  Waiting on recovery here is not just slow, it
        can deadlock: an interrupted write can leave a version only
        the primary holds, unrecoverable until exactly such an
        overwrite arrives."""
        ops = [op.get("op") for op in msg.ops]
        return bool(ops) and all(o in ("write_full", "delete")
                                 for o in ops)

    def wait_for_object(self, oid: str, retry):
        self.waiting_for_object.setdefault(oid, []).append(retry)

    def _object_recovered(self, oid: str):
        waiters = self.waiting_for_object.pop(oid, [])
        for fn in waiters:
            fn()

    def _kick_recovery(self, trigger=None):
        if not self.is_primary:
            return
        # marker span for the background work burst; `trigger` (the
        # blocked op's span, or the scrub that queued repairs via
        # _scrub_trace) becomes a span LINK — causal, not parental:
        # recovery outlives and out-fans any single op's trace
        span = self.daemon.tracer.start_span(
            "recovery_kick", tags={
                "layer": "recovery", "pgid": str(self.pgid),
                "missing": len(self.missing),
                "peer_missing": sum(len(pm) for pm in
                                    self.peer_missing.values())})
        if span is not None:
            span.add_link(trigger if trigger is not None
                          else getattr(self, "_scrub_trace", None))
            span.finish()
        # pull what WE miss first (clients read from us)
        for oid, ver in list(self.missing.items()):
            if ver is None:
                continue
            self.backend.recover_primary_object(oid, ver)
        # push what peers miss
        for o, pm in self.peer_missing.items():
            for oid, ver in list(pm.items()):
                if ver is None:
                    # peer applies deletes from the log it adopted
                    pm.pop(oid, None)
                    continue
                if oid in self.missing:
                    continue       # recover locally first
                self.backend.push_object(o, oid, ver)
        self._kick_backfill()
        self._maybe_clean()

    BACKFILL_BATCH = 8      # fallback when the daemon has no config

    def _object_version_onstore(self, oid: str) -> tuple:
        try:
            meta = json.loads(bytes(self.daemon.store.getattr(
                self.cid, oid, "_")))
            return tuple(meta.get("version", ZERO))
        except KeyError:
            return self.info.last_update

    def backfill_gate(self, peer: int, oid: str,
                      is_delete: bool = False) -> bool:
        """True → send the live write to this peer now.  Objects the
        peer hasn't been backfilled yet must NOT receive partial
        mutations (they'd build on a base the peer lacks; the later
        full push would then be rejected as stale) — the backfill scan
        delivers their current state instead (reference: writes gated
        by the target's last_backfill).  Deletes always flow (removing
        a never-backfilled object is harmlessly idempotent and keeps
        pre-downtime copies from resurfacing)."""
        st = self.backfill_targets.get(peer)
        if st is None or is_delete:
            return True
        if st["objs"] is None:
            return False        # scan not started: snapshot will cover
        if oid <= st["cursor"]:
            return True         # already backfilled: live writes apply
        import bisect
        i = bisect.bisect_left(st["objs"], oid)
        if i >= len(st["objs"]) or st["objs"][i] != oid:
            st["objs"].insert(i, oid)   # new object: scan must visit
        return False

    def _kick_backfill(self):
        """Advance each backfill target by one bounded batch once its
        previous batch fully acked (reference backfill with
        osd_max_backfills-style pacing, single-queue here).  The scan
        walks the object-list snapshot taken at registration — objects
        created afterwards flow through live replication, deleted ones
        are skipped (the push would find nothing to read)."""
        import bisect
        for o, st in list(self.backfill_targets.items()):
            if st["pending"]:
                continue
            if st["objs"] is None:
                if self.missing:
                    continue    # wait until the primary is whole
                objs = self._list_objects(include_snaps=True)
                if self.daemon.store.exists(self.cid, SNAPMAP_OID):
                    # the snap index must travel too, or the target
                    # can never trim its backfilled clones
                    objs.append(SNAPMAP_OID)
                st["objs"] = sorted(objs)
                # the target may hold objects deleted on the primary
                # while it was gone and no longer in the log: hand it
                # the authoritative list to prune against (reference
                # backfill removes extraneous objects on the target)
                self.daemon.send_to_osd(o, M.MOSDPGBackfillPrune(
                    pgid=str(self.pgid),
                    epoch=self.daemon.osdmap.epoch,
                    keep=st["objs"], from_osd=self.daemon.whoami))
            objs = st["objs"]
            lo = bisect.bisect_right(objs, st["cursor"])
            batch = []
            # live pacing knob (osd_recovery_max_active observer on
            # the daemon): autotuner-retunable per kick
            cap = max(1, int(getattr(self.daemon, "recovery_max_active",
                                     self.BACKFILL_BATCH)))
            while lo < len(objs) and len(batch) < cap:
                oid = objs[lo]
                st["cursor"] = oid
                lo += 1
                if self.daemon.store.exists(self.cid, oid):
                    batch.append(oid)
            if not batch:
                if lo >= len(objs):
                    del self.backfill_targets[o]
                    self._maybe_clean()
                continue
            for oid in batch:
                st["pending"].add(oid)
                self.backend.push_object(
                    o, oid, self._object_version_onstore(oid))

    def backfill_remaining(self) -> int:
        """Objects still to push across all backfill targets —
        progress telemetry for MPGStats (reference pg_stat_t
        misplaced counts).  A target whose scan hasn't started counts
        its full listing (min 1 so pending work never reads as 0)."""
        import bisect
        rem = 0
        for st in self.backfill_targets.values():
            objs = st["objs"]
            if objs is None:
                rem += max(1, len(self._list_objects()))
            else:
                rem += len(st["pending"]) + max(
                    0, len(objs) - bisect.bisect_right(
                        objs, st["cursor"]))
        return rem

    def _maybe_clean(self):
        if self.state == "active" and not self.missing and \
                self.backfill_targets == {} and \
                not any(self.peer_missing.values()):
            self.info.last_complete = self.info.last_update
            self.state = "active+clean"

    def handle_push(self, msg: M.MOSDPGPush):
        """Receive a recovered/backfilled object (replica or primary)."""
        self.daemon.perf.inc("recovery_ops")
        self.backend.apply_push(msg)
        if msg.pull_tid is not None and self.is_primary:
            # this push answered one of OUR pulls
            oid = self._pulls.pop(msg.pull_tid, None)
            if oid is not None:
                self.missing.pop(oid, None)
                self._object_recovered(oid)
                self._kick_recovery()
        else:
            self.daemon.send_to_osd(msg.from_osd, M.MOSDPGPushReply(
                pgid=str(self.pgid), epoch=msg.epoch, oid=msg.oid,
                from_osd=self.daemon.whoami))

    def handle_push_reply(self, msg: M.MOSDPGPushReply):
        if not self.is_primary:
            return
        self.backend.push_answered(msg.from_osd, msg.oid)
        pm = self.peer_missing.get(msg.from_osd)
        if pm is not None:
            pm.pop(msg.oid, None)
        bf = self.backfill_targets.get(msg.from_osd)
        if bf is not None:
            bf["pending"].discard(msg.oid)
            if not bf["pending"]:
                self._kick_backfill()
        self._object_recovered(msg.oid)
        self._maybe_clean()

    def handle_pull(self, msg: M.MOSDPGPull):
        """A primary asks us to push an object back to it."""
        self.backend.answer_pull(msg)

    # =======================================================================
    # client op engine (reference PrimaryLogPG::do_op / do_osd_ops)
    # =======================================================================
    def next_version(self) -> tuple[int, int]:
        e = self.daemon.osdmap.epoch
        return (e, self.info.last_update[1] + 1)

    # -- cache tiering (reference PrimaryLogPG promote/agent paths) -------
    def _maybe_promote(self, msg: M.MOSDOp) -> bool:
        """Writeback cache-pool PGs promote on miss: an op on an
        object absent locally but present in the base pool parks
        while a background copy-up runs (the reference blocks the op
        on a promote too).  DELETEs propagate to the base first so an
        evicted cache can't resurrect them.  → True when parked."""
        pool = self.pool
        if pool is None or pool.tier_of < 0 or \
                pool.cache_mode != "writeback":
            return False
        if str(msg.client).startswith("client.tier-"):
            return False        # the agent's own ops must not recurse
        if getattr(msg, "_tier_done", False):
            return False        # agent already ran for this op
        oid = msg.oid
        is_delete = any(op.get("op") == "delete" for op in msg.ops)
        if not is_delete and \
                self.daemon.store.exists(self.cid, oid):
            return False
        waiters = self._promote_waiters.setdefault(oid, [])

        def requeue():
            msg._tier_done = True
            self.do_op(msg)

        waiters.append(requeue)
        if len(waiters) > 1:
            return True         # a promote is already in flight
        self.daemon.tier_agent(self, oid, pool.tier_of,
                               delete=is_delete)
        return True

    def _promote_done(self, oid: str):
        """Agent callback (daemon lock held): release parked ops."""
        for w in self._promote_waiters.pop(oid, []):
            w()

    def do_op(self, msg: M.MOSDOp):
        if not self.is_primary:
            self._reply(msg, -11, "not primary")   # EAGAIN: client remaps
            return
        if self.state in ("peering", "down", "reset", "stray",
                          "incomplete"):
            # RADOS backoff: tell the client to park the op instead of
            # queueing server-side / letting it resend blindly — the
            # unblock on activation releases it (reference
            # PrimaryLogPG::do_request backoff path)
            self._send_backoff(msg)
            return
        reqid = f"{msg.client}:{msg.tid}"
        dup = self.log.find_reqid(reqid)
        if dup is not None and any(
                op.get("op") in _WRITE_OPS or op.get("op") == "call"
                for op in msg.ops):
            # 'call' methods may mutate, so their resends must dedup
            # too (the dup reply can't reproduce a read-only call's
            # output — the reference stores per-dup result codes; a
            # client that truly lost a read-only reply simply retries
            # with a fresh tid)
            self._reply(msg, 0, "", results=[{}] * len(msg.ops),
                        version=dup.version)
            return
        oid = msg.oid
        if self.is_degraded_object(oid) and \
                not self._supersedes_object(msg):
            self.wait_for_object(oid, lambda: self.do_op(msg))
            self._kick_recovery(trigger=getattr(
                getattr(msg, "tracked", None), "span", None))
            return
        if self._maybe_promote(msg):
            return      # parked; requeued when the promote lands
        watchish = [op.get("op") in ("watch", "unwatch", "notify")
                    for op in msg.ops]
        if any(watchish):
            if not all(watchish):
                # a mixed batch would silently drop the data ops
                self._reply(msg, -22,
                            "watch/notify ops cannot batch with "
                            "data ops")
                return
            self._do_watch_ops(msg)
            return
        if any(op.get("op") == "call" for op in msg.ops):
            msg = self._expand_class_calls(msg)
            if msg is None:
                return      # class method failed; error already sent
        from .osdmap import CLUSTER_FLAGS
        if self.daemon.osdmap.flags & CLUSTER_FLAGS["pause"]:
            # operator paused client I/O (reference pauserd|pausewr):
            # queue, don't fail — unpausing releases everything
            self.waiting_for_active.append(lambda: self.do_op(msg))
            return
        is_write = any(op.get("op") in _WRITE_OPS for op in msg.ops)
        if is_write and \
                len(self.acting_live()) < max(1, self.pool.min_size):
            # too few live members to make the write durable: block
            # the client until peering resolves it (the map advance
            # that shrank acting_live will re-peer us into down/
            # incomplete, or recovery restores min_size and unblocks)
            self._send_backoff(msg)
            return
        if is_write and self.pool.full and \
                not all(op.get("op") == "delete" for op in msg.ops):
            # quota exceeded (reference: FULL_QUOTA pools reply
            # -EDQUOT; deletes stay allowed so the operator can free
            # space)
            self._reply(msg, -122, "pool quota exceeded")
            return
        if is_write and self.scrubbing:
            # writes quiesce during scrub (reference blocks the scrub
            # chunk range; PG granularity here) — released by
            # _maybe_finish_scrub / check_scrub_timeout
            self.waiting_for_active.append(lambda: self.do_op(msg))
            return
        try:
            if is_write:
                self.backend.submit_write(msg, reqid)
            else:
                results = self.backend.do_reads(msg)
                if results is not None:     # EC async reads return None
                    self._reply(msg, 0, "", results=results)
        except KeyError:
            self._reply(msg, -2, "no such object")   # ENOENT
        except ValueError as e:
            self._reply(msg, -22, str(e))            # EINVAL

    def _send_backoff(self, msg: M.MOSDOp):
        """Block the client session for this PG instead of queueing
        the op: it parks client-side and comes back on unblock (or a
        map advance).  Re-sends the block for an already-blocked
        session — the injector can drop the first copy, and a silent
        drop here would strand the client's periodic resends forever."""
        con = getattr(msg, "connection", None)
        if con is None:
            # internal re-entry with no session: server-side queueing
            # is the only option left
            self.waiting_for_active.append(lambda: self.do_op(msg))
            return
        # the client holds the op now; keeping it in the tracker
        # would count a parked (not stuck) op as slow forever
        self.finish_tracked(msg, "backoff")
        key = id(con)
        if key in self.backoffs:
            _, bid = self.backoffs[key]
        else:
            self._backoff_id += 1
            bid = self._backoff_id
            self.backoffs[key] = (con, bid)
        try:
            con.send_message(M.MOSDBackoff(
                pgid=str(self.pgid), id=bid, op="block",
                epoch=self.daemon.osdmap.epoch))
        except ConnectionError:
            self.backoffs.pop(key, None)
            self.waiting_for_active.append(lambda: self.do_op(msg))

    def release_backoffs(self):
        """Unblock every backed-off session (on activation)."""
        backoffs, self.backoffs = self.backoffs, {}
        for con, bid in backoffs.values():
            try:
                con.send_message(M.MOSDBackoff(
                    pgid=str(self.pgid), id=bid, op="unblock",
                    epoch=self.daemon.osdmap.epoch))
            except ConnectionError:
                pass    # client re-targets on its next map instead

    @staticmethod
    def finish_tracked(msg, event: str):
        """Finish a message's TrackedOp (idempotent).  Every path
        that stops working on an op — reply, backoff handoff,
        interval-change drop — must come through here, or the tracker
        counts the op as slow forever."""
        tracked = getattr(msg, "tracked", None)
        if tracked is not None:
            msg.tracked = None
            tracked.mark_event(event)
            tracked.finish()
        return tracked

    def _reply(self, msg: M.MOSDOp, rc: int, outs: str = "",
               results=None, version=ZERO):
        call_results = getattr(msg, "_call_results", None)
        if call_results and results is not None:
            results = list(results)
            for idx, res in call_results.items():
                if idx < len(results):
                    results[idx] = res
        # capture the server-side span ctx BEFORE finish_tracked nulls
        # msg.tracked: the reply echoes it so the client's wire_recv
        # span nests under the OSD's op span, not the client root
        span = getattr(getattr(msg, "tracked", None), "span", None)
        trace = span.ctx() if span is not None \
            else getattr(msg, "trace", None)
        tracked = self.finish_tracked(msg, "replied")
        if tracked is not None:
            self.daemon.perf.tinc("op_latency", tracked.age)
            # log2 distribution in µs (perf histogram dump / exporter);
            # the span's trace id rides along as the per-bucket
            # slowest-op exemplar (OpenMetrics `_bucket` # {...})
            try:
                self.daemon.perf.hinc(
                    "op_latency_histogram", tracked.age * 1e6,
                    trace_id=span.trace_id if span is not None
                    else None)
            except KeyError:
                pass
            # heavy-hitter attribution: client/pool/pg space-saving
            # sketches (`ceph osd top`), fed only on the primary's
            # client-op reply path — subops never misattribute here
            topk = getattr(self.daemon, "topk", None)
            if topk is not None and topk.enabled:
                topk.update(
                    client=(getattr(msg, "qos_client", None)
                            or getattr(msg, "client", None) or "?"),
                    pool=str(self.pgid.pool), pg=str(self.pgid),
                    nbytes=int(getattr(msg, "_acct_bytes", 0)),
                    lat_s=tracked.age)
        try:
            msg.connection.send_message(M.MOSDOpReply(
                tid=msg.tid, rc=rc, outs=outs, results=results,
                version=list(version), epoch=self.daemon.osdmap.epoch,
                dmc_phase=getattr(msg, "_dmc_phase", None),
                trace=trace))
        except (ConnectionError, AttributeError):
            pass

    # =======================================================================
    # object classes (reference ClassHandler + src/cls/)
    # =======================================================================
    def _expand_class_calls(self, msg: M.MOSDOp):
        """Run `call` ops on the primary: the method reads the current
        object and stages standard mutations that replace the call in
        the op list — durability then rides the normal replication
        path (reference: cls methods execute inside do_osd_ops and
        their writes join the op's transaction)."""
        from ..cls import ClsContext, ClsError, call as cls_call
        store, cid, oid = self.daemon.store, self.cid, msg.oid

        def read_xattr(name):
            try:
                return store.getattr(cid, oid, name)
            except KeyError:
                return None

        def exists():
            return store.exists(cid, oid)

        def read_omap():
            try:
                return store.omap_get(cid, oid)
            except KeyError:
                return {}

        new_ops = []
        call_results = {}
        for i, op in enumerate(msg.ops):
            if op.get("op") != "call":
                new_ops.append(op)
                continue
            ctx = ClsContext(read_xattr, exists, read_omap)
            try:
                out = cls_call(op["cls"], op["method"], ctx,
                               bytes.fromhex(op.get("data", "")))
            except ClsError as e:
                self._reply(msg, e.rc, str(e))
                return None
            call_results[len(new_ops)] = {"data": out.hex()}
            if ctx.staged_ops:
                new_ops.extend(ctx.staged_ops)
            else:
                # read-only method: keep a no-op placeholder so the
                # result stays aligned with an op slot
                new_ops.append({"op": "cls_noop"})
        expanded = M.MOSDOp(tid=msg.tid, client=msg.client,
                            pgid=msg.pgid, oid=oid, epoch=msg.epoch,
                            ops=new_ops, flags=msg.flags,
                            snapc=getattr(msg, "snapc", None))
        expanded.connection = msg.connection
        expanded.tracked = getattr(msg, "tracked", None)
        expanded._call_results = call_results
        return expanded

    # =======================================================================
    # watch / notify (reference src/osd/Watch.{h,cc} + Notify)
    # =======================================================================
    def _do_watch_ops(self, msg: M.MOSDOp):
        results = []
        for op in msg.ops:
            kind = op.get("op")
            if kind == "watch":
                wid = f"{msg.client}:{op.get('watch_id', 0)}"
                self.watchers.setdefault(msg.oid, {})[wid] = \
                    msg.connection
                results.append({"watch_id": wid})
            elif kind == "unwatch":
                wid = f"{msg.client}:{op.get('watch_id', 0)}"
                ws = self.watchers.get(msg.oid, {})
                ws.pop(wid, None)
                results.append({})
            elif kind == "notify":
                self._start_notify(msg, op)
                return          # replies when acks (or timeout) land
            else:
                results.append({})
        self._reply(msg, 0, "", results=results)

    def _start_notify(self, msg: M.MOSDOp, op: dict):
        self._notify_id += 1
        nid = self._notify_id
        targets = dict(self.watchers.get(msg.oid, {}))
        st = {"msg": msg, "waiting": set(targets), "replies": {},
              "done": False}
        self._notifies[nid] = st
        for wid, con in targets.items():
            try:
                con.send_message(M.MWatchNotify(
                    oid=msg.oid, pgid=str(self.pgid), notify_id=nid,
                    watch_id=wid, data=op.get("data", "")))
            except (ConnectionError, AttributeError):
                st["waiting"].discard(wid)
        timeout = float(op.get("timeout", 10.0))
        self.daemon.timer.add_event_after(
            timeout, lambda: self._finish_notify(nid, timed_out=True))
        self._maybe_finish_notify(nid)

    def handle_notify_ack(self, msg: M.MWatchNotifyAck):
        st = self._notifies.get(msg.notify_id)
        if st is None:
            return
        st["waiting"].discard(msg.watch_id)
        st["replies"][msg.watch_id] = msg.reply
        self._maybe_finish_notify(msg.notify_id)

    def _maybe_finish_notify(self, nid: int):
        st = self._notifies.get(nid)
        if st is not None and not st["waiting"]:
            self._finish_notify(nid)

    def _finish_notify(self, nid: int, timed_out: bool = False):
        st = self._notifies.pop(nid, None)
        if st is None or st["done"]:
            return
        st["done"] = True
        self._reply(st["msg"], 0, "", results=[{
            "notify_id": nid, "replies": st["replies"],
            "timed_out_watchers": sorted(st["waiting"])}])

    def handle_backfill_prune(self, msg):
        """Backfill target: delete objects the primary no longer has
        (they were removed while we were down and have fallen out of
        the log).  Version-epoch guard: an object written at or after
        the prune's epoch is NEVER extraneous — a stale prune from a
        deposed primary (reordered behind a newer primary's writes)
        must not delete fresh data."""
        keep = set(msg.keep or ())
        store, cid = self.daemon.store, self.cid
        for oid in self._list_objects(include_snaps=True):
            if oid in keep:
                continue
            try:
                meta = json.loads(bytes(store.getattr(cid, oid, "_")))
                ver_epoch = int(meta.get("version", ZERO)[0])
            except KeyError:
                ver_epoch = 0
            if ver_epoch >= (msg.epoch or 0):
                continue
            store.queue_transaction(Transaction().remove(cid, oid))

    def con_reset(self, con):
        """A client connection died: its watches evaporate and any
        notify still waiting on it completes without it (reference
        watch timeout/disconnect handling)."""
        dead_wids = set()
        for oid, ws in list(self.watchers.items()):
            for wid, c in list(ws.items()):
                if c is con:
                    del ws[wid]
                    dead_wids.add(wid)
            if not ws:
                self.watchers.pop(oid, None)
        for nid in list(self._notifies):
            st = self._notifies.get(nid)
            if st and st["waiting"] & dead_wids:
                st["waiting"] -= dead_wids
                self._maybe_finish_notify(nid)

    def append_log_entry(self, entry: LogEntry, txn: Transaction):
        """Stamp a mutation into the journal + meta, atomically with
        the data write (the reference writes log and data in one
        ObjectStore transaction)."""
        self.log.add(entry)
        self.info.last_update = entry.version
        self._maybe_trim_log()
        self._persist_meta(txn)

    def _maybe_trim_log(self):
        """Bound the journal (reference PGLog::trim via
        osd_min/max_pg_log_entries): every member sees the identical
        entry sequence, so local trimming converges to the same tail
        cluster-wide; peers that fall behind the tail get backfill."""
        limit = self.daemon.config.get("osd_max_pg_log_entries")
        if len(self.log.entries) > limit:
            self.log.trim(self.log.entries[-limit - 1].version)

    # =======================================================================
    # scrub (reference src/osd/scrubber/: primary gathers a ScrubMap
    # from every acting member, compares, repairs from survivors)
    # =======================================================================
    def start_scrub(self, deep: bool = True, trigger=None) -> bool:
        """Primary: kick a scrub round.  False if the PG can't scrub
        now (not primary / not active / already scrubbing / writes in
        flight — scrub maps must not race uncommitted writes).

        deep=True (the default) reads every payload and verifies
        CRC-32C digests — plus the EC parity recheck on the primary;
        deep=False is the shallow pass: sizes/versions/presence only,
        no data reads.

        noscrub/nodeep-scrub do NOT gate here: the flags suppress the
        periodic scheduler (OSD._maybe_schedule_scrub) only, while an
        operator `ceph pg scrub` overrides them — reference
        OSD::sched_scrub vs the forced-scrub path."""
        busy = (self.backend._inflight
                or getattr(self.backend, "_rmw", None)
                or getattr(self.backend, "_reads", None))
        if not self.is_primary or not self.state.startswith("active") \
                or self.scrubbing or busy:
            return False
        self.scrubbing = True
        self._scrub_deep = bool(deep)
        self._scrub_started = time.monotonic()
        self._scrub_tid += 1
        # the sweep span covers the whole round (local map build →
        # replica maps → compare); `trigger` — the operator command or
        # scheduler event that kicked it — rides as a span link, and
        # the ctx travels in MOSDRepScrub so replica digest spans link
        # back to this sweep
        span = self.daemon.tracer.start_span(
            "pg_scrub", tags={"layer": "scrub",
                              "pgid": str(self.pgid),
                              "deep": bool(deep)})
        if span is not None:
            span.add_link(trigger)
        self._scrub_span = span
        self._scrub_trace = span.ctx() if span is not None else None
        self._scrub_maps = {
            self.daemon.whoami: self.backend.build_scrub_map(deep=deep)}
        self._scrub_waiting = set(self._peer_osds())
        for o in self._scrub_waiting:
            self.daemon.send_to_osd(o, M.MOSDRepScrub(
                pgid=str(self.pgid), epoch=self.daemon.osdmap.epoch,
                scrub_tid=self._scrub_tid,
                from_osd=self.daemon.whoami, deep=bool(deep),
                trace=self._scrub_trace))
        self._maybe_finish_scrub()
        return True

    def handle_rep_scrub(self, msg: M.MOSDRepScrub):
        """Acting member: walk my collection, return the scrub map."""
        # expose the primary's sweep ctx so the backend's crc_digest
        # span links to it, then drop it (we are not the sweep owner)
        self._scrub_trace = getattr(msg, "trace", None)
        try:
            objects = self.backend.build_scrub_map(
                deep=msg.deep is not False)
        finally:
            self._scrub_trace = None
        self.daemon.send_to_osd(msg.from_osd, M.MOSDRepScrubMap(
            pgid=str(self.pgid), epoch=self.daemon.osdmap.epoch,
            scrub_tid=msg.scrub_tid, shard=self.shard,
            objects=objects, from_osd=self.daemon.whoami))

    def handle_scrub_map(self, msg: M.MOSDRepScrubMap):
        if not self.scrubbing or msg.scrub_tid != self._scrub_tid:
            return
        self._scrub_maps[msg.from_osd] = msg.objects
        self._scrub_waiting.discard(msg.from_osd)
        self._maybe_finish_scrub()

    # chunk position of the in-flight sweep (scrub maps gathered vs.
    # the acting set) — rides pg_stats so the mgr progress module can
    # show per-PG scrub sweeps mid-flight
    def scrub_chunks_done(self) -> int:
        return len(self._scrub_maps)

    def scrub_chunks_total(self) -> int:
        return len(self._scrub_maps) + len(self._scrub_waiting)

    def _maybe_finish_scrub(self):
        if self._scrub_waiting:
            return
        prev_errors = self.scrub_errors
        errors = self.backend.scrub_compare(self._scrub_maps,
                                            deep=self._scrub_deep)
        if errors:
            self.daemon.perf.inc("scrub_errors_found", errors)
        elif prev_errors:
            # a clean scrub after a dirty one: the repairs took
            self.daemon.perf.inc("scrub_errors_repaired", prev_errors)
            self.inconsistent_objects = []
        self.scrub_errors = errors
        self.last_scrub = time.time()
        if self._scrub_deep:
            self.last_deep_scrub = self.last_scrub
        self.scrubbing = False
        self._scrub_maps = {}
        span = getattr(self, "_scrub_span", None)
        if span is not None:
            span.set_tag("errors", errors)
            span.finish()
            self._scrub_span = None
        if errors:
            # repair queued as recovery state by scrub_compare;
            # _scrub_trace still set → recovery_kick links to the sweep
            self.state = "active"
            self._kick_recovery()
        self._scrub_trace = None
        # release writes that queued behind the scrub
        waiters, self.waiting_for_active = self.waiting_for_active, []
        for fn in waiters:
            fn()

    def check_scrub_timeout(self, grace: float = 30.0):
        """Abort a scrub whose peers never answered (a peer without
        the PG materialized, or whose address dropped from the map) so
        the PG doesn't refuse scrubs forever."""
        if self.scrubbing and \
                time.monotonic() - getattr(self, "_scrub_started", 0.0) \
                > grace:
            self.scrubbing = False
            self._scrub_maps = {}
            self._scrub_waiting = set()
            span = getattr(self, "_scrub_span", None)
            if span is not None:
                span.set_tag("timeout", True)
                span.finish()
                self._scrub_span = None
            self._scrub_trace = None
            waiters, self.waiting_for_active = \
                self.waiting_for_active, []
            for fn in waiters:
                fn()


_WRITE_OPS = {"write", "write_full", "append", "delete", "truncate",
              "setxattr", "rmxattr", "omap_set", "omap_rm"}
_NOOP_OPS = {"cls_noop"}

# sentinel member of a repop's waiting set: the primary's own WAL
# commit (peers are int OSD ids, so a string can never collide) —
# ack-after-commit means the client reply waits for every replica's
# committed reply AND this local durability signal
_LOCAL_COMMIT = "local"


def _omap_read_result(kv: dict, op: dict) -> dict:
    """Shared omap_get result shaping: optional server-side key
    filter (reference omap_get_vals_by_keys) and keys-only mode
    (omap_get_keys) — one implementation for both backends."""
    want = op.get("keys")
    if want is not None:
        kv = {k: kv[k] for k in want if k in kv}
    if op.get("keys_only"):
        return {"kv": {k: "" for k in kv}}
    return {"kv": {k: v.hex() for k, v in kv.items()}}


def _push_is_stale(store, cid: str, msg) -> bool:
    """A backfill/recovery push racing live writes must never regress
    an object: skip apply when the local copy is already at or past
    the pushed version (the reply still flows so the primary's
    cursor advances)."""
    try:
        meta = json.loads(bytes(store.getattr(cid, msg.oid, "_")))
        local = tuple(meta.get("version", ZERO))
    except KeyError:
        return False
    # STRICTLY newer only: an equal-version push is either an
    # idempotent re-push or a scrub repair overwriting corrupt bytes
    # whose version never changed — both must apply
    return local > tuple(msg.version or ZERO)


# ===========================================================================
# Backend base — shared pull bookkeeping
# ===========================================================================
class PGBackendBase:
    """The pull-tracking protocol both backends share (reference
    ``PGBackend``): one in-flight pull per object, identified by a
    monotonically increasing per-PG pull tid that ``on_change``
    invalidates wholesale (``_pulls.clear()`` on interval change)."""

    pg: PG

    def _alloc_pull(self, oid: str) -> int | None:
        """Register a pull intent for ``oid``; None when a pull for it
        is already in flight (the single dedup point both recovery
        paths and the scrub donor-pull go through)."""
        pg = self.pg
        if any(oid == o for o in pg._pulls.values()):
            return None
        pg._pull_tid += 1
        pg._pulls[pg._pull_tid] = oid
        return pg._pull_tid

    def push_answered(self, peer: int, oid: str):
        """``peer`` acknowledged a push of ``oid`` (see
        ``ECBackend.push_object``)."""

    def _send_pull(self, peer: int, oid: str) -> int | None:
        """Allocate a pull tid and request ``oid`` from ``peer``."""
        pg = self.pg
        tid = self._alloc_pull(oid)
        if tid is None:
            return None
        pg.daemon.send_to_osd(peer, M.MOSDPGPull(
            pgid=str(pg.pgid), epoch=pg.daemon.osdmap.epoch, oid=oid,
            from_osd=pg.daemon.whoami, pull_tid=tid))
        return tid


# ===========================================================================
# Replicated backend
# ===========================================================================
class ReplicatedBackend(PGBackendBase):
    """Primary-copy replication (reference ReplicatedBackend)."""

    def __init__(self, pg: PG):
        self.pg = pg
        self._inflight: dict[str, dict] = {}   # reqid → waiting state
        # per-object gate for sealed (compressed/dedup) writes: the
        # read-modify-seal pipeline is asynchronous through the comp
        # lane, so concurrent writes to one object must serialize
        # (mirrors ECBackend._rmw at object granularity)
        self._seal_gate: dict[str, list] = {}

    def on_change(self):
        # cross-interval repops die here and their clients resend
        # against the new interval — finish the tracked ops, or the
        # dropped originals count as slow ops forever
        for st in self._inflight.values():
            self.pg.finish_tracked(st.get("msg"), "reset")
        self._inflight.clear()
        self._seal_gate.clear()

    # -- writes ------------------------------------------------------------
    def submit_write(self, msg: M.MOSDOp, reqid: str):
        pg, daemon = self.pg, self.pg.daemon
        cid, oid = pg.cid, msg.oid
        if self._needs_seal(msg):
            self._submit_write_sealed(msg, reqid)
            return
        version = pg.next_version()
        prior = self._object_version(oid)
        snap_txn = self._maybe_clone_for_snap(cid, oid, msg)
        txn, results, delete = self._prepare_txn(cid, oid, msg.ops,
                                                 version)
        if snap_txn is not None:
            snap_txn.append(txn)
            txn = snap_txn
        entry = LogEntry(op=DELETE if delete else MODIFY, oid=oid,
                         version=version, prior_version=prior,
                         reqid=reqid, mtime=time.time())
        pg.append_log_entry(entry, txn)
        peers = [o for o in pg._peer_osds()
                 if pg.backfill_gate(o, oid, is_delete=delete)]
        # ack-after-commit: the primary's own WAL commit is one more
        # member of the waiting set, exactly like each replica's reply
        state = {"waiting": set(peers) | {_LOCAL_COMMIT}, "msg": msg,
                 "version": version, "results": results}
        self._inflight[reqid] = state
        wire_txn = txn.to_dict()
        # sub-ops join the trace as children of the OSD op span (fall
        # back to the client ctx when tracking was skipped)
        span = getattr(getattr(msg, "tracked", None), "span", None)
        trace = span.ctx() if span is not None \
            else getattr(msg, "trace", None)
        for o in peers:
            daemon.send_to_osd(o, M.MOSDRepOp(
                reqid=reqid, pgid=str(pg.pgid),
                epoch=daemon.osdmap.epoch, txn=wire_txn,
                version=list(version),
                log_entries=[entry.to_dict()],
                pg_info=pg.info.to_dict(), trace=trace))
        daemon.store.queue_transaction(txn, self._local_commit_cb(reqid))

    def _local_commit_cb(self, reqid: str):
        """Commit callback gating the client ack on the primary's own
        WAL durability.  Runs on the store finisher; a state that
        vanished (interval change) means the client is resending —
        nothing to do."""
        daemon = self.pg.daemon

        def _committed():
            with daemon.lock:
                st = self._inflight.get(reqid)
                if st is None:
                    return
                st["waiting"].discard(_LOCAL_COMMIT)
                self._maybe_ack(reqid)
        return _committed

    def _object_version(self, oid: str) -> tuple:
        meta = self._read_local_meta(oid)
        return tuple(meta["version"]) if meta else ZERO

    def _read_local_meta(self, oid: str) -> dict | None:
        try:
            return json.loads(bytes(self.pg.daemon.store.getattr(
                self.pg.cid, oid, "_")))
        except (KeyError, ValueError):
            return None

    # -- sealed writes (pool compression / dedup) --------------------------
    def _needs_seal(self, msg: M.MOSDOp) -> bool:
        """Data mutations route through the seal pipeline when the
        pool wants efficiency OR the object is already stored sealed
        (so turning a pool's compression off re-plains objects on
        their next write, and deletes release dedup references)."""
        if not any(op.get("op") in ("write", "write_full", "append",
                                    "truncate", "delete")
                   for op in msg.ops):
            return False
        if self.pg.efficiency_on:
            return True
        return _meta_extra(self._read_local_meta(msg.oid)) is not None

    def _submit_write_sealed(self, msg: M.MOSDOp, reqid: str):
        pg = self.pg
        oid = msg.oid
        if oid in self._seal_gate:
            self._seal_gate[oid].append(
                lambda: self._submit_write_sealed(msg, reqid))
            return
        self._seal_gate[oid] = []
        try:
            self._seal_and_submit(msg, reqid)
        except Exception as e:   # noqa: BLE001 — a poisoned op must
            # release the gate, not wedge every later write
            self._release_seal_gate(oid)
            pg._reply(msg, -22, f"write failed: {e!r}")

    def _release_seal_gate(self, oid: str):
        waiters = self._seal_gate.pop(oid, [])
        for fn in waiters:
            fn()

    def _seal_and_submit(self, msg: M.MOSDOp, reqid: str):
        """Read-modify-seal: materialize the old LOGICAL bytes, apply
        the ops logically (the EC switch shape), then run the result
        through the batch engine's comp lane; the continuation builds
        the replicated txn at its own version (assigned at txn-build
        time so the log stays monotone under async sealing)."""
        pg, daemon = self.pg, self.pg.daemon
        cid, oid = pg.cid, msg.oid
        store = daemon.store
        old_meta = self._read_local_meta(oid)
        cur = b""
        if store.exists(cid, oid):
            cur = pg.unseal_payload(store.read(cid, oid), old_meta)
        delete = False
        attr_ops = []
        results = []
        for op in msg.ops:
            kind = op.get("op")
            if kind in _NOOP_OPS:
                results.append({})
            elif kind == "write_full":
                cur = bytes.fromhex(op["data"])
                results.append({})
            elif kind == "write":
                buf = bytes.fromhex(op["data"])
                off = int(op.get("off", 0))
                base = bytearray(cur)
                if len(base) < off:
                    base.extend(b"\x00" * (off - len(base)))
                base[off:off + len(buf)] = buf
                cur = bytes(base)
                results.append({})
            elif kind == "append":
                cur = cur + bytes.fromhex(op["data"])
                results.append({})
            elif kind == "truncate":
                size = int(op["size"])
                cur = (cur[:size] if size <= len(cur)
                       else cur + b"\x00" * (size - len(cur)))
                results.append({})
            elif kind == "delete":
                want = op.get("if_version")
                if want is not None and \
                        list(self._object_version(oid)) != list(want):
                    raise ValueError(
                        "if_version mismatch: object changed")
                delete = True
                results.append({})
            elif kind in ("setxattr", "rmxattr", "omap_set",
                          "omap_rm"):
                attr_ops.append(op)
                results.append({})
            else:
                raise ValueError(f"unknown write op {kind!r}")
        if delete:
            self._finish_sealed(msg, reqid, old_meta, 0, True,
                                attr_ops, results, b"", None, [])
            return
        span = getattr(getattr(msg, "tracked", None), "span", None)

        def _sealed(err, stored, extra, ingest):
            with daemon.lock:
                if err is not None:
                    self._release_seal_gate(oid)
                    pg._reply(msg, -22, f"write failed: {err!r}")
                    return
                try:
                    self._finish_sealed(
                        msg, reqid, old_meta, len(cur), False,
                        attr_ops, results, stored, extra, ingest)
                except Exception as e:   # noqa: BLE001
                    self._release_seal_gate(oid)
                    pg._reply(msg, -22, f"write failed: {e!r}")

        pg.seal_payload(cur, span, _sealed)

    def _finish_sealed(self, msg: M.MOSDOp, reqid: str, old_meta,
                       logical_size: int, delete: bool, attr_ops,
                       results, stored: bytes, extra, ingest):
        """Build + fan out the sealed txn (under the daemon lock —
        inline for immediate flush, from the completion worker for a
        deadline lane).  New chunk references ingest BEFORE the old
        manifest releases so shared chunks never dip to zero."""
        from ..compress import dedup as dd
        pg, daemon = self.pg, self.pg.daemon
        cid, oid = pg.cid, msg.oid
        version = pg.next_version()
        prior = tuple(old_meta["version"]) if old_meta else ZERO
        old_manifest = dd.manifest_entries(old_meta)
        snap_txn = (None if delete or pg.dedup_on
                    else self._maybe_clone_for_snap(cid, oid, msg))
        txn = Transaction()
        if delete:
            txn.remove(cid, oid)
        else:
            txn.truncate(cid, oid, 0)
            if stored:
                txn.write(cid, oid, 0, stored)
            txn.setattrs(cid, oid, {"_": _obj_meta(
                version, logical_size, extra=extra)})
            for op in attr_ops:
                kind = op["op"]
                if kind == "setxattr":
                    txn.setattrs(cid, oid, {
                        op["name"]: bytes.fromhex(op["data"])})
                elif kind == "rmxattr":
                    txn.rmattr(cid, oid, op["name"])
                elif kind == "omap_set":
                    txn.omap_setkeys(cid, oid, {
                        k: bytes.fromhex(v)
                        for k, v in op["kv"].items()})
                elif kind == "omap_rm":
                    txn.omap_rmkeys(cid, oid, list(op["keys"]))
            for fp, frame in ingest:
                txn.dedup_ingest(dd.DEDUP_COLL, fp, frame)
        for fp, _ln in old_manifest:
            txn.dedup_release(dd.DEDUP_COLL, fp)
        if snap_txn is not None:
            snap_txn.append(txn)
            txn = snap_txn
        entry = LogEntry(op=DELETE if delete else MODIFY, oid=oid,
                         version=version, prior_version=prior,
                         reqid=reqid, mtime=time.time())
        pg.append_log_entry(entry, txn)
        peers = [o for o in pg._peer_osds()
                 if pg.backfill_gate(o, oid, is_delete=delete)]
        state = {"waiting": set(peers) | {_LOCAL_COMMIT}, "msg": msg,
                 "version": version, "results": results}
        self._inflight[reqid] = state
        wire_txn = txn.to_dict()
        span = getattr(getattr(msg, "tracked", None), "span", None)
        trace = span.ctx() if span is not None \
            else getattr(msg, "trace", None)
        for o in peers:
            daemon.send_to_osd(o, M.MOSDRepOp(
                reqid=reqid, pgid=str(pg.pgid),
                epoch=daemon.osdmap.epoch, txn=wire_txn,
                version=list(version),
                log_entries=[entry.to_dict()],
                pg_info=pg.info.to_dict(), trace=trace))
        daemon.store.queue_transaction(txn, self._local_commit_cb(reqid))
        # gate drops once the local (primary) apply is queued —
        # replicated primaries apply immediately, so the next queued
        # write reads this write's bytes (the ack still waits for the
        # WAL commit via _LOCAL_COMMIT)
        self._release_seal_gate(oid)

    # -- pool snapshots (reference PrimaryLogPG make_writeable +
    # SnapMapper: clone the head before the first write past each
    # snap; the clone txn replicates with the write so every acting
    # member holds identical clones) --------------------------------------
    def _maybe_clone_for_snap(self, cid, oid, msg) -> Transaction | None:
        snapc = getattr(msg, "snapc", None)
        if not snapc:
            return None
        seq = int(snapc.get("seq", 0))
        store = self.pg.daemon.store
        if not store.exists(cid, oid):
            # creation after the snaps: stamp when the object appeared
            # (snapshot reads older than that report ENOENT) AND set
            # its snap baseline — clones made later must never claim
            # to cover snaps that predate the object
            t = Transaction()
            t.touch(cid, oid)
            t.setattrs(cid, oid,
                       {"created_seq": str(seq).encode(),
                        "snap_seq": str(seq).encode()})
            return t
        try:
            last = int(bytes(store.getattr(cid, oid, "snap_seq")))
        except KeyError:
            last = 0
        if last >= seq:
            return None
        covered = sorted(s for s in (snapc.get("snaps") or ())
                         if s > last)
        t = Transaction()
        if covered:
            clone = snap_clone_oid(oid, seq)
            t.clone(cid, oid, clone)
            t.setattrs(cid, clone, {
                "snaps": json.dumps(covered).encode()})
            t.omap_setkeys(cid, SNAPMAP_OID, {
                f"{s:010d}|{oid}|{seq}": clone.encode()
                for s in covered})
        t.setattrs(cid, oid, {"snap_seq": str(seq).encode()})
        return t

    def _resolve_snap_read(self, oid: str, snapid: int) -> str | None:
        """Which object holds `oid` as of snapshot `snapid`: the
        OLDEST clone whose seq >= snapid, else the head if it has not
        been cloned past snapid (and existed by then), else nothing
        (reference SnapSet clone resolution)."""
        pg = self.pg
        store, cid = pg.daemon.store, pg.cid
        prefix = f"{oid}{_SNAP_SEP}"
        seqs = sorted(int(o[len(prefix):])
                      for o in pg._list_objects(include_snaps=True)
                      if o.startswith(prefix))
        for cseq in seqs:
            clone = snap_clone_oid(oid, cseq)
            try:
                covered = json.loads(bytes(
                    store.getattr(cid, clone, "snaps")))
            except KeyError:
                covered = []
            if snapid in covered:
                return clone
        if not store.exists(cid, oid):
            return None
        try:
            created = int(bytes(store.getattr(cid, oid,
                                              "created_seq")))
            if created >= snapid:
                return None     # didn't exist at snapshot time
        except KeyError:
            pass
        # no clone >= snapid and the object predates the snapshot:
        # the head is unchanged since then (any later write would
        # have left a clone covering snapid)
        return oid

    def _prepare_txn(self, cid, oid, ops, version):
        """The per-opcode switch (reference do_osd_ops) for mutations."""
        store = self.pg.daemon.store
        txn = Transaction()
        results = []
        delete = False
        # logical size + storage-efficiency extras come from the
        # existing meta (a sealed object's physical stat lies about
        # its length; attr-only rewrites must not clobber the extras)
        extra = None
        meta = self._read_local_meta(oid)
        if meta is not None:
            size = int(meta.get("size", 0))
            extra = _meta_extra(meta)
        else:
            size = 0
            try:
                size = store.stat(cid, oid)["size"]
            except KeyError:
                pass
        for op in ops:
            kind = op.get("op")
            if kind in _NOOP_OPS:
                results.append({})
            elif kind == "write":
                data = bytes.fromhex(op["data"])
                off = int(op.get("off", 0))
                txn.write(cid, oid, off, data)
                size = max(size, off + len(data))
                results.append({})
            elif kind == "write_full":
                data = bytes.fromhex(op["data"])
                txn.truncate(cid, oid, 0)
                txn.write(cid, oid, 0, data)
                size = len(data)
                results.append({})
            elif kind == "append":
                data = bytes.fromhex(op["data"])
                txn.write(cid, oid, size, data)
                size += len(data)
                results.append({})
            elif kind == "truncate":
                size = int(op["size"])
                txn.truncate(cid, oid, size)
                results.append({})
            elif kind == "delete":
                want = op.get("if_version")
                if want is not None and \
                        list(self._object_version(oid)) != list(want):
                    # the flush agent's guarded evict: the object
                    # changed since it was read — do NOT discard the
                    # newer write (reference assert_version semantics)
                    raise ValueError(
                        "if_version mismatch: object changed")
                txn.remove(cid, oid)
                delete = True
                results.append({})
            elif kind == "setxattr":
                txn.setattrs(cid, oid,
                             {op["name"]: bytes.fromhex(op["data"])})
                results.append({})
            elif kind == "rmxattr":
                txn.rmattr(cid, oid, op["name"])
                results.append({})
            elif kind == "omap_set":
                txn.omap_setkeys(cid, oid, {
                    k: bytes.fromhex(v) for k, v in op["kv"].items()})
                results.append({})
            elif kind == "omap_rm":
                txn.omap_rmkeys(cid, oid, list(op["keys"]))
                results.append({})
            else:
                raise ValueError(f"unknown write op {kind!r}")
        if not delete:
            txn.setattrs(cid, oid,
                         {"_": _obj_meta(version, size, extra=extra)})
        return txn, results, delete

    def _maybe_ack(self, reqid: str):
        st = self._inflight.get(reqid)
        if st is None or st["waiting"]:
            return
        del self._inflight[reqid]
        self.pg._reply(st["msg"], 0, "", results=st["results"],
                       version=st["version"])

    def handle_rep_reply(self, msg: M.MOSDRepOpReply):
        st = self._inflight.get(msg.reqid)
        if st is None:
            return
        st["waiting"].discard(msg.from_osd)
        self._maybe_ack(msg.reqid)

    # -- replica apply -----------------------------------------------------
    def apply_rep_op(self, msg: M.MOSDRepOp):
        pg, daemon = self.pg, self.pg.daemon
        daemon.perf.inc("subop")
        txn = Transaction.from_dict(msg.txn)
        for ed in msg.log_entries or []:
            e = LogEntry.from_dict(ed)
            # this txn supersedes pending recovery for the object even
            # when the entry is a dup of one merged during activation
            pg.missing.pop(e.oid, None)
            if e.version > pg.log.head:
                pg.log.add(e)
                pg.info.last_update = e.version
        pg._maybe_trim_log()
        pg._persist_meta(txn)
        reply = M.MOSDRepOpReply(
            reqid=msg.reqid, pgid=msg.pgid,
            epoch=daemon.osdmap.epoch, rc=0,
            from_osd=daemon.whoami)

        def _committed():
            # the replica's ack is its commit promise — it must not
            # leave this OSD before the txn is WAL-durable here
            with daemon.lock:
                daemon.send_to_osd(pg.primary, reply)
        daemon.store.queue_transaction(txn, _committed)

    # -- reads -------------------------------------------------------------
    def do_reads(self, msg: M.MOSDOp):
        store, cid, oid = self.pg.daemon.store, self.pg.cid, msg.oid
        results = []
        for op in msg.ops:
            kind = op.get("op")
            src = oid
            if op.get("snapid"):
                # snapshot read: resolve through the clone chain
                src = self._resolve_snap_read(oid, int(op["snapid"]))
                if src is None:
                    raise KeyError(oid)     # ENOENT at that snapshot
            if kind in _NOOP_OPS:
                results.append({})
            elif kind == "read":
                meta = self._read_local_meta(src)
                if _meta_extra(meta) is not None:
                    # sealed object: expand to logical, then slice
                    full = self.pg.unseal_payload(
                        store.read(cid, src), meta)
                    off = int(op.get("off", 0))
                    length = op.get("len")
                    end = (len(full) if length is None
                           else off + int(length))
                    results.append({"data": full[off:end].hex()})
                else:
                    length = op.get("len")
                    data = store.read(
                        cid, src, int(op.get("off", 0)),
                        None if length is None else int(length))
                    results.append({"data": data.hex()})
            elif kind == "stat":
                meta = self._read_local_meta(src)
                size = (int(meta["size"]) if meta and "size" in meta
                        else store.stat(cid, src)["size"])
                results.append({"size": size,
                                "version": self._object_version(oid)})
            elif kind == "getxattr":
                results.append(
                    {"data": store.getattr(cid, oid, op["name"]).hex()})
            elif kind == "getxattrs":
                results.append({"attrs": {
                    k: v.hex() for k, v in store.getattrs(cid, oid).items()
                    if k != "_"}})
            elif kind == "omap_get":
                results.append(_omap_read_result(
                    store.omap_get(cid, oid), op))
            elif kind == "pgls":
                results.append({"objects": self.pg._list_objects()})
            else:
                raise ValueError(f"unknown read op {kind!r}")
        return results

    # -- scrub -------------------------------------------------------------
    def build_scrub_map(self, deep: bool = True) -> dict:
        """oid → {size, crc, version} over my copy of the collection
        (reference ScrubMap build: whole-object crc per replica).
        Deep maps carry a true CRC-32C data digest — payloads are
        bucketed and digested through the batched scrub engine; a
        shallow map reads no data (size from the object meta)."""
        pg = self.pg
        store, cid = pg.daemon.store, pg.cid
        out = {}
        payloads: dict[str, bytes] = {}
        for oid in pg._list_objects(include_snaps=True):
            try:
                meta = json.loads(bytes(store.getattr(cid, oid, "_")))
                if deep:
                    payloads[oid] = bytes(store.read(cid, oid))
                    size = len(payloads[oid])
                else:
                    size = int(meta.get("size", 0))
            except KeyError:
                continue
            out[oid] = {"size": size,
                        "version": meta.get("version", list(ZERO)),
                        "valid": True}
        if deep:
            eng = pg.daemon.scrub_engine
            span = pg.daemon.tracer.start_span(
                "crc_digest", tags={
                    "layer": "device", "kernel": "crc32c",
                    "pgid": str(pg.pgid), "objects": len(payloads),
                    "bytes": sum(len(b) for b in payloads.values())})
            if span is not None:
                span.add_link(getattr(pg, "_scrub_trace", None))
            for oid, digest in eng.compute_digests(payloads).items():
                out[oid]["crc"] = digest
            if span is not None:
                span.finish()
            perf = pg.daemon.perf
            perf.inc("scrub_objects_scanned", len(payloads))
            perf.inc("scrub_digest_bytes",
                     sum(len(b) for b in payloads.values()))
        return out

    def scrub_compare(self, maps: dict[int, dict],
                      deep: bool = True) -> int:
        """Majority-vote across replica digests (sizes only, for a
        shallow scrub); divergent or absent copies become recovery
        state (pushed from the authoritative copy).  Ties prefer the
        primary's copy — the reference prefers the copy matching the
        object_info digest and falls back to the primary.  Returns the
        inconsistency count and leaves a ``list-inconsistent-obj``
        report on the PG."""
        pg = self.pg
        me = pg.daemon.whoami
        oids = set()
        for m in maps.values():
            oids.update(m)
        errors = 0
        report = []
        for oid in sorted(oids):
            votes: dict[tuple, list[int]] = {}
            for osd, m in maps.items():
                e = m.get(oid)
                if e is not None:
                    votes.setdefault((e.get("crc"), e["size"]),
                                     []).append(osd)
            best = max(votes, key=lambda k: (len(votes[k]),
                                             me in votes[k]))
            good = votes[best]
            ver = tuple(next(m[oid] for m in maps.values()
                             if oid in m)["version"])
            shard_report: dict[tuple, dict] = {}
            obj_errors: set[str] = set()
            for osd, m in maps.items():
                if osd in good:
                    continue
                errors += 1
                e = m.get(oid)
                if e is None:
                    shard_report[osd, 0] = {"errors": ["missing"]}
                    obj_errors.add("missing")
                else:
                    kind = ("size_mismatch"
                            if e["size"] != best[1]
                            else "data_digest_mismatch")
                    shard_report[osd, 0] = {
                        "size": e["size"], "digest": e.get("crc"),
                        "errors": [kind]}
                    obj_errors.add(kind)
                if osd == me:
                    pg.missing[oid] = ver
                    # pull specifically from an authoritative copy
                    # (recover_primary_object would pick any peer,
                    # including another inconsistent one)
                    donor = next((o for o in good if o != me), None)
                    if donor is not None:
                        self._send_pull(donor, oid)
                else:
                    pg.peer_missing.setdefault(osd, {})[oid] = ver
            if shard_report:
                for osd in good:
                    e = maps[osd][oid]
                    shard_report[osd, 0] = {
                        "size": e["size"], "digest": e.get("crc"),
                        "errors": []}
                report.append(scrub_engine.inconsistent_entry(
                    oid, sorted(obj_errors), shard_report))
        if report:
            pg.inconsistent_objects = report
        return errors

    def snap_trim(self, removed: set[int] | None):
        """Deleted pool snaps release their clones (reference
        SnapMapper-driven snap trim): each clone's covered-snaps set
        shrinks; empty → the clone object is removed.  Runs on every
        acting member (clones are replicated, so is the trim).
        removed=None reconciles against the pool's current snap set —
        the catch-up path for an OSD that missed rmsnap epochs."""
        pg = self.pg
        store, cid = pg.daemon.store, pg.cid
        try:
            index = store.omap_get(cid, SNAPMAP_OID)
        except KeyError:
            return
        if removed is None:
            live = set(pg.pool.snaps)
            removed = {int(k.split("|", 1)[0]) for k in index} - live
            if not removed:
                return
        t = Transaction()
        dead_keys = []
        clones: dict[str, None] = {}
        for key in index:
            sid = int(key.split("|", 1)[0])
            if sid in removed:
                dead_keys.append(key)
                clones[bytes(index[key]).decode()] = None
        for clone in clones:
            try:
                covered = set(json.loads(bytes(
                    store.getattr(cid, clone, "snaps"))))
            except KeyError:
                continue
            covered -= removed
            if covered:
                t.setattrs(cid, clone, {
                    "snaps": json.dumps(sorted(covered)).encode()})
            else:
                t.remove(cid, clone)
        if dead_keys:
            t.omap_rmkeys(cid, SNAPMAP_OID, dead_keys)
        if not t.empty():
            store.queue_transaction(t)

    # -- recovery ----------------------------------------------------------
    @staticmethod
    def _snap_payload(store, cid: str, oid: str):
        """A head's snap clones + SnapMapper rows, for the push
        payload (reference: recovery is SnapSet-aware — clones travel
        with the head)."""
        clones = {}
        prefix = f"{oid}{_SNAP_SEP}"
        try:
            siblings = store.list_objects(cid)
        except KeyError:
            return None, None
        for o in siblings:
            if o.startswith(prefix):
                clones[o] = {
                    "data": store.read(cid, o).hex(),
                    "attrs": {k: v.hex() for k, v in
                              store.getattrs(cid, o).items()}}
        rows = {}
        try:
            snapmap = store.omap_get(cid, SNAPMAP_OID)
        except KeyError:
            snapmap = {}
        for key, val in snapmap.items():
            if key.split("|", 1)[1].rsplit("|", 1)[0] == oid:
                rows[key] = val.hex()
        return clones or None, rows or None

    @staticmethod
    def _dedup_payload(store, attrs) -> dict | None:
        """{fp: chunk frame hex} for a manifested head's push — chunk
        payloads travel with the manifest so the target can ingest
        them into its own refcount index."""
        from ..compress import dedup as dd
        try:
            meta = json.loads(bytes(attrs.get("_", b"{}")) or b"{}")
        except ValueError:
            return None
        frames = {}
        for fp, _ln in dd.manifest_entries(meta):
            if fp in frames:
                continue
            try:
                frames[fp] = bytes(store.read(
                    dd.DEDUP_COLL, dd.chunk_oid(fp))).hex()
            except KeyError:
                continue
        return frames or None

    def push_object(self, peer: int, oid: str, version: tuple):
        pg, daemon = self.pg, self.pg.daemon
        cid = pg.cid
        try:
            data = daemon.store.read(cid, oid)
            attrs = daemon.store.getattrs(cid, oid)
            omap = daemon.store.omap_get(cid, oid)
        except KeyError:
            return
        clones, snaprows = self._snap_payload(daemon.store, cid, oid)
        daemon.send_to_osd(peer, M.MOSDPGPush(
            pgid=str(pg.pgid), epoch=daemon.osdmap.epoch, oid=oid,
            data=data.hex(),
            attrs={k: v.hex() for k, v in attrs.items()},
            omap={k: v.hex() for k, v in omap.items()},
            version=list(version), from_osd=daemon.whoami,
            pull_tid=None, clones=clones, snapmap=snaprows,
            dedup=self._dedup_payload(daemon.store, attrs)))

    def recover_primary_object(self, oid: str, version: tuple):
        """Pull from any peer whose info covers the version."""
        pg = self.pg
        donor = next((o for o, pi in pg.peer_info.items()
                      if pi.last_update >= version), None)
        if donor is not None:
            self._send_pull(donor, oid)

    def answer_pull(self, msg: M.MOSDPGPull):
        pg, daemon = self.pg, self.pg.daemon
        try:
            data = daemon.store.read(pg.cid, msg.oid)
            attrs = daemon.store.getattrs(pg.cid, msg.oid)
            omap = daemon.store.omap_get(pg.cid, msg.oid)
        except KeyError:
            return
        meta = json.loads(bytes(attrs.get("_", b"{}")) or b"{}")
        clones, snaprows = self._snap_payload(daemon.store, pg.cid,
                                              msg.oid)
        daemon.send_to_osd(msg.from_osd, M.MOSDPGPush(
            pgid=str(pg.pgid), epoch=daemon.osdmap.epoch, oid=msg.oid,
            data=data.hex(),
            attrs={k: v.hex() for k, v in attrs.items()},
            omap={k: v.hex() for k, v in omap.items()},
            version=meta.get("version", list(ZERO)),
            from_osd=daemon.whoami, pull_tid=msg.pull_tid,
            clones=clones, snapmap=snaprows,
            dedup=self._dedup_payload(daemon.store, attrs)))

    def apply_push(self, msg: M.MOSDPGPush):
        pg, daemon = self.pg, self.pg.daemon
        cid = pg.cid
        if _push_is_stale(daemon.store, cid, msg):
            # the bytes are already here at (or past) the pushed
            # version — the object is NOT missing; forgetting to clear
            # the entry makes the peer re-report it at every peering
            # and the cluster re-push forever
            pg.missing.pop(msg.oid, None)
            return
        from ..compress import dedup as dd
        old_meta = None
        try:
            old_meta = json.loads(bytes(daemon.store.getattr(
                cid, msg.oid, "_")))
        except (KeyError, ValueError):
            pass
        t = Transaction()
        if not daemon.store.collection_exists(cid):
            t.create_collection(cid)
        t.remove(cid, msg.oid)
        t.touch(cid, msg.oid)
        if msg.data:
            t.write(cid, msg.oid, 0, bytes.fromhex(msg.data))
        if msg.attrs:
            t.setattrs(cid, msg.oid,
                       {k: bytes.fromhex(v) for k, v in msg.attrs.items()})
        # dedup bookkeeping: ingest the pushed manifest's chunks (one
        # ref per entry) BEFORE releasing the replaced local copy's
        # references — shared chunks must never dip to zero
        new_meta = None
        try:
            new_meta = json.loads(bytes.fromhex(
                (msg.attrs or {}).get("_", "")))
        except ValueError:
            pass
        frames = msg.dedup or {}
        for fp, _ln in dd.manifest_entries(new_meta):
            if fp in frames:
                t.dedup_ingest(dd.DEDUP_COLL, fp,
                               bytes.fromhex(frames[fp]))
        for fp, _ln in dd.manifest_entries(old_meta):
            t.dedup_release(dd.DEDUP_COLL, fp)
        if msg.omap:
            t.omap_setkeys(cid, msg.oid, {
                k: bytes.fromhex(v) for k, v in msg.omap.items()})
        for coid, payload in (msg.clones or {}).items():
            t.remove(cid, coid)
            t.write(cid, coid, 0, bytes.fromhex(payload["data"]))
            if payload.get("attrs"):
                t.setattrs(cid, coid, {
                    k: bytes.fromhex(v)
                    for k, v in payload["attrs"].items()})
        if msg.snapmap:
            t.omap_setkeys(cid, SNAPMAP_OID, {
                k: bytes.fromhex(v) for k, v in msg.snapmap.items()})
        pg.missing.pop(msg.oid, None)
        pg._persist_meta(t)
        daemon.store.queue_transaction(t)


# ===========================================================================
# EC backend
# ===========================================================================
class ECBackend(PGBackendBase):
    """Erasure-coded I/O (reference ECBackend): full-object writes are
    encoded into k+m shard chunks on the daemon's device; reads gather
    ``minimum_to_decode`` shards and decode (straight concat when the
    data shards survive — systematic code)."""

    def __init__(self, pg: PG):
        self.pg = pg
        self._engine = None
        self._inflight: dict[str, dict] = {}
        self._reads: dict[int, dict] = {}
        self._read_tid = 0
        # per-object read-modify-write gate: oid → queued retries
        # (reference ECBackend's extent cache serializes RMW per
        # object; PG-object granularity here)
        self._rmw: dict[str, list] = {}
        # reqids anywhere between submit and ack — resends dup-drop
        # against this (the log can't dup-detect pre-ack ops under
        # primary-applies-last)
        self._active_reqids: set = set()
        # shard pushes in flight: (peer, oid) → monotonic start
        self._pushes: dict[tuple[int, str], float] = {}

    @property
    def engine(self):
        if self._engine is None:
            # resolve exactly like the mon's `osd pool create` (same
            # "default" alias and k=2/m=2 fallback): a different
            # fallback here desyncs the chunk count from pool.size —
            # CRUSH then maps a shard the encoder never produces
            prof_d = self.pg.daemon.osdmap.erasure_code_profiles.get(
                self.pg.pool.erasure_code_profile or "default",
                {"k": "2", "m": "2"})
            self._engine = create_erasure_code(
                ECProfile.parse(prof_d), device=self.pg.daemon.device)
        return self._engine

    def on_change(self):
        # see ReplicatedBackend.on_change: dropped repops must not
        # linger in the op tracker
        for st in self._inflight.values():
            self.pg.finish_tracked(st.get("msg"), "reset")
        for st in self._reads.values():
            self.pg.finish_tracked(st.get("msg"), "reset")
        self._inflight.clear()
        self._reads.clear()
        self._rmw.clear()
        self._active_reqids.clear()
        self._pushes.clear()

    # -- writes ------------------------------------------------------------
    def submit_write(self, msg: M.MOSDOp, reqid: str):
        """EC mutations: write_full/delete/xattr/omap apply directly;
        partial `write` and `append` on an existing object go through
        read-modify-write — gather the stripe (decode from minimum
        shards, reconstructing if degraded), splice the new bytes,
        re-encode, sub-write (reference ``src/osd/ECTransaction.cc``
        + the extent cache, at object granularity)."""
        pg = self.pg
        oid = msg.oid
        active = self._active_reqids
        if reqid in active:
            # a client resend raced the IN-FLIGHT original: with
            # primary-applies-last the log entry (and so the dup
            # check) only lands at ack time, so without this the
            # resend would queue behind the RMW gate and APPLY AGAIN
            # (double append).  Drop it — the original replies with
            # the same tid (reference: in-progress repop dup check).
            return
        active.add(reqid)
        if oid in self._rmw:
            # an RMW is mid-flight on this object: EVERY write to it
            # queues behind it (a write_full/delete slipping past
            # would be clobbered when the RMW's splice commits)
            self._rmw[oid].append(
                lambda: self._resubmit_queued(msg, reqid))
            return
        # serialize ALL writes per object, not just RMWs: the primary
        # now applies locally at ACK time (primary-applies-last), so
        # two in-flight ops on one object could complete out of order
        # and leave the primary's shard at the older bytes
        self._rmw[oid] = []
        try:
            self._submit_gated(msg, reqid, oid)
        except Exception as e:   # noqa: BLE001 — a poisoned op (bad
            # op kind, encode failure) must release the gate and fail
            # the op, not wedge every later write to this object —
            # and must clear its half-registered inflight state
            self._inflight.pop(reqid, None)
            active.discard(reqid)
            self._release_rmw(oid)
            pg._reply(msg, -22, f"write failed: {e!r}")

    def _submit_gated(self, msg: M.MOSDOp, reqid: str, oid: str):
        pg = self.pg
        exists = self._read_local_meta(oid) is not None
        kinds = [op.get("op") for op in msg.ops]
        needs_old = exists and any(k in ("write", "append", "truncate")
                                   for k in kinds)
        if needs_old:
            fake = M.MOSDOp(tid=0, client="rmw", pgid=str(pg.pgid),
                            oid=oid, epoch=pg.daemon.osdmap.epoch,
                            ops=[], flags=0)
            fake.connection = None

            def on_chunks(decoded, meta):
                size = int(meta.get("size", 0))
                k = self.engine.k
                stored = (int(meta.get("stored", size))
                          if "comp" in meta else size)
                raw = b"".join(
                    decoded[i].tobytes() for i in range(k))[:stored]
                old = pg.unseal_payload(raw, meta)
                try:
                    self._apply_ops(msg, reqid, old)
                except Exception as e:   # noqa: BLE001 — same
                    # poisoned-op handling as the synchronous path:
                    # release the gate + reqid mark + inflight state
                    # and FAIL the op, or every later write to this
                    # object wedges (and a stale inflight entry could
                    # ack a future resend early off late sub-replies)
                    self._inflight.pop(reqid, None)
                    self._active_reqids.discard(reqid)
                    self._release_rmw(oid)
                    pg._reply(msg, -22, f"write failed: {e!r}")
                # gate NOT released on success: it holds until the
                # op acks (primary-applies-last ordering)

            def on_fail():
                self._active_reqids.discard(reqid)
                self._release_rmw(oid)
                pg._reply(msg, -5, "rmw read failed")

            self._start_data_read(fake, on_chunks=on_chunks,
                                  on_fail=on_fail)
            return
        self._apply_ops(msg, reqid, b"" if not exists else None)

    def _resubmit_queued(self, msg, reqid: str):
        """Re-enter submit for a write that waited behind the RMW
        gate (clearing its active mark so the re-entry isn't treated
        as its own duplicate)."""
        self._active_reqids.discard(reqid)
        self.submit_write(msg, reqid)

    def _release_rmw(self, oid: str):
        waiters = self._rmw.pop(oid, [])
        for fn in waiters:
            fn()

    def _apply_ops(self, msg: M.MOSDOp, reqid: str,
                   old: bytes | None):
        """Build the new object payload from `old` (b"" for a fresh
        object, None when no data op needs it) and fan out."""
        pg = self.pg
        oid = msg.oid
        version = pg.next_version()
        prior = self._object_version(oid)
        data = None
        cur = old
        delete = False
        attr_ops = []
        results = []
        for op in msg.ops:
            kind = op.get("op")
            if kind in _NOOP_OPS:
                results.append({})
            elif kind == "write_full":
                cur = bytes.fromhex(op["data"])
                data = cur
                results.append({})
            elif kind == "write":
                buf = bytes.fromhex(op["data"])
                off = int(op.get("off", 0))
                base = bytearray(cur or b"")
                if len(base) < off:
                    base.extend(b"\x00" * (off - len(base)))
                base[off:off + len(buf)] = buf
                cur = bytes(base)
                data = cur
                results.append({})
            elif kind == "append":
                cur = (cur or b"") + bytes.fromhex(op["data"])
                data = cur
                results.append({})
            elif kind == "truncate":
                size = int(op["size"])
                base = (cur or b"")
                cur = (base[:size] if size <= len(base)
                       else base + b"\x00" * (size - len(base)))
                data = cur
                results.append({})
            elif kind == "delete":
                delete = True
                results.append({})
            elif kind in ("setxattr", "rmxattr", "omap_set", "omap_rm"):
                attr_ops.append(op)
                results.append({})
            else:
                raise ValueError(f"unknown write op {kind!r}")
        entry = LogEntry(op=DELETE if delete else MODIFY, oid=oid,
                         version=version, prior_version=prior,
                         reqid=reqid, mtime=time.time())
        daemon = pg.daemon
        # encode once; per-shard transactions.  The fused GF encode +
        # CRC digest is the device kernel of the write path — it goes
        # through the per-OSD batch engine, which coalesces concurrent
        # writes (across PGs and op types) into megabatch launches and
        # completes each member with its shard bytes AND per-shard
        # hinfo digests.  The fan-out continues in the completion
        # callback; with the default immediate flush this runs
        # synchronously before submit_encode returns (the old
        # semantics, bit-identically), while a deadline window makes
        # it a true async data plane.  Traced as a child of the OSD op
        # span; the engine links it to its megabatch flush span.
        if data is not None:
            k, m = self.engine.k, self.engine.m
            _ospan = getattr(getattr(msg, "tracked", None), "span",
                             None)
            span = daemon.tracer.start_span(
                "gf_encode", parent=_ospan, tags={
                    "layer": "device", "kernel": "gf_encode",
                    "bytes": len(data), "k": k, "m": m})

            def _fail(e):
                self._inflight.pop(reqid, None)
                self._active_reqids.discard(reqid)
                self._release_rmw(oid)
                pg._reply(msg, -22, f"write failed: {e!r}")

            def _encoded(comp, _extra, _dlen=len(data)):
                with daemon.lock:
                    if span is not None:
                        if comp.info:
                            span.set_tag("batch_rows",
                                         comp.info.get("rows"))
                            span.set_tag("batch_members",
                                         comp.info.get("members"))
                        span.finish()
                    if reqid not in self._active_reqids:
                        return      # op reset (on_change) mid-encode
                    if comp.error is not None:
                        _fail(comp.error)
                        return
                    shard_chunks, hinfos = comp.value
                    try:
                        self._finish_apply(
                            msg, reqid, oid, entry, version, results,
                            shard_chunks, hinfos, delete, attr_ops,
                            _dlen, extra=_extra)
                    except Exception as e:   # noqa: BLE001 — poisoned
                        # op past encode: same cleanup as submit_write
                        _fail(e)

            def _encode(payload, extra):
                with daemon.profiler.bind():
                    daemon.batch_engine.submit_encode(
                        self.engine, payload, span=span,
                        callback=lambda comp: _encoded(comp, extra))

            if pg.compression_on:
                # inline compression before the erasure code: the
                # SEALED payload is what shards into chunks — hinfo
                # CRCs stay consistent across replicas, scrub and
                # recovery move sealed bytes, reads truncate the
                # decoded concat to `stored` then expand
                def _sealed(err, stored, extra, _ingest):
                    with daemon.lock:
                        if reqid not in self._active_reqids:
                            return
                        if err is not None:
                            _fail(err)
                            return
                        try:
                            _encode(stored, extra)
                        except Exception as e:   # noqa: BLE001
                            _fail(e)

                pg.seal_payload(data, span, _sealed)
            else:
                _encode(data, None)
            return
        self._finish_apply(msg, reqid, oid, entry, version, results,
                           None, None, delete, attr_ops, None)

    def _finish_apply(self, msg: M.MOSDOp, reqid: str, oid: str,
                      entry, version, results, shard_chunks, hinfos,
                      delete: bool, attr_ops, logical_size,
                      extra=None):
        """The post-encode half of a write: min_size gate, per-shard
        transactions, primary-applies-last fan-out.  Runs inline for
        data-less ops and as the batch engine's completion for
        encoded ones (under the daemon lock either way)."""
        pg = self.pg
        daemon = pg.daemon
        live = []
        for s, o in enumerate(pg.acting):
            if o == CRUSH_ITEM_NONE or not daemon.osdmap.is_up(o):
                continue
            if o != daemon.whoami and \
                    not pg.backfill_gate(o, oid, is_delete=delete):
                continue
            live.append((s, o))
        if len(live) < max(pg.pool.min_size, self.engine.k) \
                and not delete:
            # durability floor (reference: EC PGs don't go active —
            # and writes don't ack — below min_size): acking after
            # landing on fewer shards can leave a stripe that a single
            # later failure makes unrecoverable.  EAGAIN; the client
            # retries until enough members take the write.  Deletes
            # are exempt: they remove state and replay from the log.
            pg._reply(msg, -11, "degraded below min_size")
            self._active_reqids.discard(reqid)
            self._release_rmw(oid)
            return
        # PRIMARY APPLIES LAST (write-ahead ordering): the local txn +
        # log entry are deferred until every live peer acked its
        # sub-write.  An op interrupted mid-fan-out then leaves NO
        # trace on the primary — the client's resend re-executes at a
        # fresh version and full-replace fan-out heals any peer
        # orphans.  The old order (primary first) could strand the
        # only copy of a stripe on the primary's single shard — m
        # losses of redundancy in one step and unrecoverable with
        # k > 1 (the reference avoids this with per-entry rollback
        # records in the EC log; deferring the primary is the
        # rollback-free equivalent at our op granularity).
        local = [(s, o) for s, o in live if o == daemon.whoami]
        remote = [(s, o) for s, o in live if o != daemon.whoami]
        local_txns = [self._shard_txn(s, oid, shard_chunks, delete,
                                      attr_ops, version,
                                      logical_size, hinfos=hinfos,
                                      extra=extra)
                      for s, _ in local]
        state = {"waiting": {s for s, _ in remote}, "msg": msg,
                 "version": version, "results": results,
                 "local_txns": local_txns, "entry": entry,
                 "oid": oid}
        self._inflight[reqid] = state
        span = getattr(getattr(msg, "tracked", None), "span", None)
        trace = span.ctx() if span is not None \
            else getattr(msg, "trace", None)
        for s, o in remote:
            txn = self._shard_txn(s, oid, shard_chunks, delete,
                                  attr_ops, version, logical_size,
                                  hinfos=hinfos, extra=extra)
            daemon.send_to_osd(o, M.MOSDECSubOpWrite(
                reqid=reqid, pgid=str(pg.pgid), shard=s,
                epoch=daemon.osdmap.epoch, txn=txn.to_dict(),
                version=list(version),
                log_entries=[entry.to_dict()],
                pg_info=pg.info.to_dict(), trace=trace))
        self._maybe_ack(reqid)

    def _shard_txn(self, shard: int, oid: str, chunks, delete: bool,
                   attr_ops, version, logical_size,
                   hinfos=None, extra=None) -> Transaction:
        pg = self.pg
        cid = pg.cid_for_shard(shard)
        t = Transaction()
        if delete:
            t.remove(cid, oid)
            return t
        if chunks is not None:
            chunk = chunks[shard]
            # hinfo normally arrives precomputed from the batch
            # engine's fused digest (identical by construction to the
            # host crc — asserted in tests); the host path is the
            # fallback for callers without one
            hinfo = (hinfos[shard] if hinfos is not None
                     else crc32c(chunk))
            t.truncate(cid, oid, 0)
            t.write(cid, oid, 0, chunk)
            t.setattrs(cid, oid, {"_": _obj_meta(
                version, logical_size, hinfo=hinfo, extra=extra)})
        # attr-only mutations leave "_" untouched: it carries the
        # shard's data hinfo, which an attr update must not clobber
        # (the log entry alone records the new version)
        for op in attr_ops:
            kind = op["op"]
            if kind == "setxattr":
                t.setattrs(cid, oid,
                           {op["name"]: bytes.fromhex(op["data"])})
            elif kind == "rmxattr":
                t.rmattr(cid, oid, op["name"])
            elif kind == "omap_set":
                t.omap_setkeys(cid, oid, {
                    k: bytes.fromhex(v) for k, v in op["kv"].items()})
            elif kind == "omap_rm":
                t.omap_rmkeys(cid, oid, list(op["keys"]))
        return t

    def _apply_shard_txn(self, txn: Transaction, entries,
                         on_commit=None):
        pg = self.pg
        for e in entries:
            # the applied txn supersedes any pending recovery for this
            # object even when the entry itself is a dup (an activation
            # log that raced this sub-write may have queued it missing)
            pg.missing.pop(e.oid, None)
            if e.version > pg.log.head:
                pg.log.add(e)
                pg.info.last_update = e.version
        pg._maybe_trim_log()
        pg._persist_meta(txn)
        pg.daemon.store.queue_transaction(txn, on_commit)

    def apply_sub_write(self, msg: M.MOSDECSubOpWrite):
        pg, daemon = self.pg, self.pg.daemon
        daemon.perf.inc("subop")
        txn = Transaction.from_dict(msg.txn)
        entries = [LogEntry.from_dict(e) for e in msg.log_entries or []]
        reply = M.MOSDECSubOpWriteReply(
            reqid=msg.reqid, pgid=msg.pgid, shard=msg.shard,
            epoch=daemon.osdmap.epoch, rc=0, from_osd=daemon.whoami)

        def _committed():
            # the shard ack is a commit promise: it leaves only after
            # the sub-write is WAL-durable on this OSD
            with daemon.lock:
                daemon.send_to_osd(pg.primary, reply)
        self._apply_shard_txn(txn, entries, _committed)
        pg._note_local_object_write()

    def handle_sub_write_reply(self, msg: M.MOSDECSubOpWriteReply):
        st = self._inflight.get(msg.reqid)
        if st is None:
            return
        st["waiting"].discard(msg.shard)
        self._maybe_ack(msg.reqid)

    def _maybe_ack(self, reqid: str):
        st = self._inflight.get(reqid)
        if st is None or st["waiting"]:
            return
        pg = self.pg
        daemon = pg.daemon
        if not st.get("committing"):
            # every live peer committed: NOW apply locally + log
            # (primary-applies-last -- see submit_write).  The client
            # ack additionally waits for the local shard txns and the
            # meta txn to be WAL-durable: phase two below.
            st["committing"] = True
            txns = list(st.get("local_txns") or ())
            entry = st.get("entry")
            if entry is not None:
                pg.missing.pop(st.get("oid"), None)
                pg.log.add(entry)
                pg.info.last_update = entry.version
                txns.append(pg._persist_meta())
            st["pending_commits"] = len(txns)

            def _committed():
                with daemon.lock:
                    cur = self._inflight.get(reqid)
                    if cur is not st:
                        return      # interval change swept the state
                    st["pending_commits"] -= 1
                    self._maybe_ack(reqid)
            for txn in txns:
                daemon.store.queue_transaction(txn, _committed)
        if st.get("pending_commits", 0) > 0:
            return
        del self._inflight[reqid]
        pg._reply(st["msg"], 0, "", results=st["results"],
                  version=st["version"])
        self._active_reqids.discard(reqid)
        if st.get("oid") is not None:
            self._release_rmw(st["oid"])

    # -- object meta helpers ----------------------------------------------
    def _object_version(self, oid: str) -> tuple:
        meta = self._read_local_meta(oid)
        return tuple(meta["version"]) if meta else ZERO

    def _read_local_meta(self, oid: str) -> dict | None:
        try:
            return json.loads(bytes(self.pg.daemon.store.getattr(
                self.pg.cid, oid, "_")))
        except KeyError:
            return None


    # -- reads -------------------------------------------------------------
    def do_reads(self, msg: M.MOSDOp):
        """EC reads may fan out; returns None (async) unless every
        wanted op is locally answerable."""
        pg = self.pg
        oid = msg.oid
        meta = self._read_local_meta(oid)
        simple = []
        needs_data = False
        for op in msg.ops:
            kind = op.get("op")
            if op.get("snapid"):
                raise ValueError(
                    "pool snapshots are not supported on EC pools")
            if kind in _NOOP_OPS:
                simple.append({})
            elif kind in ("read",):
                needs_data = True
            elif kind == "stat":
                if meta is None:
                    raise KeyError(oid)
                simple.append({"size": meta["size"],
                               "version": tuple(meta["version"])})
            elif kind == "getxattr":
                simple.append({"data": self.pg.daemon.store.getattr(
                    pg.cid, oid, op["name"]).hex()})
            elif kind == "getxattrs":
                simple.append({"attrs": {
                    k: v.hex() for k, v in
                    self.pg.daemon.store.getattrs(pg.cid, oid).items()
                    if k != "_"}})
            elif kind == "omap_get":
                simple.append(_omap_read_result(
                    self.pg.daemon.store.omap_get(pg.cid, oid), op))
            elif kind == "pgls":
                simple.append({"objects": pg._list_objects()})
            else:
                raise ValueError(f"unknown read op {kind!r}")
        if not needs_data:
            return simple
        if meta is None:
            raise KeyError(oid)
        self._start_data_read(msg)
        return None

    def _available_shards(self) -> dict[int, int]:
        """shard → osd by acting position, live members only."""
        pg, m = self.pg, self.pg.daemon.osdmap
        return {s: o for s, o in enumerate(pg.acting)
                if o != CRUSH_ITEM_NONE and m.is_up(o)}

    def _holders_by_shard(self) -> dict[int, list[int]]:
        """shard → acting members whose shard-s COLLECTION holds data,
        from peering-time shards_held advertisements (split /
        re-placement leftovers).  Alternates for when the assigned
        member lacks an object — sub-reads are collection-addressed,
        so any holder can serve."""
        pg, m = self.pg, self.pg.daemon.osdmap
        held_by: dict[int, list[int]] = {}
        for s in pg._held_shards():
            held_by.setdefault(s, []).append(pg.daemon.whoami)
        for o, pi in pg.peer_info.items():
            if o in pg.acting and m.is_up(o) and pi.shards_held:
                for s in pi.shards_held:
                    held_by.setdefault(s, []).append(o)
        return held_by

    def _start_data_read(self, msg: M.MOSDOp, want=None, on_chunks=None,
                         exclude: set[int] | None = None, on_fail=None):
        """Gather minimum_to_decode shards, then decode+reply (or hand
        chunks to `on_chunks` for recovery reconstruction).  `exclude`
        drops shards known not to hold the object (recovery targets,
        peers still missing it).  Every failure path fires `on_fail`
        so recovery callers can release their pull registration and
        retry later instead of wedging."""
        pg, daemon = self.pg, self.pg.daemon
        oid = msg.oid if msg is not None else None
        k = self.engine.k
        avail = self._available_shards()
        for s in exclude or ():
            avail.pop(s, None)
        holders = self._holders_by_shard()
        # assigned-member-first with alternate-holder fallback: a
        # member that still misses this object (recovery in flight, or
        # its shard collection moved in a split/re-placement) is
        # swapped for an acting member that actually HOLDS the shard
        # collection; a later -ENOENT sub-read reply retries the
        # remaining alternates (handle_sub_read_reply)
        alts: dict[int, list[int]] = {}
        demoted: dict[int, int] = {}
        for s, o in list(avail.items()):
            alts[s] = [h for h in holders.get(s, []) if h != o]
            pm = pg.peer_missing.get(o)
            misses = (pm is not None and oid in pm) or \
                (o == daemon.whoami and oid in pg.missing)
            if misses:
                if alts[s]:
                    avail[s] = alts[s].pop(0)
                else:
                    # believed-missing with no alternate holder: a
                    # LAST-RESORT probe target, not a hard exclusion —
                    # the missing belief can be stale (a peer-reported
                    # set from before its recovery completed), and a
                    # probe that truly ENOENTs is handled by the
                    # extension path; dropping it outright can leave
                    # fewer than k chunks and wedge recovery
                    demoted[s] = avail.pop(s)
        want = set(range(k)) if want is None else set(want)
        try:
            need = self.engine.minimum_to_decode(want, set(avail))
        except Exception:
            if demoted:
                avail.update(demoted)
                try:
                    need = self.engine.minimum_to_decode(
                        want, set(avail))
                except Exception:
                    need = None
            else:
                need = None
        if need is None:
            if on_fail is not None:
                on_fail()
            if msg is not None:
                if on_chunks is None and oid is not None and \
                        pg.is_degraded_object(oid):
                    # too few consistent shards ONLY because recovery
                    # is still restoring some member's copy: queue the
                    # op until the object recovers instead of failing
                    # it (reference waiting_for_degraded_object)
                    pg.wait_for_object(oid, lambda: pg.do_op(msg))
                    return
                pg._reply(msg, -5, "not enough shards to read")  # EIO
            return
        self._read_tid += 1
        tid = self._read_tid
        st = {"msg": msg, "need": set(need), "chunks": {},
              "want": want, "on_chunks": on_chunks, "oid": oid,
              "on_fail": on_fail, "alts": alts}
        self._reads[tid] = st
        for s in need:
            if not self._issue_shard_read(tid, s, avail[s]):
                return
        self._maybe_finish_read(tid)

    def _issue_shard_read(self, tid: int, s: int, o: int) -> bool:
        """Fetch shard s of st's object from osd o (local or remote).
        → False when the read aborted (state already cleaned up)."""
        pg, daemon = self.pg, self.pg.daemon
        st = self._reads.get(tid)
        if st is None:
            return False
        oid = st["oid"]
        if o != daemon.whoami:
            daemon.send_to_osd(o, M.MOSDECSubOpRead(
                tid=tid, pgid=str(pg.pgid), shard=s,
                epoch=daemon.osdmap.epoch, oid=oid, attrs=True))
            return True
        cid = pg.cid_for_shard(s)
        try:
            chunk = daemon.store.read(cid, oid)
        except KeyError:
            nxt = st["alts"].get(s)
            if nxt:
                return self._issue_shard_read(tid, s, nxt.pop(0))
            if self._shard_unfetchable(tid, s):
                return True     # read continues on other shards
            del self._reads[tid]
            if st.get("on_fail") is not None:
                st["on_fail"]()
            if st["msg"] is not None:
                pg._reply(st["msg"], -2, "no such object")
            return False
        st["chunks"][s] = chunk
        try:
            meta = json.loads(bytes(daemon.store.getattr(cid, oid,
                                                         "_")))
            # the mixed-version guard must see LOCAL chunks too — a
            # stale local shard collection is exactly as dangerous as
            # a remote one
            st.setdefault("metas", {})[s] = meta
        except KeyError:
            pass
        return True

    def handle_sub_read(self, msg: M.MOSDECSubOpRead):
        pg, daemon = self.pg, self.pg.daemon
        cid = pg.cid_for_shard(msg.shard)
        try:
            data = daemon.store.read(cid, msg.oid)
            meta = daemon.store.getattr(cid, msg.oid, "_")
            rc = 0
        except KeyError:
            data, meta, rc = b"", b"{}", -2
        daemon.send_to_osd(pg.primary, M.MOSDECSubOpReadReply(
            tid=msg.tid, pgid=msg.pgid, shard=msg.shard,
            epoch=daemon.osdmap.epoch, rc=rc, data=data.hex(),
            attrs={"_": meta.hex()}, from_osd=daemon.whoami))

    _MIXED_RETRIES = 8
    _MIXED_RETRY_DELAY = 0.25

    def _retry_read_later(self, msg: M.MOSDOp) -> bool:
        """Requeue a client read whose shard set is transiently
        inconsistent (stray holders mid-re-placement).  Bounded: after
        _MIXED_RETRIES the caller fails the op for real."""
        tries = getattr(msg, "_mixed_retries", 0)
        if tries >= self._MIXED_RETRIES:
            return False
        msg._mixed_retries = tries + 1
        pg = self.pg
        pg.daemon.timer.add_event_after(
            self._MIXED_RETRY_DELAY,
            lambda: pg.daemon.op_queue.enqueue("client", msg))
        return True

    def handle_sub_read_reply(self, msg: M.MOSDECSubOpReadReply):
        st = self._reads.get(msg.tid)
        if st is None:
            return
        if msg.rc != 0:
            # the assigned member may simply not hold this object's
            # chunk yet (split / re-placement): try the remaining
            # holders of the shard collection before failing
            nxt = (st.get("alts") or {}).get(msg.shard)
            if msg.rc == -2 and nxt:
                self._issue_shard_read(msg.tid, msg.shard, nxt.pop(0))
                self._maybe_finish_read(msg.tid)
                return
            if msg.rc == -2 and self._shard_unfetchable(msg.tid,
                                                        msg.shard):
                return          # read continues on other shards
            del self._reads[msg.tid]
            if st.get("on_fail") is not None:
                st["on_fail"]()
            if st["msg"] is not None:
                self.pg._reply(st["msg"], msg.rc, "shard read failed")
            return
        chunk = bytes.fromhex(msg.data)
        # verify the per-chunk checksum before trusting it (reference
        # HashInfo crc verification on sub-read)
        meta = json.loads(bytes.fromhex(msg.attrs["_"]))
        hinfo = meta.get("hinfo")
        if hinfo is not None and crc32c(chunk) != hinfo:
            del self._reads[msg.tid]
            if st.get("on_fail") is not None:
                st["on_fail"]()
            if st["msg"] is not None:
                self.pg._reply(st["msg"], -5, "chunk crc mismatch")
            return
        st["chunks"][msg.shard] = chunk
        st.setdefault("metas", {})[msg.shard] = meta
        self._maybe_finish_read(msg.tid)

    def _shard_unfetchable(self, tid: int, s: int) -> bool:
        """Shard s ENOENTed with no alternates: drop it from the read
        set and extend to other shards if decode stays feasible.
        → True when the read survives (caller must not tear down)."""
        st = self._reads.get(tid)
        if st is None:
            return True
        st["need"].discard(s)
        st.setdefault("attempted", set()).add(s)
        try:
            feasible_now = set(self.engine.minimum_to_decode(
                st["want"], set(st["need"]))) <= set(st["need"])
        except Exception:
            feasible_now = False
        if feasible_now:
            self._maybe_finish_read(tid)
            return True
        return self._extend_read(tid)

    def _extend_read(self, tid: int):
        """Grow a read's shard set with untried members (preferring
        ones believed to hold the object; believed-missing members are
        last-resort probes — the belief can be stale).  → False when no
        extension is possible (state intact, caller fails the read);
        True when handled — extended, completed, or torn down."""
        st = self._reads.get(tid)
        if st is None:
            return True     # state already gone: nothing more to do
        attempted = st.setdefault("attempted", set(st["need"]))
        avail = self._available_shards()
        oid = st.get("oid")
        pg = self.pg
        preferred, fallback = [], []
        for s, o in avail.items():
            if s in st["chunks"] or s in attempted:
                continue
            misses = (o == pg.daemon.whoami
                      and oid in pg.missing) or \
                (oid in (pg.peer_missing.get(o) or ()))
            (fallback if misses else preferred).append(s)
        extra = preferred or fallback
        if not extra:
            return False            # no extension possible; state intact
        for s in extra:
            attempted.add(s)
            st["need"].add(s)
            if not self._issue_shard_read(tid, s, avail[s]):
                return True         # read state torn down
        if set(st["chunks"]) >= st["need"]:
            self._maybe_finish_read(tid)
        return True                 # handled (completed or awaiting)

    def _maybe_finish_read(self, tid: int):
        st = self._reads.get(tid)
        if st is None or set(st["chunks"]) < st["need"]:
            return
        # a stale stray shard collection (pre-re-placement leftover)
        # must never be decoded against fresh chunks; but mixed
        # versions are NORMAL under thrash — a shard that was down
        # during the write still holds the old object until recovery
        # pushes it.  Decode from the shards at the NEWEST version
        # when they still satisfy the code (reference ECBackend
        # get_min_avail_to_read_shards consults the missing set to
        # the same effect); fail only when they cannot.
        metas = st.get("metas") or {}
        vers_map = {s: tuple(m.get("version", ZERO))
                    for s, m in metas.items()}
        vers = set(vers_map.values())
        if len(vers) > 1:
            # choose the NEWEST version the gathered chunks can
            # actually decode.  An un-acked interrupted write can
            # leave a newer version on a MINORITY of shards (fewer
            # than k) — that version was never acknowledged, so
            # falling back to the previous feasible one IS the
            # correct outcome (the reference reaches the same result
            # via per-entry rollback of uncommitted EC log entries).
            # never fall below the version the PRIMARY's log carries:
            # with primary-applies-last, a logged version IS an acked
            # version, and serving anything older would be silent
            # rollback of an acknowledged write
            oid = st.get("oid")
            committed = ZERO
            if oid is not None:
                for e in reversed(self.pg.log.entries):
                    if e.oid == oid:
                        committed = e.version
                        break
            fresh = None
            for cand in sorted(vers, reverse=True):
                if cand < committed:
                    break
                cset = {s: c for s, c in st["chunks"].items()
                        if vers_map.get(s) == cand}
                try:
                    need = self.engine.minimum_to_decode(
                        st["want"], set(cset))
                    if set(need) <= set(cset):
                        fresh = cset
                        newest = cand
                        break
                except Exception:
                    continue
            if fresh is None:
                # no gathered version decodes: EXTEND the read to
                # shards not yet tried before giving up (reference:
                # ECBackend re-issues to remaining shards on errors)
                if self._extend_read(tid):
                    return
                del self._reads[tid]
                if st.get("on_fail") is not None:
                    st["on_fail"]()
                msg = st["msg"]
                if msg is not None:
                    oid = st.get("oid")
                    if st.get("on_chunks") is None and oid and \
                            self.pg.is_degraded_object(oid):
                        # stale shards will be overwritten by the
                        # in-flight recovery: retry after it lands
                        self.pg.wait_for_object(
                            oid, lambda: self.pg.do_op(msg))
                        return
                    if st.get("on_chunks") is None and \
                            self._retry_read_later(msg):
                        # a stale STRAY holder answered (its copy
                        # predates a re-placement) and not enough
                        # acting shards agree yet — recovery isn't
                        # tracking strays, so back off briefly and
                        # re-target; fail only when it persists
                        return
                    self.pg._reply(msg, -5,
                                   "mixed-version shard chunks")
                return
            st["chunks"] = fresh
            metas = {s: m for s, m in metas.items()
                     if vers_map.get(s) == newest}
        st["meta"] = next(iter(metas.values()), {})
        del self._reads[tid]
        chunks = {s: np.frombuffer(c, dtype=np.uint8)
                  for s, c in st["chunks"].items()}
        self._submit_decode(st, chunks)

    def _submit_decode(self, st: dict, chunks: dict):
        """The decode half of a gathered read, split submit/completion
        through the batch engine's reconstruct lane (mirroring the
        write path's ``_finish_apply`` split): degraded client reads,
        ``recover_primary_object`` reconstructs, and backfill/repair
        pushes — from every PG on this OSD — coalesce into fused
        per-(code, erasure-pattern, size-bucket) megabatch launches.
        With the lane disabled or ``recon_flush_ms=0`` the completion
        fires synchronously before submit returns, preserving the old
        one-decode-at-a-time semantics exactly."""
        pg = self.pg
        daemon = pg.daemon
        epoch = pg.interval_epoch
        span = daemon.tracer.start_span(
            "gf_decode", tags={
                "layer": "device", "kernel": "gf_decode",
                "pgid": str(pg.pgid), "shards": len(chunks),
                "want": len(st["want"])})

        def _decoded(comp):
            with daemon.lock:
                if span is not None:
                    if comp.info:
                        span.set_tag("batch_rows",
                                     comp.info.get("rows"))
                        span.set_tag("batch_members",
                                     comp.info.get("members"))
                    span.finish()
                if pg.interval_epoch != epoch:
                    # the interval changed while the decode was in
                    # flight: on_change already reset the read/pull
                    # world this completion would touch — drop it
                    # (clients resend, recovery re-peers)
                    if st.get("on_fail") is not None:
                        st["on_fail"]()
                    return
                if comp.error is not None:
                    if st.get("on_fail") is not None:
                        st["on_fail"]()
                    if st["msg"] is not None and \
                            st.get("on_chunks") is None:
                        pg._reply(st["msg"], -5,
                                  f"decode failed: {comp.error!r}")
                    return
                self._finish_decoded(st, comp.value)

        with daemon.profiler.bind():
            daemon.batch_engine.submit_reconstruct(
                self.engine, chunks, want=st["want"], span=span,
                callback=_decoded)

    def _finish_decoded(self, st: dict, decoded: dict):
        """Completion half: assemble the client reply (or hand the
        decoded chunks to the recovery continuation).  Runs under the
        daemon lock either way — inline for immediate mode, on the
        engine's FIFO completion worker for batched mode."""
        if st["on_chunks"] is not None:
            st["on_chunks"](decoded, st.get("meta") or {})
            return
        meta = st.get("meta") or {}
        size = int(meta.get("size", 0))
        stored = (int(meta.get("stored", size))
                  if "comp" in meta else size)
        raw = np.concatenate(
            [decoded[i] for i in sorted(st["want"])]).tobytes()[:stored]
        payload = self.pg.unseal_payload(raw, meta)
        results = []
        msg = st["msg"]
        for op in msg.ops:
            kind = op.get("op")
            if kind == "read":
                off = int(op.get("off", 0))
                ln = op.get("len")
                end = len(payload) if ln is None else off + int(ln)
                results.append({"data": payload[off:end].hex()})
            elif kind == "stat":
                results.append({"size": size,
                                "version": tuple(meta["version"])})
            else:
                # non-data ops re-run locally for the final answer
                results.append({})
        self.pg._reply(msg, 0, "", results=results,
                       version=tuple(meta.get("version", ZERO)))

    # -- recovery ----------------------------------------------------------
    # seconds before a push that has not been answered may go out again.
    # The tick re-kicks recovery every heartbeat interval, and the
    # reconstruct and push of one shard can outlast many intervals on a
    # loaded host: without the record each tick started another read,
    # decode and push of every shard still on its way (ceph_tpu's
    # ECBackend keeps none; the port's departure, ROADMAP section 3)
    PUSH_RETRY_S = 30.0

    def push_object(self, peer: int, oid: str, version: tuple):
        """Reconstruct the peer's shard chunk from k survivors and push
        it (reference ECBackend recovery — the §4.3 reconstruct).  One
        push of ``oid`` to ``peer`` at a time: a second call returns
        until the first is answered (``push_answered``), its read
        fails, the interval changes or ``PUSH_RETRY_S`` has passed."""
        pg = self.pg
        key = (peer, oid)
        now = time.monotonic()
        if now - self._pushes.get(key, now - self.PUSH_RETRY_S) \
                < self.PUSH_RETRY_S:
            return
        shard = pg.acting.index(peer)
        self._pushes[key] = now
        fake = M.MOSDOp(tid=0, client="recovery", pgid=str(pg.pgid),
                        oid=oid, epoch=pg.daemon.osdmap.epoch,
                        ops=[], flags=0)
        fake.connection = None

        def on_chunks(decoded, meta):
            chunk = decoded[shard].tobytes()
            pg.daemon.send_to_osd(peer, M.MOSDPGPush(
                pgid=str(pg.pgid), epoch=pg.daemon.osdmap.epoch,
                oid=oid, data=chunk.hex(),
                attrs={"_": _obj_meta(
                    tuple(meta.get("version", version)),
                    int(meta.get("size", 0)),
                    hinfo=crc32c(chunk),
                    extra=_meta_extra(meta)).hex()},
                omap={}, version=list(version),
                from_osd=pg.daemon.whoami, pull_tid=None))

        self._start_data_read(fake, want={shard}, on_chunks=on_chunks,
                              exclude={shard},
                              on_fail=lambda: self._pushes.pop(key, None))

    def push_answered(self, peer: int, oid: str):
        self._pushes.pop((peer, oid), None)

    def recover_primary_object(self, oid: str, version: tuple):
        pg = self.pg
        pull_tid = self._alloc_pull(oid)
        if pull_tid is None:
            return
        shard = pg.shard
        fake = M.MOSDOp(tid=0, client="recovery", pgid=str(pg.pgid),
                        oid=oid, epoch=pg.daemon.osdmap.epoch,
                        ops=[], flags=0)
        fake.connection = None

        def on_chunks(decoded, meta):
            chunk = decoded[shard].tobytes()
            t = Transaction()
            cid = pg.cid
            if not pg.daemon.store.collection_exists(cid):
                t.create_collection(cid)
            t.truncate(cid, oid, 0)
            t.write(cid, oid, 0, chunk)
            t.setattrs(cid, oid, {"_": _obj_meta(
                tuple(meta.get("version", version)),
                int(meta.get("size", 0)), hinfo=crc32c(chunk),
                extra=_meta_extra(meta))})
            pg.daemon.store.queue_transaction(t)
            pg._pulls.pop(pull_tid, None)
            pg.missing.pop(oid, None)
            pg._object_recovered(oid)
            pg._maybe_clean()

        self._start_data_read(fake, want={shard}, on_chunks=on_chunks,
                              exclude={shard},
                              on_fail=lambda: pg._pulls.pop(pull_tid,
                                                            None))

    # -- scrub -------------------------------------------------------------
    def build_scrub_map(self, deep: bool = True) -> dict:
        """oid → {size, crc, version, valid}: each EC shard verifies
        its own chunk against the stored hinfo crc (reference deep
        scrub on EC shards).  Deep maps digest chunks through the
        batched CRC-32C kernel and carry the chunk payload ("data",
        hex) so the primary can re-run the erasure code across shards
        — the parity recheck that catches bit-rot whose hinfo was
        rewritten consistently.  Shallow maps are presence/size only
        (no data read, no self-check)."""
        pg = self.pg
        store, cid = pg.daemon.store, pg.cid
        out = {}
        chunks: dict[str, bytes] = {}
        metas: dict[str, dict] = {}
        for oid in pg._list_objects():
            try:
                meta = json.loads(bytes(store.getattr(cid, oid, "_")))
                if deep:
                    chunks[oid] = bytes(store.read(cid, oid))
                metas[oid] = meta
            except KeyError:
                continue
            out[oid] = {"size": int(meta.get("size", 0)),
                        "version": meta.get("version", list(ZERO)),
                        "valid": True}
        if deep:
            eng = pg.daemon.scrub_engine
            span = pg.daemon.tracer.start_span(
                "crc_digest", tags={
                    "layer": "device", "kernel": "crc32c",
                    "pgid": str(pg.pgid), "objects": len(chunks),
                    "bytes": sum(len(b) for b in chunks.values())})
            if span is not None:
                span.add_link(getattr(pg, "_scrub_trace", None))
            with pg.daemon.profiler.bind():
                digests = eng.compute_digests(chunks)
            for oid, digest in digests.items():
                hinfo = metas[oid].get("hinfo")
                out[oid].update(
                    crc=digest, data=chunks[oid].hex(),
                    valid=hinfo is None or digest == hinfo)
            if span is not None:
                span.finish()
            perf = pg.daemon.perf
            perf.inc("scrub_objects_scanned", len(chunks))
            perf.inc("scrub_digest_bytes",
                     sum(len(b) for b in chunks.values()))
        return out

    def scrub_compare(self, maps: dict[int, dict],
                      deep: bool = True) -> int:
        """A shard whose self-check failed (or that is missing an
        object other members have) gets its chunk reconstructed from
        the k survivors — the §4.3 path as repair.

        Deep scrubs additionally re-encode each fully-present stripe
        through the GF(2^8) matmul engine and compare recomputed
        parity against the stored parity shards; an inconsistent
        stripe whose shards all pass their own hinfo self-check is
        attributed by erasure hypothesis testing — singles first,
        then pairs when the code has parity to spare
        (``scrub.engine.isolate_culprits``) — and repaired through
        the same reconstruct path."""
        pg = self.pg
        me = pg.daemon.whoami
        oids = set()
        for m in maps.values():
            oids.update(m)
        errors = 0
        report = []
        shard_of = {osd: i for i, osd in enumerate(pg.acting)
                    if osd != CRUSH_ITEM_NONE}
        versions: dict[str, tuple] = {}
        suspect: set[str] = set()
        for oid in sorted(oids):
            ver = tuple(next(m[oid] for m in maps.values()
                             if oid in m)["version"])
            versions[oid] = ver
            shard_report: dict[tuple, dict] = {}
            obj_errors: set[str] = set()
            for osd, m in maps.items():
                e = m.get(oid)
                if e is not None and e["valid"]:
                    continue
                errors += 1
                suspect.add(oid)
                kind = "missing" if e is None else "data_digest_mismatch"
                obj_errors.add(kind)
                shard_report[osd, shard_of.get(osd, -1)] = {
                    "errors": [kind],
                    **({} if e is None else
                       {"size": e["size"], "digest": e.get("crc")})}
                if osd == me:
                    pg.missing[oid] = ver
                else:
                    pg.peer_missing.setdefault(osd, {})[oid] = ver
            if shard_report:
                report.append(scrub_engine.inconsistent_entry(
                    oid, sorted(obj_errors), shard_report))
        if deep:
            errors += self._parity_recheck(
                maps, oids - suspect, shard_of, versions, report)
        if report:
            pg.inconsistent_objects = report
        return errors

    def _parity_recheck(self, maps: dict[int, dict], oids: set,
                        shard_of: dict[int, int],
                        versions: dict[str, tuple],
                        report: list) -> int:
        """Re-encode fully-present self-consistent stripes; attribute
        and queue repair for any whose stored parity diverges."""
        pg = self.pg
        me = pg.daemon.whoami
        ec = self.engine
        n = ec.k + ec.m
        stripes: dict[str, dict[int, bytes]] = {}
        for oid in oids:
            chunks: dict[int, bytes] = {}
            for osd, m in maps.items():
                e = m.get(oid)
                if e is None or "data" not in e or osd not in shard_of:
                    continue
                chunks[shard_of[osd]] = bytes.fromhex(e["data"])
            if (len(chunks) == n
                    and len({len(c) for c in chunks.values()}) == 1):
                stripes[oid] = chunks
        if not stripes:
            return 0
        eng = pg.daemon.scrub_engine
        before = eng.parity_bytes
        span = pg.daemon.tracer.start_span(
            "parity_recheck", tags={
                "layer": "device", "kernel": "gf_encode",
                "pgid": str(pg.pgid), "stripes": len(stripes)})
        if span is not None:
            span.add_link(getattr(pg, "_scrub_trace", None))
        with pg.daemon.profiler.bind():
            verdicts = eng.recheck_parity(
                ec, stripes,
                batch=getattr(pg.daemon, "batch_engine", None))
        if span is not None:
            span.set_tag("bytes", eng.parity_bytes - before)
            span.finish()
        pg.daemon.perf.inc("scrub_parity_recheck_bytes",
                           eng.parity_bytes - before)
        errors = 0
        for oid, inconsistent in sorted(verdicts.items()):
            if not inconsistent:
                continue
            errors += 1
            culprits = scrub_engine.isolate_culprits(ec, stripes[oid])
            osd_by_shard = {s: o for o, s in shard_of.items()}
            shard_report: dict[tuple, dict] = {}
            kinds = ["parity_mismatch"]
            if not culprits:
                # detected but unattributable (m=1 has no
                # discriminating redundancy; ambiguous multi-shard
                # evidence must not pick scapegoats): report only
                for osd, s in shard_of.items():
                    shard_report[osd, s] = {
                        "errors": ["parity_mismatch"]}
            else:
                ver = versions[oid]
                for culprit in culprits:
                    osd = osd_by_shard[culprit]
                    shard_report[osd, culprit] = {
                        "errors": ["parity_mismatch"]}
                    if osd == me:
                        pg.missing[oid] = ver
                    else:
                        pg.peer_missing.setdefault(osd, {})[oid] = ver
            report.append(scrub_engine.inconsistent_entry(
                oid, kinds, shard_report))
        return errors

    def answer_pull(self, msg: M.MOSDPGPull):
        # EC primaries reconstruct rather than pull whole objects
        pass

    def apply_push(self, msg: M.MOSDPGPush):
        pg = self.pg
        cid = pg.cid
        if _push_is_stale(pg.daemon.store, cid, msg):
            pg.missing.pop(msg.oid, None)   # bytes already present:
            return                          # not missing (see above)
        t = Transaction()
        if not pg.daemon.store.collection_exists(cid):
            t.create_collection(cid)
        t.remove(cid, msg.oid)
        t.write(cid, msg.oid, 0, bytes.fromhex(msg.data))
        if msg.attrs:
            t.setattrs(cid, msg.oid,
                       {k: bytes.fromhex(v) for k, v in msg.attrs.items()})
        pg.missing.pop(msg.oid, None)
        pg._note_local_object_write()
        pg._persist_meta(t)
        pg.daemon.store.queue_transaction(t)
