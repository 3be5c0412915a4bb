"""WALStore — a durable ObjectStore: MemStore + write-ahead log.

The port's copy of ``ceph_tpu.os_store.kvstore``.

Stands in for the reference's persistent store tier
(``src/os/bluestore/BlueStore.cc`` commits every mutation through the
RocksDB WAL; SURVEY.md §6.4).  Every queued Transaction is one
CRC-framed WAL record (``walog.py``) appended before the in-memory
apply; ``mount()`` replays the log with the RocksDB torn-tail rule
shared with ``MonitorDBStore`` (stop at the last parseable record,
truncate the damage).  This gives the OSD crash-restart durability
without re-creating BlueStore's block-device allocator — machinery
whose job (feeding NVMe) has no analog when chunk payloads are
encoded and digested on the card.

The commit contract is the reference's (``ObjectStore::
queue_transaction``): ``on_commit`` fires only once the record is
durable per the sync mode —

- ``"none"``   — never fsync; callbacks fire after the in-memory
  apply.  Fast, and power loss eats the whole unsynced tail.
- ``"batch"``  — group commit (default): a dedicated commit thread
  drains the pending-callback queue and pays ONE fsync for the whole
  burst before firing any of its callbacks, so a megabatch flush
  costs one durability barrier, not one per op.
- ``"always"`` — fsync inline before the apply, one per transaction.

Failure is a state, not a crash: the first failed append/fsync
(ENOSPC, injected power loss) marks the store dead, every later write
raises ``StoreError``, and ``on_error`` tells the daemon to degrade.
An attached ``CrashInjector`` turns named points in this pipeline into
deterministic power cuts — see ``crash.py`` for the menu.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Callable

from . import walog
from .crash import CrashInjector, SimulatedPowerLoss
from .memstore import MemStore
from .objectstore import StoreError, Transaction

SYNC_MODES = ("none", "batch", "always")


class WALStore(MemStore):
    def __init__(self, path: str, *, sync_mode: str | None = None,
                 sync: bool | None = None, name: str = "walstore",
                 crash: CrashInjector | None = None,
                 compact_min_records: int = 0):
        super().__init__(name=name)
        self._path = path
        self._dirty_path = path + ".dirty"
        if sync_mode is None:
            # legacy bool knob: sync=True was fsync-per-txn, sync=False
            # was never-fsync; unspecified gets the group-commit default
            sync_mode = ("always" if sync else "none") \
                if sync is not None else "batch"
        if sync_mode not in SYNC_MODES:
            raise ValueError(
                f"sync_mode {sync_mode!r} not in {SYNC_MODES}")
        self._sync_mode = sync_mode
        self.crash = crash
        self.compact_min_records = int(compact_min_records)
        # optional black box (core.flight_recorder.FlightRecorder):
        # crash points announce themselves to it before the verdict
        self.flight_recorder = None
        self.on_error: Callable | None = None
        self.replay_stats: dict | None = None
        self.wal_stats = collections.Counter()
        self._wal = None
        self._append_off = 0     # bytes written (page cache included)
        self._synced_off = 0     # bytes known durable (last fsync)
        self._records = 0
        self._mounted = False
        self._failed: StoreError | None = None
        self._error_notified = False
        self._compacting = False
        # group-commit machinery (runs only in "batch" mode)
        self._commit_cv = threading.Condition()
        self._commit_pending: list[Callable | None] = []
        self._commit_stop = False
        self._commit_kicked = False
        self._commit_inflight = 0
        self._commit_thread: threading.Thread | None = None
        # optional grace window: how long a queued commit may wait for
        # companions before the thread fsyncs anyway.  0 = sync as soon
        # as anything is pending; bursts still share fsyncs because
        # appends keep landing while the previous fsync runs (the
        # barrier is outside the store lock), so batches form naturally
        # at fsync granularity without taxing serial writers.
        self.commit_latency_s = 0.0

    # -- lifecycle ---------------------------------------------------------
    @property
    def sync_mode(self) -> str:
        return self._sync_mode

    def set_sync_mode(self, mode: str) -> None:
        if mode not in SYNC_MODES:
            raise ValueError(f"sync_mode {mode!r} not in {SYNC_MODES}")
        old, self._sync_mode = self._sync_mode, mode
        if old == "batch" and mode != "batch":
            self._stop_commit_thread(drain=True)
        elif mode == "batch" and self._wal is not None:
            self._start_commit_thread()

    def mkfs(self):
        with self.lock:
            super().mkfs()
            if self._wal is not None:
                try:
                    self._wal.close()
                except OSError:
                    pass
                self._wal = None
            # atomic re-init: build the empty log aside and rename it
            # over the old one, so a crash can never leave the path
            # with no log at all (the old unlink+recreate window)
            tmp = self._path + ".mkfs.tmp"
            with open(tmp, "wb") as f:
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path)
            walog.fsync_dir(self._path)
            self._records = 0
            self._failed = None
            self._error_notified = False
            self._open_wal()

    def mount(self):
        with self.lock:
            if self._mounted:
                return
            # a crash mid-compaction leaves the checkpoint temp behind;
            # the rename never happened, so the old WAL is authoritative
            self._unlink(self._path + ".compact.tmp")
            self._unlink(self._path + ".mkfs.tmp")
            was_dirty = os.path.exists(self._dirty_path)
            payloads, good_off, tail = walog.scan_path(self._path)
            for payload in payloads:
                txn = Transaction.from_dict(json.loads(payload.decode()))
                for op in txn.ops:
                    self._apply_op(op)
            self._records = len(payloads)
            if tail["status"] != "clean":
                # neutralize the torn/corrupt tail NOW: appending fresh
                # records after garbage would hide them from the next
                # replay forever
                walog.truncate_tail(self._path, good_off)
            self.replay_stats = {
                "records": len(payloads),
                "clean_shutdown": not was_dirty,
                "tail": dict(tail),
            }
            # dirty marker lives for the whole mount; only a clean
            # umount removes it, so its survival at the next mount is
            # the unclean-shutdown signal
            with open(self._dirty_path, "wb") as f:
                f.write(b"mounted\n")
                f.flush()
                os.fsync(f.fileno())
            walog.fsync_dir(self._dirty_path)
            self._open_wal()
            self._mounted = True
            if self._sync_mode == "batch":
                self._start_commit_thread()

    def umount(self):
        self._stop_commit_thread(drain=True)
        with self.lock:
            if self._wal is not None:
                if self._failed is None:
                    try:
                        self._wal.flush()
                        os.fsync(self._wal.fileno())
                        self._synced_off = self._append_off
                    except OSError:
                        pass
                try:
                    self._wal.close()
                except OSError:
                    pass
                self._wal = None
            if self._failed is None:
                self._unlink(self._dirty_path)
                walog.fsync_dir(self._dirty_path)
            self._mounted = False
        super().umount()

    def power_loss(self):
        """True power-loss teardown (``vstart.crash_osd``): stable
        storage keeps only the fsynced prefix; page cache and the
        in-memory contents are gone; the dirty marker survives so the
        next mount knows the shutdown was unclean."""
        with self.lock:
            if self._failed is None:
                self._failed = SimulatedPowerLoss(
                    f"{self.name}: power loss")
            wal, self._wal = self._wal, None
            self._mounted = False
            try:
                with open(self._path, "r+b") as f:
                    f.truncate(self._synced_off)
                    f.flush()
                    os.fsync(f.fileno())
            except OSError:
                pass
        if wal is not None:
            try:
                wal.close()
            except OSError:
                pass
        self._stop_commit_thread(drain=False)
        with self.lock:
            self._drop_tracking()
        self.finisher.shutdown()

    def process_death(self):
        """``kill -9`` teardown (the threaded stand-in for true
        process death): the process dies with no chance to truncate,
        fsync, or unmark dirty — but unlike :meth:`power_loss` the OS
        survives, so the page cache keeps EVERY appended record (the
        write path flushes per append).  Stable storage is the full
        appended log; only in-memory state is lost.  The caller
        forgets this object and cold-remounts from the path."""
        with self.lock:
            if self._failed is None:
                self._failed = SimulatedPowerLoss(
                    f"{self.name}: process killed")
            wal, self._wal = self._wal, None
            self._mounted = False
        if wal is not None:
            try:
                wal.close()     # close flushes; nothing is truncated
            except OSError:
                pass
        self._stop_commit_thread(drain=False)
        with self.lock:
            self._drop_tracking()
        self.finisher.shutdown()

    @staticmethod
    def _unlink(path: str):
        try:
            os.unlink(path)
        except FileNotFoundError:
            return
        walog.fsync_dir(path)

    def _open_wal(self):
        if self._wal is None:
            self._wal = open(self._path, "ab")
            self._append_off = self._wal.tell()
            self._synced_off = self._append_off

    def _ensure_open(self):
        if self._wal is None:
            self._open_wal()
        if (self._sync_mode == "batch"
                and (self._commit_thread is None
                     or not self._commit_thread.is_alive())):
            self._start_commit_thread()

    # -- write path --------------------------------------------------------
    def queue_transaction(self, txn: Transaction,
                          on_commit: Callable | None = None) -> None:
        err: StoreError | None = None
        try:
            with self.lock:
                if self._failed is not None:
                    raise self._failed
                self._ensure_open()
                rec = walog.encode_record(
                    json.dumps(txn.to_dict(),
                               separators=(",", ":")).encode())
                self._crash_point("kill9")
                self._crash_point("pre_append")
                self._crash_point("mid_record", rec)
                self._wal.write(rec)
                self._wal.flush()
                self._append_off += len(rec)
                self._records += 1
                self.wal_stats["records"] += 1
                self.wal_stats["bytes"] += len(rec)
                fr = self.flight_recorder
                if fr is not None:
                    fr.note("txn", seq=self._records, b=len(rec))
                self._crash_point("post_append_pre_fsync")
                if self._sync_mode == "always":
                    os.fsync(self._wal.fileno())
                    self._synced_off = self._append_off
                    self.wal_stats["syncs"] += 1
                self._crash_point("post_fsync_pre_apply")
                for op in txn.ops:
                    self._apply_op(op)
        except StoreError as e:         # includes SimulatedPowerLoss
            err = e
        except OSError as e:
            err = StoreError(f"{self.name}: wal append failed: {e}")
            self._failed = err
        if err is not None:
            # notify outside the store lock: the daemon's handler takes
            # its own locks and must not nest under ours
            self._notify_error(err)
            raise err
        if self._sync_mode == "batch":
            # every txn gets a group-commit slot (callback or not) so
            # _synced_off tracks the log even for fire-and-forget
            # recovery writes; the thread still fsyncs once per drain
            self._commit_enqueue(on_commit)
        elif on_commit is not None:
            self.finisher.queue(on_commit)
        if (self.compact_min_records > 0 and not self._compacting
                and self._records >= self.compact_min_records):
            self.compact()

    def _crash_point(self, point: str, rec: bytes = b""):
        inj = self.crash
        if inj is None:
            return
        fr = self.flight_recorder
        if fr is not None and fr.enabled:
            # preview the pure verdict BEFORE consuming it: when this
            # occurrence will fire, the black box gets a flushed
            # crash-imminent event the post-mortem can match against
            # CrashInjector.preview().  Unconfigured points
            # short-circuit without touching the RNG, so the always-on
            # cost is one attribute check per crash point.
            try:
                if inj.preview(point, 1)[0]:
                    fr.event("crash_point", point=point,
                             n=inj.counters.get(point, 0))
            except Exception:   # noqa: BLE001 — never fail a write
                pass            # over black-box bookkeeping
        if not inj.decide(point):
            return
        if point == "kill9" and os.environ.get("CEPH_TPU_PROC_DAEMON"):
            # real process death: no truncation, no exception — the
            # page cache (every appended record, flushed per append)
            # survives; only unsynced-but-unappended state is lost
            import signal
            os.kill(os.getpid(), signal.SIGKILL)
            time.sleep(60)          # SIGKILL is not synchronous
        torn = b""
        if point == "mid_record" and rec:
            # the power cut lands partway through the kernel's write:
            # a header plus some — never all — of the payload survives
            torn = rec[:max(walog.HEADER_SIZE + 1, len(rec) // 2)]
            torn = torn[:len(rec) - 1]
        if point == "post_fsync_pre_apply":
            # the record reached stable storage; the cut is between
            # the fsync and the in-memory apply, so replay must
            # resurface it (durable-but-unacked, the one legal extra)
            try:
                self._wal.flush()
                os.fsync(self._wal.fileno())
                self._synced_off = self._append_off
            except OSError:
                pass
        self._die(point, torn)

    def _die(self, point: str, torn: bytes):
        """Simulated power cut: stable storage keeps ``[0,
        _synced_off)`` plus any torn fragment; everything else — page
        cache and this process's in-memory store — is lost (the caller
        abandons the object and cold-remounts from the path)."""
        try:
            if self._wal is not None:
                self._wal.flush()
        except OSError:
            pass
        try:
            with open(self._path, "r+b") as f:
                f.truncate(self._synced_off)
                if torn:
                    f.seek(self._synced_off)
                    f.write(torn)
                f.flush()
                os.fsync(f.fileno())
        except OSError:
            pass
        raise SimulatedPowerLoss(
            f"{self.name}: power loss at crash point {point!r}")

    def _notify_error(self, err: StoreError):
        self._failed = self._failed or err
        cb = self.on_error
        if cb is None or self._error_notified:
            return
        self._error_notified = True
        try:
            cb(err)
        except Exception:
            pass

    # -- group commit ------------------------------------------------------
    def _start_commit_thread(self):
        if self._commit_thread is not None and self._commit_thread.is_alive():
            return
        self._commit_stop = False
        self._commit_thread = threading.Thread(
            target=self._commit_loop, name=f"{self.name}-walsync",
            daemon=True)
        self._commit_thread.start()

    def _stop_commit_thread(self, drain: bool = True):
        t = self._commit_thread
        if t is None:
            return
        with self._commit_cv:
            self._commit_stop = True
            if not drain:
                self._commit_pending.clear()
            self._commit_cv.notify_all()
        if t is not threading.current_thread():
            t.join(timeout=5.0)
        self._commit_thread = None

    def _commit_enqueue(self, cb: Callable | None):
        with self._commit_cv:
            self._commit_pending.append(cb)
            if len(self._commit_pending) == 1:
                # only the first enqueue wakes the thread; companions
                # pile into its grace window so the burst shares one
                # fsync instead of cutting the window short each time
                self._commit_cv.notify()

    def kick(self):
        """Close the current group-commit window NOW — the batch
        engine calls this at each megabatch flush boundary so the
        whole flush's records share one fsync and their acks don't
        wait out the latency bound."""
        with self._commit_cv:
            self._commit_kicked = True
            self._commit_cv.notify()

    def _commit_loop(self):
        while True:
            with self._commit_cv:
                while not self._commit_pending and not self._commit_stop:
                    self._commit_kicked = False
                    self._commit_cv.wait()
                if not self._commit_pending:
                    return          # stopped and drained
                if (self.commit_latency_s > 0
                        and not (self._commit_stop or self._commit_kicked)):
                    # grace window: let the rest of the burst arrive
                    self._commit_cv.wait(timeout=self.commit_latency_s)
                self._commit_kicked = False
                batch, self._commit_pending = self._commit_pending, []
                self._commit_inflight = len(batch)
            err: StoreError | None = None
            # snapshot under the lock, fsync OUTSIDE it: the log is
            # append-only, so syncing up to a snapshotted offset is
            # correct while writers keep appending — the next batch's
            # records overlap this batch's durability barrier instead
            # of stalling behind it (writers flush per append, so the
            # page cache already holds everything through `off`)
            wal, off = None, 0
            with self.lock:
                if self._failed is not None:
                    err = self._failed
                elif self._wal is not None:
                    wal, off = self._wal, self._append_off
            if err is None and wal is not None:
                try:
                    os.fsync(wal.fileno())
                except OSError as e:
                    err = StoreError(
                        f"{self.name}: wal fsync failed: {e}")
                with self.lock:
                    if err is not None:
                        # a racing umount/power_loss swapped the file
                        # out from under the fsync: not a media error
                        if self._wal is not wal:
                            err = self._failed or StoreError(
                                f"{self.name}: store closed mid-sync")
                        else:
                            self._failed = err
                    elif self._wal is wal:
                        self._synced_off = max(self._synced_off, off)
                        self.wal_stats["group_syncs"] += 1
            if err is None:
                self.wal_stats["group_commits"] += len(batch)
                for cb in batch:
                    if cb is not None:
                        self.finisher.queue(cb)
            else:
                # the batch's writes never became durable: their acks
                # must not fire — drop the callbacks and degrade
                self._notify_error(err)
            with self._commit_cv:
                self._commit_inflight = 0

    def flush_commits(self, timeout: float = 5.0) -> bool:
        """Barrier: wait until every queued commit has fsynced and its
        callback has run (tests/bench; the daemon drains via umount)."""
        deadline = time.monotonic() + timeout
        self.kick()
        while time.monotonic() < deadline:
            with self._commit_cv:
                # in-flight covers the gap where the thread has taken
                # a batch off the queue but not yet handed its
                # callbacks to the finisher
                if (not self._commit_pending
                        and not getattr(self, "_commit_inflight", 0)):
                    break
            time.sleep(0.001)
        return self.finisher.wait_for_empty(
            max(0.0, deadline - time.monotonic()))

    # -- checkpoint compaction --------------------------------------------
    def compact(self) -> dict:
        """Checkpoint compaction: snapshot the live state as fresh WAL
        records in a sidecar file, fsync it, then atomically rename it
        over the log.  Crash-safe by construction — before the rename
        the old log is authoritative (mount unlinks the stale temp);
        after it, the snapshot is the log."""
        err: StoreError | None = None
        try:
            with self.lock:
                if self._failed is not None:
                    raise self._failed
                self._ensure_open()
                self._compacting = True
                before = {"records": self._records,
                          "bytes": self._append_off}
                tmp = self._path + ".compact.tmp"
                n = 0
                with open(tmp, "wb") as f:
                    for payload in self._snapshot_payloads():
                        f.write(walog.encode_record(payload))
                        n += 1
                    f.flush()
                    os.fsync(f.fileno())
                self._crash_point("mid_compaction")
                self._wal.close()
                self._wal = None
                os.replace(tmp, self._path)
                walog.fsync_dir(self._path)
                self._open_wal()
                self._records = n
                self.wal_stats["compactions"] += 1
                return {"records_before": before["records"],
                        "records_after": n,
                        "bytes_before": before["bytes"],
                        "bytes_after": self._append_off}
        except StoreError as e:
            err = e
        except OSError as e:
            err = StoreError(f"{self.name}: wal compaction failed: {e}")
            self._failed = err
        finally:
            self._compacting = False
        self._notify_error(err)
        raise err

    def _snapshot_payloads(self):
        """The live state as replayable records, one per collection.
        Raw writes only — the conditional dedup opcodes must NOT be
        re-run at replay (the index omap and chunk objects are
        snapshotted verbatim instead, preserving refcounts)."""
        for cid in sorted(self.colls):
            txn = Transaction().create_collection(cid)
            coll = self.colls[cid]
            for oid in sorted(coll.objects):
                o = coll.objects[oid]
                if o.data:
                    txn.write(cid, oid, 0, bytes(o.data))
                else:
                    txn.touch(cid, oid)
                if o.xattrs:
                    txn.setattrs(cid, oid, o.xattrs)
                if o.omap:
                    txn.omap_setkeys(cid, oid, o.omap)
            yield json.dumps(txn.to_dict(),
                             separators=(",", ":")).encode()
