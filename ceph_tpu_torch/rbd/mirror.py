"""rbd-mirror — journal-based asynchronous image replication.

The port's copy of ``ceph_tpu.rbd.mirror``.

Reference behavior re-created (``src/tools/rbd_mirror/``,
``src/librbd/journal/``; SURVEY.md §3.9 "rbd-mirror"): a daemon
running near the SECONDARY cluster discovers journaled primary images
in the remote (primary) pool, bootstraps a local non-primary copy, and
tails each image's journal — replaying write/discard/resize/snapshot
events in order onto the local image and reporting its commit position
back into the remote journal so the primary can trim.  Failover =
stop replaying + ``promote()`` the local image; the non-primary write
guard (``Image._require_writable``) enforces the single-writer
contract the reference enforces via exclusive-lock + mirror state.

Direction note: like the reference, replication is PULL — the daemon
holds a client to both clusters; the primary never pushes.
"""

from __future__ import annotations

import threading
import time

from .image import RBD, Image, ImageNotFound, _journal_oid


class MirrorDaemon:
    """Replays journaled images from a remote (primary) pool into a
    local pool (reference ``rbd_mirror::ImageReplayer``)."""

    def __init__(self, remote_ioctx, local_ioctx, *,
                 interval: float = 0.1):
        self.remote = remote_ioctx
        self.local = local_ioctx
        self.interval = interval
        self.rbd = RBD()
        self.positions: dict[str, int] = {}   # image → replayed seq
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.errors: list[str] = []

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "MirrorDaemon":
        self._thread = threading.Thread(target=self._run,
                                        name="rbd-mirror", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self.sync_once()
            except Exception as e:      # noqa: BLE001 — a cluster
                # hiccup must not kill the replayer; next tick retries
                self.errors.append(repr(e))

    # -- one replication pass ---------------------------------------------
    def sync_once(self) -> int:
        """Bootstrap + replicate every mirrored primary remote image
        (journal replay or snapshot-delta sync per image mode);
        returns the number of events/deltas applied."""
        applied = 0
        for name in self.rbd.list(self.remote):
            try:
                rimg = Image(self.remote, name, read_only=True)
            except ImageNotFound:
                continue
            if not rimg.is_primary():
                continue
            mode = rimg.mirror_mode()
            if mode == "snapshot":
                applied += self._sync_snapshot_image(name, rimg)
            elif mode == "journal":
                applied += self._replay_image(name, rimg)
        return applied

    def _resync_local(self, name: str):
        """Drop the local non-primary copy so the next pass
        re-bootstraps it in full (reference `rbd mirror image
        resync`)."""
        try:
            self.rbd.remove(self.local, name)
        except Exception as e:      # noqa: BLE001 — leave it for the
            self.errors.append(     # operator if removal also fails
                f"resync removal of {name!r} failed: {e!r}")
        self.positions.pop(name, None)

    # -- snapshot-mode sync (reference rbd_mirror snapshot replayer) ------
    def _sync_snapshot_image(self, name: str, rimg: Image) -> int:
        """Ship the delta between consecutive primary mirror
        snapshots: for each remote mirror snapshot the local copy
        lacks, export-diff from the previous mirror snapshot (the
        object-map fast-diff path skips untouched objects), import it
        locally (which stamps the matching snapshot), and acknowledge
        the sync point on the primary so it can prune."""
        msnaps = rimg.mirror_snapshots()
        if not msnaps:
            return 0
        try:
            limg = Image(self.local, name, read_only=True)
        except ImageNotFound:
            self.rbd.create(self.local, name, rimg._hdr["size"],
                            order=rimg._hdr["order"],
                            stripe_unit=rimg._hdr["stripe_unit"],
                            stripe_count=rimg._hdr["stripe_count"],
                            mirror_snapshot=True, primary=False)
            limg = Image(self.local, name, read_only=True)
        if limg.is_primary():
            self.errors.append(f"split-brain on image {name!r}")
            return 0
        # progress is ordered by mirror-snapshot NAME number (the
        # primary's stamp sequence, identical on both sides); local
        # snap ids diverge and older local stamps get pruned, so
        # neither can order the sync.  Everything <= the newest local
        # stamp is already applied — re-importing an older delta would
        # REGRESS the secondary's data.
        plen = len(Image.MIRROR_SNAP_PREFIX)
        local_nums = [int(nm[plen:])
                      for _, nm in limg.mirror_snapshots()]
        synced_upto = max(local_nums, default=-1)
        base = (f"{Image.MIRROR_SNAP_PREFIX}{synced_upto}"
                if synced_upto >= 0 else None)
        applied = 0
        for sid, sname in msnaps:
            if int(sname[plen:]) <= synced_upto:
                continue
            try:
                src = Image(self.remote, name, snapshot=sname,
                            read_only=True)
                try:
                    diff = src.export_diff(from_snap=base)
                finally:
                    src.close()
            except ImageNotFound as e:
                # re-read the primary's snap table: if our diff BASE
                # is truly gone there the chain cannot re-resolve on
                # its own — resync from scratch (the reference's
                # `rbd mirror image resync`: drop the local copy and
                # re-bootstrap); anything else is a transient race
                # with a concurrent stamp/prune — retry next pass
                base_gone = False
                if base is not None:
                    try:
                        with Image(self.remote, name,
                                   read_only=True) as fresh:
                            base_gone = base not in \
                                fresh._hdr["snaps"]
                    except ImageNotFound:
                        pass
                if base_gone:
                    self.errors.append(
                        f"mirror chain broken for {name!r} (base "
                        f"{base!r} removed on primary): resyncing")
                    self._resync_local(name)
                else:
                    self.errors.append(
                        f"snapshot chain moved on primary for "
                        f"{name!r}: {e}")
                return applied
            limg._replaying = True
            try:
                limg.import_diff(diff)   # stamps `sname` locally
            finally:
                limg._replaying = False
            rimg.mirror_snap_commit(sid)
            self.positions[name] = sid
            base = sname
            synced_upto = int(sname[plen:])
            applied += 1
        if applied and base is not None:
            # secondary-side prune: older local mirror snapshots (and
            # their COW clones) would otherwise accumulate one per
            # cadence tick forever; only the latest is ever needed as
            # the next import's from_snap base (the reference daemon
            # prunes non-primary mirror snapshots the same way)
            limg._replaying = True
            try:
                for _lsid, lname in limg.mirror_snapshots():
                    if lname != base:
                        limg.remove_snap(lname)
            finally:
                limg._replaying = False
        return applied

    def _bootstrap(self, name: str, rimg: Image) -> Image:
        """Ensure the local non-primary copy exists (reference
        bootstrap: full image SYNC — copy current bytes + snapshot
        table — then start replay from the journal position observed
        BEFORE the copy, so pre-sync history is never re-applied;
        events racing the copy replay harmlessly since the replay ops
        are idempotent)."""
        try:
            return Image(self.local, name, read_only=True)
        except ImageNotFound:
            pass
        # observe the journal head first: everything <= head is (or
        # will be) reflected in the bytes we copy below
        entries = rimg.journal_entries()
        head = entries[-1][0] if entries else 0
        self.rbd.create(self.local, name, rimg._hdr["size"],
                        order=rimg._hdr["order"],
                        stripe_unit=rimg._hdr["stripe_unit"],
                        stripe_count=rimg._hdr["stripe_count"],
                        journaling=True, primary=False)
        limg = Image(self.local, name, read_only=True)
        # snapshot table + sizes come with the sync (reference: the
        # bootstrap's snapshot sync)
        limg._hdr["snaps"] = dict(rimg._hdr["snaps"])
        limg._hdr["snap_seq"] = rimg._hdr["snap_seq"]
        limg._save_header()
        # full object copy: heads AND snap clones
        prefix = f"rbd_data.{name}."
        for o in self.remote.list_objects():
            if o.startswith(prefix):
                self.local.write_full(o, self.remote.read(o))
                try:
                    cl = self.remote.getxattr(o, "cloned_upto")
                    self.local.setxattr(o, "cloned_upto", bytes(cl))
                except Exception:
                    pass
        self.local.omap_set(_journal_oid(name), {
            "replayed": str(head).encode()})
        self.positions[name] = head
        return limg

    def _replay_image(self, name: str, rimg: Image) -> int:
        limg = self._bootstrap(name, rimg)
        if limg.is_primary():
            # split-brain: both sides primary (reference raises the
            # same health error and refuses to replay)
            self.errors.append(f"split-brain on image {name!r}")
            return 0
        pos = self.positions.get(name)
        if pos is None:
            # resume from the position persisted locally (daemon
            # restart must not re-apply (non-idempotent) snap events)
            try:
                rows = self.local.omap_get(_journal_oid(name))
                pos = int(rows.get("replayed", b"0"))
            except Exception:
                pos = 0
        applied = 0
        for seq, rec in rimg.journal_entries(after=pos):
            self._apply(limg, rec)
            pos = seq
            applied += 1
            # persist position per EVENT: a crash between events must
            # not re-apply the ones already replayed (reference:
            # journal commit position advanced per entry)
            self.positions[name] = pos
            self.local.omap_set(_journal_oid(name), {
                "replayed": str(pos).encode()})
        if applied:
            rimg.journal_commit(pos)      # lets the primary trim
        else:
            self.positions[name] = pos
        return applied

    def _apply(self, limg: Image, rec: dict):
        """Replay one event.  Each arm is IDEMPOTENT — bootstrap races
        and crash-replay overlap mean an event can be applied onto a
        state that already reflects it."""
        limg._replaying = True
        try:
            op = rec["op"]
            if op == "write":
                data = bytes.fromhex(rec["data"])
                end = rec["off"] + len(data)
                if end > limg._hdr["size"]:
                    # write preceded a shrink we'll replay later (or
                    # raced the bootstrap's size snapshot): grow now,
                    # the upcoming resize event restores the final size
                    limg._hdr["size"] = end
                    limg._save_header()
                limg.write(rec["off"], data)
            elif op == "discard":
                limg.discard(rec["off"], rec["len"])
            elif op == "resize":
                limg.resize(rec["size"])
            elif op == "snap_create":
                if rec["name"] not in limg._hdr["snaps"]:
                    # faithful replay: reproduce the source snapshot
                    # even if its name sits in a reserved namespace
                    limg.create_snap(rec["name"],
                                     _mirror_internal=True)
            elif op == "snap_remove":
                if rec["name"] in limg._hdr["snaps"]:
                    limg.remove_snap(rec["name"])
            else:
                self.errors.append(f"unknown journal op {op!r}")
        finally:
            limg._replaying = False


def promote(ioctx, name: str):
    """``rbd mirror image promote`` (failover to this cluster)."""
    Image(ioctx, name, read_only=True).promote()


def demote(ioctx, name: str):
    """``rbd mirror image demote``."""
    Image(ioctx, name, read_only=True).demote()
