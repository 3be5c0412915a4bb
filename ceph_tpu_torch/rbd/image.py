"""RBD image layer — block devices over librados.

The port's copy of ``ceph_tpu.rbd.image``.

Reference behavior re-created (``src/librbd/``: ``ImageCtx.cc``,
``io/ImageRequest.cc``, ``io/ObjectRequest.cc``; SURVEY.md §3.9):

- an image is a **header object** (``rbd_header.<name>``, omap:
  size/order/stripe params/snapshot table) plus **data objects**
  (``rbd_data.<name>.<objectno:016x>``), sparse — absent objects read
  as zeros;
- image I/O maps byte ranges through the Striper
  (`ceph_tpu_torch.osdc.striper`) and fans out per-object ops through the
  Objecter; RBD's default layout is stripe_count=1 so an object is a
  contiguous 2^order-byte slice;
- **snapshots**: create_snap stamps a new snap id in the header; data
  objects are copied-on-first-write afterwards (clone object
  ``<obj>@<snap_id>``), so reads at a snapshot see the image exactly
  as it was (the reference uses RADOS self-managed snaps + SnapContext
  in the OSD; here the COW happens at the image layer over plain
  RADOS objects — same observable semantics for image I/O).

Cited reference files per SURVEY.md §0 convention (paths, no line
numbers).
"""

from __future__ import annotations

import json

from ..osdc.striper import FileLayout, file_to_extents


class ImageNotFound(KeyError):
    pass


def _header_oid(name: str) -> str:
    return f"rbd_header.{name}"


def _data_oid(name: str, objectno: int) -> str:
    return f"rbd_data.{name}.{objectno:016x}"


def _journal_oid(name: str) -> str:
    return f"rbd_journal.{name}"


# -- encryption (reference src/librbd/crypto/: LUKS-style envelope) ----
# A random data-encryption key (DEK) is wrapped by a key-encryption
# key derived from the passphrase (PBKDF2-SHA256); the wrapped DEK
# lives in the header, so the passphrase can be verified (and in
# principle rotated) without re-encrypting data.  Data objects hold
# AES-256-GCM envelopes of the object's logical plaintext — partial
# writes read-modify-write the object (the reference's LUKS layer uses
# XTS sectors for in-place writes; whole-object GCM trades that for
# authenticated reads at slice scale).

def _derive_kek(passphrase: str, salt: bytes) -> bytes:
    import hashlib
    return hashlib.pbkdf2_hmac("sha256", passphrase.encode(), salt,
                               100_000, dklen=32)


def _seal(key: bytes, plaintext: bytes, aad: bytes = b"") -> bytes:
    # CryptoKey carries the AES-GCM-or-HMAC-stream dependency gate
    # (core/auth.py): same nonce+ct framing either way
    from ..core.auth import CryptoKey
    return CryptoKey(key).encrypt(plaintext, aad)


def _unseal(key: bytes, blob: bytes, aad: bytes = b"") -> bytes:
    from ..core.auth import CryptoKey
    return CryptoKey(key).decrypt(bytes(blob), aad)


def _is_data_suffix(rest: str) -> bool:
    """True iff `rest` is '<16-hex-objno>' or '<16-hex-objno>@<int>'
    (a snapshot clone) — the only shapes this image's data objects
    take.  Guards every prefix scan against sibling images whose name
    extends ours ("foo" vs "foo.123")."""
    base, _, clone = rest.partition("@")
    if len(base) != 16 or any(c not in "0123456789abcdef"
                              for c in base):
        return False
    return clone == "" or clone.isdigit()


def _objmap_oid(name: str, snap_id: int | None = None) -> str:
    """Object-map object (reference src/librbd/object_map/): the head
    map plus one frozen copy per snapshot."""
    base = f"rbd_object_map.{name}"
    return base if snap_id is None else f"{base}.{snap_id}"


# object-map states (reference OBJECT_{NONEXISTENT,EXISTS,EXISTS_CLEAN})
OM_NONE = 0        # no data object
OM_DIRTY = 1       # exists, written since the last snapshot
OM_CLEAN = 2       # exists, unchanged since the last snapshot


class RBD:
    """Pool-level image operations (reference ``librbd::RBD``)."""

    def create(self, ioctx, name: str, size: int, *, order: int = 22,
               stripe_unit: int | None = None, stripe_count: int = 1,
               journaling: bool = False, primary: bool = True,
               object_map: bool = True, mirror_snapshot: bool = False):
        if size < 0:
            raise ValueError("image size must be >= 0")
        if journaling and mirror_snapshot:
            raise ValueError(
                "mirroring is journal- OR snapshot-based, not both")
        if _header_oid(name) in ioctx.list_objects():
            raise ValueError(f"image {name!r} exists")
        object_size = 1 << order
        su = stripe_unit if stripe_unit else object_size
        layout = FileLayout(stripe_unit=su, stripe_count=stripe_count,
                            object_size=object_size)
        layout.validate()
        hdr = {
            "size": size, "order": order,
            "stripe_unit": su, "stripe_count": stripe_count,
            "snap_seq": 0, "snaps": {},
            # journaling feature + mirror-primary flag (reference
            # librbd journaling feature bit / mirror image state).
            # `primary` is set at create so a mirror bootstrap writes
            # the non-primary header atomically (no primary window)
            "journaling": journaling, "primary": primary,
            # object-map + fast-diff feature (reference librbd
            # object-map/fast-diff feature bits, on by default)
            "object_map": object_map,
        }
        if mirror_snapshot:
            # snapshot-based mirroring mode (reference `rbd mirror
            # image enable <img> snapshot`): no journal; the daemon
            # ships object-map-assisted deltas between mirror snaps
            hdr["mirror_mode"] = "snapshot"
        ioctx.omap_set(_header_oid(name), {
            "header": json.dumps(hdr).encode()})

    def open(self, ioctx, name: str, snapshot: str | None = None,
             passphrase: str | None = None) -> "Image":
        return Image(ioctx, name, snapshot=snapshot,
                     passphrase=passphrase)

    def clone(self, ioctx, parent: str, snap_name: str, child: str):
        """COW child image from a protected parent snapshot
        (reference ``librbd::clone``): the child starts empty — reads
        of unwritten objects fall through to parent@snap; the first
        write to an object copies it up (reference copyup)."""
        with Image(ioctx, parent, read_only=True) as p:
            snap = p._hdr["snaps"].get(snap_name)
            if snap is None:
                raise ImageNotFound(f"no snapshot {snap_name!r}")
            if not snap.get("protected"):
                raise ValueError(
                    f"snapshot {snap_name!r} is not protected "
                    "(clone requires protection so the parent data "
                    "cannot vanish under the child)")
            self.create(ioctx, child, snap["size"],
                        order=p._hdr["order"],
                        stripe_unit=p._hdr["stripe_unit"],
                        stripe_count=p._hdr["stripe_count"])
        with Image(ioctx, child) as c:
            c._hdr["parent"] = {"image": parent, "snap": snap_name,
                                "snap_id": snap["id"],
                                "overlap": snap["size"]}
            c._save_header()
        with Image(ioctx, parent, read_only=True) as p:
            kids = p._hdr["snaps"][snap_name].setdefault(
                "children", [])
            if child not in kids:
                kids.append(child)
            p._save_header()

    def children(self, ioctx, parent: str, snap_name: str
                 ) -> list[str]:
        with Image(ioctx, parent, read_only=True) as p:
            snap = p._hdr["snaps"].get(snap_name)
            return list((snap or {}).get("children", []))

    def list(self, ioctx) -> list[str]:
        pre = "rbd_header."
        return sorted(o[len(pre):] for o in ioctx.list_objects()
                      if o.startswith(pre))

    # -- live migration (reference rbd migration prepare/execute/
    # commit/abort, src/librbd/migration/) --------------------------------
    def migration_prepare(self, src_ioctx, src: str, dst_ioctx,
                          dst: str):
        """Link a new target image to the source: clients switch to
        the target immediately (reads of uncopied objects fall
        through to the source; writes copy-up first), while the
        source refuses writes for the duration."""
        with Image(src_ioctx, src, read_only=True) as s:
            if s._hdr.get("encryption") is not None:
                raise ValueError(
                    "migrate after decrypting (encrypted migration "
                    "is unsupported)")
            if s._hdr.get("snaps"):
                raise ValueError(
                    "remove/flatten snapshots before migrating")
            if s._hdr.get("migrating"):
                raise ValueError(f"{src!r} is already migrating")
            if s._hdr.get("parent") is not None:
                # migration reads only the source's LOCAL objects;
                # parent-backed bytes would silently vanish
                raise ValueError("flatten the clone before migrating")
            self.create(dst_ioctx, dst, s._hdr["size"],
                        order=s._hdr["order"],
                        stripe_unit=s._hdr["stripe_unit"],
                        stripe_count=s._hdr["stripe_count"],
                        journaling=bool(s._hdr.get("journaling")),
                        primary=bool(s._hdr.get("primary", True)))
            src_size = s._hdr["size"]
            s._hdr["migrating"] = True
            s._save_header()
        with Image(dst_ioctx, dst) as d:
            d._hdr["migration_source"] = {
                "pool": src_ioctx.pool_name, "image": src,
                # like a clone's parent overlap: a shrink clamps it so
                # regrown space reads zeros, never stale source bytes
                "overlap": src_size}
            d._save_header()

    def _migration_pair(self, dst_ioctx, dst):
        d = Image(dst_ioctx, dst)
        mig = d._hdr.get("migration_source")
        if mig is None:
            d.close()
            raise ValueError(f"{dst!r} is not a migration target")
        src_io = dst_ioctx.rados.open_ioctx(mig["pool"])
        return d, src_io, mig["image"]

    def migration_execute(self, dst_ioctx, dst: str) -> int:
        """Background copy of every not-yet-copied object; → number
        copied this pass."""
        from ..osdc.librados import ObjectNotFound
        d, src_io, src = self._migration_pair(dst_ioctx, dst)
        copied: set[int] = set()
        try:
            limit = min(
                d._hdr["size"],
                d._hdr["migration_source"].get("overlap",
                                               d._hdr["size"]))
            nobj = -(-limit // d.layout.object_size)
            for objno in range(nobj):
                if d._object_exists(objno):
                    continue
                raw = d._migration_bytes(objno)
                if not raw:
                    continue            # sparse in the source too
                dst_ioctx.write_full(_data_oid(dst, objno), raw)
                copied.add(objno)
            d._objmap_mark(copied)      # ONE map rewrite per pass
        finally:
            d.close()
        return len(copied)

    def migration_commit(self, dst_ioctx, dst: str):
        """Finish: every object must be local; the source image is
        removed and the target stands alone."""
        from ..osdc.librados import ObjectNotFound
        d, src_io, src = self._migration_pair(dst_ioctx, dst)
        try:
            limit = min(
                d._hdr["size"],
                d._hdr["migration_source"].get("overlap",
                                               d._hdr["size"]))
            nobj = -(-limit // d.layout.object_size)
            for objno in range(nobj):
                if d._object_exists(objno):
                    continue
                try:
                    src_io.stat(_data_oid(src, objno))
                except ObjectNotFound:
                    continue            # sparse: nothing to copy
                raise ValueError(
                    f"object {objno} not copied yet — run "
                    "migration_execute to completion first")
            d._hdr.pop("migration_source", None)
            d._save_header()
        finally:
            d.close()
        with Image(src_io, src) as s:
            s._hdr.pop("migrating", None)
            s._save_header()
        self.remove(src_io, src)

    def migration_abort(self, dst_ioctx, dst: str):
        """Back out: the target disappears, the source resumes."""
        d, src_io, src = self._migration_pair(dst_ioctx, dst)
        d._hdr.pop("migration_source", None)
        d._save_header()
        d.close()
        self.remove(dst_ioctx, dst)
        with Image(src_io, src) as s:
            s._hdr.pop("migrating", None)
            s._save_header()

    def remove(self, ioctx, name: str):
        from ..osdc.librados import ObjectNotFound
        img = Image(ioctx, name)
        # every abort condition FIRST: only mutate the parent's
        # children list once the image is irrevocably being removed —
        # detaching before an abort would let unprotect+remove_snap on
        # the parent succeed while this surviving clone still depends
        # on it (parent-backed reads would fail: data loss)
        for sname, snap in img._hdr.get("snaps", {}).items():
            if snap.get("protected") or snap.get("children"):
                img.close()
                raise ValueError(
                    f"image {name!r} has protected snapshot "
                    f"{sname!r}"
                    + (f" with children {snap['children']}"
                       if snap.get("children") else "")
                    + " — flatten children and unprotect first")
        parent = img._hdr.get("parent")
        if parent is not None:
            # detach from the parent snapshot's children list, or the
            # protected/children guard would wedge the parent forever
            # behind a child that no longer exists
            try:
                with Image(ioctx, parent["image"],
                           read_only=True) as p:
                    snap = p._hdr["snaps"].get(parent["snap"])
                    if snap is not None and \
                            name in snap.get("children", []):
                        snap["children"].remove(name)
                        p._save_header()
            except ImageNotFound:
                pass
        # data objects: the suffix after "rbd_data.<name>." must be
        # the 16-hex objno (optionally "@<snapclone>") — a plain
        # prefix match would also destroy image "foo.123"'s objects
        # when removing "foo"
        pre = f"rbd_data.{name}."
        for o in ioctx.list_objects():
            if o.startswith(pre) and _is_data_suffix(o[len(pre):]):
                ioctx.remove(o)
        # drop the journal object too: a re-created image under the
        # same name must not inherit stale head_seq/mirror_position/
        # untrimmed events (a mirror daemon would skip or misapply the
        # new image's events)
        try:
            ioctx.remove(_journal_oid(name))
        except ObjectNotFound:
            pass
        # and the object maps: head + every possible snap id (snap
        # ids are 1..snap_seq; enumerating exactly also collects the
        # orphan a crash-interrupted create_snap may have left, and —
        # unlike a prefix scan — can never touch a sibling image's
        # maps: "rbd_object_map.foo.123" is image foo.123's HEAD map)
        maps = [_objmap_oid(name)] + [
            _objmap_oid(name, sid)
            for sid in range(1, img._hdr.get("snap_seq", 0) + 2)]
        for om in maps:
            try:
                ioctx.remove(om)
            except ObjectNotFound:
                pass
        ioctx.remove(_header_oid(name))
        img.close()


class Image:
    """One open image (reference ``librbd::Image``).  When opened at a
    snapshot the image is read-only and reads resolve through the COW
    clone chain."""

    def __init__(self, ioctx, name: str, snapshot: str | None = None,
                 read_only: bool = False,
                 passphrase: str | None = None):
        self.ioctx = ioctx
        self.name = name
        self._load_header()
        self.snap_id = None
        self._lock_cookie = None
        self._read_only = read_only
        self._passphrase = passphrase
        self._dek: bytes | None = None
        self._locked = False
        enc = self._hdr.get("encryption")
        if enc is not None:
            if passphrase is None:
                # header-only use (remove, migration bookkeeping,
                # list_snaps) needs no DEK: lock the DATA path instead
                # of refusing the open — an image whose passphrase is
                # lost must still be removable
                self._locked = True
            else:
                kek = _derive_kek(passphrase,
                                  bytes.fromhex(enc["salt"]))
                try:
                    self._dek = _unseal(
                        kek, bytes.fromhex(enc["wrapped_dek"]),
                        aad=b"rbd-dek")
                except Exception:
                    raise ValueError("wrong passphrase") from None
        if snapshot is not None:
            snap = self._hdr["snaps"].get(snapshot)
            if snap is None:
                raise ImageNotFound(f"no snapshot {snapshot!r}")
            self.snap_id = snap["id"]
            self._snap_size = snap["size"]
        elif not read_only and self._hdr.get("journaling") and \
                self._hdr.get("primary", True):
            # single-writer contract for journal sequencing: hold the
            # exclusive advisory lock for the handle's lifetime
            # (reference librbd exclusive-lock feature, required by
            # journaling) — a second writable open fails instead of
            # silently interleaving journal events
            import uuid
            cookie = uuid.uuid4().hex
            try:
                self.ioctx.lock_exclusive(_header_oid(name),
                                          "rbd_lock", cookie)
            except Exception as e:
                raise ValueError(
                    f"image {name!r} is locked by another writer "
                    f"(journaling requires a single writer): {e}"
                ) from None
            self._lock_cookie = cookie

    def _load_header(self):
        from ..osdc.librados import ObjectNotFound
        try:
            raw = self.ioctx.omap_get(_header_oid(self.name))["header"]
        except (KeyError, ObjectNotFound):
            raise ImageNotFound(self.name) from None
        self._hdr = json.loads(bytes(raw))
        self.layout = FileLayout(
            stripe_unit=self._hdr["stripe_unit"],
            stripe_count=self._hdr["stripe_count"],
            object_size=1 << self._hdr["order"])

    def _save_header(self):
        self.ioctx.omap_set(_header_oid(self.name), {
            "header": json.dumps(self._hdr).encode()})

    # -- metadata -----------------------------------------------------------
    def size(self) -> int:
        return self._snap_size if self.snap_id is not None \
            else self._hdr["size"]

    def stat(self) -> dict:
        return {"size": self.size(), "order": self._hdr["order"],
                "num_objs": -(-self._hdr["size"] //
                              self.layout.object_size),
                "snaps": sorted(self._hdr["snaps"])}

    # -- encryption --------------------------------------------------------
    def encryption_format(self, passphrase: str):
        """Turn encryption on (reference ``rbd encryption format``,
        LUKS-style).  Only an image with no data yet may be formatted
        — formatting does not re-encrypt existing bytes."""
        self._require_writable()
        if self._hdr.get("encryption") is not None:
            raise ValueError("image is already encrypted")
        if self._hdr.get("parent") is not None:
            raise ValueError("cannot format a clone")
        if self._hdr.get("journaling"):
            # the journal carries write payloads; pairing it with
            # at-rest encryption would leak every plaintext write
            raise ValueError(
                "encryption and journaling are mutually exclusive")
        if self._hdr.get("migration_source") is not None:
            # copy-up pulls PLAINTEXT source bytes into local
            # objects; mixing them with encrypted envelopes wedges
            # every later read
            raise ValueError(
                "finish the migration before formatting encryption")
        pre = f"rbd_data.{self.name}."
        if any(o.startswith(pre) and _is_data_suffix(o[len(pre):])
               for o in self.ioctx.list_objects()):
            raise ValueError(
                "image already has data; format before first write")
        import os as _os
        salt = _os.urandom(16)
        dek = _os.urandom(32)
        kek = _derive_kek(passphrase, salt)
        self._hdr["encryption"] = {
            "cipher": "aes-256-gcm",
            "salt": salt.hex(),
            "wrapped_dek": _seal(kek, dek, aad=b"rbd-dek").hex(),
        }
        self._save_header()
        self._dek = dek
        self._passphrase = passphrase

    def _require_unlocked(self):
        if self._locked:
            raise ValueError(
                f"image {self.name!r} is encrypted: passphrase "
                "required for data access")

    def _decrypt_obj(self, oid: str, raw: bytes) -> bytes:
        if self._dek is None or not raw:
            return raw
        try:
            return _unseal(self._dek, raw, aad=oid.encode())
        except Exception as e:
            raise ValueError(
                f"corrupt or tampered encrypted object {oid}: {e}"
            ) from None

    def _encrypt_obj(self, oid: str, plain: bytes) -> bytes:
        return _seal(self._dek, plain, aad=oid.encode())

    def _obj_patch(self, objno: int, payload: bytes, off: int):
        """Object-level write primitive: plain images write at the
        offset; encrypted images read-modify-write the whole envelope
        (GCM cannot be patched in place)."""
        oid = _data_oid(self.name, objno)
        if self._dek is None:
            self.ioctx.write(oid, payload, off)
            return
        from ..osdc.librados import ObjectNotFound
        try:
            raw = bytes(self.ioctx.read(oid))
        except ObjectNotFound:
            raw = b""
        cur = bytearray(self._decrypt_obj(oid, raw))
        end = off + len(payload)
        if len(cur) < end:
            cur.extend(b"\x00" * (end - len(cur)))
        cur[off:end] = payload
        self.ioctx.write_full(oid, self._encrypt_obj(oid, bytes(cur)))

    def resize(self, new_size: int):
        self._require_writable()
        self._journal_append({"op": "resize", "size": new_size})
        parent = self._hdr.get("parent")
        if parent is not None and new_size < parent["overlap"]:
            # shrinking a clone clamps the parent overlap: a later
            # grow must read zeros, never resurrect parent bytes
            # (reference librbd shrinks the parent overlap the same way)
            parent["overlap"] = new_size
        mig = self._hdr.get("migration_source")
        if mig is not None and new_size < mig.get("overlap",
                                                  new_size):
            mig["overlap"] = new_size
        old = self._hdr["size"]
        self._hdr["size"] = new_size
        self._save_header()
        if new_size < old:
            # drop whole objects past the new end (reference
            # librbd trim); partial tail objects keep their bytes but
            # reads clamp at size()
            first_dead = -(-new_size // self.layout.object_size)
            last = -(-old // self.layout.object_size)
            for objno in range(first_dead, last):
                self._cow_preserve(objno)   # snapshots keep the bytes
                try:
                    self.ioctx.remove(_data_oid(self.name, objno))
                except Exception:
                    pass
        if self._objmap_enabled():
            # re-persist at the new length: shrink drops the dead
            # objects' states, grow pads OM_NONE
            self._objmap_save(self._objmap_load())

    def close(self):
        if self._lock_cookie is not None:
            try:
                self.ioctx.unlock(_header_oid(self.name), "rbd_lock",
                                  self._lock_cookie)
            except Exception:
                pass
            self._lock_cookie = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _require_writable(self):
        if self.snap_id is not None:
            raise ValueError("image opened at a snapshot is read-only")
        if self._hdr.get("migrating"):
            raise ValueError(
                "image is mid-migration: writes go to the target")
        self._require_unlocked()
        if self._read_only and not getattr(self, "_replaying", False):
            raise ValueError("image opened read-only")
        if (self._hdr.get("journaling")
                or self._hdr.get("mirror_mode") == "snapshot") and \
                not self._hdr.get("primary", True) and \
                not getattr(self, "_replaying", False):
            raise ValueError(
                "image is non-primary (mirrored): writes only arrive "
                "via mirror replay; promote first")

    # -- journaling / mirroring ------------------------------------------
    # (reference src/librbd/journal/: every mutation is appended as a
    # journal event BEFORE being applied; rbd-mirror tails the journal.
    # Single-writer contract: a journaled primary image takes the
    # exclusive advisory lock at open — see __init__ — so the cached
    # head_seq below is sound and appends cannot interleave.)
    _TRIM_EVERY = 16

    def _journal_append(self, record: dict):
        if not self._hdr.get("journaling") or \
                getattr(self, "_replaying", False):
            return
        from ..osdc.librados import ObjectNotFound
        joid = _journal_oid(self.name)
        if getattr(self, "_journal_head", None) is None:
            # first append through this handle: one full read seeds
            # the cache (the exclusive lock guarantees nobody else
            # advances it); ONLY a missing object may default to
            # empty — any other error must propagate, or a transient
            # read failure would restart sequencing at 0 and the new
            # events would hide behind the mirror's commit position
            try:
                rows = self.ioctx.omap_get(joid)
            except ObjectNotFound:
                rows = {}
            self._journal_head = int(rows.get("head_seq", b"0"))
        self._journal_head += 1
        head = self._journal_head
        self.ioctx.omap_set(joid, {
            f"e{head:016d}": json.dumps(record).encode(),
            "head_seq": str(head).encode()})
        # trim entries every consumer has committed (the mirror daemon
        # reports its position into the same object; reference:
        # journal commit position + ObjectRecorder trim).  Amortized:
        # the trim pass re-reads the whole journal, so do it every
        # _TRIM_EVERY appends, not per write.
        if head % self._TRIM_EVERY == 0:
            try:
                rows = self.ioctx.omap_get(joid)
            except ObjectNotFound:
                return
            committed = int(rows.get("mirror_position", b"0"))
            dead = [k for k in rows
                    if k.startswith("e") and int(k[1:]) <= committed]
            if dead:
                self.ioctx.omap_rm_keys(joid, dead)

    def journal_entries(self, after: int = 0) -> list[tuple[int, dict]]:
        """Journal events with seq > after, in order."""
        try:
            rows = self.ioctx.omap_get(_journal_oid(self.name))
        except Exception:
            return []
        out = []
        for key, val in rows.items():
            if key.startswith("e") and int(key[1:]) > after:
                out.append((int(key[1:]), json.loads(bytes(val))))
        return sorted(out)

    def journal_commit(self, position: int):
        """Record the mirror consumer's commit position (trimming
        happens lazily on the next append)."""
        self.ioctx.omap_set(_journal_oid(self.name), {
            "mirror_position": str(position).encode()})

    def is_primary(self) -> bool:
        return bool(self._hdr.get("primary", True))

    def promote(self):
        """Make this side primary (failover; reference
        ``rbd mirror image promote``)."""
        self._load_header()
        self._hdr["primary"] = True
        self._save_header()

    def demote(self):
        """Make this side non-primary (planned failback)."""
        self._load_header()
        self._hdr["primary"] = False
        self._save_header()

    # -- snapshot-based mirroring ----------------------------------------
    # (reference src/tools/rbd_mirror/ snapshot mode + the mirror
    # snapshot schedule: the PRIMARY periodically stamps
    # ".mirror.primary.<id>" snapshots; the daemon ships the
    # object-map-assisted delta between consecutive mirror snapshots
    # and records its sync point back on the primary, which prunes
    # mirror snapshots older than the peer's sync point.)
    MIRROR_SNAP_PREFIX = ".mirror.primary."

    def mirror_mode(self) -> str | None:
        if self._hdr.get("mirror_mode") == "snapshot":
            return "snapshot"
        return "journal" if self._hdr.get("journaling") else None

    def mirror_snapshots(self) -> list[tuple[int, str]]:
        """Mirror snapshots as ordered (id, name).  Only names with a
        numeric sequence suffix qualify — the namespace is reserved
        (create_snap rejects user names under the prefix), but images
        imported from older clusters may carry strays; parsing them
        here would crash the mirror daemon's whole sync pass."""
        plen = len(self.MIRROR_SNAP_PREFIX)
        out = [(s["id"], nm) for nm, s in self._hdr["snaps"].items()
               if nm.startswith(self.MIRROR_SNAP_PREFIX)
               and nm[plen:].isdigit()]
        return sorted(out)

    def mirror_snapshot_create(self) -> str:
        """Primary-only: stamp a new mirror snapshot (what the
        reference's snapshot schedule does on its cadence), then prune
        mirror snapshots the peer has already synced past.

        The name's sequence number continues from the highest existing
        MIRROR snapshot name — NOT from the local snap_seq, which
        diverges across the two clusters (user snapshots advance it on
        the primary only; a promoted secondary would otherwise collide
        with a name it imported)."""
        if self.mirror_mode() != "snapshot":
            raise ValueError("image is not in snapshot mirror mode")
        self._require_writable()
        plen = len(self.MIRROR_SNAP_PREFIX)
        nums = [int(nm[plen:]) for _, nm in self.mirror_snapshots()]
        # monotonic even when older stamps were removed: reusing a
        # number would alias a NEW delta under a name the peer already
        # synced (silent divergence), so the header keeps the floor
        nxt = max([self._hdr.get("mirror_snap_seq", 0), *nums]) + 1
        self._hdr["mirror_snap_seq"] = nxt
        name = f"{self.MIRROR_SNAP_PREFIX}{nxt}"
        self.create_snap(name, _mirror_internal=True)  # persists header
        self._prune_mirror_snapshots()
        return name

    def mirror_snap_committed(self) -> int:
        """Highest mirror-snapshot id the peer reports fully synced."""
        try:
            rows = self.ioctx.omap_get(_journal_oid(self.name))
        except Exception:
            return 0
        return int(rows.get("mirror_snap_synced", b"0"))

    def mirror_snap_commit(self, snap_id: int):
        """Peer-side sync acknowledgement (the daemon writes this on
        the REMOTE image — the analog of journal_commit)."""
        self.ioctx.omap_set(_journal_oid(self.name), {
            "mirror_snap_synced": str(snap_id).encode()})

    def _prune_mirror_snapshots(self):
        """Drop mirror snapshots STRICTLY older than the peer's sync
        point: the synced one stays — it is the peer's next diff
        base — and unsynced ones must survive or the delta chain
        breaks."""
        committed = self.mirror_snap_committed()
        for sid, name in self.mirror_snapshots():
            if sid < committed:
                self.remove_snap(name)

    # -- object map / fast-diff --------------------------------------------
    # (reference src/librbd/object_map/ + the fast-diff feature: one
    # state byte per data object; the head map tracks what exists and
    # what was written since the last snapshot, each snapshot freezes
    # a copy.  export-diff consults the maps instead of scanning every
    # data object.)
    def _objmap_enabled(self) -> bool:
        return bool(self._hdr.get("object_map"))

    def _objmap_nobj(self, size: int | None = None) -> int:
        s = self._hdr["size"] if size is None else size
        return -(-s // self.layout.object_size)

    def _objmap_load(self, snap_id: int | None = None,
                     nobj: int | None = None) -> bytearray:
        """The map, padded/truncated to `nobj` entries (missing map
        object ⇒ all OM_NONE: a fresh image has no data objects)."""
        n = self._objmap_nobj() if nobj is None else nobj
        try:
            raw = bytes(self.ioctx.read(
                _objmap_oid(self.name, snap_id)))
        except Exception:       # noqa: BLE001 — absent map
            raw = b""
        m = bytearray(raw[:n])
        m.extend(b"\x00" * (n - len(m)))
        return m

    def _objmap_save(self, m: bytearray,
                     snap_id: int | None = None):
        self.ioctx.write_full(_objmap_oid(self.name, snap_id),
                              bytes(m))

    def _objmap_mark(self, objnos, state: int = OM_DIRTY):
        if not self._objmap_enabled():
            return
        m = self._objmap_load()
        changed = False
        for objno in objnos:
            if objno < len(m) and m[objno] != state:
                m[objno] = state
                changed = True
        if changed:
            self._objmap_save(m)

    def _fast_diff_objects(self, from_snap: str | None) -> set | None:
        """Objects possibly changed between `from_snap` and this
        handle's view — the union of every intervening map's dirty
        set plus existence flips; → None when the maps can't answer
        (feature off, or a full export of a clone whose unwritten
        objects are parent-backed and absent from the map)."""
        if not self._objmap_enabled():
            return None
        if self._hdr.get("migration_source") is not None:
            # uncopied objects are readable but absent from the map
            return None
        if from_snap is None:
            # a full export of parent-backed data can't come from the
            # maps: unwritten clone objects are OM_NONE yet readable.
            # For a snapshot handle, what matters is whether the image
            # had a parent AT SNAP TIME (flatten may have popped the
            # header's parent since) — recorded per snap; absent field
            # (pre-feature snaps) is treated as "had one": fallback
            # scan is slow but never wrong
            if self._hdr.get("parent") is not None:
                return None
            if self.snap_id is not None:
                snap = next(
                    (s for s in self._hdr["snaps"].values()
                     if s["id"] == self.snap_id), {})
                if snap.get("has_parent", True):
                    return None
        from_id = (self._hdr["snaps"][from_snap]["id"]
                   if from_snap else 0)
        end_id = self.snap_id            # None ⇒ head
        nobj = self._objmap_nobj(self.size())
        # maps strictly after from_id up to (and including) the end
        mid_ids = sorted(
            s["id"] for s in self._hdr["snaps"].values()
            if s["id"] > from_id
            and (end_id is None or s["id"] <= end_id))
        maps = [self._objmap_load(sid, nobj) for sid in mid_ids]
        end_map = (self._objmap_load(None, nobj) if end_id is None
                   else self._objmap_load(end_id, nobj))
        if end_id is None:
            maps.append(end_map)
        cand = set()
        for m in maps:
            cand.update(i for i, v in enumerate(m) if v == OM_DIRTY)
        if from_snap is not None:
            base_map = self._objmap_load(from_id, nobj)
            cand.update(i for i in range(nobj)
                        if (end_map[i] == OM_NONE)
                        != (base_map[i] == OM_NONE))
        else:
            cand.update(i for i, v in enumerate(end_map)
                        if v != OM_NONE)
        return cand

    # -- snapshots -----------------------------------------------------------
    def create_snap(self, snap_name: str, *, _mirror_internal=False):
        self._require_writable()
        if (snap_name.startswith(self.MIRROR_SNAP_PREFIX)
                and not _mirror_internal):
            # reserved namespace: a user snapshot here would either
            # collide with a future stamp number or (non-numeric
            # suffix) confuse peers scanning the prefix
            raise ValueError(
                f"snapshot names under {self.MIRROR_SNAP_PREFIX!r} "
                "are reserved for snapshot-mode mirroring")
        if snap_name in self._hdr["snaps"]:
            raise ValueError(f"snapshot {snap_name!r} exists")
        self._journal_append({"op": "snap_create", "name": snap_name})
        sid = self._hdr["snap_seq"] + 1
        m = None
        if self._objmap_enabled():
            # freeze the map under the NEW id BEFORE the header
            # registers the snap: a crash in between leaves only an
            # orphan map object (the retry overwrites it) — the other
            # order would register a snap whose map loads as all-NONE
            # and silently drop objects from incrementals
            m = self._objmap_load()
            self._objmap_save(m, sid)
        self._hdr["snap_seq"] = sid
        self._hdr["snaps"][snap_name] = {
            "id": sid, "size": self._hdr["size"],
            # fast-diff needs to know whether this snap's view has
            # parent-backed bytes the object map can't see
            "has_parent": self._hdr.get("parent") is not None}
        self._save_header()
        if m is not None:
            # clean the head LAST: a crash before this leaves extra
            # dirty bits (conservative — more diff reads, never fewer)
            for i, v in enumerate(m):
                if v == OM_DIRTY:
                    m[i] = OM_CLEAN
            self._objmap_save(m)

    def protect_snap(self, snap_name: str):
        """Required before cloning (reference snap protect)."""
        self._require_writable()
        snap = self._hdr["snaps"].get(snap_name)
        if snap is None:
            raise ImageNotFound(f"no snapshot {snap_name!r}")
        snap["protected"] = True
        self._save_header()

    def unprotect_snap(self, snap_name: str):
        self._require_writable()
        snap = self._hdr["snaps"].get(snap_name)
        if snap is None:
            raise ImageNotFound(f"no snapshot {snap_name!r}")
        if snap.get("children"):
            raise ValueError(
                f"snapshot has children: {snap['children']} "
                "(flatten them first)")
        snap["protected"] = False
        self._save_header()

    def remove_snap(self, snap_name: str):
        self._require_writable()
        if snap_name not in self._hdr["snaps"]:
            raise ImageNotFound(f"no snapshot {snap_name!r}")
        if self._hdr["snaps"][snap_name].get("protected"):
            raise ValueError(f"snapshot {snap_name!r} is protected")
        self._journal_append({"op": "snap_remove", "name": snap_name})
        gone = self._hdr["snaps"].pop(snap_name)
        self._save_header()
        if self._objmap_enabled():
            # merge the removed snap's DIRTY bits into the next newer
            # map (or the head map): its interval's changes must stay
            # visible to fast-diff, or an incremental spanning the
            # removed snap silently loses them (reference
            # object_map::SnapshotRemoveRequest does the same merge)
            removed = self._objmap_load(gone["id"],
                                        self._objmap_nobj(
                                            gone["size"]))
            newer = sorted(
                (s["id"], s["size"])
                for s in self._hdr["snaps"].values()
                if s["id"] > gone["id"])
            tgt_sid = newer[0][0] if newer else None
            # load the target at ITS OWN length (snap maps keep their
            # snap-time size; the head map the current size)
            tgt = self._objmap_load(
                tgt_sid,
                self._objmap_nobj(newer[0][1]) if newer else None)
            changed = False
            for i in range(min(len(removed), len(tgt))):
                if removed[i] == OM_DIRTY and tgt[i] == OM_CLEAN:
                    tgt[i] = OM_DIRTY
                    changed = True
            if changed:
                self._objmap_save(tgt, tgt_sid)
            try:
                self.ioctx.remove(_objmap_oid(self.name, gone["id"]))
            except Exception:       # noqa: BLE001 — map may be absent
                pass
        self._gc_clones()

    def _gc_clones(self):
        """Collect clone objects no remaining snapshot resolves to.
        Mirrors _read_object_at_snap exactly: each snap uses the
        OLDEST clone with id >= its own; every other clone is garbage
        (reference: the OSD's snap trimmer removing unreferenced
        clones)."""
        snap_ids = sorted(s["id"]
                          for s in self._hdr["snaps"].values())
        prefix = f"rbd_data.{self.name}."
        clones: dict[str, list[int]] = {}
        for o in self.ioctx.list_objects():
            if o.startswith(prefix) and "@" in o and \
                    _is_data_suffix(o[len(prefix):]):
                base, _, cid = o.rpartition("@")
                clones.setdefault(base, []).append(int(cid))
        for base, cids in clones.items():
            needed = set()
            for sid in snap_ids:
                cand = min((c for c in cids if c >= sid),
                           default=None)
                if cand is not None:
                    needed.add(cand)
            for c in cids:
                if c not in needed:
                    self.ioctx.remove(f"{base}@{c}")

    def list_snaps(self) -> list[dict]:
        return [{"name": n, **s}
                for n, s in sorted(self._hdr["snaps"].items())]

    def _cow_preserve(self, objno: int):
        """Before the first overwrite after a snapshot, preserve the
        object's current bytes for every snap that hasn't got a clone
        yet (reference: the OSD clones via SnapContext; same effect)."""
        snaps = self._hdr["snaps"]
        if not snaps:
            return
        oid = _data_oid(self.name, objno)
        try:
            cloned = int(bytes(self.ioctx.getxattr(oid,
                                                   "cloned_upto")))
        except Exception:
            cloned = 0
        newest = max(s["id"] for s in snaps.values())
        if cloned >= newest:
            return
        try:
            cur = self.ioctx.read(oid)
        except Exception:
            cur = None     # sparse: snapshot reads fall back to zeros
        if cur is not None:
            self.ioctx.write_full(f"{oid}@{newest}", cur)
        self.ioctx.setxattr(oid, "cloned_upto", str(newest).encode())

    def _read_object_at_snap(self, objno: int) -> bytes:
        """Resolve an object's bytes as of self.snap_id: the oldest
        clone whose id >= snap_id, else the head object if it was
        never overwritten past snap_id."""
        oid = _data_oid(self.name, objno)
        clones = []
        prefix = f"{oid}@"
        for o in self.ioctx.list_objects():
            if o.startswith(prefix):
                clones.append(int(o[len(prefix):]))
        for cid in sorted(clones):
            if cid >= self.snap_id:
                try:
                    return self.ioctx.read(f"{oid}@{cid}")
                except Exception:
                    return b""
        try:
            cloned = int(bytes(self.ioctx.getxattr(oid,
                                                   "cloned_upto")))
        except Exception:
            cloned = 0
        if cloned >= self.snap_id:
            # head was overwritten after the snap but the pre-snap
            # state was sparse (no clone written): zeros
            return b""
        try:
            return self.ioctx.read(oid)
        except Exception:
            return b""

    # -- clone / parent fall-through --------------------------------------
    def _parent_covers(self, objno: int) -> bool:
        """Cheap (no I/O) test: does the parent overlap back any byte
        of this child object?"""
        parent = self._hdr.get("parent")
        if parent is None:
            return False
        lay = self.layout
        sc = lay.stripe_count
        su = lay.stripe_unit
        su_per_object = lay.object_size // su
        # first logical byte an object holds: its first stripe unit
        objectsetno, stripepos = objno // sc, objno % sc
        first_stripeno = objectsetno * su_per_object
        first_logical = (first_stripeno * sc + stripepos) * su
        return first_logical < parent["overlap"]

    def _parent_bytes(self, objno: int) -> bytes | None:
        """The parent@snap bytes backing this child object, laid out
        in the OBJECT's internal order, or None when no parent covers
        it (reference: reads below the overlap fall through the parent
        chain).  Stripe-aware: with stripe_count > 1 an object holds
        interleaved stripe units from non-contiguous logical ranges,
        so each unit is fetched at its own logical offset."""
        if not self._parent_covers(objno):
            return None
        parent = self._hdr.get("parent")
        lay = self.layout
        sc, su = lay.stripe_count, lay.stripe_unit
        su_per_object = lay.object_size // su
        objectsetno, stripepos = objno // sc, objno % sc
        out = bytearray()
        with Image(self.ioctx, parent["image"],
                   snapshot=parent["snap"]) as p:
            for u in range(su_per_object):
                stripeno = objectsetno * su_per_object + u
                logical = (stripeno * sc + stripepos) * su
                if logical >= parent["overlap"]:
                    break
                n = min(su, parent["overlap"] - logical)
                piece = p.read(logical, n)
                out.extend(piece)
                if len(piece) < su:
                    break
        return bytes(out) if out else None

    # -- migration fall-through -------------------------------------------
    def _migration_bytes(self, objno: int) -> bytes | None:
        """Plaintext bytes of a not-yet-copied object from the
        migration source (reads fall through like a clone's parent)."""
        mig = self._hdr.get("migration_source")
        if mig is None:
            return None
        base = objno * self.layout.object_size
        ov = mig.get("overlap")
        if ov is not None and base >= ov:
            return None         # beyond the clamped overlap: zeros
        src_io = getattr(self, "_mig_io", None)
        if src_io is None:
            src_io = self._mig_io = self.ioctx.rados.open_ioctx(
                mig["pool"])
        try:
            raw = bytes(src_io.read(_data_oid(mig["image"], objno)))
        except Exception:       # noqa: BLE001 — absent or transient
            return None
        if ov is not None and base + len(raw) > ov:
            raw = raw[:ov - base]
        return raw

    def _migration_copy_up(self, objno: int):
        """First write to an uncopied object pulls the source bytes
        in first (the copyup discipline, reference deep-copyup)."""
        if self._hdr.get("migration_source") is None:
            return
        if self._object_exists(objno):
            return
        base = self._migration_bytes(objno)
        if base:
            self.ioctx.write_full(_data_oid(self.name, objno), base)

    def _object_exists(self, objno: int) -> bool:
        from ..osdc.librados import ObjectNotFound
        try:
            self.ioctx.stat(_data_oid(self.name, objno))
            return True
        except ObjectNotFound:
            return False

    def _copy_up(self, objno: int) -> bool:
        """First write to a parent-backed object copies the parent
        bytes into the child first (reference copyup).  → True iff
        the child owns the object afterwards (flatten uses this to
        build the object map without re-statting everything)."""
        if self._hdr.get("parent") is None:
            return self._object_exists(objno)
        oid = _data_oid(self.name, objno)
        from ..osdc.librados import ObjectNotFound
        try:
            self.ioctx.stat(oid)
            return True         # child already owns this object
        except ObjectNotFound:
            # only a definitive "absent" may fall through to the
            # copyup write: a transient error on an object the child
            # already wrote must propagate, or the write_full below
            # would clobber the child's data with stale parent bytes
            pass
        base = self._parent_bytes(objno)
        if base:
            self.ioctx.write_full(oid, base)
            return True
        return False

    def flatten(self):
        """Copy all parent-backed data into the child and detach it
        (reference ``rbd flatten``)."""
        self._require_writable()
        parent = self._hdr.get("parent")
        if parent is None:
            return
        # exact object set: with striping, an object's logical bytes
        # are interleaved — derive the covered objects from the layout
        nobj = 1 + max(
            (e.object_no for e in
             file_to_extents(self.layout, 0, parent["overlap"])),
            default=-1)
        owned = {objno for objno in range(nobj)
                 if self._copy_up(objno)}
        if self._objmap_enabled():
            # the copied-up objects now hold the image's only copy of
            # the parent bytes: they must enter the object map, or the
            # first post-flatten export-diff would skip them
            self._objmap_mark(owned)
        with Image(self.ioctx, parent["image"]) as p:
            snap = p._hdr["snaps"].get(parent["snap"])
            if snap is not None:
                kids = snap.get("children", [])
                if self.name in kids:
                    kids.remove(self.name)
                p._save_header()
        self._hdr.pop("parent", None)
        self._save_header()

    # -- incremental diff (reference rbd export-diff / import-diff) -----
    def export_diff(self, from_snap: str | None = None) -> dict:
        """Changed extents since `from_snap` (None ⇒ everything) up
        to this handle's view (a snapshot handle diffs to that snap,
        a head handle to the current data) — the transport behind
        incremental backup/mirroring (reference ``rbd export-diff``).
        Extent granularity: differing byte ranges within each object.
        With the object-map feature the candidate objects come from
        the maps (fast-diff): unchanged objects are SKIPPED without
        any data read — the map lookup replaces the full scan."""
        size = self.size()
        base = None
        if from_snap is not None:
            if from_snap not in self._hdr["snaps"]:
                raise ImageNotFound(f"no snapshot {from_snap!r}")
            base = Image(self.ioctx, self.name, snapshot=from_snap,
                         passphrase=self._passphrase)
        candidates = self._fast_diff_objects(from_snap)
        try:
            extents = []
            step = self.layout.object_size
            off = 0
            chunk = 4096
            while off < size:
                if candidates is not None and \
                        (off // step) not in candidates:
                    off += step
                    continue
                n = min(step, size - off)
                new = self.read(off, n)
                if base is not None:
                    old = base.read(off, n)
                    if len(old) < n:
                        old += b"\x00" * (n - len(old))
                else:
                    old = b"\x00" * n
                if new != old:
                    # narrow by C-speed chunk comparisons, then
                    # byte-trim only inside the boundary chunks — a
                    # per-byte Python walk over a 4 MiB object costs
                    # seconds per changed object
                    lo = 0
                    while lo < n and \
                            new[lo:lo + chunk] == old[lo:lo + chunk]:
                        lo += chunk
                    hi = n
                    while hi > lo and new[max(hi - chunk, lo):hi] == \
                            old[max(hi - chunk, lo):hi]:
                        hi -= chunk
                    hi = min(hi, n)
                    while lo < hi and new[lo] == old[lo]:
                        lo += 1
                    while hi > lo and new[hi - 1] == old[hi - 1]:
                        hi -= 1
                    extents.append({"off": off + lo,
                                    "data": new[lo:hi].hex()})
                off += n
        finally:
            if base is not None:
                base.close()
        return {"image": self.name, "size": size,
                "from_snap": from_snap,
                "to_snap": next(
                    (nm for nm, sn in self._hdr["snaps"].items()
                     if sn["id"] == self.snap_id), None),
                "extents": extents}

    def import_diff(self, diff: dict):
        """Apply an exported diff (reference ``rbd import-diff``):
        validate the base snapshot, resize, write each extent, then
        stamp the end snapshot — the chain discipline that makes
        out-of-order incrementals fail loudly instead of silently
        corrupting the restore."""
        self._require_writable()
        if diff.get("from_snap") and \
                diff["from_snap"] not in self._hdr["snaps"]:
            raise ValueError(
                f"diff is based on snapshot {diff['from_snap']!r} "
                "which this image does not have — apply the earlier "
                "diffs first")
        if diff["size"] != self._hdr["size"]:
            self.resize(diff["size"])
        for ext in diff["extents"]:
            self.write(ext["off"], bytes.fromhex(ext["data"]))
        to_snap = diff.get("to_snap")
        if to_snap and to_snap not in self._hdr["snaps"]:
            # stamp the chain endpoint so the NEXT incremental's
            # from_snap check passes (reference import-diff creates
            # the end snap after applying).  _mirror_internal: in
            # snapshot-mode sync the endpoint IS a reserved
            # .mirror.primary.N name the secondary must reproduce
            self.create_snap(to_snap, _mirror_internal=True)

    # -- data path ------------------------------------------------------------
    def write(self, offset: int, data: bytes) -> int:
        self._require_writable()
        if offset + len(data) > self._hdr["size"]:
            raise ValueError("write past end of image")
        self._journal_append({"op": "write", "off": offset,
                              "data": data.hex()})
        exts = file_to_extents(self.layout, offset, len(data))
        # mark BEFORE the data writes (reference object-map ordering):
        # a mid-loop failure then leaves objects dirty-but-unwritten
        # (harmless extra diff reads), never written-but-clean (lost
        # from the next incremental)
        self._objmap_mark({e.object_no for e in exts})
        for ext in exts:
            self._copy_up(ext.object_no)
            self._migration_copy_up(ext.object_no)
            self._cow_preserve(ext.object_no)
            lo = ext.logical_offset - offset
            self._obj_patch(ext.object_no,
                            data[lo:lo + ext.length], ext.offset)
        return len(data)

    def read(self, offset: int, length: int) -> bytes:
        self._require_unlocked()
        end = min(offset + length, self.size())
        if end <= offset:
            return b""
        length = end - offset
        out = bytearray(length)
        for ext in file_to_extents(self.layout, offset, length):
            raw = True      # raw object bytes (decrypt if encrypted)
            if self.snap_id is not None:
                obj = self._read_object_at_snap(ext.object_no)
                if not obj:
                    obj = self._parent_bytes(ext.object_no) or b""
                    raw = False     # parent returns plaintext
            else:
                try:
                    obj = self.ioctx.read(
                        _data_oid(self.name, ext.object_no))
                except Exception:
                    obj = (self._parent_bytes(ext.object_no)
                           or self._migration_bytes(ext.object_no)
                           or b"")
                    raw = False     # source image returns plaintext
            if raw and self._dek is not None:
                obj = self._decrypt_obj(
                    _data_oid(self.name, ext.object_no), bytes(obj))
            piece = obj[ext.offset:ext.offset + ext.length]
            lo = ext.logical_offset - offset
            out[lo:lo + len(piece)] = piece
        return bytes(out)

    def discard(self, offset: int, length: int):
        """Zero a range (whole-object removes when aligned)."""
        self._require_writable()
        self._journal_append({"op": "discard", "off": offset,
                              "len": length})
        from ..osdc.librados import ObjectNotFound
        exts = file_to_extents(self.layout, offset, length)
        # conservative ordering: everything touched goes DIRTY first;
        # only a CONFIRMED removal (ok or already-absent) may demote
        # to NONE afterwards — a swallowed transient error must not
        # leave live data invisible to fast-diff
        self._objmap_mark({e.object_no for e in exts})
        gone = set()
        for ext in exts:
            oid = _data_oid(self.name, ext.object_no)
            parent_backed = (
                self._parent_covers(ext.object_no)
                or self._hdr.get("migration_source") is not None)
            if ext.offset == 0 and \
                    ext.length == self.layout.object_size and \
                    not parent_backed:
                self._cow_preserve(ext.object_no)
                try:
                    self.ioctx.remove(oid)
                    gone.add(ext.object_no)
                except ObjectNotFound:
                    gone.add(ext.object_no)
                except Exception:       # noqa: BLE001 — stays DIRTY
                    pass
            else:
                # parent-/source-backed objects must be ZEROED, not
                # removed — removal would resurrect the backing bytes
                if parent_backed:
                    self._copy_up(ext.object_no)
                    self._migration_copy_up(ext.object_no)
                self._cow_preserve(ext.object_no)
                self._obj_patch(ext.object_no,
                                b"\x00" * ext.length, ext.offset)
        self._objmap_mark(gone, OM_NONE)
