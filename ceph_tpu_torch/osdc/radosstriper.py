"""radosstriper — striped large-object layer over librados.

The port's copy of ``ceph_tpu.osdc.radosstriper``.

Reference behavior re-created (``src/libradosstriper/RadosStriperImpl.cc``,
SURVEY.md §3.8 "radosstriper"): a logical "striped object" named *soid*
is spread over RADOS objects ``<soid>.%016x`` using the shared
``FileLayout`` policy (``src/osdc/Striper.cc``); the first piece
(index 0) carries the striper metadata as xattrs —
``striper.layout.stripe_unit`` / ``.stripe_count`` / ``.object_size``
and ``striper.size`` (the logical EOF).  Reads of holes return zeros,
exactly like a sparse POSIX file; a write past EOF extends it.

Unlike the reference there is no cross-client shared lock — the
single-writer case it protects is out of scope here; what matters is
the layout math, the metadata contract, and parallel per-piece I/O
(each extent is submitted as an independent aio op, the RADOS analog
of the reference's async ObjectOperation fan-out).
"""

from __future__ import annotations

from .librados import Error, IoCtx, ObjectNotFound
from .striper import FileLayout, file_to_extents

XATTR_SU = "striper.layout.stripe_unit"
XATTR_SC = "striper.layout.stripe_count"
XATTR_OS = "striper.layout.object_size"
XATTR_SIZE = "striper.size"


def piece_name(soid: str, object_no: int) -> str:
    return f"{soid}.{object_no:016x}"


class RadosStriper:
    """Striped-object API over one IoCtx (reference RadosStriperImpl)."""

    def __init__(self, ioctx: IoCtx, layout: FileLayout | None = None):
        self.io = ioctx
        self.default_layout = layout or FileLayout()
        self.default_layout.validate()

    # -- metadata ----------------------------------------------------------
    def _load_meta(self, soid: str) -> tuple[FileLayout, int]:
        """→ (layout, size) from the first piece's xattrs."""
        first = piece_name(soid, 0)
        try:
            xa = self.io.getxattrs(first)
        except ObjectNotFound:
            raise ObjectNotFound(-2, f"striped object {soid!r} "
                                 "does not exist")
        try:
            layout = FileLayout(
                stripe_unit=int(xa[XATTR_SU]),
                stripe_count=int(xa[XATTR_SC]),
                object_size=int(xa[XATTR_OS]))
            size = int(xa[XATTR_SIZE])
        except KeyError as e:
            raise Error(-22, f"{first!r} exists but lacks striper "
                        f"xattr {e}")
        return layout, size

    def _store_meta(self, soid: str, layout: FileLayout, size: int):
        first = piece_name(soid, 0)
        for name, val in ((XATTR_SU, layout.stripe_unit),
                          (XATTR_SC, layout.stripe_count),
                          (XATTR_OS, layout.object_size),
                          (XATTR_SIZE, size)):
            self.io.setxattr(first, name, str(val).encode())

    def _meta_or_create(self, soid: str) -> tuple[FileLayout, int]:
        try:
            return self._load_meta(soid)
        except ObjectNotFound:
            # create the first piece so metadata has a home; layout is
            # frozen at creation (the reference rejects layout changes
            # on a non-empty striped object the same way)
            self.io.write_full(piece_name(soid, 0), b"")
            self._store_meta(soid, self.default_layout, 0)
            return self.default_layout, 0

    # -- data path ---------------------------------------------------------
    def write(self, soid: str, data: bytes, offset: int = 0):
        if not data:
            return
        layout, size = self._meta_or_create(soid)
        extents = file_to_extents(layout, offset, len(data))
        completions = []
        for ext in extents:
            chunk = data[ext.logical_offset - offset:
                         ext.logical_offset - offset + ext.length]
            completions.append(self.io._aio(
                piece_name(soid, ext.object_no),
                [{"op": "write", "off": ext.offset,
                  "data": chunk.hex()}]))
        for c in completions:
            if not c.wait_for_complete(timeout=15.0):
                raise Error(-110, "striper write timed out")
            if c.rc != 0:
                raise Error(c.rc, "striper piece write failed")
        end = offset + len(data)
        if end > size:
            self._store_meta(soid, layout, end)

    def write_full(self, soid: str, data: bytes):
        """Replace contents entirely (truncate-then-write)."""
        try:
            self.remove(soid)
        except ObjectNotFound:
            pass
        self.write(soid, data, 0)

    def append(self, soid: str, data: bytes):
        try:
            _, size = self._load_meta(soid)
        except ObjectNotFound:
            size = 0
        self.write(soid, data, size)

    def read(self, soid: str, length: int | None = None,
             offset: int = 0) -> bytes:
        layout, size = self._load_meta(soid)
        if offset >= size:
            return b""
        n = size - offset if length is None else min(length,
                                                     size - offset)
        if n <= 0:
            return b""
        out = bytearray(n)
        waits = []
        for ext in file_to_extents(layout, offset, n):
            c = self.io.aio_read(piece_name(soid, ext.object_no),
                                 ext.length, ext.offset)
            waits.append((ext, c))
        for ext, c in waits:
            if not c.wait_for_complete(timeout=15.0):
                raise Error(-110, "striper read timed out")
            if c.rc == -2:
                continue        # hole: piece never written → zeros
            if c.rc != 0:
                raise Error(c.rc, "striper piece read failed")
            data = (bytes.fromhex(c.results[0]["data"])
                    if c.results else b"")
            dst = ext.logical_offset - offset
            out[dst:dst + len(data)] = data
        return bytes(out)

    def stat(self, soid: str) -> dict:
        layout, size = self._load_meta(soid)
        return {"size": size, "stripe_unit": layout.stripe_unit,
                "stripe_count": layout.stripe_count,
                "object_size": layout.object_size}

    def truncate(self, soid: str, new_size: int):
        layout, size = self._load_meta(soid)
        if new_size >= size:
            self._store_meta(soid, layout, new_size)
            return
        # per-piece keep lengths under the new EOF (with striping >1 a
        # shrink trims MANY pieces' tails, not just one — the reference
        # truncates every extent the same way), then drop pieces that
        # hold no bytes at all any more
        keep: dict[int, int] = {}
        for e in file_to_extents(layout, 0, new_size) if new_size else []:
            keep[e.object_no] = max(keep.get(e.object_no, 0),
                                    e.offset + e.length)
        old_last = max((e.object_no for e in
                        file_to_extents(layout, 0, size)), default=0)
        for i in range(old_last + 1):
            if i in keep:
                try:
                    self.io.truncate(piece_name(soid, i), keep[i])
                except ObjectNotFound:
                    pass
            elif i != 0:        # piece 0 holds the metadata
                try:
                    self.io.remove(piece_name(soid, i))
                except ObjectNotFound:
                    pass
        if 0 not in keep:
            try:
                self.io.truncate(piece_name(soid, 0), 0)
            except ObjectNotFound:
                pass
        self._store_meta(soid, layout, new_size)

    def remove(self, soid: str):
        layout, size = self._load_meta(soid)
        last = max((e.object_no for e in
                    file_to_extents(layout, 0, max(size, 1))),
                   default=0)
        for i in range(last + 1):
            try:
                self.io.remove(piece_name(soid, i))
            except ObjectNotFound:
                pass

    # -- xattr passthrough (user xattrs live on piece 0) -------------------
    def setxattr(self, soid: str, name: str, value: bytes):
        self._load_meta(soid)
        self.io.setxattr(piece_name(soid, 0), f"user.{name}", value)

    def getxattr(self, soid: str, name: str) -> bytes:
        self._load_meta(soid)
        return self.io.getxattr(piece_name(soid, 0), f"user.{name}")
