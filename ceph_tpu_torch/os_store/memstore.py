"""MemStore — the in-RAM ObjectStore.

The port's copy of ``ceph_tpu.os_store.memstore``.

Reference behavior re-created (``src/os/memstore/MemStore.{h,cc}``;
SURVEY.md §3.7): collections of objects held in process memory, with
the full Transaction opcode set and commit callbacks delivered off the
caller's thread through a Finisher, preserving the reference's async
completion ordering (callbacks fire in queue order).
"""

from __future__ import annotations

import threading
from typing import Callable

from ..core.mempool import pool as _mempool
from ..core.threading_utils import Finisher
from .objectstore import (Collection, ObjectStore, StoredObject,
                          Transaction, OP_CLONE, OP_COLL_MOVE,
                          OP_DEDUP_INGEST, OP_DEDUP_RELEASE,
                          OP_MKCOLL, OP_OMAP_RMKEYS, OP_OMAP_SETKEYS,
                          OP_REMOVE, OP_RMATTR, OP_RMCOLL, OP_SETATTRS,
                          OP_TOUCH, OP_TRUNCATE, OP_WRITE, OP_ZERO)


class MemStore(ObjectStore):
    def __init__(self, name: str = "memstore"):
        self.name = name
        self.colls: dict[str, Collection] = {}
        self.lock = threading.RLock()
        self.finisher = Finisher(f"{name}-fin")
        # live data-byte accounting (reference mempool::bluestore_*):
        # one pool per store instance + items on the shared pool
        self.mempool = _mempool(f"objectstore::{name}")
        self._tracked_bytes = 0   # this instance's pool contribution

    # -- lifecycle ---------------------------------------------------------
    def mkfs(self):
        with self.lock:
            self.colls.clear()
            self._drop_tracking()

    def umount(self):
        with self.lock:
            self._drop_tracking()
        self.finisher.shutdown()

    def _drop_tracking(self):
        """This store's data is gone (or being abandoned): give its
        bytes back to the pool — pools are process-global by name, so
        a leaked residue would count dead stores as live forever."""
        self.mempool.adjust(-self._tracked_bytes)
        self._tracked_bytes = 0

    # -- write path --------------------------------------------------------
    def queue_transaction(self, txn: Transaction,
                          on_commit: Callable | None = None) -> None:
        with self.lock:
            for op in txn.ops:
                self._apply_op(op)
        if on_commit is not None:
            self.finisher.queue(on_commit)

    def _coll(self, cid: str) -> Collection:
        c = self.colls.get(cid)
        if c is None:
            raise KeyError(f"no collection {cid!r}")
        return c

    def _obj(self, cid: str, oid: str, create: bool = False) -> StoredObject:
        c = self._coll(cid)
        o = c.objects.get(oid)
        if o is None:
            if not create:
                raise KeyError(f"no object {cid}/{oid}")
            o = c.objects[oid] = StoredObject()
        return o

    def _obj_bytes(self, cid: str, oid: str) -> int:
        c = self.colls.get(cid)
        o = c.objects.get(oid) if c is not None else None
        return len(o.data) if o is not None else 0

    def _apply_op(self, op: list):
        code, cid, oid = op[0], op[1], op[2]
        track = code in (OP_WRITE, OP_ZERO, OP_TRUNCATE, OP_REMOVE,
                        OP_CLONE, OP_RMCOLL, OP_DEDUP_INGEST,
                        OP_DEDUP_RELEASE)
        before = 0
        if track:
            if code == OP_RMCOLL:
                c = self.colls.get(cid)
                before = sum(len(o.data)
                             for o in c.objects.values()) if c else 0
            elif code == OP_CLONE:
                before = self._obj_bytes(cid, op[3])
            elif code in (OP_DEDUP_INGEST, OP_DEDUP_RELEASE):
                # the mutated object is the chunk, keyed off the fp
                # in the oid slot
                before = self._obj_bytes(cid, "chunk_" + oid)
            else:
                before = self._obj_bytes(cid, oid)
        self._apply_op_inner(op)
        if track:
            if code == OP_RMCOLL:
                after = 0
            elif code == OP_CLONE:
                after = self._obj_bytes(cid, op[3])
            elif code in (OP_DEDUP_INGEST, OP_DEDUP_RELEASE):
                after = self._obj_bytes(cid, "chunk_" + oid)
            else:
                after = self._obj_bytes(cid, oid)
            self._tracked_bytes += after - before
            self.mempool.adjust(after - before)

    def _apply_op_inner(self, op: list):
        code, cid, oid = op[0], op[1], op[2]
        if code == OP_MKCOLL:
            self.colls.setdefault(cid, Collection(cid))
        elif code == OP_RMCOLL:
            self.colls.pop(cid, None)
        elif code == OP_TOUCH:
            self._obj(cid, oid, create=True)
        elif code == OP_WRITE:
            off, data = op[3], op[4]
            o = self._obj(cid, oid, create=True)
            end = off + len(data)
            if len(o.data) < end:
                o.data.extend(b"\0" * (end - len(o.data)))
            o.data[off:end] = data
        elif code == OP_ZERO:
            off, length = op[3], op[4]
            o = self._obj(cid, oid, create=True)
            end = off + length
            if len(o.data) < end:
                o.data.extend(b"\0" * (end - len(o.data)))
            o.data[off:end] = b"\0" * length
        elif code == OP_TRUNCATE:
            size = op[3]
            o = self._obj(cid, oid, create=True)
            if len(o.data) > size:
                del o.data[size:]
            else:
                o.data.extend(b"\0" * (size - len(o.data)))
        elif code == OP_REMOVE:
            self._coll(cid).objects.pop(oid, None)
        elif code == OP_SETATTRS:
            self._obj(cid, oid, create=True).xattrs.update(op[3])
        elif code == OP_RMATTR:
            self._obj(cid, oid, create=True).xattrs.pop(op[3], None)
        elif code == OP_OMAP_SETKEYS:
            self._obj(cid, oid, create=True).omap.update(op[3])
        elif code == OP_OMAP_RMKEYS:
            o = self._obj(cid, oid, create=True)
            for k in op[3]:
                o.omap.pop(k, None)
        elif code == OP_COLL_MOVE:
            # idempotent: WAL replay after the move finds nothing left
            o = self._coll(cid).objects.pop(oid, None)
            if o is not None:
                self.colls.setdefault(
                    op[3], Collection(op[3])).objects[oid] = o
        elif code == OP_CLONE:
            src = self._obj(cid, oid)
            dst = self._obj(cid, op[3], create=True)
            dst.data = bytearray(src.data)
            dst.xattrs = dict(src.xattrs)
            dst.omap = dict(src.omap)
        elif code == OP_DEDUP_INGEST:
            # conditional at apply time: each store consults its OWN
            # index (compress/dedup.py conventions), so the same txn
            # replicated to every acting member stays correct whatever
            # chunks each replica already holds
            fp, data = oid, op[3]
            self.colls.setdefault(cid, Collection(cid))
            idx = self._obj(cid, "_dedup_index", create=True)
            refs = int(idx.omap.get(fp, b"0"))
            if refs <= 0:
                chunk = self._obj(cid, "chunk_" + fp, create=True)
                chunk.data = bytearray(data)
            idx.omap[fp] = str(refs + 1).encode()
        elif code == OP_DEDUP_RELEASE:
            fp = oid
            self.colls.setdefault(cid, Collection(cid))
            idx = self._obj(cid, "_dedup_index", create=True)
            refs = int(idx.omap.get(fp, b"0")) - 1
            if refs <= 0:
                idx.omap.pop(fp, None)
                self._coll(cid).objects.pop("chunk_" + fp, None)
            else:
                idx.omap[fp] = str(refs).encode()
        else:
            raise ValueError(f"unknown transaction op {code!r}")

    # -- read path ---------------------------------------------------------
    def read(self, cid: str, oid: str, off: int = 0,
             length: int | None = None) -> bytes:
        with self.lock:
            o = self._obj(cid, oid)
            if length is None:
                return bytes(o.data[off:])
            return bytes(o.data[off:off + length])

    def stat(self, cid: str, oid: str) -> dict:
        with self.lock:
            return {"size": len(self._obj(cid, oid).data)}

    def getattr(self, cid: str, oid: str, name: str) -> bytes:
        with self.lock:
            return self._obj(cid, oid).xattrs[name]

    def getattrs(self, cid: str, oid: str) -> dict[str, bytes]:
        with self.lock:
            return dict(self._obj(cid, oid).xattrs)

    def omap_get(self, cid: str, oid: str) -> dict[str, bytes]:
        with self.lock:
            return dict(self._obj(cid, oid).omap)

    def exists(self, cid: str, oid: str) -> bool:
        with self.lock:
            c = self.colls.get(cid)
            return c is not None and oid in c.objects

    def list_objects(self, cid: str) -> list[str]:
        with self.lock:
            return sorted(self._coll(cid).objects)

    def list_collections(self) -> list[str]:
        with self.lock:
            return sorted(self.colls)
