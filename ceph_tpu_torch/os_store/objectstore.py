"""ObjectStore API — collections, objects, transactions.

The port's copy of ``ceph_tpu.os_store.objectstore``.

Reference behavior re-created (``src/os/ObjectStore.h``,
``src/os/Transaction.cc``; SURVEY.md §3.7):

- a store holds **collections** (one per PG), each a namespace of
  objects; an object is (data bytes, xattrs, omap);
- every mutation travels as a ``Transaction`` — an ordered opcode
  stream applied atomically with an async commit callback
  (``queue_transaction``);
- reads are synchronous (``read``, ``stat``, ``getattr``,
  ``omap_get``), exactly the reference's split.

Transactions are dict-serializable so the replication backends can
ship them inside ``MOSDRepOp`` / EC sub-write messages the way the
reference encodes ``Transaction`` into those message payloads.
"""

from __future__ import annotations

import abc
from typing import Callable

class StoreError(OSError):
    """The store's durable backing failed (WAL append/fsync error,
    ENOSPC, simulated power loss).  Once raised, the store refuses
    further writes: the daemon degrades (EIO to clients, mark-down)
    instead of the op thread crashing."""


# transaction opcodes (reference Transaction::OP_*)
OP_TOUCH = "touch"
OP_WRITE = "write"
OP_ZERO = "zero"
OP_TRUNCATE = "truncate"
OP_REMOVE = "remove"
OP_SETATTRS = "setattrs"
OP_RMATTR = "rmattr"
OP_OMAP_SETKEYS = "omap_setkeys"
OP_OMAP_RMKEYS = "omap_rmkeys"
OP_CLONE = "clone"
OP_MKCOLL = "create_collection"
OP_RMCOLL = "remove_collection"
OP_COLL_MOVE = "coll_move"      # reference OP_COLL_MOVE_RENAME (split)
# dedup refcount layer (compress/dedup.py conventions): conditional at
# apply time, so every acting member applies against its own local
# chunk index — the primary never needs to know replica state
OP_DEDUP_INGEST = "dedup_ingest"
OP_DEDUP_RELEASE = "dedup_release"


class Transaction:
    """An ordered opcode stream (reference ``ObjectStore::Transaction``).

    Ops are ``[opcode, cid, oid, *args]`` lists; byte payloads are kept
    as ``bytes`` in memory and hex-encoded only by ``to_dict`` for the
    wire.
    """

    def __init__(self):
        self.ops: list[list] = []

    def __len__(self):
        return len(self.ops)

    def empty(self) -> bool:
        return not self.ops

    # -- builders (the reference's fluent API) ----------------------------
    def touch(self, cid: str, oid: str) -> "Transaction":
        self.ops.append([OP_TOUCH, cid, oid])
        return self

    def write(self, cid: str, oid: str, off: int,
              data: bytes) -> "Transaction":
        self.ops.append([OP_WRITE, cid, oid, off, bytes(data)])
        return self

    def zero(self, cid: str, oid: str, off: int,
             length: int) -> "Transaction":
        self.ops.append([OP_ZERO, cid, oid, off, length])
        return self

    def truncate(self, cid: str, oid: str, size: int) -> "Transaction":
        self.ops.append([OP_TRUNCATE, cid, oid, size])
        return self

    def remove(self, cid: str, oid: str) -> "Transaction":
        self.ops.append([OP_REMOVE, cid, oid])
        return self

    def setattrs(self, cid: str, oid: str,
                 attrs: dict[str, bytes]) -> "Transaction":
        self.ops.append([OP_SETATTRS, cid, oid,
                         {k: bytes(v) for k, v in attrs.items()}])
        return self

    def rmattr(self, cid: str, oid: str, name: str) -> "Transaction":
        self.ops.append([OP_RMATTR, cid, oid, name])
        return self

    def omap_setkeys(self, cid: str, oid: str,
                     kv: dict[str, bytes]) -> "Transaction":
        self.ops.append([OP_OMAP_SETKEYS, cid, oid,
                         {k: bytes(v) for k, v in kv.items()}])
        return self

    def omap_rmkeys(self, cid: str, oid: str,
                    keys: list[str]) -> "Transaction":
        self.ops.append([OP_OMAP_RMKEYS, cid, oid, list(keys)])
        return self

    def coll_move(self, cid: str, oid: str,
                  dest_cid: str) -> "Transaction":
        """Move an object between collections (PG split/merge path —
        reference ``OP_COLL_MOVE_RENAME``)."""
        self.ops.append([OP_COLL_MOVE, cid, oid, dest_cid])
        return self

    def clone(self, cid: str, oid: str, dest: str) -> "Transaction":
        self.ops.append([OP_CLONE, cid, oid, dest])
        return self

    def create_collection(self, cid: str) -> "Transaction":
        self.ops.append([OP_MKCOLL, cid, ""])
        return self

    def remove_collection(self, cid: str) -> "Transaction":
        self.ops.append([OP_RMCOLL, cid, ""])
        return self

    def dedup_ingest(self, cid: str, fp: str,
                     data: bytes) -> "Transaction":
        """Conditionally store a dedup chunk: if ``fp`` is unknown to
        the applying store's index, write the chunk object and set its
        refcount to 1; if known, just bump the refcount (the payload
        is carried either way — apply decides, see memstore)."""
        self.ops.append([OP_DEDUP_INGEST, cid, fp, bytes(data)])
        return self

    def dedup_release(self, cid: str, fp: str) -> "Transaction":
        """Drop one reference to ``fp``; the applying store removes
        the chunk object when its refcount reaches zero."""
        self.ops.append([OP_DEDUP_RELEASE, cid, fp])
        return self

    def append(self, other: "Transaction") -> "Transaction":
        self.ops.extend(other.ops)
        return self

    # -- wire form ---------------------------------------------------------
    # Tagged envelopes keep the decode unambiguous regardless of user
    # key names: a bytes arg becomes {"b": hex}, an attr/omap map
    # becomes {"d": {key: {"b": hex} | value}}.  (A user attr literally
    # named "hex"/"b" can no longer be confused with a payload.)
    def to_dict(self) -> list:
        out = []
        for op in self.ops:
            enc = []
            for a in op:
                if isinstance(a, bytes):
                    enc.append({"b": a.hex()})
                elif isinstance(a, dict):
                    enc.append({"d": {
                        k: {"b": v.hex()} if isinstance(v, bytes) else v
                        for k, v in a.items()}})
                else:
                    enc.append(a)
            out.append(enc)
        return out

    @classmethod
    def from_dict(cls, data: list) -> "Transaction":
        t = cls()
        for op in data:
            dec = []
            for a in op:
                if isinstance(a, dict) and set(a) == {"b"}:
                    dec.append(bytes.fromhex(a["b"]))
                elif isinstance(a, dict) and set(a) == {"d"}:
                    dec.append({
                        k: (bytes.fromhex(v["b"])
                            if isinstance(v, dict) and set(v) == {"b"}
                            else v)
                        for k, v in a["d"].items()})
                else:
                    dec.append(a)
            t.ops.append(dec)
        return t


class Collection:
    """A collection handle: object namespace (≙ one PG's shard on this
    store)."""

    def __init__(self, cid: str):
        self.cid = cid
        self.objects: dict[str, "StoredObject"] = {}


class StoredObject:
    __slots__ = ("data", "xattrs", "omap")

    def __init__(self):
        self.data = bytearray()
        self.xattrs: dict[str, bytes] = {}
        self.omap: dict[str, bytes] = {}


class ObjectStore(abc.ABC):
    """The transactional store API (reference ``src/os/ObjectStore.h``)."""

    # -- lifecycle ---------------------------------------------------------
    def mkfs(self):
        """Initialize an empty store."""

    def mount(self):
        """Load persisted state (no-op for RAM stores)."""

    def umount(self):
        """Flush and release."""

    # -- writes ------------------------------------------------------------
    @abc.abstractmethod
    def queue_transaction(self, txn: Transaction,
                          on_commit: Callable | None = None) -> None:
        """Apply atomically; fire ``on_commit()`` once durable."""

    def apply_transaction(self, txn: Transaction) -> None:
        """Synchronous convenience wrapper."""
        import threading
        ev = threading.Event()
        self.queue_transaction(txn, ev.set)
        ev.wait()

    # -- reads -------------------------------------------------------------
    @abc.abstractmethod
    def read(self, cid: str, oid: str, off: int = 0,
             length: int | None = None) -> bytes:
        """→ data; raises KeyError when the object does not exist."""

    @abc.abstractmethod
    def stat(self, cid: str, oid: str) -> dict:
        """→ {"size": int} or raises KeyError."""

    @abc.abstractmethod
    def getattr(self, cid: str, oid: str, name: str) -> bytes:
        ...

    @abc.abstractmethod
    def getattrs(self, cid: str, oid: str) -> dict[str, bytes]:
        ...

    @abc.abstractmethod
    def omap_get(self, cid: str, oid: str) -> dict[str, bytes]:
        ...

    @abc.abstractmethod
    def exists(self, cid: str, oid: str) -> bool:
        ...

    @abc.abstractmethod
    def list_objects(self, cid: str) -> list[str]:
        ...

    @abc.abstractmethod
    def list_collections(self) -> list[str]:
        ...

    def collection_exists(self, cid: str) -> bool:
        return cid in self.list_collections()
