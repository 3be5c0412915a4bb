"""Dedup index conventions — a copy of ``ceph_tpu.compress.dedup``.

The chunk store is one collection per OSD (``dedup``) holding
``chunk_<fp>`` objects, with refcounts in the omap of one index object;
each stored object becomes a manifest of ``[fp, length]`` entries.  A
chunk object's bytes are a self-describing frame (raw, or a compression
header and blob), so any reader can expand any frame, whichever package
wrote it.  The port has no object store yet: the store helpers take any
object with ``omap_get``/``stat``/``list_collections``/``list_objects``/
``getattr``, as ``ceph_tpu``'s do.
"""

from __future__ import annotations

import collections
import json

DEDUP_COLL = "dedup"
DEDUP_INDEX_OID = "_dedup_index"
CHUNK_PREFIX = "chunk_"


def chunk_oid(fp: str) -> str:
    return CHUNK_PREFIX + fp


# -- chunk frames -----------------------------------------------------------
# A chunk object's stored bytes are self-describing: a 1-byte tag, then
# either the raw chunk or a compression header + blob.  Self-description
# matters because ingest is conditional — the FIRST writer of a
# fingerprint decides the stored form, and later manifests referencing
# the same chunk may have been written under different pool compression
# settings.  Any reader can expand any frame.

def frame_raw(chunk: bytes) -> bytes:
    return b"\x00" + bytes(chunk)


def frame_sealed(blob: bytes, header: dict) -> bytes:
    hdr = json.dumps(header, separators=(",", ":")).encode()
    return b"\x01" + len(hdr).to_bytes(4, "big") + hdr + bytes(blob)


def unframe(frame: bytes) -> tuple[bytes, dict | None]:
    """→ (payload, header).  header None ⇒ payload IS the raw chunk;
    otherwise payload is a compressed blob to expand with header."""
    frame = bytes(frame)
    if not frame:
        raise ValueError("empty dedup chunk frame")
    if frame[0] == 0:
        return frame[1:], None
    if frame[0] != 1:
        raise ValueError(f"bad dedup chunk frame tag {frame[0]}")
    n = int.from_bytes(frame[1:5], "big")
    header = json.loads(frame[5:5 + n].decode())
    return frame[5 + n:], header


def manifest_entries(meta: dict | None) -> list:
    """The ``[[fp, length], ...]`` manifest from an object's "_" meta
    (empty when the object is not dedup-sealed)."""
    if not meta:
        return []
    return list(meta.get("dedup") or [])


def index_refcounts(store) -> dict[str, int]:
    """fp → live refcount from a store's dedup index."""
    try:
        omap = store.omap_get(DEDUP_COLL, DEDUP_INDEX_OID)
    except KeyError:
        return {}
    return {fp: int(bytes(v)) for fp, v in omap.items()}


def dedup_stats(store) -> dict:
    """Physical vs referenced (logical) bytes of a store's chunk set."""
    refs = index_refcounts(store)
    stored = 0
    referenced = 0
    for fp, n in refs.items():
        try:
            size = store.stat(DEDUP_COLL, chunk_oid(fp))["size"]
        except KeyError:
            size = 0
        stored += size
        referenced += size * n
    return {"chunks": len(refs), "refs": sum(refs.values()),
            "stored_bytes": stored, "referenced_bytes": referenced}


def expected_refcounts(store) -> collections.Counter:
    """fp → reference count implied by every live manifest in the
    store (all collections, all objects) — the ground truth the index
    must match."""
    expect: collections.Counter = collections.Counter()
    for cid in store.list_collections():
        if cid == DEDUP_COLL:
            continue
        for oid in store.list_objects(cid):
            try:
                meta = json.loads(bytes(store.getattr(cid, oid, "_")))
            except (KeyError, ValueError):
                continue
            for fp, _ln in manifest_entries(meta):
                expect[fp] += 1
    return expect


def verify_refcounts(store) -> list[str]:
    """Leak check: [] when the index exactly matches the live
    manifests and no orphan chunk objects remain."""
    problems = []
    refs = index_refcounts(store)
    expect = expected_refcounts(store)
    for fp in sorted(set(refs) | set(expect)):
        have, want = refs.get(fp, 0), expect.get(fp, 0)
        if have != want:
            problems.append(
                f"fp {fp}: refcount {have} != {want} live references")
    try:
        objs = store.list_objects(DEDUP_COLL)
    except KeyError:
        objs = []
    for oid in objs:
        if oid == DEDUP_INDEX_OID:
            continue
        fp = oid[len(CHUNK_PREFIX):]
        if refs.get(fp, 0) <= 0:
            problems.append(f"orphan chunk object {oid}")
    return problems
