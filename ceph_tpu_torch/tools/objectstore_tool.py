"""ceph-objectstore-tool — offline surgery on an OSD's object store.

The port's copy of ``ceph_tpu.tools.objectstore_tool``.

Reference behavior re-created (``src/tools/ceph_objectstore_tool.cc``;
SURVEY.md §3.10): mount a **stopped** OSD's store directly (no daemon,
no cluster) and inspect or repair it.  Supported operations::

    --data-path <wal> --op list-pgs
    --data-path <wal> --op list [--pgid <pgid>]
    --data-path <wal> --op info --pgid <pgid>
    --data-path <wal> --op log --pgid <pgid>
    --data-path <wal> --op export --pgid <pgid> --file <out>
    --data-path <wal> --op import --file <in>
    --data-path <wal> --op remove --pgid <pgid>
    --data-path <wal> --op fsck [--truncate-tail]
    --data-path <wal> <pgid> <oid> dump|get-bytes|remove

The export file is a self-describing JSON snapshot of the PG's
collection (objects with data/xattrs/omap, including the ``_meta``
info+log rows) — the analog of the reference's PG export container
used to re-home a PG onto another OSD (``--op export`` / ``import``).
Imports refuse to clobber an existing collection, like the reference.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..os_store import MemStore, WALStore, walog
from ..os_store.objectstore import Transaction

EXPORT_VERSION = 1


def _mount(path: str) -> WALStore:
    store = WALStore(path)
    store.mount()
    return store


def _pg_collections(store: WALStore, pgid: str | None = None):
    """All collection ids, optionally filtered to one PG (an EC PG's
    shards are ``<pgid>s<n>`` collections; replicated is bare)."""
    out = []
    for cid in sorted(store.list_collections()):
        if pgid is None or cid == pgid or cid.startswith(f"{pgid}s"):
            out.append(cid)
    return out


def export_pg(store: WALStore, pgid: str) -> dict:
    colls = _pg_collections(store, pgid)
    if not colls:
        raise SystemExit(f"PG {pgid} does not exist in this store")
    dump = {"version": EXPORT_VERSION, "pgid": pgid, "collections": {}}
    for cid in colls:
        objs = {}
        for oid in store.list_objects(cid):
            objs[oid] = {
                "data": bytes(store.read(cid, oid)).hex(),
                "xattrs": {k: v.hex()
                           for k, v in store.getattrs(cid, oid).items()},
                "omap": {k: v.hex()
                         for k, v in store.omap_get(cid, oid).items()},
            }
        dump["collections"][cid] = objs
    return dump


def import_pg(store: WALStore, dump: dict):
    if dump.get("version") != EXPORT_VERSION:
        raise SystemExit("unrecognized export file version")
    for cid, objs in dump["collections"].items():
        if store.collection_exists(cid):
            raise SystemExit(f"collection {cid} already exists — "
                             "remove it first (--op remove)")
    for cid, objs in dump["collections"].items():
        t = Transaction().create_collection(cid)
        for oid, o in objs.items():
            t.touch(cid, oid)
            data = bytes.fromhex(o["data"])
            if data:
                t.write(cid, oid, 0, data)
            xattrs = {k: bytes.fromhex(v)
                      for k, v in o["xattrs"].items()}
            if xattrs:
                t.setattrs(cid, oid, xattrs)
            omap = {k: bytes.fromhex(v) for k, v in o["omap"].items()}
            if omap:
                t.omap_setkeys(cid, oid, omap)
        store.queue_transaction(t)


def remove_pg(store: WALStore, pgid: str):
    colls = _pg_collections(store, pgid)
    if not colls:
        raise SystemExit(f"PG {pgid} does not exist in this store")
    for cid in colls:
        t = Transaction()
        for oid in store.list_objects(cid):
            t.remove(cid, oid)
        t.remove_collection(cid)
        store.queue_transaction(t)


def fsck(path: str, truncate_tail: bool = False) -> dict:
    """Offline consistency check of a WALStore file.

    Non-destructive by default: walks the CRC-framed log directly with
    :mod:`walog` (NOT ``WALStore.mount``, which repairs torn tails as a
    side effect), replays every intact record into a throwaway
    :class:`MemStore`, and verifies invariants on the reconstructed
    state — the analog of ``ceph-objectstore-tool --op fsck`` over
    BlueStore's fsck.  With ``truncate_tail=True`` a torn/corrupt tail
    is cut back to the last intact record (the same repair a mount
    would perform).

    Checks:
      * per-record framing + CRC32C (implicit in the log scan);
      * every record decodes as JSON and replays as a valid transaction;
      * dedup chunk refcounts match live manifests, no orphan chunks;
      * each collection's ``_meta`` info/log omap rows parse as JSON.
    """
    import os

    payloads, good_off, tail = walog.scan_path(path)
    try:
        file_size = os.path.getsize(path)
    except OSError:
        file_size = 0
    issues: list[str] = []
    if tail["status"] != "clean":
        issues.append(
            f"{tail['status']} tail at offset {good_off}: "
            f"{tail['error']} ({tail['lost_bytes']} bytes lost)")

    shadow = MemStore()
    shadow.mount()
    replayed = 0
    for i, payload in enumerate(payloads):
        try:
            txn = Transaction.from_dict(json.loads(payload.decode()))
            shadow.queue_transaction(txn)
            replayed += 1
        except Exception as exc:  # noqa: BLE001 — report, keep walking
            issues.append(f"record {i}: replay failed: {exc!r}")

    from ..compress import dedup
    for problem in dedup.verify_refcounts(shadow):
        issues.append(f"dedup: {problem}")
    for cid in sorted(shadow.list_collections()):
        try:
            rows = shadow.omap_get(cid, "_meta")
        except KeyError:
            continue
        for k in ("info", "log", "missing"):
            if k not in rows:
                continue
            try:
                json.loads(rows[k])
            except Exception as exc:  # noqa: BLE001
                issues.append(f"{cid}/_meta[{k}]: unparseable: {exc!r}")

    truncated = False
    if truncate_tail and tail["status"] != "clean" and file_size:
        walog.truncate_tail(path, good_off)
        truncated = True
    n_colls = len(shadow.list_collections())
    shadow.umount()
    return {
        "path": path,
        "file_size": file_size,
        "records": len(payloads),
        "records_replayed": replayed,
        "good_off": good_off,
        "tail": tail,
        "collections": n_colls,
        "issues": issues,
        "truncated": truncated,
    }


def _meta(store: WALStore, cid: str) -> dict:
    try:
        rows = store.omap_get(cid, "_meta")
    except KeyError:
        return {}
    out = {}
    for k in ("info", "log"):
        if k in rows:
            out[k] = json.loads(rows[k])
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ceph-objectstore-tool",
                                description=__doc__)
    p.add_argument("--data-path", required=True,
                   help="the OSD's WALStore file")
    p.add_argument("--op", choices=["list-pgs", "list", "info", "log",
                                    "export", "import", "remove",
                                    "fsck"])
    p.add_argument("--pgid")
    p.add_argument("--file", help="export/import file")
    p.add_argument("--truncate-tail", action="store_true",
                   help="with --op fsck: repair a torn/corrupt tail by "
                        "truncating to the last intact record")
    p.add_argument("positional", nargs="*",
                   help="<pgid> <oid> dump|get-bytes|remove")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.op == "fsck":
        # fsck never mounts — mounting repairs torn tails, and an fsck
        # must observe (not destroy) the evidence unless asked.
        report = fsck(args.data_path,
                      truncate_tail=args.truncate_tail)
        print(json.dumps(report, indent=1, sort_keys=True))
        bad = report["issues"]
        if report["truncated"]:  # tail damage was just repaired
            bad = [i for i in bad
                   if not i.startswith(("torn tail", "corrupt tail"))]
        return 1 if bad else 0
    store = _mount(args.data_path)
    try:
        if args.op == "list-pgs":
            seen = []
            for cid in _pg_collections(store):
                base = cid.split("s", 1)[0] if "s" in cid else cid
                if base not in seen:
                    seen.append(base)
            print("\n".join(seen))
            return 0
        if args.op == "list":
            for cid in _pg_collections(store, args.pgid):
                for oid in sorted(store.list_objects(cid)):
                    print(json.dumps([cid, oid]))
            return 0
        if args.op == "info":
            if not args.pgid:
                raise SystemExit("--op info requires --pgid")
            for cid in _pg_collections(store, args.pgid):
                m = _meta(store, cid)
                if "info" in m:
                    print(json.dumps(m["info"], indent=1,
                                     sort_keys=True))
                    return 0
            raise SystemExit(f"no info for PG {args.pgid}")
        if args.op == "log":
            if not args.pgid:
                raise SystemExit("--op log requires --pgid")
            for cid in _pg_collections(store, args.pgid):
                m = _meta(store, cid)
                if "log" in m:
                    print(json.dumps(m["log"], indent=1,
                                     sort_keys=True))
                    return 0
            raise SystemExit(f"no log for PG {args.pgid}")
        if args.op == "export":
            if not (args.pgid and args.file):
                raise SystemExit("--op export requires --pgid --file")
            dump = export_pg(store, args.pgid)
            with open(args.file, "w") as f:
                json.dump(dump, f)
            n = sum(len(o) for o in dump["collections"].values())
            print(f"Export successful: {args.pgid} "
                  f"({n} objects)")
            return 0
        if args.op == "import":
            if not args.file:
                raise SystemExit("--op import requires --file")
            with open(args.file) as f:
                dump = json.load(f)
            import_pg(store, dump)
            print(f"Import successful: {dump['pgid']}")
            return 0
        if args.op == "remove":
            if not args.pgid:
                raise SystemExit("--op remove requires --pgid")
            remove_pg(store, args.pgid)
            print(f"Remove successful: {args.pgid}")
            return 0
        # object-level positional form
        if len(args.positional) == 3:
            pgid, oid, cmd = args.positional
            cids = [c for c in _pg_collections(store, pgid)
                    if store.exists(c, oid)]
            if not cids:
                raise SystemExit(f"object {oid!r} not found in {pgid}")
            cid = cids[0]
            if cmd == "dump":
                print(json.dumps({
                    "cid": cid, "oid": oid,
                    "size": store.stat(cid, oid)["size"],
                    "xattrs": {k: v.hex() for k, v in
                               store.getattrs(cid, oid).items()},
                    "omap_keys": sorted(store.omap_get(cid, oid)),
                }, indent=1, sort_keys=True))
            elif cmd == "get-bytes":
                sys.stdout.buffer.write(bytes(store.read(cid, oid)))
            elif cmd == "remove":
                store.queue_transaction(
                    Transaction().remove(cid, oid))
                print(f"removed {cid}/{oid}")
            else:
                raise SystemExit(f"unknown object command {cmd!r}")
            return 0
        raise SystemExit("nothing to do (see --help)")
    finally:
        store.umount()


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:      # e.g. `... --op list | head`
        sys.exit(141)
