"""ceph-kvstore-tool — offline surgery on a monitor's KV store.

The port's copy of ``ceph_tpu.tools.kvstore_tool``.

Reference behavior re-created (``src/tools/ceph_kvstore_tool.cc``;
SURVEY.md §3.10): open a **stopped** mon's ``MonitorDBStore`` WAL
directly and list / read / write / delete rows, or copy the whole
store to a fresh compacted file (the reference's ``store-copy``, used
to rescue a mon whose store grew torn or bloated)::

    kvstore-tool <wal> list [prefix]
    kvstore-tool <wal> get <prefix> <key> [out <file>]
    kvstore-tool <wal> set <prefix> <key> in <file>
    kvstore-tool <wal> set <prefix> <key> val <string>
    kvstore-tool <wal> rm <prefix> <key>
    kvstore-tool <wal> store-copy <dest-wal>
"""

from __future__ import annotations

import argparse
import sys

from ..mon.store import MonitorDBStore, StoreTransaction


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ceph-kvstore-tool",
                                description=__doc__)
    p.add_argument("store")
    p.add_argument("command",
                   choices=["list", "get", "set", "rm", "store-copy"])
    p.add_argument("args", nargs="*")
    args = p.parse_args(argv)

    db = MonitorDBStore(args.store, sync=False)
    try:
        if args.command == "list":
            want = args.args[0] if args.args else None
            for prefix in sorted(db._data):
                if want is not None and prefix != want:
                    continue
                for key in db.keys(prefix):
                    print(f"{prefix}\t{key}")
            return 0
        if args.command == "get":
            if len(args.args) < 2:
                raise SystemExit("get <prefix> <key> [out <file>]")
            prefix, key = args.args[0], args.args[1]
            v = db.get(prefix, key)
            if v is None:
                print(f"({prefix}, {key}) does not exist",
                      file=sys.stderr)
                return 1
            if len(args.args) >= 4 and args.args[2] == "out":
                with open(args.args[3], "wb") as f:
                    f.write(v)
                print(f"wrote {len(v)} bytes to {args.args[3]}")
            else:
                print(v.hex())
            return 0
        if args.command == "set":
            if len(args.args) != 4 or args.args[2] not in ("in", "val"):
                raise SystemExit(
                    "set <prefix> <key> in <file> | val <string>")
            prefix, key, mode, src = args.args
            value = (open(src, "rb").read() if mode == "in"
                     else src.encode())
            t = StoreTransaction()
            t.put(prefix, key, value)
            db.apply_transaction(t)
            print(f"set ({prefix}, {key}) = {len(value)} bytes")
            return 0
        if args.command == "rm":
            if len(args.args) != 2:
                raise SystemExit("rm <prefix> <key>")
            prefix, key = args.args
            if db.get(prefix, key) is None:
                print(f"({prefix}, {key}) does not exist",
                      file=sys.stderr)
                return 1
            t = StoreTransaction()
            t.erase(prefix, key)
            db.apply_transaction(t)
            print(f"removed ({prefix}, {key})")
            return 0
        if args.command == "store-copy":
            if len(args.args) != 1:
                raise SystemExit("store-copy <dest-wal>")
            import os
            dest = args.args[0]
            if os.path.exists(dest):
                raise SystemExit(f"{dest} already exists")
            out = MonitorDBStore(dest, sync=False)
            try:
                n = 0
                for prefix in sorted(db._data):
                    t = StoreTransaction()
                    for key in db.keys(prefix):
                        t.put(prefix, key, db.get(prefix, key))
                        n += 1
                    if not t.empty():
                        out.apply_transaction(t)
                print(f"copied {n} keys to {dest}")
            finally:
                out.close()
            return 0
        raise SystemExit("nothing to do")
    finally:
        db.close()


if __name__ == "__main__":
    sys.exit(main())
