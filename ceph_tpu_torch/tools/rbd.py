"""rbd CLI — block-image management + bench (reference ``src/tools/
rbd`` and ``rbd bench``; SURVEY.md §3.10).

The port's copy of ``ceph_tpu.tools.rbd``; run it as
``python -m ceph_tpu_torch.tools.rbd``.

    rbd -m HOST:PORT[,...] -p POOL create NAME --size BYTES
        [--order N] [--journaling]
    rbd ... ls | info NAME | rm NAME | resize NAME --size BYTES
    rbd ... snap create NAME@SNAP | snap ls NAME | snap rm NAME@SNAP
    rbd ... export NAME FILE | import FILE NAME
    rbd ... bench NAME --io-type write|read [--io-size N]
        [--io-total N] [--seconds S]
    rbd ... mirror promote NAME | mirror demote NAME

`bench` reports ops/sec and MB/s like the reference's
``rbd bench --io-type write`` summary.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..osdc.librados import Rados
from ..rbd.image import RBD, Image
from .rados import _monmap_from_addrs


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rbd", description=__doc__)
    p.add_argument("-m", "--mon", required=True)
    p.add_argument("-p", "--pool", default="rbd")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("create")
    c.add_argument("name")
    c.add_argument("--size", type=int, required=True)
    c.add_argument("--order", type=int, default=22)
    c.add_argument("--journaling", action="store_true")
    c.add_argument("--mirror-snapshot", action="store_true",
                   help="enable snapshot-based mirroring mode")

    sub.add_parser("ls")
    for name in ("info", "rm"):
        s = sub.add_parser(name)
        s.add_argument("name")

    s = sub.add_parser("resize")
    s.add_argument("name")
    s.add_argument("--size", type=int, required=True)

    s = sub.add_parser("snap")
    s.add_argument("op", choices=["create", "ls", "rm", "protect",
                                  "unprotect"])
    s.add_argument("spec", help="NAME or NAME@SNAP")

    s = sub.add_parser("clone")
    s.add_argument("parent_spec", help="PARENT@SNAP")
    s.add_argument("child")
    s = sub.add_parser("flatten")
    s.add_argument("name")
    s = sub.add_parser("children")
    s.add_argument("parent_spec", help="PARENT@SNAP")

    s = sub.add_parser("export")
    s.add_argument("name")
    s.add_argument("path")
    s = sub.add_parser("export-diff")
    s.add_argument("name", help="NAME or NAME@SNAP (diff endpoint)")
    s.add_argument("path")
    s.add_argument("--from-snap", default=None)
    s = sub.add_parser("import-diff")
    s.add_argument("path")
    s.add_argument("name")
    s = sub.add_parser("import")
    s.add_argument("path")
    s.add_argument("name")

    s = sub.add_parser("bench")
    s.add_argument("name")
    s.add_argument("--io-type", choices=["write", "read"],
                   default="write")
    s.add_argument("--io-size", type=int, default=4096)
    s.add_argument("--io-total", type=int, default=4 << 20)
    s.add_argument("--seconds", type=float, default=10.0)

    s = sub.add_parser("mirror")
    s.add_argument("op", choices=["promote", "demote", "snapshot",
                                  "status"])
    s.add_argument("name")
    return p


def _bench(img: Image, a) -> dict:
    """Sequential-with-wrap I/O loop, reference obj_bencher-style
    summary."""
    import random
    rng = random.Random(0)
    size = img.size()
    if size < a.io_size:
        raise SystemExit("image smaller than --io-size")
    payload = bytes(rng.randrange(256) for _ in range(a.io_size))
    deadline = time.monotonic() + a.seconds
    done = 0
    t0 = time.monotonic()
    offset = 0
    while done < a.io_total and time.monotonic() < deadline:
        if offset + a.io_size > size:
            offset = 0
        if a.io_type == "write":
            img.write(offset, payload)
        else:
            img.read(offset, a.io_size)
        offset += a.io_size
        done += a.io_size
    dt = max(time.monotonic() - t0, 1e-9)
    ios = done // a.io_size
    return {"io_type": a.io_type, "io_size": a.io_size,
            "bytes": done, "seconds": round(dt, 3),
            "ops_per_sec": round(ios / dt, 2),
            "mb_per_sec": round(done / dt / 1e6, 3)}


def main(argv=None) -> int:
    a = build_parser().parse_args(argv)
    r = Rados(_monmap_from_addrs(a.mon)).connect()
    try:
        try:
            io = r.open_ioctx(a.pool)
        except Exception:
            if a.cmd not in ("create", "import"):
                raise SystemExit(f"rbd: pool {a.pool!r} not found")
            # image creation bootstraps its pool (vstart convenience;
            # read-side commands must never create pools as a side
            # effect of a typo)
            r.create_pool(a.pool, pg_num=8)
            io = r.open_ioctx(a.pool)
        rbd = RBD()
        if a.cmd == "create":
            rbd.create(io, a.name, a.size, order=a.order,
                       journaling=a.journaling,
                       mirror_snapshot=a.mirror_snapshot)
            return 0
        if a.cmd == "ls":
            print("\n".join(rbd.list(io)))
            return 0
        if a.cmd == "info":
            with Image(io, a.name, read_only=True) as img:
                print(json.dumps(img.stat(), indent=2))
            return 0
        if a.cmd == "rm":
            rbd.remove(io, a.name)
            return 0
        if a.cmd == "resize":
            with Image(io, a.name) as img:
                img.resize(a.size)
            return 0
        if a.cmd == "snap":
            if a.op == "ls":
                with Image(io, a.spec, read_only=True) as img:
                    for s in img.list_snaps():
                        print(f"{s['id']:>4} {s['name']} "
                              f"{s['size']}")
                return 0
            name, _, snap = a.spec.partition("@")
            if not snap:
                raise SystemExit("snap ops want NAME@SNAP")
            with Image(io, name) as img:
                if a.op == "create":
                    img.create_snap(snap)
                elif a.op == "rm":
                    img.remove_snap(snap)
                elif a.op == "protect":
                    img.protect_snap(snap)
                else:
                    img.unprotect_snap(snap)
            return 0
        if a.cmd == "clone":
            parent, _, snap = a.parent_spec.partition("@")
            if not snap:
                raise SystemExit("clone wants PARENT@SNAP CHILD")
            rbd.clone(io, parent, snap, a.child)
            return 0
        if a.cmd == "flatten":
            with Image(io, a.name) as img:
                img.flatten()
            return 0
        if a.cmd == "children":
            parent, _, snap = a.parent_spec.partition("@")
            print("\n".join(rbd.children(io, parent, snap)))
            return 0
        if a.cmd == "export":
            name, _, snap = a.name.partition("@")
            with Image(io, name, snapshot=snap or None,
                       read_only=True) as img:
                data = img.read(0, img.size())
            with open(a.path, "wb") as f:
                f.write(data)
            print(f"exported {len(data)} bytes")
            return 0
        if a.cmd == "export-diff":
            name, _, snap = a.name.partition("@")
            with Image(io, name, snapshot=snap or None,
                       read_only=True) as img:
                diff = img.export_diff(from_snap=a.from_snap)
            with open(a.path, "w") as f:
                json.dump(diff, f)
            nb = sum(len(e["data"]) // 2 for e in diff["extents"])
            print(f"exported diff: {len(diff['extents'])} extents, "
                  f"{nb} bytes")
            return 0
        if a.cmd == "import-diff":
            with open(a.path) as f:
                diff = json.load(f)
            with Image(io, a.name) as img:
                img.import_diff(diff)
            print("applied diff")
            return 0
        if a.cmd == "import":
            with open(a.path, "rb") as f:
                data = f.read()
            rbd.create(io, a.name, len(data))
            with Image(io, a.name) as img:
                img.write(0, data)
            print(f"imported {len(data)} bytes")
            return 0
        if a.cmd == "bench":
            with Image(io, a.name) as img:
                rep = _bench(img, a)
            print(json.dumps(rep))
            return 0
        if a.cmd == "mirror":
            if a.op == "snapshot":
                # reference `rbd mirror image snapshot`: stamp one
                with Image(io, a.name) as img:
                    print(img.mirror_snapshot_create())
                return 0
            with Image(io, a.name, read_only=True) as img:
                if a.op == "status":
                    print(json.dumps({
                        "mode": img.mirror_mode(),
                        "primary": img.is_primary(),
                        "mirror_snapshots": img.mirror_snapshots(),
                        "peer_synced": img.mirror_snap_committed()}))
                else:
                    (img.promote() if a.op == "promote"
                     else img.demote())
            return 0
        return 1
    finally:
        r.shutdown()


if __name__ == "__main__":
    sys.exit(main())
