"""monmaptool — create/inspect/edit monmap files.

The port's copy of ``ceph_tpu.tools.monmaptool``.

Reference behavior re-created (``src/tools/monmaptool.cc``; SURVEY.md
§3.10): a monmap file names the monitor quorum (rank → address) that
every daemon and client bootstraps from.  Supported operations mirror
the reference CLI::

    monmaptool --create [--add <rank> <host:port>]... <file>
    monmaptool --add <rank> <host:port> <file>
    monmaptool --rm <rank> <file>
    monmaptool --print <file>

Edits bump the epoch, as the reference does.  The on-disk format is
the JSON of ``MonMap.to_dict()`` — the same dict the wire protocol
carries in MMonMap.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..mon.monitor import MonMap
from ..msg import EntityAddr


def load_monmap(path: str) -> MonMap:
    with open(path) as f:
        return MonMap.from_dict(json.load(f))


def save_monmap(path: str, m: MonMap):
    with open(path, "w") as f:
        json.dump(m.to_dict(), f, indent=1, sort_keys=True)
        f.write("\n")


def _parse_addr(s: str) -> EntityAddr:
    host, _, port = s.rpartition(":")
    if not host or not port.isdigit():
        raise SystemExit(f"invalid address {s!r} (want host:port)")
    return EntityAddr(host, int(port))


def format_monmap(m: MonMap) -> str:
    lines = [f"epoch {m.epoch}", f"num_mons {len(m.mons)}"]
    for r in m.ranks():
        a = m.mons[r]
        lines.append(f"mon.{r} {a.host}:{a.port}")
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="monmaptool", description=__doc__)
    p.add_argument("--create", action="store_true",
                   help="create a new (empty) monmap")
    p.add_argument("--add", nargs=2, action="append", default=[],
                   metavar=("RANK", "ADDR"),
                   help="add mon RANK at host:port")
    p.add_argument("--rm", action="append", default=[], metavar="RANK",
                   help="remove mon RANK")
    p.add_argument("--print", action="store_true", dest="show",
                   help="print the monmap")
    p.add_argument("--clobber", action="store_true",
                   help="with --create, overwrite an existing file")
    p.add_argument("mapfile")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import os
    if args.create:
        if os.path.exists(args.mapfile) and not args.clobber:
            print(f"monmaptool: {args.mapfile} exists, "
                  "--clobber to overwrite", file=sys.stderr)
            return 1
        m = MonMap(epoch=0, mons={})
    else:
        try:
            m = load_monmap(args.mapfile)
        except FileNotFoundError:
            print(f"monmaptool: couldn't open {args.mapfile}",
                  file=sys.stderr)
            return 1
    changed = args.create
    for rank_s, addr_s in args.add:
        rank = int(rank_s)
        if rank in m.mons:
            print(f"monmaptool: mon.{rank} already exists",
                  file=sys.stderr)
            return 1
        m.mons[rank] = _parse_addr(addr_s)
        changed = True
    for rank_s in args.rm:
        rank = int(rank_s)
        if rank not in m.mons:
            print(f"monmaptool: mon.{rank} does not exist",
                  file=sys.stderr)
            return 1
        del m.mons[rank]
        changed = True
    if changed:
        m.epoch += 1
        save_monmap(args.mapfile, m)
        print(f"monmaptool: writing epoch {m.epoch} to "
              f"{args.mapfile} ({len(m.mons)} monitors)")
    if args.show:
        print(format_monmap(m))
    return 0


if __name__ == "__main__":
    sys.exit(main())
