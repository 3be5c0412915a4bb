"""rados CLI — pool/object operations and the classic RADOS benchmark.

The port's copy of ``ceph_tpu.tools.rados``.

Reference behavior re-created (``src/tools/rados/rados.cc`` + the
bench engine ``src/common/obj_bencher.cc``; SURVEY.md §3.10):

    rados -m HOST:PORT[,HOST:PORT...] lspools
    rados -m ... mkpool POOL [--size N] [--pg-num N]
    rados -m ... -p POOL put OBJ FILE | get OBJ FILE | rm OBJ
    rados -m ... -p POOL ls | stat OBJ
    rados -m ... list-inconsistent-obj PGID
    rados -m ... -p POOL bench SECONDS write|seq|rand \\
          [-b BLOCKSIZE] [-t CONCURRENCY] [--no-cleanup] [--json]

``bench write`` drives -t concurrent object writes of -b bytes for
SECONDS and prints the reference-style report (bandwidth MB/s, IOPS,
latency); ``seq``/``rand`` read the benchmark objects back.  The
summary is also emitted as one JSON line with --json so harnesses can
consume it (BASELINE.md row "RADOS MB/s & IOPS").
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..msg import EntityAddr
from ..mon.monitor import MonMap
from ..osdc.librados import Rados

BENCH_PREFIX = "benchmark_data"


def _monmap_from_addrs(spec: str) -> MonMap:
    mons = {}
    for i, hp in enumerate(spec.split(",")):
        host, _, port = hp.strip().rpartition(":")
        mons[i] = EntityAddr(host or "127.0.0.1", int(port))
    return MonMap(mons=mons)


def _connect(args) -> Rados:
    if not args.mon:
        raise SystemExit("rados: -m HOST:PORT required")
    return Rados(_monmap_from_addrs(args.mon)).connect()


class ObjBencher:
    """The obj_bencher engine: windowed async I/O + periodic report."""

    def __init__(self, io, *, block_size: int, concurrency: int,
                 out=sys.stdout):
        self.io = io
        self.block = block_size
        self.window = concurrency
        self.out = out

    def _report_header(self, mode: str, secs: int):
        print(f"  sec Cur ops   started  finished  avg MB/s  "
              f"cur MB/s last lat(s)  avg lat(s)", file=self.out)

    def _drain(self, pending, limit):
        lat = []
        while len(pending) > limit:
            comp, t0 = pending.pop(0)
            comp.wait_for_complete(30)
            if comp.rc not in (0, None):
                raise RuntimeError(f"bench I/O failed rc={comp.rc}")
            lat.append(time.perf_counter() - t0)
        return lat

    def run(self, mode: str, seconds: int, run_id: str) -> dict:
        payload = bytes(
            (i * 131 + 17) & 0xFF for i in range(self.block))
        start = time.perf_counter()
        deadline = start + seconds
        pending: list = []
        lats: list[float] = []
        done = started = 0
        last_tick = start
        self._report_header(mode, seconds)
        objs: list[str] = []
        if mode in ("seq", "rand"):
            objs = [o for o in self.io.list_objects()
                    if o.startswith(f"{BENCH_PREFIX}_{run_id}_")]
            if not objs:
                raise SystemExit(
                    "no benchmark objects — run `bench write "
                    "--no-cleanup` first")
        i = 0
        import random
        while time.perf_counter() < deadline:
            if mode == "write":
                oid = f"{BENCH_PREFIX}_{run_id}_{i}"
                comp = self.io.aio_write_full(oid, payload)
            else:
                oid = (objs[i % len(objs)] if mode == "seq"
                       else random.choice(objs))
                comp = self.io.aio_read(oid)
            pending.append((comp, time.perf_counter()))
            started += 1
            i += 1
            got = self._drain(pending, self.window - 1)
            lats.extend(got)
            done += len(got)
            now = time.perf_counter()
            if now - last_tick >= 1.0:
                el = now - start
                mbps = done * self.block / el / 1e6
                print(f"{int(el):5d} {len(pending):7d} {started:9d} "
                      f"{done:9d} {mbps:9.2f} {mbps:9.2f} "
                      f"{lats[-1] if lats else 0:11.4f} "
                      f"{(sum(lats)/len(lats)) if lats else 0:11.4f}",
                      file=self.out)
                last_tick = now
        lats.extend(self._drain(pending, 0))
        done = started
        elapsed = time.perf_counter() - start
        total_mb = done * self.block / 1e6
        summary = {
            "mode": mode, "seconds": round(elapsed, 3),
            "ops": done, "block_bytes": self.block,
            "total_MB": round(total_mb, 3),
            "bandwidth_MBps": round(total_mb / elapsed, 3),
            "iops": round(done / elapsed, 1),
            "avg_latency_s": round(sum(lats) / len(lats), 5)
            if lats else 0.0,
            "max_latency_s": round(max(lats), 5) if lats else 0.0,
        }
        print(f"Total time run:       {summary['seconds']}\n"
              f"Total {mode}s made:    {done}\n"
              f"{mode.capitalize()} size:           {self.block}\n"
              f"Bandwidth (MB/sec):   {summary['bandwidth_MBps']}\n"
              f"Average IOPS:         {summary['iops']}\n"
              f"Average Latency(s):   {summary['avg_latency_s']}\n"
              f"Max latency(s):       {summary['max_latency_s']}",
              file=self.out)
        return summary

    def cleanup(self, run_id: str):
        for o in self.io.list_objects():
            if o.startswith(f"{BENCH_PREFIX}_{run_id}_"):
                self.io.remove(o)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="rados", description=__doc__)
    p.add_argument("-m", "--mon", help="mon addrs host:port[,...]")
    p.add_argument("-p", "--pool", help="pool name")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("lspools")
    mk = sub.add_parser("mkpool")
    mk.add_argument("name")
    mk.add_argument("--size", type=int, default=3)
    mk.add_argument("--pg-num", type=int, default=8)
    rm = sub.add_parser("rmpool")
    rm.add_argument("name")
    put = sub.add_parser("put")
    put.add_argument("obj")
    put.add_argument("file")
    get = sub.add_parser("get")
    get.add_argument("obj")
    get.add_argument("file")
    rmo = sub.add_parser("rm")
    rmo.add_argument("obj")
    sub.add_parser("ls")
    st = sub.add_parser("stat")
    st.add_argument("obj")
    for name in ("listomapkeys", "listxattr"):
        x = sub.add_parser(name)
        x.add_argument("obj")
    for name in ("getomapval", "getxattr"):
        x = sub.add_parser(name)
        x.add_argument("obj")
        x.add_argument("key")
    for name in ("setomapval", "setxattr"):
        x = sub.add_parser(name)
        x.add_argument("obj")
        x.add_argument("key")
        x.add_argument("value")
    cf = sub.add_parser("cache-flush-evict-all")
    cf.add_argument("base_pool")
    li = sub.add_parser("list-inconsistent-obj")
    li.add_argument("pgid")
    be = sub.add_parser("bench")
    be.add_argument("seconds", type=int)
    be.add_argument("mode", choices=["write", "seq", "rand"])
    be.add_argument("-b", "--block-size", type=int, default=1 << 16)
    be.add_argument("-t", "--concurrency", type=int, default=16)
    be.add_argument("--run-id", default="cli")
    be.add_argument("--no-cleanup", action="store_true")
    be.add_argument("--json", action="store_true")
    return p


def _write_bytes(data: bytes):
    """Binary-safe stdout write that degrades to text when stdout has
    been swapped for a StringIO (test capture)."""
    buf = getattr(sys.stdout, "buffer", None)
    if buf is not None:
        buf.write(data)
    else:
        sys.stdout.write(data.decode(errors="replace"))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    r = _connect(args)
    try:
        if args.cmd == "lspools":
            for name in r.list_pools():
                print(name)
            return 0
        if args.cmd == "mkpool":
            r.create_pool(args.name, pg_num=args.pg_num,
                          size=args.size)
            print(f"successfully created pool {args.name}")
            return 0
        if args.cmd == "rmpool":
            r.delete_pool(args.name)
            print(f"successfully deleted pool {args.name}")
            return 0
        if args.cmd == "cache-flush-evict-all":
            n = r.cache_flush_evict_all(args.base_pool)
            print(f"flushed and evicted {n} objects")
            return 0
        if args.cmd == "list-inconsistent-obj":
            rc, outs, outb = r.mon_command(
                {"prefix": "pg list-inconsistent-obj",
                 "pgid": args.pgid})
            if outb is not None:
                print(json.dumps(outb, indent=2, default=str))
            if outs:
                print(outs, file=sys.stderr)
            return 0 if rc == 0 else 1
        if not args.pool:
            raise SystemExit("rados: -p POOL required")
        io = r.open_ioctx(args.pool)
        if args.cmd == "put":
            with open(args.file, "rb") as f:
                io.write_full(args.obj, f.read())
        elif args.cmd == "get":
            data = io.read(args.obj)
            with open(args.file, "wb") as f:
                f.write(data)
        elif args.cmd == "rm":
            io.remove(args.obj)
        elif args.cmd == "ls":
            for o in sorted(io.list_objects()):
                print(o)
        elif args.cmd == "stat":
            st = io.stat(args.obj)
            print(f"{args.pool}/{args.obj} size {st['size']}")
        elif args.cmd == "listomapkeys":
            for k in io.omap_get_keys(args.obj):
                print(k)
        elif args.cmd == "getomapval":
            kv = io.omap_get(args.obj, keys=[args.key])
            if args.key not in kv:
                raise SystemExit(f"no omap key {args.key!r}")
            _write_bytes(bytes(kv[args.key]))
            print()
        elif args.cmd == "setomapval":
            io.omap_set(args.obj, {args.key: args.value.encode()})
        elif args.cmd == "listxattr":
            for k in sorted(io.getxattrs(args.obj)):
                print(k)
        elif args.cmd == "getxattr":
            _write_bytes(bytes(io.getxattr(args.obj, args.key)))
            print()
        elif args.cmd == "setxattr":
            io.setxattr(args.obj, args.key, args.value.encode())
        elif args.cmd == "bench":
            bench = ObjBencher(io, block_size=args.block_size,
                               concurrency=args.concurrency)
            summary = bench.run(args.mode, args.seconds, args.run_id)
            if args.mode == "write" and not args.no_cleanup:
                bench.cleanup(args.run_id)
            if args.json:
                print(json.dumps(summary))
        return 0
    finally:
        r.shutdown()


if __name__ == "__main__":
    sys.exit(main())
