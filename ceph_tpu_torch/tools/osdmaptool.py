"""osdmaptool — offline OSDMap operations; ``--test-map-pgs`` is the
north-star CRUSH harness (SURVEY.md §4.5).

Reference: ``src/tools/osdmaptool.cc``.  The reference enumerates every
PG of every pool and maps each through scalar ``crush_do_rule`` one at a
time, single-threaded; here a pool's whole PG batch maps through the
port's `BatchMapper`, one K7 straw2 launch per descent level on the
card (``--device``, default ``cuda``; ``--device cpu`` runs the plain
versions).  ``--scalar`` maps with the scalar oracle instead; it is
never taken on its own.  ``--upmap FILE`` runs the upmap balancer
(``mgr.balancer.UpmapBalancer``) on the same engine and writes its
proposed ``ceph osd pg-upmap-items`` commands to FILE.

Usage::

    osdmaptool --createsimple 256 map.json --pg-bits 6
    osdmaptool map.json --test-map-pgs [--pool 0] [--device cpu]
    osdmaptool map.json --test-map-object foo --pool 0
    osdmaptool map.json --upmap out.txt [--upmap-pool 0] [--upmap-max 100]
    osdmaptool map.json --mark-out 3 -o map2.json
    osdmaptool map.json --export-crush crush.json
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..crush.compiler import crushmap_from_dict, crushmap_to_dict
from ..crush.map import CRUSH_ITEM_NONE
from ..crush.mapper import do_rule
from ..osd.osdmap import (EXISTS, UP, OSDMap, PGPool, PGid, TYPE_ERASURE,
                          TYPE_REPLICATED)
from ._engine import BatchedRequired, announce, declined


def osdmap_to_dict(m: OSDMap) -> dict:
    return {
        "version": 1,
        "epoch": m.epoch,
        "max_osd": m.max_osd,
        "osd_state": m.osd_state,
        "osd_weight": m.osd_weight,
        "osd_up_thru": m.osd_up_thru,
        "flags": m.flags,
        "crush": crushmap_to_dict(m.crush),
        "pools": [{
            "id": p.id, "name": p.name, "type": p.type, "size": p.size,
            "min_size": p.min_size, "pg_num": p.pg_num,
            "pgp_num": p.pgp_num, "crush_rule": p.crush_rule,
            "flags": p.flags, "last_change": p.last_change,
            "erasure_code_profile": p.erasure_code_profile,
            "snap_seq": p.snap_seq,
            "snaps": {str(i): n for i, n in p.snaps.items()},
            "quota_max_objects": p.quota_max_objects,
            "quota_max_bytes": p.quota_max_bytes,
            "full": p.full,
            "tier_of": p.tier_of, "read_tier": p.read_tier,
            "write_tier": p.write_tier, "cache_mode": p.cache_mode,
            "tiers": list(p.tiers),
            "is_stretch": p.is_stretch,
            "stretch_min_size": p.stretch_min_size,
            "compression_mode": p.compression_mode,
            "compression_algorithm": p.compression_algorithm,
            "dedup_enable": p.dedup_enable,
        } for p in m.pools.values()],
        "stretch": {
            "enabled": m.stretch_mode_enabled,
            "bucket_type": m.stretch_bucket_type,
            "sites": {s: list(o) for s, o in m.stretch_sites.items()},
            "tiebreaker": m.stretch_tiebreaker,
            "degraded": m.degraded_stretch_mode,
            "recovering": m.recovering_stretch_mode,
            "degraded_site": m.stretch_degraded_site,
        },
        "pg_temp": {str(pg): osds for pg, osds in m.pg_temp.items()},
        "primary_temp": {str(pg): o for pg, o in m.primary_temp.items()},
        "pg_upmap": {str(pg): osds for pg, osds in m.pg_upmap.items()},
        "pg_upmap_items": {str(pg): [list(pair) for pair in pairs]
                           for pg, pairs in m.pg_upmap_items.items()},
        "erasure_code_profiles": m.erasure_code_profiles,
        "osd_addrs": {str(o): a for o, a in m.osd_addrs.items()},
    }


def osdmap_from_dict(d: dict) -> OSDMap:
    m = OSDMap(crush=crushmap_from_dict(d["crush"]), max_osd=d["max_osd"])
    m.epoch = d["epoch"]
    m.osd_state = list(d["osd_state"])
    m.osd_weight = list(d["osd_weight"])
    m.osd_up_thru = list(d.get("osd_up_thru", [])) or [0] * d["max_osd"]
    m.flags = d.get("flags", 0)
    for p in d["pools"]:
        p = dict(p)
        p["snaps"] = {int(i): n
                      for i, n in (p.get("snaps") or {}).items()}
        pool = PGPool(**p)
        m.pools[pool.id] = pool
        m.pool_name[pool.name] = pool.id
    m.pg_temp = {PGid.parse(s): list(v)
                 for s, v in d.get("pg_temp", {}).items()}
    m.primary_temp = {PGid.parse(s): v
                      for s, v in d.get("primary_temp", {}).items()}
    m.pg_upmap = {PGid.parse(s): list(v)
                  for s, v in d.get("pg_upmap", {}).items()}
    m.pg_upmap_items = {
        PGid.parse(s): [tuple(pair) for pair in v]
        for s, v in d.get("pg_upmap_items", {}).items()}
    m.erasure_code_profiles = d.get("erasure_code_profiles", {})
    m.osd_addrs = {int(o): a for o, a in d.get("osd_addrs", {}).items()}
    st = d.get("stretch")
    if st:
        m.stretch_mode_enabled = bool(st.get("enabled", False))
        m.stretch_bucket_type = int(st.get("bucket_type", 0))
        m.stretch_sites = {s: [int(o) for o in osds]
                           for s, osds in (st.get("sites") or {}).items()}
        m.stretch_tiebreaker = st.get("tiebreaker", "")
        m.degraded_stretch_mode = bool(st.get("degraded", False))
        m.recovering_stretch_mode = bool(st.get("recovering", False))
        m.stretch_degraded_site = st.get("degraded_site", "")
    return m


def load_osdmap(path: str) -> OSDMap:
    with open(path) as f:
        return osdmap_from_dict(json.load(f))


def save_osdmap(m: OSDMap, path: str):
    with open(path, "w") as f:
        json.dump(osdmap_to_dict(m), f)
        f.write("\n")


def map_pool_pgs(m: OSDMap, pool: PGPool, scalar: bool = False,
                 device=None, engines: list | None = None) -> np.ndarray:
    """Map every PG of a pool → [pg_num, size] int32 device matrix
    (CRUSH only — upmap/pg_temp overrides applied by the caller if
    needed).  The batched path computes the pps seeds vectorized, then
    maps them all through the pool's `BatchMapper` on ``device``
    (``None``: the card).  ``scalar`` maps with the oracle instead.

    A rule the batched mapper declines raises `BatchedRequired`;
    `engines`, when given, collects which engine ran."""
    seeds = np.arange(pool.pg_num, dtype=np.uint32)
    pps = pool.raw_pg_to_pps_batch(seeds)
    rule = m.crush.rule_by_id(pool.crush_rule)
    if not scalar:
        try:
            # the OSDMap-level cache: repeated sweeps (--test-map-pgs
            # after a reweight) rebind one mapper via set_weights
            bm = m.batch_mapper(rule.id, pool.size, device=device)
        except (NotImplementedError, ValueError) as e:
            declined("osdmaptool", f"pool {pool.id} rule {rule.id}", e)
        out = bm(pps, np.asarray(m.osd_weight, dtype=np.uint32))
        if engines is not None:
            engines.append(f"batched ({bm.device.type})")
        return out
    if engines is not None:
        engines.append("scalar-oracle")
    rows = [do_rule(m.crush, rule, int(x), pool.size, m.osd_weight)
            for x in pps]
    out = np.full((len(rows), pool.size), CRUSH_ITEM_NONE, dtype=np.int32)
    for i, row in enumerate(rows):
        out[i, :len(row)] = row
    return out


def run_test_map_pgs(m: OSDMap, pool_id: int | None, *, scalar: bool = False,
                     device=None, out=None) -> dict:
    """The reference's --test-map-pgs report (to ``out``, default
    stdout): per-OSD PG counts, first/primary counts,
    min/max/avg/stddev, size histogram."""
    out = sys.stdout if out is None else out
    pools = ([m.pools[pool_id]] if pool_id is not None
             else list(m.pools.values()))
    engines: list[str] = []
    count = np.zeros(m.max_osd, dtype=np.int64)
    first = np.zeros(m.max_osd, dtype=np.int64)
    primary = np.zeros(m.max_osd, dtype=np.int64)
    size_hist: dict[int, int] = {}
    total_pgs = 0
    t0 = time.perf_counter()
    for pool in pools:
        print(f"pool {pool.id} pg_num {pool.pg_num}", file=out)
        total_pgs += pool.pg_num
        res = map_pool_pgs(m, pool, scalar=scalar, device=device,
                           engines=engines)
        # apply upmap/pg_temp overrides (host-side; they are sparse)
        overrides = (set(m.pg_upmap) | set(m.pg_upmap_items)
                     | set(m.pg_temp) | set(m.primary_temp))
        for pg in overrides:
            if pg.pool == pool.id and pg.seed < pool.pg_num:
                up, up_p, acting, acting_p = m.pg_to_up_acting_osds(pg)
                row = np.full(pool.size, CRUSH_ITEM_NONE, dtype=np.int32)
                n = min(len(acting), pool.size)
                row[:n] = acting[:n]
                res[pg.seed] = row
        # count only up OSDs — matches pg_to_up_acting_osds's up filtering
        up_mask = np.array([m.is_up(o) for o in range(m.max_osd)],
                           dtype=bool)
        valid = res != CRUSH_ITEM_NONE
        valid &= up_mask[np.clip(res, 0, m.max_osd - 1)]
        np.add.at(count, res[valid], 1)
        fcol = res[np.arange(len(res)), valid.argmax(axis=1)]
        fvalid = (fcol != CRUSH_ITEM_NONE) & valid.any(axis=1)
        np.add.at(first, fcol[fvalid], 1)
        np.add.at(primary, fcol[fvalid], 1)   # no primary-affinity yet
        sizes, freqs = np.unique(valid.sum(axis=1), return_counts=True)
        for s, f in zip(sizes, freqs):
            size_hist[int(s)] = size_hist.get(int(s), 0) + int(f)
    dt = time.perf_counter() - t0

    print("#osd\tcount\tfirst\tprimary\tc wt\twt", file=out)
    for o in range(m.max_osd):
        print(f"osd.{o}\t{count[o]}\t{first[o]}\t{primary[o]}"
              f"\t{_osd_crush_weight(m, o):.5g}"
              f"\t{m.osd_weight[o] / 0x10000:.5g}", file=out)
    in_osds = max(m.num_in_osds(), 1)
    avg = count.sum() / in_osds
    stddev = float(np.sqrt(((count - avg) ** 2).sum() / in_osds))
    print(f" in {m.num_in_osds()}", file=out)
    print(f" avg {avg:.4g} stddev {stddev:.4g} "
          f"({stddev / avg if avg else 0:.4g}x)", file=out)
    print(f" min osd.{int(count.argmin())} {int(count.min())}", file=out)
    print(f" max osd.{int(count.argmax())} {int(count.max())}", file=out)
    print("size histogram: " + "; ".join(
        f"size {s} {n}" for s, n in sorted(size_hist.items())), file=out)
    rate = total_pgs / dt if dt > 0 else float("inf")
    print(f"mapped {total_pgs} pgs in {dt:.3f}s = {rate:,.0f} pg/s",
          file=out)
    engine = ("+".join(sorted(set(engines)))
              if engines else "scalar-oracle")
    return {"pgs": total_pgs, "seconds": dt, "pgs_per_sec": rate,
            "count": count, "size_hist": size_hist, "engine": engine}


def _osd_crush_weight(m: OSDMap, osd: int) -> float:
    for b in m.crush.buckets:
        if b is None:
            continue
        ws = b.weights if b.weights else [b.item_weight] * b.size
        for item, w in zip(b.items, ws):
            if item == osd:
                return w / 0x10000
    return 0.0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="osdmaptool", description=__doc__)
    p.add_argument("mapfile", nargs="?", help="OSDMap file (JSON)")
    p.add_argument("--createsimple", type=int, metavar="N",
                   help="create a simple map with N osds into MAPFILE")
    p.add_argument("--pg-bits", type=int, default=6)
    p.add_argument("--pool-type", choices=["replicated", "erasure"],
                   default="replicated")
    p.add_argument("--test-map-pgs", action="store_true")
    p.add_argument("--test-map-object", metavar="NAME")
    p.add_argument("--pool", type=int, default=None)
    p.add_argument("--mark-out", type=int, action="append", default=[],
                   metavar="OSD")
    p.add_argument("--mark-up-in", action="store_true")
    p.add_argument("--export-crush", metavar="FILE")
    p.add_argument("--import-crush", metavar="FILE")
    p.add_argument("--upmap", metavar="FILE",
                   help="run the upmap balancer, write the proposed "
                        "`osd pg-upmap-items` commands to FILE")
    p.add_argument("--upmap-pool", type=int, default=None)
    p.add_argument("--upmap-max", type=int, default=100)
    p.add_argument("--scalar", action="store_true",
                   help="map with the scalar Python oracle")
    p.add_argument("--require-batched", action="store_true",
                   help="refuse --scalar (the batched mapper never "
                        "falls back on its own)")
    p.add_argument("--device", default="cuda",
                   help="device of the batched mapper (default cuda; "
                        "cpu runs the plain versions)")
    p.add_argument("-o", "--out-file", metavar="FILE")
    p.add_argument("--print", dest="print_map", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.mapfile:
        build_parser().print_usage()
        return 1

    if args.createsimple:
        ptype = (TYPE_ERASURE if args.pool_type == "erasure"
                 else TYPE_REPLICATED)
        m = OSDMap.build_simple(args.createsimple, pg_bits=args.pg_bits,
                                pool_type=ptype)
        save_osdmap(m, args.mapfile)
        print(f"osdmaptool: writing epoch {m.epoch} to {args.mapfile}")
        return 0

    m = load_osdmap(args.mapfile)
    dirty = False
    if args.mark_up_in:
        for o in range(m.max_osd):
            m.osd_state[o] |= EXISTS | UP
            m.osd_weight[o] = 0x10000
        dirty = True
    for o in args.mark_out:
        m.mark_out(o)
        dirty = True
    if args.import_crush:
        with open(args.import_crush) as f:
            m.crush = crushmap_from_dict(json.load(f))
        dirty = True
    if args.export_crush:
        with open(args.export_crush, "w") as f:
            json.dump(crushmap_to_dict(m.crush), f)
            f.write("\n")
    if args.print_map:
        print(f"epoch {m.epoch}")
        print(f"max_osd {m.max_osd}")
        for p in m.pools.values():
            kind = "erasure" if p.type == TYPE_ERASURE else "replicated"
            print(f"pool {p.id} '{p.name}' {kind} size {p.size} "
                  f"min_size {p.min_size} pg_num {p.pg_num} "
                  f"crush_rule {p.crush_rule}")
        for o in range(m.max_osd):
            print(f"osd.{o} {'up' if m.is_up(o) else 'down'} "
                  f"{'out' if m.is_out(o) else 'in'} "
                  f"weight {m.osd_weight[o] / 0x10000:g}")
    if args.test_map_object:
        pool = args.pool if args.pool is not None else min(m.pools)
        pg = m.object_locator_to_pg(args.test_map_object, pool)
        pg = m.raw_pg_to_pg(pg)
        up, up_p, acting, acting_p = m.pg_to_up_acting_osds(pg)
        print(f" object '{args.test_map_object}' -> {pg} -> up {up} "
              f"acting {acting}")
    if args.test_map_pgs:
        try:
            if args.require_batched and args.scalar:
                raise BatchedRequired(
                    "osdmaptool: --require-batched with --scalar")
            rep = run_test_map_pgs(m, args.pool, scalar=args.scalar,
                                   device=args.device)
            announce("osdmaptool", rep["engine"])
        except BatchedRequired as e:
            print(e, file=sys.stderr)
            return 2
    if args.upmap:
        # reference `osdmaptool --upmap out.txt`: emit the balancer's
        # proposed commands (and keep them applied in -o output)
        from ..mgr.balancer import UpmapBalancer
        if args.require_batched and args.scalar:
            print("osdmaptool: --require-batched with --scalar",
                  file=sys.stderr)
            return 2
        pools = ([args.upmap_pool] if args.upmap_pool is not None
                 else list(m.pools))
        lines = []
        for pid in pools:
            try:
                bal = UpmapBalancer(m, pid, scalar=args.scalar,
                                    device=args.device)
                before = bal.stddev()
                props = bal.optimize(max_changes=args.upmap_max)
            except BatchedRequired as e:
                print(e, file=sys.stderr)
                return 2
            for pgid, items in sorted(props.items(),
                                      key=lambda kv: str(kv[0])):
                pairs = " ".join(f"{a} {b}" for a, b in items)
                lines.append(f"ceph osd pg-upmap-items {pgid} {pairs}")
            print(f"pool {pid}: stddev {before:.2f} -> "
                  f"{bal.stddev():.2f}, {len(props)} changes")
        with open(args.upmap, "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
        dirty = True
    if dirty and args.out_file:
        save_osdmap(m, args.out_file)
        print(f"osdmaptool: writing epoch {m.epoch} to {args.out_file}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
