"""CRUSH mapping rate of the port's `BatchMapper` — the counterpart of
``ceph_tpu.crush.bench.measure`` without its native-C leg.

BASELINE.md row 4: ``osdmaptool --test-map-pgs`` on a straw2 map of
4096 OSDs and 1 Mi PGs.  The topology is ``build_hierarchy(1, 64, 64)``
(root → 64 hosts → 64 OSDs each), rule 0 (``chooseleaf_firstn host``),
size 3.  A sample is checked against the scalar oracle ``do_rule``
before any timing.

    python -m ceph_tpu_torch.crush.bench [--device cpu] [--osds N] [--pgs N]

The rate is host clock around mapping calls that end in a
synchronised device-to-host copy of the placements.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from .map import CRUSH_ITEM_NONE, build_hierarchy
from .mapper import do_rule
from .torch_mapper import BatchMapper


def measure(osds: int = 4096, pgs: int = 1 << 20, device=None,
            sample: int = 64) -> dict:
    hosts = max(1, int(round(osds ** 0.5 / 8)) * 8)
    per_host = osds // hosts
    numrep = 3
    cmap = build_hierarchy(1, hosts, per_host)
    t0 = time.perf_counter()
    bm = BatchMapper(cmap, 0, result_max=numrep, device=device)
    xs = np.arange(pgs, dtype=np.uint32)
    # warm on other inputs (first launch builds the kernels on the card)
    bm(xs ^ np.uint32(0xA5A5A5A5))
    setup_s = time.perf_counter() - t0

    picks = np.linspace(0, pgs - 1, num=min(sample, pgs)).astype(np.int64)
    got = bm(xs[picks])
    for i, x in enumerate(xs[picks]):
        want = do_rule(cmap, 0, int(x), numrep)
        row = np.full(numrep, CRUSH_ITEM_NONE, dtype=np.int32)
        row[:len(want)] = want
        if not np.array_equal(got[i], row):
            raise AssertionError(f"pg {int(x)}: mapper {got[i].tolist()} "
                                 f"!= do_rule {want}")

    t0 = time.perf_counter()
    out = bm(xs)
    map_s = time.perf_counter() - t0
    return {
        "osds": hosts * per_host, "pgs": pgs, "numrep": numrep,
        "rule": "chooseleaf_firstn host", "device": str(bm.device),
        "oracle_sample": len(picks), "setup_s": setup_s,
        "map_s": map_s, "pgs_per_sec": pgs / map_s,
        "placed": int((out != CRUSH_ITEM_NONE).sum()),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--osds", type=int, default=4096)
    p.add_argument("--pgs", type=int, default=1 << 20)
    args = p.parse_args(argv)
    print(json.dumps(measure(args.osds, args.pgs, device=args.device)))


if __name__ == "__main__":
    main()
