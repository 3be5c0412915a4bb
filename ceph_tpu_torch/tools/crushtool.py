"""crushtool — compile, decompile, build and test CRUSH maps.

Reference: ``src/tools/crushtool.cc``; port of ``ceph_tpu.tools.crushtool``.
``--test`` maps the inputs ``--min-x`` .. ``--max-x`` of every rule (or
``--rule``) at every replica count of the rule (or ``--num-rep``) through
the port's `BatchMapper`, one K7 straw2 launch per descent level on the
card (``--device``, default ``cuda``; ``--device cpu`` runs the plain
versions), and prints ``--show-mappings``, ``--show-utilization`` and
``--show-statistics`` as ``ceph_tpu``'s tool does.  ``--scalar`` maps
with the scalar oracle ``do_rule`` instead; it is never taken on its
own: a rule the batched mapper declines stops the run (exit 2), as in
the port's ``osdmaptool``.

Usage::

    crushtool -c map.txt -o map.json          # compile text → map
    crushtool -d map.json [-o map.txt]        # decompile → text
    crushtool -i map.json --test --rule 0 --num-rep 3 \\
        --min-x 0 --max-x 1023 --show-mappings [--device cpu]
    crushtool -i map.json --test --show-utilization
    crushtool --build --num-osds 64 host straw2 4 rack straw2 4 \\
        root straw2 0 -o map.json
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..crush.compiler import (compile_crushmap, crushmap_from_dict,
                              crushmap_to_dict, decompile_crushmap)
from ..crush.map import CRUSH_ITEM_NONE, Bucket, CrushMap, Rule, Step
from ..crush.mapper import do_rule
from ._engine import BatchedRequired, announce, declined


def load_map(path: str) -> CrushMap:
    with open(path) as f:
        text = f.read()
    if text.lstrip().startswith("{"):
        return crushmap_from_dict(json.loads(text))
    return compile_crushmap(text)


def save_map(cmap: CrushMap, path: str):
    with open(path, "w") as f:
        json.dump(crushmap_to_dict(cmap), f, indent=1)
        f.write("\n")


def batch_map(cmap: CrushMap, rule: Rule, xs: np.ndarray, num_rep: int,
              weights=None, *, scalar: bool = False, device=None,
              engines: list | None = None) -> np.ndarray:
    """Map the inputs ``xs`` → ``[len(xs), num_rep]`` int32, NONE-padded
    rows: through `BatchMapper` on ``device`` (``None``: the card), or
    the scalar oracle with ``scalar``.  A rule the batched mapper
    declines raises `BatchedRequired`; ``engines`` collects which engine
    ran."""
    if not scalar:
        from ..crush.torch_mapper import BatchMapper
        try:
            bm = BatchMapper(cmap, rule, result_max=num_rep, device=device)
        except (NotImplementedError, ValueError) as e:
            declined("crushtool", f"rule {rule.id} ({rule.name})", e)
        out = bm(xs, weights)
        if engines is not None:
            engines.append(f"batched ({bm.device.type})")
        return out
    if engines is not None:
        engines.append("scalar-oracle")
    wl = list(weights) if weights is not None else None
    out = np.full((len(xs), num_rep), CRUSH_ITEM_NONE, dtype=np.int32)
    for i, x in enumerate(xs):
        row = do_rule(cmap, rule, int(x), num_rep, wl)
        out[i, :len(row)] = row
    return out


def build_hierarchy_args(num_osds: int, layers: list[tuple[str, str, int]],
                         ) -> CrushMap:
    """--build: bottom-up layered topology.  Each layer (typename, alg,
    fanout); fanout 0 = one bucket holding everything below."""
    cmap = CrushMap(types={0: "osd"}, max_devices=num_osds)
    for i in range(num_osds):
        cmap.names[i] = f"osd.{i}"
    cur = list(range(num_osds))
    cur_w = [0x10000] * num_osds
    next_bid = -1
    for li, (tname, alg, fanout) in enumerate(layers, start=1):
        cmap.types[li] = tname
        if fanout <= 0:
            groups = [cur]
        else:
            groups = [cur[i:i + fanout] for i in range(0, len(cur), fanout)]
        weight_of = dict(zip(cur, cur_w))
        nxt, nxt_w = [], []
        for gi, grp in enumerate(groups):
            b = Bucket(id=next_bid, type=li, alg=alg, items=list(grp),
                       weights=[weight_of[it] for it in grp])
            cmap.add_bucket(b)
            cmap.names[next_bid] = (tname if len(groups) == 1
                                    else f"{tname}{gi}")
            nxt.append(next_bid)
            nxt_w.append(b.weight)
            next_bid -= 1
        cur, cur_w = nxt, nxt_w
    # default rule: chooseleaf over the layer under the root (the failure
    # domain), or straight to devices for a single-layer build
    top_type = len(layers)
    domain = top_type - 1 if top_type >= 2 else 0
    cmap.rules.append(Rule(id=0, name="replicated_rule", steps=[
        Step("take", cur[0]),
        Step("chooseleaf_firstn", 0, domain),
        Step("emit")]))
    return cmap


def _is_firstn(rule: Rule) -> bool:
    return any(s.op.endswith("firstn") for s in rule.steps)


def cmd_test(cmap: CrushMap, args) -> int:
    rules = [r for r in cmap.rules
             if args.rule is None or r.id == args.rule]
    if not rules:
        print(f"rule {args.rule} not found", file=sys.stderr)
        return 1
    weights = None
    if args.weight:
        weights = [0x10000] * cmap.max_devices
        for spec in args.weight:
            osd, w = spec.split(":") if ":" in spec else spec.split(",")
            weights[int(osd)] = int(float(w) * 0x10000)
    xs = np.arange(args.min_x, args.max_x + 1, dtype=np.int64)
    engines: list[str] = []
    for rule in rules:
        reps = ([args.num_rep] if args.num_rep
                else list(range(rule.min_size, rule.max_size + 1)))
        for num_rep in reps:
            res = batch_map(cmap, rule, xs, num_rep, weights,
                            scalar=args.scalar, device=args.device,
                            engines=engines)
            placed = res != CRUSH_ITEM_NONE
            if args.show_mappings:
                firstn = bool(rule.steps) and _is_firstn(rule)
                for x, row in zip(xs.tolist(), res.tolist()):
                    shown = ([o for o in row if o != CRUSH_ITEM_NONE]
                             if firstn else
                             ["NONE" if o == CRUSH_ITEM_NONE else o
                              for o in row])
                    print(f"CRUSH rule {rule.id} x {x} {shown}")
            if args.show_utilization:
                items, counts = np.unique(res[placed], return_counts=True)
                avg = int(placed.sum()) / max(cmap.max_devices, 1)
                print(f"rule {rule.id} ({rule.name}) num_rep {num_rep} "
                      f"result size == {int(placed.sum()) / len(xs):.2f}"
                      f"\tok for all x")
                for o, n in zip(items.tolist(), counts.tolist()):
                    print(f"  device {o}:\t\t stored : {n}\t "
                          f"expected : {avg:.2f}")
            if args.show_statistics:
                sizes = np.bincount(placed.sum(axis=1))
                for got in np.flatnonzero(sizes).tolist():
                    print(f"rule {rule.id} ({rule.name}) num_rep {num_rep} "
                          f"result size == {got}:\t{sizes[got]}/{len(xs)}")
    announce("crushtool", "+".join(sorted(set(engines)))
             if engines else "scalar-oracle")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="crushtool", description=__doc__)
    p.add_argument("-c", "--compile", metavar="FILE",
                   help="compile text map FILE")
    p.add_argument("-d", "--decompile", metavar="FILE",
                   help="decompile map FILE to text")
    p.add_argument("-i", "--in-file", metavar="FILE", help="input map")
    p.add_argument("-o", "--out-file", metavar="FILE", help="output path")
    p.add_argument("--build", action="store_true")
    p.add_argument("--num-osds", type=int, default=0)
    p.add_argument("layers", nargs="*", default=[],
                   help="--build layers: NAME ALG SIZE triples")
    p.add_argument("--test", action="store_true")
    p.add_argument("--rule", type=int, default=None)
    p.add_argument("--num-rep", type=int, default=None)
    p.add_argument("--min-x", type=int, default=0)
    p.add_argument("--max-x", type=int, default=1023)
    p.add_argument("--weight", action="append", default=[],
                   metavar="OSD:W", help="reweight device (repeatable)")
    p.add_argument("--show-mappings", action="store_true")
    p.add_argument("--show-utilization", action="store_true")
    p.add_argument("--show-statistics", action="store_true")
    p.add_argument("--scalar", action="store_true",
                   help="map with the scalar Python oracle")
    p.add_argument("--require-batched", action="store_true",
                   help="refuse --scalar (the batched mapper never "
                        "falls back on its own)")
    p.add_argument("--device", default="cuda",
                   help="device of the batched mapper (default cuda; "
                        "cpu runs the plain versions)")
    return p


def _run_test(cmap: CrushMap, args) -> int:
    try:
        if args.require_batched and args.scalar:
            raise BatchedRequired("crushtool: --require-batched with "
                                  "--scalar")
        return cmd_test(cmap, args)
    except BatchedRequired as e:
        print(e, file=sys.stderr)
        return 2


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.compile:
        with open(args.compile) as f:
            cmap = compile_crushmap(f.read())
        save_map(cmap, args.out_file or args.compile + ".json")
        return 0
    if args.decompile:
        text = decompile_crushmap(load_map(args.decompile))
        if args.out_file:
            with open(args.out_file, "w") as f:
                f.write(text)
        else:
            sys.stdout.write(text)
        return 0
    if args.build:
        if args.num_osds <= 0 or len(args.layers) % 3:
            print("--build needs --num-osds and NAME ALG SIZE triples",
                  file=sys.stderr)
            return 1
        layers = [(args.layers[i], args.layers[i + 1],
                   int(args.layers[i + 2]))
                  for i in range(0, len(args.layers), 3)]
        cmap = build_hierarchy_args(args.num_osds, layers)
        if args.out_file:
            save_map(cmap, args.out_file)
        if args.test:
            return _run_test(cmap, args)
        return 0
    if args.test:
        if not args.in_file:
            print("--test needs -i MAP", file=sys.stderr)
            return 1
        return _run_test(load_map(args.in_file), args)
    build_parser().print_usage()
    return 1


if __name__ == "__main__":
    sys.exit(main())
