"""CRUSH map model: buckets, rules, tunables, names, device classes.

Reference: `src/crush/crush.h` (structs), `src/crush/CrushWrapper.{h,cc}`
(builder/façade), `src/crush/CrushCompiler.cc` (text form) — SURVEY.md
§3.3.  This is the in-memory model consumed by both the scalar oracle
(`mapper.py`) and the batched mapper (`torch_mapper.py`).

Conventions carried over from the reference:
- devices have ids ≥ 0; buckets have ids < 0; bucket id -1-i indexes row i
  of the bucket table (dense).
- weights are 16.16 fixed point (0x10000 == weight 1.0).
- bucket algs: straw2 (default since Hammer), uniform, list, tree, straw.
  The scalar oracle (mapper.py) and the batched mapper implement all
  five.
- rule steps form a tiny VM: take / choose(leaf)_firstn / choose(leaf)_indep
  / emit / set_* tunable overrides.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

CRUSH_ITEM_NONE = -0x7FFFFFFF  # 0x80000001 as int32
CRUSH_ITEM_UNDEF = -0x7FFFFFFE


@dataclass
class Tunables:
    """Behavior knobs; defaults = the reference's 'jewel' (optimal) profile."""
    choose_local_tries: int = 0
    choose_local_fallback_tries: int = 0
    choose_total_tries: int = 50
    chooseleaf_descend_once: int = 1
    chooseleaf_vary_r: int = 1
    chooseleaf_stable: int = 1
    straw_calc_version: int = 1
    allowed_bucket_algs: int = 0x36  # unused placeholder; parity field

    @classmethod
    def legacy(cls) -> "Tunables":
        return cls(choose_local_tries=2, choose_local_fallback_tries=5,
                   choose_total_tries=19, chooseleaf_descend_once=0,
                   chooseleaf_vary_r=0, chooseleaf_stable=0,
                   straw_calc_version=0)


@dataclass
class Bucket:
    id: int                      # < 0
    type: int                    # type id (0 reserved for devices)
    alg: str = "straw2"          # straw2 | uniform | list | tree | straw
    hash: str = "rjenkins1"
    items: list[int] = field(default_factory=list)
    weights: list[int] = field(default_factory=list)  # 16.16 per item
    item_weight: int = 0         # uniform buckets: one weight for all items

    @property
    def size(self) -> int:
        return len(self.items)

    @property
    def weight(self) -> int:
        if self.alg == "uniform":
            return self.item_weight * self.size
        return sum(self.weights)


@dataclass
class Step:
    op: str        # take | choose_firstn | choose_indep | chooseleaf_firstn
    #              # | chooseleaf_indep | emit | set_choose_tries
    #              # | set_chooseleaf_tries | set_choose_local_tries
    #              # | set_choose_local_fallback_tries
    #              # | set_chooseleaf_vary_r | set_chooseleaf_stable
    arg1: int = 0  # take: item id; choose*: numrep; set_*: value
    arg2: int = 0  # choose*: bucket type to select
    # take-with-class bookkeeping (reference: `step take <root> class <c>`
    # resolves to a class-filtered shadow bucket): `arg1` holds the shadow
    # id the mappers walk; `orig`/`cls` keep the source form for decompile.
    orig: int | None = None
    cls: str | None = None


@dataclass
class Rule:
    id: int
    name: str
    steps: list[Step]
    type: str = "replicated"     # replicated | erasure
    min_size: int = 1
    max_size: int = 32


@dataclass
class CrushMap:
    buckets: list[Bucket | None] = field(default_factory=list)  # row i ↔ id -1-i
    rules: list[Rule] = field(default_factory=list)
    types: dict[int, str] = field(default_factory=lambda: {0: "osd"})
    names: dict[int, str] = field(default_factory=dict)          # item id → name
    tunables: Tunables = field(default_factory=Tunables)
    max_devices: int = 0
    device_classes: dict[int, str] = field(default_factory=dict)  # osd id → class
    # balancer weight-sets: bucket id → {"ids": [...], "weight_set": [[w]*size per position]}
    choose_args: dict[int, dict] = field(default_factory=dict)
    # per-class shadow-tree clone cache: class → {bucket id → clone id|None}
    _shadow_cache: dict = field(default_factory=dict, repr=False,
                                compare=False)

    def bucket(self, bid: int) -> Bucket:
        row = -1 - bid
        if row < 0 or row >= len(self.buckets) or self.buckets[row] is None:
            raise KeyError(f"no bucket with id {bid}")
        return self.buckets[row]

    def add_bucket(self, bucket: Bucket) -> None:
        row = -1 - bucket.id
        while len(self.buckets) <= row:
            self.buckets.append(None)
        self.buckets[row] = bucket

    def item_type(self, item: int) -> int:
        return 0 if item >= 0 else self.bucket(item).type

    def rule_by_id(self, rule_id: int) -> Rule:
        """Resolve a rule by its id (the reference resolves by id, not
        list position — rule ids may be sparse/non-dense)."""
        for r in self.rules:
            if r.id == rule_id:
                return r
        raise KeyError(f"no rule with id {rule_id}")

    def rule_by_name(self, name: str) -> Rule:
        for r in self.rules:
            if r.name == name:
                return r
        raise KeyError(name)

    def class_shadow(self, root_id: int, device_class: str) -> int:
        """Shadow-tree id for ``take <root> class <cls>`` steps.

        The reference builds per-class clones of every bucket containing
        only devices of that class (``CrushWrapper::populate_classes`` /
        ``device_class_clone``); rule takes then walk the clone.  Clone ids
        here are allocated deterministically below the most negative
        existing id, cached per (bucket, class).

        Raises KeyError if the filtered subtree is empty.
        """
        cache = self._shadow_cache.setdefault(device_class, {})

        def clone(bid: int) -> int | None:
            if bid in cache:
                return cache[bid]
            b = self.bucket(bid)
            items, weights = [], []
            for item, w in zip(b.items,
                               b.weights or [b.item_weight] * b.size):
                if item >= 0:
                    if self.device_classes.get(item) == device_class:
                        items.append(item)
                        weights.append(w)
                else:
                    sub = clone(item)
                    if sub is not None:
                        items.append(sub)
                        weights.append(self.bucket(sub).weight)
            if not items:
                cache[bid] = None
                return None
            sid = -1 - len(self.buckets)
            sb = Bucket(id=sid, type=b.type, alg=b.alg, hash=b.hash,
                        items=items, weights=weights,
                        item_weight=b.item_weight)
            self.add_bucket(sb)
            self.names[sid] = f"{self.names.get(bid, bid)}~{device_class}"
            cache[bid] = sid
            return sid

        sid = clone(root_id)
        if sid is None:
            raise KeyError(
                f"no devices of class {device_class!r} under bucket {root_id}")
        return sid

    def max_depth_to_type(self, root_id: int, target_type: int) -> int:
        """Longest descent path (in choose steps) from root to target type."""
        def depth(item: int) -> int:
            if self.item_type(item) == target_type:
                return 0
            if item >= 0:
                return 0  # device of a different type: dead end
            b = self.bucket(item)
            if not b.items:
                return 1
            return 1 + max(depth(c) for c in b.items)
        return depth(root_id)


def build_flat_map(n_osds: int, osd_weight: int = 0x10000,
                   weights: list[int] | None = None) -> CrushMap:
    """One straw2 root directly containing n_osds devices."""
    m = CrushMap(max_devices=n_osds,
                 types={0: "osd", 10: "root"})
    w = weights if weights is not None else [osd_weight] * n_osds
    root = Bucket(id=-1, type=10, items=list(range(n_osds)), weights=list(w))
    m.add_bucket(root)
    m.names[-1] = "default"
    for i in range(n_osds):
        m.names[i] = f"osd.{i}"
    m.rules.append(Rule(id=0, name="replicated_rule", steps=[
        Step("take", -1), Step("choose_firstn", 0, 0), Step("emit")]))
    return m


DATACENTER_TYPE = 8     # reference type id for "datacenter"


def build_stretch_map(sites: dict[str, list[int]],
                      osd_weight: int = 0x10000) -> CrushMap:
    """Two-"datacenter" stretch topology plus the stretch rule.

    ``sites`` maps site name → osd ids (each OSD gets its own host
    bucket so ``chooseleaf firstn 2 type host`` can spread within the
    site).  Rule 0 is the reference stretch-mode placement::

        take default
        choose firstn 2 type datacenter
        chooseleaf firstn 2 type host
        emit

    — both sites first, then two hosts in each, giving size=4 replica
    sets that always span the sites.
    """
    m = CrushMap(types={0: "osd", 1: "host",
                        DATACENTER_TYPE: "datacenter", 10: "root"})
    bid = -2  # -1 reserved for root
    dc_ids, dc_ws = [], []
    max_osd = 0
    for site, osds in sites.items():
        host_ids, host_ws = [], []
        for i, o in enumerate(osds):
            m.names[o] = f"osd.{o}"
            max_osd = max(max_osd, o + 1)
            hb = Bucket(id=bid, type=1, items=[o], weights=[osd_weight])
            m.add_bucket(hb)
            m.names[bid] = f"host-{site}-{i}"
            host_ids.append(bid)
            host_ws.append(hb.weight)
            bid -= 1
        db = Bucket(id=bid, type=DATACENTER_TYPE, items=host_ids,
                    weights=host_ws)
        m.add_bucket(db)
        m.names[bid] = site
        dc_ids.append(bid)
        dc_ws.append(db.weight)
        bid -= 1
    root = Bucket(id=-1, type=10, items=dc_ids, weights=dc_ws)
    m.add_bucket(root)
    m.names[-1] = "default"
    m.max_devices = max_osd
    m.rules.append(Rule(id=0, name="stretch_rule", steps=[
        Step("take", -1),
        Step("choose_firstn", len(sites), DATACENTER_TYPE),
        Step("chooseleaf_firstn", 2, 1),
        Step("emit")]))
    return m


def build_hierarchy(n_racks: int, hosts_per_rack: int, osds_per_host: int,
                    osd_weight: int = 0x10000,
                    rule: str = "chooseleaf_firstn") -> CrushMap:
    """root → racks → hosts → osds, all straw2; the canonical topology.

    `rule` picks the rule family for rule id 0: "chooseleaf_firstn"
    (replicated over hosts) or "chooseleaf_indep" (EC over hosts).
    """
    m = CrushMap(types={0: "osd", 1: "host", 3: "rack", 10: "root"})
    osd = 0
    bid = -2  # -1 reserved for root
    rack_ids, rack_ws = [], []
    for r in range(n_racks):
        host_ids, host_ws = [], []
        for h in range(hosts_per_rack):
            items = list(range(osd, osd + osds_per_host))
            for i in items:
                m.names[i] = f"osd.{i}"
            hb = Bucket(id=bid, type=1, items=items,
                        weights=[osd_weight] * osds_per_host)
            m.add_bucket(hb)
            m.names[bid] = f"host-{r}-{h}"
            host_ids.append(bid)
            host_ws.append(hb.weight)
            bid -= 1
            osd += osds_per_host
        rb = Bucket(id=bid, type=3, items=host_ids, weights=host_ws)
        m.add_bucket(rb)
        m.names[bid] = f"rack-{r}"
        rack_ids.append(bid)
        rack_ws.append(rb.weight)
        bid -= 1
    root = Bucket(id=-1, type=10, items=rack_ids, weights=rack_ws)
    m.add_bucket(root)
    m.names[-1] = "default"
    m.max_devices = osd
    if rule == "chooseleaf_firstn":
        steps = [Step("take", -1), Step("chooseleaf_firstn", 0, 1),
                 Step("emit")]
        rtype = "replicated"
    else:
        steps = [Step("take", -1), Step("set_chooseleaf_tries", 5),
                 Step("chooseleaf_indep", 0, 1), Step("emit")]
        rtype = "erasure"
    m.rules.append(Rule(id=0, name=f"{rtype}_rule", steps=steps, type=rtype))
    return m
