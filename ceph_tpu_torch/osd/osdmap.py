"""OSDMap — epoch-versioned cluster state and the PG→OSD mapping spine.

Reference behavior re-created: ``src/osd/OSDMap.{h,cc}`` and the pool
type ``pg_pool_t`` from ``src/osd/osd_types.{h,cc}`` (SURVEY.md §3.4):

- pools (size, min_size, pg_num, crush_rule, EC profile, flags) keyed by
  id, with the ``HASHPSPOOL`` placement-seed mixing;
- per-OSD state: exists/up flags, CRUSH reweight (16.16), addresses
  elided (the messenger layer binds names, not this map);
- the mapping pipeline ``object_locator_to_pg -> raw_pg_to_pg ->
  pg_to_raw_osds -> (upmap overrides) -> up -> (pg_temp/primary_temp)
  -> acting`` — the exact call chain of
  ``OSDMap::pg_to_up_acting_osds``;
- ``Incremental`` deltas applied in epoch order.

The CRUSH walk itself runs on the scalar oracle for single lookups and
on the port's `ceph_tpu_torch.crush.torch_mapper.BatchMapper` (on the
card) for PG-batch workloads
(osdmaptool, balancer) — same results, bit-for-bit.
"""

from __future__ import annotations

import hashlib
import json
import threading
from dataclasses import dataclass, field, replace

from ..crush.hash import ceph_str_hash_rjenkins, crush_hash32_2
from ..crush.map import CRUSH_ITEM_NONE, CrushMap, build_flat_map
from ..crush.mapper import do_rule

# pool types (reference pg_pool_t::TYPE_*)
TYPE_REPLICATED = 1
TYPE_ERASURE = 3

# pool flags (subset)
FLAG_HASHPSPOOL = 1 << 0

# cluster-wide OSDMap flags (reference CEPH_OSDMAP_*): operator
# switches set via `ceph osd set <flag>`
CLUSTER_FLAGS = {
    "pause": 1 << 0,     # block client I/O (pauserd|pausewr)
    "nodown": 1 << 1,    # suppress marking OSDs down
    "noout": 1 << 2,     # suppress auto-out (stored; nothing
                         # auto-outs at this scale yet)
    "noscrub": 1 << 3,   # suppress scheduled (shallow) scrubs
    "nodeep-scrub": 1 << 4,  # suppress scheduled deep scrubs
}

# osd state bits (reference CEPH_OSD_EXISTS/UP)
EXISTS = 1
UP = 2


def ceph_stable_mod(x: int, b: int, bmask: int) -> int:
    """The pg_num folding function (reference ``ceph_stable_mod`` in
    ``src/include/ceph_hash.h``): stable under pg_num growth — a pg only
    moves when its own bit splits."""
    if (x & bmask) < b:
        return x & bmask
    return x & (bmask >> 1)


def _calc_bits_of(n: int) -> int:
    return max(0, (n - 1)).bit_length() if n > 0 else 0


@dataclass(frozen=True, order=True)
class PGid:
    pool: int
    seed: int

    def __str__(self):
        return f"{self.pool}.{self.seed:x}"

    @classmethod
    def parse(cls, s: str) -> "PGid":
        pool, seed = s.split(".")
        return cls(int(pool), int(seed, 16))


@dataclass
class PGPool:
    """pg_pool_t analog."""
    id: int
    name: str
    type: int = TYPE_REPLICATED
    size: int = 3
    min_size: int = 2
    pg_num: int = 32
    pgp_num: int = 0                 # 0 ⇒ follows pg_num
    crush_rule: int = 0
    object_hash: str = "rjenkins"
    flags: int = FLAG_HASHPSPOOL
    erasure_code_profile: str = ""
    last_change: int = 0             # epoch of last modification
    # pool snapshots (reference pg_pool_t::snap_seq/snaps): clients
    # stamp writes with the pool SnapContext; OSDs clone-on-write
    snap_seq: int = 0
    snaps: dict = field(default_factory=dict)   # id → name
    # quotas (reference pg_pool_t quota_max_objects/bytes): 0 = none.
    # `full` is set by the mon when PGMap usage exceeds a quota;
    # OSDs reply -EDQUOT to writes while it holds.
    quota_max_objects: int = 0
    quota_max_bytes: int = 0
    full: bool = False
    # cache tiering (reference pg_pool_t tier fields): a cache pool
    # has tier_of = base pool id; the BASE pool's read/write_tier
    # point at the cache once the overlay is set, redirecting client
    # ops there (the Objecter honors this like the reference).
    tier_of: int = -1
    read_tier: int = -1
    write_tier: int = -1
    cache_mode: str = "none"         # none | writeback
    tiers: list = field(default_factory=list)
    # stretch pools (reference pg_pool_t peering-crush stretch set):
    # replicas span the datacenter buckets; on site loss the mon drops
    # min_size to 1 (degraded stretch mode) and restores
    # `stretch_min_size` once both sites are back.
    is_stretch: bool = False
    stretch_min_size: int = 0        # healthy min_size to restore
    # storage efficiency (reference pg_pool_t compression_* options +
    # dedup tiering): mode none|passive|aggressive|force gates the
    # OSD's inline compression lane; dedup is replicated-pool-only
    # and mutually exclusive with pool snapshots (mon-enforced).
    compression_mode: str = "none"
    compression_algorithm: str = ""
    dedup_enable: bool = False

    def __post_init__(self):
        if self.pgp_num == 0:
            self.pgp_num = self.pg_num

    @property
    def pg_num_mask(self) -> int:
        return (1 << _calc_bits_of(self.pg_num)) - 1

    @property
    def pgp_num_mask(self) -> int:
        return (1 << _calc_bits_of(self.pgp_num)) - 1

    def is_erasure(self) -> bool:
        return self.type == TYPE_ERASURE

    def raw_pg_to_pg(self, seed: int) -> int:
        return ceph_stable_mod(seed, self.pg_num, self.pg_num_mask)

    def raw_pg_to_pps(self, seed: int) -> int:
        """Placement seed handed to CRUSH (``pg_pool_t::raw_pg_to_pps``).
        HASHPSPOOL mixes the pool id in so co-sized pools diverge."""
        if self.flags & FLAG_HASHPSPOOL:
            return int(crush_hash32_2(
                ceph_stable_mod(seed, self.pgp_num, self.pgp_num_mask),
                self.id & 0xFFFFFFFF))
        return (ceph_stable_mod(seed, self.pgp_num, self.pgp_num_mask)
                + self.id)

    def raw_pg_to_pps_batch(self, seeds):
        """Vectorized twin of `raw_pg_to_pps` over a uint32 seed array —
        the osdmaptool/balancer batch path.  Same math, one definition
        site; tests assert elementwise equality with the scalar form."""
        import numpy as np
        seeds = np.asarray(seeds, dtype=np.uint32)
        masked = np.where(
            (seeds & self.pgp_num_mask) < self.pgp_num,
            seeds & self.pgp_num_mask, seeds & (self.pgp_num_mask >> 1))
        if self.flags & FLAG_HASHPSPOOL:
            return crush_hash32_2(masked.astype(np.uint32),
                                  np.uint32(self.id & 0xFFFFFFFF))
        return (masked + self.id).astype(np.uint32)


@dataclass
class Incremental:
    """OSDMap::Incremental analog — one epoch's delta."""
    epoch: int
    new_pools: dict[int, PGPool] = field(default_factory=dict)
    old_pools: list[int] = field(default_factory=list)
    new_max_osd: int | None = None
    new_state: dict[int, int] = field(default_factory=dict)   # xor'd bits
    new_weight: dict[int, int] = field(default_factory=dict)
    new_pg_temp: dict[PGid, list[int]] = field(default_factory=dict)
    new_primary_temp: dict[PGid, int] = field(default_factory=dict)
    new_pg_upmap: dict[PGid, list[int]] = field(default_factory=dict)
    old_pg_upmap: list[PGid] = field(default_factory=list)
    new_pg_upmap_items: dict[PGid, list[tuple[int, int]]] = \
        field(default_factory=dict)
    old_pg_upmap_items: list[PGid] = field(default_factory=list)
    new_crush: CrushMap | None = None
    # stretch-mode state delta: {field: value} over the OSDMap stretch
    # attributes (stretch_mode_enabled, stretch_sites, ...)
    new_stretch: dict | None = None


# ``do_rule`` results shared by the maps that carry a ``mapping_key``:
# an OSD daemon's and an Objecter's maps are decoded from the mon's JSON
# and never changed afterwards, so every daemon of one process (a
# MiniCluster runs them all in one) and every epoch that leaves the
# CRUSH map and the reweights as they were reuse one scalar mapping of a
# PG instead of walking straw2 again (~30 ms an 11-wide EC PG)
_RAW_MEMO: dict = {}
_RAW_MEMO_MAX = 1 << 16
_RAW_MEMO_LOCK = threading.Lock()   # one walk a PG, not one a daemon


def mapping_key(map_dict: dict) -> str:
    """What ``do_rule`` reads of an encoded map (its CRUSH map and the
    reweights), as a digest: maps with equal keys map every PG alike."""
    blob = json.dumps([map_dict["crush"], map_dict["osd_weight"]],
                      sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


class OSDMap:
    def __init__(self, crush: CrushMap | None = None, max_osd: int = 0):
        self.epoch = 0
        # set only by ``tools.osdmaptool.shared_osdmap_from_dict``
        self.mapping_key: str | None = None
        self.crush = crush if crush is not None else CrushMap()
        self.max_osd = max_osd
        self.osd_state = [0] * max_osd
        self.osd_weight = [0x10000] * max_osd     # reweight, 16.16
        # newest epoch through which each OSD confirmed aliveness as a
        # would-be primary (reference osd_info_t::up_thru, bumped by
        # MOSDAlive before a primary activates): an interval whose
        # primary never bumped up_thru into it provably accepted no
        # writes, which is what keeps dead-primary intervals from
        # blocking peering forever
        self.osd_up_thru = [0] * max_osd
        self.pools: dict[int, PGPool] = {}
        self.pool_name: dict[str, int] = {}
        self.pg_temp: dict[PGid, list[int]] = {}
        self.primary_temp: dict[PGid, int] = {}
        self.pg_upmap: dict[PGid, list[int]] = {}
        self.pg_upmap_items: dict[PGid, list[tuple[int, int]]] = {}
        self.erasure_code_profiles: dict[str, dict[str, str]] = {}
        self.flags = 0
        # daemon addresses, "host:port" — the Objecter's routing table
        # (reference OSDMap::get_addrs)
        self.osd_addrs: dict[int, str] = {}
        # (rule_id, result_max) → BatchMapper, reused across epochs:
        # a weight-only CRUSH change rebinds via set_weights (new
        # weight tables only), everything else builds a fresh mapper
        self._mappers: dict = {}
        # stretch mode (reference OSDMap::stretch_mode_enabled et al.):
        # site-aware placement + surviving-site degraded operation
        self.stretch_mode_enabled = False
        self.stretch_bucket_type = 0             # crush type id (datacenter)
        self.stretch_sites: dict[str, list[int]] = {}   # site → osd ids
        self.stretch_tiebreaker = ""             # tiebreaker mon name
        self.degraded_stretch_mode = False       # a site is down
        self.recovering_stretch_mode = False     # healed, recovery pending
        self.stretch_degraded_site = ""          # which site died

    def batch_mapper(self, rule_id: int, result_max: int, **kwargs):
        """Cached `crush.torch_mapper.BatchMapper` for (rule, size, and
        the mapper's keyword arguments, e.g. ``device``).

        Balancer rounds and repeated osdmaptool sweeps reuse one
        mapper; after `apply_incremental` swaps in a weight-only
        `new_crush`, the mapper rebinds through
        `BatchMapper.set_weights` (new device tables, nothing else).
        Topology / rule / tunables changes build a fresh mapper."""
        from ..crush.torch_mapper import BatchMapper
        key = (rule_id, result_max, tuple(sorted(kwargs.items())))
        bm = self._mappers.get(key)
        if bm is not None:
            if bm.cmap is not self.crush:
                try:
                    bm.set_weights(self.crush)
                except (ValueError, NotImplementedError):
                    bm = None
            if bm is not None:
                return bm
        bm = BatchMapper(self.crush, rule_id, result_max=result_max,
                         **kwargs)
        self._mappers[key] = bm
        return bm

    # -- construction ------------------------------------------------------
    @classmethod
    def build_simple(cls, n_osds: int, pg_bits: int = 6,
                     pool_type: int = TYPE_REPLICATED) -> "OSDMap":
        """osdmaptool --createsimple analog: flat straw2 map, all osds
        up+in, one pool 'rbd' with n_osds << pg_bits PGs (replicated by
        default; TYPE_ERASURE gets an indep rule and positional holes)."""
        from ..crush.map import Rule, Step
        crush = build_flat_map(n_osds)
        crush.rules.append(Rule(id=1, name="erasure_rule", type="erasure",
                                steps=[Step("take", -1),
                                       Step("choose_indep", 0, 0),
                                       Step("emit")]))
        m = cls(crush=crush, max_osd=n_osds)
        m.epoch = 1
        for o in range(n_osds):
            m.osd_state[o] = EXISTS | UP
        m.create_pool("rbd", pg_num=max(1, n_osds << pg_bits),
                      type=pool_type,
                      crush_rule=1 if pool_type == TYPE_ERASURE else 0)
        return m

    def create_pool(self, name: str, pg_num: int = 32, *, size: int = 3,
                    min_size: int | None = None, crush_rule: int = 0,
                    type: int = TYPE_REPLICATED,
                    erasure_code_profile: str = "") -> PGPool:
        pid = max(self.pools, default=-1) + 1
        if min_size is None:
            min_size = size - size // 2 if type == TYPE_REPLICATED else size
        pool = PGPool(id=pid, name=name, type=type, size=size,
                      min_size=min_size, pg_num=pg_num,
                      crush_rule=crush_rule, last_change=self.epoch,
                      erasure_code_profile=erasure_code_profile)
        self.pools[pid] = pool
        self.pool_name[name] = pid
        return pool

    # -- osd state ---------------------------------------------------------
    def is_up(self, osd: int) -> bool:
        return 0 <= osd < self.max_osd and bool(self.osd_state[osd] & UP)

    def exists(self, osd: int) -> bool:
        return 0 <= osd < self.max_osd and bool(self.osd_state[osd] & EXISTS)

    def is_out(self, osd: int) -> bool:
        return self.osd_weight[osd] == 0

    def up_thru(self, osd: int) -> int:
        return self.osd_up_thru[osd] if 0 <= osd < self.max_osd else 0

    def mark_down(self, osd: int):
        self.osd_state[osd] &= ~UP

    def mark_out(self, osd: int):
        self.osd_weight[osd] = 0

    # -- the mapping spine -------------------------------------------------
    def object_locator_to_pg(self, oid: str, pool: int,
                             key: str = "") -> PGid:
        """Objecter's first hop (reference
        ``OSDMap::object_locator_to_pg``): hash the object name (or
        locator key) to a raw placement seed."""
        p = self.pools[pool]
        name = key or oid
        if p.object_hash != "rjenkins":
            raise ValueError(f"unsupported object_hash {p.object_hash!r}")
        return PGid(pool, int(ceph_str_hash_rjenkins(name.encode())))

    def raw_pg_to_pg(self, pgid: PGid) -> PGid:
        p = self.pools[pgid.pool]
        return PGid(pgid.pool, p.raw_pg_to_pg(pgid.seed))

    def pg_to_raw_osds(self, pgid: PGid) -> list[int]:
        """CRUSH mapping, no overrides (``OSDMap::_pg_to_raw_osds``)."""
        pool = self.pools[pgid.pool]
        pps = pool.raw_pg_to_pps(pgid.seed)
        rule = self.crush.rule_by_id(pool.crush_rule)
        if self.mapping_key is None:
            raw = do_rule(self.crush, rule, pps, pool.size, self.osd_weight)
        else:
            memo = (self.mapping_key, pool.crush_rule, pps, pool.size)
            raw = _RAW_MEMO.get(memo)
            if raw is None:
                with _RAW_MEMO_LOCK:
                    raw = _RAW_MEMO.get(memo)
                    if raw is None:
                        if len(_RAW_MEMO) >= _RAW_MEMO_MAX:
                            _RAW_MEMO.clear()
                        raw = _RAW_MEMO[memo] = tuple(do_rule(
                            self.crush, rule, pps, pool.size,
                            self.osd_weight))
        return [o if (o == CRUSH_ITEM_NONE or self.exists(o)) else
                CRUSH_ITEM_NONE for o in raw]

    def _apply_upmap(self, pgid: PGid, raw: list[int]) -> list[int]:
        """pg_upmap (full replacement) and pg_upmap_items (pairwise)
        overrides — ``OSDMap::_apply_upmap``."""
        pm = self.pg_upmap.get(pgid)
        if pm:
            if all(self.exists(o) and not self.is_out(o) for o in pm):
                return list(pm)
        items = self.pg_upmap_items.get(pgid)
        if items:
            raw = list(raw)
            for frm, to in items:
                if (frm in raw and to not in raw and self.exists(to)
                        and not self.is_out(to)):
                    raw[raw.index(frm)] = to
        return raw

    def _raw_to_up_osds(self, pool: PGPool,
                        raw: list[int]) -> tuple[list[int], int]:
        """Strip down OSDs: replicated pools compact, EC pools keep
        positional NONE holes (shard identity matters)."""
        if pool.is_erasure():
            up = [o if (o != CRUSH_ITEM_NONE and self.is_up(o))
                  else CRUSH_ITEM_NONE for o in raw]
        else:
            up = [o for o in raw
                  if o != CRUSH_ITEM_NONE and self.is_up(o)]
        primary = next((o for o in up if o != CRUSH_ITEM_NONE), -1)
        return up, primary

    def pg_to_up_acting_osds(
            self, pgid: PGid,
    ) -> tuple[list[int], int, list[int], int]:
        """→ (up, up_primary, acting, acting_primary), the full override
        chain of the reference method of the same name."""
        pgid = self.raw_pg_to_pg(pgid)
        pool = self.pools[pgid.pool]
        raw = self.pg_to_raw_osds(pgid)
        raw = self._apply_upmap(pgid, raw)
        up, up_primary = self._raw_to_up_osds(pool, raw)
        acting = self.pg_temp.get(pgid)
        if acting is None:
            acting = list(up)
            acting_primary = up_primary
        else:
            acting = list(acting)
            acting_primary = next(
                (o for o in acting if o != CRUSH_ITEM_NONE), -1)
        tp = self.primary_temp.get(pgid)
        if tp is not None and tp in acting:
            acting_primary = tp
        return up, up_primary, acting, acting_primary

    # -- incrementals ------------------------------------------------------
    def apply_incremental(self, inc: Incremental):
        if inc.epoch != self.epoch + 1:
            raise ValueError(
                f"incremental epoch {inc.epoch} != {self.epoch}+1")
        self.epoch = inc.epoch
        if inc.new_crush is not None:
            self.crush = inc.new_crush
            # weight-only fast path: rebind every cached batch mapper
            # onto the new map now (`set_weights`: new weight tables
            # only); a mapper that rejects the rebind saw a
            # topology/tunables change and is evicted so the next
            # `batch_mapper` call rebuilds it.
            for key, bm in list(self._mappers.items()):
                try:
                    bm.set_weights(self.crush)
                except (ValueError, NotImplementedError):
                    del self._mappers[key]
        if inc.new_stretch is not None:
            for k, v in inc.new_stretch.items():
                if not hasattr(self, k):
                    raise ValueError(f"unknown stretch field {k!r}")
                setattr(self, k, v)
        if inc.new_max_osd is not None:
            old = self.max_osd
            self.max_osd = inc.new_max_osd
            if self.max_osd > old:
                self.osd_state += [0] * (self.max_osd - old)
                self.osd_weight += [0x10000] * (self.max_osd - old)
                self.osd_up_thru += [0] * (self.max_osd - old)
            else:
                del self.osd_state[self.max_osd:]
                del self.osd_weight[self.max_osd:]
                del self.osd_up_thru[self.max_osd:]
        for pid, pool in inc.new_pools.items():
            pool.last_change = inc.epoch
            self.pools[pid] = pool
            self.pool_name[pool.name] = pid
        for pid in inc.old_pools:
            pool = self.pools.pop(pid, None)
            if pool:
                self.pool_name.pop(pool.name, None)
        for osd, bits in inc.new_state.items():
            self.osd_state[osd] ^= bits
        for osd, w in inc.new_weight.items():
            self.osd_weight[osd] = w
        for pgid, osds in inc.new_pg_temp.items():
            if osds:
                self.pg_temp[pgid] = list(osds)
            else:
                self.pg_temp.pop(pgid, None)
        for pgid, osd in inc.new_primary_temp.items():
            if osd >= 0:
                self.primary_temp[pgid] = osd
            else:
                self.primary_temp.pop(pgid, None)
        self.pg_upmap.update(inc.new_pg_upmap)
        for pgid in inc.old_pg_upmap:
            self.pg_upmap.pop(pgid, None)
        self.pg_upmap_items.update(inc.new_pg_upmap_items)
        for pgid in inc.old_pg_upmap_items:
            self.pg_upmap_items.pop(pgid, None)

    # -- stretch mode ------------------------------------------------------
    def stretch_site_up(self, site: str) -> bool:
        """A site counts as up while any of its OSDs is up."""
        return any(self.is_up(o) for o in self.stretch_sites.get(site, []))

    def stretch_down_sites(self) -> list[str]:
        return [s for s in sorted(self.stretch_sites)
                if not self.stretch_site_up(s)]

    # -- stats -------------------------------------------------------------
    def num_up_osds(self) -> int:
        return sum(1 for s in self.osd_state if s & UP)

    def num_in_osds(self) -> int:
        return sum(1 for o in range(self.max_osd)
                   if self.exists(o) and not self.is_out(o))
