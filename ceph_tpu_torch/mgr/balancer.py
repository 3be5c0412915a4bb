"""Upmap balancer — evens per-OSD PG load with pg_upmap_items.

The port's copy of ``ceph_tpu.mgr.balancer``.

Reference behavior re-created (``src/pybind/mgr/balancer/module.py``
upmap mode + ``OSDMap::calc_pg_upmaps`` in ``src/osd/OSDMap.cc``):
compute every PG's placement, find overfull/underfull OSDs against
their CRUSH-weight-proportional targets, and propose pg_upmap_items
exceptions moving single replicas from the fullest OSD to compatible
underfull ones — never violating the rule's failure domain.

The full-pool placement matrix comes from one ``BatchMapper`` call
(`tools.osdmaptool.map_pool_pgs`: K7, the straw2 kernel, on the card)
instead of the reference's per-PG scalar loop.  The optimize round
itself stays numpy on the host and is array-native: per-OSD PG counts
are a scatter-add over the placement matrix, overfull→underfull
candidates come from sorted deviation arrays, and the domain-conflict
check is one boolean [pgs-on-omax, underfull] eligibility matrix per
round instead of a per-PG dict walk.  ``optimize(use_arrays=False)`` keeps
the original per-PG walk as the equality oracle; both paths propose
byte-identical moves.

Apply through the mon: ``{"prefix": "osd pg-upmap-items", "pgid":
"<p.s>", "mappings": [[from, to], ...]}`` (same command the reference
balancer issues).
"""

from __future__ import annotations

import numpy as np

from ..crush.map import CRUSH_ITEM_NONE
from ..osd.osdmap import UP, OSDMap, PGid

# domain sentinel for placement slots that must not contribute a
# used-domain (holes, the overfull OSD itself).  Must sit outside the
# whole domain-value space: bucket ids are negative and "osd has no
# domain" is -1 (which DOES collide with a domain-less candidate,
# matching the legacy None-vs-None check) — so a large positive.
_DOM_IGNORE = 1 << 62


class UpmapBalancer:
    def __init__(self, osdmap: OSDMap, pool_id: int,
                 scalar: bool = False, device=None,
                 placements: np.ndarray | None = None):
        """``placements``: optional precomputed [pg_num, size] raw
        CRUSH matrix (CRUSH_ITEM_NONE holes) — the scale harness
        injects synthetic or cached placements so a million-PG round
        doesn't recompute the mapping.  Otherwise the pool maps
        through the batched mapper on ``device`` (``None``: the card,
        raising without one), or through the scalar oracle when
        ``scalar``; a rule the batched mapper declines raises
        ``tools._engine.BatchedRequired``."""
        self.scalar = scalar
        self.device = device
        if not scalar and placements is None:
            from ..utils.device import resolve_device
            self.device = resolve_device(device)
        self.m = osdmap
        self.pool = osdmap.pools[pool_id]
        self.rule = osdmap.crush.rule_by_id(self.pool.crush_rule)
        self._raw_placements = placements
        # failure-domain type of the rule's choose step (0 = osd)
        self.domain_type = 0
        for s in self.rule.steps:
            if s.op.startswith(("choose_firstn", "chooseleaf_firstn",
                                "choose_indep", "chooseleaf_indep")):
                self.domain_type = s.arg2
        self._domain_of = self._build_domain_index()

    def _build_domain_index(self) -> dict[int, int]:
        """osd → ancestor bucket id of the failure-domain type."""
        dom: dict[int, int] = {}
        if self.domain_type == 0:
            return dom
        crush = self.m.crush

        def walk(bid: int, domain: int | None):
            b = crush.bucket(bid)
            d = bid if b.type == self.domain_type else domain
            for it in b.items:
                if it >= 0:
                    if d is not None:
                        dom[it] = d
                else:
                    walk(it, d)

        children = {it for b in crush.buckets if b is not None
                    for it in b.items if it < 0}
        for b in crush.buckets:
            if b is not None and b.type > self.domain_type and \
                    b.id not in children:
                walk(b.id, None)
        return dom

    # -- placement snapshot ------------------------------------------------
    def _raw_matrix(self) -> np.ndarray:
        if self._raw_placements is not None:
            return self._raw_placements
        from ..tools.osdmaptool import map_pool_pgs
        return map_pool_pgs(self.m, self.pool, scalar=self.scalar,
                            device=self.device)

    def _placements(self) -> dict[PGid, list[int]]:
        raw = self._raw_matrix()
        place: dict[PGid, list[int]] = {}
        for seed in range(self.pool.pg_num):
            pgid = PGid(self.pool.id, seed)
            row = [o for o in raw[seed] if o != CRUSH_ITEM_NONE]
            row = self.m._apply_upmap(pgid, row)
            place[pgid] = [o for o in row
                           if o != CRUSH_ITEM_NONE and self.m.is_up(o)]
        return place

    def _placement_matrix(self) -> np.ndarray:
        """[pg_num, size] int64 placement with upmaps applied and
        invalid (hole / not-up) slots as CRUSH_ITEM_NONE — the
        array-round state.  Upmap overrides are sparse, so only those
        rows take the per-PG path; everything else is two vectorized
        masks over the raw CRUSH matrix."""
        raw = np.asarray(self._raw_matrix(), dtype=np.int64)
        mat = raw.copy()
        pg_num, size = self.pool.pg_num, self.pool.size
        override = {p.seed for p in self.m.pg_upmap
                    if p.pool == self.pool.id and p.seed < pg_num}
        override |= {p.seed for p in self.m.pg_upmap_items
                     if p.pool == self.pool.id and p.seed < pg_num}
        for seed in override:
            pgid = PGid(self.pool.id, seed)
            row = [o for o in raw[seed] if o != CRUSH_ITEM_NONE]
            row = list(self.m._apply_upmap(pgid, row))[:size]
            mat[seed] = CRUSH_ITEM_NONE
            mat[seed, :len(row)] = row
        # mask holes and down/nonexistent OSDs in one pass
        valid = (mat >= 0) & (mat < self.m.max_osd)
        up = np.asarray(self.m.osd_state, dtype=np.int64) & UP != 0
        live = np.zeros_like(mat, dtype=bool)
        live[valid] = up[mat[valid]]
        mat[~live] = CRUSH_ITEM_NONE
        return mat

    def pg_counts(self, place=None) -> np.ndarray:
        if place is None:
            mat = self._placement_matrix()
            flat = mat[mat != CRUSH_ITEM_NONE]
            return np.bincount(flat, minlength=self.m.max_osd
                               ).astype(np.int64)
        counts = np.zeros(self.m.max_osd, dtype=np.int64)
        for osds in place.values():
            for o in osds:
                counts[o] += 1
        return counts

    def _targets(self) -> np.ndarray:
        """Per-OSD target load ∝ CRUSH device weight (in OSDs only)."""
        w = np.zeros(self.m.max_osd, dtype=np.float64)
        crush = self.m.crush
        for b in crush.buckets:
            if b is None:
                continue
            for it, bw in zip(b.items, b.weights):
                if it >= 0 and not self.m.is_out(it) \
                        and self.m.is_up(it):
                    w[it] = bw
        total_slots = self.pool.pg_num * self.pool.size
        if w.sum() == 0:
            return np.zeros_like(w)
        return total_slots * w / w.sum()

    def _live_mask(self) -> np.ndarray:
        st = np.asarray(self.m.osd_state, dtype=np.int64)
        wt = np.asarray(self.m.osd_weight, dtype=np.int64)
        return ((st & UP) != 0) & (wt != 0)

    def _rewire_items(self, pgid: PGid, omax: int,
                      ou: int) -> list[tuple[int, int]]:
        """The PG may sit on omax only VIA an existing upmap pair
        (raw→omax): rewrite that pair's target instead of appending a
        no-op (omax, ou) that _apply_upmap would ignore."""
        items = []
        rewired = False
        for a, b in self.m.pg_upmap_items.get(pgid, []):
            if b == omax and not rewired:
                items.append((a, ou))
                rewired = True
            else:
                items.append((a, b))
        if not rewired:
            items.append((omax, ou))
        return items

    # -- optimization ------------------------------------------------------
    def optimize(self, max_changes: int = 10,
                 deviation_stop: float = 1.0,
                 use_arrays: bool = True
                 ) -> dict[PGid, list[tuple[int, int]]]:
        """Propose up to max_changes pg_upmap_items changes.  Greedy
        per-round: move one replica off the currently fullest OSD to
        the most underfull compatible OSD (reference calc_pg_upmaps'
        retry loop, simplified to single-replica swaps).  The default
        array path and the legacy per-PG walk
        (``use_arrays=False``) propose identical moves."""
        if not use_arrays:
            return self._optimize_legacy(max_changes, deviation_stop)
        max_osd = self.m.max_osd
        mat = self._placement_matrix()
        flat = mat[mat != CRUSH_ITEM_NONE]
        counts = np.bincount(flat, minlength=max_osd
                             ).astype(np.float64)
        targets = self._targets()
        live = self._live_mask()
        # osd → failure-domain as an array (-1: no domain recorded)
        dom = np.full(max_osd, -1, dtype=np.int64)
        for o, d in self._domain_of.items():
            if 0 <= o < max_osd:
                dom[o] = d
        proposals: dict[PGid, list[tuple[int, int]]] = {}

        for _ in range(max_changes):
            dev = counts - targets
            dev[~live] = 0      # ignore out/down osds entirely
            omax = int(np.argmax(dev))
            if dev[omax] <= deviation_stop:
                break
            cand = np.nonzero(live & (dev < -0.5))[0]
            # stable sort keeps ascending-osd tie order, matching the
            # legacy sorted(..., key=dev) walk
            order = cand[np.argsort(dev[cand], kind="stable")]
            rows = np.nonzero((mat == omax).any(axis=1))[0]
            if order.size == 0 or rows.size == 0:
                break
            sub = mat[rows]                          # [P, S]
            # candidate already holds a replica of the PG?
            member = (sub[:, None, :] ==
                      order[None, :, None]).any(axis=2)      # [P, U]
            elig = ~member
            if self.domain_type:
                dsub = dom[np.clip(sub, 0, max_osd - 1)]
                invalid = (sub == omax) | (sub < 0) | (sub >= max_osd)
                dsub = np.where(invalid, _DOM_IGNORE, dsub)  # [P, S]
                d_ou = dom[order]                            # [U]
                conflict = (dsub[:, None, :] ==
                            d_ou[None, :, None]).any(axis=2)
                elig &= ~conflict
            hit = elig.any(axis=1)
            if not hit.any():
                break
            # first PG in seed order with a compatible candidate,
            # then its most-underfull compatible candidate — the
            # exact pair the legacy nested loops pick
            r = int(np.argmax(hit))
            ou = int(order[int(np.argmax(elig[r]))])
            seed = int(rows[r])
            pgid = PGid(self.pool.id, seed)
            items = self._rewire_items(pgid, omax, ou)
            proposals[pgid] = items
            # apply locally for subsequent rounds
            self.m.pg_upmap_items[pgid] = items
            mat[seed][mat[seed] == omax] = ou
            counts[omax] -= 1
            counts[ou] += 1
        return proposals

    def _optimize_legacy(self, max_changes: int = 10,
                         deviation_stop: float = 1.0
                         ) -> dict[PGid, list[tuple[int, int]]]:
        """The original per-PG dict walk, kept verbatim as the
        equality oracle for the array round."""
        place = self._placements()
        counts = self.pg_counts(place).astype(np.float64)
        targets = self._targets()
        proposals: dict[PGid, list[tuple[int, int]]] = {}
        pgs_by_osd: dict[int, set[PGid]] = {}
        for pgid, osds in place.items():
            for o in osds:
                pgs_by_osd.setdefault(o, set()).add(pgid)

        for _ in range(max_changes):
            dev = counts - targets
            # ignore out/down osds entirely
            for o in range(self.m.max_osd):
                if not self.m.is_up(o) or self.m.is_out(o):
                    dev[o] = 0
            omax = int(np.argmax(dev))
            if dev[omax] <= deviation_stop:
                break
            under = sorted(
                (o for o in range(self.m.max_osd)
                 if self.m.is_up(o) and not self.m.is_out(o)
                 and dev[o] < -0.5),
                key=lambda o: dev[o])
            moved = False
            for pgid in sorted(pgs_by_osd.get(omax, ()),
                               key=lambda p: p.seed):
                others = [o for o in place[pgid] if o != omax]
                used_domains = {self._domain_of.get(o) for o in others} \
                    if self.domain_type else set()
                for ou in under:
                    if ou in place[pgid]:
                        continue
                    if self.domain_type and \
                            self._domain_of.get(ou) in used_domains:
                        continue
                    items = self._rewire_items(pgid, omax, ou)
                    proposals[pgid] = items
                    # apply locally for subsequent rounds
                    self.m.pg_upmap_items[pgid] = items
                    place[pgid] = [ou if o == omax else o
                                   for o in place[pgid]]
                    pgs_by_osd[omax].discard(pgid)
                    pgs_by_osd.setdefault(ou, set()).add(pgid)
                    counts[omax] -= 1
                    counts[ou] += 1
                    moved = True
                    break
                if moved:
                    break
            if not moved:
                break
        return proposals

    def stddev(self) -> float:
        counts = self.pg_counts().astype(np.float64)
        live = self._live_mask()
        return float(np.std(counts[live]))
