"""The in-process cluster harnesses (vstart.sh analog).

The port's copy of ``ceph_tpu.vstart``, so far only ``ScaleHarness``:
the million-PG control plane without daemons.  ``MiniCluster`` waits
for the OSD daemon.
"""

from __future__ import annotations

import time


class ScaleHarness:
    """Synthetic million-PG control plane — no daemons, no sockets.

    Stands up the mon/mgr aggregation state (OSDMap + array PGMap +
    per-OSD stats) for ``n_osds``/``pg_num`` directly, the way a
    vstart cluster would look after every OSD reported once, so the
    health/summary/balancer passes can be exercised and timed at
    scales no in-process cluster could reach (4096 OSDs, 2^20 PGs).
    Placement is either one batched CRUSH evaluation of the whole pool
    (``placement="crush"``: the port's ``BatchMapper`` on ``device``,
    ``None`` meaning the card, raising without one) or collision-free
    uniform sampling (``"synthetic"``, the default — mapping cost
    stays out of control-plane timings).

    Everything is deterministic in ``seed``: two harnesses built with
    the same arguments hold bit-identical state, which is what lets
    the tier-1 equality test run the array and legacy paths on twins.
    """

    STATE_MIX = (
        ("active+clean", 0.97),
        ("active+undersized+degraded", 0.015),
        ("active+remapped+backfilling", 0.008),
        ("active+clean+scrubbing", 0.004),
        ("down", 0.002),
        ("incomplete", 0.001),
    )

    def __init__(self, n_osds: int = 4096, pg_num: int = 1 << 20, *,
                 size: int = 3, seed: int = 0,
                 placement: str = "synthetic",
                 down_osds: int = 0,
                 damaged_frac: float = 1e-4,
                 scrub_late_frac: float = 1e-3,
                 stale_frac: float = 0.0,
                 scrub_interval: float | None = None,
                 now: float | None = None, device=None):
        import numpy as np
        from .crush.map import build_flat_map
        from .mon import health
        from .mon.pgmap import PGMap
        from .osd.osdmap import EXISTS, UP, OSDMap

        self.now = time.time() if now is None else now
        self.n_osds, self.pg_num, self.size = n_osds, pg_num, size
        rng = np.random.default_rng(seed)

        m = OSDMap(crush=build_flat_map(n_osds), max_osd=n_osds)
        m.epoch = 1
        for o in range(n_osds):
            m.osd_state[o] = EXISTS | UP
        for o in range(down_osds):
            m.mark_down(o)
        self.pool = m.create_pool("scale", pg_num=pg_num, size=size,
                                  crush_rule=0)
        self.osdmap = m

        if placement == "crush":
            from .tools.osdmaptool import map_pool_pgs
            self.placements = np.asarray(
                map_pool_pgs(m, self.pool, device=device), dtype=np.int64)
        elif placement == "synthetic":
            self.placements = self._sample_placements(rng)
        else:
            raise ValueError(f"placement={placement!r}")

        # -- pg_stats: one vectorized ingest --------------------------
        names = [s for s, _w in self.STATE_MIX]
        probs = np.array([w for _s, w in self.STATE_MIX])
        codes = rng.choice(len(names), size=pg_num,
                           p=probs / probs.sum())
        interval = health.SCRUB_WARN_INTERVAL \
            if scrub_interval is None else scrub_interval
        lss = self.now - rng.uniform(0.0, 0.5 * interval, pg_num)
        late = rng.random(pg_num) < scrub_late_frac
        lss[late] = self.now - interval * (2.0 + rng.random(late.sum()))
        errs = np.zeros(pg_num, dtype=np.int64)
        dmg = rng.random(pg_num) < damaged_frac
        errs[dmg] = rng.integers(1, 5, dmg.sum())
        degraded = np.isin(codes,
                           [names.index("active+undersized+degraded"),
                            names.index("active+remapped+backfilling")])
        stamp = np.full(pg_num, self.now)
        if stale_frac:
            stale = rng.random(pg_num) < stale_frac
            stamp[stale] = self.now - 10 * health.PG_STALE_GRACE

        pgm = PGMap()
        pgm.ingest_columns(
            self.pool.id, np.arange(pg_num, dtype=np.int64),
            state_names=names, state_codes=codes, stamp=stamp,
            num_objects=rng.integers(0, 2000, pg_num),
            num_bytes=rng.integers(0, 1 << 24, pg_num),
            log_size=rng.integers(0, 100, pg_num),
            missing=np.where(degraded,
                             rng.integers(1, 50, pg_num), 0),
            backfill_remaining=np.where(
                degraded, rng.integers(0, 200, pg_num), 0),
            scrub_errors=errs,
            last_scrub_stamp=lss,
            osd=self.placements[:, 0],
        )
        for o in range(n_osds):
            pgm.osd_stats[o] = {
                "kb": 1 << 20, "kb_used": 1 << 19,
                "bytes_total": 1 << 30, "bytes_used": 1 << 29,
                "op": 100 * o, "op_w": 60 * o, "op_r": 40 * o,
                "stamp": self.now,
            }
        self.pgmap = pgm

    def _sample_placements(self, rng):
        """[pg_num, size] uniform OSD ids, no repeats within a row
        (resample colliding rows until clean — a handful of passes at
        size=3 vs thousands of OSDs)."""
        import numpy as np
        place = rng.integers(0, self.n_osds,
                             size=(self.pg_num, self.size),
                             dtype=np.int64)
        while True:
            srt = np.sort(place, axis=1)
            dup = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
            if not dup.any():
                return place
            place[dup] = rng.integers(0, self.n_osds,
                                      size=(int(dup.sum()), self.size),
                                      dtype=np.int64)

    # -- control-plane entry points -----------------------------------
    def health_context(self):
        from .mon.health import HealthContext
        return HealthContext(osdmap=self.osdmap, pgmap=self.pgmap,
                             monmap_ranks=[0], quorum=[0],
                             now=self.now)

    def evaluate(self) -> list[dict]:
        """One full health pass: states histogram + every registered
        evaluator over the array PGMap."""
        from .mon.health import evaluate_checks
        return evaluate_checks(self.health_context())

    def summary(self) -> dict:
        return self.pgmap.summary(live_pools={self.pool.id},
                                  now=self.now,
                                  total_expected=self.pg_num)

    def legacy_pgmap(self):
        """Dict-backed twin of the array map (materializes every row
        — meant for the fast equality tier, not the 1M smoke)."""
        from .mon.pgmap import LegacyPGMap
        lm = LegacyPGMap()
        lm.pg_stats = self.pgmap.dump()
        lm.osd_stats = {o: dict(st)
                        for o, st in self.pgmap.osd_stats.items()}
        return lm

    def balancer(self):
        """UpmapBalancer over the injected placements (no CRUSH
        recompute); pick the round implementation via
        ``optimize(use_arrays=...)``."""
        from .mgr.balancer import UpmapBalancer
        return UpmapBalancer(self.osdmap, self.pool.id,
                             placements=self.placements)
