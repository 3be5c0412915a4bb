"""Deterministic space-saving top-K heavy-hitter sketches.

The port's copy of ``ceph_tpu.core.topk``.

Workload attribution (reference: the mgr ``iostat``/``insights``
modules and ``rbd perf image iostat`` answer "who is hurting the
cluster"; SURVEY.md §3.10): each OSD tracks the heaviest client/
tenant, pool, and PG keys crossing its op path with the Metwally
space-saving algorithm — k counters, O(1) per op, and a per-entry
overestimation bound ``err`` instead of unbounded per-key state.

Space-saving invariants (Metwally et al., "Efficient computation of
frequent and top-k elements in data streams"):

- a tracked key's ``ops`` overestimates its true count by at most its
  ``err`` (the evicted minimum it inherited);
- any key whose true count exceeds the sketch minimum is guaranteed
  to be tracked — the top-1 of a skewed stream is exact once its
  lead exceeds the eviction noise.

Determinism: no randomness anywhere — ties on eviction break by key
string, so equal streams produce bit-equal sketches (the same replay
contract the autotune/alert engines keep).

Each entry also carries rider aggregates (``bytes``, ``lat_sum_us``,
and a log2 latency histogram) so the mgr can rank by bytes or p99,
not just op count.  Only the COUNT inherits on eviction (that is what
the guarantee above needs); riders reset to zero, so bytes/latency
are exact-but-possibly-partial for keys that churned through the
eviction floor — a byte ranking never shows another tenant's load.

Cluster merge: summing per-OSD sketches key-wise is the standard
mergeable-summary construction; a key missing from one saturated
sketch may be hiding below that sketch's minimum, so the merged
``err`` adds that minimum for every sketch the key was absent from.
"""

from __future__ import annotations

HIST_BUCKETS = 28       # log2 µs buckets: 2^27 µs ≈ 134 s ceiling


def _bucket(v: float, n: int = HIST_BUCKETS) -> int:
    """Same log2 bucket rule as perf_counters.LogHistogram."""
    if v <= 0:
        return 0
    import math
    return min(int(math.log2(v + 1)), n - 1)


def hist_quantile(counts, q: float) -> float:
    """Quantile from log2 bucket counts → bucket upper bound (µs)."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    need = q * total
    seen = 0
    for i, c in enumerate(counts):
        seen += c
        if seen >= need:
            return float((1 << (i + 1)) - 1)
    return float((1 << len(counts)) - 1)


class SpaceSaving:
    """One dimension's sketch: at most ``k`` tracked keys."""

    __slots__ = ("k", "entries")

    def __init__(self, k: int = 16):
        self.k = max(1, int(k))
        # key -> [ops, err, bytes, lat_sum_us, hist list]
        self.entries: dict[str, list] = {}

    def update(self, key: str, ops: int = 1, nbytes: int = 0,
               lat_us: float | None = None) -> None:
        e = self.entries.get(key)
        if e is None:
            if len(self.entries) >= self.k:
                # evict the minimum (deterministic tie-break by key):
                # the newcomer inherits the COUNT as its error bound
                # (the space-saving guarantee needs it), but the
                # riders reset — bytes/latency only ever attribute
                # traffic observed while the key was tracked, so a
                # byte or p99 ranking never carries another tenant's
                # load under a new key's name
                mkey = min(self.entries,
                           key=lambda x: (self.entries[x][0], x))
                mcount = self.entries.pop(mkey)[0]
                e = [mcount, mcount, 0, 0.0, [0] * HIST_BUCKETS]
            else:
                e = [0, 0, 0, 0.0, [0] * HIST_BUCKETS]
            self.entries[key] = e
        e[0] += ops
        e[2] += nbytes
        if lat_us is not None:
            e[3] += lat_us
            e[4][_bucket(lat_us)] += 1

    def min_count(self) -> int:
        """Eviction floor: 0 until the sketch saturates."""
        if len(self.entries) < self.k:
            return 0
        return min(e[0] for e in self.entries.values())

    def dump(self) -> dict:
        return {"k": self.k,
                "min": self.min_count(),
                "entries": {key: {"ops": e[0], "err": e[1],
                                  "bytes": e[2],
                                  "lat_sum_us": e[3],
                                  "hist": list(e[4])}
                            for key, e in self.entries.items()}}

    def reset(self) -> None:
        self.entries.clear()


def merge_sketches(dumps: list[dict], k: int | None = None) -> dict:
    """Merge per-OSD ``SpaceSaving.dump()``s into one cluster sketch.

    Key-wise sums; a key absent from a saturated sketch adds that
    sketch's minimum to the merged ``err`` (it may be hiding below
    the floor there).  The merged view keeps the top ``k`` by ops."""
    union: dict[str, dict] = {}
    for d in dumps:
        for key, e in (d.get("entries") or {}).items():
            m = union.setdefault(key, {
                "ops": 0, "err": 0, "bytes": 0, "lat_sum_us": 0.0,
                "hist": [0] * HIST_BUCKETS})
            m["ops"] += int(e.get("ops", 0))
            m["err"] += int(e.get("err", 0))
            m["bytes"] += int(e.get("bytes", 0))
            m["lat_sum_us"] += float(e.get("lat_sum_us", 0.0))
            h = e.get("hist") or []
            for i, c in enumerate(h[:HIST_BUCKETS]):
                m["hist"][i] += int(c)
    for d in dumps:
        floor = int(d.get("min") or 0)
        if floor <= 0:
            continue
        entries = d.get("entries") or {}
        for key, m in union.items():
            if key not in entries:
                m["err"] += floor
    if k:
        keep = sorted(union,
                      key=lambda x: (-union[x]["ops"], x))[:int(k)]
        union = {key: union[key] for key in keep}
    return {"k": k or max((int(d.get("k") or 0) for d in dumps),
                          default=0),
            "min": sum(int(d.get("min") or 0) for d in dumps),
            "entries": union}


def rank(dump: dict, by: str = "ops", n: int = 10) -> list[dict]:
    """Render a sketch dump as a sorted row list.

    ``by``: ops | bytes | p99 — p99 from each entry's log2 latency
    histogram (bucket upper bound, µs → ms in the row)."""
    rows = []
    for key, e in (dump.get("entries") or {}).items():
        ops = int(e.get("ops", 0))
        hist = e.get("hist") or []
        rows.append({
            "key": key,
            "ops": ops,
            "err": int(e.get("err", 0)),
            "bytes": int(e.get("bytes", 0)),
            "lat_avg_ms": (float(e.get("lat_sum_us", 0.0)) / ops
                           / 1e3 if ops else 0.0),
            "p99_ms": hist_quantile(hist, 0.99) / 1e3,
        })
    order = {"ops": lambda r: (-r["ops"], r["key"]),
             "bytes": lambda r: (-r["bytes"], r["key"]),
             "p99": lambda r: (-r["p99_ms"], r["key"])}
    rows.sort(key=order.get(by, order["ops"]))
    return rows[:n]


class TopKSet:
    """The OSD's three attribution dimensions, updated as one call on
    the op-reply path.  ``enabled`` gates the whole set (the A/B
    bench toggles it live); updates are GIL-atomic dict/list ops, no
    lock — the same relaxed tradeoff PerfCounters makes."""

    DIMS = ("clients", "pools", "pgs")

    def __init__(self, k: int = 16, enabled: bool = True):
        self.enabled = bool(enabled)
        self.sketches = {d: SpaceSaving(k) for d in self.DIMS}

    def set_k(self, k: int) -> None:
        """Resize: rebuild each sketch keeping the heaviest keys."""
        k = max(1, int(k))
        for dim, sk in self.sketches.items():
            fresh = SpaceSaving(k)
            keep = sorted(sk.entries,
                          key=lambda x: (-sk.entries[x][0], x))[:k]
            fresh.entries = {key: sk.entries[key] for key in keep}
            self.sketches[dim] = fresh

    def update(self, client: str, pool: str, pg: str,
               nbytes: int = 0, lat_s: float = 0.0) -> None:
        if not self.enabled:
            return
        lat_us = lat_s * 1e6
        self.sketches["clients"].update(str(client), 1, nbytes, lat_us)
        self.sketches["pools"].update(str(pool), 1, nbytes, lat_us)
        self.sketches["pgs"].update(str(pg), 1, nbytes, lat_us)

    def dump(self) -> dict:
        return {dim: sk.dump() for dim, sk in self.sketches.items()}

    def reset(self) -> None:
        for sk in self.sketches.values():
            sk.reset()
