"""Array PGMap — struct-of-arrays PG state aggregation.

The port's copy of ``ceph_tpu.mon.pgmap``.

The device plane is batch-native (CRUSH maps a whole pool in one
launch, EC encodes stripes as matrices), but the mon's PGMap was
still a dict-of-dicts: every health evaluator walked
``pg_stats.items()`` in Python, so a million-PG cluster would spend
~0.5 s *per mon tick* just counting states.  This module applies the
paper's core move — replace per-object scalar control loops with
batched array programs — to the aggregation spine itself:

* PG state lives in parallel numpy columns (interned state ids,
  stamps, per-PG counters, scrub stamps) plus a per-row presence
  bitmask, kept incrementally in sync by ``apply_report``;
* summary/health passes are masked reductions (``bincount`` over
  ``state_id*2+stale``, scatter-adds per pool) returning compact
  offender indices only where detail rendering needs them;
* an optional device fold (``summary_arrays(use_device=True)``) runs
  the state×stale histogram and the four totals as one hand CUDA
  kernel (K11, ``csrc/pgmap_fold.cu``) on the card;
* the dict-shaped API survives as a thin **write-through view**
  (``pg_stats[pgid]`` returns a row proxy; mutating the proxy mutates
  the arrays) so every existing CLI/health/history surface stays
  bit-identical, including tests that edit returned rows in place.

``LegacyPGMap`` keeps the original dict implementation verbatim — the
equality oracle the tier-1 tests diff the array path against.
"""

from __future__ import annotations

import time
from collections.abc import MutableMapping

import numpy as np
import torch

from ..kernels import build

PG_STALE_GRACE = 6.0     # seconds without a primary report → stale

# Known per-PG report fields → (column name, kind, presence bit).
# Kind: "i" int64, "f" float64, "state" interned str, "osd" int32.
# ``inconsistent_objects`` has a presence bit but its (rarely
# non-empty) payload lives in the sparse ``_extra`` side table.
_FIELDS: dict[str, tuple[str, str, int]] = {}
for _i, (_name, _kind) in enumerate((
        ("state", "state"),
        ("num_objects", "i"), ("num_bytes", "i"),
        ("num_bytes_logical", "i"), ("log_size", "i"),
        ("missing", "i"), ("backfill_remaining", "i"),
        ("last_scrub", "f"), ("last_deep_scrub", "f"),
        ("last_scrub_stamp", "f"),
        ("scrub_errors", "i"),
        ("inconsistent_objects", "x"),
        ("scrub_chunks_done", "i"), ("scrub_chunks_total", "i"),
        ("osd", "osd"), ("stamp", "f"))):
    _FIELDS[_name] = (_name, _kind, 1 << _i)

_BIT = {k: b for k, (_c, _k, b) in _FIELDS.items()}
_F_NBL = _BIT["num_bytes_logical"]
_F_LSS = _BIT["last_scrub_stamp"]
_F_SCT = _BIT["scrub_chunks_total"]


def _parse_pgid(pgid: str) -> tuple[int, int]:
    """'pool.seedhex' → (pool, seed); -1 where unparsable (matching
    the legacy prune's int() try/except on the pool part)."""
    head, _, tail = str(pgid).partition(".")
    try:
        pool = int(head)
    except ValueError:
        pool = -1
    try:
        seed = int(tail, 16)
        if seed < 0:
            seed = -1
    except ValueError:
        seed = -1
    return pool, seed


class _PGRow(MutableMapping):
    """Write-through proxy for one PG's stats row.

    Survives compactions: the row index is revalidated against the
    map's compaction generation on every access, so ``list(
    pg_stats.values())[0]["k"] = v`` keeps editing the right PG even
    if a prune shuffled rows in between."""

    __slots__ = ("_m", "_row", "_gen", "_pgid")

    def __init__(self, m: "PGMap", row: int):
        self._m = m
        self._row = row
        self._gen = m._compact_gen
        self._pgid = m._pgid_str(row)

    def _r(self) -> int:
        if self._gen != self._m._compact_gen:
            self._row = self._m._row_of(self._pgid)   # KeyError if gone
            self._gen = self._m._compact_gen
        return self._row

    def __getitem__(self, k):
        return self._m._get_field(self._r(), k)

    def __setitem__(self, k, v):
        self._m._set_field(self._r(), k, v)
        self._m._version += 1

    def __delitem__(self, k):
        self._m._del_field(self._r(), k)
        self._m._version += 1

    def __iter__(self):
        row = self._r()
        present = int(self._m._present[row])
        for k, (_c, kind, bit) in _FIELDS.items():
            if present & bit and not (kind == "x"):
                yield k
        if present & _BIT["inconsistent_objects"]:
            yield "inconsistent_objects"
        for k in self._m._extra.get(row, ()):
            if k not in _FIELDS:
                yield k

    def __len__(self):
        return sum(1 for _ in self)

    def __eq__(self, other):
        if isinstance(other, (dict, MutableMapping)):
            return dict(self) == dict(other)
        return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    def __repr__(self):
        return f"_PGRow({self._pgid}, {dict(self)!r})"


class _PGStatsView(MutableMapping):
    """The dict-shaped facade over the arrays: ``pg_stats`` keeps
    behaving like ``dict[str, dict]`` for every legacy consumer."""

    __slots__ = ("_m",)

    def __init__(self, m: "PGMap"):
        self._m = m

    def __getitem__(self, pgid) -> _PGRow:
        return _PGRow(self._m, self._m._row_of(str(pgid)))

    def __setitem__(self, pgid, st):
        self._m._ingest(str(pgid), st)
        self._m._version += 1

    def __delitem__(self, pgid):
        self._m._delete(str(pgid))

    def __iter__(self):
        m = self._m
        gen = m._compact_gen
        for row in range(m._n):
            if m._compact_gen != gen:       # mutated mid-iteration
                raise RuntimeError("pg_stats changed during iteration")
            yield m._pgid_str(row)

    def __len__(self):
        return self._m._n

    def __contains__(self, pgid):
        try:
            self._m._row_of(str(pgid))
            return True
        except KeyError:
            return False

    def __eq__(self, other):
        if isinstance(other, (dict, MutableMapping)):
            if len(self) != len(other):
                return False
            try:
                return all(dict(self[k]) == dict(other[k])
                           for k in other)
            except KeyError:
                return False
        return NotImplemented

    def __ne__(self, other):
        eq = self.__eq__(other)
        return NotImplemented if eq is NotImplemented else not eq

    def __repr__(self):
        return f"_PGStatsView({self._m.dump()!r})"


class PGMap:
    """Struct-of-arrays PGMap (drop-in for the legacy dict one).

    Columns are padded to capacity; ``_n`` rows are live.  Pruning
    compacts in one vectorized pass.  ``osd_stats`` stays a plain
    dict — it is O(n_osds), not O(n_pgs), and callers index it with
    heterogeneous key types."""

    _GROW_MIN = 64

    def __init__(self):
        self.osd_stats: dict[int, dict] = {}
        self._n = 0
        self._cap = 0
        self._cols: dict[str, np.ndarray] = {}
        self._present = np.zeros(0, dtype=np.uint32)
        self._pool = np.zeros(0, dtype=np.int64)
        self._seed = np.zeros(0, dtype=np.int64)
        self._keys: list[str | None] = []
        self._extra: dict[int, dict] = {}
        self._index: dict[str, int] | None = {}
        # state-string intern table; id 0 is the absent-state default
        self._state_names: list[str] = ["unknown"]
        self._state_ids: dict[str, int] = {"unknown": 0}
        self._scrubbing_lut = np.zeros(1, dtype=bool)
        self._version = 0
        self._compact_gen = 0

    # -- dict-shaped surface ----------------------------------------------

    @property
    def pg_stats(self) -> _PGStatsView:
        return _PGStatsView(self)

    def apply_report(self, osd: int, pg_stats: dict, osd_stats: dict):
        now = time.time()
        for pgid, st in (pg_stats or {}).items():
            self._ingest(str(pgid), st, osd=osd, stamp=now)
        if osd_stats:
            self.osd_stats[osd] = dict(osd_stats, stamp=now)
        self._version += 1

    def prune(self, live_pools: set[int]):
        """Drop stats for PGs of deleted pools (vectorized isin +
        one compaction instead of the legacy per-key loop)."""
        if self._n == 0:
            return
        pools = np.fromiter(live_pools, dtype=np.int64,
                            count=len(live_pools)) \
            if live_pools else np.empty(0, dtype=np.int64)
        keep = np.isin(self._pool[:self._n], pools)
        if keep.all():
            return
        self._compact(keep)

    # -- interning / storage ----------------------------------------------

    def _intern(self, state) -> int:
        s = state if isinstance(state, str) else str(state)
        sid = self._state_ids.get(s)
        if sid is None:
            sid = len(self._state_names)
            self._state_ids[s] = sid
            self._state_names.append(s)
            self._scrubbing_lut = np.array(
                ["scrubbing" in n for n in self._state_names],
                dtype=bool)
        return sid

    def _ensure_capacity(self, need: int):
        if need <= self._cap:
            return
        cap = max(self._GROW_MIN, 2 * self._cap, need)

        def grow(arr, fill):
            out = np.full(cap, fill, dtype=arr.dtype)
            out[:self._n] = arr[:self._n]
            return out

        if not self._cols:
            for k, (col, kind, _b) in _FIELDS.items():
                if kind == "i":
                    self._cols[col] = np.zeros(0, dtype=np.int64)
                elif kind == "f":
                    self._cols[col] = np.zeros(0, dtype=np.float64)
                elif kind == "osd":
                    self._cols[col] = np.zeros(0, dtype=np.int64)
            self._cols["state"] = np.zeros(0, dtype=np.int64)
        for col, arr in self._cols.items():
            fill = np.nan if arr.dtype == np.float64 else \
                (-1 if col == "osd" else 0)
            self._cols[col] = grow(arr, fill)
        self._present = grow(self._present, 0)
        self._pool = grow(self._pool, -1)
        self._seed = grow(self._seed, -1)
        self._cap = cap

    def _row_of(self, pgid: str) -> int:
        if self._index is None:
            self._index = {self._pgid_str(r): r
                           for r in range(self._n)}
        return self._index[pgid]

    def _pgid_str(self, row: int) -> str:
        k = self._keys[row]
        if k is None:
            k = f"{self._pool[row]}.{self._seed[row]:x}"
            self._keys[row] = k
        return k

    def _new_row(self, pgid: str) -> int:
        self._ensure_capacity(self._n + 1)
        row = self._n
        self._n += 1
        pool, seed = _parse_pgid(pgid)
        self._pool[row] = pool
        self._seed[row] = seed
        self._keys.append(pgid)
        if self._index is not None:
            self._index[pgid] = row
        return row

    def _reset_row(self, row: int):
        for col, arr in self._cols.items():
            arr[row] = np.nan if arr.dtype == np.float64 else \
                (-1 if col == "osd" else 0)
        self._present[row] = 0
        self._extra.pop(row, None)

    def _ingest(self, pgid: str, st: dict,
                osd: int | None = None, stamp: float | None = None):
        try:
            row = self._row_of(pgid)
        except KeyError:
            row = self._new_row(pgid)
        # reset both paths: a fresh row index may reuse memory a
        # compaction left behind
        self._reset_row(row)
        for k, v in st.items():
            self._set_field(row, k, v)
        if osd is not None:
            self._set_field(row, "osd", osd)
        if stamp is not None:
            self._set_field(row, "stamp", stamp)

    def _set_field(self, row: int, k, v):
        spec = _FIELDS.get(k)
        if spec is None:
            self._extra.setdefault(row, {})[k] = v
            return
        col, kind, bit = spec
        if kind == "state":
            self._cols["state"][row] = self._intern(v)
        elif kind == "i":
            self._cols[col][row] = int(v)
        elif kind == "f":
            self._cols[col][row] = float(v)
        elif kind == "osd":
            self._cols["osd"][row] = int(v)
        elif kind == "x":       # inconsistent_objects
            if v:
                self._extra.setdefault(row, {})[k] = v
            else:
                ex = self._extra.get(row)
                if ex:
                    ex.pop(k, None)
        self._present[row] |= np.uint32(bit)

    def _get_field(self, row: int, k):
        spec = _FIELDS.get(k)
        if spec is None:
            ex = self._extra.get(row)
            if ex is None or k not in ex:
                raise KeyError(k)
            return ex[k]
        col, kind, bit = spec
        if not int(self._present[row]) & bit:
            raise KeyError(k)
        if kind == "state":
            return self._state_names[int(self._cols["state"][row])]
        if kind == "i":
            return int(self._cols[col][row])
        if kind == "f":
            return float(self._cols[col][row])
        if kind == "osd":
            return int(self._cols["osd"][row])
        return self._extra.get(row, {}).get(k, [])

    def _del_field(self, row: int, k):
        spec = _FIELDS.get(k)
        if spec is None:
            ex = self._extra.get(row)
            if ex is None or k not in ex:
                raise KeyError(k)
            del ex[k]
            return
        col, kind, bit = spec
        if not int(self._present[row]) & bit:
            raise KeyError(k)
        self._present[row] &= np.uint32(~np.uint32(bit))
        if kind == "x":
            ex = self._extra.get(row)
            if ex:
                ex.pop(k, None)
        elif kind == "state":
            self._cols["state"][row] = 0
        else:
            arr = self._cols[col]
            arr[row] = np.nan if arr.dtype == np.float64 else \
                (-1 if col == "osd" else 0)

    def _delete(self, pgid: str):
        row = self._row_of(pgid)
        keep = np.ones(self._n, dtype=bool)
        keep[row] = False
        self._compact(keep)

    def _compact(self, keep: np.ndarray):
        kept = np.nonzero(keep)[0]
        n_new = len(kept)
        for col, arr in self._cols.items():
            arr[:n_new] = arr[kept]
        self._present[:n_new] = self._present[kept]
        self._pool[:n_new] = self._pool[kept]
        self._seed[:n_new] = self._seed[kept]
        self._keys = [self._keys[i] for i in kept]
        if self._extra:
            remap = {}
            old2new = {int(o): i for i, o in enumerate(kept)}
            for old, v in self._extra.items():
                new = old2new.get(old)
                if new is not None:
                    remap[new] = v
            self._extra = remap
        self._n = n_new
        self._index = None
        self._compact_gen += 1
        self._version += 1

    # -- bulk ingestion (scale harness) -----------------------------------

    def ingest_columns(self, pool_id: int, seeds: np.ndarray, *,
                       state_names: list[str],
                       state_codes: np.ndarray,
                       stamp, **columns) -> None:
        """Append one row per seed in a single vectorized pass —
        the scale harness's way of standing up a million-PG map
        without a million dict inserts.  ``state_codes`` indexes
        ``state_names``; ``columns`` maps known field names to arrays
        or scalars (broadcast)."""
        seeds = np.asarray(seeds, dtype=np.int64)
        count = len(seeds)
        if count == 0:
            return
        base = self._n
        self._ensure_capacity(base + count)
        end = base + count
        self._n = end
        self._pool[base:end] = pool_id
        self._seed[base:end] = seeds
        self._keys.extend([None] * count)
        ids = np.array([self._intern(s) for s in state_names],
                       dtype=np.int64)
        self._cols["state"][base:end] = \
            ids[np.asarray(state_codes, dtype=np.int64)]
        bits = _BIT["state"] | _BIT["stamp"]
        self._cols["stamp"][base:end] = stamp
        for k, v in columns.items():
            col, kind, bit = _FIELDS[k]
            if kind not in ("i", "f", "osd"):
                raise ValueError(f"ingest_columns: scalar field "
                                 f"expected, got {k!r}")
            self._cols[col][base:end] = v
            bits |= bit
        self._present[base:end] = bits
        self._index = None
        self._version += 1

    # -- vectorized reductions --------------------------------------------

    def states(self, total_expected: int | None = None,
               now: float | None = None) -> dict:
        """state string → count; primaries silent past the grace are
        'stale+<last state>', PGs never reported at all 'unknown' —
        one bincount over ``state_id*2 + stale`` instead of a dict
        walk."""
        now = time.time() if now is None else now
        out: dict[str, int] = {}
        n = self._n
        if n:
            hist = self._state_stale_hist(now)
            for i in np.nonzero(hist)[0]:
                name = self._state_names[i >> 1]
                if i & 1:
                    name = f"stale+{name}"
                out[name] = int(hist[i])
        if total_expected is not None and total_expected > n:
            out["unknown"] = out.get("unknown", 0) + \
                (total_expected - n)
        return out

    def _state_stale_hist(self, now: float) -> np.ndarray:
        n = self._n
        sid = self._cols["state"][:n]
        stamp = self._cols["stamp"][:n]
        with np.errstate(invalid="ignore"):
            stale = (now - stamp) > PG_STALE_GRACE
        return np.bincount(sid * 2 + stale,
                           minlength=2 * len(self._state_names))

    def num_objects(self) -> int:
        return int(self._cols["num_objects"][:self._n].sum()) \
            if self._n else 0

    def pool_usage(self, live_pools: set[int]) -> dict[int, list]:
        """pool id → [objects, stored_bytes, logical_bytes] — three
        scatter-adds after pruning dead pools."""
        self.prune(live_pools)
        n = self._n
        if n == 0:
            return {}
        pid = self._pool[:n]
        valid = pid >= 0
        ids = pid[valid].astype(np.int64)
        if ids.size == 0:
            return {}
        nb = self._cols["num_bytes"][:n][valid]
        nbl = np.where(
            (self._present[:n][valid] & _F_NBL) != 0,
            self._cols["num_bytes_logical"][:n][valid], nb)
        length = int(ids.max()) + 1
        objs = np.bincount(ids, weights=self._cols["num_objects"]
                           [:n][valid], minlength=length)
        stored = np.bincount(ids, weights=nb, minlength=length)
        logical = np.bincount(ids, weights=nbl, minlength=length)
        pgs = np.bincount(ids, minlength=length)
        return {int(p): [int(objs[p]), int(stored[p]),
                         int(logical[p])]
                for p in np.nonzero(pgs)[0]}

    def dedup_totals(self) -> dict:
        out = {"chunks": 0, "refs": 0, "stored_bytes": 0,
               "referenced_bytes": 0}
        for st in self.osd_stats.values():
            d = st.get("dedup") or {}
            for k in out:
                out[k] += int(d.get(k, 0))
        return out

    def damaged(self) -> list[tuple[str, int]]:
        """(pgid, scrub_errors) offenders, sorted by pgid — the
        PG_DAMAGED reduction (compare + nonzero, detail only for the
        offenders)."""
        n = self._n
        if n == 0:
            return []
        err = self._cols["scrub_errors"][:n]
        rows = np.nonzero(err > 0)[0]
        return sorted((self._pgid_str(int(r)), int(err[r]))
                      for r in rows)

    def scrub_late(self, now: float,
                   interval: float) -> list[tuple[str, float]]:
        """(pgid, age) for PGs whose last_scrub_stamp is older than
        ``interval``, sorted by pgid — the PG_NOT_SCRUBBED
        reduction."""
        n = self._n
        if n == 0:
            return []
        lss = self._cols["last_scrub_stamp"][:n]
        present = (self._present[:n] & _F_LSS) != 0
        with np.errstate(invalid="ignore"):
            age = now - lss
            rows = np.nonzero(present & (age > interval))[0]
        return sorted((self._pgid_str(int(r)), float(age[r]))
                      for r in rows)

    def pool_clean_count(self, pool_id: int, pg_num: int,
                         state: str = "active+clean") -> int:
        """How many of pool's first pg_num PGs report ``state`` —
        the stretch-recovery predicate as one masked reduction."""
        sid = self._state_ids.get(state)
        if sid is None or self._n == 0:
            return 0
        n = self._n
        m = (self._pool[:n] == pool_id) & (self._seed[:n] < pg_num) \
            & (self._seed[:n] >= 0) & (self._cols["state"][:n] == sid)
        return int(m.sum())

    def summary_arrays(self, now: float, use_device: bool = False,
                       device=None) -> dict:
        """The fused summary fold: state×stale histogram + cluster
        totals in one pass.  ``use_device=True`` copies the six columns
        to ``device`` (``None``: the card, raising without one;
        ``"cpu"``: the plain version) and folds them with K11 (same
        outputs, held equal value for value in the tests); numpy is the
        default so the mon tick never depends on a device."""
        n = self._n
        if n == 0:
            return {"state_stale_hist":
                    np.zeros(2 * len(self._state_names),
                             dtype=np.int64),
                    "num_objects": 0, "missing": 0,
                    "backfill_remaining": 0, "scrub_errors": 0}
        if use_device:
            from ..utils.device import resolve_device
            dev = resolve_device(device)
            cols = [torch.from_numpy(np.ascontiguousarray(
                self._cols[c][:n])).to(dev)
                for c in ("state", "stamp", "num_objects", "missing",
                          "backfill_remaining", "scrub_errors")]
            hist, sums = summary_fold(cols[0], cols[1], now, *cols[2:],
                                      2 * len(self._state_names))
            objs, miss, back, errs, bad = sums.tolist()
            if bad:
                raise ValueError(f"summary fold: {bad} rows with a state "
                                 f"id outside the state table")
            return {"state_stale_hist": hist.cpu().numpy(),
                    "num_objects": objs, "missing": miss,
                    "backfill_remaining": back, "scrub_errors": errs}
        return {"state_stale_hist": self._state_stale_hist(now),
                "num_objects": self.num_objects(),
                "missing": int(self._cols["missing"][:n].sum()),
                "backfill_remaining":
                    int(self._cols["backfill_remaining"][:n].sum()),
                "scrub_errors":
                    int(self._cols["scrub_errors"][:n].sum())}

    def summary(self, live_pools: set[int] | None = None,
                now: float | None = None,
                total_expected: int | None = None) -> dict:
        """The ``pg summary`` payload: everything the mgr-side
        consumers (exporter, progress, telemetry) used to re-derive
        from a full ``pg dump`` — per-pool/per-state gauges, scrub
        and recovery totals — computed as masked reductions, so the
        reply is O(pools + offenders), never O(PGs)."""
        now = time.time() if now is None else now
        if live_pools is not None:
            self.prune(live_pools)
        n = self._n
        fold = self.summary_arrays(now)
        out = {
            "reported_pgs": n,
            "states": self.states(total_expected=total_expected,
                                  now=now),
            "num_objects": fold["num_objects"],
            "missing": fold["missing"],
            "backfill_remaining": fold["backfill_remaining"],
            "scrub_errors": fold["scrub_errors"],
            "pools": {},
            "scrubbing": {},
            "osd_stats": {str(o): s
                          for o, s in self.osd_stats.items()},
        }
        if total_expected is not None:
            out["num_pgs"] = total_expected
        if n == 0:
            out["inconsistent_objects"] = 0
            out["scrubbing_pgs"] = 0
            return out
        out["inconsistent_objects"] = sum(
            len(ex.get("inconsistent_objects") or ())
            for ex in self._extra.values())
        pid = self._pool[:n]
        valid = pid >= 0
        ids = pid[valid].astype(np.int64)
        sid = self._cols["state"][:n]
        n_states = len(self._state_names)
        if ids.size:
            length = int(ids.max()) + 1
            pgs = np.bincount(ids, minlength=length)
            objs = np.bincount(
                ids, weights=self._cols["num_objects"][:n][valid],
                minlength=length)
            nb = self._cols["num_bytes"][:n][valid]
            nbl = np.where((self._present[:n][valid] & _F_NBL) != 0,
                           self._cols["num_bytes_logical"][:n][valid],
                           nb)
            stored = np.bincount(ids, weights=nb, minlength=length)
            logical = np.bincount(ids, weights=nbl, minlength=length)
            perr = np.bincount(
                ids, weights=self._cols["scrub_errors"][:n][valid],
                minlength=length)
            key = ids * n_states + sid[valid]
            by_state = np.bincount(key, minlength=length * n_states)
            for p in np.nonzero(pgs)[0]:
                sl = by_state[p * n_states:(p + 1) * n_states]
                out["pools"][str(int(p))] = {
                    "pgs": int(pgs[p]), "objects": int(objs[p]),
                    "bytes_used": int(stored[p]),
                    "bytes_logical": int(logical[p]),
                    "scrub_errors": int(perr[p]),
                    "by_state": {self._state_names[s]: int(sl[s])
                                 for s in np.nonzero(sl)[0]},
                }
        # mid-flight scrub sweeps: state says scrubbing AND the
        # primary reported a chunk position — sparse by construction
        total = self._cols["scrub_chunks_total"][:n]
        scrubbing = self._scrubbing_lut[sid] & (total > 0) & \
            ((self._present[:n] & _F_SCT) != 0)
        out["scrubbing_pgs"] = int(self._scrubbing_lut[sid].sum())
        done = self._cols["scrub_chunks_done"][:n]
        for r in np.nonzero(scrubbing)[0]:
            out["scrubbing"][self._pgid_str(int(r))] = \
                [int(done[r]), int(total[r])]
        return out

    def dump(self) -> dict[str, dict]:
        """Materialize plain dict-of-dicts (``pg dump`` replies are
        JSON-encoded; views don't serialize)."""
        return {self._pgid_str(r): self._row_dict(r)
                for r in range(self._n)}

    def _row_dict(self, row: int) -> dict:
        out = {}
        present = int(self._present[row])
        for k, (_c, kind, bit) in _FIELDS.items():
            if not present & bit:
                continue
            if kind == "x":
                out[k] = self._extra.get(row, {}).get(k, [])
            else:
                out[k] = self._get_field(row, k)
        for k, v in self._extra.get(row, {}).items():
            if k not in _FIELDS:
                out[k] = v
        return out


# -- K11: the summary fold on the card ----------------------------------------

PGMAP_FOLD = build.register(
    "pgmap_fold", "ceph_tpu_torch/csrc/pgmap_fold.cu",
    "ceph_tpu/mon/pgmap.py:727")
FOLD_SHARED_CAP = 8192      # csrc/pgmap_fold.cu kSharedCap: int32 bins
_FOLD_THREADS = 256         # the kernel's block
_FOLD_BLOCKS_PER_SM = 8


def _fold_inputs(sid, stamp, cols, hist_len: int):
    n = sid.shape[0]
    for name, t, dtype in (("sid", sid, torch.int64),
                           ("stamp", stamp, torch.float64),
                           *((f"column {i}", c, torch.int64)
                             for i, c in enumerate(cols))):
        if t.dim() != 1 or t.shape[0] != n or t.dtype != dtype \
                or t.device != sid.device:
            raise ValueError(f"summary_fold: {name} must be [{n}] {dtype} "
                             f"on {sid.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if hist_len <= 0:
        raise ValueError(f"summary_fold: hist_len {hist_len}")


def summary_fold(sid: torch.Tensor, stamp: torch.Tensor, now: float,
                 objs: torch.Tensor, miss: torch.Tensor,
                 back: torch.Tensor, errs: torch.Tensor,
                 hist_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K11: the summary fold of ``n`` PGs on the tensors' device.
    ``sid`` int64 state ids, ``stamp`` float64 report stamps (NaN: no
    report), four int64 counter columns, all ``[n]``.  Returns the
    int64 histogram ``[hist_len]`` of ``sid * 2 + stale`` (stale: ``now
    - stamp > PG_STALE_GRACE``, a NaN age never) and int64 ``[5]``:
    the four column sums and the rows whose key falls outside the
    histogram (not counted in it).  Un-fenced."""
    cols = (objs, miss, back, errs)
    _fold_inputs(sid, stamp, cols, hist_len)
    if sid.device.type == "cpu":
        return _summary_fold_plain(sid, stamp, now, *cols, hist_len)
    if not sid.is_cuda:
        raise ValueError(f"summary_fold: unsupported device {sid.device}")
    n = sid.shape[0]
    out = torch.zeros(hist_len + 5, dtype=torch.int64, device=sid.device)
    if n:
        ins = [t.contiguous() for t in (sid, stamp, *cols)]
        sms = torch.cuda.get_device_properties(
            sid.device).multi_processor_count
        blocks = min(-(-n // _FOLD_THREADS), _FOLD_BLOCKS_PER_SM * sms)
        rc = build.library().ctt_pgmap_fold(
            ins[0].data_ptr(), ins[1].data_ptr(), float(now),
            *(t.data_ptr() for t in ins[2:]), n, hist_len,
            out.data_ptr(), blocks, build.stream_ptr(sid.device))
        build.check(rc, "pgmap_fold")
        PGMAP_FOLD.count()
    return out[:hist_len], out[hist_len:]


def _summary_fold_plain(sid, stamp, now, objs, miss, back, errs,
                        hist_len: int):
    """K11's plain version: a ``bincount`` and four sums."""
    age = now - stamp
    stale = (age == age) & (age > PG_STALE_GRACE)
    key = sid * 2 + stale.to(torch.int64)
    ok = (key >= 0) & (key < hist_len)
    hist = torch.bincount(key[ok], minlength=hist_len)
    sums = torch.stack([objs.sum(), miss.sum(), back.sum(), errs.sum(),
                        (~ok).sum()]).to(torch.int64)
    return hist, sums


# -- the legacy oracle -------------------------------------------------------

class LegacyPGMap:
    """The original dict-of-dicts PGMap, kept verbatim as the
    equality oracle: tier-1 tests diff every array-path output
    against this on identical injected stats."""

    def __init__(self):
        self.pg_stats: dict[str, dict] = {}
        self.osd_stats: dict[int, dict] = {}

    def apply_report(self, osd: int, pg_stats: dict, osd_stats: dict):
        now = time.time()
        for pgid, st in (pg_stats or {}).items():
            st = dict(st)
            st["osd"] = osd
            st["stamp"] = now
            self.pg_stats[pgid] = st
        if osd_stats:
            self.osd_stats[osd] = dict(osd_stats, stamp=now)

    def prune(self, live_pools: set[int]):
        for pgid in list(self.pg_stats):
            try:
                pool = int(pgid.split(".", 1)[0])
            except ValueError:
                pool = -1
            if pool not in live_pools:
                del self.pg_stats[pgid]

    def states(self, total_expected: int | None = None,
               now: float | None = None) -> dict:
        now = time.time() if now is None else now
        out: dict[str, int] = {}
        for st in self.pg_stats.values():
            s = st.get("state", "unknown")
            if now - st["stamp"] > PG_STALE_GRACE:
                s = f"stale+{s}"
            out[s] = out.get(s, 0) + 1
        if total_expected is not None:
            known = len(self.pg_stats)
            if total_expected > known:
                out["unknown"] = out.get("unknown", 0) + \
                    (total_expected - known)
        return out

    def num_objects(self) -> int:
        return sum(int(st.get("num_objects", 0))
                   for st in self.pg_stats.values())

    def pool_usage(self, live_pools: set[int]) -> dict[int, list]:
        self.prune(live_pools)
        usage: dict[int, list] = {}
        for pgid_s, st in self.pg_stats.items():
            try:
                pid = int(pgid_s.split(".", 1)[0])
            except ValueError:
                continue
            row = usage.setdefault(pid, [0, 0, 0])
            row[0] += int(st.get("num_objects", 0))
            row[1] += int(st.get("num_bytes", 0))
            row[2] += int(st.get("num_bytes_logical",
                                 st.get("num_bytes", 0)))
        return usage

    def dedup_totals(self) -> dict:
        out = {"chunks": 0, "refs": 0, "stored_bytes": 0,
               "referenced_bytes": 0}
        for st in self.osd_stats.values():
            d = st.get("dedup") or {}
            for k in out:
                out[k] += int(d.get(k, 0))
        return out

    def damaged(self) -> list[tuple[str, int]]:
        bad = {pgid: int(st.get("scrub_errors", 0))
               for pgid, st in self.pg_stats.items()
               if int(st.get("scrub_errors", 0)) > 0}
        return sorted(bad.items())

    def scrub_late(self, now: float,
                   interval: float) -> list[tuple[str, float]]:
        late = {}
        for pgid, st in self.pg_stats.items():
            stamp = st.get("last_scrub_stamp")
            if stamp is None:
                continue
            age = now - float(stamp)
            if age > interval:
                late[pgid] = age
        return sorted(late.items())

    def pool_clean_count(self, pool_id: int, pg_num: int,
                         state: str = "active+clean") -> int:
        count = 0
        for seed in range(pg_num):
            st = self.pg_stats.get(f"{pool_id}.{seed:x}")
            if st is not None and st.get("state") == state:
                count += 1
        return count

    def dump(self) -> dict[str, dict]:
        return {pgid: dict(st) for pgid, st in self.pg_stats.items()}
