"""Batched deep-scrub planner: device digests + EC parity recheck — port
of ``ceph_tpu.scrub.engine``.

The scrub data path (reference ``src/osd/scrubber/ScrubStore`` +
``be_compare_scrubmaps``) has two integrity layers:

1. **Digests** — every shard payload is CRC-32C'd.  Payloads are
   bucketed by exact length and digested as ``[n, L]`` batches through
   :func:`..scrub.crc32c.crc32c_batch` (the ``crc32c_batch`` kernel on
   the card); a bucket below the size policy (``device_min_rows`` /
   ``device_min_bytes``, or ``mode``) runs the host scalar.  Payloads
   larger than ``segment_bytes`` are digested as equal segments, which
   batch with each other across objects, and folded back with
   ``crc32c_combine``.  The digests are identical either way.
2. **Parity recheck** (EC pools only) — stripes are stacked
   ``[B, k, chunk]`` and re-encoded through the plugin's engine, or
   through a ``BatchEngine``'s reconstruct lane completed inline with
   ``flush_sync``; recomputed parity is byte-compared with the stored
   parity shards.

For an inconsistent stripe, :func:`isolate_culprit` names the bad shard
by hypothesis testing: decode each candidate from the others and accept
the hypothesis whose repaired stripe is self-consistent.  Reports use
the ``rados list-inconsistent-obj`` shape.

Unlike ceph_tpu's engine, a kernel or lane failure raises: nothing
redoes the work elsewhere.  Not carried over yet: the
``CEPH_TPU_SCRUB_*`` environment reads (``mode`` and ``segment_bytes``
are constructor arguments with the same defaults) and the
multi-device mesh.  The device profiler's spans are ``crc_digest`` (one
digest batch) and ``parity_recheck`` (one standalone re-encode batch),
recorded on the profiler bound to the calling thread.
"""

from __future__ import annotations

import itertools

import numpy as np

from ..core.device_profiler import DeviceProfiler
from ..ec.interface import ECError
from ..utils.device import resolve_device
from .crc32c import crc32c, crc32c_batch, crc32c_combine

MODES = ("auto", "always", "never")


class ScrubEngine:
    """Digest/parity planner for one OSD's scrubs on ``device``
    (``None`` → the card); counters accumulate so callers can report
    scanned bytes."""

    def __init__(self, device_min_rows: int = 4,
                 device_min_bytes: int = 1 << 16,
                 segment_bytes: int = 4 << 20, mode: str = "auto",
                 device=None):
        if mode not in MODES:
            raise ValueError(f"scrub mode {mode!r} not in {MODES}")
        self.mode = mode
        self.device_min_rows = device_min_rows
        self.device_min_bytes = device_min_bytes
        self.segment_bytes = max(1, int(segment_bytes))
        self.device = resolve_device(device)
        self.objects_scanned = 0
        self.segmented_objects = 0
        self.digest_bytes = 0
        self.device_digest_bytes = 0
        self.parity_bytes = 0

    # ------------------------------------------------------- digests

    def _use_device(self, rows: int, length: int) -> bool:
        if self.mode == "always":
            return length > 0
        if self.mode == "never" or length == 0:
            return False
        return (rows >= self.device_min_rows
                or rows * length >= self.device_min_bytes)

    def compute_digests(self, payloads: dict) -> dict:
        """{key: bytes-like} → {key: crc32c int}, batching same-length
        payloads through the device kernel; payloads larger than
        ``segment_bytes`` are digested as segments and folded with
        :func:`crc32c_combine`."""
        seg = self.segment_bytes
        parts: dict = {}        # key -> [(part_key, part_len), ...]
        expanded: dict = {}     # part_key/key -> bytes
        for key, buf in payloads.items():
            b = bytes(buf)
            if len(b) > seg:
                self.segmented_objects += 1
                pieces = parts[key] = []
                for i, off in enumerate(range(0, len(b), seg)):
                    pk = ("_seg", key, i)
                    expanded[pk] = b[off:off + seg]
                    pieces.append((pk, len(expanded[pk])))
            else:
                expanded[key] = b
        digests = self._digest_exact(expanded)
        out: dict = {}
        for key in payloads:
            if key in parts:
                crc = 0
                for pk, plen in parts[key]:
                    crc = crc32c_combine(crc, digests[pk], plen)
                out[key] = crc
            else:
                out[key] = digests[key]
        self.objects_scanned += len(payloads)
        return out

    def _digest_exact(self, payloads: dict) -> dict:
        """Digest materialised byte payloads, bucketed by exact length."""
        by_len: dict[int, list] = {}
        for key, b in payloads.items():
            by_len.setdefault(len(b), []).append((key, b))
        out: dict = {}
        for length, group in by_len.items():
            self.digest_bytes += length * len(group)
            if self._use_device(len(group), length):
                batch = np.empty((len(group), length), dtype=np.uint8)
                for row, (_, b) in zip(batch, group):
                    row[:] = np.frombuffer(b, dtype=np.uint8)
                ln = DeviceProfiler.active().start(
                    "crc_digest", bytes_in=batch.nbytes, rows=len(group))
                try:
                    crcs = crc32c_batch(batch, device=self.device)
                except Exception:
                    if ln is not None:
                        ln.abort()
                    raise
                if ln is not None:
                    ln.finish(bytes_out=crcs.nbytes)
                self.device_digest_bytes += length * len(group)
                for (key, _), c in zip(group, crcs):
                    out[key] = int(c)
            else:
                for key, b in group:
                    out[key] = crc32c(b)
        return out

    # ------------------------------------------------- parity recheck

    def recheck_parity(self, ec, stripes: dict, batch=None) -> dict:
        """{oid: {shard_index: uint8 chunk}} → {oid: inconsistent bool}.

        `ec` is an ``ErasureCodeInterface`` plugin (k data + m parity
        shards, shard i ≥ k is parity row i-k).  Every stripe carries
        all k+m equal-length shards.  ``batch`` (a ``BatchEngine``)
        routes the re-encodes through its reconstruct lane, completed
        on this thread by ``flush_sync``; otherwise each chunk size is
        re-encoded as one ``[B, k, chunk]`` batch by a plugin with an
        engine, or stripe by stripe by one without (lrc, clay)."""
        if (batch is not None and batch.enabled and batch.recon_enabled):
            return self._recheck_batched(ec, stripes, batch)
        k = ec.k
        by_size: dict[int, list] = {}
        for oid, shards in stripes.items():
            by_size.setdefault(len(shards[0]), []).append((oid, shards))
        out: dict = {}
        for group in by_size.values():
            data = np.stack([_stack(shards, range(k))
                             for _, shards in group])    # [B, k, chunk]
            self.parity_bytes += data.size
            ln = DeviceProfiler.active().start(
                "parity_recheck", bytes_in=data.nbytes, rows=len(group))
            try:
                if getattr(ec, "engine", None) is not None:
                    parity = np.asarray(ec._encode_chunks(data))
                else:
                    parity = np.stack([np.asarray(ec._encode_chunks(d))
                                       for d in data])
            except Exception:
                if ln is not None:
                    ln.abort()
                raise
            if ln is not None:
                ln.finish(bytes_out=parity.nbytes)
            for (oid, shards), par in zip(group, parity):
                out[oid] = not np.array_equal(
                    par, _stack(shards, range(k, k + ec.m)))
        return out

    def _recheck_batched(self, ec, stripes: dict, batch) -> dict:
        """Submit every stripe's re-encode to the reconstruct lane and
        complete it inline (the scrub must not wait behind the engine's
        completion worker)."""
        k, m = ec.k, ec.m
        comps = {}
        for oid, shards in stripes.items():
            data = _stack(shards, range(k))
            self.parity_bytes += data.size
            comps[oid] = batch.submit_recheck(ec, data)
        batch.flush_sync("recon", reason="scrub")
        return {oid: not np.array_equal(
                    np.asarray(comp.result(timeout=60.0)),
                    _stack(stripes[oid], range(k, k + m)))
                for oid, comp in comps.items()}


def _stack(shards: dict, ids) -> np.ndarray:
    return np.stack([np.frombuffer(memoryview(shards[i]), np.uint8)
                     for i in ids])


def _consistent(ec, fixed: dict) -> bool:
    k, m = ec.k, ec.m
    parity = np.asarray(ec._encode_chunks(
        np.stack([fixed[i] for i in range(k)])))
    return all(np.array_equal(parity[j], fixed[k + j]) for j in range(m))


def isolate_culprit(ec, shards: dict) -> int | None:
    """Given one inconsistent stripe {shard_index: uint8 chunk} with
    all k+m shards present, return the single shard index whose
    reconstruction-from-the-others restores stripe consistency, or
    None when no single-shard hypothesis explains the mismatch.

    Needs m >= 2 to attribute: with a single parity row every
    one-erasure decode re-satisfies that row, so each hypothesis looks
    consistent and None is returned.  A hypothesis the code cannot
    decode (``ECError``) is skipped; any other failure raises."""
    n = ec.k + ec.m
    arrs = {i: np.frombuffer(memoryview(shards[i]), np.uint8)
            for i in range(n)}
    candidates = []
    for c in range(n):
        survivors = {i: arrs[i] for i in range(n) if i != c}
        try:
            rebuilt = ec.decode({c}, survivors)[c]
        except ECError:
            continue
        if np.array_equal(rebuilt, arrs[c]):
            continue            # hypothesis changes nothing — not it
        fixed = dict(arrs)
        fixed[c] = rebuilt
        if _consistent(ec, fixed):
            candidates.append(c)
    # only a UNIQUE consistent hypothesis is an attribution
    return candidates[0] if len(candidates) == 1 else None


def isolate_culprits(ec, shards: dict,
                     max_erasures: int = 2) -> tuple[int, ...]:
    """Multi-shard culprit attribution for one inconsistent stripe
    with all k+m shards present: single-erasure hypotheses first
    (:func:`isolate_culprit`), then erasure PAIRS.  Returns the
    attributed shard indices, or ``()`` when the stripe is
    unattributable or the evidence is ambiguous.

    Pair attribution needs m >= 3 in general: with m=2 every pair
    hypothesis re-satisfies the code, all pairs tie and () is
    returned."""
    n = ec.k + ec.m
    single = isolate_culprit(ec, shards)
    if single is not None:
        return (single,)
    if ec.m < 2 or max_erasures < 2:
        return ()
    arrs = {i: np.frombuffer(memoryview(shards[i]), np.uint8)
            for i in range(n)}
    candidates = []
    for pair in itertools.combinations(range(n), 2):
        survivors = {i: arrs[i] for i in range(n) if i not in pair}
        try:
            rebuilt = ec.decode(set(pair), survivors)
        except ECError:         # undecodable pattern
            continue
        if all(np.array_equal(np.asarray(rebuilt[c]), arrs[c])
               for c in pair):
            continue            # hypothesis changes nothing — not it
        fixed = dict(arrs)
        for c in pair:
            fixed[c] = np.asarray(rebuilt[c], dtype=np.uint8)
        if _consistent(ec, fixed):
            candidates.append(pair)
    return tuple(candidates[0]) if len(candidates) == 1 else ()


def inconsistent_entry(oid: str, errors: list[str],
                       shards: dict) -> dict:
    """One ``rados list-inconsistent-obj``-shaped report entry.

    `shards`: {(osd, shard_index): {size, digest?, errors: [...]}}."""
    union: set[str] = set()
    shard_list = []
    for (osd, shard), info in sorted(shards.items()):
        union |= set(info.get("errors", ()))
        shard_list.append({"osd": osd, "shard": shard, **info})
    return {"object": {"name": oid},
            "errors": sorted(errors),
            "union_shard_errors": sorted(union),
            "shards": shard_list}


_DEFAULT: ScrubEngine | None = None


def default_engine() -> ScrubEngine:
    """Process-wide engine on the card (shared digest counters across
    PGs)."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = ScrubEngine()
    return _DEFAULT
