"""Per-OSD coalescing device data plane — port of
``ceph_tpu.osd.batch_engine`` onto the CUDA kernels.

The write stream for a tick accumulates into one **megabatch** per EC
code and size bucket, and one :class:`ops.gf_torch.GFEncodeDigest`
launch group encodes it *and* CRC-32Cs every data and parity shard, so
per-shard hinfo digests ride the same flush.  Rows and lengths pad to
powers of two; zero padding is free for the GF encode (zero columns
encode to zero parity) and reversible for the digest
(``scrub.crc32c.crc32c_zero_unpad``), so batched results are
**bit-identical** to the unbatched path (``ec.encode`` + host
``crc32c``).

Six kinds of op share the machinery in three lanes:

- the **write lane** — ``submit_encode`` (encode + digest) and
  ``submit_digest`` (a CRC-32C of a payload);
- the **reconstruct lane** — ``submit_reconstruct`` (degraded reads,
  recovery) grouped per (code, erasure pattern, size bucket), one
  launch per group over the plan's stacked ``[k + p, k]`` matrix:
  through ``ResidentPlanes`` (``gf_expand`` + ``gf_planes``); and
  ``submit_recheck`` (scrub parity re-encode) through ``GFLinear``;
- the **compression lane** (``comp``) — ``submit_compress`` (inline
  compression: the codec's device scan, K9 for ``rle``, over the whole
  size-bucketed megabatch, then the host finalize of each member) and
  ``submit_fingerprint`` (dedup: one K8 gear-hash launch over the
  megabatch, the host cut walk on the hash-mask hits, then one K6
  launch digesting every chunk of the flush).  Payloads above
  ``comp_segment_bytes`` split into fixed segments that batch across
  objects.  Its knobs (``comp_*``) default to the write lane's, its
  stats carry the ``comp_`` prefix.

Flush policy (as ceph_tpu's): ``max_bytes`` / ``max_ops`` trigger at
submit; ``flush_ms == 0`` flushes every submit synchronously;
``flush_ms > 0`` arms ``schedule`` and enables the flight pipeline: a
flush launches its groups, queues each result's device→host copy into
pinned memory behind a CUDA event, and hands the flights to a FIFO
completion worker that waits on each event before reading — the next
tick stages while earlier flights drain, and FIFO completion keeps
per-PG ordering.

``profiler`` (a ``core.device_profiler.DeviceProfiler``) gets one
``"megabatch"`` sample per launch group, tagged with its lane and op:
dispatch ends after ``_stage_out`` queues the result copies, compute is
the completion's wait at the flight's CUDA event.

The OSD daemon's hooks, as ceph_tpu's: ``tracer`` (a
``core.tracer.Tracer``) opens one ``megabatch_flush`` span a launch
group, linked to the span each member was submitted with (``span=`` on
every ``submit_*``); ``on_lane_flush(lane, ops, bytes)`` is told of
every lane flush; ``store_kick`` (``WALStore.kick``) is called once a
flush, after its launches, so one group-commit fsync covers the
flush's transactions (counted in the ``store_kicks`` stats).

Not carried over: the mesh (one card; ROADMAP item 7).
"""

from __future__ import annotations

import collections
import queue
import threading

import numpy as np
import torch

from ..utils.device import resolve_device


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


class Completion:
    """One submitted op's pending result.

    ``value`` for an encode op is ``(shard_chunks, hinfos)`` —
    ``{shard: bytes}`` for all k+m shards and ``{shard: crc32c}`` to
    match; for a digest op it is the ``int`` crc.  ``info`` carries
    flush attribution (rows, members, reason).
    """

    __slots__ = ("_ev", "value", "error", "info", "_cb")

    def __init__(self, callback=None):
        self._ev = threading.Event()
        self.value = None
        self.error: BaseException | None = None
        self.info: dict = {}
        self._cb = callback

    def done(self) -> bool:
        return self._ev.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._ev.wait(timeout)

    def result(self, timeout: float | None = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("batch op still pending")
        if self.error is not None:
            raise self.error
        return self.value

    def _fire(self, value=None, error: BaseException | None = None):
        if self._ev.is_set():
            return              # first outcome wins
        self.value = value
        self.error = error
        self._ev.set()
        if self._cb is not None:
            self._cb(self)


class _Op:
    __slots__ = ("kind", "key", "chunks", "payload", "length",
                 "nbytes", "comp", "want", "passthrough", "codec", "mode",
                 "chunker", "span")

    def __init__(self, kind, key, comp, length, nbytes, chunks=None,
                 payload=None, want=None, passthrough=None, codec=None,
                 mode=None, chunker=None, span=None):
        self.kind = kind            # "encode"|"digest"|"recon"|"recheck"|
        #                             "compress"|"fingerprint"
        self.key = key              # executable-identity group key
        self.comp = comp
        self.length = length        # true (unpadded) per-row length
        self.nbytes = nbytes
        self.chunks = chunks        # encode/recheck: [k, length];
        #                             recon: survivor stack [k, length]
        self.payload = payload      # digest/compress/fingerprint: bytes
        self.want = want            # recon: frozenset of wanted ids
        self.passthrough = passthrough  # recon: {id: chunk} present+wanted
        self.codec = codec          # compress: Codec instance
        self.mode = mode            # compress: pool compression_mode
        self.chunker = chunker      # fingerprint: Chunker instance
        self.span = span            # the submitter's span, or None


class _Flight:
    """One launched group awaiting its fence."""

    __slots__ = ("kind", "ops", "out", "event", "length", "bucket",
                 "reason", "ln", "plan", "spans", "chunk_len", "span")

    def __init__(self, kind, ops, out, event, length, bucket, reason, ln,
                 plan=None, spans=None, chunk_len=0):
        self.kind = kind
        self.ops = ops
        self.out = out              # host tensors, valid after event
        self.event = event          # CUDA event or None (CPU)
        self.length = length        # bucket row length
        self.bucket = bucket        # padded row count
        self.reason = reason
        self.ln = ln                # profiler launch (overlap) or None
        self.plan = plan            # recon: DecodePlan (row_of mapping)
        self.spans = spans          # fingerprint: [(off, len), ...] per op
        self.chunk_len = chunk_len  # fingerprint: padded chunk row length
        self.span = None            # the megabatch_flush span, or None


class BatchEngine:
    """Tick-accumulating megabatch launcher for one OSD's device ops."""

    LANES = ("write", "recon", "comp")
    _PREFIX = {"write": "", "recon": "recon_", "comp": "comp_"}

    def __init__(self, name: str = "", *, device=None, enabled: bool = True,
                 max_bytes: int = 8 << 20, max_ops: int = 64,
                 flush_ms: float = 0.0, schedule=None,
                 recon_enabled: bool | None = None,
                 recon_max_bytes: int | None = None,
                 recon_max_ops: int | None = None,
                 recon_flush_ms: float | None = None,
                 comp_enabled: bool | None = None,
                 comp_max_bytes: int | None = None,
                 comp_max_ops: int | None = None,
                 comp_flush_ms: float | None = None,
                 comp_segment_bytes: int = 1 << 20,
                 bucket_floor: int = 32, profiler=None, tracer=None,
                 on_lane_flush=None, store_kick=None):
        self.name = name
        self.device = resolve_device(device)
        self.enabled = bool(enabled)
        self.max_bytes = int(max_bytes)
        self.max_ops = int(max_ops)
        self.flush_ms = float(flush_ms)
        # reconstruct-lane knobs default to the write lane's values
        self.recon_enabled = (self.enabled if recon_enabled is None
                              else bool(recon_enabled))
        self.recon_max_bytes = (self.max_bytes if recon_max_bytes
                                is None else int(recon_max_bytes))
        self.recon_max_ops = (self.max_ops if recon_max_ops is None
                              else int(recon_max_ops))
        self.recon_flush_ms = (self.flush_ms if recon_flush_ms is None
                               else float(recon_flush_ms))
        # compression-lane knobs default to the write lane's values
        self.comp_enabled = (self.enabled if comp_enabled is None
                             else bool(comp_enabled))
        self.comp_max_bytes = (self.max_bytes if comp_max_bytes
                               is None else int(comp_max_bytes))
        self.comp_max_ops = (self.max_ops if comp_max_ops is None
                             else int(comp_max_ops))
        self.comp_flush_ms = (self.flush_ms if comp_flush_ms is None
                              else float(comp_flush_ms))
        self.comp_segment_bytes = int(comp_segment_bytes)
        self.bucket_floor = int(bucket_floor)
        self.profiler = profiler
        self.tracer = tracer
        self.on_lane_flush = on_lane_flush   # (lane, ops, bytes) hook
        # zero-arg durability nudge (WALStore.kick): one group-commit
        # fsync per megabatch flush instead of one per op
        self.store_kick = store_kick
        self._schedule = schedule   # schedule(delay_s, fn) -> token
        self._lock = threading.Lock()        # pending accumulators
        self._flush_lock = threading.Lock()  # serializes dispatch
        self._pending: dict[str, list[_Op]] = {
            lane: [] for lane in self.LANES}
        self._pending_bytes = {lane: 0 for lane in self.LANES}
        self._armed = {lane: False for lane in self.LANES}
        self._fused: dict = {}               # code key → GFEncodeDigest
        self._rexec: dict = {}               # recheck key → GFLinear
        self._plan_cache: dict = {}          # DecodePlan per erasure set
        self._plane_mats: dict = {}          # plane-matrix device tables
        self._flights: queue.Queue = queue.Queue()
        self._worker: threading.Thread | None = None
        self._stopped = False
        self.stats = collections.Counter()

    # -- submission --------------------------------------------------------

    @staticmethod
    def _matrix_engine(ec):
        """The batchable core of an EC plugin — the port's
        MatrixECEngine — or None (unbatched path)."""
        from ..ec.torch_backend import MatrixECEngine
        eng = getattr(ec, "engine", None)
        return eng if isinstance(eng, MatrixECEngine) else None

    def submit_encode(self, ec, data, *, span=None,
                      callback=None) -> Completion:
        """Queue a full-stripe encode+digest; the completion's value is
        ``({shard: bytes}, {shard: crc32c})`` over all k+m shards —
        byte- and digest-identical to ``ec.encode`` + host ``crc32c``
        per shard."""
        comp = Completion(callback)
        self.stats["ops_submitted"] += 1
        value = None
        try:
            eng = self._matrix_engine(ec)
            if eng is None or not self.enabled or self._stopped:
                value = self._encode_unbatched(ec, data)
            else:
                chunks = np.ascontiguousarray(
                    ec.encode_prepare(data), dtype=np.uint8)
                key = ("encode", eng.k, eng.m, eng.coding.tobytes())
                self._enqueue(_Op("encode", key, comp,
                                  length=int(chunks.shape[1]),
                                  nbytes=int(chunks.nbytes),
                                  chunks=chunks, span=span))
                return comp
        except Exception as e:      # noqa: BLE001 — poisoned payloads
            self.stats["ops_failed"] += 1   # fail their own op only
            comp._fire(error=e)
            return comp
        # fire outside the try: a callback raising must surface to the
        # submitter, not masquerade as an encode failure
        comp._fire(value=value)
        return comp

    def submit_digest(self, payload, *, span=None,
                      callback=None) -> Completion:
        """Queue a CRC-32C digest; completion value is the int crc."""
        comp = Completion(callback)
        self.stats["ops_submitted"] += 1
        try:
            buf = bytes(payload)
            if self.enabled and not self._stopped and buf:
                self._enqueue(_Op("digest", ("digest",), comp,
                                  length=len(buf), nbytes=len(buf),
                                  payload=buf, span=span))
                return comp
            from ..scrub.crc32c import crc32c
            value = crc32c(buf)
        except Exception as e:      # noqa: BLE001
            self.stats["ops_failed"] += 1
            comp._fire(error=e)
            return comp
        comp._fire(value=value)
        return comp

    @staticmethod
    def _encode_unbatched(ec, data):
        """Whole-stripe encode, then host CRC per shard — the
        bit-identity reference."""
        from ..scrub.crc32c import crc32c
        n = ec.k + ec.m
        out = ec.encode(set(range(n)), data)
        shard_chunks = {i: bytes(np.asarray(out[i]).tobytes())
                        for i in range(n)}
        hinfos = {i: crc32c(shard_chunks[i]) for i in range(n)}
        return shard_chunks, hinfos

    # -- reconstruct lane --------------------------------------------------

    def submit_reconstruct(self, ec, chunks, *, want=None, span=None,
                           callback=None) -> Completion:
        """Queue a degraded decode; the completion's value is
        ``{chunk_id: uint8 array}`` for every wanted id — byte-identical
        to ``ec.decode(want, chunks)``.  ``want`` defaults to the k data
        ids; when every wanted id is present the op completes at once
        with no device work."""
        comp = Completion(callback)
        self.stats["recon_ops_submitted"] += 1
        value = None
        try:
            from ..ec.interface import ECError
            present = {int(i): np.asarray(c, dtype=np.uint8)
                       for i, c in chunks.items()}
            if not present:
                raise ECError("no chunks to decode from")
            want_ids = frozenset(
                int(i) for i in (want if want is not None
                                 else range(ec.k)))
            if want_ids <= present.keys():
                self.stats["recon_fast_path"] += 1
                value = {i: present[i] for i in want_ids}
            else:
                eng = self._matrix_engine(ec)
                if (eng is None or not self.enabled
                        or not self.recon_enabled or self._stopped):
                    value = self._reconstruct_unbatched(
                        ec, want_ids, chunks)
                else:
                    sizes = {c.size for c in present.values()}
                    if len(sizes) != 1:
                        raise ECError("chunk sizes differ")
                    if len(present) < eng.k:
                        raise ECError(
                            f"{len(present)} chunks < k={eng.k}")
                    erasures = tuple(i for i in range(eng.k + eng.m)
                                     if i not in present)
                    avail = sorted(present)
                    surv = np.ascontiguousarray(np.stack(
                        [present[i] for i in avail[:eng.k]]))
                    self._enqueue(_Op(
                        "recon", ("recon", eng.k, eng.m,
                                  eng.coding.tobytes(), erasures),
                        comp, length=int(surv.shape[1]),
                        nbytes=int(surv.nbytes), chunks=surv,
                        want=want_ids,
                        passthrough={i: present[i] for i in want_ids
                                     if i in present}, span=span),
                        lane="recon")
                    return comp
        except Exception as e:      # noqa: BLE001 — poisoned payloads
            self.stats["recon_ops_failed"] += 1
            comp._fire(error=e)
            return comp
        comp._fire(value=value)
        return comp

    def submit_recheck(self, ec, data, *, span=None,
                       callback=None) -> Completion:
        """Queue a scrub parity re-encode; completion value is the
        ``[m, length]`` parity array, byte-identical to
        ``np.asarray(ec._encode_chunks(data))``."""
        comp = Completion(callback)
        self.stats["recon_ops_submitted"] += 1
        try:
            eng = self._matrix_engine(ec)
            arr = np.ascontiguousarray(data, dtype=np.uint8)
            if (eng is None or not self.enabled
                    or not self.recon_enabled or self._stopped):
                value = np.asarray(ec._encode_chunks(arr))
            else:
                self._enqueue(_Op(
                    "recheck", ("recheck", eng.k, eng.m,
                                eng.coding.tobytes()),
                    comp, length=int(arr.shape[1]),
                    nbytes=int(arr.nbytes), chunks=arr, span=span),
                    lane="recon")
                return comp
        except Exception as e:      # noqa: BLE001
            self.stats["recon_ops_failed"] += 1
            comp._fire(error=e)
            return comp
        comp._fire(value=value)
        return comp

    @staticmethod
    def _reconstruct_unbatched(ec, want, chunks):
        """The exact pre-lane semantics — the bit-identity reference."""
        return ec.decode(set(want), chunks)

    # -- compression lane --------------------------------------------------

    def submit_compress(self, codec, payload, *, mode: str = "aggressive",
                        span=None, callback=None) -> Completion:
        """Queue an inline-compression pass; the completion's value is
        ``(stored_bytes, header | None)``.  ``header is None`` means
        pass-through: the payload did not shrink under an
        ``aggressive`` mode and is stored verbatim (``force`` always
        stores compressed).  The header (``{"algo", "len"}``, plus
        ``{"seg", "segs"}`` on the segment path) is what the caller
        persists so that reads can expand.

        Payloads above ``comp_segment_bytes`` split into fixed segments
        that batch across objects.  Batched and unbatched paths are
        bit-identical: the device scan feeds the same host finalize the
        single-op path uses."""
        comp = Completion(callback)
        self.stats["comp_ops_submitted"] += 1
        try:
            buf = bytes(payload)
            if len(buf) > self.comp_segment_bytes > 0:
                return self._submit_compress_segmented(codec, buf, mode,
                                                       span, comp)
            if (not self.enabled or not self.comp_enabled
                    or self._stopped or not buf):
                value = self._compress_unbatched(codec, buf, mode)
            else:
                self._enqueue(_Op("compress", ("compress", codec.name),
                                  comp, length=len(buf), nbytes=len(buf),
                                  payload=buf, codec=codec, mode=mode,
                                  span=span), lane="comp")
                return comp
        except Exception as e:      # noqa: BLE001 — poisoned payloads
            self.stats["comp_ops_failed"] += 1
            comp._fire(error=e)
            return comp
        comp._fire(value=value)
        return comp

    def _compress_unbatched(self, codec, buf: bytes, mode: str):
        """Single-op host semantics — the bit-identity reference for the
        lane (same codec, same pass-through rule)."""
        return self._seal(codec, buf, mode, codec.compress(buf))

    def _seal(self, codec, buf: bytes, mode: str, blob: bytes):
        """``(stored bytes, header)`` of one payload from its compressed
        ``blob``: the payload itself, header ``None``, when the blob did
        not shrink under a mode other than ``force``."""
        self.stats["comp_bytes_in"] += len(buf)
        if mode != "force" and len(blob) >= len(buf):
            self.stats["comp_passthrough"] += 1
            self.stats["comp_bytes_out"] += len(buf)
            return buf, None
        self.stats["comp_bytes_out"] += len(blob)
        return blob, {"algo": codec.name, "len": len(buf)}

    def _submit_compress_segmented(self, codec, buf: bytes, mode: str,
                                   span, comp: Completion) -> Completion:
        """Segment path: fixed-size segments submitted as ordinary lane
        members (they coalesce with other objects' segments), joined
        back into one blob whose header carries each segment's stored
        length and whether it passed through raw."""
        seg = self.comp_segment_bytes
        segs = [buf[i:i + seg] for i in range(0, len(buf), seg)]
        results: list = [None] * len(segs)
        state = {"left": len(segs), "err": None}
        lock = threading.Lock()

        def _child(i):
            def cb(child):
                with lock:
                    if child.error is not None:
                        state["err"] = state["err"] or child.error
                    else:
                        results[i] = child.value
                    state["left"] -= 1
                    if state["left"]:
                        return
                if state["err"] is not None:
                    comp._fire(error=state["err"])
                    return
                clens = [[len(b), 1 if h is None else 0]
                         for b, h in results]
                total = sum(c for c, _raw in clens)
                if mode != "force" and total >= len(buf):
                    self.stats["comp_passthrough"] += 1
                    comp._fire(value=(buf, None))
                    return
                blob = b"".join(b for b, _h in results)
                comp._fire(value=(blob, {
                    "algo": codec.name, "len": len(buf),
                    "seg": seg, "segs": clens}))
            return cb

        for i, s in enumerate(segs):
            self.submit_compress(codec, s, mode=mode, span=span,
                                 callback=_child(i))
        return comp

    def decompress(self, blob, header: dict) -> bytes:
        """Expand a sealed blob back to its logical bytes (the read
        half).  Host work, as in ``ceph_tpu``: RLE expansion is one
        ``np.repeat``.  Counted under ``comp_decompress_bytes``."""
        from ..compress.codec import CodecError
        from ..compress.registry import create_codec
        blob = bytes(blob)
        codec = create_codec(header["algo"])
        total = int(header["len"])
        segs = header.get("segs")
        if segs is None:
            out = codec.decompress(blob, total)
        else:
            seg = int(header["seg"])
            parts = []
            off = 0
            for i, (clen, raw) in enumerate(segs):
                llen = min(seg, total - i * seg)
                piece = blob[off:off + clen]
                off += clen
                parts.append(bytes(piece) if raw
                             else codec.decompress(piece, llen))
            out = b"".join(parts)
        if len(out) != total:
            raise CodecError(
                f"decompress produced {len(out)} of {total} bytes")
        self.stats["comp_decompress_bytes"] += len(out)
        return out

    def submit_fingerprint(self, chunker, payload, *, span=None,
                           callback=None) -> Completion:
        """Queue a dedup fingerprint pass; the completion's value is
        ``[(off, length, fp), ...]``: content-defined chunk spans with
        their fingerprints.  A flush makes one K8 gear-hash launch over
        the size-bucketed megabatch and one K6 launch over every chunk
        of the flush; the host path (lane off, empty payload) computes
        the identical spans and fingerprints."""
        comp = Completion(callback)
        self.stats["comp_ops_submitted"] += 1
        try:
            buf = bytes(payload)
            if (not self.enabled or not self.comp_enabled
                    or self._stopped or not buf):
                value = self._fingerprint_unbatched(chunker, buf)
            else:
                self._enqueue(_Op("fingerprint",
                                  ("fingerprint",) + chunker.key(), comp,
                                  length=len(buf), nbytes=len(buf),
                                  payload=buf, chunker=chunker,
                                  span=span), lane="comp")
                return comp
        except Exception as e:      # noqa: BLE001
            self.stats["comp_ops_failed"] += 1
            comp._fire(error=e)
            return comp
        comp._fire(value=value)
        return comp

    def _fingerprint_unbatched(self, chunker, buf: bytes):
        from ..compress.chunker import fingerprint
        self.stats["comp_fingerprint_bytes"] += len(buf)
        return [(off, ln, fingerprint(buf[off:off + ln]))
                for off, ln in chunker.chunks(buf)]

    # -- accumulation ------------------------------------------------------

    def _lane_knobs(self, lane: str) -> tuple[int, int, float]:
        """(max_ops, max_bytes, flush_ms) for one lane."""
        if lane == "recon":
            return (self.recon_max_ops, self.recon_max_bytes,
                    self.recon_flush_ms)
        if lane == "comp":
            return (self.comp_max_ops, self.comp_max_bytes,
                    self.comp_flush_ms)
        return self.max_ops, self.max_bytes, self.flush_ms

    def _enqueue(self, op: _Op, lane: str = "write"):
        arm = False
        fire = None
        max_ops, max_bytes, flush_ms = self._lane_knobs(lane)
        with self._lock:
            self._pending[lane].append(op)
            self._pending_bytes[lane] += op.nbytes
            n, nbytes = len(self._pending[lane]), self._pending_bytes[lane]
            if n >= max_ops:
                fire = "max_ops"
            elif nbytes >= max_bytes:
                fire = "max_bytes"
            elif flush_ms <= 0:
                fire = "immediate"
            elif not self._armed[lane] and self._schedule is not None:
                self._armed[lane] = True
                arm = True
        if fire is not None:
            self.flush(reason=fire, lane=lane)
        elif arm:
            self._schedule(
                flush_ms / 1000.0,
                lambda: self.flush(reason="deadline", lane=lane))

    # -- flush / dispatch --------------------------------------------------

    def flush(self, reason: str = "manual", lane: str | None = None
              ) -> int:
        """Launch everything pending.  In immediate mode the flights
        complete inline; in batched mode they go to the FIFO
        completion worker.  ``lane`` limits the flush to one lane."""
        lanes = self.LANES if lane is None else (lane,)
        return sum(self._flush_lane(ln, reason) for ln in lanes)

    def flush_sync(self, lane: str, reason: str = "manual") -> int:
        """Dispatch and complete a lane's pending ops inline on the
        calling thread, bypassing the completion worker, for a
        submitter that must read its results synchronously (the deep
        scrub's parity recheck) and must not wait behind flights queued
        for the worker."""
        return self._flush_lane(lane, reason, force_inline=True)

    def _flush_lane(self, lane: str, reason: str,
                    force_inline: bool = False) -> int:
        inline: list[_Flight] = []
        ms = self._lane_knobs(lane)[2]
        with self._flush_lock:
            with self._lock:
                pending, self._pending[lane] = self._pending[lane], []
                staged, self._pending_bytes[lane] = \
                    self._pending_bytes[lane], 0
                self._armed[lane] = False
                use_worker = (ms > 0 and not self._stopped
                              and not force_inline)
            if not pending:
                return 0
            self.stats[f"{self._PREFIX[lane]}flush_{reason}"] += 1
            flights = self._dispatch(pending, reason, lane)
            for fl in flights:
                if use_worker:
                    self._ensure_worker()
                    self._flights.put(fl)
                else:
                    inline.append(fl)
        for fl in inline:
            self._complete(fl)
        if self.on_lane_flush is not None:
            try:
                self.on_lane_flush(lane, len(pending), staged)
            except Exception:       # noqa: BLE001 — accounting hook
                self.stats["callback_errors"] += 1
        if self.store_kick is not None:
            # durability boundary: the completions just dispatched
            # queue their transactions — nudge the WAL group-commit
            # thread so the whole megabatch shares one fsync and its
            # acks (gated on commit) release together
            try:
                self.store_kick()
                self.stats[f"{self._PREFIX[lane]}store_kicks"] += 1
            except Exception:       # noqa: BLE001
                self.stats["callback_errors"] += 1
        return len(flights)

    def drain(self):
        """Flush and wait until every in-flight completion has fired."""
        self.flush(reason="drain")
        self._flights.join()

    def stop(self):
        """Drain, then retire the completion worker.  Later submits
        take the synchronous unbatched path."""
        self._stopped = True
        self.drain()
        w = self._worker
        if w is not None:
            self._flights.put(None)
            w.join(timeout=5.0)
            self._worker = None

    def _ensure_worker(self):
        w = self._worker
        if w is not None and w.is_alive():
            return
        w = threading.Thread(target=self._worker_loop,
                             name=f"batch-{self.name}", daemon=True)
        self._worker = w
        w.start()

    def _worker_loop(self):
        while True:
            fl = self._flights.get()
            try:
                if fl is None:
                    return
                self._complete(fl)
            finally:
                self._flights.task_done()

    def _groups(self, pending):
        groups: dict = {}
        floor = max(1, int(self.bucket_floor))
        for op in pending:
            bucket_len = _next_pow2(max(op.length, floor))
            groups.setdefault((op.key, bucket_len), []).append(op)
        return groups

    def _dispatch(self, pending, reason, lane="write") -> list[_Flight]:
        flights = []
        launches_key = f"{self._PREFIX[lane]}launches"
        launch = {"encode": self._launch_encode,
                  "digest": self._launch_digest,
                  "recon": self._launch_reconstruct,
                  "recheck": self._launch_recheck,
                  "compress": self._launch_compress,
                  "fingerprint": self._launch_fingerprint}
        for (key, bucket_len), ops in self._groups(pending).items():
            rows = _next_pow2(len(ops))
            span = None
            if self.tracer is not None:
                span = self.tracer.start_span(
                    "megabatch_flush", tags={
                        "layer": "device", "kernel": "megabatch",
                        "op": key[0], "lane": lane,
                        "members": len(ops),
                        "rows": rows, "row_len": bucket_len,
                        "reason": reason})
                if span is not None:
                    for op in ops:
                        if op.span is not None:
                            span.add_link(op.span)
            try:
                fl = launch[key[0]](key, ops, rows, bucket_len, reason)
            except Exception as e:  # noqa: BLE001 — one group's
                # launch failure must not kill sibling groups
                self._fail_group(ops, e, span)
                continue
            fl.span = span
            flights.append(fl)
            self.stats[launches_key] += 1
        return flights

    def _prof_start(self, ops, rows, staged_bytes, reason, op_kind,
                    cache_hit, lane="write"):
        if self.profiler is None:
            return None
        return self.profiler.start(
            "megabatch", bytes_in=staged_bytes,
            bytes_used=sum(o.nbytes for o in ops),
            rows=rows, rows_used=len(ops), overlap=True,
            members=len(ops), reason=reason, op=op_kind,
            cache_hit=cache_hit, lane=lane)

    @staticmethod
    def _flight_out(ln, run):
        """``run()`` → (host tensors, event) between the profiler's
        start and its dispatch mark; an exception aborts the launch."""
        try:
            out = run()
        except Exception:
            if ln is not None:
                ln.abort()
            raise
        if ln is not None:
            ln.dispatched()
        return out

    def _stage_in(self, batch: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(batch).to(self.device)

    def _stage_out(self, *tensors):
        """Queue each result's copy to host memory behind one event;
        the completion reads them after ``event.synchronize()``."""
        if self.device.type != "cuda":
            return tensors, None
        hosts = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            hosts.append(h)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return tuple(hosts), event

    def _batch(self, ops, rows, k, bucket_len) -> np.ndarray:
        batch = np.zeros((rows, k, bucket_len), dtype=np.uint8)
        for i, op in enumerate(ops):
            batch[i, :, :op.length] = op.chunks
        return batch

    @staticmethod
    def _payload_rows(ops, rows, bucket_len) -> np.ndarray:
        batch = np.zeros((rows, bucket_len), dtype=np.uint8)
        for i, op in enumerate(ops):
            batch[i, :op.length] = np.frombuffer(op.payload, np.uint8)
        return batch

    def _launch_encode(self, key, ops, rows, bucket_len,
                       reason) -> _Flight:
        from ..ops.gf_torch import GFEncodeDigest
        _kind, k, m, mat = key
        fused = self._fused.get(key)
        cache_hit = fused is not None
        if fused is None:
            fused = self._fused[key] = GFEncodeDigest(
                np.frombuffer(mat, dtype=np.uint8).reshape(m, k),
                device=self.device)
        batch = self._batch(ops, rows, k, bucket_len)
        ln = self._prof_start(ops, rows, batch.nbytes, reason, "encode",
                              cache_hit)
        out, event = self._flight_out(ln, lambda: self._stage_out(
            *fused(self._stage_in(batch))))
        return _Flight("encode", ops, out, event, bucket_len, rows, reason,
                       ln)

    def _launch_digest(self, _key, ops, rows, bucket_len,
                       reason) -> _Flight:
        from ..scrub.crc32c import crc32c_rows
        batch = self._payload_rows(ops, rows, bucket_len)
        ln = self._prof_start(ops, rows, batch.nbytes, reason, "digest",
                              True)
        out, event = self._flight_out(ln, lambda: self._stage_out(
            crc32c_rows(self._stage_in(batch))))
        return _Flight("digest", ops, out[0], event, bucket_len, rows,
                       reason, ln)

    def _launch_reconstruct(self, key, ops, rows, bucket_len,
                            reason) -> _Flight:
        from ..parallel.decode_plan import decode_plan
        _kind, k, m, mat, erasures = key
        coding = np.frombuffer(mat, dtype=np.uint8).reshape(m, k)
        cache_hit = len(self._plan_cache)
        plan = decode_plan(coding, k, m, erasures, cache=self._plan_cache)
        cache_hit = cache_hit == len(self._plan_cache)
        batch = self._batch(ops, rows, k, bucket_len)
        ln = self._prof_start(ops, rows, batch.nbytes, reason, "recon",
                              cache_hit, lane="recon")
        out, event = self._flight_out(ln, lambda: self._stage_out(
            self._run_reconstruct(plan, self._stage_in(batch))))
        return _Flight("recon", ops, out[0], event, bucket_len, rows,
                       reason, ln, plan=plan)

    def _run_reconstruct(self, plan, batch: torch.Tensor) -> torch.Tensor:
        """One launch group for a reconstruct group: resident planes
        expand the survivors once and multiply by the plan's stacked
        matrix, with per-matrix tables held across the sweep in
        ``_plane_mats``."""
        from ..ops.gf_words import ResidentPlanes
        rp = ResidentPlanes(batch, mats=self._plane_mats)
        return rp.multiply(plan.matrix)

    def _launch_recheck(self, key, ops, rows, bucket_len,
                        reason) -> _Flight:
        _kind, k, m, mat = key
        prog = self._rexec.get(key)
        cache_hit = prog is not None
        if prog is None:
            from ..ops.gf_torch import GFLinear
            prog = self._rexec[key] = GFLinear(
                np.frombuffer(mat, dtype=np.uint8).reshape(m, k),
                device=self.device)
        batch = self._batch(ops, rows, k, bucket_len)
        ln = self._prof_start(ops, rows, batch.nbytes, reason, "recheck",
                              cache_hit, lane="recon")
        out, event = self._flight_out(ln, lambda: self._stage_out(
            prog(self._stage_in(batch))))
        return _Flight("recheck", ops, out[0], event, bucket_len, rows,
                       reason, ln)

    def _launch_compress(self, _key, ops, rows, bucket_len,
                         reason) -> _Flight:
        """Stage one codec's ops into a pow2 megabatch and run the
        codec's device scan (``scan_batch``, K9 for ``rle``); a host-only
        codec (zlib) flies with no output and finalizes every member in
        ``_complete_comp``, sharing the lane's flush cadence and stats."""
        scan = ops[0].codec.scan_batch
        if scan is None:
            ln = self._prof_start(ops, rows, sum(op.length for op in ops),
                                  reason, "compress", True, lane="comp")
            out, event = self._flight_out(ln, lambda: ((None,), None))
        else:
            batch = self._payload_rows(ops, rows, bucket_len)
            ln = self._prof_start(ops, rows, batch.nbytes, reason,
                                  "compress", True, lane="comp")
            out, event = self._flight_out(ln, lambda: self._stage_out(
                scan(self._stage_in(batch))))
        return _Flight("compress", ops, out[0], event, bucket_len, rows,
                       reason, ln)

    def _launch_fingerprint(self, _key, ops, rows, bucket_len,
                            reason) -> _Flight:
        """Two launches a flush: K8's gear hashes over the pow2
        megabatch, of which only the rows' hits of the chunker's mask
        (``(h & mask) == 0``, a few per chunk) come back to the host;
        then, after the host walks them into bounded chunk spans
        (``Chunker.cuts_from_candidates``, the spans of
        ``cuts_from_hashes`` on the full hashes), one K6 launch digests
        every chunk of the flush, gathered from the staged megabatch
        into rows zero-padded at the back.  The flight carries the
        digests; ``_complete_comp`` unpads them."""
        from ..compress.chunker import chunk_bucket, gather_chunks
        from ..scrub.crc32c import crc32c_rows
        chunker = ops[0].chunker
        batch = self._payload_rows(ops, rows, bucket_len)
        ln = self._prof_start(ops, rows, batch.nbytes, reason,
                              "fingerprint", True, lane="comp")
        spans = []

        def run():
            staged = self._stage_in(batch)
            hits = torch.nonzero((chunker.hash_batch(staged)
                                  & int(chunker.mask)) == 0).cpu().numpy()
            bounds = np.searchsorted(hits[:, 0], np.arange(len(ops) + 1))
            owner, offs, lens = [], [], []
            for i, op in enumerate(ops):
                pos = hits[bounds[i]:bounds[i + 1], 1]
                cuts = chunker.cuts_from_candidates(
                    pos[pos < op.length] + 1, op.length)
                ends = np.asarray(cuts, dtype=np.int64)
                starts = np.concatenate([[0], ends[:-1]])
                spans.append(list(zip(starts.tolist(),
                                      (ends - starts).tolist())))
                owner += [i] * len(cuts)
                offs.append(starts)
                lens.append(ends - starts)
            offs, lens = np.concatenate(offs), np.concatenate(lens)
            chunk_len = chunk_bucket(lens)
            out, event = self._stage_out(crc32c_rows(gather_chunks(
                staged, owner, offs, lens, chunk_len)))
            return out, event, chunk_len

        out, event, chunk_len = self._flight_out(ln, run)
        return _Flight("fingerprint", ops, out[0], event, bucket_len, rows,
                       reason, ln, spans=spans, chunk_len=chunk_len)

    # -- completion --------------------------------------------------------

    def _fence(self, fl: _Flight) -> bool:
        """Wait at the flight's event and close its profiler launch
        (``compute`` is that wait); a launch that died fails every
        member."""
        try:
            if fl.event is not None:
                fl.event.synchronize()
        except Exception as e:      # noqa: BLE001 — launch died at the
            if fl.ln is not None:   # fence: fail every member
                fl.ln.abort()
            self._fail_group(fl.ops, e, fl.span)
            return False
        if fl.ln is not None:
            outs = fl.out if isinstance(fl.out, tuple) else (fl.out,)
            fl.ln.finish(bytes_out=sum(t.numel() * t.element_size()
                                       for t in outs if t is not None))
        return True

    def _complete(self, fl: _Flight):
        from ..scrub.crc32c import crc32c_zero_unpad
        if fl.kind in ("compress", "fingerprint"):
            self._complete_comp(fl)
            return
        if not self._fence(fl):
            return
        if fl.span is not None:
            fl.span.finish()
        parity = crcs = rec = None
        if fl.kind == "encode":
            parity = fl.out[0].numpy()
            crcs = fl.out[1].numpy().view(np.uint32)
        elif fl.kind == "digest":
            crcs = fl.out.numpy().view(np.uint32)
        else:                   # recon | recheck
            rec = fl.out.numpy()
        info = {"rows": fl.bucket, "members": len(fl.ops),
                "row_len": fl.length, "reason": fl.reason}
        if rec is not None:
            info["lane"] = "recon"
            plan = fl.plan
            for i, op in enumerate(fl.ops):
                try:
                    if fl.kind == "recheck":
                        value = np.ascontiguousarray(
                            rec[i, :, :op.length])
                    else:
                        value = {
                            cid: (op.passthrough[cid]
                                  if cid in op.passthrough else
                                  np.ascontiguousarray(
                                      rec[i, plan.row_of[cid],
                                          :op.length]))
                            for cid in op.want}
                    op.comp.info = info
                    op.comp._fire(value=value)
                    self.stats["recon_ops_completed"] += 1
                except Exception:   # noqa: BLE001 — a member's
                    # callback blowing up must not starve its siblings
                    self.stats["callback_errors"] += 1
            return
        for i, op in enumerate(fl.ops):
            pad = fl.length - op.length
            try:
                if fl.kind == "encode":
                    k = op.chunks.shape[0]
                    m = parity.shape[1]
                    shard_chunks = {j: op.chunks[j].tobytes()
                                    for j in range(k)}
                    for j in range(m):
                        shard_chunks[k + j] = \
                            parity[i, j, :op.length].tobytes()
                    hinfos = {s: crc32c_zero_unpad(int(crcs[i, s]), pad)
                              for s in range(k + m)}
                    value = (shard_chunks, hinfos)
                else:
                    value = crc32c_zero_unpad(int(crcs[i]), pad)
                op.comp.info = info
                op.comp._fire(value=value)
                self.stats["ops_completed"] += 1
            except Exception:       # noqa: BLE001 — a member's
                # callback blowing up must not starve its siblings
                self.stats["callback_errors"] += 1

    def _complete_comp(self, fl: _Flight):
        """Fence, then finalize each member of a compression-lane
        flight on the host.  A member whose finalize raises fails
        alone."""
        from ..compress.chunker import fingerprints_from_padded
        if not self._fence(fl):
            return
        scan = fl.out.numpy() if fl.out is not None else None
        info = {"rows": fl.bucket, "members": len(fl.ops),
                "row_len": fl.length, "reason": fl.reason, "lane": "comp"}
        if fl.kind == "fingerprint":
            # every chunk of the flight unpadded in one numpy pass
            try:
                fps = iter(fingerprints_from_padded(
                    scan.view(np.uint32),
                    [op.payload[off:off + ln]
                     for op, spans in zip(fl.ops, fl.spans)
                     for off, ln in spans], fl.chunk_len))
            except Exception as e:  # noqa: BLE001 — fail the flight
                self._fail_group(fl.ops, e, fl.span)
                return
        for i, op in enumerate(fl.ops):
            try:
                if fl.kind == "compress":
                    blob = (op.codec.compress(op.payload) if scan is None
                            else op.codec.compress_from_scan(
                                np.frombuffer(op.payload, np.uint8),
                                op.length, scan[i]))
                    value = self._seal(op.codec, op.payload, op.mode, blob)
                else:
                    value = [(off, ln, next(fps))
                             for off, ln in fl.spans[i]]
                    self.stats["comp_fingerprint_bytes"] += op.length
            except Exception as e:  # noqa: BLE001 — poisoned member
                self.stats["comp_ops_failed"] += 1
                try:
                    op.comp._fire(error=e)
                except Exception:   # noqa: BLE001
                    self.stats["callback_errors"] += 1
                continue
            op.comp.info = info
            try:
                op.comp._fire(value=value)
                self.stats["comp_ops_completed"] += 1
            except Exception:       # noqa: BLE001 — a member's
                # callback blowing up must not starve its siblings
                self.stats["callback_errors"] += 1
        if fl.span is not None:
            fl.span.finish()

    def _fail_group(self, ops, err, span=None):
        if span is not None:
            span.set_tag("error", repr(err))
            span.finish()
        for op in ops:
            self.stats["recon_ops_failed"
                       if op.kind in ("recon", "recheck")
                       else "comp_ops_failed"
                       if op.kind in ("compress", "fingerprint")
                       else "ops_failed"] += 1
            try:
                op.comp._fire(error=err)
            except Exception:       # noqa: BLE001
                self.stats["callback_errors"] += 1
