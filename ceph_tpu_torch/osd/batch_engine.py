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

Four kinds of op share the machinery in two lanes:

- the **write lane** — ``submit_encode`` (encode + digest) and
  ``submit_digest`` (a CRC-32C of a payload);
- the **reconstruct lane** — ``submit_reconstruct`` (degraded reads,
  recovery) grouped per (code, erasure pattern, size bucket), one
  launch per group over the plan's stacked ``[k + p, k]`` matrix:
  through ``ResidentPlanes`` (``gf_expand`` + ``gf_planes``); and
  ``submit_recheck`` (scrub parity re-encode) through ``GFLinear``.

Flush policy (as ceph_tpu's): ``max_bytes`` / ``max_ops`` trigger at
submit; ``flush_ms == 0`` flushes every submit synchronously;
``flush_ms > 0`` arms ``schedule`` and enables the flight pipeline: a
flush launches its groups, queues each result's device→host copy into
pinned memory behind a CUDA event, and hands the flights to a FIFO
completion worker that waits on each event before reading — the next
tick stages while earlier flights drain, and FIFO completion keeps
per-PG ordering.

Not carried over in this slice: the compression and fingerprint lanes,
the mesh, the device profiler and the tracer.
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
                 "nbytes", "comp", "want", "passthrough")

    def __init__(self, kind, key, comp, length, nbytes, chunks=None,
                 payload=None, want=None, passthrough=None):
        self.kind = kind            # "encode"|"digest"|"recon"|"recheck"
        self.key = key              # executable-identity group key
        self.comp = comp
        self.length = length        # true (unpadded) per-row length
        self.nbytes = nbytes
        self.chunks = chunks        # encode/recheck: [k, length];
        #                             recon: survivor stack [k, length]
        self.payload = payload      # digest: bytes
        self.want = want            # recon: frozenset of wanted ids
        self.passthrough = passthrough  # recon: {id: chunk} present+wanted


class _Flight:
    """One launched group awaiting its fence."""

    __slots__ = ("kind", "ops", "out", "event", "length", "bucket",
                 "reason", "plan")

    def __init__(self, kind, ops, out, event, length, bucket, reason,
                 plan=None):
        self.kind = kind
        self.ops = ops
        self.out = out              # host tensors, valid after event
        self.event = event          # CUDA event or None (CPU)
        self.length = length        # bucket row length
        self.bucket = bucket        # padded row count
        self.reason = reason
        self.plan = plan            # recon: DecodePlan (row_of mapping)


class BatchEngine:
    """Tick-accumulating megabatch launcher for one OSD's device ops."""

    def __init__(self, name: str = "", *, device=None, enabled: bool = True,
                 max_bytes: int = 8 << 20, max_ops: int = 64,
                 flush_ms: float = 0.0, schedule=None,
                 recon_enabled: bool | None = None,
                 recon_max_bytes: int | None = None,
                 recon_max_ops: int | None = None,
                 recon_flush_ms: float | None = None,
                 bucket_floor: int = 32):
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
        self.bucket_floor = int(bucket_floor)
        self._schedule = schedule   # schedule(delay_s, fn) -> token
        self._lock = threading.Lock()        # pending accumulators
        self._flush_lock = threading.Lock()  # serializes dispatch
        self._pending: dict[str, list[_Op]] = {"write": [], "recon": []}
        self._pending_bytes = {"write": 0, "recon": 0}
        self._armed = {"write": False, "recon": False}
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

    def submit_encode(self, ec, data, *, callback=None) -> Completion:
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
                                  chunks=chunks))
                return comp
        except Exception as e:      # noqa: BLE001 — poisoned payloads
            self.stats["ops_failed"] += 1   # fail their own op only
            comp._fire(error=e)
            return comp
        # fire outside the try: a callback raising must surface to the
        # submitter, not masquerade as an encode failure
        comp._fire(value=value)
        return comp

    def submit_digest(self, payload, *, callback=None) -> Completion:
        """Queue a CRC-32C digest; completion value is the int crc."""
        comp = Completion(callback)
        self.stats["ops_submitted"] += 1
        try:
            buf = bytes(payload)
            if self.enabled and not self._stopped and buf:
                self._enqueue(_Op("digest", ("digest",), comp,
                                  length=len(buf), nbytes=len(buf),
                                  payload=buf))
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

    def submit_reconstruct(self, ec, chunks, *, want=None,
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
                                     if i in present}), lane="recon")
                    return comp
        except Exception as e:      # noqa: BLE001 — poisoned payloads
            self.stats["recon_ops_failed"] += 1
            comp._fire(error=e)
            return comp
        comp._fire(value=value)
        return comp

    def submit_recheck(self, ec, data, *, callback=None) -> Completion:
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
                    nbytes=int(arr.nbytes), chunks=arr), lane="recon")
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

    # -- accumulation ------------------------------------------------------

    def _lane_knobs(self, lane: str) -> tuple[int, int, float]:
        """(max_ops, max_bytes, flush_ms) for one lane."""
        if lane == "recon":
            return (self.recon_max_ops, self.recon_max_bytes,
                    self.recon_flush_ms)
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
        lanes = ("write", "recon") if lane is None else (lane,)
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
                self._pending_bytes[lane] = 0
                self._armed[lane] = False
                use_worker = (ms > 0 and not self._stopped
                              and not force_inline)
            if not pending:
                return 0
            prefix = "recon_" if lane == "recon" else ""
            self.stats[f"{prefix}flush_{reason}"] += 1
            flights = self._dispatch(pending, reason, lane)
            for fl in flights:
                if use_worker:
                    self._ensure_worker()
                    self._flights.put(fl)
                else:
                    inline.append(fl)
        for fl in inline:
            self._complete(fl)
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
        launches_key = "recon_launches" if lane == "recon" else "launches"
        for (key, bucket_len), ops in self._groups(pending).items():
            rows = _next_pow2(len(ops))
            try:
                if key[0] == "encode":
                    fl = self._launch_encode(key, ops, rows, bucket_len,
                                             reason)
                elif key[0] == "digest":
                    fl = self._launch_digest(ops, rows, bucket_len, reason)
                elif key[0] == "recon":
                    fl = self._launch_reconstruct(key, ops, rows,
                                                  bucket_len, reason)
                else:
                    fl = self._launch_recheck(key, ops, rows, bucket_len,
                                              reason)
            except Exception as e:  # noqa: BLE001 — one group's
                # launch failure must not kill sibling groups
                self._fail_group(ops, e)
                continue
            flights.append(fl)
            self.stats[launches_key] += 1
        return flights

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

    def _launch_encode(self, key, ops, rows, bucket_len,
                       reason) -> _Flight:
        from ..ops.gf_torch import GFEncodeDigest
        _kind, k, m, mat = key
        fused = self._fused.get(key)
        if fused is None:
            fused = self._fused[key] = GFEncodeDigest(
                np.frombuffer(mat, dtype=np.uint8).reshape(m, k),
                device=self.device)
        parity, crcs = fused(self._stage_in(
            self._batch(ops, rows, k, bucket_len)))
        out, event = self._stage_out(parity, crcs)
        return _Flight("encode", ops, out, event, bucket_len, rows, reason)

    def _launch_digest(self, ops, rows, bucket_len, reason) -> _Flight:
        from ..scrub.crc32c import crc32c_rows
        batch = np.zeros((rows, bucket_len), dtype=np.uint8)
        for i, op in enumerate(ops):
            batch[i, :op.length] = np.frombuffer(op.payload, np.uint8)
        out, event = self._stage_out(crc32c_rows(self._stage_in(batch)))
        return _Flight("digest", ops, out[0], event, bucket_len, rows,
                       reason)

    def _launch_reconstruct(self, key, ops, rows, bucket_len,
                            reason) -> _Flight:
        from ..parallel.decode_plan import decode_plan
        _kind, k, m, mat, erasures = key
        coding = np.frombuffer(mat, dtype=np.uint8).reshape(m, k)
        plan = decode_plan(coding, k, m, erasures, cache=self._plan_cache)
        rec = self._run_reconstruct(
            plan, self._stage_in(self._batch(ops, rows, k, bucket_len)))
        out, event = self._stage_out(rec)
        return _Flight("recon", ops, out[0], event, bucket_len, rows,
                       reason, plan=plan)

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
        if prog is None:
            from ..ops.gf_torch import GFLinear
            prog = self._rexec[key] = GFLinear(
                np.frombuffer(mat, dtype=np.uint8).reshape(m, k),
                device=self.device)
        out, event = self._stage_out(prog(self._stage_in(
            self._batch(ops, rows, k, bucket_len))))
        return _Flight("recheck", ops, out[0], event, bucket_len, rows,
                       reason)

    # -- completion --------------------------------------------------------

    def _complete(self, fl: _Flight):
        from ..scrub.crc32c import crc32c_zero_unpad
        parity = crcs = rec = None
        try:
            if fl.event is not None:
                fl.event.synchronize()      # the fence
            if fl.kind == "encode":
                parity = fl.out[0].numpy()
                crcs = fl.out[1].numpy().view(np.uint32)
            elif fl.kind == "digest":
                crcs = fl.out.numpy().view(np.uint32)
            else:               # recon | recheck
                rec = fl.out.numpy()
        except Exception as e:      # noqa: BLE001 — launch died at the
            self._fail_group(fl.ops, e)     # fence: fail every member
            return
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

    def _fail_group(self, ops, err):
        for op in ops:
            self.stats["recon_ops_failed"
                       if op.kind in ("recon", "recheck")
                       else "ops_failed"] += 1
            try:
                op.comp._fire(error=err)
            except Exception:       # noqa: BLE001
                self.stats["callback_errors"] += 1
