"""librados-style API — Rados / IoCtx / Completion.

The port's copy of ``ceph_tpu.osdc.librados``.

Reference behavior re-created (``src/librados/``, ``librados.hpp``;
SURVEY.md §3.8): a cluster handle (`Rados`) opens per-pool I/O contexts
(`IoCtx`); object ops compose into one submission (the reference's
``ObjectWriteOperation``); sync wrappers ride the async engine, and
``aio_*`` return `Completion` objects with ``wait_for_complete``.
"""

from __future__ import annotations

import threading

from ..mon.client import MonClient
from .objecter import Objecter


class Error(Exception):
    def __init__(self, rc: int, msg: str = ""):
        super().__init__(f"rc={rc}: {msg}")
        self.rc = rc


class ObjectNotFound(Error):
    pass


def _raise(rc: int, outs: str):
    if rc == -2:
        raise ObjectNotFound(rc, outs)
    if rc != 0:
        raise Error(rc, outs)


class Completion:
    """AioCompletion analog."""

    def __init__(self):
        self._ev = threading.Event()
        self.rc: int | None = None
        self.results = None
        self.version = (0, 0)

    def _complete(self, rc, outs, results, version):
        self.rc, self.results, self.version = rc, results, version
        self._ev.set()

    def wait_for_complete(self, timeout: float | None = None) -> bool:
        return self._ev.wait(timeout)

    def is_complete(self) -> bool:
        return self._ev.is_set()


class Rados:
    """Cluster handle (reference ``librados::Rados``)."""

    def __init__(self, monmap, name: str = "client.admin", auth=None,
                 config=None):
        self.monmap = monmap
        self.name = name
        self.auth = auth
        # optional ConfigProxy: carries the objecter resend/backoff
        # knobs (objecter_resend_*, objecter_backoff_expire)
        self.config = config
        self.monc = MonClient(monmap, entity=name, auth=auth)
        self.objecter: Objecter | None = None

    def connect(self, timeout: float = 15.0):
        kw = {}
        if self.config is not None:
            kw = {"resend_interval": float(
                      self.config.get("objecter_resend_interval")),
                  "resend_max": float(
                      self.config.get("objecter_resend_max")),
                  "resend_jitter": float(
                      self.config.get("objecter_resend_jitter")),
                  "backoff_expire": float(
                      self.config.get("objecter_backoff_expire")),
                  "tracing": bool(
                      self.config.get("jaeger_tracing_enable")),
                  "tracer_ring": int(
                      self.config.get("tracer_ring_size")),
                  "tracer_sampling_rate": float(
                      self.config.get("tracer_sampling_rate")),
                  "tracer_span_budget": int(
                      self.config.get("tracer_span_budget"))}
        self.objecter = Objecter(self.monmap, entity=self.name,
                                 auth=self.auth, **kw)
        self.objecter.wait_for_osdmap(1, timeout)
        return self

    def shutdown(self):
        if self.objecter:
            self.objecter.shutdown()
        self.monc.shutdown()

    def set_qos_tag(self, tag: str | None):
        """Tag ops submitted from this thread with a tenant/uid: the
        OSDs' mClock scheduler keys its per-client QoS streams by the
        tag (per-tenant isolation even when many tenants share one
        connection).  None clears."""
        if self.objecter:
            self.objecter.set_qos_tag(tag)

    def mgr_command(self, cmd: dict | str,
                    timeout: float | None = None):
        """Command served by the active mgr (reference
        ``rados_mgr_command`` — the `ceph orch`/`ceph tell mgr`
        transport)."""
        return self.monc.mgr_command(cmd, timeout=timeout)

    # -- pool ops (mon plane) ---------------------------------------------
    def create_pool(self, name: str, *, pg_num: int = 8,
                    pool_type: str = "replicated", size: int = 3,
                    erasure_code_profile: str = "", rule: int = 0,
                    min_size: int | None = None,
                    compression_mode: str | None = None,
                    compression_algorithm: str | None = None,
                    dedup_enable: bool | None = None):
        cmd = {"prefix": "osd pool create", "pool": name,
               "pg_num": pg_num, "pool_type": pool_type, "size": size,
               "rule": rule}
        if min_size is not None:
            cmd["min_size"] = min_size
        if erasure_code_profile:
            cmd["erasure_code_profile"] = erasure_code_profile
        if compression_mode is not None:
            cmd["compression_mode"] = compression_mode
        if compression_algorithm is not None:
            cmd["compression_algorithm"] = compression_algorithm
        if dedup_enable is not None:
            cmd["dedup_enable"] = dedup_enable
        rc, outs, _ = self.monc.command(cmd)
        _raise(rc, outs)

    def delete_pool(self, name: str):
        rc, outs, _ = self.monc.command(
            {"prefix": "osd pool delete", "pool": name})
        _raise(rc, outs)

    def list_pools(self) -> list[str]:
        rc, outs, out = self.monc.command({"prefix": "osd pool ls"})
        _raise(rc, outs)
        return out

    def pool_lookup(self, name: str, timeout: float = 10.0) -> int:
        import time
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            m = self.objecter.osdmap
            if name in m.pool_name:
                return m.pool_name[name]
            time.sleep(0.05)
        raise ObjectNotFound(-2, f"pool {name!r}")

    def open_ioctx(self, pool_name: str) -> "IoCtx":
        return IoCtx(self, self.pool_lookup(pool_name), pool_name)

    def open_ioctx_direct(self, pool_name: str) -> "IoCtx":
        """IoCtx that bypasses cache-tier overlay redirects."""
        return IoCtx(self, self.pool_lookup(pool_name), pool_name,
                     direct=True)

    def mon_command(self, cmd: dict):
        return self.monc.command(cmd)

    def cache_flush_evict_all(self, base_pool: str) -> int:
        """Flush every cache-pool object back to `base_pool` and
        evict it (reference ``rados cache-flush-evict-all``).  Runs
        under a dedicated `client.tier-` agent identity so its
        cache-pool deletes are not themselves tier-propagated, and
        reaches the base pool directly (bypassing the overlay
        redirect).  → objects flushed."""
        import uuid
        m = self.objecter.osdmap
        if base_pool not in m.pool_name:
            raise ObjectNotFound(-2, f"pool {base_pool!r}")
        bp = m.pools[m.pool_name[base_pool]]
        if bp.read_tier < 0 or bp.read_tier not in m.pools:
            raise Error(-22, f"pool {base_pool!r} has no overlay")
        cache_pool = m.pools[bp.read_tier].name
        agent = Rados(
            self.monmap,
            name=f"client.tier-flush-{uuid.uuid4().hex[:8]}",
            auth=self.auth).connect()
        try:
            cache_io = agent.open_ioctx_direct(cache_pool)
            base_io = agent.open_ioctx_direct(base_pool)
            n = 0
            for oid in cache_io.list_objects():
                try:
                    # ONE compound op: the version and the bytes come
                    # from the same serialized execution
                    res, _ = cache_io._sync(oid, [
                        {"op": "stat"}, {"op": "read"}])
                except ObjectNotFound:
                    continue    # raced a delete
                ver = res[0].get("version")
                data = bytes.fromhex(res[1].get("data", ""))
                base_io.write_full(oid, data)
                try:
                    for k, v in cache_io.getxattrs(oid).items():
                        base_io.setxattr(oid, k, v)
                except Exception:   # noqa: BLE001 — optional
                    pass
                try:
                    rows = cache_io.omap_get(oid)
                    if rows:
                        base_io.omap_set(oid, rows)
                except Exception:   # noqa: BLE001 — optional
                    pass
                try:
                    # guarded evict: refuse if a client write landed
                    # after our read — that write must not be lost
                    cache_io._sync(oid, [
                        {"op": "delete", "if_version": ver}])
                    n += 1
                except Error as e:
                    if "if_version" not in str(e):
                        raise
                    # changed underneath us: leave it dirty; the next
                    # flush pass picks it up
            return n
        finally:
            agent.shutdown()


class IoCtx:
    """Per-pool I/O context (reference ``librados::IoCtx``)."""

    def __init__(self, rados: Rados, pool_id: int, pool_name: str,
                 direct: bool = False):
        self.rados = rados
        self.pool_id = pool_id
        self.pool_name = pool_name
        self.objecter = rados.objecter
        # direct: bypass the cache-tier overlay redirect (the flush/
        # promote agents must reach the BASE pool itself)
        self.direct = direct

    # -- async engine ------------------------------------------------------
    def _aio(self, oid: str, ops: list[dict]) -> Completion:
        c = Completion()
        self.objecter.op_submit(self.pool_id, oid, ops, c._complete,
                                direct=self.direct)
        return c

    def _sync(self, oid: str, ops: list[dict], timeout: float = 10.0):
        rc, outs, results, version = self.objecter.operate(
            self.pool_id, oid, ops, timeout, direct=self.direct)
        _raise(rc, outs)
        return results, version

    # -- writes ------------------------------------------------------------
    def write_full(self, oid: str, data: bytes):
        self._sync(oid, [{"op": "write_full", "data": data.hex()}])

    def write(self, oid: str, data: bytes, off: int = 0):
        self._sync(oid, [{"op": "write", "off": off,
                          "data": data.hex()}])

    def append(self, oid: str, data: bytes):
        self._sync(oid, [{"op": "append", "data": data.hex()}])

    def truncate(self, oid: str, size: int):
        self._sync(oid, [{"op": "truncate", "size": size}])

    def remove(self, oid: str):
        self._sync(oid, [{"op": "delete"}])

    def setxattr(self, oid: str, name: str, value: bytes):
        self._sync(oid, [{"op": "setxattr", "name": name,
                          "data": value.hex()}])

    def rmxattr(self, oid: str, name: str):
        self._sync(oid, [{"op": "rmxattr", "name": name}])

    def omap_set(self, oid: str, kv: dict[str, bytes]):
        self._sync(oid, [{"op": "omap_set",
                          "kv": {k: v.hex() for k, v in kv.items()}}])

    def omap_rm_keys(self, oid: str, keys: list[str]):
        self._sync(oid, [{"op": "omap_rm", "keys": list(keys)}])

    def execute(self, oid: str, cls: str, method: str,
                data: bytes = b"") -> bytes:
        """Invoke an object-class method on the primary (reference
        rados_exec / IoCtx::exec)."""
        results, _ = self._sync(oid, [{"op": "call", "cls": cls,
                                       "method": method,
                                       "data": data.hex()}])
        return bytes.fromhex(results[0].get("data", ""))

    def lock_exclusive(self, oid: str, name: str, cookie: str,
                       entity: str = ""):
        import json as _json
        self.execute(oid, "lock", "lock", _json.dumps({
            "name": name, "type": "exclusive", "cookie": cookie,
            "entity": entity or self.rados.objecter.entity}).encode())

    def unlock(self, oid: str, name: str, cookie: str,
               entity: str = ""):
        import json as _json
        self.execute(oid, "lock", "unlock", _json.dumps({
            "name": name, "cookie": cookie,
            "entity": entity or self.rados.objecter.entity}).encode())

    # -- pool snapshots ----------------------------------------------------
    def create_snap(self, snap_name: str):
        """Pool snapshot (reference rados_ioctx_snap_create)."""
        rc, outs, _ = self.rados.monc.command({
            "prefix": "osd pool mksnap", "pool": self.pool_name,
            "snap": snap_name})
        _raise(rc, outs)
        self._wait_snap_visible(snap_name, present=True)

    def remove_snap(self, snap_name: str):
        rc, outs, _ = self.rados.monc.command({
            "prefix": "osd pool rmsnap", "pool": self.pool_name,
            "snap": snap_name})
        _raise(rc, outs)
        self._wait_snap_visible(snap_name, present=False)

    def snap_lookup(self, snap_name: str) -> int:
        pool = self.objecter.osdmap.pools[self.pool_id]
        for sid, name in pool.snaps.items():
            if name == snap_name:
                return sid
        raise ObjectNotFound(-2, f"no snap {snap_name!r}")

    def list_snaps(self) -> dict[int, str]:
        return dict(self.objecter.osdmap.pools[self.pool_id].snaps)

    def _wait_snap_visible(self, snap_name: str, present: bool,
                           timeout: float = 10.0):
        """Block until this client's map reflects the snap change —
        writes issued after create_snap must carry the new seq."""
        import time as _t
        deadline = _t.monotonic() + timeout
        while _t.monotonic() < deadline:
            pool = self.objecter.osdmap.pools.get(self.pool_id)
            if pool is not None and \
                    (snap_name in pool.snaps.values()) == present:
                return
            _t.sleep(0.02)
        raise TimeoutError(f"snap {snap_name!r} never became "
                           f"{'visible' if present else 'gone'}")

    def snap_read(self, oid: str, snap_name: str,
                  length: int | None = None, off: int = 0) -> bytes:
        """Read an object as of a pool snapshot."""
        sid = self.snap_lookup(snap_name)
        op = {"op": "read", "off": off, "snapid": sid}
        if length is not None:
            op["len"] = length
        results, _ = self._sync(oid, [op])
        return bytes.fromhex(results[0]["data"])

    # -- watch/notify ------------------------------------------------------
    def watch(self, oid: str, callback) -> str:
        """Register `callback(notify_id, oid, payload)` for notifies
        on the object; returns the watch handle (reference
        rados_watch).  Sessions are primary-resident: a primary change
        drops them and the application re-watches (the reference's
        linger-op re-registration is future work)."""
        obj = self.rados.objecter
        obj._watch_id += 1
        local = obj._watch_id
        handle = f"{obj.entity}:{local}"
        obj.watch_cbs[handle] = callback
        self._sync(oid, [{"op": "watch", "watch_id": local}])
        return handle

    def unwatch(self, oid: str, handle: str):
        obj = self.rados.objecter
        local = int(handle.rsplit(":", 1)[1])
        self._sync(oid, [{"op": "unwatch", "watch_id": local}])
        obj.watch_cbs.pop(handle, None)

    def notify(self, oid: str, payload: bytes = b"",
               timeout: float = 10.0) -> dict:
        """Fire a notify; blocks until every watcher acks or the
        timeout lapses.  Returns {"replies": {watch_id: reply},
        "timed_out_watchers": [...]} (reference rados_notify2)."""
        results, _ = self._sync(oid, [{"op": "notify",
                                       "data": payload.hex(),
                                       "timeout": timeout}],
                                timeout=timeout + 10.0)
        return results[0]

    def aio_write_full(self, oid: str, data: bytes) -> Completion:
        return self._aio(oid, [{"op": "write_full", "data": data.hex()}])

    def aio_append(self, oid: str, data: bytes) -> Completion:
        return self._aio(oid, [{"op": "append", "data": data.hex()}])

    def aio_remove(self, oid: str) -> Completion:
        return self._aio(oid, [{"op": "delete"}])

    # -- reads -------------------------------------------------------------
    def read(self, oid: str, length: int | None = None,
             off: int = 0) -> bytes:
        op = {"op": "read", "off": off}
        if length is not None:
            op["len"] = length
        results, _ = self._sync(oid, [op])
        return bytes.fromhex(results[0]["data"])

    def aio_read(self, oid: str, length: int | None = None,
                 off: int = 0) -> Completion:
        op = {"op": "read", "off": off}
        if length is not None:
            op["len"] = length
        return self._aio(oid, [op])

    def stat(self, oid: str) -> dict:
        results, _ = self._sync(oid, [{"op": "stat"}])
        return results[0]

    def getxattr(self, oid: str, name: str) -> bytes:
        results, _ = self._sync(oid, [{"op": "getxattr", "name": name}])
        return bytes.fromhex(results[0]["data"])

    def getxattrs(self, oid: str) -> dict[str, bytes]:
        results, _ = self._sync(oid, [{"op": "getxattrs"}])
        return {k: bytes.fromhex(v)
                for k, v in results[0]["attrs"].items()}

    def omap_get(self, oid: str, keys: list[str] | None = None
                 ) -> dict[str, bytes]:
        """Full map, or just `keys` (reference
        omap_get_vals_by_keys — the OSD filters server-side)."""
        op = {"op": "omap_get"}
        if keys is not None:
            op["keys"] = list(keys)
        results, _ = self._sync(oid, [op])
        return {k: bytes.fromhex(v) for k, v in results[0]["kv"].items()}

    def omap_get_keys(self, oid: str) -> list[str]:
        """Key names only (reference omap_get_keys): no values cross
        the wire."""
        results, _ = self._sync(oid, [{"op": "omap_get",
                                       "keys_only": True}])
        return sorted(results[0]["kv"])

    def list_objects(self, timeout: float = 20.0) -> list[str]:
        """Pool listing = pgls over every PG (reference pool listing
        iterates PGs the same way)."""
        m = self.objecter.osdmap
        pool = m.pools[self.pool_id]
        oids: set[str] = set()
        from ..osd.osdmap import PGid
        for ps in range(pool.pg_num):
            rc, _outs, results, _ = self._pgls(PGid(self.pool_id, ps),
                                               timeout)
            if rc == 0 and results:
                oids.update(results[0].get("objects", []))
        return sorted(oids)

    def _pgls(self, pgid, timeout):
        """Direct-to-PG listing op (bypasses the name→PG hash).  The
        op is pinned to `pgid` and its resend schedule starts as
        ``op_submit``'s does, so a resend (a slow reply, a map
        advance, a reset session) asks the same PG again."""
        import threading as _t
        ev = _t.Event()
        box: list = []

        def on_reply(rc, outs, results, version):
            box.append((rc, outs, results, version))
            ev.set()

        with self.objecter.lock:
            self.objecter._tid += 1
            from .objecter import _Op
            op = _Op(self.objecter._tid, self.pool_id, "",
                     [{"op": "pgls"}], on_reply)
            op.pgid = op.pg_pin = pgid
            self.objecter._reset_resend(op)
            self.objecter.inflight[op.tid] = op
            _up, _upp, _acting, primary = \
                self.objecter.osdmap.pg_to_up_acting_osds(pgid)
            op.target_osd = primary
            con = self.objecter._osd_con(primary)
            if con is not None:
                from ..osd import messages as M
                con.send_message(M.MOSDOp(
                    tid=op.tid, client=self.objecter.entity,
                    pgid=str(pgid), oid="",
                    epoch=self.objecter.osdmap.epoch,
                    ops=[{"op": "pgls"}], flags=0))
        if not ev.wait(timeout):
            with self.objecter.lock:
                self.objecter.inflight.pop(op.tid, None)
            raise TimeoutError(f"pgls {pgid} timed out")
        return box[0]
