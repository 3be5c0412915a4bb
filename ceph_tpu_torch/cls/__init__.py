"""Object classes — server-side compute on objects.

The port's copy of ``ceph_tpu.cls``.

Reference behavior re-created (``src/osd/ClassHandler.cc`` +
``src/cls/``; SURVEY.md §3.5): clients invoke named methods that run
ON the primary inside the op pipeline with read access to the object
and the ability to stage mutations — the mechanism behind rbd/rgw
metadata ops and advisory locking.  The reference dlopens
``libcls_*.so``; here classes are Python modules registered in-process
(`register`, `method`), the idiomatic analog of the plugin registry.

Built-ins: ``lock`` (advisory shared/exclusive locks with cookies —
reference ``src/cls/lock``) and ``version`` (monotonic object version
stamps — reference ``src/cls/version``).
"""

from __future__ import annotations

import json


class ClsError(Exception):
    def __init__(self, rc: int, msg: str = ""):
        super().__init__(msg or f"cls error rc={rc}")
        self.rc = rc


class ClsContext:
    """What a class method sees (reference cls_method_context_t):
    reads against the object's current state, staged writes that join
    the surrounding op's transaction."""

    def __init__(self, read_xattr, exists, read_omap=None):
        self._read_xattr = read_xattr
        self._exists = exists
        self._read_omap = read_omap
        self.staged_ops: list[dict] = []

    # -- reads -------------------------------------------------------------
    def exists(self) -> bool:
        return self._exists()

    def get_xattr(self, name: str) -> bytes | None:
        return self._read_xattr(name)

    def get_omap(self) -> dict[str, bytes]:
        if self._read_omap is None:
            return {}
        return self._read_omap()

    # -- staged writes ------------------------------------------------------
    def set_xattr(self, name: str, value: bytes):
        self.staged_ops.append({"op": "setxattr", "name": name,
                                "data": value.hex()})

    def rm_xattr(self, name: str):
        self.staged_ops.append({"op": "rmxattr", "name": name})

    def set_omap(self, kv: dict[str, bytes]):
        self.staged_ops.append({"op": "omap_set", "kv": {
            k: v.hex() for k, v in kv.items()}})

    def rm_omap(self, keys: list[str]):
        self.staged_ops.append({"op": "omap_rm", "keys": list(keys)})

    def create(self):
        """Ensure the object exists (zero-length write)."""
        if not self.exists():
            self.staged_ops.append({"op": "write_full", "data": ""})


_REGISTRY: dict[str, dict[str, object]] = {}


def register(cls_name: str):
    _REGISTRY.setdefault(cls_name, {})


def method(cls_name: str, name: str):
    """Decorator: fn(ctx, input_bytes) -> output_bytes (raise
    ClsError(-errno) to fail the op)."""
    register(cls_name)

    def deco(fn):
        _REGISTRY[cls_name][name] = fn
        return fn
    return deco


def call(cls_name: str, method_name: str, ctx: ClsContext,
         inp: bytes) -> bytes:
    cls = _REGISTRY.get(cls_name)
    if cls is None:
        raise ClsError(-95, f"no class {cls_name!r}")      # EOPNOTSUPP
    fn = cls.get(method_name)
    if fn is None:
        raise ClsError(-95, f"no method {cls_name}.{method_name}")
    out = fn(ctx, inp)
    return out if out is not None else b""


# --------------------------------------------------------------------------
# cls_lock — advisory locking (reference src/cls/lock/cls_lock.cc)
# --------------------------------------------------------------------------
_LOCK_XATTR = "lock.%s"


def _load_lock(ctx: ClsContext, name: str) -> dict:
    raw = ctx.get_xattr(_LOCK_XATTR % name)
    return json.loads(bytes(raw)) if raw else {"type": "", "lockers": {}}


@method("lock", "lock")
def _lock_lock(ctx: ClsContext, inp: bytes) -> bytes:
    req = json.loads(inp.decode())
    name = req["name"]
    ltype = req.get("type", "exclusive")
    cookie = req["cookie"]
    entity = req.get("entity", "")
    st = _load_lock(ctx, name)
    holders = st["lockers"]
    mine = f"{entity}/{cookie}"
    if holders:
        if st["type"] == "exclusive" or ltype == "exclusive":
            if list(holders) != [mine]:
                raise ClsError(-16, "lock held")           # EBUSY
    st["type"] = ltype
    holders[mine] = {"entity": entity, "cookie": cookie, "type": ltype}
    ctx.create()
    ctx.set_xattr(_LOCK_XATTR % name, json.dumps(st).encode())
    return b""


@method("lock", "unlock")
def _lock_unlock(ctx: ClsContext, inp: bytes) -> bytes:
    req = json.loads(inp.decode())
    name = req["name"]
    mine = f"{req.get('entity', '')}/{req['cookie']}"
    st = _load_lock(ctx, name)
    if mine not in st["lockers"]:
        raise ClsError(-2, "no such lock holder")          # ENOENT
    del st["lockers"][mine]
    if st["lockers"]:
        ctx.set_xattr(_LOCK_XATTR % name, json.dumps(st).encode())
    else:
        ctx.rm_xattr(_LOCK_XATTR % name)
    return b""


@method("lock", "info")
def _lock_info(ctx: ClsContext, inp: bytes) -> bytes:
    req = json.loads(inp.decode()) if inp else {}
    st = _load_lock(ctx, req.get("name", ""))
    return json.dumps(st).encode()


# --------------------------------------------------------------------------
# cls_version — monotonic object versions (reference src/cls/version)
# --------------------------------------------------------------------------
@method("version", "inc")
def _version_inc(ctx: ClsContext, inp: bytes) -> bytes:
    raw = ctx.get_xattr("cls.version")
    cur = int(bytes(raw)) if raw else 0
    ctx.create()
    ctx.set_xattr("cls.version", str(cur + 1).encode())
    return str(cur + 1).encode()


@method("version", "read")
def _version_read(ctx: ClsContext, inp: bytes) -> bytes:
    raw = ctx.get_xattr("cls.version")
    return bytes(raw) if raw else b"0"


# --------------------------------------------------------------------------
# cls_log — time-indexed log entries in omap (reference src/cls/log)
# --------------------------------------------------------------------------
# Keys sort by (timestamp, sub-second counter) so `list` pages in time
# order; `trim` drops everything up to a marker — the structure RGW
# multisite mdlog/datalog shards are built on.

def _log_key(ts: float, seq: int) -> str:
    return f"log.{ts:020.6f}.{seq:08d}"


@method("log", "add")
def _log_add(ctx: ClsContext, inp: bytes) -> bytes:
    import time as _time
    req = json.loads(inp.decode())
    entries = req["entries"] if "entries" in req else [req]
    rows = {}
    existing = ctx.get_omap()
    # persisted MONOTONIC counter: deriving seq from a key count
    # would re-mint a surviving key's seq after a partial trim and
    # silently overwrite its entry
    seq = int(existing.get("log_seq", b"0"))
    for e in entries:
        ts = float(e.get("timestamp", _time.time()))
        rows[_log_key(ts, seq)] = json.dumps(
            {"timestamp": ts, "section": e.get("section", ""),
             "name": e.get("name", ""),
             "data": e.get("data", "")}).encode()
        seq += 1
    rows["log_seq"] = str(seq).encode()
    ctx.create()
    ctx.set_omap(rows)
    return b""


@method("log", "list")
def _log_list(ctx: ClsContext, inp: bytes) -> bytes:
    req = json.loads(inp.decode()) if inp else {}
    marker = req.get("marker", "")
    limit = int(req.get("max_entries", 100))
    rows = ctx.get_omap()
    keys = sorted(k for k in rows if k.startswith("log.")
                  and k > marker)
    page = keys[:limit]
    out = {"entries": [dict(json.loads(bytes(rows[k])), key=k)
                       for k in page],
           "truncated": len(keys) > limit,
           "marker": page[-1] if page else marker}
    return json.dumps(out).encode()


@method("log", "trim")
def _log_trim(ctx: ClsContext, inp: bytes) -> bytes:
    req = json.loads(inp.decode())
    upto = req["to_marker"]
    rows = ctx.get_omap()
    dead = [k for k in rows if k.startswith("log.") and k <= upto]
    if not dead:
        raise ClsError(-2, "nothing to trim")
    ctx.rm_omap(dead)
    return b""
