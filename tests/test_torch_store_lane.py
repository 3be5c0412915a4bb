"""The slice as a whole on the CPU: the OSD's write path below the PG.
Both packages' batch engines (ceph_tpu's through JAX on the CPU, the
port's with ``device="cpu"``) encode the same seeded writes, k=8 m=3,
and each completion queues one transaction per shard into its own
``WALStore`` (remove, touch, write, and the ``"_"`` attribute with the
shard's hinfo, as ceph_tpu's PG builds it).  The engines carry a tracer
and kick the store's group commit once a flush.  The WAL files must be
identical, the kicks equal the flushes, the ``megabatch_flush`` spans
equal the launches, and the shards read back after a remount digest to
their stored hinfos."""

import json

import numpy as np
import pytest
import torch

import ceph_tpu.os_store as J
import ceph_tpu_torch.os_store as P
from ceph_tpu.core.threading_utils import SafeTimer as JSafeTimer
from ceph_tpu.core.tracer import Tracer as JTracer
from ceph_tpu.ec import create_erasure_code as j_create
from ceph_tpu.osd.batch_engine import BatchEngine as JBatchEngine
from ceph_tpu.osd.pg import _obj_meta as j_obj_meta
from ceph_tpu_torch.core.threading_utils import SafeTimer
from ceph_tpu_torch.core.tracer import Tracer
from ceph_tpu_torch.ec import create_erasure_code
from ceph_tpu_torch.osd.batch_engine import BatchEngine
from ceph_tpu_torch.scrub.crc32c import crc32c_rows

torch.set_num_threads(1)

K, M = 8, 3
N_OBJ, OBJ = 8, 64 << 10
PGID = "1.7"
PROFILE = {"plugin": "jerasure", "technique": "reed_sol_van", "k": K, "m": M}
MODES = [pytest.param(0.0, id="immediate"),
         pytest.param(1000.0, id="deadline")]


def obj_meta(version, size, hinfo=None):
    """``ceph_tpu.osd.pg._obj_meta`` (the object's ``"_"`` attribute)."""
    d = {"version": list(version), "size": size}
    if hinfo is not None:
        d["hinfo"] = hinfo
    return json.dumps(d).encode()


def _side(port: bool):
    if port:
        return dict(os=P, engine=lambda **kw: BatchEngine(device="cpu", **kw),
                    ec=create_erasure_code(PROFILE, device="cpu"),
                    tracer=Tracer, timer=SafeTimer, meta=obj_meta)
    return dict(os=J, engine=lambda **kw: JBatchEngine(**kw),
                ec=j_create(PROFILE), tracer=JTracer, timer=JSafeTimer,
                meta=j_obj_meta)


def _drive(port, path, flush_ms):
    side = _side(port)
    T = side["os"].Transaction
    store = side["os"].WALStore(path, sync_mode="batch")
    store.mount()
    mk = T()
    for s in range(K + M):
        mk.create_collection(f"{PGID}s{s}")
    store.queue_transaction(mk)
    tracer = side["tracer"](daemon="osd.0", enabled=True)
    timer = side["timer"]("t")
    eng = side["engine"](name="osd.0", max_ops=4, max_bytes=1 << 30,
                         flush_ms=flush_ms,
                         schedule=lambda d, fn: timer.add_event_after(d, fn),
                         tracer=tracer, store_kick=store.kick)
    rng = np.random.default_rng(17)
    payloads = [rng.integers(0, 256, OBJ, dtype=np.uint8).tobytes()
                for _ in range(N_OBJ)]
    acked = []

    def encoded(i, comp):
        shards, hinfos = comp.value
        oid = f"obj{i}"
        for s in range(K + M):
            cid = f"{PGID}s{s}"
            t = (T().remove(cid, oid).touch(cid, oid)
                 .write(cid, oid, 0, shards[s])
                 .setattrs(cid, oid, {"_": side["meta"](
                     (1, i + 1), OBJ, hinfo=hinfos[s])}))
            store.queue_transaction(
                t, on_commit=lambda i=i, s=s: acked.append((i, s)))

    op_spans = [tracer.start_span("osd_op", tags={"layer": "osd"})
                for _ in range(N_OBJ)]
    comps = [eng.submit_encode(side["ec"], p, span=op_spans[i],
                               callback=lambda c, i=i: encoded(i, c))
             for i, p in enumerate(payloads)]
    eng.drain()
    for c in comps:
        c.result(timeout=60)
    assert store.flush_commits(timeout=30)
    for s in op_spans:
        s.finish()
    eng.stop()
    timer.shutdown()
    stats, wal = dict(eng.stats), dict(store.wal_stats)
    spans = [s for s in tracer.dump() if s["name"] == "megabatch_flush"]
    store.umount()
    with open(path, "rb") as f:
        raw = f.read()
    return dict(raw=raw, stats=stats, wal=wal, spans=spans, acked=acked,
                op_spans=[s.span_id for s in op_spans], payloads=payloads)


@pytest.mark.parametrize("flush_ms", MODES)
def test_store_lane_matches_ceph_tpu(tmp_path, flush_ms):
    p = _drive(True, str(tmp_path / "p.wal"), flush_ms)
    j = _drive(False, str(tmp_path / "j.wal"), flush_ms)
    assert p["raw"] == j["raw"]
    assert sorted(p["acked"]) == sorted(j["acked"]) == [
        (i, s) for i in range(N_OBJ) for s in range(K + M)]
    for key in ("launches", "store_kicks", "ops_completed"):
        assert p["stats"].get(key) == j["stats"].get(key), key
    for key in ("records", "bytes", "group_commits"):
        assert p["wal"][key] == j["wal"][key], key

    stats = p["stats"]
    flushes = sum(v for k, v in stats.items() if k.startswith("flush_"))
    assert stats["store_kicks"] == flushes
    assert stats["launches"] == len(p["spans"])
    assert flushes == (2 if flush_ms else N_OBJ)
    linked = [l["s"] for s in p["spans"] for l in s["links"]]
    assert sorted(linked) == sorted(p["op_spans"])
    for s in p["spans"]:
        assert s["tags"]["members"] == len(s["links"])
        assert s["tags"]["op"] == "encode" and s["duration"] is not None


@pytest.mark.parametrize("port", [True, False], ids=["port", "ceph_tpu"])
def test_read_back_digests_equal_hinfos(tmp_path, port):
    """Remount the WAL the port wrote and re-digest every shard (the
    port's ``crc32c_rows``); each equals its stored hinfo.  Either
    package's store reads it."""
    path = str(tmp_path / "p.wal")
    out = _drive(True, path, 1000.0)
    store = (P if port else J).WALStore(path)
    store.mount()
    assert store.replay_stats["tail"]["status"] == "clean"
    rows, hinfos = [], []
    for i in range(N_OBJ):
        for s in range(K + M):
            cid = f"{PGID}s{s}"
            rows.append(np.frombuffer(store.read(cid, f"obj{i}"), np.uint8))
            meta = json.loads(store.getattr(cid, f"obj{i}", "_"))
            assert meta["size"] == OBJ and meta["version"] == [1, i + 1]
            hinfos.append(meta["hinfo"])
    store.umount()
    got = crc32c_rows(torch.from_numpy(np.stack(rows)))
    assert got.numpy().view(np.uint32).tolist() == hinfos
    data = b"".join(rows[i * (K + M) + s].tobytes() for i in range(1)
                    for s in range(K))
    assert data[:OBJ] == out["payloads"][0]


def _hooked(port: bool):
    """Every lane once through an engine with all three daemon hooks."""
    from ceph_tpu.compress.chunker import Chunker as JChunker
    from ceph_tpu.compress.registry import create_codec as j_codec
    from ceph_tpu_torch.compress.chunker import Chunker
    from ceph_tpu_torch.compress.registry import create_codec
    side = _side(port)
    flushes, kicks = [], []
    tracer = side["tracer"](daemon="osd.0", enabled=True)
    eng = side["engine"](name="osd.0", tracer=tracer,
                         on_lane_flush=lambda *a: flushes.append(a),
                         store_kick=lambda: kicks.append(1))
    codec = (create_codec if port else j_codec)("rle")
    chunker = (Chunker if port else JChunker)(256)
    rng = np.random.default_rng(3)
    blob = rng.integers(0, 4, 5000, dtype=np.uint8).repeat(3).tobytes()
    ec = side["ec"]
    shards = ec.encode(set(range(K + M)), blob[:8192])
    root = tracer.start_span("op")
    comps = [
        eng.submit_digest(blob, span=root),
        eng.submit_reconstruct(ec, {i: c for i, c in shards.items()
                                    if i not in (0, 9)}, span=root.ctx()),
        eng.submit_recheck(ec, ec.encode_prepare(blob[:8192]), span=root),
        eng.submit_compress(codec, blob, span=root),
        eng.submit_fingerprint(chunker, blob, span=root),
        eng.submit_encode(ec, b"", span=root)]        # fails: no payload
    for c in comps:
        c.wait(30)
    eng.stop()
    spans = sorted((s["tags"]["lane"], s["tags"]["op"], len(s["links"]),
                    "error" in s["tags"])
                   for s in tracer.dump() if s["name"] == "megabatch_flush")
    return (flushes, len(kicks), spans,
            {k: v for k, v in eng.stats.items() if "kick" in k})


def test_engine_hooks_on_every_lane():
    p, j = _hooked(True), _hooked(False)
    assert p == j
    flushes, kicks, spans, stats = p
    assert kicks == len(flushes) == sum(stats.values())
    assert {f[0] for f in flushes} == {"write", "recon", "comp"}
    assert {s[1] for s in spans} >= {"digest", "recon", "recheck",
                                     "compress", "fingerprint"}
    assert all(links == 1 for _l, _o, links, _e in spans)
