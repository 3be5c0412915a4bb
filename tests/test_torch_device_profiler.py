"""The port's device profiler (``ceph_tpu_torch.core.device_profiler``) on
the CPU: the recording semantics of ``tests/test_device_profiler.py``
(disabled start, sample fields and aggregates, the ring, idle gaps,
nesting, abort, bind, cache hits), the entry points that open spans
(``GFLinear``, ``crc32c_batch``, ``ScrubEngine``, ``BatchMapper``), and
the batch engine's per-lane samples held against ceph_tpu's engine on
the same ops: the same kernel names, tag keys, lanes, ops, rows and
staged bytes.  The CUDA-event fence itself runs only on the card
(``tests/test_torch_cuda.py``)."""

import time

import numpy as np
import pytest
import torch

from ceph_tpu.compress.chunker import Chunker as JChunker
from ceph_tpu.compress.registry import create_codec as j_codec
from ceph_tpu.core.device_profiler import DeviceProfiler as JProfiler
from ceph_tpu.ec import create_erasure_code as j_create
from ceph_tpu.osd.batch_engine import BatchEngine as JBatchEngine
from ceph_tpu_torch.compress.chunker import Chunker
from ceph_tpu_torch.compress.registry import create_codec
from ceph_tpu_torch.core.device_profiler import (DeviceProfiler,
                                                 default_profiler)
from ceph_tpu_torch.ec import create_erasure_code
from ceph_tpu_torch.ops import rs
from ceph_tpu_torch.ops.gf_torch import GFLinear
from ceph_tpu_torch.osd.batch_engine import BatchEngine
from ceph_tpu_torch.scrub.crc32c import crc32c, crc32c_batch
from ceph_tpu_torch.scrub.engine import ScrubEngine

# the suite shares the CPU with timing-sensitive cluster tests: keep
# torch's intra-op pool from spinning on every core
torch.set_num_threads(1)


def _prof(**kw):
    kw.setdefault("enabled", True)
    return DeviceProfiler(name="test", **kw)


# -- recording semantics ---------------------------------------------------

def test_disabled_start_returns_none():
    p = DeviceProfiler(enabled=False)
    assert p.start("k") is None
    assert len(p) == 0


def test_sample_fields_and_aggregate():
    p = _prof()
    ln = p.start("k", bytes_in=100, rows=8, rows_used=6, tag="v")
    ln.finish(bytes_out=40)
    (s,) = p.samples()
    assert s["kernel"] == "k"
    assert s["bytes_in"] == 100 and s["bytes_out"] == 40
    assert s["rows"] == 8 and s["rows_used"] == 6
    assert s["dispatch_s"] >= 0 and s["total_s"] >= s["dispatch_s"]
    assert s["tags"]["tag"] == "v"
    agg = p.aggregate()
    assert agg["totals"]["launches"] == 1
    assert agg["occupancy_ratio"] == pytest.approx(6 / 8)
    assert 0.0 <= agg["dispatch_overhead_ratio"] <= 1.0
    assert sum(agg["launch_hist_us"]) == 1
    assert set(agg) == set(JProfiler(name="j").aggregate())


def test_rows_used_defaults_to_rows():
    p = _prof()
    p.start("k", rows=4).finish()
    assert p.samples()[0]["rows_used"] == 4
    assert p.aggregate()["occupancy_ratio"] == 1.0


def test_ring_bounded_and_reset():
    p = _prof(ring_size=4)
    for i in range(10):
        p.start(f"k{i}").finish()
    assert len(p) == 4
    assert p.aggregate()["totals"]["launches"] == 10    # aggregates keep all
    p.reset()
    assert len(p) == 0
    assert p.aggregate()["totals"]["launches"] == 0
    assert sum(p.aggregate()["launch_hist_us"]) == 0


def test_idle_gap_series():
    p = _prof()
    p.start("a").finish()
    time.sleep(0.02)
    p.start("b").finish()
    s = p.samples()
    assert s[0]["gap_s"] is None                # nothing before it
    assert s[1]["gap_s"] >= 0.015
    assert p.aggregate()["idle_gap_avg_s"] >= 0.015


def test_nested_start_suppressed():
    p = _prof()
    outer = p.start("outer")
    assert p.start("inner") is None             # outermost wins
    outer.finish()
    assert [s["kernel"] for s in p.samples()] == ["outer"]
    after = p.start("after")                    # flag released
    assert after is not None
    after.finish()


def test_overlap_launches_stay_open_together():
    p = _prof()
    a = p.start("a", overlap=True, lane="write")
    b = p.start("b", overlap=True, lane="comp")
    a.dispatched()
    b.dispatched()
    b.finish()
    a.finish()
    assert [s["kernel"] for s in p.samples()] == ["b", "a"]
    assert set(p.aggregate()["lanes"]) == {"write", "comp"}


def test_abort_releases_nesting_flag():
    p = _prof()
    p.start("doomed").abort()
    assert len(p) == 0
    ln = p.start("next")
    assert ln is not None
    ln.finish()
    assert len(p) == 1


def test_bind_restores_previous():
    a, b = _prof(), _prof()
    with a.bind():
        assert DeviceProfiler.active() is a
        with b.bind():
            assert DeviceProfiler.active() is b
        assert DeviceProfiler.active() is a
    assert DeviceProfiler.active() is default_profiler()


def test_cache_hit_counting():
    p = _prof()
    p.start("k", cache_hit=True).finish()
    p.start("k").finish(cache_hit=True)         # late tag via finish
    p.start("k").finish()
    assert p.aggregate()["kernels"]["k"]["cache_hits"] == 2


def test_finish_on_host_tensors_takes_no_fence():
    p = _prof()
    ln = p.start("k")
    ln.dispatched()
    ln.finish(out=(torch.zeros(3), [torch.ones(2)]), bytes_out=5)
    assert p.samples()[0]["compute_s"] >= 0.0


# -- the entry points ------------------------------------------------------

def test_gf_encode_sample():
    k, m = 4, 2
    gl = GFLinear(rs.reed_sol_van_matrix(k, m), backend="plain",
                  device="cpu")
    data = np.arange(k * 64, dtype=np.uint8).reshape(k, 64)
    p = _prof()
    with p.bind():
        out = gl(data)
    (s,) = [x for x in p.samples() if x["kernel"] == "gf_encode"]
    assert s["bytes_in"] == data.nbytes
    assert s["bytes_out"] == out.numel()
    assert s["rows"] == k
    assert s["dispatch_s"] > 0
    assert s["tags"]["backend"] == "plain"


def test_crc32c_batch_sample_and_cache_hit():
    batch = np.arange(4 * 40, dtype=np.uint8).reshape(4, 40)
    p = _prof()
    with p.bind():
        crc32c_batch(batch, device="cpu")
        crc32c_batch(batch, device="cpu")       # same length: hit
    ss = [s for s in p.samples() if s["kernel"] == "crc32c"]
    assert len(ss) == 2
    assert ss[0]["bytes_in"] == batch.nbytes
    assert ss[1]["tags"]["cache_hit"] is True


def test_crc_digest_suppresses_inner_crc32c():
    eng = ScrubEngine(device_min_rows=1, device_min_bytes=1, device="cpu")
    payloads = {f"o{i}": b"\x5a" * 64 for i in range(6)}
    p = _prof()
    with p.bind():
        digests = eng.compute_digests(payloads)
    assert [s["kernel"] for s in p.samples()] == ["crc_digest"]
    (s,) = p.samples()
    assert s["rows"] == 6 and s["bytes_in"] == 6 * 64
    assert digests["o0"] == crc32c(b"\x5a" * 64)


def test_parity_recheck_suppresses_inner_gf_encode():
    ec = create_erasure_code({"plugin": "jerasure", "k": 3, "m": 2},
                             device="cpu")
    rng = np.random.default_rng(5)
    stripes = {}
    for oid in ("good", "bad"):
        data = rng.integers(0, 256, (3, 32), dtype=np.uint8)
        enc = ec.encode(set(range(5)), data.reshape(-1))
        shards = {i: bytes(enc[i]) for i in range(5)}
        if oid == "bad":
            shards[4] = bytes(32)               # rot a parity shard
        stripes[oid] = shards
    p = _prof()
    with p.bind():
        verdicts = ScrubEngine(device="cpu").recheck_parity(ec, stripes)
    assert verdicts == {"good": False, "bad": True}
    assert [s["kernel"] for s in p.samples()] == ["parity_recheck"]
    assert p.samples()[0]["rows"] == 2


def test_crush_map_sample():
    """ceph_tpu pads a call to its compiled chunk (rows = chunk); the
    port maps the rows it is given, so rows == rows_used."""
    from ceph_tpu_torch.crush.map import build_flat_map
    from ceph_tpu_torch.crush.torch_mapper import BatchMapper
    bm = BatchMapper(build_flat_map(6), 0, result_max=3, chunk=8,
                     device="cpu")
    xs = np.arange(5, dtype=np.uint32)
    p = _prof()
    with p.bind():
        out = bm(xs)
    (s,) = [x for x in p.samples() if x["kernel"] == "crush_map"]
    assert s["rows"] == s["rows_used"] == 5
    assert s["bytes_in"] == xs.nbytes + 4 * 6
    assert s["bytes_out"] == out.nbytes
    assert s["tags"]["cache_hit"] is False


def test_profiling_leaves_encode_bit_identical():
    gl = GFLinear(rs.reed_sol_van_matrix(4, 2), device="cpu")
    data = np.random.default_rng(11).integers(0, 256, (4, 256),
                                              dtype=np.uint8)
    p = _prof(enabled=False)
    with p.bind():
        baseline = gl(data)
    assert len(p) == 0
    p.set_enabled(True)
    with p.bind():
        profiled = gl(data)
    assert len(p) == 1
    assert torch.equal(profiled, baseline)


# -- the batch engine's lanes against ceph_tpu's ---------------------------

def _drive(eng, ec, codec, chunker):
    rng = np.random.default_rng(3)
    obj = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
           for n in (3000, 4096, 900)]
    comps = [eng.submit_encode(ec, o) for o in obj]
    comps.append(eng.submit_digest(obj[0]))
    eng.flush_sync("write")
    shards = [c.result(timeout=30)[0] for c in comps[:3]]
    avail = [{i: np.frombuffer(s[i], np.uint8) for i in s if i not in (1, 5)}
             for s in shards]
    recon = [eng.submit_reconstruct(ec, a, want={1, 5}) for a in avail]
    recon.append(eng.submit_recheck(ec, ec.encode_prepare(obj[1])))
    eng.flush_sync("recon")
    comp = [eng.submit_compress(codec, o) for o in obj]
    comp += [eng.submit_fingerprint(chunker, o) for o in obj]
    eng.flush_sync("comp")
    return [c.result(timeout=30) for c in comps[3:] + recon[:3] + comp]


def _view(prof):
    return [(s["kernel"], s["tags"]["lane"], s["tags"]["op"],
             s["tags"]["members"], s["tags"]["reason"], sorted(s["tags"]),
             s["rows"], s["rows_used"], s["bytes_in"], s["bytes_used"])
            for s in prof.samples()]


def test_engine_samples_match_ceph_tpu_lane_by_lane():
    profile = {"plugin": "jerasure", "technique": "reed_sol_van", "k": 4,
               "m": 2}
    kw = dict(flush_ms=1000.0, max_ops=1000, max_bytes=1 << 30)
    p, jp = _prof(), JProfiler(name="j", enabled=True)
    eng = BatchEngine("t", device="cpu", profiler=p, **kw)
    jeng = JBatchEngine("j", profiler=jp, **kw)
    got = _drive(eng, create_erasure_code(profile, device="cpu"),
                 create_codec("rle"), Chunker(512))
    want = _drive(jeng, j_create(profile), j_codec("rle"), JChunker(512))
    assert got[0] == want[0]
    assert all(np.array_equal(g[c], np.asarray(w[c]))
               for g, w in zip(got[1:4], want[1:4]) for c in (1, 5))
    assert got[4:] == want[4:]
    assert _view(p) == _view(jp)
    assert [s["kernel"] for s in p.samples()] == ["megabatch"] * len(
        p.samples())
    agg, jagg = p.aggregate(), jp.aggregate()
    assert set(agg) == set(jagg)
    assert set(agg["lanes"]) == set(jagg["lanes"]) == {"write", "recon",
                                                       "comp"}
    for lane, a in agg["lanes"].items():
        assert set(a) == set(jagg["lanes"][lane])
        assert a["launches"] == jagg["lanes"][lane]["launches"]
        assert a["bytes_in"] == jagg["lanes"][lane]["bytes_in"]
    for s in p.samples():
        assert s["dispatch_s"] > 0 and s["compute_s"] >= 0
    eng.stop()
    jeng.stop()
