"""The port's deep-scrub engine (``ceph_tpu_torch.scrub.engine``) against
ceph_tpu's: the same digests in every mode (segmented or not), the same
parity rechecks, standalone and through the batch engine's
``flush_sync``, and the same culprits.  Tolerance: exact."""

import numpy as np
import pytest
import torch

from ceph_tpu.ec import create_erasure_code as j_create
from ceph_tpu.osd.batch_engine import BatchEngine as JBatchEngine
from ceph_tpu.scrub import engine as J
from ceph_tpu_torch.ec import create_erasure_code
from ceph_tpu_torch.osd.batch_engine import BatchEngine
from ceph_tpu_torch.scrub import engine as S
from ceph_tpu_torch.scrub.crc32c import crc32c

# the suite shares the CPU with timing-sensitive cluster tests: keep
# torch's intra-op pool from spinning on every core
torch.set_num_threads(1)


def _payloads(seed=1):
    rng = np.random.default_rng(seed)
    out = {f"o{i}": rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
           for i, n in enumerate([512, 512, 512, 512, 100, 0, 3500, 2048,
                                  2048, 7])}
    out[("tuple", 1)] = rng.integers(0, 256, size=3500,
                                     dtype=np.uint8).tobytes()
    return out


@pytest.mark.parametrize("mode", ["auto", "always", "never"])
@pytest.mark.parametrize("segment", [1 << 20, 1000])
def test_digests_match_jax(mode, segment, monkeypatch):
    monkeypatch.setenv("CEPH_TPU_SCRUB_DEVICE", mode)
    payloads = _payloads()
    eng = S.ScrubEngine(device_min_rows=3, device_min_bytes=4096,
                        segment_bytes=segment, mode=mode, device="cpu")
    jeng = J.ScrubEngine(device_min_rows=3, device_min_bytes=4096,
                         segment_bytes=segment)
    got, want = eng.compute_digests(payloads), jeng.compute_digests(payloads)
    assert got == want
    assert got == {key: crc32c(b) for key, b in payloads.items()}
    for name in ("objects_scanned", "segmented_objects", "digest_bytes",
                 "device_digest_bytes"):
        assert getattr(eng, name) == getattr(jeng, name), name
    if mode == "never":
        assert eng.device_digest_bytes == 0
    with pytest.raises(ValueError, match="mode"):
        S.ScrubEngine(mode="sometimes", device="cpu")


def _stripes(ec, n=5, chunk=256, seed=3):
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n):
        data = rng.integers(0, 256, size=(ec.k, chunk), dtype=np.uint8)
        parity = ec.engine.encode(data)
        out[f"obj{i}"] = {s: (data[s] if s < ec.k else parity[s - ec.k]
                              ).tobytes() for s in range(ec.k + ec.m)}
    return out


def _corrupt(stripes, oid, shard):
    buf = bytearray(stripes[oid][shard])
    buf[17] ^= 0x41
    stripes[oid][shard] = bytes(buf)


PROF = {"plugin": "jerasure", "technique": "reed_sol_van", "k": 4, "m": 2}


@pytest.mark.parametrize("lane", [None, "flush_sync"])
def test_recheck_matches_jax(lane):
    ec, jec = create_erasure_code(PROF, device="cpu"), j_create(PROF)
    stripes = _stripes(ec)
    _corrupt(stripes, "obj1", 2)
    _corrupt(stripes, "obj3", 5)
    eng, jeng = S.ScrubEngine(device="cpu"), J.ScrubEngine()
    batch = jbatch = None
    if lane:
        # a long window: only flush_sync can complete the rechecks
        batch = BatchEngine("scrub", device="cpu", flush_ms=60000.0,
                            max_ops=1000, max_bytes=1 << 30)
        jbatch = JBatchEngine("scrub", flush_ms=60000.0, max_ops=1000,
                              max_bytes=1 << 30)
    got = eng.recheck_parity(ec, stripes, batch=batch)
    want = jeng.recheck_parity(jec, stripes, batch=jbatch)
    assert got == want
    assert {o for o, bad in got.items() if bad} == {"obj1", "obj3"}
    assert eng.parity_bytes == jeng.parity_bytes
    if lane:
        assert batch.stats["recon_flush_scrub"] == 1
        batch.stop()
        jbatch.stop()


@pytest.mark.parametrize("prof", [
    {"plugin": "lrc", "k": 4, "m": 2, "l": 3},
    {"plugin": "clay", "k": 4, "m": 2, "d": 5},
    {"plugin": "jerasure", "technique": "blaum_roth", "k": 4, "m": 2}])
def test_recheck_other_plugins_match_jax(prof):
    """Plugins without a matrix engine re-encode stripe by stripe; the
    bitmatrix engine takes the whole batch."""
    ec, jec = create_erasure_code(prof, device="cpu"), j_create(prof)
    rng = np.random.default_rng(11)
    stripes = {}
    for o in range(6):
        data = rng.integers(0, 256, size=(ec.k, 64), dtype=np.uint8)
        par = ec._encode_chunks(data)
        stripes[o] = {i: (data[i] if i < ec.k else par[i - ec.k]).tobytes()
                      for i in range(ec.k + ec.m)}
    _corrupt(stripes, 4, ec.k)
    got = S.ScrubEngine(device="cpu").recheck_parity(ec, stripes)
    assert got == J.ScrubEngine().recheck_parity(jec, stripes)
    assert [o for o, bad in got.items() if bad] == [4]


def test_flush_sync_completes_on_the_callers_thread():
    ec = create_erasure_code(PROF, device="cpu")
    eng = BatchEngine("t", device="cpu", flush_ms=60000.0, max_ops=1000,
                      max_bytes=1 << 30,
                      schedule=lambda delay, fn: None)
    data = np.random.default_rng(8).integers(0, 256, size=(4, 96),
                                             dtype=np.uint8)
    comps = [eng.submit_recheck(ec, data) for _ in range(3)]
    assert not any(c.done() for c in comps)
    assert eng.flush_sync("recon", reason="scrub") == 1
    assert all(c.done() for c in comps)
    assert eng._worker is None          # nothing went to the worker
    for c in comps:
        assert np.array_equal(c.result(), ec.engine.encode(data))
    assert eng.flush_sync("recon") == 0
    eng.stop()


def test_recheck_lane_failure_raises():
    """A failed recheck op is not redone elsewhere: the error surfaces."""
    ec = create_erasure_code(PROF, device="cpu")
    stripes = _stripes(ec, n=2)
    batch = BatchEngine("t", device="cpu", flush_ms=0.0)

    def boom(*a, **k):
        raise RuntimeError("lane down")
    batch._launch_recheck = boom
    with pytest.raises(RuntimeError, match="lane down"):
        S.ScrubEngine(device="cpu").recheck_parity(ec, stripes, batch=batch)


@pytest.mark.parametrize("prof,bad", [
    (PROF, (2,)),
    (PROF, (5,)),
    ({"plugin": "jerasure", "technique": "reed_sol_van", "k": 4, "m": 1},
     (1,)),
    ({"plugin": "jerasure", "technique": "reed_sol_van", "k": 4, "m": 3},
     (0, 5)),
    ({"plugin": "jerasure", "technique": "reed_sol_van", "k": 8, "m": 3},
     (1, 9)),
    ({"plugin": "shec", "k": 4, "m": 3, "c": 2}, (1,)),
])
def test_culprits_match_jax(prof, bad):
    ec, jec = create_erasure_code(prof, device="cpu"), j_create(prof)
    stripes = _stripes(ec, n=1, chunk=64)
    for shard in bad:
        _corrupt(stripes, "obj0", shard)
    shards = stripes["obj0"]
    one, jone = S.isolate_culprit(ec, shards), J.isolate_culprit(jec, shards)
    many = S.isolate_culprits(ec, shards)
    assert one == jone and many == J.isolate_culprits(jec, shards)
    if ec.m == 1:
        assert one is None and many == ()
    elif len(bad) == 1:
        assert one == bad[0] and many == bad
    elif ec.k == 8:
        assert one is None and many == bad


def test_inconsistent_entry_and_default_engine(monkeypatch):
    shards = {(2, 1): {"size": 10, "errors": ["data_digest_mismatch"]},
              (0, 0): {"size": 10, "digest": 5, "errors": []}}
    assert S.inconsistent_entry("o", ["b", "a"], shards) \
        == J.inconsistent_entry("o", ["b", "a"], shards)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(S, "_DEFAULT", None)
    with pytest.raises(RuntimeError, match="CUDA"):
        S.default_engine()
