"""The port's compression lane (``BatchEngine`` ``comp``: ``submit_compress``,
``submit_fingerprint``, ``decompress``) against ceph_tpu's engine on the
same seeded payloads, on the CPU.  Each mode is either immediate
(``flush_ms == 0``, one flush per submit) or batched, where the test
submits everything and completes the lane inline with
``flush_sync("comp")`` (no timer, no completion worker).  Tolerance:
exact blobs, headers, spans, fingerprints and ``comp_*`` stats."""

import numpy as np
import pytest
import torch

from ceph_tpu.compress import codec as JK
from ceph_tpu.compress.chunker import Chunker as JChunker
from ceph_tpu.compress.registry import create_codec as j_codec
from ceph_tpu.osd.batch_engine import BatchEngine as JBatchEngine
from ceph_tpu_torch.compress import codec as PK
from ceph_tpu_torch.compress.chunker import Chunker, fingerprint
from ceph_tpu_torch.compress.registry import create_codec
from ceph_tpu_torch.osd.batch_engine import BatchEngine, _next_pow2

# the suite shares the CPU with timing-sensitive cluster tests: keep
# torch's intra-op pool from spinning on every core
torch.set_num_threads(1)

MODES = [pytest.param(0.0, id="immediate"),
         pytest.param(1000.0, id="flush_sync")]


def _runs(n, seed=0, lo=16, hi=128):
    rng = np.random.default_rng(seed)
    out = []
    while sum(len(r) for r in out) < n:
        out.append(np.full(int(rng.integers(lo, hi)), rng.integers(0, 256),
                           dtype=np.uint8))
    return np.concatenate(out)[:n].tobytes() if n else b""


def _random(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


PAYLOADS = ([_runs(5000, s) for s in range(4)]
            + [_random(3000, 8), b"", _runs(64, 1), b"\x00", _runs(700, 9),
               _random(40, 2)])


def _engines(flush_ms, **kw):
    kw = dict(flush_ms=flush_ms, max_ops=1000, max_bytes=1 << 30, **kw)
    return BatchEngine("t", device="cpu", **kw), JBatchEngine("j", **kw)


def _run(eng, submit):
    comps = submit()
    if eng.flush_ms:
        eng.flush_sync("comp")
    out = [c.result(timeout=30) for c in comps]
    eng.stop()
    return out


def _comp_stats(eng):
    return {k: v for k, v in eng.stats.items() if k.startswith("comp_")}


@pytest.mark.parametrize("flush_ms", MODES)
@pytest.mark.parametrize("name", ["rle", "zlib", "none"])
@pytest.mark.parametrize("mode", ["aggressive", "force"])
def test_compress_matches_jax(flush_ms, name, mode):
    eng, jeng = _engines(flush_ms)
    got = _run(eng, lambda: [
        eng.submit_compress(create_codec(name), p, mode=mode)
        for p in PAYLOADS])
    want = _run(jeng, lambda: [
        jeng.submit_compress(j_codec(name), p, mode=mode)
        for p in PAYLOADS])
    assert got == want
    assert _comp_stats(eng) == _comp_stats(jeng)
    for (blob, hdr), p in zip(got, PAYLOADS):
        if hdr is None:
            assert mode != "force" and blob == p
        else:
            assert eng.decompress(blob, hdr) == p
    if flush_ms:                        # one launch per size bucket
        assert eng.stats["comp_launches"] == len(
            {_next_pow2(max(len(p), 32)) for p in PAYLOADS if p})


@pytest.mark.parametrize("flush_ms", MODES)
def test_segmented_compress_matches_jax(flush_ms):
    eng, jeng = _engines(flush_ms, comp_segment_bytes=2048)
    payloads = [_runs(10000, 3) + _random(2048, 5) + _runs(4000, 2),
                _random(9000, 7), _runs(2049, 4), _runs(2048, 6)]
    got = _run(eng, lambda: [eng.submit_compress(create_codec("rle"), p)
                             for p in payloads])
    want = _run(jeng, lambda: [jeng.submit_compress(j_codec("rle"), p)
                               for p in payloads])
    assert got == want
    assert _comp_stats(eng) == _comp_stats(jeng)
    blob, hdr = got[0]
    assert hdr["seg"] == 2048 and len(hdr["segs"]) == 8
    assert [raw for _c, raw in hdr["segs"]].count(1) == 1
    assert eng.decompress(blob, hdr) == payloads[0]
    assert got[1] == (payloads[1], None)        # passes through whole
    assert eng.decompress(*got[2]) == payloads[2]


def test_decompress_reads_either_packages_blobs():
    eng, jeng = _engines(0.0, comp_segment_bytes=4096)
    data = _runs(10000, 11)
    for name in ("rle", "zlib"):
        pblob, phdr = eng.submit_compress(create_codec(name), data).result()
        jblob, jhdr = jeng.submit_compress(j_codec(name), data).result()
        assert (pblob, phdr) == (jblob, jhdr)
        assert eng.decompress(jblob, jhdr) == data
        assert jeng.decompress(pblob, phdr) == data
    assert eng.stats["comp_decompress_bytes"] == 2 * len(data)
    with pytest.raises(PK.CodecError):
        eng.decompress(pblob, dict(phdr, len=len(data) + 1))


@pytest.mark.parametrize("flush_ms", MODES)
@pytest.mark.parametrize("avg", [256, 1024])
def test_fingerprint_matches_jax(flush_ms, avg):
    payloads = [_runs(20000, 3), _random(12000, 5), _random(37, 2), b"",
                _random(12000, 5), _runs(3000, 8)]
    eng, jeng = _engines(flush_ms)
    got = _run(eng, lambda: [eng.submit_fingerprint(Chunker(avg), p)
                             for p in payloads])
    want = _run(jeng, lambda: [jeng.submit_fingerprint(JChunker(avg), p)
                               for p in payloads])
    assert got == want
    assert got[1] == got[4]             # duplicate content, same chunks
    assert got[3] == []
    for spans, p in zip(got, payloads):
        assert [(o, n) for o, n, _f in spans] == Chunker(avg).chunks(p)
        assert all(fingerprint(p[o:o + n]) == fp for o, n, fp in spans)
    assert _comp_stats(eng) == _comp_stats(jeng)
    if flush_ms:
        assert eng.stats["comp_launches"] == len(
            {_next_pow2(max(len(p), 32)) for p in payloads if p})


def test_lane_off_matches_lane_on():
    on = BatchEngine("on", device="cpu", flush_ms=1000.0, max_ops=1000)
    off = BatchEngine("off", device="cpu", enabled=False)
    ch = Chunker(512)
    comps = [on.submit_compress(create_codec("rle"), p) for p in PAYLOADS]
    fps = [on.submit_fingerprint(ch, p) for p in PAYLOADS]
    on.flush_sync("comp")
    for c, f, p in zip(comps, fps, PAYLOADS):
        assert c.result() == off.submit_compress(create_codec("rle"),
                                                 p).result()
        assert f.result() == off.submit_fingerprint(ch, p).result()
    assert off.stats.get("comp_launches", 0) == 0


class _Poisoned(PK.RleCodec):
    def compress_from_scan(self, row, length, scan_row):
        if length == 777:
            raise ValueError("poisoned member")
        return super().compress_from_scan(row, length, scan_row)


class _JPoisoned(JK.RleCodec):
    def compress_from_scan(self, row, length, scan_row):
        if length == 777:
            raise ValueError("poisoned member")
        return super().compress_from_scan(row, length, scan_row)


def test_poisoned_member_fails_alone():
    payloads = [_runs(1000, 1), _runs(777, 2), _runs(900, 3)]
    results = []
    for eng, codec in ((BatchEngine("t", device="cpu", flush_ms=1000.0,
                                    max_ops=1000), _Poisoned()),
                       (JBatchEngine("j", flush_ms=1000.0, max_ops=1000),
                        _JPoisoned())):
        comps = [eng.submit_compress(codec, p) for p in payloads]
        eng.flush_sync("comp")
        assert isinstance(comps[1].error, ValueError)
        results.append([comps[0].result(), comps[2].result(),
                        _comp_stats(eng)])
        assert eng.stats["comp_ops_failed"] == 1
        assert eng.stats["comp_ops_completed"] == 2
    assert results[0] == results[1]


def test_launch_failure_fails_the_group(monkeypatch):
    def boom(batch):
        raise RuntimeError("scan died")
    monkeypatch.setattr(PK.RleCodec, "scan_batch", property(lambda s: boom))
    eng = BatchEngine("t", device="cpu", flush_ms=1000.0, max_ops=1000)
    comps = [eng.submit_compress(create_codec("rle"), _runs(500, s))
             for s in range(3)]
    fp = eng.submit_fingerprint(Chunker(256), _runs(500, 9))
    eng.flush_sync("comp")
    assert all(isinstance(c.error, RuntimeError) for c in comps)
    assert fp.result()[0][0] == 0       # the other group still completes
    assert eng.stats["comp_ops_failed"] == 3
    assert eng.stats["comp_launches"] == 1
