"""The port's WAL framing (``ceph_tpu_torch.os_store.walog``) and its
host CRC-32C (``scrub.crc32c.crc32c_blocks``) against ceph_tpu's.
Records, scans of torn and corrupted tails, and every CRC must be equal
bit for bit."""

import os

import numpy as np
import pytest

from ceph_tpu.os_store import walog as j_walog
from ceph_tpu.scrub.crc32c_jax import crc32c as j_crc32c
from ceph_tpu_torch.os_store import walog as p_walog
from ceph_tpu_torch.scrub.crc32c import crc32c, crc32c_blocks

LENGTHS = [0, 1, 3, 255, 256, 257, 1000, 4095, 4097, 65535, 65536 + 7,
           (1 << 20) - 1, 1 << 20]


def _bytes(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("n", LENGTHS)
def test_crc32c_blocks_equals_crc32c(n):
    buf = _bytes(n + 8, n)
    for off in (0, 1, 3, 5):            # unaligned views
        view = memoryview(buf)[off:off + n]
        want = j_walog.crc32c(bytes(view))
        assert crc32c_blocks(view) == want
        assert crc32c_blocks(np.frombuffer(buf, np.uint8)[off:off + n]) \
            == want
    if n <= 65536:                      # the per-byte walks, where cheap
        assert crc32c(buf[:n]) == j_crc32c(buf[:n]) == crc32c_blocks(buf[:n])


@pytest.mark.parametrize("seed_crc", [1, 0xDEADBEEF, 0xFFFFFFFF])
def test_crc32c_blocks_chains(seed_crc):
    a, b = _bytes(70001, 1), _bytes(300, 2)
    assert crc32c_blocks(b, seed_crc) == crc32c(b, seed_crc)
    assert crc32c_blocks(a + b) == crc32c_blocks(b, crc32c_blocks(a))
    assert crc32c_blocks(a, seed_crc) == j_crc32c(a, seed_crc)


def test_crc32c_blocks_rfc3720():
    assert crc32c_blocks(b"123456789" * 64) == crc32c(b"123456789" * 64)
    assert crc32c_blocks(bytes(32)) == 0x8A9136AA
    assert crc32c_blocks(b"\xff" * 32) == 0x62A8AB43
    assert crc32c_blocks(bytes(range(32))) == 0x46DD794E


@pytest.fixture(params=["fast", "blocks"])
def crc_path(request, monkeypatch):
    """The port's walog with and without ``google_crc32c``."""
    if request.param == "blocks":
        monkeypatch.setattr(p_walog, "_crc32c_fast", None)
    return request.param


def _payloads():
    return [b"", b"x", b"hello" * 100, _bytes(333, 1), _bytes(70000, 2),
            b'[["write","1.0s0","o",0,{"b":"00ff"}]]']


def test_encode_record_equal(crc_path):
    for payload in _payloads():
        assert p_walog.encode_record(payload) == \
            j_walog.encode_record(payload)
        assert p_walog.crc32c(payload) == j_walog.crc32c(payload)
    assert p_walog.HEADER_SIZE == j_walog.HEADER_SIZE
    assert p_walog.MAGIC == j_walog.MAGIC


def _log():
    return b"".join(j_walog.encode_record(p) for p in _payloads())


def test_scan_every_torn_cut_equal(crc_path):
    full = _log()
    last = len(full) - len(j_walog.encode_record(_payloads()[-1]))
    for cut in list(range(last - 3, len(full) + 1)) + [0, 1, 7, 100]:
        assert p_walog.scan_records(full[:cut]) == \
            j_walog.scan_records(full[:cut]), cut


@pytest.mark.parametrize("where", [0, 1, 6, 9, 200, -1])
def test_scan_corruption_equal(crc_path, where):
    buf = bytearray(_log())
    buf[where] ^= 0x41
    p = p_walog.scan_records(bytes(buf))
    assert p == j_walog.scan_records(bytes(buf))
    assert p[2]["status"] in ("corrupt", "torn")


def test_scan_path_and_truncate_equal(tmp_path, crc_path):
    full = _log()
    for mod in (p_walog, j_walog):
        path = str(tmp_path / f"{mod.__name__}.wal")
        assert mod.scan_path(path) == ([], 0, {
            "status": "clean", "error": None, "lost_bytes": 0})
        with open(path, "wb") as f:
            f.write(full + b"\xce\x01\x05")
        recs, good, tail = mod.scan_path(path)
        assert tail["status"] == "torn" and good == len(full)
        mod.truncate_tail(path, good)
        assert os.path.getsize(path) == len(full)
    assert open(str(tmp_path / f"{p_walog.__name__}.wal"), "rb").read() == \
        open(str(tmp_path / f"{j_walog.__name__}.wal"), "rb").read()


def test_crc_path_named():
    assert p_walog.CRC_PATH in ("google_crc32c", "crc32c_blocks")
