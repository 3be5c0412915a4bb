"""walog — CRC-framed write-ahead-log records + torn-tail recovery.

The port's copy of ``ceph_tpu.os_store.walog``.

The one record format every durable log in the tree shares
(``os_store/kvstore.py::WALStore`` and ``mon/store.py::
MonitorDBStore``), production-shaped the way the reference's journals
are (BlueFS/RocksDB log blocks carry a length + CRC32C header;
``src/os/bluestore/bluefs_types.h``): each record is

    ``MAGIC(2) | payload_len(u32 LE) | crc32c(payload)(u32 LE) | payload``

and recovery applies the RocksDB ``kTolerateCorruptedTailRecords``
rule: scan forward, stop at the first frame that is short, mis-magic'd
or CRC-mismatched — everything before it is good, everything from it
on is the torn/corrupt tail a power loss left behind.  The scanner
only *reports* the tail; truncating it is the mounting store's call
(and ``objectstore_tool fsck --truncate-tail`` the operator's).

CRC is the same Castagnoli CRC-32C the scrub kernels compute, so a
WAL record digest and an object-payload digest are bit-compatible.
The hot append/scan path uses the C implementation (``google_crc32c``)
when it imports; otherwise ``scrub.crc32c.crc32c_blocks``, the numpy
block-parallel table walk (a few hundred MiB/s on one host core, where
the per-byte walk of ``scrub.crc32c.crc32c`` manages a few).  All three
are bit-identical (RFC 3720 golden-vector exact).  ``CRC_PATH`` names
the one in use.
"""

from __future__ import annotations

import os
import struct

from ..scrub.crc32c import crc32c_blocks

try:
    from google_crc32c import value as _crc32c_fast
except ImportError:                                 # pragma: no cover
    _crc32c_fast = None

CRC_PATH = "google_crc32c" if _crc32c_fast is not None else "crc32c_blocks"


def crc32c(data: bytes, crc: int = 0) -> int:
    if _crc32c_fast is not None and crc == 0:
        return _crc32c_fast(bytes(data))
    return crc32c_blocks(data, crc)

MAGIC = b"\xce\x01"                 # 0xCE: "ceph", version 1 framing
_HEADER = struct.Struct("<2sII")    # magic, payload_len, crc32c
HEADER_SIZE = _HEADER.size


def encode_record(payload: bytes) -> bytes:
    """One framed WAL record for ``payload``."""
    payload = bytes(payload)
    return _HEADER.pack(MAGIC, len(payload), crc32c(payload)) + payload


def scan_records(buf: bytes) -> tuple[list[bytes], int, dict]:
    """Recover ``buf`` → ``(payloads, good_off, tail)``.

    ``good_off`` is the offset of the first unparseable byte (== file
    size on a clean log); ``tail`` describes what stopped the scan:
    ``{"status": "clean"|"torn"|"corrupt", "error", "lost_bytes"}`` —
    "torn" is a record cut short (the classic power-loss mid-write),
    "corrupt" is framing/CRC damage.
    """
    out: list[bytes] = []
    off, n = 0, len(buf)
    status, error = "clean", None
    while off < n:
        if off + HEADER_SIZE > n:
            status, error = "torn", f"short header at offset {off}"
            break
        magic, ln, crc = _HEADER.unpack_from(buf, off)
        if magic != MAGIC:
            status, error = "corrupt", f"bad magic at offset {off}"
            break
        end = off + HEADER_SIZE + ln
        if end > n:
            status, error = "torn", (
                f"record at offset {off} cut short "
                f"({end - n} of {ln} payload bytes missing)")
            break
        payload = bytes(buf[off + HEADER_SIZE:end])
        if crc32c(payload) != crc:
            status, error = "corrupt", f"crc mismatch at offset {off}"
            break
        out.append(payload)
        off = end
    return out, off, {"status": status, "error": error,
                      "lost_bytes": n - off}


def scan_path(path: str) -> tuple[list[bytes], int, dict]:
    """``scan_records`` over a file (absent file == empty clean log)."""
    try:
        with open(path, "rb") as f:
            buf = f.read()
    except FileNotFoundError:
        return [], 0, {"status": "clean", "error": None,
                       "lost_bytes": 0}
    return scan_records(buf)


def truncate_tail(path: str, good_off: int) -> None:
    """Discard a torn/corrupt tail: truncate to the last good record
    and make the repair itself durable."""
    with open(path, "r+b") as f:
        f.truncate(good_off)
        f.flush()
        os.fsync(f.fileno())
    fsync_dir(path)


def fsync_dir(path: str) -> None:
    """fsync the parent directory of ``path`` — a create/rename/unlink
    is only durable once the directory entry is (the reference fsyncs
    BlueFS dirs the same way).  Best-effort: platforms that refuse
    directory fds lose nothing they ever had."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
