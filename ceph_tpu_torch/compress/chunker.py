"""Content-defined chunking and batched fingerprints — port of
``ceph_tpu.compress.chunker`` (the dedup front).

Chunk boundaries fall where the gear hash of the trailing 32-byte window
hits a mask, so identical content yields identical chunks at any byte
offset: ``h_i = sum_{j<32} GEAR[x_{i-j}] << j`` (uint32, wrapping), with
no term for ``i - j < 0`` (``ceph_tpu`` pads the *gear values* with
zeros, so positions 0..30 sum only bytes of the row, and
``GEAR[0] != 0``).  ``_GEAR`` comes from the same generator call as
``ceph_tpu``'s, so both packages cut every payload alike.

:func:`gear_hashes` is K8, the port of ``_gear_kernel``
(``ceph_tpu/compress/chunker.py:47``): on a CUDA tensor it launches
``csrc/gear_hash.cu``, which evaluates the same sum as the recurrence
``h = (h << 1) + GEAR[x]`` (older terms shift out of the 32-bit word);
on a CPU tensor it runs :func:`gear_hashes_plain`, the 32 shifted adds
of ``ceph_tpu``'s kernel on int64 lanes masked to 32 bits (CPU torch has
no uint32 shifts); anything else raises.

Fingerprints are CRC-32C ‖ CRC-32 (zlib) ‖ length, 24 hex characters.
:func:`fingerprints_batch` digests every chunk in one launch of the
port's CRC-32C entry (``scrub.crc32c.crc32c_rows``, K6) over rows
zero-padded at the back to a power of two of at least 32 bytes, and
strips each pad with ``crc32c_zero_unpad`` (all of a launch's digests
at once: ``crc32c_zero_unpad_many``), as ``ceph_tpu`` does.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from ..kernels import build
from ..scrub.crc32c import crc32c, crc32c_rows, crc32c_zero_unpad_many
from ..utils.device import resolve_device

_WINDOW = 32
# deterministic gear table: chunk boundaries must agree across every
# OSD, every process lifetime and both packages, or dedup stops matching
_GEAR = np.random.default_rng(0x43455048).integers(
    0, 1 << 32, size=256, dtype=np.uint32)
_M32 = 0xFFFFFFFF
_VEC = 16           # bytes a lane of the kernel's vector path takes

# K8 _gear_kernel.kern
GEAR_HASH = build.register(
    "gear_hash", "ceph_tpu_torch/csrc/gear_hash.cu",
    "ceph_tpu/compress/chunker.py:47")

# device copies of the gear table, per device
_DEVICE_TABLES: dict = {}


def _next_pow2(n: int) -> int:
    return 1 << max(0, (int(n) - 1).bit_length())


def _u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of uint32 values -> int32 tensor of the same bits."""
    return (x - ((x >> 31) & 1) * (1 << 32)).to(torch.int32)


def gear_hashes_plain(batch: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gear_hashes`: the 32 shifted adds of the
    gathered gear values, zero-padded at the front, on int64 masked to
    32 bits after each shift and add."""
    rows, length = batch.shape
    gear = torch.from_numpy(_GEAR.astype(np.int64)).to(batch.device)
    g = gear[batch.to(torch.int64)]
    padded = torch.nn.functional.pad(g, (_WINDOW - 1, 0))
    acc = torch.zeros_like(g)
    for j in range(_WINDOW):
        acc = (acc + ((padded[:, _WINDOW - 1 - j:
                              _WINDOW - 1 - j + length] << j) & _M32)
               ) & _M32
    return _u32_to_i32(acc)


def gear_hashes(batch: torch.Tensor) -> torch.Tensor:
    """K8: ``[rows, L]`` uint8 → ``[rows, L]`` int32 holding the uint32
    gear hashes, on the tensor's device and un-fenced."""
    if batch.dim() != 2 or batch.dtype != torch.uint8:
        raise ValueError(f"gear_hashes wants [rows, L] uint8, got "
                         f"{batch.dtype} {tuple(batch.shape)}")
    if batch.device.type == "cpu":
        return gear_hashes_plain(batch)
    if not batch.is_cuda:
        raise ValueError(f"gear_hashes: unsupported device {batch.device}")
    rows, length = batch.shape
    out = torch.empty((rows, length), dtype=torch.int32, device=batch.device)
    if rows == 0 or length == 0:
        return out
    batch = batch.contiguous()
    gear = build.device_table(_DEVICE_TABLES, "gear", lambda: _GEAR,
                              batch.device)
    vec = int(length % _VEC == 0 and batch.data_ptr() % _VEC == 0)
    rc = build.library().ctt_gear_hash(
        batch.data_ptr(), out.data_ptr(), gear.data_ptr(), rows, length,
        vec, build.stream_ptr(batch.device))
    build.check(rc, "gear_hash")
    GEAR_HASH.count()
    return out


def gear_hashes_host(row: np.ndarray) -> np.ndarray:
    """Host mirror of the gear hash for one row: the bit-identity
    reference of the unbatched path and the tests."""
    g = _GEAR[row.astype(np.intp)]
    padded = np.pad(g, (_WINDOW - 1, 0))
    acc = np.zeros(len(row), dtype=np.uint32)
    for j in range(_WINDOW):
        acc += padded[_WINDOW - 1 - j:
                      _WINDOW - 1 - j + len(row)] << np.uint32(j)
    return acc


def fingerprint(chunk: bytes) -> str:
    """24 hex chars: crc32c ‖ crc32 ‖ length (host reference)."""
    chunk = bytes(chunk)
    return (f"{crc32c(chunk):08x}"
            f"{zlib.crc32(chunk) & 0xFFFFFFFF:08x}"
            f"{len(chunk):08x}")


def fingerprints_from_padded(crcs, chunks, bucket: int) -> list[str]:
    """:func:`fingerprint` of every chunk from the CRC-32C of the chunk
    zero-padded at the back to ``bucket`` bytes (``crcs``, uint32)."""
    true = crc32c_zero_unpad_many(
        crcs, [bucket - len(c) for c in chunks]).tolist()
    return [f"{crc:08x}{zlib.crc32(c) & 0xFFFFFFFF:08x}{len(c):08x}"
            for crc, c in zip(true, chunks)]


def chunk_bucket(lengths) -> int:
    """Row length of a fingerprint launch: the longest chunk rounded up
    to a power of two, at least 32 bytes."""
    return _next_pow2(max(max(lengths), 32))


class Chunker:
    """CDC parameters and the boundary pass.

    ``avg_size`` is rounded up to a power of two (it becomes the hash
    mask); chunks are clamped to ``[min_size, max_size]`` with a forced
    cut at ``max_size``, the only content-independent boundaries.
    """

    def __init__(self, avg_size: int = 4096, min_size: int | None = None,
                 max_size: int | None = None):
        self.avg = _next_pow2(max(int(avg_size), 64))
        self.min = int(min_size) if min_size else max(self.avg // 4, 64)
        self.max = int(max_size) if max_size else self.avg * 4
        if not self.min <= self.avg <= self.max:
            raise ValueError("need min <= avg <= max chunk size")
        self.mask = np.uint32(self.avg - 1)

    def key(self) -> tuple:
        """Engine group key: one launch shape family per parameter set."""
        return ("cdc", self.avg, self.min, self.max)

    @staticmethod
    def hash_batch(batch: torch.Tensor) -> torch.Tensor:
        """K8 gear hashes of a padded ``[rows, L]`` uint8 megabatch."""
        return gear_hashes(batch)

    def cuts_from_hashes(self, hashes: np.ndarray,
                         length: int) -> list[int]:
        """Exclusive chunk end offsets from a (possibly padded) hash
        row; deterministic given the bytes alone."""
        if length == 0:
            return []
        h = np.asarray(hashes[:length]).view(np.uint32)
        return self.cuts_from_candidates(
            np.flatnonzero((h & self.mask) == 0) + 1, length)

    def cuts_from_candidates(self, cand, length: int) -> list[int]:
        """Exclusive chunk end offsets from the ascending candidate ends
        (``i + 1`` for every ``i < length`` whose hash hits the mask):
        :meth:`cuts_from_hashes` without the hashes."""
        if length == 0:
            return []
        cuts: list[int] = []
        last = 0
        for c in cand:
            c = int(c)
            while c - last > self.max:
                last += self.max
                cuts.append(last)
            if c - last >= self.min and c < length:
                cuts.append(c)
                last = c
        while length - last > self.max:
            last += self.max
            cuts.append(last)
        cuts.append(length)
        return cuts

    def chunks(self, data: bytes) -> list[tuple[int, int]]:
        """(offset, length) spans for ``data``: the host path."""
        row = np.frombuffer(bytes(data), dtype=np.uint8)
        cuts = self.cuts_from_hashes(gear_hashes_host(row), len(row))
        out = []
        last = 0
        for c in cuts:
            out.append((last, c - last))
            last = c
        return out


def gather_chunks(batch: torch.Tensor, rows, offsets, lengths,
                  bucket: int) -> torch.Tensor:
    """``[n, bucket]`` uint8 on ``batch``'s device: row ``i`` is
    ``batch[rows[i], offsets[i]:offsets[i] + lengths[i]]`` zero-padded
    at the back.  One scatter of every chunk byte, with no per-chunk
    launch: byte ``p`` of the chunks laid end to end comes from
    ``p + (src_i - start_i)`` and goes to ``p + (i * bucket - start_i)``,
    ``start_i`` the chunk's offset in that concatenation."""
    dev = batch.device
    lens = torch.as_tensor(np.asarray(lengths, dtype=np.int64))
    n = len(lens)
    out = torch.zeros((n, bucket), dtype=torch.uint8, device=dev)
    if n == 0:
        return out
    start = torch.cumsum(lens, 0) - lens
    src = (torch.as_tensor(np.asarray(rows, dtype=np.int64))
           * batch.shape[1] + torch.as_tensor(np.asarray(offsets,
                                                         dtype=np.int64)))
    dst = torch.arange(n, dtype=torch.int64) * bucket
    lens, start, src, dst = (t.to(dev) for t in (lens, start, src, dst))
    total = int(lens.sum())
    pos = torch.arange(total, dtype=torch.int64, device=dev)
    flat = batch.reshape(-1)
    out.view(-1)[pos + torch.repeat_interleave(dst - start, lens,
                                               output_size=total)] = \
        flat[pos + torch.repeat_interleave(src - start, lens,
                                           output_size=total)]
    return out


def fingerprints_batch(chunks: list[bytes], device=None) -> list[str]:
    """Digest many chunks in one CRC-32C launch on ``device`` (``None``:
    the card): stacked, zero-padded at the back to
    :func:`chunk_bucket`, each pad stripped with the GF(2) unpad
    algebra; equal to the host :func:`fingerprint` per chunk."""
    if not chunks:
        return []
    bucket = chunk_bucket(len(c) for c in chunks)
    batch = np.zeros((len(chunks), bucket), dtype=np.uint8)
    for i, c in enumerate(chunks):
        batch[i, :len(c)] = np.frombuffer(c, dtype=np.uint8)
    dev = resolve_device(device)
    crcs = crc32c_rows(torch.from_numpy(batch).to(dev)).cpu().numpy()
    return fingerprints_from_padded(crcs.view(np.uint32),
                                    [bytes(c) for c in chunks], bucket)
