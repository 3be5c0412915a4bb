"""Device-batched compression codecs — port of ``ceph_tpu.compress.codec``.

The codec family, its host semantics and the blob formats
(``_MODE_RLE8``, ``_MODE_RLE4``) are copies of ``ceph_tpu``'s, byte for
byte, so that a blob sealed by either package expands in the other.

``rle`` is run-length coding with an entropy second stage: a device scan
marks run starts over a whole size-bucketed ``[rows, length]`` uint8
megabatch (:func:`run_starts`, K9), the host compacts them into
``(count, byte)`` pairs with numpy, and when the run alphabet fits in 16
symbols the pairs are re-coded as a nibble-packed dictionary stream.
Decompression is a single ``np.repeat`` and stays on the host.

:func:`run_starts` is the port of ``_boundary_kernel``
(``ceph_tpu/compress/codec.py:88``): on a CUDA tensor it launches
``csrc/run_starts.cu``, on a CPU tensor it runs :func:`run_starts_plain`,
and it raises for anything else.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from ..kernels import build


class CodecError(Exception):
    pass


_MODE_RLE8 = 1      # (count u8, byte u8) pairs
_MODE_RLE4 = 2      # nibble-packed dictionary symbols + count stream

# K9 _boundary_kernel.kern
RUN_STARTS = build.register(
    "run_starts", "ceph_tpu_torch/csrc/run_starts.cu",
    "ceph_tpu/compress/codec.py:88")

_VEC = 16           # bytes a thread of the kernel's vector path takes


class Codec:
    """One compression algorithm (reference ``Compressor``).

    ``compress``/``decompress`` are the host semantics; codecs that can
    batch expose ``scan_batch`` (a device pass over a padded
    ``[rows, length]`` uint8 tensor) and ``compress_from_scan`` to
    finalize one member from the scan output, bit-identical to
    ``compress``.
    """

    name = "?"

    def compress(self, data: bytes) -> bytes:
        raise NotImplementedError

    def decompress(self, blob: bytes, out_len: int) -> bytes:
        raise NotImplementedError

    # device-batched entry points (None: a host-only codec, whose lane
    # members finalize on the host)
    scan_batch = None

    def compress_from_scan(self, row: np.ndarray, length: int,
                           scan_row: np.ndarray) -> bytes:
        raise NotImplementedError


class PassthroughCodec(Codec):
    """``none``: stores bytes verbatim."""

    name = "none"

    def compress(self, data: bytes) -> bytes:
        return bytes(data)

    def decompress(self, blob: bytes, out_len: int) -> bytes:
        if len(blob) != out_len:
            raise CodecError(f"passthrough length {len(blob)} != "
                             f"{out_len}")
        return bytes(blob)


def run_starts_plain(batch: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`run_starts`: ``cur != prev`` on int16,
    with ``prev = -1`` before column 0."""
    cur = batch.to(torch.int16)
    prev = torch.cat([torch.full((batch.shape[0], 1), -1, dtype=torch.int16,
                                 device=batch.device), cur[:, :-1]], dim=1)
    return cur != prev


def run_starts(batch: torch.Tensor) -> torch.Tensor:
    """K9: ``[rows, L]`` uint8 → ``[rows, L]`` bool run-start mask
    (``x[i] != x[i-1]``, column 0 always true), on the tensor's device
    and un-fenced."""
    if batch.dim() != 2 or batch.dtype != torch.uint8:
        raise ValueError(f"run_starts wants [rows, L] uint8, got "
                         f"{batch.dtype} {tuple(batch.shape)}")
    if batch.device.type == "cpu":
        return run_starts_plain(batch)
    if not batch.is_cuda:
        raise ValueError(f"run_starts: unsupported device {batch.device}")
    rows, length = batch.shape
    out = torch.empty((rows, length), dtype=torch.bool, device=batch.device)
    if rows == 0 or length == 0:
        return out
    batch = batch.contiguous()
    vec = int(length % _VEC == 0 and batch.data_ptr() % _VEC == 0)
    rc = build.library().ctt_run_starts(
        batch.data_ptr(), out.data_ptr(), rows, length, vec,
        build.stream_ptr(batch.device))
    build.check(rc, "run_starts")
    RUN_STARTS.count()
    return out


def _run_starts_host(row: np.ndarray) -> np.ndarray:
    """Host mirror of :func:`run_starts` for one row: the bit-identity
    reference of the unbatched path."""
    mask = np.empty(len(row), dtype=bool)
    if len(row):
        mask[0] = True
        np.not_equal(row[1:], row[:-1], out=mask[1:])
    return mask


class RleCodec(Codec):
    """RLE + nibble-dictionary entropy hybrid (the ``rle`` builtin)."""

    name = "rle"

    @property
    def scan_batch(self):
        return run_starts

    def compress(self, data: bytes) -> bytes:
        row = np.frombuffer(bytes(data), dtype=np.uint8)
        return self.compress_from_scan(row, len(row),
                                       _run_starts_host(row))

    def compress_from_scan(self, row: np.ndarray, length: int,
                           scan_row: np.ndarray) -> bytes:
        if length == 0:
            return bytes([_MODE_RLE8])
        starts = np.flatnonzero(np.asarray(scan_row[:length]))
        lens = np.diff(np.append(starts, length))
        syms = row[starts]
        # runs longer than 255 split into u8-countable pieces; the
        # count stream stays fixed-width so decode is one reshape
        pieces = (lens + 254) // 255
        total = int(pieces.sum())
        out_syms = np.repeat(syms, pieces)
        counts = np.full(total, 255, dtype=np.int64)
        counts[np.cumsum(pieces) - 1] = lens - (pieces - 1) * 255
        counts = counts.astype(np.uint8)
        pairs = np.empty((total, 2), dtype=np.uint8)
        pairs[:, 0] = counts
        pairs[:, 1] = out_syms
        rle8 = bytes([_MODE_RLE8]) + pairs.tobytes()
        alphabet = np.unique(out_syms)
        if len(alphabet) > 16:
            return rle8
        # entropy stage: symbols become 4-bit dictionary indices
        idx = np.searchsorted(alphabet, out_syms).astype(np.uint8)
        if total % 2:
            idx = np.append(idx, np.uint8(0))
        packed = (idx[0::2] << 4) | idx[1::2]
        rle4 = (bytes([_MODE_RLE4, len(alphabet)]) + alphabet.tobytes()
                + struct.pack("<I", total) + packed.tobytes()
                + counts.tobytes())
        return rle4 if len(rle4) < len(rle8) else rle8

    def decompress(self, blob: bytes, out_len: int) -> bytes:
        if not blob:
            raise CodecError("empty rle blob")
        mode = blob[0]
        if mode == _MODE_RLE8:
            pairs = np.frombuffer(blob, dtype=np.uint8, offset=1)
            if len(pairs) % 2:
                raise CodecError("truncated rle8 stream")
            pairs = pairs.reshape(-1, 2)
            out = np.repeat(pairs[:, 1], pairs[:, 0])
        elif mode == _MODE_RLE4:
            nsym = blob[1]
            alphabet = np.frombuffer(blob, np.uint8, nsym, offset=2)
            (total,) = struct.unpack_from("<I", blob, 2 + nsym)
            off = 6 + nsym
            npack = (total + 1) // 2
            packed = np.frombuffer(blob, np.uint8, npack, offset=off)
            counts = np.frombuffer(blob, np.uint8, total,
                                   offset=off + npack)
            idx = np.empty(npack * 2, dtype=np.uint8)
            idx[0::2] = packed >> 4
            idx[1::2] = packed & 0x0F
            out = np.repeat(alphabet[idx[:total]], counts)
        else:
            raise CodecError(f"unknown rle mode {mode}")
        if len(out) != out_len:
            raise CodecError(
                f"rle expanded to {len(out)} bytes, expected {out_len}")
        return out.tobytes()


class ZlibCodec(Codec):
    """Host codec (the upstream default compressor); no device scan,
    so the lane batches its accounting only."""

    name = "zlib"

    def compress(self, data: bytes) -> bytes:
        return zlib.compress(bytes(data), 6)

    def decompress(self, blob: bytes, out_len: int) -> bytes:
        out = zlib.decompress(bytes(blob))
        if len(out) != out_len:
            raise CodecError(
                f"zlib expanded to {len(out)} bytes, expected {out_len}")
        return out
