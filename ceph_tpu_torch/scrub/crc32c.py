"""CRC-32C (Castagnoli) as GF(2) linear algebra — host scalar + CUDA batch.

The host algebra (:func:`crc32c`, :func:`crc32c_combine`,
:func:`crc32c_shift` / :func:`crc32c_unshift`, :func:`crc32c_zero_unpad`,
:func:`_contrib`) is a copy of ``ceph_tpu.scrub.crc32c_jax``'s: polynomial
``0x1EDC6F41``, reflected register, init and final xor ``0xFFFFFFFF``
(RFC 3720).  :func:`crc32c_batch` is the port of its device batch: on a
CUDA tensor it launches the ``crc32c_batch`` kernel
(``csrc/crc32c_batch.cu``), on a CPU tensor it runs the plain version,
the contribution matmul ``crc_out = A^L·crc_in ⊕ (A^L·F ⊕ F) ⊕
K·bits(data)`` done in L-chunks, each reduced mod 2 and XORed, so the
float products stay exact.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core.device_profiler import DeviceProfiler
from ..kernels import build
from ..utils.device import resolve_device

CRC32C_POLY = 0x1EDC6F41        # Castagnoli, normal form
_POLY = 0x82F63B78              # reflected (LSB-first register)
_MASK = 0xFFFFFFFF


# ---------------------------------------------------------------- tables

def _make_table() -> list[int]:
    tab = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        tab.append(c)
    return tab


_TABLE = _make_table()

# slice-by-8: T8[0] consumes the most-significant of 8 bytes in flight
_T8: list[list[int]] = [_TABLE]
for _k in range(1, 8):
    _prev = _T8[-1]
    _T8.append([(_prev[i] >> 8) ^ _TABLE[_prev[i] & 0xFF]
                for i in range(256)])
_T8.reverse()   # _T8[j] shifts its byte past 7-j later bytes


def _as_bytes(data) -> bytes:
    if isinstance(data, (bytes, bytearray)):
        return bytes(data)
    if isinstance(data, memoryview):
        return data.tobytes()
    arr = np.asarray(data)
    if arr.dtype != np.uint8:
        raise TypeError(f"crc32c wants bytes/uint8, got {arr.dtype}")
    return arr.tobytes()


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C of `data`, chaining from `crc` (``crc32c(b"") == 0``;
    ``crc32c(b, crc32c(a)) == crc32c(a + b)``)."""
    b = _as_bytes(data)
    c = (int(crc) ^ _MASK) & _MASK
    n8 = len(b) & ~7
    t0, t1, t2, t3, t4, t5, t6, t7 = _T8
    for off in range(0, n8, 8):
        lo = c ^ int.from_bytes(b[off:off + 4], "little")
        hi = int.from_bytes(b[off + 4:off + 8], "little")
        c = (t0[lo & 0xFF] ^ t1[(lo >> 8) & 0xFF]
             ^ t2[(lo >> 16) & 0xFF] ^ t3[lo >> 24]
             ^ t4[hi & 0xFF] ^ t5[(hi >> 8) & 0xFF]
             ^ t6[(hi >> 16) & 0xFF] ^ t7[hi >> 24])
    for byte in b[n8:]:
        c = (c >> 8) ^ _TABLE[(c ^ byte) & 0xFF]
    return (c ^ _MASK) & _MASK


# ------------------------------------------------- GF(2) matrix algebra
#
# A 32x32 GF(2) matrix is a list of 32 uint32 columns: col[i] = M·e_i.

def _matrix_times(mat: list[int], vec: int) -> int:
    out = 0
    i = 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _matrix_square(mat: list[int]) -> list[int]:
    return [_matrix_times(mat, col) for col in mat]


def _shift_byte_matrix() -> list[int]:
    """A: the raw-register operator for one zero *byte*:
    ``A(r) = (r >> 8) ^ T[r & 0xFF]``."""
    return [((1 << i) >> 8) ^ _TABLE[(1 << i) & 0xFF] for i in range(32)]


_A_COLS = _shift_byte_matrix()


@functools.lru_cache(maxsize=None)
def _power_cols(inverse: bool, bit: int) -> tuple:
    """``A^(2^bit)``, or its inverse, as 32 columns: the squarings of
    square-and-multiply, made once per process."""
    if bit == 0:
        return tuple(_a_inv_cols() if inverse else _A_COLS)
    return tuple(_matrix_square(list(_power_cols(inverse, bit - 1))))


def _apply_power(c: int, n: int, inverse: bool) -> int:
    """``A^n`` (or ``A^-n``) times ``c``: one matrix-vector product per
    set bit of ``n`` over the cached squarings."""
    if n < 0:
        raise ValueError("negative length")
    bit = 0
    while n:
        if n & 1:
            c = _matrix_times(_power_cols(inverse, bit), c)
        n >>= 1
        bit += 1
    return c


def crc32c_shift(crc: int, nbytes: int) -> int:
    """Apply ``A^nbytes`` (append `nbytes` zero bytes to the *raw*
    register) to a 32-bit value, by square-and-multiply."""
    return _apply_power(int(crc) & _MASK, int(nbytes), False)


def crc32c_combine(crc_a: int, crc_b: int, len_b: int) -> int:
    """``crc32c(A || B)`` from ``crc32c(A)``, ``crc32c(B)``, ``len(B)``.

    Follows from linearity: conditioning cancels, leaving
    ``crc(A||B) = A^len_b · crc(A) ⊕ crc(B)``.
    """
    if len_b == 0:
        return int(crc_a) & _MASK
    return crc32c_shift(crc_a, len_b) ^ (int(crc_b) & _MASK)


def _matrix_inverse(cols: list[int]) -> list[int]:
    """Invert a 32x32 GF(2) matrix (column-of-uint32 form) by
    Gauss-Jordan elimination.  A is invertible because the CRC
    polynomial has a nonzero constant term (x^0), so the byte-shift
    operator is a bijection on register states."""
    n = len(cols)
    dense = _dense(cols, n).astype(np.uint8)
    aug = np.concatenate([dense, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        piv = col + int(np.argmax(aug[col:, col]))
        if aug[piv, col] == 0:
            raise ValueError("singular GF(2) matrix")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        for row in np.nonzero(aug[:, col])[0]:
            if row != col:
                aug[row] ^= aug[col]
    inv = aug[:, n:]
    return [int(sum(int(inv[r, i]) << r for r in range(n)))
            for i in range(n)]


@functools.lru_cache(maxsize=1)
def _a_inv_cols() -> list[int]:
    return _matrix_inverse(_A_COLS)


def crc32c_unshift(crc: int, nbytes: int) -> int:
    """Inverse of :func:`crc32c_shift`: apply ``A^-nbytes`` (remove
    `nbytes` trailing zero bytes from the *raw* register), by
    square-and-multiply over the inverted shift matrix."""
    return _apply_power(int(crc) & _MASK, int(nbytes), True)


@functools.lru_cache(maxsize=None)
def crc32c_zeros(nbytes: int) -> int:
    """``crc32c(b"\\x00" * nbytes)`` without touching the bytes:
    conditioning in, ``A^n``, conditioning out."""
    if nbytes == 0:
        return 0
    return (crc32c_shift(_MASK, nbytes) ^ _MASK) & _MASK


def crc32c_zero_unpad(crc: int, pad: int) -> int:
    """``crc32c(A)`` from ``crc32c(A || 0^pad)`` — strip `pad`
    trailing zero bytes from a digest.

    The batch engine right-pads every member payload to its size
    bucket with zeros before the fused device digest; by
    ``crc(A||0^n) = A^n·crc(A) ⊕ crc(0^n)`` the true digest is
    recovered host-side with two 32-bit GF(2) matrix applications —
    no second pass over the data."""
    if pad == 0:
        return int(crc) & _MASK
    return crc32c_unshift((int(crc) ^ crc32c_zeros(pad)) & _MASK, pad)


@functools.lru_cache(maxsize=None)
def _power_nibbles(inverse: bool, bit: int) -> np.ndarray:
    """``_power_cols(inverse, bit)`` as [8, 16] uint32 nibble tables:
    entry [j, v] is the matrix times ``v << 4j``."""
    cols = np.asarray(_power_cols(inverse, bit), dtype=np.uint32)
    v = np.arange(16)
    return np.stack([np.bitwise_xor.reduce(
        np.where(((v[:, None] >> np.arange(4)) & 1) == 1,
                 cols[4 * j:4 * j + 4], 0), axis=1, dtype=np.uint32)
        for j in range(8)])


def _apply_powers(c: np.ndarray, n: np.ndarray, inverse: bool) -> np.ndarray:
    """:func:`_apply_power` of every ``c[i]`` by its own ``n[i]``: one
    masked pass of nibble-table lookups per bit of the largest ``n``."""
    c = c.astype(np.uint32, copy=True)
    for bit in range(int(n.max()).bit_length() if len(n) else 0):
        sel = np.flatnonzero((n >> bit) & 1)
        if len(sel):
            tab, v = _power_nibbles(inverse, bit), c[sel]
            out = np.zeros(len(sel), dtype=np.uint32)
            for j in range(8):
                out ^= tab[j, (v >> np.uint32(4 * j)) & np.uint32(15)]
            c[sel] = out
    return c


def crc32c_zero_unpad_many(crcs, pads) -> np.ndarray:
    """:func:`crc32c_zero_unpad` of every ``crcs[i]`` by ``pads[i]``, in
    numpy: ``[n]`` uint32 digests of payloads zero-padded at the back →
    ``[n]`` uint32 digests of the payloads."""
    pads = np.asarray(pads, dtype=np.int64)
    crcs = np.asarray(crcs, dtype=np.uint32)
    if len(pads) and pads.min() < 0:
        raise ValueError("negative length")
    mask = np.uint32(_MASK)
    zeros = _apply_powers(np.full(len(pads), mask), pads, False) ^ mask
    zeros[pads == 0] = 0
    return _apply_powers(crcs ^ zeros, pads, True)


# --------------------------------------------------- block-parallel host

_BLOCKS_MIN = 256               # bytes below which the scalar walk is as fast


@functools.lru_cache(maxsize=1)
def _pair_tables() -> tuple[np.ndarray, np.ndarray]:
    """Two [65536] uint32 tables for one 4-byte step of the raw register:
    entry ``v`` of the first is the register after the little-endian
    pair ``v`` then two zero bytes, of the second after ``v`` alone."""
    t = np.asarray(_TABLE, dtype=np.uint32)
    after = [t]                 # after[z][b]: byte b, then z zero bytes
    for _ in range(3):
        after.append((after[-1] >> np.uint32(8))
                     ^ t[after[-1] & np.uint32(0xFF)])
    v = np.arange(1 << 16, dtype=np.uint32)
    lo, hi = v & np.uint32(0xFF), v >> np.uint32(8)
    return (after[3][lo] ^ after[2][hi], after[1][lo] ^ after[0][hi])


def crc32c_blocks(data, crc: int = 0) -> int:
    """:func:`crc32c`, bit for bit, at numpy speed on one host core.

    The buffer splits into ``B`` blocks of ``L`` bytes (``L`` a power of
    two near ``sqrt(n / 16)``).  The table walk runs across all blocks
    at once, one numpy step per 4 bytes of a block, through two 16-bit
    tables; each block starts from a zero register, the first from
    ``crc``'s.  By linearity the blocks' registers then fold pairwise in
    a log-depth tree, ``r = A^span · r_left ⊕ r_right``, with the cached
    squarings of :func:`_apply_powers`; the bytes past the last block go
    through :func:`crc32c`."""
    b = _as_bytes(data)
    n = len(b)
    if n < _BLOCKS_MIN:
        return crc32c(b, crc)
    blk = 1 << max(4, round(math.log2(math.sqrt(n / 16))))
    nblk = n // blk
    words = np.ascontiguousarray(np.frombuffer(
        b, dtype=np.uint32, count=nblk * blk // 4).reshape(nblk, blk // 4).T)
    lo_tab, hi_tab = _pair_tables()
    reg = np.zeros(nblk, dtype=np.uint32)
    reg[0] = (int(crc) ^ _MASK) & _MASK
    for step in words:
        reg ^= step
        pairs = reg.view(np.uint16)
        reg = lo_tab.take(pairs[0::2]) ^ hi_tab.take(pairs[1::2])
    # zero registers in front of the first block leave the fold as it is
    width = 1 << (nblk - 1).bit_length()
    reg = np.concatenate([np.zeros(width - nblk, dtype=np.uint32), reg])
    span = blk
    while len(reg) > 1:
        reg = _apply_powers(reg[0::2], np.full(len(reg) // 2, span),
                            False) ^ reg[1::2]
        span *= 2
    return crc32c(b[nblk * blk:], (int(reg[0]) ^ _MASK) & _MASK)


# ------------------------------------------------------- batch kernel

def _dense(cols: list[int], rows: int = 32) -> np.ndarray:
    """uint32 columns -> dense 0/1 uint8 matrix [rows, len(cols)]."""
    c = np.asarray(cols, dtype=np.uint64)
    return ((c[None, :] >> np.arange(rows, dtype=np.uint64)[:, None])
            & 1).astype(np.uint8)


_A_DENSE = _dense(_A_COLS)
# B: data-byte injection, column s = T[1<<s] (table additivity)
_B_DENSE = _dense([_TABLE[1 << s] for s in range(8)])


@functools.lru_cache(maxsize=None)
def _contrib(length: int) -> tuple[np.ndarray, np.ndarray]:
    """→ (K [32, 8L] with column 8j+s = A^(L-1-j)·B·e_s, A^L [32, 32]),
    built by doubling: K_2n = [A^n·K_n | K_n]."""
    if length == 1:
        return _B_DENSE, _A_DENSE
    if length % 2:
        k1, a1 = _contrib(length - 1)
        head = (a1 @ _B_DENSE) % 2
        return (np.concatenate([head, k1], axis=1).astype(np.uint8),
                ((_A_DENSE @ a1) % 2).astype(np.uint8))
    kh, ah = _contrib(length // 2)
    return (np.concatenate([(ah @ kh) % 2, kh], axis=1).astype(np.uint8),
            ((ah @ ah) % 2).astype(np.uint8))




# ------------------------------------------------------- batch digest

# K6 _batch_kernel.run, and the digest half of K5
# GFEncodeDigest._make.run (ops/gf_jax.py:325)
CRC32C_BATCH = build.register(
    "crc32c_batch", "ceph_tpu_torch/csrc/crc32c_batch.cu",
    "ceph_tpu/scrub/crc32c_jax.py:275")

_GRAN = 16                  # bytes per granule (one uint4 load)
_THREADS = 256              # threads per block, granules per tile
_BLOCKS_PER_SM = 4          # resident blocks per SM (kernel launch bounds)
_ITEM_TILES = 2             # a work item's fixed cost, in tiles of loads
_MAX_SEGMENTS = 32          # segments of a row at most (combine mask)
_TABLE_COPIES = 16          # copies of the kernel's tables on the card
_PLAIN_CHUNK = 1 << 14      # bytes of L per plain matmul: counts <= 2^17


def _power_dense(n: int) -> np.ndarray:
    """A^n as a dense 0/1 [32, 32] matrix (square and multiply)."""
    out = np.eye(32, dtype=np.int64)
    base = _A_DENSE.astype(np.int64)
    while n:
        if n & 1:
            out = (base @ out) % 2
        n >>= 1
        if n:
            base = (base @ base) % 2
    return out


def _cols(dense: np.ndarray) -> np.ndarray:
    """Dense [32, 32] 0/1 -> 32 uint32 columns (bit r of col b = M[r, b])."""
    w = np.left_shift(np.uint64(1), np.arange(32, dtype=np.uint64))
    return (dense.astype(np.uint64) * w[:, None]).sum(0).astype(np.uint32)


def _nibble_tables(cols: np.ndarray) -> np.ndarray:
    """The linear map with uint32 columns ``cols`` (one per input bit)
    as [len(cols) / 4, 16] nibble tables: table i maps nibble v of the
    input to the image of ``v << 4i``."""
    cols = np.asarray(cols, dtype=np.uint32).reshape(-1, 4)
    v = np.arange(16, dtype=np.uint32)
    tabs = np.zeros((cols.shape[0], 16), dtype=np.uint32)
    for b in range(4):
        tabs ^= np.where(((v >> b) & 1)[None, :] == 1, cols[:, b:b + 1],
                         np.uint32(0))
    return tabs


def _raw_crc(block: bytes) -> int:
    """Raw CRC-32C register of ``block`` from a zero register (no
    conditioning): linear in the bytes."""
    c = 0
    for byte in block:
        c = (c >> 8) ^ _TABLE[(c ^ byte) & 0xFF]
    return c


def _op_tables(n: int) -> np.ndarray:
    """A^n as [8, 16] nibble tables."""
    return _nibble_tables(_cols(_power_dense(n)))


@functools.lru_cache(maxsize=1)
def _kernel_tables() -> np.ndarray:
    """The kernel's constant tables, [5760] uint32: the raw CRC of one
    16-byte granule as 32 nibble tables (one per nibble of the
    granule, little-endian); A^(16 * 256), one tile ahead; the lane
    operators A^(16 (31 - l)), interleaved [table, nibble, lane] so
    that lane l reads bank l; the warp operators
    A^(16 * 32 * (7 - w)), w = 0..7."""
    data_cols = [_raw_crc(bytes(p // 8) + bytes([1 << (p % 8)])
                          + bytes(15 - p // 8)) for p in range(128)]
    lanes = np.stack([_op_tables(_GRAN * (31 - lane))
                      for lane in range(32)], axis=-1)
    warps = [_op_tables(_GRAN * 32 * (7 - w)).ravel() for w in range(8)]
    return np.concatenate([_nibble_tables(data_cols).ravel(),
                           _op_tables(_GRAN * _THREADS).ravel(),
                           lanes.ravel()] + warps)


@functools.lru_cache(maxsize=None)
def _segment_ops(tps: int, nseg: int) -> np.ndarray:
    """[nseg, 128] uint32: entry j is A^(16 * 256 * tps * j) as nibble
    tables, the move of a segment's CRC j segments ahead."""
    step = _power_dense(_GRAN * _THREADS * tps)
    cur = np.eye(32, dtype=np.int64)
    out = np.empty((nseg, 128), dtype=np.uint32)
    for j in range(nseg):
        out[j] = _nibble_tables(_cols(cur)).ravel()
        cur = (step @ cur) % 2
    return out


@functools.lru_cache(maxsize=None)
def _seed_op(length: int) -> np.ndarray:
    """A^length as [128] uint32 nibble tables (the seed term)."""
    return _op_tables(length).ravel()


@functools.lru_cache(maxsize=4096)
def crc32c_geometry(nrows: int, ngran: int, sms: int) -> tuple:
    """(tiles per segment, segments per row, grid) of a launch over
    ``nrows`` rows of ``ngran`` 16-byte granules on a card of ``sms``
    SMs.

    A work item is one segment of one row; the grid (at most 4 blocks
    per SM) takes items in turn.  The split minimises the busiest SM's
    items x (tiles per segment + a fixed cost of ``_ITEM_TILES``): the
    items of one SM share its shared-memory pipe, and each carries the
    fixed cost of its operators and its combine.  A row has at most 32
    segments (one bit each in the combine); ties go to fewer."""
    ntiles = -(-ngran // _THREADS)
    best = None
    for nseg in range(1, min(ntiles, _MAX_SEGMENTS) + 1):
        tps = -(-ntiles // nseg)
        nseg = -(-ntiles // tps)
        cost = -(-nrows * nseg // sms) * (tps + _ITEM_TILES)
        if best is None or cost < best[0]:
            best = (cost, tps, nseg)
    _, tps, nseg = best
    return tps, nseg, min(nrows * nseg, _BLOCKS_PER_SM * sms)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# device copies of the operator tables, per (table, device)
_DEVICE_TABLES: dict = {}


def _u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor of uint32 values -> int32 tensor of the same bits."""
    return (x - ((x >> 31) & 1) * (1 << 32)).to(torch.int32)


def crc32c_rows_plain(data: torch.Tensor,
                      seeds: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch CRC-32C of every row: ``[n, L]`` uint8, seeds
    ``[n]`` int32 (uint32 bits) -> ``[n]`` int32 (uint32 bits).

    The contribution matmul of ``ceph_tpu``'s ``_batch_kernel``: bit
    planes times ``K^T`` in L-chunks of 16 KiB, so every float32
    count stays below 2^17 (exact), each reduced mod 2 and XORed."""
    n, length = data.shape
    dev = data.device
    if seeds is None:
        seeds = torch.zeros(n, dtype=torch.int32, device=dev)
    if length == 0:
        return seeds.clone()
    k_dense, a_dense = _contrib(length)
    acc = torch.zeros(n, 32, dtype=torch.int32, device=dev)
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    for off in range(0, length, _PLAIN_CHUNK):
        blk = data[:, off:off + _PLAIN_CHUNK]
        bits = ((blk.unsqueeze(-1) >> shifts) & 1).reshape(n, -1)
        kt = torch.from_numpy(np.ascontiguousarray(
            k_dense[:, 8 * off:8 * (off + blk.shape[1])].T,
            dtype=np.float32)).to(dev)
        acc ^= (bits.to(torch.float32) @ kt).to(torch.int32) & 1
    bit32 = torch.arange(32, dtype=torch.int64, device=dev)
    sbits = (seeds.to(torch.int64) & 0xFFFFFFFF).unsqueeze(-1) >> bit32 & 1
    at = torch.from_numpy(a_dense.T.astype(np.float32)).to(dev)
    acc ^= (sbits.to(torch.float32) @ at).to(torch.int32) & 1
    ones = np.ones(32, dtype=np.int64)
    const_row = torch.from_numpy(
        ((a_dense.astype(np.int64) @ ones) % 2) ^ ones).to(dev)
    out_bits = (acc.to(torch.int64) ^ const_row) & 1
    return _u32_to_i32((out_bits << bit32).sum(-1))


def _launch_crc32c(sets: list, seeds: torch.Tensor,
                   length: int) -> torch.Tensor:
    """Launch the kernel on one or two row sets ``[n_i, Lp]`` (Lp % 16
    == 0, 16-byte aligned, zero-padded at the front from the true
    ``length``) → ``[sum n_i]`` int32, the sets' rows in order."""
    for data in sets:
        if not data.is_cuda or data.device != sets[0].device:
            raise ValueError("crc32c_batch kernel wants CUDA tensors on "
                             "one device")
        if data.dtype != torch.uint8 or data.dim() != 2 \
                or data.shape[1] != sets[0].shape[1]:
            raise ValueError(f"want [n, L] uint8 rows of one length, got "
                             f"{data.dtype} {tuple(data.shape)}")
        if (not data.is_contiguous() or data.shape[1] % _GRAN
                or data.data_ptr() % _GRAN):
            raise ValueError("crc32c_batch kernel wants contiguous 16-byte "
                             "aligned rows of a multiple of 16 bytes")
    n = sum(d.shape[0] for d in sets)
    if (not seeds.is_cuda or seeds.dtype != torch.int32
            or seeds.shape != (n,) or not seeds.is_contiguous()):
        raise ValueError("want [n] int32 seeds on the card")
    dev = sets[0].device
    ngran = sets[0].shape[1] // _GRAN
    tps, nseg, grid = crc32c_geometry(n, ngran, _sm_count(dev.index or 0))
    blob = build.device_table(
        _DEVICE_TABLES, ("blob",),
        lambda: np.tile(_kernel_tables(), _TABLE_COPIES), dev)
    segs = build.device_table(_DEVICE_TABLES, ("segments", tps, nseg),
                              lambda: _segment_ops(tps, nseg), dev)
    sop = build.device_table(_DEVICE_TABLES, ("seed", length),
                             lambda: _seed_op(length), dev)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    acc = _accumulators(dev, n) if nseg > 1 else out
    second = sets[1] if len(sets) > 1 else sets[0]
    rc = build.library().ctt_crc32c_batch(
        sets[0].data_ptr(), second.data_ptr(), sets[0].shape[0], n,
        seeds.data_ptr(), out.data_ptr(), ngran, tps, nseg,
        blob.data_ptr(), segs.data_ptr(), sop.data_ptr(),
        acc.data_ptr(), grid, build.stream_ptr(dev))
    build.check(rc, "crc32c_batch")
    CRC32C_BATCH.count()
    return out


# per-row 64-bit combine words, per (device, stream): zeroed once and
# left at zero by every launch (the segment that completes a row clears
# its word), so launches on one stream, which run in order, share them
_ACCUMULATORS: dict = {}


def _accumulators(dev, n: int) -> torch.Tensor:
    key = (str(dev), build.stream_ptr(dev))
    acc = _ACCUMULATORS.get(key)
    if acc is None or acc.numel() < n:
        acc = _ACCUMULATORS[key] = torch.zeros(max(n, 1024),
                                               dtype=torch.int64, device=dev)
    return acc


def _kernel_rows(data: torch.Tensor, length: int) -> torch.Tensor:
    """``data`` as rows the kernel takes: front-padded with zeros to a
    multiple of 16 bytes, contiguous and 16-byte aligned."""
    pad = -length % _GRAN
    if pad or not data.is_contiguous() or data.data_ptr() % _GRAN:
        padded = torch.zeros(data.shape[0], length + pad, dtype=torch.uint8,
                             device=data.device)
        padded[:, pad:] = data
        data = padded
    return data


def crc32c_row_sets(first: torch.Tensor, second: torch.Tensor,
                    seeds: torch.Tensor | None = None) -> torch.Tensor:
    """CRC-32C of every row of two ``[n_a, L]`` and ``[n_b, L]`` uint8
    tensors of the same length ``L`` → ``[n_a + n_b]`` int32 (uint32
    bits), ``first``'s rows then ``second``'s, chained from ``seeds``
    (``[n_a + n_b]``, zeros by default); un-fenced.

    On the card it is one ``crc32c_batch`` launch over both sets, read
    where they lie (the write lane's data and parity rows, never copied
    into one buffer).  CPU tensors take the plain version."""
    for t in (first, second):
        if t.dim() != 2 or t.dtype != torch.uint8:
            raise ValueError(f"crc32c_row_sets wants [n, L] uint8, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if first.shape[1] != second.shape[1] or first.device != second.device:
        raise ValueError("crc32c_row_sets wants rows of one length on one "
                         "device")
    na, length = first.shape
    n = na + second.shape[0]
    if seeds is None:
        seeds = torch.zeros(n, dtype=torch.int32, device=first.device)
    if first.device.type == "cpu":
        return torch.cat([crc32c_rows_plain(first, seeds[:na]),
                          crc32c_rows_plain(second, seeds[na:])])
    if not first.is_cuda:
        raise ValueError(f"crc32c_row_sets: unsupported device "
                         f"{first.device}")
    if length == 0 or n == 0:
        return seeds.clone()
    return _launch_crc32c([_kernel_rows(first, length),
                           _kernel_rows(second, length)],
                          seeds.contiguous(), length)


def crc32c_rows(data: torch.Tensor,
                seeds: torch.Tensor | None = None) -> torch.Tensor:
    """CRC-32C of every row of a ``[n, L]`` uint8 tensor, chained from
    ``seeds`` (``[n]`` int32 holding uint32 bits) → ``[n]`` int32 on
    the same device, un-fenced.  A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel.

    The launch geometry (:func:`crc32c_geometry`) replaces a fixed
    split: rows are cut into equal segments of whole 4 KiB tiles
    (front-padded with virtual zeros), so that the (row, segment) items
    spread evenly over the SMs.  The segments of a row combine in the
    kernel (one 64-bit atomic each), so the output needs no zeroing
    launch."""
    if data.dim() != 2 or data.dtype != torch.uint8:
        raise ValueError(f"crc32c_rows wants [n, L] uint8, got "
                         f"{data.dtype} {tuple(data.shape)}")
    n, length = data.shape
    if seeds is None:
        seeds = torch.zeros(n, dtype=torch.int32, device=data.device)
    if data.device.type == "cpu":
        return crc32c_rows_plain(data, seeds)
    if not data.is_cuda:
        raise ValueError(f"crc32c_rows: unsupported device {data.device}")
    if length == 0 or n == 0:
        return seeds.clone()
    return _launch_crc32c([_kernel_rows(data, length)], seeds.contiguous(),
                          length)


def crc32c_batch(data, seeds=None, device=None) -> np.ndarray:
    """CRC-32C of every row of a ``[n, L]`` uint8 batch → ``[n]``
    uint32 numpy (port of ``ceph_tpu.scrub.crc32c_jax.crc32c_batch``).

    A tensor runs where it lies; host data moves to ``device``
    (``None`` → the card)."""
    if isinstance(data, torch.Tensor):
        arr = data
    else:
        arr = torch.from_numpy(np.ascontiguousarray(data, dtype=np.uint8)
                               ).to(resolve_device(device))
    if arr.dim() != 2:
        raise ValueError(f"crc32c_batch wants [n, L], got {tuple(arr.shape)}")
    s = None
    if seeds is not None:
        s = torch.from_numpy(np.ascontiguousarray(
            seeds, dtype=np.uint32).view(np.int32)).to(arr.device)
    misses = _table_misses()
    ln = DeviceProfiler.active().start(
        "crc32c", bytes_in=arr.numel(), rows=int(arr.shape[0]),
        rows_used=int(arr.shape[0]))
    try:
        res = crc32c_rows(arr.to(torch.uint8), s).cpu().numpy().view(
            np.uint32)
    except Exception:
        if ln is not None:
            ln.abort()
        raise
    if ln is not None:
        ln.finish(bytes_out=res.nbytes, cache_hit=_table_misses() == misses)
    return res


def _table_misses() -> int:
    """Misses of the per-length operator caches (the plain version's
    contribution matrix, the kernel's seed operator): unchanged across
    a call when its length was seen before — the ``cache_hit`` tag."""
    return _contrib.cache_info().misses + _seed_op.cache_info().misses
