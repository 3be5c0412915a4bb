"""GF(2^8) linear maps on word-resident chunks — the port of
``ceph_tpu.ops.gf_pallas2``.

Chunk payloads are uint8 bytes; on the card a ``[..., k, n]`` uint8
tensor with ``n % 4 == 0`` views as ``[..., k, n/4]`` int32 words for
free, so the byte API (K3) and the word API (K1) share one kernel.
Three CUDA kernels serve this module (``csrc/``):

- ``gf_words`` — :func:`gf_matmul_words` / :func:`gf_matmul_bytes`
  (K1 ``_gf_apply_words`` and K3 ``_gf_apply_pallas2``);
- ``gf_expand`` — :func:`gf_expand_words`, bit planes in ceph_tpu's row
  order ``(8b + s) * k + i``;
- ``gf_planes`` — :func:`gf_matmul_planes` (K2 ``_gf_apply_planes``),
  behind :class:`ResidentPlanes` (expand once, multiply many).

Each wrapper takes its plain PyTorch version for a tensor on the CPU
and launches its kernel for a CUDA tensor; any other device raises.
The plain versions: the ``GF_MUL_TABLE`` gather with XOR reduce for
the matmuls, shifts and masks for the expansion, and a float32 matmul
of 0/1 values (exact: counts stay below 2^24) for the planes product.

Not carried over from the TPU: the 128-lane padding and the
small-stripe fold of ``gf_matmul_words`` (``gf_pallas2.py:269-288``);
a CUDA grid takes any word count.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import build
from ..utils.device import resolve_device
from .gf_bytes import (gf_matmul_gather, nibble_rows_per_block,
                       nibble_tables)

# K1 _gf_apply_words; K3 _gf_apply_pallas2 (gf_pallas2.py:113) runs
# through the same kernel on a uint8 -> int32 view
GF_WORDS = build.register(
    "gf_words", "ceph_tpu_torch/csrc/gf_words.cu",
    "ceph_tpu/ops/gf_pallas2.py:217")
# gf_expand_words, K2's feeder (XLA on the TPU)
GF_EXPAND = build.register(
    "gf_expand", "ceph_tpu_torch/csrc/gf_expand.cu",
    "ceph_tpu/ops/gf_pallas2.py:304")
# K2 _gf_apply_planes
GF_PLANES = build.register(
    "gf_planes", "ceph_tpu_torch/csrc/gf_planes.cu",
    "ceph_tpu/ops/gf_pallas2.py:340")

_WORD = 4
# dynamic shared memory the kernels may take without an opt-in
_SMEM_LIMIT = 48 * 1024
_FRAG_BYTES = 256       # gf_planes: one k32 x n8 B tile, all 32 lanes


def block_diag4(bitmat: np.ndarray) -> np.ndarray:
    """v1 bit-layout matrix [8m, 8k] -> word-sliced [32m, 32k] int8:
    one identical block per in-word byte position."""
    m8, k8 = bitmat.shape
    out = np.zeros((4 * m8, 4 * k8), dtype=np.int8)
    for b in range(4):
        out[b * m8:(b + 1) * m8, b * k8:(b + 1) * k8] = bitmat
    return out


def plane_frags(coding: np.ndarray) -> np.ndarray:
    """[rows, k] GF(2^8) matrix -> the K2 kernel's B operand,
    ``[rows, ceil(8k/32), 32, 2]`` uint32: one diagonal block of
    :func:`block_diag4` (all four are the bit-layout matrix) as a
    ``[K = 8k, N = 8 rows]`` product with output row t in n8 tile t,
    column s' (bit s'), K (plane rows ``s * k + i`` of one byte position)
    zero-padded to k32 steps, laid out as the ``mma.m16n8k32`` B
    fragments of each lane: register h of lane ``4 g + tig`` in (tile t,
    step ks) holds K ``32 ks + 16 h + 4 tig + 0..3`` of column g."""
    from .gf_torch import _bit_layout_matrix
    coding = np.asarray(coding, dtype=np.uint8)
    rows, k = coding.shape
    kt = -(-8 * k // 32)
    bits = _bit_layout_matrix(coding).astype(np.uint8)  # [s' rows + t, 8k]
    b = np.zeros((rows, 8, kt * 32), dtype=np.uint8)    # [t, s', K]
    b[:, :, :8 * k] = bits.reshape(8, rows, 8 * k).transpose(1, 0, 2)
    # [t, g, ks, h, tig, p] -> [t, ks, g, tig, h, p]
    b = b.reshape(rows, 8, kt, 2, 4, 4).transpose(0, 2, 1, 4, 3, 5)
    return np.ascontiguousarray(b).reshape(rows, kt, 32, 8).view("<u4")


def _check_cuda(t: torch.Tensor, dtype, name: str):
    if not t.is_cuda:
        raise ValueError(f"{name}: kernel wants a CUDA tensor, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: want {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: want a contiguous tensor")
    if t.data_ptr() % _WORD:
        raise ValueError(f"{name}: storage not 4-byte aligned")


def _dispatch(t: torch.Tensor, name: str) -> bool:
    """True for the plain version (CPU tensor), False for the kernel
    (CUDA tensor); raise for anything else."""
    if t.device.type == "cpu":
        return True
    if t.is_cuda:
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


# -- K1 / K3: gf_words ------------------------------------------------------

# plain version of the byte API: the product-table gather and XOR
# reduce, shared with K4
gf_matmul_bytes_plain = gf_matmul_gather


def gf_matmul_words_plain(coding: np.ndarray,
                          words: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gf_matmul_words` on the byte view."""
    by = words.contiguous().view(torch.uint8)
    return gf_matmul_bytes_plain(coding, by).view(torch.int32)


def _launch_gf_words(tables: torch.Tensor, words: torch.Tensor,
                     rows: int, k: int) -> torch.Tensor:
    _check_cuda(words, torch.int32, "gf_words")
    if words.dim() != 3 or words.shape[1] != k:
        raise ValueError(f"gf_words: want [B, {k}, nw], got "
                         f"{tuple(words.shape)}")
    rows_per_block = nibble_rows_per_block(k, rows)
    if rows_per_block < 1:
        raise ValueError(f"gf_words: k={k} tables exceed shared memory")
    bsz, _, nw = words.shape
    out = torch.empty(bsz, rows, nw, dtype=torch.int32, device=words.device)
    rc = build.library().ctt_gf_words(
        words.data_ptr(), out.data_ptr(), tables.data_ptr(), bsz, k, rows,
        rows_per_block, nw, build.stream_ptr(words.device))
    build.check(rc, "gf_words")
    GF_WORDS.count()
    return out


def gf_matmul_words(coding: np.ndarray, words: torch.Tensor,
                    cache: dict | None = None) -> torch.Tensor:
    """GF(2^8) matrix ``[rows, k]`` times word-resident chunks
    ``[..., k, nw]`` int32 → ``[..., rows, nw]`` int32 (K1).  ``cache``
    holds the matrix's device table across calls."""
    coding = np.asarray(coding, dtype=np.uint8)
    rows, k = coding.shape
    if _dispatch(words, "gf_matmul_words"):
        return gf_matmul_words_plain(coding, words)
    lead, nw = words.shape[:-2], words.shape[-1]
    table = build.device_table(
        {} if cache is None else cache, ("nibbles", coding.tobytes()),
        lambda: nibble_tables(coding), words.device)
    out = _launch_gf_words(table, words.reshape(-1, k, nw), rows, k)
    return out.reshape(*lead, rows, nw)


def gf_matmul_bytes(coding: np.ndarray, data: torch.Tensor,
                    cache: dict | None = None) -> torch.Tensor:
    """Byte API (K3): ``[..., k, n]`` uint8 → ``[..., rows, n]`` uint8.
    On the card the bytes run through the word kernel on an int32
    view; a length that is not a multiple of 4 is zero-padded (zero
    bytes map to zero bytes)."""
    if _dispatch(data, "gf_matmul_bytes"):
        return gf_matmul_bytes_plain(coding, data)
    n = data.shape[-1]
    pad = -n % _WORD
    if pad or not data.is_contiguous() or data.data_ptr() % _WORD:
        data = torch.nn.functional.pad(data, (0, pad)).contiguous()
    out = gf_matmul_words(coding, data.view(torch.int32), cache)
    out = out.view(torch.uint8)
    return out[..., :n] if pad else out


# -- K2 feeder: gf_expand ---------------------------------------------------

def gf_expand_words_plain(data: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gf_expand_words`."""
    *lead, k, n = data.shape
    words = data.contiguous().view(torch.int32)            # [..., k, nw]
    shifts = torch.arange(32, dtype=torch.int32,
                          device=data.device).view(32, 1, 1)
    bits = (words.unsqueeze(-3) >> shifts) & 1              # [..., 32, k, nw]
    return bits.to(torch.int8).reshape(*lead, 32 * k, n // _WORD)


def gf_expand_words(data: torch.Tensor) -> torch.Tensor:
    """``[..., k, n]`` uint8 (n % 4 == 0) → ``[..., 32k, n/4]`` int8
    0/1 planes in ceph_tpu's word-sliced row order."""
    if data.dtype != torch.uint8 or data.shape[-1] % _WORD:
        raise ValueError("gf_expand_words wants uint8 with n % 4 == 0")
    if _dispatch(data, "gf_expand_words"):
        return gf_expand_words_plain(data)
    *lead, k, n = data.shape
    words = data.reshape(-1, k, n).view(torch.int32)
    _check_cuda(words, torch.int32, "gf_expand")
    bsz, nw = words.shape[0], n // _WORD
    planes = torch.empty(bsz, 32 * k, nw, dtype=torch.int8,
                         device=data.device)
    rc = build.library().ctt_gf_expand(
        words.data_ptr(), planes.data_ptr(), bsz, k, nw,
        build.stream_ptr(data.device))
    build.check(rc, "gf_expand")
    GF_EXPAND.count()
    return planes.reshape(*lead, 32 * k, nw)


# -- K2: gf_planes ------------------------------------------------------------

def gf_matmul_planes_plain(coding: np.ndarray,
                           planes: torch.Tensor) -> torch.Tensor:
    """Plain version: the block-diagonal GF(2) matmul in float32 (0/1
    entries, counts <= 32k: exact), ``& 1``, then the 32-bit repack."""
    from .gf_torch import _bit_layout_matrix
    coding = np.asarray(coding, dtype=np.uint8)
    rows = coding.shape[0]
    bd = torch.from_numpy(block_diag4(_bit_layout_matrix(coding))
                          .astype(np.float32)).to(planes.device)
    acc = (bd @ (planes & 1).to(torch.float32)).to(torch.int64) & 1
    *lead, _r32, nw = acc.shape
    acc = acc.reshape(*lead, 32, rows, nw)
    shifts = torch.arange(32, dtype=torch.int64,
                          device=planes.device).view(32, 1, 1)
    word = (acc << shifts).sum(-3)
    word = (word - ((word >> 31) & 1) * (1 << 32)).to(torch.int32)
    return word.view(torch.uint8).reshape(*lead, rows, nw * _WORD)


def gf_matmul_planes(coding: np.ndarray, planes: torch.Tensor,
                     cache: dict | None = None) -> torch.Tensor:
    """GF(2^8) matrix ``[rows, k]`` times pre-expanded planes
    ``[..., 32k, nw]`` int8 → ``[..., rows, 4 nw]`` uint8 (K2)."""
    coding = np.asarray(coding, dtype=np.uint8)
    rows, k = coding.shape
    if planes.shape[-2] != 32 * k:
        raise ValueError(f"want [..., {32 * k}, nw] planes, got "
                         f"{tuple(planes.shape)}")
    if _dispatch(planes, "gf_matmul_planes"):
        return gf_matmul_planes_plain(coding, planes)
    *lead, k32, nw = planes.shape
    x = planes.reshape(-1, k32, nw)
    if not x.is_cuda or x.dtype != torch.int8 or not x.is_contiguous():
        raise ValueError("gf_planes: want contiguous CUDA int8 planes")
    # output rows whose B operand shares one block's shared copy; the
    # rest tile over the grid
    nt_per_block = min(rows, _SMEM_LIMIT // (-(-8 * k // 32) * _FRAG_BYTES))
    if nt_per_block < 1:
        raise ValueError(f"gf_planes: k={k} exceeds the shared B operand")
    frags = build.device_table(
        {} if cache is None else cache, ("planes", coding.tobytes()),
        lambda: plane_frags(coding), planes.device)
    out = torch.empty(x.shape[0], rows, nw, dtype=torch.int32,
                      device=planes.device)
    rc = build.library().ctt_gf_planes(
        x.data_ptr(), out.data_ptr(), frags.data_ptr(), x.shape[0], k,
        rows, nt_per_block, nw, build.stream_ptr(planes.device))
    build.check(rc, "gf_planes")
    GF_PLANES.count()
    return out.view(torch.uint8).reshape(*lead, rows, nw * _WORD)


class ResidentPlanes:
    """Expand-once/multiply-many survivor planes, resident on the device
    (port of ``ceph_tpu.ops.gf_pallas2.ResidentPlanes`` without
    ``mesh``).

    :func:`gf_expand_words` runs once in the constructor; every
    :meth:`multiply` serves a GF(2^8) matrix against the same planes.
    ``mats`` is an optional shared per-matrix table cache; hand the
    same dict to every holder of a sweep and each matrix's device
    table uploads once for the whole sweep."""

    __slots__ = ("planes", "n", "_mats")

    # same padding as ceph_tpu, so the planes compare byte for byte
    _ALIGN = 512

    def __init__(self, data, mats: dict | None = None, device=None):
        if isinstance(data, torch.Tensor):
            t = data
        else:
            t = torch.from_numpy(np.ascontiguousarray(
                data, dtype=np.uint8)).to(resolve_device(device))
        n = int(t.shape[-1])
        pad = -n % self._ALIGN
        if pad:
            t = torch.nn.functional.pad(t, (0, pad))
        self.n = n
        self._mats = mats if mats is not None else {}
        self.planes = gf_expand_words(t.contiguous())

    def multiply(self, matrix: np.ndarray) -> torch.Tensor:
        """GF(2^8) matrix [m, k] × resident planes → [..., m, n] uint8
        (device tensor, pad stripped)."""
        mat = np.ascontiguousarray(matrix, dtype=np.uint8)
        out = gf_matmul_planes(mat, self.planes, cache=self._mats)
        return out[..., : self.n]
