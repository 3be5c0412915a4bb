"""GF(2^8) linear maps on byte rows by split-nibble product tables — the
port of ``ceph_tpu.ops.gf_pallas`` (K4, the ``pallas-v1`` kernel).

:func:`gf_matmul_tables` takes ``[..., k, n]`` uint8 and an ``[m, k]``
GF(2^8) matrix to ``[..., m, n]`` uint8, for any leading batch shape,
any ``n`` and any matrix whose tables fit a block's shared memory.  On
the card it launches the ``gf_bytes`` kernel (``csrc/gf_bytes.cu``), the
byte-layout entry of the kernel ``gf_words`` runs (``csrc/gf_nibble.cuh``):
the host builds ISA-L's pair of 16-entry tables per coefficient
(:func:`nibble_tables`, 32 B each), the kernel stages them in shared
memory and looks bytes up four at a time with a byte permute.  A row
length that is not a multiple of 4 is zero-padded to one (zero bytes
map to zero bytes, as ``gf_pallas.py:121-155`` pads to 128 lanes);
output rows beyond a register tile of 8 tile over the grid.

The plain version is :func:`gf_matmul_gather`, the twin of
``ceph_tpu.ops.gf_jax.gf_matmul_gather``: a 64 KiB product table, a
gather, and an XOR reduce over k.  A CPU tensor takes it; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import build
from .gf import GF_MUL_TABLE

# K4 _gf_apply_pallas
GF_BYTES = build.register(
    "gf_bytes", "ceph_tpu_torch/csrc/gf_bytes.cu",
    "ceph_tpu/ops/gf_pallas.py:105")

_WORD = 4                       # the kernel reads rows as 32-bit words
_COEF_BYTES = 32                # LO and HI tables, 16 B each
_SMEM_LIMIT = 48 * 1024         # dynamic shared memory without an opt-in
_ROW_TILE = 8                   # output rows held in registers
_K_CHUNK = 8                    # input rows loaded together


def nibble_rows_per_block(k: int, rows: int) -> int:
    """Output rows sharing one block's shared tables in the split-nibble
    kernel (``csrc/gf_nibble.cuh``): the register tile of 8, fewer if
    the tables (k padded to the chunk of input rows) fill shared
    memory; the rest tile over the grid.  0 if one row's tables do not
    fit."""
    kpad = -(-k // _K_CHUNK) * _K_CHUNK
    return min(rows, _ROW_TILE, _SMEM_LIMIT // (kpad * _COEF_BYTES))


def nibble_tables(coding: np.ndarray) -> np.ndarray:
    """[rows, k] GF(2^8) matrix -> [rows, k, 8] uint32: bytes 0..15 are
    ``c * x`` and bytes 16..31 are ``c * (x << 4)`` for x = 0..15, so
    ``c * v = LO[v & 15] ^ HI[v >> 4]``."""
    coding = np.asarray(coding, dtype=np.uint8)
    x = np.arange(16, dtype=np.uint8)
    lo = GF_MUL_TABLE[coding[..., None], x]
    hi = GF_MUL_TABLE[coding[..., None], x << 4]
    tab = np.ascontiguousarray(np.concatenate([lo, hi], axis=-1))
    return tab.view("<u4")


def gf_matmul_gather(coding: np.ndarray, data: torch.Tensor) -> torch.Tensor:
    """Plain version: ``[..., k, n]`` uint8 -> ``[..., rows, n]`` uint8 by
    product-table gather and XOR reduce over k, one input row at a
    time."""
    coding = np.asarray(coding, dtype=np.uint8)
    rows, k = coding.shape
    if data.shape[-2] != k:
        raise ValueError(f"want [..., {k}, n], got {tuple(data.shape)}")
    dev = data.device
    table = torch.from_numpy(GF_MUL_TABLE.reshape(-1)).to(dev)
    base = torch.from_numpy(coding.astype(np.int64) * 256).to(dev)
    out = torch.zeros(*data.shape[:-2], rows, data.shape[-1],
                      dtype=torch.uint8, device=dev)
    for i in range(k):
        idx = base[:, i, None] + data[..., i, None, :].to(torch.int64)
        out ^= table[idx]
    return out


def gf_matmul_tables(coding: np.ndarray, data: torch.Tensor,
                     cache: dict | None = None) -> torch.Tensor:
    """GF(2^8) matrix ``[rows, k]`` times ``[..., k, n]`` uint8 →
    ``[..., rows, n]`` uint8 (K4), un-fenced.  ``cache`` holds the
    matrix's device tables across calls."""
    coding = np.asarray(coding, dtype=np.uint8)
    rows, k = coding.shape
    if data.dtype != torch.uint8 or data.dim() < 2 or data.shape[-2] != k:
        raise ValueError(f"gf_bytes: want [..., {k}, n] uint8, got "
                         f"{data.dtype} {tuple(data.shape)}")
    if data.device.type == "cpu":
        return gf_matmul_gather(coding, data)
    if not data.is_cuda:
        raise ValueError(f"gf_bytes: unsupported device {data.device}")
    rows_per_block = nibble_rows_per_block(k, rows)
    if rows_per_block < 1:
        raise ValueError(f"gf_bytes: k={k} tables exceed shared memory")
    lead, n = data.shape[:-2], data.shape[-1]
    x = data.reshape(-1, k, n)
    pad = -n % _WORD
    if pad or not x.is_contiguous() or x.data_ptr() % _WORD:
        x = torch.nn.functional.pad(x, (0, pad)).contiguous()
    bsz, _, npad = x.shape
    if bsz * npad * rows == 0:
        return torch.zeros(*lead, rows, n, dtype=torch.uint8,
                           device=data.device)
    tables = build.device_table(
        {} if cache is None else cache, ("nibbles", coding.tobytes()),
        lambda: nibble_tables(coding), data.device)
    out = torch.empty(bsz, rows, npad, dtype=torch.uint8, device=data.device)
    rc = build.library().ctt_gf_bytes(
        x.data_ptr(), out.data_ptr(), tables.data_ptr(), bsz, k, rows,
        rows_per_block, npad, build.stream_ptr(data.device))
    build.check(rc, "gf_bytes")
    GF_BYTES.count()
    if pad:
        out = out[..., :n]
    return out.reshape(*lead, rows, n)
