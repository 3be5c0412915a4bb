"""GF(2^8) linear maps in PyTorch — port of ``ceph_tpu.ops.gf_jax``.

- :func:`gf_matmul_bits` — the plain bitmatrix formulation (bit planes,
  a float32 matmul of 0/1 values, ``& 1``, repack), the CPU
  counterpart of ``gf_jax.gf_matmul_bits``;
- :func:`gf_matmul_gather` — the table-gather formulation (re-exported
  from ``gf_bytes``, where it is K4's plain version), the counterpart
  of ``gf_jax.gf_matmul_gather``;
- :class:`GFLinear` — the byte API, ``[..., k, n]`` uint8 in and out,
  on one of three routes: the ``gf_words`` kernel on an int32 view
  (K3's path, the default), the ``gf_bytes`` kernel (K4) or the plain
  bitmatrix product;
- :class:`GFLinearWords` — the word API, ``[..., k, nw]`` int32 (K1);
- :class:`GFEncodeDigest` — the write lane's launch: parity through
  ``gf_words`` and a CRC-32C of every data and parity shard through
  the ``crc32c_batch`` kernel, with no copy of the shards between.

Layout of the bitmatrix (same as ceph_tpu): plane row ``s*k + i`` is
bit ``s`` of chunk ``i``; output row ``r*m + j`` is bit ``r`` of
parity ``j``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device_profiler import DeviceProfiler
from ..scrub.crc32c import crc32c_row_sets
from ..utils.device import resolve_device
from .gf import gf_bitmatrix
from .gf_bytes import gf_matmul_gather, gf_matmul_tables  # noqa: F401
from .gf_words import gf_matmul_bytes, gf_matmul_words


def _bit_layout_matrix(coding: np.ndarray) -> np.ndarray:
    """[m, k] uint8 -> [8m, 8k] 0/1 int8 bitmatrix in (bit, chunk) layout.

    Row r*m+j, column s*k+i = BM(coding[j, i])[r, s].
    """
    coding = np.asarray(coding, dtype=np.uint8)
    m, k = coding.shape
    bm = gf_bitmatrix(coding)            # [m, k, 8, 8] (j, i, r, s)
    bm = bm.transpose(2, 0, 3, 1)        # [8(r), m(j), 8(s), k(i)]
    return bm.reshape(8 * m, 8 * k).astype(np.int8)


def gf_matmul_bits(bitmat, data: torch.Tensor, m: int) -> torch.Tensor:
    """Plain GF(2^8) matmul through the GF(2) bitmatrix.

    bitmat: [8m, 8k] 0/1 from :func:`_bit_layout_matrix`;
    data: [..., k, n] uint8 → [..., m, n] uint8.  The float32 products
    of 0/1 values sum to at most 8k, so they are exact."""
    bm = torch.as_tensor(np.asarray(bitmat), device=data.device)
    k = data.shape[-2]
    shifts = torch.arange(8, dtype=torch.uint8,
                          device=data.device).view(8, 1, 1)
    dbits = (data.unsqueeze(-3) >> shifts) & 1               # [..., 8, k, n]
    dbits = dbits.reshape(*data.shape[:-2], 8 * k, data.shape[-1])
    acc = (bm.to(torch.float32) @ dbits.to(torch.float32)).to(torch.int32) & 1
    acc = acc.reshape(*acc.shape[:-2], 8, m, acc.shape[-1])
    wshift = torch.arange(8, dtype=torch.int32,
                          device=data.device).view(8, 1, 1)
    return (acc << wshift).sum(-3).to(torch.uint8)


def to_device(data, device, dtype=torch.uint8) -> torch.Tensor:
    """Host array or tensor → tensor of ``dtype`` on ``device``."""
    if isinstance(data, torch.Tensor):
        return data.to(device=device, dtype=dtype)
    np_dtype = {torch.uint8: np.uint8, torch.int32: np.int32}[dtype]
    return torch.from_numpy(np.ascontiguousarray(data, dtype=np_dtype)
                            ).to(device)


class GFLinear:
    """A GF(2^8) linear map over batches, byte API: ``[..., k, n]``
    uint8 → ``[..., m, n]`` uint8 on ``device`` (un-fenced).

    Routes (ceph_tpu's backend names in brackets):

    - ``"words"`` (default) — the ``gf_words`` kernel on an int32 view,
      K3's path [``"auto"`` / ``"pallas"``];
    - ``"bytes"`` — the ``gf_bytes`` split-nibble kernel, K4's port
      [``"pallas-v1"``]; ``use_bits=False`` selects it, as it selects
      the table gather in ceph_tpu;
    - ``"plain"`` — :func:`gf_matmul_bits`, the bitmatrix formulation in
      plain PyTorch on any device [``"xla"``].

    On the CPU the kernel routes run their plain versions; a CUDA tensor
    launches the route's kernel or raises."""

    ROUTES = ("words", "bytes", "plain")

    def __init__(self, coding: np.ndarray, use_bits: bool = True,
                 backend: str | None = None, device=None):
        self.coding = np.asarray(coding, dtype=np.uint8)
        self.m, self.k = self.coding.shape
        self.use_bits = use_bits
        if backend is None:
            backend = "words" if use_bits else "bytes"
        if backend not in self.ROUTES:
            raise ValueError(f"unknown GFLinear backend {backend!r} "
                             f"(routes: {self.ROUTES})")
        if not use_bits and backend != "bytes":
            raise ValueError("use_bits=False is the table route: "
                             "backend must be 'bytes'")
        self.backend = backend
        self.device = resolve_device(device)
        self._tables: dict = {}
        self._bits = (_bit_layout_matrix(self.coding)
                      if backend == "plain" else None)

    def __call__(self, data) -> torch.Tensor:
        x = to_device(data, self.device)
        rows = int(x.shape[0]) if x.dim() else 0
        cache_hit = bool(self._tables)
        ln = DeviceProfiler.active().start(
            "gf_encode", bytes_in=x.numel(), rows=rows,
            cache_hit=cache_hit, backend=self.backend)
        try:
            if self.backend == "words":
                out = gf_matmul_bytes(self.coding, x, self._tables)
            elif self.backend == "bytes":
                out = gf_matmul_tables(self.coding, x, self._tables)
            else:
                out = gf_matmul_bits(self._bits, x, self.m)
        except Exception:
            if ln is not None:
                ln.abort()
            raise
        if ln is not None:
            ln.finish(out=out, bytes_out=out.numel())
        return out


class GFLinearWords:
    """Word-native GF(2^8) linear map: ``[..., k, nw]`` int32 →
    ``[..., m, nw]`` int32 on ``device`` (un-fenced)."""

    def __init__(self, coding: np.ndarray, device=None):
        self.coding = np.asarray(coding, dtype=np.uint8)
        self.m, self.k = self.coding.shape
        self.device = resolve_device(device)
        self._tables: dict = {}

    def __call__(self, words) -> torch.Tensor:
        w = to_device(words, self.device, torch.int32)
        ln = DeviceProfiler.active().start(
            "gf_encode", bytes_in=4 * w.numel(),
            rows=int(w.shape[0]) if w.dim() else 0, backend="words")
        try:
            out = gf_matmul_words(self.coding, w, self._tables)
        except Exception:
            if ln is not None:
                ln.abort()
            raise
        if ln is not None:
            ln.finish(out=out, bytes_out=4 * out.numel())
        return out


class GFEncodeDigest:
    """Fused EC encode + CRC-32C digest for one megabatch.

    ``[B, k, L]`` uint8 stripes in, ``([B, m, L]`` uint8 parity,
    ``[B, k+m]`` int32 shard digests holding uint32 bits) out, both on
    the device and un-fenced: the engine's flight queue decides when
    to read them.  On the card: one ``gf_words`` launch for the parity
    and one ``crc32c_batch`` launch over two row sets, the data rows
    and the parity rows where they lie, so the shards are never copied
    into one buffer."""

    def __init__(self, coding: np.ndarray, device=None):
        self.coding = np.asarray(coding, dtype=np.uint8)
        self.m, self.k = self.coding.shape
        self.device = resolve_device(device)
        self._tables: dict = {}

    def __call__(self, data) -> tuple[torch.Tensor, torch.Tensor]:
        arr = to_device(data, self.device)
        if arr.dim() != 3 or arr.shape[1] != self.k:
            raise ValueError(
                f"GFEncodeDigest wants [B, {self.k}, L], got "
                f"{tuple(arr.shape)}")
        arr = arr.contiguous()
        bsz, k, length = arr.shape
        parity = gf_matmul_bytes(self.coding, arr, self._tables)
        crc = crc32c_row_sets(arr.reshape(bsz * k, length),
                              parity.reshape(bsz * self.m, length))
        crcs = torch.cat([crc[:bsz * k].view(bsz, k),
                          crc[bsz * k:].view(bsz, self.m)], dim=1)
        return parity, crcs
