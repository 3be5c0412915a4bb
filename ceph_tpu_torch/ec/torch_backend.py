"""The CUDA engine behind every matrix-based erasure code — port of
``ceph_tpu.ec.jax_backend``.

Stripes batch to ``[B, k, chunk]`` uint8 and encode/decode as one
``gf_words`` launch through the byte API (``ops.gf_words.
gf_matmul_bytes``): a chunk length that is a multiple of 4 views as
int32 words for free, any other is zero-padded first.  Decode
matrices are cached per erasure tuple.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import rs
from ..ops.gf_torch import GFLinear, to_device
from ..utils.device import resolve_device


class MatrixECEngine:
    """Executes encode/decode for a fixed [m, k] GF(2^8) coding matrix
    on ``device`` (``None`` → the card)."""

    def __init__(self, coding: np.ndarray, k: int, m: int, device=None):
        coding = np.asarray(coding, dtype=np.uint8)
        if coding.shape != (m, k):
            raise ValueError(f"coding {coding.shape} is not [{m}, {k}]")
        self.coding = coding
        self.k, self.m = k, m
        self.device = resolve_device(device)
        self._encoder = GFLinear(coding, device=self.device)
        self._decoders: dict[tuple[int, ...], tuple] = {}

    @classmethod
    def from_coding(cls, coding: np.ndarray, k: int, m: int,
                    device=None) -> "MatrixECEngine":
        """An engine over the same numpy coding matrix ceph_tpu uses."""
        return cls(coding, k, m, device=device)

    def _apply_host(self, gfl: GFLinear, data) -> np.ndarray:
        return gfl(to_device(data, self.device)).cpu().numpy()

    # -- encode ------------------------------------------------------------
    def encode(self, data: np.ndarray) -> np.ndarray:
        """[k, chunk] or [B, k, chunk] uint8 -> parity of matching batch shape."""
        return self._apply_host(self._encoder, data)

    def encode_device(self, data) -> torch.Tensor:
        """Same, but the result stays on the device, un-fenced."""
        return self._encoder(to_device(data, self.device))

    # -- decode ------------------------------------------------------------
    def _decoder_for(self, erasures: tuple[int, ...]):
        entry = self._decoders.get(erasures)
        if entry is None:
            dm = rs.decode_matrix(self.coding, self.k, list(erasures))
            survivors = [i for i in range(self.k + self.m)
                         if i not in erasures][: self.k]
            entry = (GFLinear(dm, device=self.device), survivors)
            self._decoders[erasures] = entry
        return entry

    def decode(self, chunks: dict[int, np.ndarray],
               chunk_size: int) -> dict[int, np.ndarray]:
        """Recover all k+m chunks of one stripe from any >=k survivors."""
        erasures = tuple(i for i in range(self.k + self.m) if i not in chunks)
        decoder, survivors = self._decoder_for(erasures)
        stacked = np.stack([np.asarray(chunks[i], dtype=np.uint8)
                            for i in survivors])
        data = self._apply_host(decoder, stacked)
        out = {i: data[i] for i in range(self.k)}
        missing_parity = [j for j in range(self.m) if self.k + j not in chunks]
        if missing_parity:
            parity = self.encode(data)
            for j in missing_parity:
                out[self.k + j] = parity[j]
        for i, buf in chunks.items():
            out[i] = np.asarray(buf, dtype=np.uint8)
        return out

    def decode_batch(self, survivors_data: np.ndarray,
                     erasures: tuple[int, ...]) -> np.ndarray:
        """[B, k, chunk] survivor stack (id order) -> [B, k, chunk] data."""
        decoder, _ = self._decoder_for(tuple(erasures))
        return self._apply_host(decoder, survivors_data)

    def decode_device(self, survivors_data,
                      erasures: tuple[int, ...]) -> torch.Tensor:
        """:meth:`decode_batch` with the result left on the device."""
        decoder, _ = self._decoder_for(tuple(erasures))
        return decoder(to_device(survivors_data, self.device))
