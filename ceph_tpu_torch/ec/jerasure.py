"""jerasure-equivalent plugin — port of ``ceph_tpu.ec.jerasure``.

GF(2^8) matrix techniques — ``reed_sol_van`` (default),
``reed_sol_r6_op`` (m must be 2), ``cauchy_orig``, ``cauchy_good`` —
execute on the port's `MatrixECEngine` (the ``gf_words`` CUDA kernel).

Bit-matrix XOR techniques — ``liberation``, ``liber8tion``,
``blaum_roth`` (all RAID-6, m=2) — execute on `BitMatrixECEngine`
(``ec/bitmatrix.py``, the ``gf2_packets`` CUDA kernel).
"""

from __future__ import annotations

import numpy as np

from ..ops import rs
from .bitmatrix import BitMatrixECEngine, build_bitmatrix
from .interface import ECError, ECProfile, ErasureCodeInterface
from .torch_backend import MatrixECEngine


TECHNIQUES = ("reed_sol_van", "reed_sol_r6_op", "cauchy_orig",
              "cauchy_good", "liberation", "liber8tion", "blaum_roth")
BITMATRIX_TECHNIQUES = ("liberation", "liber8tion", "blaum_roth")


class ErasureCodeJerasure(ErasureCodeInterface):
    def __init__(self, profile: ECProfile, device=None):
        self.profile = profile
        self.k = profile.k
        self.m = profile.m
        self.technique = profile.technique or "reed_sol_van"
        if self.k < 1 or self.m < 1:
            raise ECError(f"bad k={self.k} m={self.m}")
        if self.k + self.m > 256:
            raise ECError("k+m must be <= 256 for w=8")
        if self.technique in BITMATRIX_TECHNIQUES:
            if self.m != 2:
                raise ECError(f"{self.technique} requires m=2")
            # profile.w None = unspecified → the technique's smallest
            # valid w (the reference's per-technique DEFAULT_W); an
            # explicit invalid w raises from the construction
            bits, self.w = build_bitmatrix(self.technique, self.k,
                                           profile.w)
            self.coding_matrix = bits
            self.engine = BitMatrixECEngine(bits, self.k, self.w,
                                            device=device)
            return
        self.w = profile.w or 8
        if self.w != 8:
            raise ECError("GF(2^8) techniques require w=8")
        if self.technique == "reed_sol_van":
            coding = rs.reed_sol_van_matrix(self.k, self.m)
        elif self.technique == "reed_sol_r6_op":
            if self.m != 2:
                raise ECError("reed_sol_r6_op requires m=2")
            coding = rs.reed_sol_r6_matrix(self.k)
        elif self.technique == "cauchy_orig":
            coding = rs.cauchy_orig_matrix(self.k, self.m)
        elif self.technique == "cauchy_good":
            coding = rs.cauchy_good_matrix(self.k, self.m)
        else:
            raise ECError(f"jerasure technique {self.technique!r} not supported"
                          f" (supported: {TECHNIQUES})")
        self.coding_matrix = coding
        self.engine = MatrixECEngine(coding, self.k, self.m, device=device)

    def get_alignment(self) -> int:
        """Bitmatrix codes need chunk % w == 0 (w packets per chunk);
        k·w·4 mirrors jerasure's alignment formula for all techniques."""
        return self.k * self.w * 4

    def _encode_chunks(self, data: np.ndarray) -> np.ndarray:
        return self.engine.encode(data)

    def _decode_chunks(self, chunks, chunk_size, want=None):
        if len(chunks) < self.k:
            raise ECError(f"{len(chunks)} chunks < k={self.k}")
        return self.engine.decode(chunks, chunk_size)
