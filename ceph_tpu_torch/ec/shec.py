"""Shingled erasure code plugin — port of ``ceph_tpu.ec.shec``
(reference: ``src/erasure-code/shec/``).

SHEC(k, m, c) trades durability for repair cost: each of the m parity
chunks covers a *shingled window* of consecutive data chunks rather than
all k, so repairing one lost chunk reads only the chunks of one window.
Window geometry follows the SHEC paper (Miyamae et al.): window length
``ceil(k*c/m)``, window ``i`` starting at ``floor(i*k/m)`` with wraparound.
Coefficients inside a window are Vandermonde rows (powers of 2^i), giving
the multiple-SHEC construction; recovery uses a general GF(2^8) linear
solve, since the code is deliberately not MDS.

``minimum_to_decode`` performs the reference's minimisation: start from
all available chunks and greedily drop reads while the wanted chunks stay
recoverable.

Encode and the parity re-encode after a decode run on the port's
`MatrixECEngine` (the ``gf_words`` kernel on the card); the linear
solve for missing data runs on the host in numpy, as in ceph_tpu.
"""

from __future__ import annotations

import numpy as np

from ..ops import rs
from ..ops.gf import gf_mul, gf_pow
from .interface import ECError, ECProfile, ErasureCodeInterface
from .torch_backend import MatrixECEngine


def shec_matrix(k: int, m: int, c: int) -> np.ndarray:
    """[m, k] coding matrix with shingled zero structure."""
    if not (0 < c <= m <= k):
        raise ECError(f"SHEC requires 0 < c <= m <= k, got k={k} m={m} c={c}")
    wlen = -(-k * c // m)  # ceil(k*c/m)
    mat = np.zeros((m, k), dtype=np.uint8)
    for i in range(m):
        start = (i * k) // m
        for t in range(wlen):
            j = (start + t) % k
            mat[i, j] = gf_pow(2, ((i + 1) * j) % 255) or 1
    return mat


class ErasureCodeShec(ErasureCodeInterface):
    is_mds = False  # shingled parities: not every k-subset decodes

    def __init__(self, profile: ECProfile, device=None):
        self.profile = profile
        self.k = profile.k
        self.m = profile.m
        self.c = int(profile.extra.get("c", 1))
        self.coding_matrix = shec_matrix(self.k, self.m, self.c)
        self.engine = MatrixECEngine(self.coding_matrix, self.k, self.m,
                                     device=device)
        # generator rows: identity (data) then coding rows
        self._gen = np.concatenate(
            [np.eye(self.k, dtype=np.uint8), self.coding_matrix])

    def _encode_chunks(self, data: np.ndarray) -> np.ndarray:
        return self.engine.encode(data)

    def _recoverable(self, available: set[int],
                     want: set[int]) -> bool:
        """Can ``want`` be derived from ``available`` chunk ids?"""
        missing_data = [j for j in range(self.k) if j not in available]
        if not missing_data:
            return want <= (available | set(range(self.k + self.m)))
        rows = []
        for i in sorted(available):
            rows.append(self._gen[i])
        A = np.stack(rows)  # [n_avail, k]
        sub = A[:, missing_data]
        # unique solvability of the missing data = full column rank of sub
        return rs.solve_gf_system(
            sub, np.zeros((sub.shape[0], 1), dtype=np.uint8)) is not None

    def _decode_chunks(self, chunks, chunk_size, want=None):
        available = set(chunks)
        missing_data = [j for j in range(self.k) if j not in available]
        data = np.zeros((self.k, chunk_size), dtype=np.uint8)
        for j in range(self.k):
            if j in chunks:
                data[j] = chunks[j]
        if missing_data:
            # equations from available parity rows: sum coeff_j d_j = parity
            eqs, rhs = [], []
            for i in sorted(available):
                if i < self.k:
                    continue
                row = self._gen[i]
                acc = np.asarray(chunks[i], dtype=np.uint8).copy()
                for j in range(self.k):
                    if j not in missing_data and row[j]:
                        acc ^= gf_mul(row[j], data[j])
                eqs.append(row[missing_data])
                rhs.append(acc)
            if not eqs:
                raise ECError("SHEC: no parity available for missing data")
            sol = rs.solve_gf_system(np.stack(eqs), np.stack(rhs))
            if sol is None:
                raise ECError("SHEC: available chunks insufficient to decode")
            for idx, j in enumerate(missing_data):
                data[j] = sol[idx]
        out = {j: data[j] for j in range(self.k)}
        parity = self.engine.encode(data)
        for i in range(self.m):
            out[self.k + i] = (np.asarray(chunks[self.k + i], dtype=np.uint8)
                               if self.k + i in chunks else parity[i])
        return out

    def minimum_to_decode(self, want_to_read, available):
        if want_to_read <= available:
            return set(want_to_read)
        want = set(want_to_read)
        if not self._recoverable(available, want):
            raise ECError("SHEC: wanted chunks unrecoverable from available")
        # greedy minimisation: drop reads while the wanted set stays
        # recoverable (wanted chunks present in the set are read directly,
        # so they are never dropped)
        minimum = set(available)
        for i in sorted(available, reverse=True):
            if i in want:
                continue
            trial = minimum - {i}
            if self._recoverable(trial, want):
                minimum = trial
        return minimum
