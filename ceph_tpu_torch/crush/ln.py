"""Fixed-point log2 for straw2 — `crush_ln` and its lookup tables.

Reference: `crush_ln()` in `src/crush/mapper.c` with tables in
`src/crush/crush_ln_table.h` (SURVEY.md §3.3).  The tables have closed
forms (documented in the reference header comments):

- ``RH_LH_tbl[2k]   = round(2^48 / (1 + k/2^7))``   (reciprocal, k=0..128)
- ``RH_LH_tbl[2k+1] = round(2^48 * log2(1 + k/2^7))`` (coarse log)
- ``LL_tbl[j]       = round(2^48 * log2(1 + j/2^15))`` (fine log, j=0..255)

They are generated here at import time with 50-digit Decimal precision so
rounding is exact, instead of copying 770 constants.  NOTE (SURVEY.md §0):
the reference mount was empty, so the reference's exact rounding mode
could not be byte-verified; round-half-up is used and must be re-checked
against `crush_ln_table.h` when the mount is populated.

`crush_ln(x)` maps x∈[0, 0xffff] → [0, 2^48], fixed point with 2^44 per
octave: conceptually ``2^44 * log2(x+1)``.  straw2 uses
``ln = crush_ln(u) - 2^48`` (a negative log of a uniform draw) divided by
the 16.16 item weight.

Known approximation artifact (present in the reference algorithm too):
at coarse-segment boundaries where RH rounds below the exact reciprocal,
``xl64`` truncates to 0x7fff instead of 0x8000 and the fine-table index
wraps to 255, overshooting by ≈ 2^48·log2(1+255/2^15)/16 ≈ 2e11 (~0.011
octave).  ~410 of 65536 inputs are affected; straw2 only needs an
approximately-log map, and the reference keeps the glitch ("probably a
rounding effect" — straw2 comment), so we reproduce rather than repair
it.

Vectorized NumPy: works elementwise on arrays; the batched mapper
reads the same values from one 64 Ki-entry table (`straw2.ln16_s_table`).
"""

from __future__ import annotations

from decimal import Decimal, getcontext

import numpy as np


def _gen_tables() -> tuple[np.ndarray, np.ndarray]:
    getcontext().prec = 50
    ln2 = Decimal(2).ln()
    two48 = Decimal(2) ** 48

    def log2d(v: Decimal) -> Decimal:
        return v.ln() / ln2

    def rnd(v: Decimal) -> int:
        return int((v + Decimal("0.5")).to_integral_value(rounding="ROUND_FLOOR"))

    rh_lh = np.zeros(2 * 129, dtype=np.uint64)
    for k in range(129):
        frac = Decimal(1) + Decimal(k) / 128
        rh_lh[2 * k] = rnd(two48 / frac)
        rh_lh[2 * k + 1] = rnd(two48 * log2d(frac))
    ll = np.zeros(256, dtype=np.uint64)
    for j in range(256):
        ll[j] = rnd(two48 * log2d(Decimal(1) + Decimal(j) / (1 << 15)))
    return rh_lh, ll


RH_LH_TBL, LL_TBL = _gen_tables()


def crush_ln(xin):
    """Fixed-point 2^44·log2(x+1) for x in [0, 0xffff]. Vectorized.

    Returns uint64 in [0, 2^48].
    """
    x = np.asarray(xin, dtype=np.uint64) + 1  # [1, 0x10000]
    # normalize so x has its top bit at position 15 or 16 (C: while !(x & 0x18000))
    m, e = np.frexp(x.astype(np.float64))     # exact for x < 2^53
    floor_log2 = e.astype(np.int64) - 1
    bits = np.maximum(0, 15 - floor_log2).astype(np.uint64)
    x = x << bits
    iexpon = (15 - bits.astype(np.int64)).astype(np.uint64)

    index1 = (x >> 8) << 1                    # [256, 512]
    rh = RH_LH_TBL[(index1 - 256).astype(np.int64)]
    lh = RH_LH_TBL[(index1 + 1 - 256).astype(np.int64)]

    xl64 = (x * rh) >> 48                     # ≈ 2^15 + xf, xf < 2^8
    index2 = (xl64 & 0xFF).astype(np.int64)
    ll = LL_TBL[index2]

    result = iexpon << 44
    result = result + ((lh + ll) >> 4)        # >> (48 - 12 - 32)
    return result if isinstance(xin, np.ndarray) else np.uint64(result)
