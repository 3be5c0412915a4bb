"""Clay (coupled-layer) MSR erasure code — port of ``ceph_tpu.ec.clay``
(reference ``src/erasure-code/clay/ErasureCodeClay.{h,cc}``).

Clay runs on the host in numpy, as in ceph_tpu: its plane-by-plane
layered decode goes through ``rs.decode_oracle`` and launches no
kernel.  The ``device`` argument of the plugin factory is accepted and
not used.

Clay codes mould an MDS code into a *minimum storage regenerating* (MSR)
code: repairing ONE lost chunk reads only ``d * q^(t-1)`` sub-chunks
instead of ``k * q^t`` — a ``d/(k*(d-k+1))`` bandwidth ratio (FAST '18,
"Clay Codes: Moulding MDS Codes to Yield Vector MDS Codes with Optimal
Repair").  This is why the reference's ``minimum_to_decode`` grows
sub-chunk ranges for this plugin.

Construction (re-created from the published algorithm, NOT a translation —
the reference mount was empty, so byte-exactness to the reference plugin is
untestable; correctness is established by MDS round-trips over all erasure
patterns and by the repair-bandwidth property test):

- parameters ``k, m, d`` with ``k+1 <= d <= k+m-1`` (default ``k+m-1``);
  ``q = d-k+1``; the ``n = k+m`` chunks (padded with ``nu`` virtual
  always-zero chunks until ``q | n+nu``) sit on a ``q x t`` grid,
  ``t = (n+nu)/q``; chunk index ``c`` -> grid ``(x, y) = (c % q, c // q)``.
- each chunk is a vector of ``q^t`` sub-chunks; sub-chunk ``z`` has digits
  ``z_y`` (digit ``y`` weighted ``q^(t-1-y)``).
- *pairing*: symbol ``(x, y; z)`` with ``x != z_y`` couples with
  ``(z_y, y; z')`` where ``z' = z`` with digit ``y`` set to ``x``;
  symbols with ``x == z_y`` (dots) are uncoupled.  Coupled values C and
  uncoupled values U relate through the invertible pair transform
  ``C_a = U_a + theta*U_b``, ``C_b = theta*U_a + U_b`` over GF(2^8)
  (members ordered by grid x; ``det = 1 + theta^2 != 0`` for theta != 1).
- the code is defined by: every *uncoupled* plane ``{U(x,y;z)}_xy`` is a
  codeword of the scalar MDS code (reed_sol_van over k+nu data, m parity).

Decode walks planes in increasing *intersection score* (number of erased
grid positions hit by the plane's dots), recovering U everywhere, then
rebuilds C at erased positions — ``decode_layered`` in the reference.
"""

from __future__ import annotations

import numpy as np

from ..ops import gf, rs
from .interface import ECError, ECProfile, ErasureCodeInterface

THETA = 2  # pair-transform coefficient; any theta != 0,1 works
_DET_INV = gf.gf_inv(1 ^ gf.gf_mul(THETA, THETA))  # 1/(1+theta^2)
_THETA_INV = gf.gf_inv(THETA)


class ErasureCodeClay(ErasureCodeInterface):
    def __init__(self, profile: ECProfile, device=None):
        self.profile = profile
        self.k = profile.k
        self.m = profile.m
        self.d = int(profile.extra.get("d", self.k + self.m - 1))
        if not (self.k + 1 <= self.d <= self.k + self.m - 1):
            raise ECError(
                f"clay requires k+1 <= d <= k+m-1, got k={self.k} "
                f"m={self.m} d={self.d}")
        self.q = self.d - self.k + 1
        n = self.k + self.m
        self.nu = (-n) % self.q          # virtual zero chunks (shortening)
        self.t = (n + self.nu) // self.q
        self.sub_chunk_count = self.q ** self.t
        # scalar MDS base code over the padded grid: k+nu data, m parity.
        # Chunk ids: 0..k-1 real data, k..k+nu-1 virtual (zero),
        # k+nu..k+nu+m-1 parity (real parity chunks k..k+m-1 shifted up).
        self.k_pad = self.k + self.nu
        scalar = profile.extra.get("scalar_mds", "jerasure")
        if scalar not in ("jerasure", "isa"):
            raise ECError(f"clay scalar_mds must be jerasure or isa,"
                          f" got {scalar!r}")
        if scalar == "isa":
            self.base_coding = rs.isa_rs_van_matrix(self.k_pad, self.m)
        else:
            self.base_coding = rs.reed_sol_van_matrix(self.k_pad, self.m)
        self._powers = [self.q ** (self.t - 1 - y) for y in range(self.t)]

    # -- geometry ----------------------------------------------------------
    def get_alignment(self) -> int:
        return self.k * self.sub_chunk_count

    def get_sub_chunk_count(self) -> int:
        return self.sub_chunk_count

    # -- grid / plane helpers ---------------------------------------------
    def _grid(self, c: int) -> tuple[int, int]:
        """Padded chunk id -> (x, y). Real ids 0..k-1 map directly; real
        parity ids k..k+m-1 live at padded ids k+nu..; virtual at k..k+nu-1."""
        return c % self.q, c // self.q

    def _pad_id(self, c: int) -> int:
        return c if c < self.k else c + self.nu

    def _real_id(self, cpad: int) -> int | None:
        if cpad < self.k:
            return cpad
        if cpad < self.k_pad:
            return None  # virtual
        return cpad - self.nu

    def _digit(self, z: int, y: int) -> int:
        return (z // self._powers[y]) % self.q

    def _set_digit(self, z: int, y: int, v: int) -> int:
        return z + (v - self._digit(z, y)) * self._powers[y]

    def _iscore(self, z: int, erased_pad: set[int]) -> int:
        return sum(1 for c in erased_pad
                   if self._digit(z, self._grid(c)[1]) == self._grid(c)[0])

    # -- pair transform ----------------------------------------------------
    @staticmethod
    def _pair_u(c_a, c_b):
        """Coupled pair -> uncoupled pair (canonical a,b order)."""
        u_a = gf.gf_mul(c_a ^ gf.gf_mul(THETA, c_b), _DET_INV)
        u_b = gf.gf_mul(gf.gf_mul(THETA, c_a) ^ c_b, _DET_INV)
        return u_a, u_b

    @staticmethod
    def _pair_c(u_a, u_b):
        c_a = u_a ^ gf.gf_mul(THETA, u_b)
        c_b = gf.gf_mul(THETA, u_a) ^ u_b
        return c_a, c_b

    def _companion(self, cpad: int, z: int) -> tuple[int, int]:
        """(padded chunk, plane) of the pair partner of (cpad, z)."""
        x, y = self._grid(cpad)
        zy = self._digit(z, y)
        return zy + y * self.q, self._set_digit(z, y, x)

    # -- layered decode (the engine behind encode AND decode) -------------
    def _decode_layered(self, coupled: dict[int, np.ndarray],
                        erased_real: list[int],
                        sub_size: int) -> dict[int, np.ndarray]:
        """coupled: real chunk id -> [sub_chunk_count, sub_size] uint8 for
        every NON-erased real chunk.  Returns the erased chunks' coupled
        arrays.  Mirrors the reference's ``decode_layered``: erasures are
        padded up to exactly m so every uncoupled plane has m unknowns."""
        erased_pad = {self._pad_id(c) for c in erased_real}
        if len(erased_pad) > self.m:
            raise ECError(f"{len(erased_pad)} erasures > m={self.m}")
        for c in range(self.k + self.m - 1, -1, -1):
            if len(erased_pad) == self.m:
                break
            erased_pad.add(self._pad_id(c))
        npad = self.k_pad + self.m
        zeros = np.zeros((self.sub_chunk_count, sub_size), dtype=np.uint8)

        def C(cpad, z):
            real = self._real_id(cpad)
            if real is None:
                return zeros[z]
            return coupled[real][z]

        # pass 1: uncoupled values everywhere, planes by intersection score
        U = {}  # (cpad, z) -> [sub_size] uint8
        planes = sorted(range(self.sub_chunk_count),
                        key=lambda z: self._iscore(z, erased_pad))
        for z in planes:
            avail = {}
            for cpad in range(npad):
                if cpad in erased_pad:
                    continue
                x, y = self._grid(cpad)
                if (cpad, z) in U:                    # pair partner visited
                    avail[cpad] = U[cpad, z]
                    continue
                if self._digit(z, y) == x:           # dot: uncoupled
                    U[cpad, z] = C(cpad, z)
                    avail[cpad] = U[cpad, z]
                    continue
                comp, z2 = self._companion(cpad, z)
                if comp not in erased_pad:
                    c_self, c_comp = C(cpad, z), C(comp, z2)
                    if x < self._grid(comp)[0]:
                        u, u_other = self._pair_u(c_self, c_comp)
                    else:
                        u_other, u = self._pair_u(c_comp, c_self)
                    U[comp, z2] = u_other             # cache: pair solved once
                else:
                    # companion erased: its U in plane z2 was already
                    # produced by the MDS step of a lower-score plane.
                    # Both orderings reduce to U_self = C_self + theta*U_comp.
                    u = C(cpad, z) ^ gf.gf_mul(THETA, U[comp, z2])
                U[cpad, z] = u
                avail[cpad] = u
            full = rs.decode_oracle(self.base_coding, self.k_pad, avail,
                                    sub_size)
            for cpad in erased_pad:
                U[cpad, z] = full[cpad]

        # pass 2: coupled values at the erased positions
        out = {}
        for c in erased_real:
            cpad = self._pad_id(c)
            x, y = self._grid(cpad)
            arr = np.empty((self.sub_chunk_count, sub_size), dtype=np.uint8)
            for z in range(self.sub_chunk_count):
                if self._digit(z, y) == x:
                    arr[z] = U[cpad, z]
                    continue
                comp, z2 = self._companion(cpad, z)
                u_self, u_comp = U[cpad, z], U[comp, z2]
                if x < self._grid(comp)[0]:
                    arr[z] = self._pair_c(u_self, u_comp)[0]
                else:
                    arr[z] = self._pair_c(u_comp, u_self)[1]
            out[c] = arr
        return out

    # -- ErasureCodeInterface ---------------------------------------------
    def _as_planes(self, chunk: np.ndarray) -> np.ndarray:
        if chunk.size % self.sub_chunk_count:
            raise ECError(
                f"chunk size {chunk.size} not divisible by sub-chunk count "
                f"{self.sub_chunk_count}")
        return chunk.reshape(self.sub_chunk_count, -1)

    def _encode_chunks(self, data: np.ndarray) -> np.ndarray:
        coupled = {i: self._as_planes(data[i]) for i in range(self.k)}
        sub_size = data.shape[1] // self.sub_chunk_count
        parity = self._decode_layered(
            coupled, list(range(self.k, self.k + self.m)), sub_size)
        return np.stack([parity[self.k + j].reshape(-1)
                         for j in range(self.m)])

    def _decode_chunks(self, chunks, chunk_size, want=None):
        erased = [c for c in range(self.k + self.m) if c not in chunks]
        coupled = {i: self._as_planes(np.asarray(buf, dtype=np.uint8))
                   for i, buf in chunks.items()}
        sub_size = chunk_size // self.sub_chunk_count
        rec = self._decode_layered(coupled, erased, sub_size)
        out = {i: np.asarray(chunks[i], dtype=np.uint8).reshape(-1)
               for i in chunks}
        for c, arr in rec.items():
            out[c] = arr.reshape(-1)
        return out

    # -- MSR repair: the reason this plugin exists -------------------------
    def is_repair(self, want_to_read: set[int], available: set[int]) -> bool:
        """True when the bandwidth-optimal repair path applies: one chunk
        actually lost (wanted and NOT available), all other k+m-1 chunks up
        (the d = k+m-1 case; smaller d falls back to conventional decode,
        as noted in the class docs)."""
        return (len(want_to_read) == 1 and self.d == self.k + self.m - 1
                and not (want_to_read & available)
                and len(available & (set(range(self.k + self.m))
                                     - want_to_read)) == self.k + self.m - 1)

    def repair_planes(self, lost: int) -> list[int]:
        """The q^(t-1) plane indices helpers must send for ``lost``."""
        x0, y0 = self._grid(self._pad_id(lost))
        return [z for z in range(self.sub_chunk_count)
                if self._digit(z, y0) == x0]

    def minimum_to_decode_with_subchunks(
            self, want_to_read: set[int], available: set[int],
    ) -> dict[int, list[tuple[int, int]]]:
        """Reference ``minimum_to_decode`` with sub-chunk ranges: maps each
        needed chunk -> list of (sub_chunk_index, count) runs.  For the
        repair case only q^(t-1) of the q^t sub-chunks are read."""
        if self.is_repair(want_to_read, available):
            lost = next(iter(want_to_read))
            helpers = sorted(available - {lost})
            runs = _runs(self.repair_planes(lost))
            return {h: list(runs) for h in helpers}
        need = self.minimum_to_decode(want_to_read, available)
        return {c: [(0, self.sub_chunk_count)] for c in need}

    def repair_chunk(self, lost: int,
                     helper_subchunks: dict[int, np.ndarray],
                     chunk_size: int) -> np.ndarray:
        """Recover chunk ``lost`` from the repair-plane sub-chunks of the
        other k+m-1 chunks.  ``helper_subchunks[h]`` is
        [q^(t-1), sub_size] — chunk h's sub-chunks at ``repair_planes``
        indices, in order.  Reads d*q^(t-1) sub-chunks total vs k*q^t for
        conventional decode."""
        if chunk_size % self.sub_chunk_count:
            raise ECError(
                f"chunk size {chunk_size} not divisible by sub-chunk count "
                f"{self.sub_chunk_count}")
        x0, y0 = self._grid(self._pad_id(lost))
        planes = self.repair_planes(lost)
        plane_pos = {z: i for i, z in enumerate(planes)}
        sub_size = chunk_size // self.sub_chunk_count
        zeros = np.zeros(sub_size, dtype=np.uint8)
        npad = self.k_pad + self.m

        def C(cpad, z):
            real = self._real_id(cpad)
            if real is None:
                return zeros
            return np.asarray(helper_subchunks[real][plane_pos[z]],
                              dtype=np.uint8)

        lost_pad = self._pad_id(lost)
        U = {}
        # 1. per repair plane: uncouple row-wise pairs (their companions are
        #    also repair planes), MDS-decode column y0 (exactly m=q unknowns)
        for z in planes:
            avail = {}
            for cpad in range(npad):
                x, y = self._grid(cpad)
                if y == y0:
                    continue  # the erased column
                if self._digit(z, y) == x:
                    u = C(cpad, z)
                else:
                    comp, z2 = self._companion(cpad, z)
                    c_self, c_comp = C(cpad, z), C(comp, z2)
                    if x < self._grid(comp)[0]:
                        u, _ = self._pair_u(c_self, c_comp)
                    else:
                        _, u = self._pair_u(c_comp, c_self)
                avail[cpad] = u
            full = rs.decode_oracle(self.base_coding, self.k_pad, avail,
                                    sub_size)
            for x in range(self.q):
                U[x + y0 * self.q, z] = full[x + y0 * self.q]

        # 2. lost sub-chunks: repair planes are dots (C = U); each non-repair
        #    plane pairs the lost symbol with a column-y0 symbol in a repair
        #    plane whose C was read and U was decoded above.
        out = np.empty((self.sub_chunk_count, sub_size), dtype=np.uint8)
        for z in range(self.sub_chunk_count):
            if self._digit(z, y0) == x0:
                out[z] = U[lost_pad, z]
                continue
            comp, z2 = self._companion(lost_pad, z)  # z2 is a repair plane
            c_comp, u_comp = C(comp, z2), U[comp, z2]
            # companion's own pair equation gives (either ordering)
            # U_lost = (C_comp + U_comp) / theta; then re-couple for C_lost.
            u_self = gf.gf_mul(c_comp ^ u_comp, _THETA_INV)
            if x0 < self._grid(comp)[0]:
                out[z] = self._pair_c(u_self, u_comp)[0]
            else:
                out[z] = self._pair_c(u_comp, u_self)[1]
        return out.reshape(-1)


def _runs(indices: list[int]) -> list[tuple[int, int]]:
    """Sorted indices -> (start, count) runs."""
    runs: list[tuple[int, int]] = []
    for i in indices:
        if runs and runs[-1][0] + runs[-1][1] == i:
            runs[-1] = (runs[-1][0], runs[-1][1] + 1)
        else:
            runs.append((i, 1))
    return runs
