"""Bit-matrix XOR erasure codes — liberation / liber8tion / blaum_roth —
port of ``ceph_tpu.ec.bitmatrix``.

RAID-6 (m=2) codes whose generator is a GF(2) matrix of w×w bit blocks
(reference: ``src/erasure-code/jerasure`` techniques backed by
jerasure's ``liberation.c``), so encode and decode are pure XOR of
*packets*.  Each chunk is w packets of ``chunk_size/w`` bytes; parity
packet r is the XOR of the data packets its bitmatrix row selects.

The constructions, :func:`encode_oracle` and :func:`_gf2_inv` are
copies of ceph_tpu's; see there for their provenance (liber8tion uses
the companion matrix of 0x11d, not Plank's searched matrices).

The packet product runs on the card through the ``gf2_packets`` kernel
(``csrc/gf2_packets.cu``, K10), which replaces ceph_tpu's ``jnp``
program ``BitMatrixECEngine._jit_apply.go``.  Its plain version,
:func:`gf2_packets_plain`, is that program's twin: bit planes, a float32
matmul of 0/1 values (exact: counts stay below 2^24), ``& 1`` and a
repack.  A CPU tensor takes the plain version; a CUDA tensor launches
the kernel or raises.  ``BitMatrixECEngine.HOST_THRESHOLD`` keeps
ceph_tpu's size policy: a host array under 1 MiB runs in numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import build
from ..ops.gf_torch import to_device
from ..utils.device import resolve_device
from .interface import ECError

# K10 BitMatrixECEngine._jit_apply.go
GF2_PACKETS = build.register(
    "gf2_packets", "ceph_tpu_torch/csrc/gf2_packets.cu",
    "ceph_tpu/ec/bitmatrix.py:216")

_WORD = 4


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    return all(n % p for p in range(2, int(n ** 0.5) + 1))


def default_w(technique: str, k: int) -> int:
    """Smallest valid word size for a technique (profiles may override
    with w=...; the reference errors on invalid combos the same way)."""
    if technique == "liber8tion":
        return 8
    if technique == "liberation":
        w = max(k, 3) | 1            # odd start
        while not _is_prime(w):
            w += 2
        return w
    if technique == "blaum_roth":
        w = max(k, 2)
        while not _is_prime(w + 1):
            w += 1
        return w
    raise ECError(f"unknown bitmatrix technique {technique!r}")


def liberation_bitmatrix(k: int, w: int) -> np.ndarray:
    """[2w, kw] GF(2) coding matrix (parity rows only)."""
    if not _is_prime(w):
        raise ECError(f"liberation needs prime w (got {w})")
    if k > w:
        raise ECError(f"liberation needs k <= w ({k} > {w})")
    mat = np.zeros((2 * w, k * w), dtype=np.int8)
    for i in range(k):
        for j in range(w):
            mat[j, i * w + j] = 1                       # P: plain XOR
            mat[w + j, i * w + (j + i) % w] = 1         # Q: row j ←
            # chunk i packet (j+i) mod w
        if i > 0:
            jx = (i * ((w - 1) // 2)) % w
            mat[w + jx, i * w + (jx + i - 1) % w] = 1   # the extra bit
    return mat


def _companion_powers_bitmatrix(companion: np.ndarray, k: int,
                                w: int) -> np.ndarray:
    """[2w, kw]: P rows = identities, Q column block i = companionⁱ."""
    mat = np.zeros((2 * w, k * w), dtype=np.int8)
    blk = np.eye(w, dtype=np.int8)
    for i in range(k):
        mat[:w, i * w: (i + 1) * w] = np.eye(w, dtype=np.int8)
        mat[w:, i * w: (i + 1) * w] = blk
        blk = (companion @ blk) & 1
    return mat


def blaum_roth_bitmatrix(k: int, w: int) -> np.ndarray:
    if not _is_prime(w + 1):
        raise ECError(f"blaum_roth needs w+1 prime (got w={w})")
    if k > w:
        raise ECError(f"blaum_roth needs k <= w ({k} > {w})")
    # multiply-by-x companion matrix in GF(2)[x]/(1+x+...+x^w)
    B = np.zeros((w, w), dtype=np.int8)
    for j in range(w - 1):
        B[j + 1, j] = 1
    B[:, w - 1] = 1                  # x^w = 1 + x + ... + x^(w-1)
    return _companion_powers_bitmatrix(B, k, w)


def liber8tion_bitmatrix(k: int) -> np.ndarray:
    w = 8
    if k > w:
        raise ECError(f"liber8tion needs k <= 8 (got {k})")
    # companion matrix of x^8 + x^4 + x^3 + x^2 + 1 (0x11d)
    C = np.zeros((w, w), dtype=np.int8)
    for j in range(w - 1):
        C[j + 1, j] = 1
    for bit in range(w):
        if (0x1D >> bit) & 1:
            C[bit, w - 1] = 1
    return _companion_powers_bitmatrix(C, k, w)


def build_bitmatrix(technique: str, k: int, w: int | None) -> \
        tuple[np.ndarray, int]:
    w = w or default_w(technique, k)
    if technique == "liberation":
        return liberation_bitmatrix(k, w), w
    if technique == "blaum_roth":
        return blaum_roth_bitmatrix(k, w), w
    if technique == "liber8tion":
        if w != 8:
            raise ECError("liber8tion requires w=8")
        return liber8tion_bitmatrix(k), 8
    raise ECError(f"unknown bitmatrix technique {technique!r}")


def encode_oracle(coding_bits: np.ndarray, data: np.ndarray,
                  w: int) -> np.ndarray:
    """Scalar row-walk XOR oracle (independent of the kernel path):
    data [k, C] → parity [m, C]."""
    k = data.shape[0]
    C = data.shape[1]
    words = data.reshape(k * w, C // w)
    mw = coding_bits.shape[0]
    out = np.zeros((mw, C // w), dtype=np.uint8)
    for r in range(mw):
        for c in range(k * w):
            if coding_bits[r, c]:
                out[r] ^= words[c]
    return out.reshape(mw // w, C)


def _gf2_inv(a: np.ndarray) -> np.ndarray:
    """Invert a square GF(2) matrix (Gaussian elimination)."""
    n = a.shape[0]
    aug = np.concatenate([a.astype(np.int8) & 1,
                          np.eye(n, dtype=np.int8)], axis=1)
    for col in range(n):
        piv = next((r for r in range(col, n) if aug[r, col]), None)
        if piv is None:
            raise ECError("bitmatrix submatrix is singular")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        hits = (aug[:, col] == 1)
        hits[col] = False
        aug[hits] ^= aug[col]
    return aug[:, n:]


# -- K10: the GF(2) packet product ----------------------------------------

_CHUNK = 48         # input packets the kernel stages per pass


def xor_schedule(mat: np.ndarray, chunk: int = _CHUNK) -> np.ndarray:
    """The ``gf2_packets`` kernel's XOR schedule of a 0/1 selector
    ``[R, N]``, as one int32 array: ``ceil(N / chunk) * R + 1`` CSR
    offsets, entry ``pass * R + r`` starting row r's list for the pass
    over input packets ``[pass * chunk, (pass + 1) * chunk)``; then the
    lists, each input packet as its index within its pass
    (``c - pass * chunk``).

    Jerasure's ``jerasure_dumb_bitmatrix_to_schedule``: one entry per
    one of the matrix, in column order; a row with one entry is a
    copy."""
    sel = np.asarray(mat) & 1
    rows, n = sel.shape
    offsets, entries = [0], []
    for c0 in range(0, n, chunk):
        for r in range(rows):
            cols = np.flatnonzero(sel[r, c0:c0 + chunk])
            entries.extend(cols.tolist())
            offsets.append(len(entries))
    return np.asarray(offsets + entries, dtype=np.int32)


def gf2_packets_plain(mat: np.ndarray, words: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gf2_packets` (twin of ceph_tpu's ``go``)."""
    dev = words.device
    sel = torch.from_numpy(np.asarray(mat, dtype=np.float32)).to(dev)
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    bits = (words.unsqueeze(-1) >> shifts) & 1           # [..., N, pw, 8]
    bits = bits.reshape(*words.shape[:-1], -1).to(torch.float32)
    acc = (sel @ bits).to(torch.int32) & 1               # [..., R, 8 pw]
    acc = acc.reshape(*acc.shape[:-1], words.shape[-1], 8)
    wshift = torch.arange(8, dtype=torch.int32, device=dev)
    return (acc << wshift).sum(-1).to(torch.uint8)


def gf2_packets(mat: np.ndarray, words: torch.Tensor,
                cache: dict | None = None) -> torch.Tensor:
    """GF(2) selector ``[R, N]`` 0/1 times packets ``[..., N, pw]``
    uint8 → ``[..., R, pw]`` uint8 (K10), un-fenced.  ``cache`` holds
    the selector's device schedule (:func:`xor_schedule`) across
    calls."""
    mat = np.ascontiguousarray(np.asarray(mat) & 1, dtype=np.int8)
    rows, n = mat.shape
    if words.dtype != torch.uint8 or words.dim() < 2 \
            or words.shape[-2] != n:
        raise ValueError(f"gf2_packets: want [..., {n}, pw] uint8, got "
                         f"{words.dtype} {tuple(words.shape)}")
    if words.device.type == "cpu":
        return gf2_packets_plain(mat, words)
    if not words.is_cuda:
        raise ValueError(f"gf2_packets: unsupported device {words.device}")
    lead, pw = words.shape[:-2], words.shape[-1]
    x = words.reshape(-1, n, pw)
    pad = -pw % _WORD
    if pad or not x.is_contiguous() or x.data_ptr() % _WORD:
        x = torch.nn.functional.pad(x, (0, pad)).contiguous()
    bsz, _, pwp = x.shape
    if bsz * pwp * rows * n == 0:
        return torch.zeros(*lead, rows, pw, dtype=torch.uint8,
                           device=words.device)
    sched = build.device_table(
        {} if cache is None else cache, ("schedule", mat.shape,
                                         mat.tobytes()),
        lambda: xor_schedule(mat), words.device)
    out = torch.empty(bsz, rows, pwp, dtype=torch.uint8, device=words.device)
    rc = build.library().ctt_gf2_packets(
        x.data_ptr(), out.data_ptr(), sched.data_ptr(), sched.numel(), bsz,
        rows, n, min(n, _CHUNK), pwp // _WORD, build.stream_ptr(words.device))
    build.check(rc, "gf2_packets")
    GF2_PACKETS.count()
    if pad:
        out = out[..., :pw]
    return out.reshape(*lead, rows, pw)


class BitMatrixECEngine:
    """Encode/decode one bitmatrix code on ``device`` (``None`` → the
    card); same duck type as `MatrixECEngine` (encode, encode_device,
    decode, decode_batch, decode_device).

    Data layout: a chunk of C bytes is w packets of C/w bytes; the
    word vector stacks chunk-major (chunk i packet j = row i·w+j),
    matching jerasure's ``jerasure_bitmatrix_encode`` addressing.
    """

    # Below this many input bytes a host array's XOR fan-in runs as a
    # numpy matmul (ceph_tpu's policy: a launch costs more than the
    # work); larger payloads and device tensors go to the device.
    HOST_THRESHOLD = 1 << 20

    def __init__(self, coding_bits: np.ndarray, k: int, w: int,
                 device=None):
        self.k, self.w = k, w
        self.mw, kw = coding_bits.shape
        self.m = self.mw // w
        if kw != k * w:
            raise ValueError(f"coding bits {coding_bits.shape} are not "
                             f"[m·{w}, {k}·{w}]")
        self.coding_bits = coding_bits.astype(np.int8)
        self.device = resolve_device(device)
        # full generator: data rows (identity) then parity rows
        self.generator = np.concatenate(
            [np.eye(k * w, dtype=np.int8), self.coding_bits], axis=0)
        # erasure tuple → (inverse matrix, survivor chunk ids)
        self._inverses: dict[tuple[int, ...],
                             tuple[np.ndarray, list[int]]] = {}
        self._schedules: dict = {}      # XOR schedules on the device

    @staticmethod
    def _apply_np(mat: np.ndarray, words: np.ndarray) -> np.ndarray:
        bits = np.unpackbits(words, axis=-1, bitorder="little")
        acc = (mat.astype(np.int32) @ bits.astype(np.int32)) & 1
        return np.packbits(acc.astype(np.uint8), axis=-1,
                           bitorder="little")

    def _apply(self, mat: np.ndarray, words, device: bool = False):
        """mat [R, N] 0/1 · words [..., N, pw] uint8 → [..., R, pw]: a
        numpy array, or with ``device`` the engine's un-fenced
        tensor."""
        if (not device and isinstance(words, np.ndarray)
                and words.size < self.HOST_THRESHOLD):
            return self._apply_np(mat, words)
        out = gf2_packets(mat, to_device(words, self.device),
                          self._schedules)
        return out if device else out.cpu().numpy()

    def _to_words(self, data):
        """[..., k, C] → [..., k·w, C/w] (numpy array or tensor)."""
        C = data.shape[-1]
        if C % self.w:
            raise ECError(f"chunk size {C} not a multiple of w={self.w}")
        if not isinstance(data, torch.Tensor):
            data = np.asarray(data, dtype=np.uint8)
        return data.reshape(*data.shape[:-2], data.shape[-2] * self.w,
                            C // self.w)

    # -- encode ------------------------------------------------------------
    def encode(self, data: np.ndarray) -> np.ndarray:
        """[k, C] or [B, k, C] uint8 → parity of matching batch shape."""
        C = data.shape[-1]
        parity = self._apply(self.coding_bits, self._to_words(data))
        return parity.reshape(*data.shape[:-2], self.m, C)

    def encode_device(self, data) -> torch.Tensor:
        """Same, but the result stays on the device, un-fenced."""
        t = to_device(data, self.device)
        out = self._apply(self.coding_bits, self._to_words(t), device=True)
        return out.reshape(*t.shape[:-2], self.m, t.shape[-1])

    # -- decode ------------------------------------------------------------
    def _inverse_for(self, erasures: tuple[int, ...]) -> \
            tuple[np.ndarray, list[int]]:
        entry = self._inverses.get(erasures)
        if entry is None:
            k, w = self.k, self.w
            survivors = [i for i in range(k + self.m)
                         if i not in erasures][: k]
            rows = np.concatenate(
                [np.arange(c * w, (c + 1) * w) for c in survivors])
            entry = (_gf2_inv(self.generator[rows]), survivors)
            self._inverses[erasures] = entry
        return entry

    def decode(self, chunks: dict[int, np.ndarray],
               chunk_size: int) -> dict[int, np.ndarray]:
        """Recover all k+m chunks of one stripe from any ≥k survivors."""
        k, w, m = self.k, self.w, self.m
        if len(chunks) < k:
            raise ECError(f"{len(chunks)} chunks < k={k}")
        erasures = tuple(i for i in range(k + m) if i not in chunks)
        inv, survivors = self._inverse_for(erasures)
        words = np.concatenate(
            [np.asarray(chunks[c], dtype=np.uint8).reshape(w, -1)
             for c in survivors], axis=0)                # [kw, pw]
        data = self._apply(inv, words).reshape(k, chunk_size)
        out = {i: data[i] for i in range(k)}
        if any(k + j not in chunks for j in range(m)):
            parity = self.encode(data)
            for j in range(m):
                if k + j not in chunks:
                    out[k + j] = parity[j]
        for i, buf in chunks.items():
            out[i] = np.asarray(buf, dtype=np.uint8)
        return out

    def decode_batch(self, survivors_data: np.ndarray,
                     erasures: tuple[int, ...]) -> np.ndarray:
        """[B, k, chunk] survivor stack (id order) → [B, k, chunk]."""
        inv, _ = self._inverse_for(tuple(erasures))
        B, _, C = survivors_data.shape
        words = self._to_words(survivors_data)
        return self._apply(inv, words).reshape(B, self.k, C)

    def decode_device(self, survivors_data,
                      erasures: tuple[int, ...]) -> torch.Tensor:
        """:meth:`decode_batch` with the result left on the device."""
        inv, _ = self._inverse_for(tuple(erasures))
        t = to_device(survivors_data, self.device)
        out = self._apply(inv, self._to_words(t), device=True)
        return out.reshape(t.shape[0], self.k, t.shape[-1])
