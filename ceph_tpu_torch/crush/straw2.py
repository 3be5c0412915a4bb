"""The straw2 choose of one descent level for a batch of lanes (K7) —
the port of ``ceph_tpu.crush.jax_mapper``'s ``straw2()`` (``:958``) with
``_straw2_draws`` (``:228``) and ``_ln16_s_tbl`` (``:53``).

Lane ``i`` sits in bucket row ``rows[i]`` with input ``x[i]``, draw index
``r[i]`` and output position ``pos[i]`` (the choose_args weight-set
column).  For every item ``j`` of the row::

    u    = crush_hash32_3(x, hash_id[j], r) & 0xFFFF
    draw = trunc_div(((crush_ln(u) - 2^48) << 16) wrapped to s64, w[j])
           (INT64_MIN when w[j] == 0)

and the lane takes the item of the first maximum (strict ``>``, item 0
seeds it: ``mapper.bucket_straw2_choose``).  The numerator comes from
one 64 Ki-entry s64 table (:func:`ln16_s_table`), exactly the values of
``crush_ln`` including its ~410 overshooting inputs.

On the card :func:`straw2_choose` launches ``csrc/crush_straw2.cu``: one
thread per lane, the row read from global memory, the table from L2.
The plain version :func:`straw2_plain` is torch code on the same tables
(hash on int64 lanes masked to 32 bits, so every right shift is
logical; the divide is ``torch.div(..., rounding_mode="trunc")``, C's
``div64_s64``).  A CPU tensor takes it; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels import build
from .ln import crush_ln

# K7: the straw2 draws and argmax of jax_mapper.py's device program
CRUSH_STRAW2 = build.register(
    "crush_straw2", "ceph_tpu_torch/csrc/crush_straw2.cu",
    "ceph_tpu/crush/jax_mapper.py:958")

I64_MIN = -(1 << 63)
_M32 = 0xFFFFFFFF
_SEED = 1315423911
_X, _Y = 231232, 1232


@functools.lru_cache(maxsize=1)
def ln16_s_table() -> np.ndarray:
    """``(crush_ln(u) - 2^48) << 16`` for every 16-bit ``u``, wrapped
    mod 2^64 to s64 as the scalar oracle's shift is."""
    u = np.arange(0x10000, dtype=np.uint64)
    lnv = crush_ln(u).astype(np.int64) - np.int64(1 << 48)
    return (lnv.astype(np.uint64) << np.uint64(16)).astype(np.int64)


# -- rjenkins on int64 lanes holding u32 values -------------------------------

def _mix(a, b, c):
    a = (a - b - c) & _M32
    a = a ^ (c >> 13)
    b = (b - c - a) & _M32
    b = b ^ ((a << 8) & _M32)
    c = (c - a - b) & _M32
    c = c ^ (b >> 13)
    a = (a - b - c) & _M32
    a = a ^ (c >> 12)
    b = (b - c - a) & _M32
    b = b ^ ((a << 16) & _M32)
    c = (c - a - b) & _M32
    c = c ^ (b >> 5)
    a = (a - b - c) & _M32
    a = a ^ (c >> 3)
    b = (b - c - a) & _M32
    b = b ^ ((a << 10) & _M32)
    c = (c - a - b) & _M32
    c = c ^ (b >> 15)
    return a, b, c


def _lanes(*vals):
    """Broadcast int64 tensors (or ints) to u32 values in int64."""
    ref = next(v for v in vals if isinstance(v, torch.Tensor))
    return [(v.to(torch.int64) if isinstance(v, torch.Tensor)
             else torch.tensor(v, dtype=torch.int64, device=ref.device))
            & _M32 for v in vals]


def _const(ref, v):
    return torch.full_like(ref, v)


def hash32_2(a, b):
    a, b = _lanes(a, b)
    a, b = torch.broadcast_tensors(a, b)
    h = _SEED ^ a ^ b
    x, y = _const(a, _X), _const(a, _Y)
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h


def hash32_3(a, b, c):
    a, b, c = _lanes(a, b, c)
    a, b, c = torch.broadcast_tensors(a, b, c)
    h = _SEED ^ a ^ b ^ c
    x, y = _const(a, _X), _const(a, _Y)
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    y, c, h = _mix(y, c, h)
    return h


def hash32_4(a, b, c, d):
    a, b, c, d = _lanes(a, b, c, d)
    a, b, c, d = torch.broadcast_tensors(a, b, c, d)
    h = _SEED ^ a ^ b ^ c ^ d
    x, y = _const(a, _X), _const(a, _Y)
    a, b, h = _mix(a, b, h)
    c, d, h = _mix(c, d, h)
    a, x, h = _mix(a, x, h)
    y, b, h = _mix(y, b, h)
    c, x, h = _mix(c, x, h)
    y, d, h = _mix(y, d, h)
    return h


# -- K7 -----------------------------------------------------------------------

class Straw2Tables:
    """A map's bucket tables on one device, as K7 and its plain version
    read them: ``items`` and ``hash_ids`` ``[nb, S]`` int32, ``weights``
    ``[P, nb, S]`` int64 (16.16), ``sizes`` ``[nb]`` int32 and the
    64 Ki-entry numerator table."""

    __slots__ = ("items", "hash_ids", "weights", "sizes", "ln16")

    def __init__(self, items, hash_ids, weights, sizes, device):
        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)
                                    ).to(device)
        self.items = put(items, np.int32)
        self.hash_ids = put(hash_ids, np.int32)
        self.weights = put(weights, np.int64)
        self.sizes = put(sizes, np.int32)
        self.ln16 = put(ln16_s_table(), np.int64)


def straw2_draws(u: torch.Tensor, w: torch.Tensor,
                 ln16: torch.Tensor) -> torch.Tensor:
    """Plain draws of 16-bit hashes ``u`` against weights ``w`` (int64),
    the numerators from ``ln16`` (:func:`ln16_s_table` on u's device)."""
    s = ln16[u.to(torch.int64)]
    q = torch.div(s, w.clamp(min=1), rounding_mode="trunc")
    return torch.where(w > 0, q, torch.full_like(q, I64_MIN))


def straw2_plain(tab: Straw2Tables, rows, x, r, pos) -> torch.Tensor:
    """Plain version of :func:`straw2_choose`: every lane scans all S
    columns of its row, columns past the row's size masked out."""
    S = tab.items.shape[1]
    P = tab.weights.shape[0]
    rows = rows.to(torch.int64)
    its = tab.items[rows]                                   # [B, S]
    hid = tab.hash_ids[rows]
    p = pos.to(torch.int64).clamp(0, P - 1)
    w = tab.weights[p, rows]                                # [B, S]
    u = hash32_3(x.to(torch.int64)[:, None], hid,
                 r.to(torch.int64)[:, None]) & 0xFFFF
    draws = straw2_draws(u, w, tab.ln16)
    col = torch.arange(S, device=its.device)
    draws = torch.where(col[None, :] < tab.sizes[rows][:, None], draws,
                        torch.full_like(draws, I64_MIN))
    # the first maximum: argmax returns the first of equal maxima
    sel = torch.argmax(draws, dim=1)
    return its.gather(1, sel[:, None])[:, 0]


def _i32(t: torch.Tensor) -> torch.Tensor:
    """int64 lanes holding u32 (or small signed) values -> int32 of the
    same low 32 bits."""
    t = t.to(torch.int64) & _M32
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(
        torch.int32).contiguous()


def straw2_choose(tab: Straw2Tables, rows: torch.Tensor, x: torch.Tensor,
                  r: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """K7: the straw2 choose of ``[B]`` lanes in bucket rows ``rows``
    → ``[B]`` int32 items.  ``x`` holds u32 inputs, ``r`` the draw
    indices, ``pos`` the output positions (any integer dtype)."""
    dev = rows.device
    if dev.type == "cpu":
        return straw2_plain(tab, rows, x, r, pos)
    if not rows.is_cuda:
        raise ValueError(f"crush_straw2: unsupported device {dev}")
    if tab.items.device != dev:
        raise ValueError("crush_straw2: tables and lanes on different "
                         "devices")
    lanes = rows.shape[0]
    out = torch.empty(lanes, dtype=torch.int32, device=dev)
    if lanes == 0:
        return out
    rows32, x32, r32, p32 = (_i32(t) for t in (rows, x, r, pos))
    nb, S = tab.items.shape
    rc = build.library().ctt_crush_straw2(
        rows32.data_ptr(), x32.data_ptr(), r32.data_ptr(),
        p32.data_ptr(), out.data_ptr(), tab.items.data_ptr(),
        tab.hash_ids.data_ptr(), tab.weights.data_ptr(),
        tab.sizes.data_ptr(), tab.ln16.data_ptr(), lanes, nb, S,
        tab.weights.shape[0], build.stream_ptr(dev))
    build.check(rc, "crush_straw2")
    CRUSH_STRAW2.count()
    return out
