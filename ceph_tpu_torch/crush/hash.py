"""rjenkins1 integer hashing — the randomness source of every CRUSH draw.

Reference: `src/crush/hash.c` (`crush_hash32_rjenkins1*`) and
`src/common/ceph_hash.cc` (`ceph_str_hash_rjenkins`) — SURVEY.md §3.3.
The reference mount was empty (SURVEY.md §0); the mixing schedule below is
reconstructed from upstream Ceph/Linux `crush/hash.c` and must be
re-verified against the fork when the mount is populated.

All functions are written with plain arithmetic operators on unsigned
32-bit values so the SAME code runs on NumPy arrays (oracle path) and on
the port's batched mapper hashes with its own torch twin (int64 lanes
masked to 32 bits, ``straw2.py``); uint32 wraparound is the semantics
either way.
"""

from __future__ import annotations

import functools

import numpy as np


def _wrapping(fn):
    """uint32 wraparound is the semantics; silence NumPy scalar-overflow
    warnings inside (harmless but noisy on the scalar oracle path)."""
    @functools.wraps(fn)
    def wrapped(*args):
        with np.errstate(over="ignore"):
            return fn(*args)
    return wrapped

CRUSH_HASH_SEED = np.uint32(1315423911)
_X = np.uint32(231232)
_Y = np.uint32(1232)
_U32 = np.uint32


def _mix(a, b, c):
    """Robert Jenkins' 96-bit mix (one round). Returns updated (a, b, c)."""
    a = (a - b) - c
    a = a ^ (c >> _U32(13))
    b = (b - c) - a
    b = b ^ (a << _U32(8))
    c = (c - a) - b
    c = c ^ (b >> _U32(13))
    a = (a - b) - c
    a = a ^ (c >> _U32(12))
    b = (b - c) - a
    b = b ^ (a << _U32(16))
    c = (c - a) - b
    c = c ^ (b >> _U32(5))
    a = (a - b) - c
    a = a ^ (c >> _U32(3))
    b = (b - c) - a
    b = b ^ (a << _U32(10))
    c = (c - a) - b
    c = c ^ (b >> _U32(15))
    return a, b, c


def _u32(v):
    """Coerce ints / arrays to uint32 (wrapping); pass other arrays through."""
    if isinstance(v, (int, np.integer)):
        return np.uint32(v & 0xFFFFFFFF)
    if isinstance(v, np.ndarray):
        return v.astype(np.uint32)
    return v  # already a uint32-typed jnp array / tracer


@_wrapping
def crush_hash32(a):
    a = _u32(a)
    hash_ = CRUSH_HASH_SEED ^ a
    b = a
    x, y = _X, _Y
    b, x, hash_ = _mix(b, x, hash_)
    y, a, hash_ = _mix(y, a, hash_)
    return hash_


@_wrapping
def crush_hash32_2(a, b):
    a, b = _u32(a), _u32(b)
    hash_ = (CRUSH_HASH_SEED ^ a) ^ b
    x, y = _X, _Y
    a, b, hash_ = _mix(a, b, hash_)
    x, a, hash_ = _mix(x, a, hash_)
    b, y, hash_ = _mix(b, y, hash_)
    return hash_


@_wrapping
def crush_hash32_3(a, b, c):
    a, b, c = _u32(a), _u32(b), _u32(c)
    hash_ = ((CRUSH_HASH_SEED ^ a) ^ b) ^ c
    x, y = _X, _Y
    a, b, hash_ = _mix(a, b, hash_)
    c, x, hash_ = _mix(c, x, hash_)
    y, a, hash_ = _mix(y, a, hash_)
    b, x, hash_ = _mix(b, x, hash_)
    y, c, hash_ = _mix(y, c, hash_)
    return hash_


@_wrapping
def crush_hash32_4(a, b, c, d):
    a, b, c, d = _u32(a), _u32(b), _u32(c), _u32(d)
    hash_ = (((CRUSH_HASH_SEED ^ a) ^ b) ^ c) ^ d
    x, y = _X, _Y
    a, b, hash_ = _mix(a, b, hash_)
    c, d, hash_ = _mix(c, d, hash_)
    a, x, hash_ = _mix(a, x, hash_)
    y, b, hash_ = _mix(y, b, hash_)
    c, x, hash_ = _mix(c, x, hash_)
    y, d, hash_ = _mix(y, d, hash_)
    return hash_


@_wrapping
def ceph_str_hash_rjenkins(data: bytes) -> int:
    """String hash used for object name → placement seed (ps).

    Reference: `src/common/ceph_hash.cc` — the object_hash of every pool
    by default (CEPH_STR_HASH_RJENKINS).
    """
    k = np.frombuffer(data, dtype=np.uint8)
    length = np.uint32(len(data))
    a = np.uint32(0x9E3779B9)
    b = np.uint32(0x9E3779B9)
    c = np.uint32(0)
    i = 0
    n = len(data)
    while n >= 12:
        a = a + np.uint32(int(k[i]) | int(k[i + 1]) << 8
                          | int(k[i + 2]) << 16 | int(k[i + 3]) << 24)
        b = b + np.uint32(int(k[i + 4]) | int(k[i + 5]) << 8
                          | int(k[i + 6]) << 16 | int(k[i + 7]) << 24)
        c = c + np.uint32(int(k[i + 8]) | int(k[i + 9]) << 8
                          | int(k[i + 10]) << 16 | int(k[i + 11]) << 24)
        a, b, c = _mix(a, b, c)
        i += 12
        n -= 12
    c = c + length
    # tail bytes; first byte of c is reserved for the length
    if n >= 11:
        c = c + np.uint32(int(k[i + 10]) << 24)
    if n >= 10:
        c = c + np.uint32(int(k[i + 9]) << 16)
    if n >= 9:
        c = c + np.uint32(int(k[i + 8]) << 8)
    if n >= 8:
        b = b + np.uint32(int(k[i + 7]) << 24)
    if n >= 7:
        b = b + np.uint32(int(k[i + 6]) << 16)
    if n >= 6:
        b = b + np.uint32(int(k[i + 5]) << 8)
    if n >= 5:
        b = b + np.uint32(int(k[i + 4]))
    if n >= 4:
        a = a + np.uint32(int(k[i + 3]) << 24)
    if n >= 3:
        a = a + np.uint32(int(k[i + 2]) << 16)
    if n >= 2:
        a = a + np.uint32(int(k[i + 1]) << 8)
    if n >= 1:
        a = a + np.uint32(int(k[i]))
    a, b, c = _mix(a, b, c)
    return int(c)
