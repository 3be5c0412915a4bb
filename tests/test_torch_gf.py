"""The port's GF(2^8) maps (``ceph_tpu_torch.ops``) against ceph_tpu's.

Same seeded numpy inputs through both packages; the port runs its
plain PyTorch versions on the CPU, ceph_tpu its Pallas kernels in
interpret mode.  Tolerance: exact byte identity (integer math).
"""

import numpy as np
import pytest
import torch

from ceph_tpu.ops import gf_pallas2 as jgp
from ceph_tpu.ops import rs as jrs
from ceph_tpu.ops.gf_jax import GFEncodeDigest as JGFEncodeDigest
from ceph_tpu.ops.gf_jax import _bit_layout_matrix as j_bit_layout
from ceph_tpu.ops.gf_jax import gf_matmul_bits as j_matmul_bits
from ceph_tpu_torch.ops import gf_words as W
from ceph_tpu_torch.ops import rs
from ceph_tpu_torch.ops.gf_torch import (GFEncodeDigest, GFLinear,
                                         GFLinearWords, _bit_layout_matrix,
                                         gf_matmul_bits)

# the suite shares the CPU with timing-sensitive cluster tests: keep
# torch's intra-op pool from spinning on every core
torch.set_num_threads(1)

KM = [(4, 2), (8, 3), (8, 4)]


def _data(k, shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, size=(*shape[:-1], k, shape[-1]),
                        dtype=np.uint8)


@pytest.mark.parametrize("k,m", KM)
def test_matrices_identical(k, m):
    coding = rs.reed_sol_van_matrix(k, m)
    assert np.array_equal(coding, jrs.reed_sol_van_matrix(k, m))
    bits = _bit_layout_matrix(coding)
    assert np.array_equal(bits, j_bit_layout(coding))
    assert np.array_equal(W.block_diag4(bits), jgp.block_diag4(bits))
    for build in ("reed_sol_r6_matrix", "cauchy_orig_matrix",
                  "cauchy_good_matrix", "isa_rs_van_matrix",
                  "isa_cauchy_matrix"):
        args = (k,) if build == "reed_sol_r6_matrix" else (k, m)
        assert np.array_equal(getattr(rs, build)(*args),
                              getattr(jrs, build)(*args))


@pytest.mark.parametrize("k,m", KM)
def test_matmul_words_matches_jax(k, m):
    coding = rs.reed_sol_van_matrix(k, m)
    data = _data(k, (2, 1024), k * 10 + m)
    words = data.view("<i4")
    want = np.asarray(jgp.gf_matmul_words(j_bit_layout(coding), words, m,
                                          interpret=True))
    got = W.gf_matmul_words(coding, torch.from_numpy(words))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    gw = GFLinearWords(coding, device="cpu")(words)
    assert np.array_equal(gw.numpy(), want)


@pytest.mark.parametrize("k,m", KM)
@pytest.mark.parametrize("n", [512, 700])
def test_matmul_bytes_matches_jax(k, m, n):
    coding = rs.reed_sol_van_matrix(k, m)
    data = _data(k, (3, n), n + k)
    want = np.asarray(jgp.gf_matmul_pallas2(j_bit_layout(coding), data, m,
                                            interpret=True))
    got = W.gf_matmul_bytes(coding, torch.from_numpy(data))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(GFLinear(coding, device="cpu")(data).numpy(), want)


@pytest.mark.parametrize("k,m", KM)
def test_matmul_bits_matches_jax(k, m):
    coding = rs.reed_sol_van_matrix(k, m)
    bits = _bit_layout_matrix(coding)
    data = _data(k, (2, 96), 5)
    want = np.asarray(j_matmul_bits(bits, data, m))
    assert np.array_equal(
        gf_matmul_bits(bits, torch.from_numpy(data), m).numpy(), want)


@pytest.mark.parametrize("k,m", KM)
def test_expand_words_matches_jax(k, m):
    data = _data(k, (2, 1024), 11 + k)
    want = np.asarray(jgp.gf_expand_words(data))
    got = W.gf_expand_words(torch.from_numpy(data))
    assert got.dtype == torch.int8
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,m", KM)
def test_resident_planes_match_jax(k, m):
    coding = rs.reed_sol_van_matrix(k, m)
    data = _data(k, (2, 700), 23 + m)
    jrp = jgp.ResidentPlanes(data, interpret=True)
    rp = W.ResidentPlanes(data, device="cpu")
    assert np.array_equal(rp.planes.numpy(), np.asarray(jrp.planes))
    dm = rs.decode_matrix(coding, k, [0, k])
    for mat in (coding, dm):
        assert np.array_equal(rp.multiply(mat).numpy(),
                              np.asarray(jrp.multiply(mat)))


def _prmt(a, b, s):
    """PRMT (``prmt.b32``, default mode) on uint32 arrays: byte n of the
    result is byte ``s[4n:4n+3]`` of {b:a}, or its sign replicated when
    bit ``4n+3`` of ``s`` is set."""
    a, b, s = np.broadcast_arrays(
        *(np.asarray(v, dtype=np.uint32) for v in (a, b, s)))
    src = np.stack([(x >> np.uint32(8 * j)) & np.uint32(0xFF)
                    for x in (a, b) for j in range(4)])
    out = np.zeros(a.shape, dtype=np.uint32)
    for n in range(4):
        nib = (s >> np.uint32(4 * n)) & np.uint32(0xF)
        byte = np.take_along_axis(
            src, (nib & np.uint32(7))[None].astype(np.int64), 0)[0]
        sign = np.where(byte & 0x80, np.uint32(0xFF), np.uint32(0))
        byte = np.where(nib & np.uint32(8), sign, byte)
        out |= byte.astype(np.uint32) << np.uint32(8 * n)
    return out


def _plane_b(frags, rows):
    """Undo :func:`W.plane_frags`' fragment layout: the [8 rows, 32 kt]
    operand, row t*8 + s' (output row t, bit s'), column s*k + i."""
    kt = frags.shape[1]
    b = np.ascontiguousarray(frags).view(np.uint8)
    b = b.reshape(rows, kt, 8, 4, 2, 4).transpose(0, 2, 1, 4, 3, 5)
    return b.reshape(8 * rows, 32 * kt)


@pytest.mark.parametrize("k,m", KM)
def test_plane_frags_block_product(k, m):
    """The K2 kernel's arithmetic in numpy: per byte position b, that
    position's planes times the operand (from its fragments), ``& 1``,
    then the second product that weighs bit s' by 2^s' to gather each
    output byte; equals the oracle."""
    coding = rs.reed_sol_van_matrix(k, m)
    data = _data(k, (1, 64), 3)
    planes = W.gf_expand_words(torch.from_numpy(data)).numpy()[0] & 1
    op = _plane_b(W.plane_frags(coding), m).astype(np.int64)
    gather = np.zeros((8 * m, m), dtype=np.int64)   # [t*8 + s', t]
    for t in range(m):
        gather[t * 8:(t + 1) * 8, t] = 1 << np.arange(8)
    out = np.zeros((planes.shape[1], m), dtype=np.uint32)
    for b in range(4):
        pb = np.zeros((planes.shape[1], op.shape[1]), dtype=np.int64)
        pb[:, :8 * k] = planes[8 * k * b:8 * k * (b + 1)].T
        byte = ((pb @ op.T) & 1) @ gather            # [nw, rows], < 256
        out |= byte.astype(np.uint32) << np.uint32(8 * b)
    assert np.array_equal(np.ascontiguousarray(out.T).view(np.uint8),
                          rs.encode_oracle(coding, data[0]))


@pytest.mark.parametrize("k,m", KM)
def test_plane_frags_reassemble_block_diag4(k, m):
    """Each diagonal block of block_diag4, its rows in the kernel's
    t*8 + s' order, is the operand the fragments hold."""
    coding = rs.reed_sol_van_matrix(k, m)
    bd = W.block_diag4(_bit_layout_matrix(coding))
    op = _plane_b(W.plane_frags(coding), m)
    assert op.shape == (8 * m, 32 * (-(-8 * k // 32)))
    for b in range(4):
        blk = bd[8 * m * b:8 * m * (b + 1), 8 * k * b:8 * k * (b + 1)]
        want = blk.reshape(8, m, 8 * k).transpose(1, 0, 2).reshape(
            8 * m, 8 * k)
        assert np.array_equal(op[:, :8 * k], want)
    assert not op[:, 8 * k:].any()


@pytest.mark.parametrize("k,m", KM)
def test_nibble_table_lookup(k, m):
    """The K1 kernel's arithmetic in numpy, PRMT emulated: selectors and
    bit-3 masks per input word, two table halves looked up and picked
    per nibble, from the host's nibble tables; equals the oracle."""
    coding = rs.reed_sol_van_matrix(k, m)
    data = _data(k, (1, 256), 4)[0]
    w = data.view("<u4")
    tab = W.nibble_tables(coding)                 # [m, k, 8] LO, HI
    acc = np.zeros((m, w.shape[1]), dtype=np.uint32)
    c7 = np.uint32(0x07070707)
    for i in range(k):
        lo, hi = w[i] & c7, (w[i] >> np.uint32(4)) & c7
        lsel = _prmt(lo | (lo >> np.uint32(4)), 0, 0x3320)
        hsel = _prmt(hi | (hi >> np.uint32(4)), 0, 0x3320)
        lmask = _prmt(w[i] << np.uint32(4), 0, 0xBA98)
        hmask = _prmt(w[i], 0, 0xBA98)
        for j in range(m):
            t = tab[j, i]
            la, lb = _prmt(t[0], t[1], lsel), _prmt(t[2], t[3], lsel)
            ha, hb = _prmt(t[4], t[5], hsel), _prmt(t[6], t[7], hsel)
            acc[j] ^= la ^ ha ^ ((la ^ lb) & lmask) ^ ((ha ^ hb) & hmask)
    assert np.array_equal(acc.view(np.uint8), rs.encode_oracle(coding, data))


@pytest.mark.parametrize("k,m", KM)
def test_encode_digest_matches_jax(k, m):
    coding = rs.reed_sol_van_matrix(k, m)
    data = _data(k, (2, 256), 31 + k)
    jpar, jcrc = JGFEncodeDigest(coding)(data)
    par, crc = GFEncodeDigest(coding, device="cpu")(data)
    assert np.array_equal(par.numpy(), np.asarray(jpar))
    assert np.array_equal(crc.numpy().view(np.uint32),
                          np.asarray(jcrc, dtype=np.uint32))
