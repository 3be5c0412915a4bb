"""The port's bitmatrix codes (``ceph_tpu_torch.ec.bitmatrix``, K10)
against ceph_tpu's: the same constructions, and the same engine answers
on both sides of ``HOST_THRESHOLD``.

The port's device side runs the plain version of the ``gf2_packets``
kernel on the CPU; ceph_tpu's runs its jitted ``go`` program on the
CPU.  Tolerance: exact byte identity.
"""

import itertools

import numpy as np
import pytest
import torch

from ceph_tpu.ec import bitmatrix as J
from ceph_tpu_torch.ec import bitmatrix as B
from ceph_tpu_torch.ec.interface import ECError

# the suite shares the CPU with timing-sensitive cluster tests: keep
# torch's intra-op pool from spinning on every core
torch.set_num_threads(1)

CODES = [("liberation", 4, None), ("liberation", 6, 7),
         ("liber8tion", 6, None), ("blaum_roth", 4, None),
         ("blaum_roth", 6, 6)]


@pytest.mark.parametrize("technique,k,w", CODES)
def test_constructions_identical(technique, k, w):
    bits, ww = B.build_bitmatrix(technique, k, w)
    jbits, jw = J.build_bitmatrix(technique, k, w)
    assert ww == jw and np.array_equal(bits, jbits)
    eng = B.BitMatrixECEngine(bits, k, ww, device="cpu")
    jeng = J.BitMatrixECEngine(jbits, k, jw)
    assert np.array_equal(eng.generator, jeng.generator)
    for era in [(0, 1), (0, k), (k, k + 1)]:
        inv, surv = eng._inverse_for(era)
        jinv, jsurv = jeng._inverse_for(era)
        assert surv == jsurv and np.array_equal(inv, jinv)


def test_default_w_and_validation_identical():
    for technique in ("liberation", "liber8tion", "blaum_roth"):
        for k in range(1, 12):
            assert B.default_w(technique, k) == J.default_w(technique, k)
    for bad in (lambda mod: mod.liberation_bitmatrix(5, 8),
                lambda mod: mod.liberation_bitmatrix(8, 7),
                lambda mod: mod.blaum_roth_bitmatrix(4, 7),
                lambda mod: mod.liber8tion_bitmatrix(9),
                lambda mod: mod.build_bitmatrix("liber8tion", 4, 7),
                lambda mod: mod.default_w("nope", 4)):
        with pytest.raises(ECError):
            bad(B)
        with pytest.raises(Exception):
            bad(J)
    with pytest.raises(ECError, match="singular"):
        B._gf2_inv(np.zeros((3, 3), dtype=np.int8))


def test_gf2_inverse_and_oracle_identical():
    rng = np.random.default_rng(2)
    bits, w = B.build_bitmatrix("liberation", 5, None)
    sq = bits[:, :2 * w]
    assert np.array_equal(B._gf2_inv(np.concatenate([np.eye(
        2 * w, dtype=np.int8)[:w], sq[w:]])), J._gf2_inv(np.concatenate(
            [np.eye(2 * w, dtype=np.int8)[:w], sq[w:]])))
    data = rng.integers(0, 256, size=(5, w * 9), dtype=np.uint8)
    assert np.array_equal(B.encode_oracle(bits, data, w),
                          J.encode_oracle(bits, data, w))


@pytest.mark.parametrize("technique,k,w", CODES)
@pytest.mark.parametrize("side", ["host", "device"])
def test_engine_matches_jax(technique, k, w, side):
    """encode / decode / decode_batch, below HOST_THRESHOLD (numpy on
    both sides) and forced onto the device path (the port's plain
    gf2_packets, ceph_tpu's jit)."""
    bits, w = B.build_bitmatrix(technique, k, w)
    eng = B.BitMatrixECEngine(bits, k, w, device="cpu")
    jeng = J.BitMatrixECEngine(bits, k, w)
    if side == "device":
        eng.HOST_THRESHOLD = 0
        jeng.HOST_THRESHOLD = 0
    rng = np.random.default_rng(k * w)
    chunk = w * 12
    data = rng.integers(0, 256, size=(3, k, chunk), dtype=np.uint8)
    parity = eng.encode(data)
    assert np.array_equal(parity, np.asarray(jeng.encode(data)))
    assert np.array_equal(parity[1], B.encode_oracle(bits, data[1], w))
    dev = eng.encode_device(torch.from_numpy(data))
    assert np.array_equal(dev.numpy(), np.asarray(jeng.encode_device(data)))
    full = np.concatenate([data, parity], axis=1)
    for era in itertools.combinations(range(k + 2), 2):
        surv = [i for i in range(k + 2) if i not in era][:k]
        got = eng.decode_batch(full[:, surv], era)
        assert np.array_equal(got, data)
        assert np.array_equal(
            got, np.asarray(jeng.decode_batch(full[:, surv], era)))
        assert np.array_equal(eng.decode_device(full[:, surv], era).numpy(),
                              data)
    chunks = {i: full[0, i] for i in range(k + 2) if i not in (1, k)}
    got = eng.decode(chunks, chunk)
    jgot = jeng.decode(chunks, chunk)
    for i in range(k + 2):
        assert np.array_equal(got[i], full[0, i])
        assert np.array_equal(got[i], np.asarray(jgot[i]))


@pytest.mark.parametrize("pw", [1, 3, 7, 13])
def test_packet_product_odd_packets(pw):
    """The plain K10 (the twin of ceph_tpu's ``go``) on packets that
    are no multiple of 4 or 16 bytes, with and without a batch."""
    bits, w = B.build_bitmatrix("liberation", 6, 7)
    rng = np.random.default_rng(pw)
    words = rng.integers(0, 256, size=(2, 6 * w, pw), dtype=np.uint8)
    go = J.BitMatrixECEngine._jit_apply()
    for mat in (bits, J._gf2_inv(np.concatenate(
            [np.eye(6 * w, dtype=np.int8)[2 * w:],
             bits], axis=0)[:6 * w])):
        want = np.asarray(go(mat, words))
        assert np.array_equal(
            B.gf2_packets(mat, torch.from_numpy(words)).numpy(), want)
        assert np.array_equal(
            B.gf2_packets(mat, torch.from_numpy(words[0])).numpy(), want[0])
    eng = B.BitMatrixECEngine(bits, 6, w, device="cpu")
    data = rng.integers(0, 256, size=(6, w * pw), dtype=np.uint8)
    assert np.array_equal(eng.encode(data), B.encode_oracle(bits, data, w))
    with pytest.raises(ECError, match="multiple"):
        eng.encode(data[:, 1:])


def _run_schedule(sched, mat, words, chunk):
    """Apply the gf2_packets kernel's XOR schedule in numpy, pass by
    pass as the kernel does: ``words`` [B, N, pw] -> [B, R, pw]."""
    rows, n = mat.shape
    npass = -(-n // chunk)
    offs, ents = sched[:npass * rows + 1], sched[npass * rows + 1:]
    out = np.zeros((words.shape[0], rows, words.shape[2]), np.uint8)
    for p in range(npass):
        staged = words[:, p * chunk:(p + 1) * chunk]
        for r in range(rows):
            for e in ents[offs[p * rows + r]:offs[p * rows + r + 1]]:
                assert 0 <= e < chunk
                out[:, r] ^= staged[:, e]
    return out


@pytest.mark.parametrize("technique,k,w", [("liberation", 6, 7),
                                           ("liber8tion", 6, None),
                                           ("blaum_roth", 6, 6)])
@pytest.mark.parametrize("which", ["encode", (0, 1), (0, 6)])
def test_xor_schedule_equals_the_selector(technique, k, w, which):
    """The kernel's XOR schedule, at encode and at decode, applied in
    numpy equals the plain K10 and ceph_tpu's ``_apply_np``: one entry
    per one of the matrix, identity rows as copies."""
    bits, w = B.build_bitmatrix(technique, k, w)
    mat = bits if which == "encode" else \
        B.BitMatrixECEngine(bits, k, w, device="cpu")._inverse_for(which)[0]
    sched = B.xor_schedule(mat)
    rows, n = mat.shape
    assert len(sched) == rows + 1 + int((mat & 1).sum())
    rng = np.random.default_rng(rows * n)
    words = rng.integers(0, 256, size=(2, n, 24), dtype=np.uint8)
    got = _run_schedule(sched, mat, words, min(n, B._CHUNK))
    assert np.array_equal(
        got, B.gf2_packets_plain(mat, torch.from_numpy(words)).numpy())
    assert np.array_equal(got, J.BitMatrixECEngine._apply_np(mat, words))
    if which != "encode":
        copies = [r for r in range(rows)
                  if sched[r + 1] - sched[r] == 1]
        assert len(copies) >= (k - 2) * w


def test_xor_schedule_runs_long_selectors_in_passes():
    """More than 32 rows and more input packets than one pass stages:
    each later pass XORs into the rows already written."""
    rng = np.random.default_rng(9)
    mat = (rng.random((70, 130)) < 0.4).astype(np.int8)
    sched = B.xor_schedule(mat)
    assert len(sched) == 3 * 70 + 1 + int(mat.sum())
    words = rng.integers(0, 256, size=(1, 130, 8), dtype=np.uint8)
    assert np.array_equal(_run_schedule(sched, mat, words, B._CHUNK),
                          J.BitMatrixECEngine._apply_np(mat, words))
