"""The port's CRC-32C (``ceph_tpu_torch.scrub.crc32c``) against RFC 3720
and ceph_tpu's batch digest.  Tolerance: exact."""

import numpy as np
import pytest
import torch

from ceph_tpu.scrub.crc32c_jax import crc32c_batch as j_crc32c_batch
from ceph_tpu_torch.scrub import crc32c as C

# the suite shares the CPU with timing-sensitive cluster tests: keep
# torch's intra-op pool from spinning on every core
torch.set_num_threads(1)

# RFC 3720 B.4 test vectors
RFC3720 = [
    (bytes(32), 0x8A9136AA),
    (b"\xff" * 32, 0x62A8AB43),
    (bytes(range(32)), 0x46DD794E),
    (bytes(range(31, -1, -1)), 0x113FDB5C),
    (b"123456789", 0xE3069283),
]


@pytest.mark.parametrize("data,want", RFC3720)
def test_rfc3720_vectors(data, want):
    assert C.crc32c(data) == want
    rows = torch.from_numpy(np.frombuffer(data, dtype=np.uint8)[None].copy())
    assert int(C.crc32c_batch(rows)[0]) == want


@pytest.mark.parametrize("n,length", [(1, 1), (3, 31), (4, 100), (5, 777),
                                      (2, 4096)])
def test_batch_matches_jax_with_seeds(n, length):
    rng = np.random.default_rng(length)
    data = rng.integers(0, 256, size=(n, length), dtype=np.uint8)
    seeds = rng.integers(0, 2 ** 32, size=n, dtype=np.uint32)
    want = j_crc32c_batch(data, seeds)
    got = C.crc32c_batch(data, seeds, device="cpu")
    assert got.dtype == np.uint32
    assert np.array_equal(got, want)
    assert np.array_equal(C.crc32c_batch(data, device="cpu"),
                          j_crc32c_batch(data))
    for i in range(n):
        assert int(got[i]) == C.crc32c(data[i], int(seeds[i]))


def test_empty_rows_return_seeds():
    seeds = np.array([0, 7, 0xFFFFFFFF], dtype=np.uint32)
    got = C.crc32c_batch(np.zeros((3, 0), np.uint8), seeds, device="cpu")
    assert np.array_equal(got, seeds)


@pytest.mark.parametrize("pad", [0, 1, 5, 64, 1000])
def test_zero_unpad_round_trip(pad):
    rng = np.random.default_rng(pad)
    payload = rng.integers(0, 256, size=300, dtype=np.uint8)
    padded = np.concatenate([payload, np.zeros(pad, np.uint8)])
    crc_padded = int(C.crc32c_batch(padded[None], device="cpu")[0])
    assert C.crc32c_zero_unpad(crc_padded, pad) == C.crc32c(payload)


def test_combine_and_shift_inverse():
    a, b = b"hello ", b"world, erasure coded"
    assert C.crc32c_combine(C.crc32c(a), C.crc32c(b), len(b)) \
        == C.crc32c(a + b)
    assert C.crc32c_unshift(C.crc32c_shift(0x12345678, 77), 77) == 0x12345678


def _replay_kernel(sets, seeds, length, sms):
    """The crc32c_batch kernel's arithmetic replayed in numpy, thread by
    thread: the wrapper's geometry for a card of ``sms`` SMs, the
    virtual front pad, 16-byte granules folded through the nibble
    tables, the tile shift, the lane and warp operators, the segment
    operators and the seed operator; rows of the first set, then the
    second."""
    blob = C._kernel_tables()
    assert blob.shape == (5760,)
    data_t = blob[:512].reshape(32, 16)
    shift = blob[512:640].reshape(8, 16)
    lane_t = blob[640:4736].reshape(8, 16, 32)
    warp_t = blob[4736:].reshape(8, 8, 16)
    rows = [np.concatenate([np.zeros(-length % 16, np.uint8), r])
            for rs in sets for r in rs]
    ngran = len(rows[0]) // 16
    tps, nseg, grid = C.crc32c_geometry(len(rows), ngran, sms)
    assert grid == min(len(rows) * nseg, 4 * sms) and nseg <= 32
    seg_ops = C._segment_ops(tps, nseg).reshape(nseg, 8, 16)
    seed_op = C._seed_op(length).reshape(8, 16)
    lane = np.arange(256)

    def apply(op, v):
        v = np.asarray(v, dtype=np.uint32)
        out = np.zeros_like(v)
        for i in range(8):
            out ^= op[i][(v >> np.uint32(4 * i)) & np.uint32(15)]
        return out

    pad = nseg * tps * 256 - ngran
    assert 0 <= pad < tps * 256
    got = []
    for row, seed in zip(rows, seeds):
        gran = row.view("<u4").reshape(ngran, 4)
        crc = np.uint32(0)
        for s in range(nseg):
            reg = np.zeros(256, dtype=np.uint32)
            for tl in range(max(s * tps, pad // 256), (s + 1) * tps):
                g = tl * 256 + lane - pad
                w = np.where((g >= 0)[:, None], gran[np.maximum(g, 0)], 0)
                reg = apply(shift, reg)
                for j in range(4):
                    for i in range(8):
                        reg ^= data_t[8 * j + i][(w[:, j] >> np.uint32(4 * i))
                                                 & np.uint32(15)]
            y = np.zeros(256, dtype=np.uint32)
            for i in range(8):          # each lane's own operator
                nib = (reg >> np.uint32(4 * i)) & np.uint32(15)
                y ^= lane_t[i, nib, lane % 32]
            x = np.uint32(0)
            for w in range(8):          # warp sums, each warp's operator
                x ^= apply(warp_t[w], np.bitwise_xor.reduce(
                    y[32 * w:32 * w + 32]))
            v = apply(seg_ops[nseg - 1 - s], x)
            if s == 0:
                v ^= apply(seed_op, np.uint32(seed) ^ np.uint32(0xFFFFFFFF)) \
                    ^ np.uint32(0xFFFFFFFF)
            crc ^= v
        got.append(int(crc))
    return got, nseg


@pytest.mark.parametrize("length,sms", [
    (1, 132), (15, 132), (16, 132), (17, 132), (100, 132), (4096, 132),
    (12293, 2), (40000, 16), ((1 << 20) + 37, 132)])
def test_kernel_algorithm_in_numpy(length, sms):
    """The crc32c_batch kernel's schedule replayed in numpy equals the
    scalar CRC, for one row (many segments at the long length)."""
    rng = np.random.default_rng(length)
    data = rng.integers(0, 256, size=(1, length), dtype=np.uint8)
    seed = int(rng.integers(0, 2 ** 32))
    got, nseg = _replay_kernel([data], [seed], length, sms)
    assert got == [C.crc32c(data[0], seed)]
    if length > 1 << 20:
        assert nseg > 1


@pytest.mark.parametrize("na,nb,length,sms", [
    (3, 2, 5000, 132), (16, 6, 8192, 132), (2, 3, 70000, 1)])
def test_kernel_two_row_sets_in_numpy(na, nb, length, sms):
    """One launch over two row sets (the write lane's data and parity
    rows): each row's digest, in the sets' order."""
    rng = np.random.default_rng(na * 100 + nb)
    a = rng.integers(0, 256, size=(na, length), dtype=np.uint8)
    b = rng.integers(0, 256, size=(nb, length), dtype=np.uint8)
    seeds = rng.integers(0, 2 ** 32, size=na + nb, dtype=np.uint32)
    want = [C.crc32c(r, int(s)) for r, s in zip(np.concatenate([a, b]),
                                                 seeds)]
    if na * length < 200000:
        got, _ = _replay_kernel([a, b], seeds, length, sms)
        assert got == want
    got = C.crc32c_row_sets(torch.from_numpy(a), torch.from_numpy(b),
                            torch.from_numpy(seeds.view(np.int32)))
    assert got.numpy().view(np.uint32).tolist() == want


def test_geometry_fills_the_card():
    """The write lane's and scrub's launch shapes on 132 SMs: whole
    tiles a segment, at most 32 segments a row, at most 4 blocks per
    SM, and the busiest SM's work no larger than any other split's."""
    assert C.crc32c_geometry(16, 32768, 132) == (16, 8, 128)
    for n, ngran in ((16, 32768), (6, 32768), (22, 32768), (512, 512),
                     (192, 512), (704, 512), (704, 32768), (1, 65539)):
        tps, nseg, grid = C.crc32c_geometry(n, ngran, 132)
        ntiles = -(-ngran // 256)
        assert nseg * tps >= ntiles > (nseg - 1) * tps and nseg <= 32
        assert grid == min(n * nseg, 4 * 132)
        cost = -(-n * nseg // 132) * (tps + C._ITEM_TILES)
        for other in range(1, min(ntiles, 32) + 1):
            t = -(-ntiles // other)
            assert cost <= -(-n * -(-ntiles // t) // 132) * (t + C._ITEM_TILES)
