"""The port's compression package (``ceph_tpu_torch.compress``) against
ceph_tpu's, on the CPU, with seeded numpy inputs: the gear table, K8's
plain version against ``_gear_kernel`` and ``gear_hashes_host``, K9's
plain version against ``_boundary_kernel``, numpy replays of the two
CUDA kernels' lane arithmetic, codec blobs, chunk spans, batched
fingerprints, the registry and the dedup frames.  Tolerance: exact
bytes, hashes, spans and fingerprints."""

import numpy as np
import pytest
import torch

from ceph_tpu.compress import chunker as JC
from ceph_tpu.compress import codec as JK
from ceph_tpu.compress import dedup as JD
from ceph_tpu.compress import registry as JR
from ceph_tpu_torch.compress import chunker as PC
from ceph_tpu_torch.compress import codec as PK
from ceph_tpu_torch.compress import dedup as PD
from ceph_tpu_torch.compress import registry as PR

# the suite shares the CPU with timing-sensitive cluster tests: keep
# torch's intra-op pool from spinning on every core
torch.set_num_threads(1)

SHAPES = [(1, 1), (3, 31), (2, 32), (3, 33), (1, 48), (2, 4097), (4, 512)]


def _rows(rows, length, seed, zero_led=True):
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 256, size=(rows, length), dtype=np.uint8)
    if zero_led:
        b[0, :40] = 0           # GEAR[0] != 0 shows a wrong front pad
    if rows > 1:
        runs = np.repeat(rng.integers(0, 256, length // 5 + 1,
                                      dtype=np.uint8), 5)
        b[1] = runs[:length]
    return b


def _runs(n, seed=0, lo=16, hi=128, alphabet=256):
    rng = np.random.default_rng(seed)
    out = []
    while sum(len(r) for r in out) < n:
        out.append(np.full(int(rng.integers(lo, hi)),
                           rng.integers(0, alphabet), dtype=np.uint8))
    return np.concatenate(out)[:n].tobytes()


def test_gear_table_is_ceph_tpus():
    assert PC._GEAR.dtype == JC._GEAR.dtype == np.uint32
    assert PC._GEAR.tobytes() == JC._GEAR.tobytes()
    assert PC._GEAR[0] == 0xDBB7D9F7
    assert PC._WINDOW == JC._WINDOW == 32


@pytest.mark.parametrize("rows,length", SHAPES)
def test_gear_hashes_plain_matches_jax(rows, length):
    b = _rows(rows, length, seed=length)
    got = PC.gear_hashes(torch.from_numpy(b))
    assert got.dtype == torch.int32 and got.shape == (rows, length)
    got = got.numpy().view(np.uint32)
    assert np.array_equal(got, np.asarray(JC._gear_kernel(length)(b)))
    assert np.array_equal(got, np.stack([JC.gear_hashes_host(r)
                                         for r in b]))
    assert np.array_equal(got, np.stack([PC.gear_hashes_host(r)
                                         for r in b]))


def _gear_kernel_replay(b: np.ndarray) -> np.ndarray:
    """``csrc/gear_hash.cu`` lane by lane in numpy: 16-byte chunks, each
    run through ``h = (h << 1) + GEAR[x]`` from 0 (q_k, P = q_15), warps
    of 32 lanes over chunks ``30 w - 2 .. 30 w + 29`` of a row (no P
    before the row start), outputs of lanes 2..31 from the two P the
    shuffle brings: q_k + ((P1 + (P2 << 16)) << (k + 1))."""
    rows, length = b.shape
    gear = PC._GEAR.astype(np.uint64)
    m32 = np.uint64(0xFFFFFFFF)
    chunks = -(-length // 16)
    out = np.zeros((rows, length), dtype=np.uint64)
    for r in range(rows):
        for w in range(-(-chunks // 30)):
            q = np.zeros((32, 16), dtype=np.uint64)
            p = np.zeros(32, dtype=np.uint64)
            for lane in range(32):
                c = w * 30 + lane - 2
                if not 0 <= c < chunks:
                    continue
                h = np.uint64(0)
                for k in range(16):
                    pos = 16 * c + k
                    x = b[r, pos] if pos < length else 0    # byte path
                    h = ((h << np.uint64(1)) + gear[x]) & m32
                    q[lane, k] = h
                p[lane] = h
            for lane in range(2, 32):
                c = w * 30 + lane - 2
                if c >= chunks:
                    continue
                h0 = (p[lane - 1] + (p[lane - 2] << np.uint64(16))) & m32
                for k in range(16):
                    if 16 * c + k < length:
                        out[r, 16 * c + k] = (
                            q[lane, k] + (h0 << np.uint64(k + 1))) & m32
    return out.astype(np.uint32)


@pytest.mark.parametrize("rows,length", [(1, 1), (2, 31), (2, 33),
                                         (1, 512), (1, 1000), (2, 961)])
def test_gear_kernel_lane_arithmetic(rows, length):
    b = _rows(rows, length, seed=3 * length)
    want = PC.gear_hashes(torch.from_numpy(b)).numpy().view(np.uint32)
    assert np.array_equal(_gear_kernel_replay(b), want)


def _stage_slot(lane, s):
    """``stage_slot`` of ``csrc/gear_hash.cu``."""
    return 4 * lane + ((s + (lane >> 1)) & 3)


def test_gear_kernel_store_staging():
    """The vector path's write-back: every staged uint4 has one slot, the
    8 lanes of each phase of the 16-byte shared stores and loads hit 8
    distinct bank groups, and staged uint4 ``idx >= 8`` (lane ``idx >>
    2``, its uint4 ``idx & 3``) lands at ``dst[idx - 8]``: chunk
    ``lane - 2``'s outputs in order, 512 contiguous bytes a store."""
    slots = {_stage_slot(lane, s) for lane in range(32) for s in range(4)}
    assert slots == set(range(128))
    for s in range(4):                          # stores, lane by lane
        for phase in range(4):
            lanes = range(8 * phase, 8 * phase + 8)
            assert len({_stage_slot(lane, s) % 8 for lane in lanes}) == 8
    placed = {}
    for t in range(4):                          # loads and global stores
        idx = [32 * t + lane for lane in range(32)]
        for phase in range(4):
            part = idx[8 * phase:8 * phase + 8]
            assert len({_stage_slot(i >> 2, i & 3) % 8 for i in part}) == 8
        for i in idx:
            if i >= 8:
                placed[i - 8] = ((i >> 2) - 2, i & 3)
    assert [placed[d] for d in range(120)] == [
        (c, s) for c in range(30) for s in range(4)]


@pytest.mark.parametrize("rows,length", SHAPES)
def test_run_starts_plain_matches_jax(rows, length):
    b = _rows(rows, length, seed=7 + length)
    got = PK.run_starts(torch.from_numpy(b))
    assert got.dtype == torch.bool and got.shape == (rows, length)
    assert np.array_equal(got.numpy(),
                          np.asarray(JK._boundary_kernel(length)(b)))
    assert np.array_equal(got.numpy(), np.stack(
        [PK._run_starts_host(r) for r in b]))
    assert got[:, 0].all()


def _run_starts_replay(b: np.ndarray) -> np.ndarray:
    """``csrc/run_starts.cu``'s vector path in numpy: 16 bytes as four
    little-endian words, the previous-byte words by a funnel shift with
    the byte before the chunk (at a row start, ``~x[0] & 0xff``), and a
    per-byte not-equal of the words."""
    rows, length = b.shape
    words = b.reshape(rows, -1, 4, 4).view("<u4")[..., 0]   # [r, c, 4]
    out = np.zeros((rows, length // 16, 16), dtype=np.uint8)
    for r in range(rows):
        for c in range(length // 16):
            v = [int(x) for x in words[r, c]]
            halo = int(b[r, 16 * c - 1]) if c else (~v[0] & 0xFF)
            prev = [((v[0] << 8) | halo) & 0xFFFFFFFF] + [
                ((v[i] << 8) | (v[i - 1] >> 24)) & 0xFFFFFFFF
                for i in range(1, 4)]
            for i in range(4):
                for byte in range(4):
                    sh = 8 * byte
                    out[r, c, 4 * i + byte] = (
                        (v[i] >> sh) & 0xFF) != ((prev[i] >> sh) & 0xFF)
    return out.reshape(rows, length).astype(bool)


@pytest.mark.parametrize("rows,length", [(1, 16), (2, 32), (3, 512)])
def test_run_starts_kernel_lane_arithmetic(rows, length):
    b = _rows(rows, length, seed=length)
    b[-1, :16] = b[-1, 0]      # a run across the first chunk
    want = PK.run_starts(torch.from_numpy(b)).numpy()
    assert np.array_equal(_run_starts_replay(b), want)


CORPORA = {
    "empty": b"",
    "tiny": b"\x05",
    "runs": _runs(20000, 1),
    "long_runs": _runs(9000, 2, lo=200, hi=900),
    "few_symbols": _runs(12000, 3, lo=1, hi=9, alphabet=12),
    "random": np.random.default_rng(4).integers(
        0, 256, 7000, dtype=np.uint8).tobytes(),
    "many_symbols": _runs(15000, 5, lo=2, hi=6),
}


@pytest.mark.parametrize("corpus", sorted(CORPORA))
@pytest.mark.parametrize("name", ["rle", "zlib", "none"])
def test_codec_blobs_match_jax(corpus, name):
    data = CORPORA[corpus]
    pc, jc = PR.create_codec(name), JR.create_codec(name)
    blob = pc.compress(data)
    assert blob == jc.compress(data)
    assert pc.decompress(blob, len(data)) == data
    if name == "rle":
        row = np.frombuffer(data, dtype=np.uint8)
        scan = PK.run_starts(torch.from_numpy(row.reshape(1, -1).copy())
                             ).numpy()
        assert pc.compress_from_scan(row, len(row), scan[0]) == blob


@pytest.mark.parametrize("corpus", ["runs", "few_symbols", "random"])
def test_blob_sealed_by_either_package_expands_in_the_other(corpus):
    data = CORPORA[corpus]
    for name in ("rle", "rle_jax", "zlib"):
        pblob = PR.create_codec(name).compress(data)
        jblob = JR.create_codec(name).compress(data)
        assert JR.create_codec(name).decompress(pblob, len(data)) == data
        assert PR.create_codec(name).decompress(jblob, len(data)) == data


def test_rle_modes_and_errors_match():
    few = CORPORA["few_symbols"]
    assert PR.create_codec("rle").compress(few)[0] == PK._MODE_RLE4 \
        == JK._MODE_RLE4
    assert PR.create_codec("rle").compress(CORPORA["many_symbols"])[0] \
        == PK._MODE_RLE8 == JK._MODE_RLE8
    rle = PR.create_codec("rle")
    for bad in (b"", b"\x09\x00", b"\x01\x03"):
        with pytest.raises(PK.CodecError):
            rle.decompress(bad, 3)
    with pytest.raises(PK.CodecError, match="unknown compression codec"):
        PR.create_codec("lz4")


def test_registry_names_match():
    assert PR.list_codecs() == JR.list_codecs() == [
        "none", "rle", "rle_jax", "zlib"]


@pytest.mark.parametrize("avg", [64, 256, 4096])
@pytest.mark.parametrize("n", [0, 37, 5000, 40000])
def test_chunker_spans_match_jax(avg, n):
    data = (_runs(n, n) if n % 2 else np.random.default_rng(n).integers(
        0, 256, n, dtype=np.uint8).tobytes())
    pch, jch = PC.Chunker(avg_size=avg), JC.Chunker(avg_size=avg)
    assert pch.key() == jch.key()
    assert pch.chunks(data) == jch.chunks(data)
    row = np.frombuffer(data, dtype=np.uint8)
    hashes = PC.gear_hashes(torch.from_numpy(row.reshape(1, -1).copy())
                            ).numpy()[0]
    cuts = pch.cuts_from_hashes(hashes, n)
    assert cuts == jch.cuts_from_hashes(JC.gear_hashes_host(row), n)
    cand = np.flatnonzero((hashes.view(np.uint32) & pch.mask) == 0) + 1
    assert pch.cuts_from_candidates(cand, n) == cuts


def test_fingerprints_batch_matches_jax():
    rng = np.random.default_rng(9)
    chunks = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for n in (1, 31, 32, 33, 100, 4096, 5000)] + [b"\x00" * 70]
    got = PC.fingerprints_batch(chunks, device="cpu")
    assert got == JC.fingerprints_batch(chunks)
    assert got == [PC.fingerprint(c) for c in chunks]
    assert got == [JC.fingerprint(c) for c in chunks]
    assert all(len(fp) == 24 for fp in got)
    assert PC.fingerprints_batch([], device="cpu") == []


def test_crc32c_zero_unpad_many_matches_jax():
    from ceph_tpu.scrub.crc32c_jax import crc32c_zero_unpad as j_unpad
    from ceph_tpu_torch.scrub.crc32c import crc32c_zero_unpad_many
    rng = np.random.default_rng(12)
    crcs = rng.integers(0, 1 << 32, 300, dtype=np.uint32)
    pads = rng.integers(0, 1 << 17, 300)
    pads[:3] = [0, 1, (1 << 17) - 1]
    got = crc32c_zero_unpad_many(crcs, pads)
    assert got.dtype == np.uint32
    assert got.tolist() == [j_unpad(int(c), int(p))
                            for c, p in zip(crcs, pads)]
    assert crc32c_zero_unpad_many([], []).tolist() == []
    with pytest.raises(ValueError):
        crc32c_zero_unpad_many([1], [-1])


def test_gather_chunks_pads_each_chunk_at_the_back():
    rng = np.random.default_rng(2)
    batch = torch.from_numpy(rng.integers(0, 256, (3, 100),
                                          dtype=np.uint8))
    rows, offs, lens = [0, 0, 2, 1, 2], [0, 40, 7, 99, 0], [40, 60, 93, 1, 7]
    got = PC.gather_chunks(batch, rows, offs, lens, 128).numpy()
    assert got.shape == (5, 128)
    for i, (r, o, n) in enumerate(zip(rows, offs, lens)):
        assert np.array_equal(got[i, :n], batch[r, o:o + n].numpy())
        assert not got[i, n:].any()
    assert PC.gather_chunks(batch, [], [], [], 32).shape == (0, 32)


def test_dedup_frames_match_jax():
    hdr = {"algo": "rle", "len": 4096}
    for mod_a, mod_b in ((PD, JD), (JD, PD)):
        assert mod_b.unframe(mod_a.frame_raw(b"abc")) == (b"abc", None)
        assert mod_b.unframe(mod_a.frame_sealed(b"xyz", hdr)) == \
            (b"xyz", hdr)
    assert PD.frame_sealed(b"q", hdr) == JD.frame_sealed(b"q", hdr)
    assert PD.chunk_oid("ab") == JD.chunk_oid("ab")
    assert PD.manifest_entries({"dedup": [["f", 3]]}) == \
        JD.manifest_entries({"dedup": [["f", 3]]})
    with pytest.raises(ValueError):
        PD.unframe(b"\x07")
