"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``; every test skips without a CUDA device.  On a
machine with one (and without jax, so without the suite's conftest):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ceph_tpu_torch.crush import straw2 as K7
from ceph_tpu_torch.crush.torch_mapper import BatchMapper
from ceph_tpu_torch.ec import bitmatrix as BM
from ceph_tpu_torch.kernels import build
from ceph_tpu_torch.ops import gf_bytes as GB
from ceph_tpu_torch.ops import gf_words as W
from ceph_tpu_torch.ops import rs
from ceph_tpu_torch.scrub import crc32c as C

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _u8(dev, *shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, size=shape,
                                         dtype=np.uint8)).to(dev)


@pytest.mark.parametrize("k,m", [(4, 2), (8, 3), (8, 4)])
@pytest.mark.parametrize("n", [4, 100, 4096, 4096 + 36])
def test_gf_words_matches_plain(dev, k, m, n):
    coding = rs.reed_sol_van_matrix(k, m)
    dm = rs.decode_matrix(coding, k, list(range(m)))
    x = _u8(dev, 3, k, n, seed=n)
    before = W.GF_WORDS.launches
    for mat in (coding, dm):
        assert torch.equal(W.gf_matmul_bytes(mat, x),
                           W.gf_matmul_bytes_plain(mat, x))
    assert W.GF_WORDS.launches == before + 2


@pytest.mark.parametrize("k,m", [(4, 2), (8, 3)])
def test_planes_match_plain(dev, k, m):
    coding = rs.reed_sol_van_matrix(k, m)
    x = _u8(dev, 2, k, 2048, seed=k)
    planes = W.gf_expand_words(x)
    assert torch.equal(planes, W.gf_expand_words_plain(x))
    assert torch.equal(W.gf_matmul_planes(coding, planes),
                       W.gf_matmul_planes_plain(coding, planes))
    rp = W.ResidentPlanes(x[..., :700])
    assert torch.equal(rp.multiply(coding),
                       W.gf_matmul_bytes_plain(coding, x[..., :700]))


def _i32(dev, *shape, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=shape,
                                         dtype=np.int64).astype(np.int32)
                            ).to(dev)


@pytest.mark.parametrize("k,rows", [(8, 3), (8, 8), (8, 9), (8, 17),
                                    (3, 12), (200, 3), (1536, 1)])
@pytest.mark.parametrize("batch,nw", [(1, 1), (1, 5), (2, 127),
                                      (3, 1024), (1, 4099)])
def test_gf_words_edge_shapes(dev, k, rows, batch, nw):
    """Rows beyond the register tile (grid.y tiles), shared-memory-bound
    k, word counts that are not a multiple of the 4-word segment, and
    batch 1, through the word API."""
    rng = np.random.default_rng(k * rows + nw)
    mat = rng.integers(0, 256, size=(rows, k), dtype=np.uint8)
    x = _i32(dev, batch, k, nw, seed=nw)
    before = W.GF_WORDS.launches
    assert torch.equal(W.gf_matmul_words(mat, x),
                       W.gf_matmul_words_plain(mat, x))
    assert W.GF_WORDS.launches == before + 1


@pytest.mark.parametrize("k,rows", [(8, 1), (8, 3), (8, 9), (8, 24),
                                    (2, 5), (5, 2), (48, 8)])
@pytest.mark.parametrize("batch,nw", [(1, 1), (2, 127), (1, 389),
                                      (3, 4096)])
def test_gf_planes_edge_shapes(dev, k, rows, batch, nw):
    """m-tiles beyond the register tile, K not a multiple of 32, odd
    word counts (bytewise plane loads) and batch 1; planes of any int8
    value (the product reads bit 0)."""
    rng = np.random.default_rng(k * rows + nw)
    mat = rng.integers(0, 256, size=(rows, k), dtype=np.uint8)
    planes = torch.from_numpy(rng.integers(-128, 128, size=(batch, 32 * k,
                                                             nw),
                                           dtype=np.int8)).to(dev)
    before = W.GF_PLANES.launches
    assert torch.equal(W.gf_matmul_planes(mat, planes),
                       W.gf_matmul_planes_plain(mat, planes))
    assert W.GF_PLANES.launches == before + 1


@pytest.mark.parametrize("k,m", [(2, 1), (8, 3), (20, 4), (128, 128)])
@pytest.mark.parametrize("n", [1, 4, 100, 1001, 4096, 4096 + 36])
def test_gf_bytes_matches_plain(dev, k, m, n):
    coding = rs.reed_sol_van_matrix(k, m)
    dm = rs.decode_matrix(coding, k, list(range(min(m, k))))
    x = _u8(dev, 2, 3, k, n, seed=n + k)
    before = GB.GF_BYTES.launches
    for mat in (coding, dm):
        assert torch.equal(GB.gf_matmul_tables(mat, x),
                           GB.gf_matmul_gather(mat, x))
    assert GB.GF_BYTES.launches == before + 2


@pytest.mark.parametrize("offset", [1, 2, 4])
def test_gf_bytes_unaligned_views(dev, offset):
    """Rows that are views off the word grid are copied to a padded
    contiguous tensor, never read misaligned."""
    coding = rs.reed_sol_van_matrix(8, 3)
    x = _u8(dev, 64, 8, 131072 + offset, seed=offset)[..., offset:]
    assert torch.equal(GB.gf_matmul_tables(coding, x),
                       GB.gf_matmul_gather(coding, x.contiguous()))


def _straw2_tables(dev, sizes, positions, seed, zero_rows=()):
    rng = np.random.default_rng(seed)
    nb, S = len(sizes), max(sizes)
    items = rng.integers(0, 1 << 20, size=(nb, S)).astype(np.int32)
    hids = rng.integers(-(1 << 31), 1 << 31, size=(nb, S)).astype(np.int32)
    w = rng.integers(0, 4 * 0x10000, size=(positions, nb, S))
    w[:, :, ::7] = 0
    for row in zero_rows:
        w[:, row] = 0
    return K7.Straw2Tables(items, hids, w, sizes, dev), rng


@pytest.mark.parametrize("sizes,positions,lanes", [
    ([64] * 65, 1, 131072),          # host buckets of the 4096-OSD map
    ([1, 3, 65], 1, 1000),           # lanes not a multiple of the block
    ([3, 65, 1, 64], 3, 4099),       # weight sets, positions off the end
    ([65, 5], 2, 257)])
def test_crush_straw2_matches_plain(dev, sizes, positions, lanes):
    tab, rng = _straw2_tables(dev, sizes, positions, lanes, zero_rows=(1,))
    args = [torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, len(sizes), size=lanes),
        rng.integers(0, 1 << 32, size=lanes, dtype=np.uint64).astype(
            np.int64),
        rng.integers(0, 100, size=lanes), rng.integers(-1, 5, size=lanes))]
    before = K7.CRUSH_STRAW2.launches
    got = K7.straw2_choose(tab, *args)
    assert K7.CRUSH_STRAW2.launches == before + 1
    assert torch.equal(got.to(torch.int64),
                       K7.straw2_plain(tab, *args).to(torch.int64))


@pytest.mark.parametrize("rule", ["chooseleaf_firstn", "chooseleaf_indep"])
def test_mapper_kernel_equals_plain(dev, rule):
    from ceph_tpu_torch.crush.map import build_hierarchy
    cmap = build_hierarchy(1, 16, 16, rule=rule)
    rw = np.full(256, 0x10000, dtype=np.uint32)
    rw[::20] = 0
    rw[5::20] = 0x8000
    xs = np.arange(20000, dtype=np.uint32)
    before = K7.CRUSH_STRAW2.launches
    got = BatchMapper(cmap, 0, result_max=4, device=dev)(xs, rw)
    assert K7.CRUSH_STRAW2.launches > before
    plain = BatchMapper(cmap, 0, result_max=4, device=dev)
    plain._straw2 = K7.straw2_plain
    want = plain(xs, rw)
    assert np.array_equal(got, want)


def test_balancer_on_the_card_equals_plain_placements(dev):
    """The upmap balancer maps its pool through K7 on the card; a twin
    map balanced over the plain mapper's placements (straw2_plain on the
    card) gets the same moves, and no move puts two replicas on a
    host."""
    from ceph_tpu_torch.crush.map import CRUSH_ITEM_NONE, build_hierarchy
    from ceph_tpu_torch.mgr import UpmapBalancer
    from ceph_tpu_torch.osd.osdmap import EXISTS, UP, OSDMap, PGid
    from ceph_tpu_torch.tools.osdmaptool import map_pool_pgs

    def hier():
        m = OSDMap(crush=build_hierarchy(4, 8, 8), max_osd=256)
        m.epoch = 1
        for o in range(256):
            m.osd_state[o] = EXISTS | UP
        m.create_pool("bench", pg_num=4096, size=3, crush_rule=0)
        return m

    a, b = hier(), hier()
    b.batch_mapper(0, 3, device=dev)._straw2 = K7.straw2_plain
    plain = map_pool_pgs(b, b.pools[0], device=dev)
    before = K7.CRUSH_STRAW2.launches
    bal = UpmapBalancer(a, 0, device=dev)
    twin = UpmapBalancer(b, 0, placements=plain)
    assert np.array_equal(map_pool_pgs(a, a.pools[0], device=dev), plain)
    assert bal.stddev() == twin.stddev()
    for _ in range(8):
        pa = bal.optimize(max_changes=32, deviation_stop=0.5)
        assert pa == twin.optimize(max_changes=32, deviation_stop=0.5)
        if not pa:
            break
    assert K7.CRUSH_STRAW2.launches > before
    assert a.pg_upmap_items == b.pg_upmap_items and a.pg_upmap_items
    assert bal.stddev() == twin.stddev()
    for seed in range(4096):
        row = [o for o in plain[seed] if o != CRUSH_ITEM_NONE]
        row = a._apply_upmap(PGid(0, seed), row)
        hosts = [bal._domain_of[o] for o in row]
        assert len(hosts) == len(set(hosts))


@pytest.mark.parametrize("out", [[], list(range(11)), list(range(12))])
def test_multiblock_mapper_on_the_card(dev, out):
    """A two-root hybrid rule (one OSD from the first root, two from the
    second) on the card, with the first root's OSDs all, nearly all or
    none out: each block's NONE padding squeezes out on the device, and
    every PG equals ``do_rule``."""
    from ceph_tpu_torch.crush.map import Bucket, CrushMap, Rule, Step
    from ceph_tpu_torch.crush.mapper import do_rule
    cmap = CrushMap(types={0: "osd", 1: "host", 10: "root"})
    for root, first in ((-1, 0), (-2, 12)):
        hosts = []
        for h in range(3):
            hid = -3 - 3 * (-1 - root) - h
            cmap.add_bucket(Bucket(id=hid, type=1,
                                   items=list(range(first + 4 * h,
                                                    first + 4 * h + 4)),
                                   weights=[0x10000] * 4))
            hosts.append(hid)
        cmap.add_bucket(Bucket(id=root, type=10, items=hosts,
                               weights=[0x40000] * 3))
    cmap.max_devices = 24
    cmap.rules.append(Rule(id=0, name="hybrid", steps=[
        Step("take", -1), Step("chooseleaf_firstn", 1, 1), Step("emit"),
        Step("take", -2), Step("chooseleaf_firstn", 2, 1), Step("emit")]))
    rw = np.full(24, 0x10000, dtype=np.uint32)
    rw[out] = 0
    xs = np.arange(2000, dtype=np.uint32)
    got = BatchMapper(cmap, 0, device=dev)(xs, rw)
    want = np.full((len(xs), 3), -0x7FFFFFFF, dtype=np.int32)
    for i, x in enumerate(xs):
        row = do_rule(cmap, 0, int(x), 3, [int(v) for v in rw])
        want[i, :len(row)] = row
    assert np.array_equal(got, want)


@pytest.mark.parametrize("technique,k", [("liberation", 6),
                                         ("liber8tion", 6),
                                         ("blaum_roth", 6)])
@pytest.mark.parametrize("pw,batch", [(1, 3), (7, 2), (64, 1), (1000, 3),
                                      (24968, 1)])
def test_gf2_packets_matches_plain(dev, technique, k, pw, batch):
    """Encode and the decodes of erasures (0, 1), (0, 3), (0, k): 4-,
    8- and 16-byte vector variants, tails off the 512-byte warp tile."""
    bits, w = BM.build_bitmatrix(technique, k, None)
    eng = BM.BitMatrixECEngine(bits, k, w, device=dev)
    mats = [bits] + [eng._inverse_for(e)[0] for e in ((0, 1), (0, 3),
                                                      (0, k))]
    x = _u8(dev, batch, k * w, pw, seed=pw)
    before = BM.GF2_PACKETS.launches
    for mat in mats:
        assert torch.equal(BM.gf2_packets(mat, x),
                           BM.gf2_packets_plain(mat, x))
    assert BM.GF2_PACKETS.launches == before + len(mats)


def test_gf2_packets_many_rows(dev):
    """More than 32 output rows and a long selector: many staged passes,
    each XORing into the rows already stored; an unaligned view."""
    rng = np.random.default_rng(3)
    mat = (rng.random((70, 5000)) < 0.3).astype(np.int8)
    x = _u8(dev, 2, 5000, 12, seed=5)
    assert torch.equal(BM.gf2_packets(mat, x), BM.gf2_packets_plain(mat, x))
    v = _u8(dev, 2, 5000, 13, seed=6)[..., 1:]
    assert torch.equal(BM.gf2_packets(mat[:3], v),
                       BM.gf2_packets_plain(mat[:3], v))


def _seeds(dev, n):
    return torch.from_numpy(np.random.default_rng(n).integers(
        0, 2 ** 32, size=n, dtype=np.uint32).view(np.int32)).to(dev)


@pytest.mark.parametrize("n,length", [
    (1, 1), (2, 15), (3, 16), (4, 17), (5, 100), (7, 777), (3, 4096),
    (16, 65536), (2, 1 << 18), (1024, 33),
    (512, 8192), (6, 524288), (22, 524288)])
def test_crc32c_matches_plain(dev, n, length):
    x = _u8(dev, n, length, seed=length)
    seeds = _seeds(dev, n)
    before = C.CRC32C_BATCH.launches
    assert torch.equal(C.crc32c_rows(x, seeds),
                       C.crc32c_rows_plain(x, seeds))
    assert C.CRC32C_BATCH.launches == before + 1


@pytest.mark.parametrize("length", [(1 << 20) + 37])
def test_crc32c_long_rows(dev, length):
    """Rows above 2^20 bytes (many segments a row), against the host
    CRC (the plain version's [32, 8L] matrix is too large here)."""
    x = _u8(dev, 2, length, seed=length)
    seeds = _seeds(dev, 2)
    got = C.crc32c_rows(x, seeds).cpu().numpy().view(np.uint32)
    host = x.cpu().numpy()
    want = [C.crc32c(host[i], int(s)) for i, s in
            enumerate(seeds.cpu().numpy().view(np.uint32))]
    assert got.tolist() == want


@pytest.mark.parametrize("offset", [1, 3, 8])
def test_crc32c_unaligned_views(dev, offset):
    """Rows that start off a 16-byte boundary or are not contiguous
    take the wrapper's front pad; zero length returns the seeds."""
    base = _u8(dev, 9, 5000 + offset, seed=offset)
    view = base[:, offset:]
    seeds = _seeds(dev, 9)
    assert torch.equal(C.crc32c_rows(view, seeds),
                       C.crc32c_rows_plain(view.contiguous(), seeds))
    assert torch.equal(C.crc32c_rows(view[:, :0], seeds), seeds)


@pytest.mark.parametrize("na,nb,length", [(16, 6, 524288), (512, 192, 8192),
                                          (3, 1, 17), (1, 1, 1)])
def test_crc32c_two_row_sets(dev, na, nb, length):
    a, b = _u8(dev, na, length, seed=1), _u8(dev, nb, length, seed=2)
    seeds = _seeds(dev, na + nb)
    before = C.CRC32C_BATCH.launches
    got = C.crc32c_row_sets(a, b, seeds)
    assert C.CRC32C_BATCH.launches == before + 1
    assert torch.equal(got, torch.cat([
        C.crc32c_rows_plain(a, seeds[:na]),
        C.crc32c_rows_plain(b, seeds[na:])]))


@pytest.mark.parametrize("bsz,length", [(2, 524288), (64, 8192), (3, 999)])
def test_encode_digest_one_launch(dev, bsz, length):
    """GFEncodeDigest's digests equal per-row plain CRCs of the data
    and parity shards, from one crc32c_batch launch a flush."""
    from ceph_tpu_torch.ops.gf_torch import GFEncodeDigest
    coding = rs.reed_sol_van_matrix(8, 3)
    data = _u8(dev, bsz, 8, length, seed=bsz)
    fused = GFEncodeDigest(coding, device=dev)
    before = C.CRC32C_BATCH.launches
    parity, crcs = fused(data)
    assert C.CRC32C_BATCH.launches == before + 1
    assert torch.equal(parity, W.gf_matmul_bytes_plain(coding, data))
    shards = torch.cat([data, parity], dim=1).reshape(-1, length)
    assert torch.equal(crcs.reshape(-1), C.crc32c_rows_plain(shards))


def test_launch_counts_only_on_launch(dev):
    build.reset_counts()
    W.gf_matmul_bytes_plain(rs.reed_sol_van_matrix(4, 2), _u8(dev, 1, 4, 64))
    assert all(v == 0 for v in build.counts().values())


def _zero_led(dev, rows, length, seed):
    x = _u8(dev, rows, length, seed=seed)
    x[0, :40] = 0               # GEAR[0] != 0 shows a wrong front pad
    return x


@pytest.mark.parametrize("rows,length", [
    (64, 1 << 20), (1, 1), (3, 1), (1, 31), (3, 31), (1, 32), (3, 32),
    (1, 33), (3, 33), (1, 4097), (3, 4097), (5, 480), (2, 961)])
def test_gear_hash_matches_plain(dev, rows, length):
    from ceph_tpu_torch.compress import chunker as CH
    x = _zero_led(dev, rows, length, seed=length)
    before = CH.GEAR_HASH.launches
    assert torch.equal(CH.gear_hashes(x), CH.gear_hashes_plain(x))
    assert CH.GEAR_HASH.launches == before + 1
    # a view off the 16-byte boundary takes the byte path
    view = _u8(dev, rows * length + 1, seed=rows)[1:].view(rows, length)
    assert torch.equal(CH.gear_hashes(view), CH.gear_hashes_plain(view))


@pytest.mark.parametrize("rows,length", [
    (64, 1 << 20), (1, 1), (3, 1), (1, 31), (3, 31), (1, 32), (3, 32),
    (1, 33), (3, 33), (1, 4097), (3, 4097)])
def test_run_starts_matches_plain(dev, rows, length):
    from ceph_tpu_torch.compress import codec as CO
    x = _zero_led(dev, rows, length, seed=length)
    x[-1] = int(x[-1, 0])       # one run the whole row
    before = CO.RUN_STARTS.launches
    assert torch.equal(CO.run_starts(x), CO.run_starts_plain(x))
    assert CO.RUN_STARTS.launches == before + 1
    view = _u8(dev, rows * length + 3, seed=rows)[3:].view(rows, length)
    assert torch.equal(CO.run_starts(view), CO.run_starts_plain(view))


def test_fingerprints_batch_on_the_card(dev):
    from ceph_tpu_torch.compress import chunker as CH
    rng = np.random.default_rng(4)
    chunks = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for n in (1, 31, 32, 33, 1000, 16384)]
    assert CH.fingerprints_batch(chunks, device=dev) == \
        [CH.fingerprint(c) for c in chunks]


def test_comp_lane_on_the_card_matches_the_lane_off(dev):
    """The comp lane on the card (one K9 launch for the compress group,
    one K8 and one K6 launch for the fingerprint group) against
    ``BatchEngine(enabled=False)``, which runs the host codec and
    chunker."""
    from ceph_tpu_torch.compress import chunker as CH
    from ceph_tpu_torch.compress.registry import create_codec
    from ceph_tpu_torch.osd.batch_engine import BatchEngine
    rng = np.random.default_rng(19)
    payloads = []
    for i in range(16):
        if i % 8 == 7:
            payloads.append(rng.integers(0, 256, 65536, np.uint8).tobytes())
        else:
            run = int(rng.integers(16, 128))
            vals = rng.integers(0, 256, 65536 // run + 1, np.uint8)
            payloads.append(np.repeat(vals, run)[:65536].tobytes())
    on = BatchEngine("on", device=dev, flush_ms=1000.0, max_ops=64,
                     max_bytes=64 << 20)
    off = BatchEngine("off", device="cpu", enabled=False)
    codec, chunker = create_codec("rle"), CH.Chunker(4096)
    before = build.counts()
    comps = [on.submit_compress(codec, p) for p in payloads]
    fps = [on.submit_fingerprint(chunker, p) for p in payloads]
    on.flush_sync("comp")
    after = build.counts()
    assert after["run_starts"] - before["run_starts"] == 1
    assert after["gear_hash"] - before["gear_hash"] == 1
    assert after["crc32c_batch"] - before["crc32c_batch"] == 1
    for c, f, p in zip(comps, fps, payloads):
        assert c.result() == off.submit_compress(codec, p).result()
        assert f.result() == off.submit_fingerprint(chunker, p).result()


def test_profiler_fences_on_a_cuda_event(dev):
    from ceph_tpu_torch.core.device_profiler import DeviceProfiler
    from ceph_tpu_torch.ops.gf_torch import GFLinear
    gl = GFLinear(rs.reed_sol_van_matrix(8, 3), device=dev)
    x = _u8(dev, 64, 8, 131072, seed=5)
    prof = DeviceProfiler(name="t", enabled=True)
    with prof.bind():
        out = gl(x)
    (s,) = prof.samples()
    assert s["kernel"] == "gf_encode" and s["bytes_out"] == out.numel()
    assert s["compute_s"] >= 0.0
    assert torch.equal(out, W.gf_matmul_bytes_plain(rs.reed_sol_van_matrix(
        8, 3), x))


def test_store_phase_crash_leg_on_the_card(dev):
    """The smoke's store phase at 4 objects of 4 MiB: the last flush
    meets a mid_record power cut, the remount truncates the torn tail,
    and every acknowledged shard re-digested by K6 equals its hinfo."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    before = build.counts()
    out = chip_smoke.store_phase(dev, 4, 4 << 20)
    after = build.counts()
    assert out["acked"] == 2 and out["torn_tail"]["status"] == "torn"
    assert out["kicks"] == out["flushes"] == out["spans"] == 2
    assert after["gf_words"] > before["gf_words"]
    assert after["crc32c_batch"] > before["crc32c_batch"]


def _fold_args(dev, n, n_states, ages):
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke.pgmap_fold_args(torch, dev, n, n_states, ages,
                                      seed=n)


@pytest.mark.parametrize("n,n_states,ages", [
    (1 << 20, 7, "mix"), (1, 7, "mix"), (31, 7, "mix"), (32, 7, "mix"),
    (33, 7, "mix"), (1023, 7, "mix"), (65537, 7, "mix"),
    (65537, 1, "mix"), (65537, 4097, "mix"), (1 << 20, 4097, "mix"),
    (1 << 20, 7, "stale"), (1 << 20, 7, "fresh")])
def test_pgmap_fold_matches_plain(dev, n, n_states, ages):
    """K11 exactly equal to its plain version at the smoke's phase-2
    shapes: both branches (the shared histogram up to
    FOLD_SHARED_CAP bins, global atomics above it)."""
    from ceph_tpu_torch.mon import pgmap as PG
    assert (2 * 4097 > PG.FOLD_SHARED_CAP) and (14 <= PG.FOLD_SHARED_CAP)
    args = _fold_args(dev, n, n_states, ages)
    before = PG.PGMAP_FOLD.launches
    hist, sums = PG.summary_fold(*args)
    assert PG.PGMAP_FOLD.launches == before + 1
    want_hist, want_sums = PG._summary_fold_plain(*args)
    assert torch.equal(hist, want_hist) and torch.equal(sums, want_sums)
    assert int(hist.sum()) + int(sums[4]) == n


def test_summary_arrays_on_the_card_equal_numpy(dev):
    from ceph_tpu_torch.vstart import ScaleHarness
    h = ScaleHarness(n_osds=64, pg_num=16384, seed=11, stale_frac=0.01)
    h.pgmap._cols["stamp"][::97] = np.nan
    host = h.pgmap.summary_arrays(h.now)
    card = h.pgmap.summary_arrays(h.now, use_device=True)
    assert np.array_equal(card["state_stale_hist"],
                          host["state_stale_hist"])
    assert {k: v for k, v in card.items() if k != "state_stale_hist"} == \
        {k: v for k, v in host.items() if k != "state_stale_hist"}


def test_scale_harness_crush_placement_on_the_card(dev):
    from ceph_tpu_torch.vstart import ScaleHarness
    kw = dict(n_osds=64, pg_num=4096, seed=5, placement="crush")
    card = ScaleHarness(**kw)
    cpu = ScaleHarness(**kw, device="cpu")
    assert np.array_equal(card.placements, cpu.placements)
    assert card.evaluate() == cpu.evaluate()


def test_mini_cluster_on_the_card(dev):
    """The port's live cluster on the card: ``MiniCluster(n_mons=1,
    n_osds=6, device=cuda)`` with an EC k=4 m=2 pool (rule 1, so every
    OSD holds one shard of every object).  Writes launch K1 and K6; with
    osd.2 down, rewrites and a degraded read of every object launch K2
    and its feeder; after the revive and clean, every OSD's shards and
    hinfos equal a re-encode on the CPU."""
    import json
    import time
    from ceph_tpu_torch.ec import create_erasure_code
    from ceph_tpu_torch.vstart import MiniCluster

    def wait_for(pred, timeout=60.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if pred():
                return True
            time.sleep(0.05)
        return False

    k, m, n_osds, kill = 4, 2, 6, 2
    ec_cpu = create_erasure_code({"plugin": "jerasure", "k": k, "m": m,
                                  "technique": "reed_sol_van"}, device="cpu")
    rng = np.random.default_rng(17)
    data = {f"o{i}": rng.integers(0, 256, size=(256 << 10) + 37 * i,
                                  dtype=np.uint8).tobytes()
            for i in range(8)}
    c = MiniCluster(n_mons=1, n_osds=n_osds, device=dev)
    try:
        c.start()
        r = c.rados()
        rc, outs, _ = r.mon_command({
            "prefix": "osd erasure-code-profile set", "name": "k4m2",
            "profile": [f"k={k}", f"m={m}", "plugin=jerasure",
                        "technique=reed_sol_van"]})
        assert rc == 0, outs
        r.create_pool("ecp", pg_num=4, pool_type="erasure",
                      erasure_code_profile="k4m2", rule=1)
        io = r.open_ioctx("ecp")
        c.wait_for_clean(timeout=60)
        before = build.counts()
        for o, d in data.items():
            io.write_full(o, d)
        written = build.counts()
        c.kill_osd(kill)
        c.wait_for_osd_down(kill, timeout=30)
        for o in ("o0", "o1"):
            data[o] = data[o][::-1]
            io.write_full(o, data[o])
        for o, d in data.items():
            assert io.read(o) == d
        c.revive_osd(kill)
        want = {o: ec_cpu.encode(set(range(k + m)), d)
                for o, d in data.items()}

        def shards_ok():
            if not all(d.osdmap.is_up(kill) for d in c.osds.values()):
                return False
            om = c.osds[0].osdmap
            for o in data:
                pgid = om.raw_pg_to_pg(om.object_locator_to_pg(o, io.pool_id))
                acting = om.pg_to_up_acting_osds(pgid)[2]
                for s, i in enumerate(acting):
                    st, cid = c.osds[i].store, f"{pgid}s{s}"
                    with c.osds[i].lock:
                        if not st.exists(cid, o) or bytes(st.read(
                                cid, o)) != np.asarray(want[o][s]).tobytes():
                            return False
                        meta = json.loads(bytes(st.getattr(cid, o, "_")))
                    if meta["hinfo"] != C.crc32c(np.asarray(want[o][s])):
                        return False
            return True

        assert wait_for(shards_ok)
        c.wait_for_clean(timeout=60)
        after = build.counts()
    finally:
        c.stop()
    for name in ("gf_words", "crc32c_batch"):
        assert written[name] > before[name], name
    for name in ("gf_expand", "gf_planes"):
        assert after[name] > written[name], name


def test_gateway_on_the_card(dev):
    """The port's gateway on the card: a 4-OSD ``MiniCluster`` with
    ``start_rgw`` on a k=2 m=1 EC data pool (rule 1), one SigV4-signed
    multipart upload whose parts stripe (``stripe_size`` 64 KiB), and
    its GET byte for byte; the write lane's K1 and K6 launched."""
    import hashlib
    from ceph_tpu_torch.rgw import S3Client
    from ceph_tpu_torch.vstart import MiniCluster
    rng = np.random.default_rng(23)
    parts = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
             for n in (3 * (64 << 10) + 5, 100 << 10)]
    c = MiniCluster(n_mons=1, n_osds=4, device=dev)
    try:
        c.start()
        r = c.rados()
        rc, outs, _ = r.mon_command({
            "prefix": "osd erasure-code-profile set", "name": "k2m1",
            "profile": ["k=2", "m=1", "plugin=jerasure",
                        "technique=reed_sol_van"]})
        assert rc == 0, outs
        gw = c.start_rgw(require_auth=True, stripe_size=64 << 10,
                         data_pool_opts={"pool_type": "erasure",
                                         "erasure_code_profile": "k2m1",
                                         "pg_num": 4, "rule": 1})
        c.wait_for_clean(timeout=60)
        user = gw.store.create_user("cuda")
        cl = S3Client("127.0.0.1", gw.port, user["access_key"],
                      user["secret_key"])
        assert cl.make_bucket("b") == 200
        before = build.counts()
        st, up = cl.initiate_multipart("b", "mp")
        assert st == 200
        for n, data in enumerate(parts, 1):
            assert cl.put_part("b", "mp", up, n, data) == (
                200, hashlib.md5(data).hexdigest())
        st, etag = cl.complete_multipart("b", "mp", up)
        assert st == 200 and etag == hashlib.md5(b"".join(
            hashlib.md5(p).digest() for p in parts)).hexdigest() + "-2"
        after = build.counts()
        assert cl.get("b", "mp") == (200, b"".join(parts))
        manifest = gw.store.head_object("b", "mp")["parts"]
    finally:
        c.stop()
    assert len(manifest) == 4 + 2       # 4 stripes, then 2
    for name in ("gf_words", "crc32c_batch"):
        assert after[name] > before[name], name


def test_rbd_image_and_mirror_on_the_card(dev):
    """The port's block images on the card: a 4-OSD ``MiniCluster`` with
    a k=2 m=1 EC pool (rule 1); an image of 4 objects of 64 KiB, a
    snapshot, partial writes (EC read-modify-writes), the head and the
    snapshot read back byte for byte, a clone flattened; then a second
    cluster and ``MirrorDaemon.sync_once`` replaying a journaled image
    onto it; the write lane's K1 and K6 launched."""
    from ceph_tpu_torch.rbd import RBD, Image
    from ceph_tpu_torch.rbd.mirror import MirrorDaemon
    from ceph_tpu_torch.vstart import MiniCluster
    rng = np.random.default_rng(29)
    base = rng.integers(0, 256, size=4 << 16, dtype=np.uint8).tobytes()
    clusters, ios = [], []
    try:
        for _ in range(2):
            c = MiniCluster(n_mons=1, n_osds=4, device=dev)
            clusters.append(c)
            c.start()
            r = c.rados()
            rc, outs, _ = r.mon_command({
                "prefix": "osd erasure-code-profile set", "name": "k2m1",
                "profile": ["k=2", "m=1", "plugin=jerasure",
                            "technique=reed_sol_van"]})
            assert rc == 0, outs
            r.create_pool("rbd", pg_num=4, pool_type="erasure",
                          erasure_code_profile="k2m1", rule=1)
            c.wait_for_clean(timeout=60)
            ios.append(r.open_ioctx("rbd"))
        io, io_b = ios
        before = build.counts()
        RBD().create(io, "img", len(base), order=16)
        head = bytearray(base)
        with Image(io, "img") as img:
            img.write(0, base)
            img.create_snap("s1")
            for off in (100, 70000, 200001):
                data = rng.integers(0, 256, size=5000,
                                    dtype=np.uint8).tobytes()
                img.write(off, data)
                head[off:off + 5000] = data
            assert img.read(0, len(base)) == bytes(head)
            img.protect_snap("s1")
        after = build.counts()
        with Image(io, "img", snapshot="s1") as snap:
            assert snap.read(0, len(base)) == base
        RBD().clone(io, "img", "s1", "kid")
        with Image(io, "kid") as kid:
            kid.flatten()
            assert kid.read(0, len(base)) == base
        RBD().create(io, "jrn", 2 << 16, order=16, journaling=True)
        with Image(io, "jrn") as img:
            img.write(1000, base[:70000])
        d = MirrorDaemon(io, io_b)
        d.sync_once()
        assert d.errors == []
        with Image(io_b, "jrn", read_only=True) as img:
            assert img.read(1000, 70000) == base[:70000]
    finally:
        for c in clusters:
            c.stop()
    for name in ("gf_words", "crc32c_batch"):
        assert after[name] > before[name], name


def test_cephfs_on_an_ec_pool_on_the_card(dev):
    """The port's file system on the card: a 4-OSD ``MiniCluster`` with
    a replicated metadata pool, a k=2 m=1 EC data pool (rule 1), ``fs
    new``, one MDS and one client at Ceph's default layout; one file of
    4 MiB written in one call and read back byte for byte; the write
    lane's K1 and K6 launched."""
    from ceph_tpu_torch.vstart import MiniCluster
    data = np.random.default_rng(31).integers(
        0, 256, size=4 << 20, dtype=np.uint8).tobytes()
    c = MiniCluster(n_mons=1, n_osds=4, device=dev)
    try:
        c.start()
        r = c.rados()
        rc, outs, _ = r.mon_command({
            "prefix": "osd erasure-code-profile set", "name": "k2m1",
            "profile": ["k=2", "m=1", "plugin=jerasure",
                        "technique=reed_sol_van"]})
        assert rc == 0, outs
        r.create_pool("cephfs_data", pg_num=4, pool_type="erasure",
                      erasure_code_profile="k2m1", rule=1)
        r.create_pool("cephfs_metadata", pg_num=4, size=3)
        c.wait_for_clean(timeout=60)
        rc, outs, _ = r.mon_command({
            "prefix": "fs new", "fs_name": "cephfs",
            "metadata": "cephfs_metadata", "data": "cephfs_data"})
        assert rc == 0, outs
        c.start_mds("a")
        c.wait_for_active_mds(timeout=60)
        fs = c.cephfs(entity="client.cuda")
        before = build.counts()
        fs.write_file("/f", data)
        after = build.counts()
        assert fs.stat("/f")["size"] == len(data)
        assert fs.read_file("/f") == data
    finally:
        c.stop()
    for name in ("gf_words", "crc32c_batch"):
        assert after[name] > before[name], name
