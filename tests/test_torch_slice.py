"""The port's EC data-plane slice as a whole, and its package rules.

- seeded writes → the port's engine → two shards erased →
  reconstruct, equal to ceph_tpu's engine on the same ops;
- seeded writes → deep scrub (digests, recheck through the recovery
  lane, culprit) for an RS pool and a bitmatrix pool, equal to
  ceph_tpu's scrub of the same writes;
- import hygiene: nothing in ``ceph_tpu_torch`` (nor ``chip_smoke.py``)
  imports jax or ceph_tpu;
- entry points (the CRUSH mapper among them) raise without CUDA unless
  ``device="cpu"``;
- a request for the card never routes to a plain version.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from ceph_tpu.ec import create_erasure_code as j_create
from ceph_tpu.osd.batch_engine import BatchEngine as JBatchEngine
from ceph_tpu.scrub import engine as JS
from ceph_tpu.crush import build_hierarchy
from ceph_tpu.crush.compiler import crushmap_to_dict
from ceph_tpu_torch.compress import chunker as CH
from ceph_tpu_torch.compress import codec as CO
from ceph_tpu_torch.crush import straw2 as K7
from ceph_tpu_torch.crush.compiler import crushmap_from_dict
from ceph_tpu_torch.crush.torch_mapper import BatchMapper
from ceph_tpu_torch.ec import bitmatrix as BM
from ceph_tpu_torch.ec import create_erasure_code
from ceph_tpu_torch.ec.torch_backend import MatrixECEngine
from ceph_tpu_torch.kernels import build
from ceph_tpu_torch.mgr import UpmapBalancer
from ceph_tpu_torch.ops import gf_bytes as GB
from ceph_tpu_torch.ops import gf_words as W
from ceph_tpu_torch.ops import rs
from ceph_tpu_torch.ops.gf_torch import GFEncodeDigest, GFLinear
from ceph_tpu_torch.osd.batch_engine import BatchEngine
from ceph_tpu_torch.scrub import crc32c as C
from ceph_tpu_torch.scrub import engine as S
from ceph_tpu_torch.scrub.engine import ScrubEngine
from ceph_tpu_torch.tools import osdmaptool
from ceph_tpu_torch.utils.device import resolve_device
from ceph_tpu_torch.vstart import ScaleHarness

# the suite shares the CPU with timing-sensitive cluster tests: keep
# torch's intra-op pool from spinning on every core
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PROFILE = {"plugin": "torch_cuda", "technique": "reed_sol_van", "k": 8,
           "m": 3}


@pytest.mark.parametrize("flush_ms", [0.0, 1000.0])
def test_slice_write_erase_reconstruct_matches_jax(flush_ms):
    rng = np.random.default_rng(17)
    payloads = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
                for n in (8192, 4000, 8192, 1, 6000)]
    ec = create_erasure_code(PROFILE, device="cpu")
    jec = j_create(dict(PROFILE, plugin="jax_tpu"))
    kw = dict(flush_ms=flush_ms, max_ops=1000, max_bytes=1 << 30)

    def run(eng, code):
        comps = [eng.submit_encode(code, p) for p in payloads]
        eng.drain()
        written = [c.result(timeout=30) for c in comps]
        comps = []
        for shards, _h in written:
            avail = {i: np.frombuffer(b, np.uint8)
                     for i, b in shards.items() if i not in (2, 9)}
            comps.append(eng.submit_reconstruct(code, avail,
                                                want={2, 9, 0}))
        eng.drain()
        rebuilt = [c.result(timeout=30) for c in comps]
        eng.stop()
        return written, rebuilt

    written, rebuilt = run(BatchEngine("t", device="cpu", **kw), ec)
    jwritten, jrebuilt = run(JBatchEngine("j", **kw), jec)
    assert written == jwritten
    for (shards, hinfos), got, jgot in zip(written, rebuilt, jrebuilt):
        for cid in (0, 2, 9):
            assert got[cid].tobytes() == shards[cid]
            assert np.array_equal(got[cid], np.asarray(jgot[cid]))
            assert C.crc32c(got[cid]) == hinfos[cid]


@pytest.mark.parametrize("prof", [
    PROFILE, {"plugin": "jerasure", "technique": "liber8tion", "k": 4,
              "m": 2}], ids=["rs-k8m3", "liber8tion-k4m2"])
def test_slice_write_then_deep_scrub_matches_jax(prof):
    rng = np.random.default_rng(29)
    payloads = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
                for n in (6000, 6000, 2500, 6000)]
    ec = create_erasure_code(prof, device="cpu")
    jec = j_create(dict(prof, plugin="jax_tpu")
                   if prof["plugin"] == "torch_cuda" else prof)
    kw = dict(flush_ms=1000.0, max_ops=1000, max_bytes=1 << 30)

    def run(eng, code, scrub, iso):
        comps = [eng.submit_encode(code, p) for p in payloads]
        eng.drain()
        written = [c.result(timeout=30) for c in comps]
        digests = scrub.compute_digests(
            {(o, i): b for o, (shards, _h) in enumerate(written)
             for i, b in shards.items()})
        stripes = {o: dict(shards) for o, (shards, _h) in enumerate(written)}
        bad = bytearray(stripes[2][1])
        bad[7] ^= 0x10
        stripes[2][1] = bytes(bad)
        recheck = scrub.recheck_parity(code, stripes, batch=eng)
        culprit = iso(code, stripes[2])
        eng.stop()
        return written, digests, recheck, culprit

    got = run(BatchEngine("t", device="cpu", **kw), ec,
              ScrubEngine(device_min_rows=2, device="cpu"),
              S.isolate_culprit)
    want = run(JBatchEngine("j", **kw), jec,
               JS.ScrubEngine(device_min_rows=2), JS.isolate_culprit)
    assert got == want
    written, digests, recheck, culprit = got
    assert all(digests[(o, i)] == hinfos[i]
               for o, (_s, hinfos) in enumerate(written) for i in hinfos)
    assert [o for o, flag in recheck.items() if flag] == [2]
    assert culprit == 1


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(
    [*(REPO / "ceph_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(REPO)))
def test_import_hygiene(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top != "jax", f"{path} imports {name}"
        assert top != "ceph_tpu", f"{path} imports {name}"


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    coding = rs.reed_sol_van_matrix(4, 2)
    mapfile = str(tmp_path / "m.json")
    assert osdmaptool.main([mapfile, "--createsimple", "8",
                            "--pg-bits", "1"]) == 0
    for make in (lambda: resolve_device(None),
                 lambda: create_erasure_code(PROFILE),
                 lambda: MatrixECEngine(coding, 4, 2),
                 lambda: GFLinear(coding),
                 lambda: GFLinear(coding, backend="bytes"),
                 lambda: BM.BitMatrixECEngine(
                     *BM.build_bitmatrix("liberation", 4, None)[:1], 4, 5),
                 lambda: create_erasure_code({"plugin": "shec", "k": 4,
                                              "m": 3, "c": 2}),
                 lambda: create_erasure_code({"plugin": "lrc", "k": 4,
                                              "m": 2, "l": 3}),
                 lambda: ScrubEngine(),
                 lambda: GFEncodeDigest(coding),
                 lambda: BatchEngine("t"),
                 lambda: W.ResidentPlanes(np.zeros((4, 512), np.uint8)),
                 lambda: C.crc32c_batch(np.zeros((2, 8), np.uint8)),
                 lambda: CH.fingerprints_batch([b"abc"]),
                 lambda: BatchMapper(crushmap_from_dict(crushmap_to_dict(
                     build_hierarchy(1, 2, 2))), 0, result_max=2),
                 lambda: ScaleHarness(n_osds=8, pg_num=64).pgmap
                 .summary_arrays(0.0, use_device=True),
                 lambda: ScaleHarness(n_osds=8, pg_num=64,
                                      placement="crush"),
                 lambda: UpmapBalancer(osdmaptool.load_osdmap(mapfile), 0),
                 lambda: osdmaptool.main([mapfile, "--upmap",
                                          str(tmp_path / "out.upmap")])):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    # the balancer maps on the CPU only when asked to
    bal = UpmapBalancer(osdmaptool.load_osdmap(mapfile), 0, device="cpu")
    assert bal.device.type == "cpu" and bal.stddev() >= 0
    assert osdmaptool.main([mapfile, "--upmap", str(tmp_path / "out.upmap"),
                            "--device", "cpu"]) == 0
    assert resolve_device("cpu").type == "cpu"
    assert create_erasure_code(PROFILE, device="cpu").engine.device.type \
        == "cpu"


def test_device_tensors_never_take_the_plain_version(monkeypatch):
    """A tensor that is not on the CPU goes to the kernel or raises;
    the plain versions are never called for it."""
    called = []
    for name in ("gf_matmul_bytes_plain", "gf_matmul_words_plain",
                 "gf_expand_words_plain", "gf_matmul_planes_plain"):
        monkeypatch.setattr(W, name,
                            lambda *a, _n=name, **k: called.append(_n))
    monkeypatch.setattr(C, "crc32c_rows_plain",
                        lambda *a, **k: called.append("crc"))
    monkeypatch.setattr(GB, "gf_matmul_gather",
                        lambda *a, **k: called.append("gather"))
    monkeypatch.setattr(BM, "gf2_packets_plain",
                        lambda *a, **k: called.append("packets"))
    monkeypatch.setattr(K7, "straw2_plain",
                        lambda *a, **k: called.append("straw2"))
    monkeypatch.setattr(CH, "gear_hashes_plain",
                        lambda *a, **k: called.append("gear"))
    monkeypatch.setattr(CO, "run_starts_plain",
                        lambda *a, **k: called.append("runs"))
    coding = rs.reed_sol_van_matrix(4, 2)
    meta = dict(device="meta")
    calls = [
        lambda: W.gf_matmul_words(
            coding, torch.empty(2, 4, 16, dtype=torch.int32, **meta)),
        lambda: W.gf_matmul_bytes(
            coding, torch.empty(2, 4, 64, dtype=torch.uint8, **meta)),
        lambda: W.gf_expand_words(
            torch.empty(2, 4, 64, dtype=torch.uint8, **meta)),
        lambda: W.gf_matmul_planes(
            coding, torch.empty(2, 128, 16, dtype=torch.int8, **meta)),
        lambda: C.crc32c_rows(
            torch.empty(2, 64, dtype=torch.uint8, **meta)),
        lambda: GB.gf_matmul_tables(
            coding, torch.empty(2, 4, 64, dtype=torch.uint8, **meta)),
        lambda: BM.gf2_packets(
            np.eye(3, dtype=np.int8),
            torch.empty(2, 3, 64, dtype=torch.uint8, **meta)),
        lambda: K7.straw2_choose(
            K7.Straw2Tables(np.zeros((1, 2)), np.zeros((1, 2)),
                            np.ones((1, 1, 2)), [2], "meta"),
            *(torch.zeros(4, dtype=torch.int32, **meta),) * 4),
        lambda: CH.gear_hashes(torch.empty(2, 64, dtype=torch.uint8, **meta)),
        lambda: CO.run_starts(torch.empty(2, 64, dtype=torch.uint8, **meta)),
    ]
    for call in calls:
        with pytest.raises((ValueError, RuntimeError)):
            call()
    assert called == []


def test_kernel_launch_path_raises_without_its_library(monkeypatch):
    """With the card's tensors but no kernel library, the launch path
    raises: there is no fallback to the plain version."""
    def no_library():
        raise build.KernelError("nvcc not found")
    monkeypatch.setattr(build, "library", no_library)
    monkeypatch.setattr(W, "_check_cuda", lambda *a, **k: None)
    monkeypatch.setattr(W, "_dispatch", lambda t, name: False)
    monkeypatch.setattr(W, "gf_matmul_words_plain",
                        lambda *a, **k: pytest.fail("plain version used"))
    before = W.GF_WORDS.launches
    with pytest.raises(build.KernelError):
        W.gf_matmul_words(rs.reed_sol_van_matrix(4, 2),
                          torch.zeros(1, 4, 8, dtype=torch.int32))
    assert W.GF_WORDS.launches == before


def test_every_kernel_is_registered_with_its_source():
    assert set(build.KERNELS) == {"gf_words", "gf_expand", "gf_planes",
                                  "crc32c_batch", "gf_bytes", "gf2_packets",
                                  "crush_straw2", "gear_hash", "run_starts",
                                  "pgmap_fold"}
    for kern in build.KERNELS.values():
        assert (REPO / kern.source).exists()
        path, line = kern.replaces.split(":")
        assert (REPO / path).exists() and int(line) > 0
    sources = {p.name for p in build._sources()}
    assert sources == {Path(k.source).name for k in build.KERNELS.values()}


def test_ctypes_signatures_match_the_c_entries():
    """Each C entry's parameters, as the source declares them, agree in
    number and kind (pointer, int, long long, double) with its ctypes
    argtypes: a mismatch would only show on the card."""
    import re
    kinds = {build._P: "p", build._I: "i", build._L: "l", build._D: "d"}
    found = {}
    for src in build._sources():
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (ctt_\w+)\(([^)]*)\)', text):
            params = [q.strip() for q in m.group(2).split(",")]
            found[m.group(1)] = "".join(
                "p" if "*" in q else "l" if "long long" in q
                else "d" if q.startswith("double") else "i"
                for q in params)
    assert set(found) == set(build._SIGNATURES)
    for name, args in build._SIGNATURES.items():
        assert found[name] == "".join(kinds[a] for a in args), name


def test_ptxas_report_names_each_kernel_variant(tmp_path, monkeypatch):
    """The build keeps each source's nvcc log; the report gives one line
    per kernel variant with its registers and spills, template
    arguments demangled."""
    log = (
        "ptxas info    : Compiling entry function '_ZN45_GLOBAL__N__ec72a2b5"
        "_12_gf_planes_cu_214b348716gf_planes_kernelILi9ELb1EEEvPKaPjPK5uint2"
        "iiixxx' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN45_GLOBAL__N__\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function "
        "'_Z15gf_bytes_kernelPK5uint4' for 'sm_90a'\n"
        "    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 77 registers\n")
    (tmp_path / "gf_planes.log").write_text(log)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    assert build.ptxas_report("gf_planes") == [
        "gf_planes_kernel<9, 1>: Used 168 registers, used 1 barriers; "
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "_Z15gf_bytes_kernelPK5uint4: Used 77 registers; "
        "8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads"]
    assert build.ptxas_report("gf_words") == []
