"""lrc, shec, clay and the bitmatrix techniques of the port's plugin
registry against ceph_tpu's: the same chunks, the same
``minimum_to_decode`` answers and the same decodes, byte for byte; and
``ec_bench --device cpu --verify`` for each."""

import itertools

import numpy as np
import pytest
import torch

from ceph_tpu.ec import create_erasure_code as j_create
from ceph_tpu.ec import list_plugins as j_list_plugins
from ceph_tpu_torch.ec import create_erasure_code, list_plugins
from ceph_tpu_torch.tools import ec_bench

# the suite shares the CPU with timing-sensitive cluster tests: keep
# torch's intra-op pool from spinning on every core
torch.set_num_threads(1)

PROFILES = [
    {"plugin": "lrc", "k": 4, "m": 2, "l": 3},
    {"plugin": "lrc", "k": 8, "m": 4, "l": 6},
    {"plugin": "lrc", "mapping": "__DD__DD",
     "layers": '[["_cDD_cDD", ""], ["cDDD____", ""], ["____cDDD", ""]]'},
    {"plugin": "shec", "k": 4, "m": 3, "c": 2},
    {"plugin": "shec", "k": 6, "m": 4, "c": 3},
    {"plugin": "clay", "k": 4, "m": 2, "d": 5},
    {"plugin": "clay", "k": 3, "m": 3, "d": 4},
    {"plugin": "jerasure", "technique": "liberation", "k": 4, "m": 2},
    {"plugin": "jerasure", "technique": "liber8tion", "k": 6, "m": 2},
    {"plugin": "jerasure", "technique": "blaum_roth", "k": 5, "m": 2},
]
IDS = ["lrc-k4m2l3", "lrc-k8m4l6", "lrc-layers", "shec-k4m3c2",
       "shec-k6m4c3", "clay-k4m2d5", "clay-k3m3d4", "liberation",
       "liber8tion", "blaum_roth"]


def _pair(prof):
    return create_erasure_code(prof, device="cpu"), j_create(dict(prof))


@pytest.mark.parametrize("prof", PROFILES, ids=IDS)
def test_encode_identical(prof):
    ec, jec = _pair(prof)
    assert (ec.k, ec.m) == (jec.k, jec.m)
    payload = np.random.default_rng(ec.k * 7 + ec.m).integers(
        0, 256, size=5000, dtype=np.uint8).tobytes()
    assert ec.get_chunk_size(5000) == jec.get_chunk_size(5000)
    want = set(range(ec.k + ec.m))
    got, jgot = ec.encode(want, payload), jec.encode(want, payload)
    for i in want:
        assert np.array_equal(got[i], np.asarray(jgot[i])), i


@pytest.mark.parametrize("prof", PROFILES, ids=IDS)
def test_minimum_to_decode_and_decode_identical(prof):
    ec, jec = _pair(prof)
    n = ec.k + ec.m
    payload = np.random.default_rng(n).integers(
        0, 256, size=3000, dtype=np.uint8).tobytes()
    chunks = ec.encode(set(range(n)), payload)
    patterns = [p for e in (1, 2)
                for p in itertools.combinations(range(n), e)][:12]
    for lost in patterns:
        avail = set(range(n)) - set(lost)
        for want in (set(lost), set(range(ec.k))):
            try:
                jreads = jec.minimum_to_decode(want, avail)
            except Exception:               # noqa: BLE001
                with pytest.raises(Exception):
                    ec.minimum_to_decode(want, avail)
                continue
            reads = ec.minimum_to_decode(want, avail)
            assert reads == jreads, (lost, want)
            sub = {i: chunks[i] for i in reads}
            got, jgot = ec.decode(want, sub), jec.decode(want, sub)
            for i in want:
                assert np.array_equal(got[i], chunks[i]), (lost, i)
                assert np.array_equal(got[i], np.asarray(jgot[i]))


def test_clay_repair_identical():
    ec, jec = _pair({"plugin": "clay", "k": 4, "m": 2, "d": 5})
    payload = np.random.default_rng(4).integers(
        0, 256, size=4096, dtype=np.uint8).tobytes()
    chunks = ec.encode(set(range(6)), payload)
    chunk = chunks[0].size
    lost = 2
    avail = set(range(6)) - {lost}
    runs = ec.minimum_to_decode_with_subchunks({lost}, avail)
    assert runs == jec.minimum_to_decode_with_subchunks({lost}, avail)
    planes = ec.repair_planes(lost)
    helpers = {h: chunks[h].reshape(ec.sub_chunk_count, -1)[planes]
               for h in avail}
    got = ec.repair_chunk(lost, helpers, chunk)
    assert np.array_equal(got, chunks[lost])
    assert np.array_equal(got, jec.repair_chunk(lost, helpers, chunk))


def test_registry_lists_all_plugins():
    assert list_plugins() == ["clay", "isa", "jerasure", "lrc", "shec",
                              "torch_cuda"]
    assert set(list_plugins()) - {"torch_cuda"} \
        == set(j_list_plugins()) - {"jax_tpu"}


@pytest.mark.parametrize("prof", [PROFILES[i] for i in (0, 3, 5, 7, 8, 9)],
                         ids=[IDS[i] for i in (0, 3, 5, 7, 8, 9)])
@pytest.mark.parametrize("workload", ["encode", "decode"])
def test_ec_bench_verifies_on_cpu(prof, workload):
    params = [a for key, val in prof.items()
              for a in ("--parameter", f"{key}={val}")]
    res = ec_bench.run(["--device", "cpu", "--workload", workload,
                        "--size", "32768", "--batch", "2",
                        "--iterations", "1", "--erased", "0",
                        "--erased", "1", "--verify", "--json", *params])
    assert res["verified"] and res["plugin"] == prof["plugin"]
    ec = create_erasure_code(prof, device="cpu")
    assert (res["k"], res["m"]) == (ec.k, ec.m)
    assert res["chunk"] == ec.get_chunk_size(32768)


def test_ec_bench_verify_catches_bad_parity(monkeypatch):
    """--verify holds an engine-less plugin (lrc) to its layer oracle."""
    from ceph_tpu_torch.ec.lrc import ErasureCodeLrc
    real = ErasureCodeLrc._encode_chunks

    def bad(self, data):
        out = real(self, data)
        out[0, 0] ^= 1
        return out
    monkeypatch.setattr(ErasureCodeLrc, "_encode_chunks", bad)
    with pytest.raises(AssertionError, match="parity mismatch"):
        ec_bench.run(["--device", "cpu", "--plugin", "lrc", "--size",
                      "32768", "--parameter", "k=4", "--parameter", "m=2",
                      "--parameter", "l=3", "--verify"])
