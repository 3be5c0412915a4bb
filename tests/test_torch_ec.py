"""The port's EC plugins (``ceph_tpu_torch.ec``) against ceph_tpu's: the
same profile gives the same coding matrix, the same chunks and the
same decodes, byte for byte."""

import itertools

import numpy as np
import pytest
import torch

from ceph_tpu.ec import create_erasure_code as j_create
from ceph_tpu_torch.ec import ECError, create_erasure_code, list_plugins
from ceph_tpu_torch.ec.torch_backend import MatrixECEngine

# the suite shares the CPU with timing-sensitive cluster tests: keep
# torch's intra-op pool from spinning on every core
torch.set_num_threads(1)

PROFILES = [
    ("jerasure", "reed_sol_van", 4, 2),
    ("jerasure", "reed_sol_van", 8, 3),
    ("jerasure", "reed_sol_r6_op", 4, 2),
    ("jerasure", "cauchy_orig", 6, 3),
    ("jerasure", "cauchy_good", 8, 4),
    ("isa", "reed_sol_van", 8, 3),
    ("isa", "cauchy", 4, 2),
    ("torch_cuda", "reed_sol_van", 8, 3),
]


def _pair(plugin, technique, k, m):
    prof = {"plugin": plugin, "technique": technique, "k": k, "m": m}
    jprof = dict(prof, plugin="jax_tpu" if plugin == "torch_cuda"
                 else plugin)
    return create_erasure_code(prof, device="cpu"), j_create(jprof)


@pytest.mark.parametrize("plugin,technique,k,m", PROFILES)
def test_encode_identical(plugin, technique, k, m):
    ec, jec = _pair(plugin, technique, k, m)
    assert np.array_equal(ec.coding_matrix, jec.coding_matrix)
    payload = np.random.default_rng(k * m).integers(
        0, 256, size=5000, dtype=np.uint8).tobytes()
    assert ec.get_chunk_size(5000) == jec.get_chunk_size(5000)
    want = set(range(k + m))
    got, jgot = ec.encode(want, payload), jec.encode(want, payload)
    for i in want:
        assert np.array_equal(got[i], np.asarray(jgot[i])), i


@pytest.mark.parametrize("plugin,technique,k,m", PROFILES)
def test_decode_identical(plugin, technique, k, m):
    ec, jec = _pair(plugin, technique, k, m)
    payload = np.random.default_rng(k + m).integers(
        0, 256, size=3000, dtype=np.uint8).tobytes()
    chunks = ec.encode(set(range(k + m)), payload)
    patterns = list(itertools.combinations(range(k + m), m))[:6]
    for lost in patterns:
        avail = {i: c for i, c in chunks.items() if i not in lost}
        want = set(lost) | {0}
        assert ec.minimum_to_decode(want, set(avail)) \
            == jec.minimum_to_decode(want, set(avail))
        got, jgot = ec.decode(want, avail), jec.decode(want, avail)
        for i in want:
            assert np.array_equal(got[i], chunks[i])
            assert np.array_equal(got[i], np.asarray(jgot[i]))


def test_decode_batch_matches_jax():
    ec, jec = _pair("jerasure", "reed_sol_van", 8, 3)
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, size=(3, 8, 512), dtype=np.uint8)
    parity = ec.engine.encode(data)
    assert np.array_equal(parity, np.asarray(jec.engine.encode(data)))
    full = np.concatenate([data, parity], axis=1)
    erasures = (0, 9)
    surv = [i for i in range(11) if i not in erasures][:8]
    got = ec.engine.decode_batch(full[:, surv], erasures)
    assert np.array_equal(got, data)
    assert np.array_equal(
        got, np.asarray(jec.engine.decode_batch(full[:, surv], erasures)))


def test_from_coding_uses_the_same_matrix():
    _ec, jec = _pair("isa", "reed_sol_van", 8, 3)
    eng = MatrixECEngine.from_coding(jec.coding_matrix, 8, 3, device="cpu")
    data = np.random.default_rng(2).integers(0, 256, size=(8, 64),
                                             dtype=np.uint8)
    assert np.array_equal(eng.encode(data),
                          np.asarray(jec.engine.encode(data)))


@pytest.mark.parametrize("technique", ["liberation", "liber8tion",
                                       "blaum_roth"])
def test_bitmatrix_techniques_raise(technique):
    """The bitmatrix techniques are RAID-6 codes: any m but 2 raises, as
    in ceph_tpu; m=2 builds on the bitmatrix engine."""
    with pytest.raises(ECError, match="m=2"):
        create_erasure_code({"plugin": "jerasure", "technique": technique,
                             "k": 4, "m": 3}, device="cpu")
    ec = create_erasure_code({"plugin": "jerasure", "technique": technique,
                              "k": 4, "m": 2}, device="cpu")
    assert type(ec.engine).__name__ == "BitMatrixECEngine"


def test_registry():
    assert {"jerasure", "isa", "torch_cuda", "lrc", "shec", "clay"} \
        <= set(list_plugins())
    with pytest.raises(ECError, match="unknown"):
        create_erasure_code({"plugin": "nope", "k": 4, "m": 2}, device="cpu")


@pytest.mark.parametrize("workload", ["encode", "decode"])
def test_ec_bench_verifies_on_cpu(workload, capsys):
    from ceph_tpu_torch.tools import ec_bench
    res = ec_bench.run(["--device", "cpu", "--workload", workload,
                        "--size", "65536", "--batch", "3",
                        "--iterations", "2", "--parameter", "k=8",
                        "--parameter", "m=3", "--erased", "0",
                        "--erased", "9", "--verify", "--json"])
    assert res["verified"] and res["plugin"] == "torch_cuda"
    assert (res["k"], res["m"], res["chunk"]) == (8, 3, 8192)
    assert '"GBps"' in capsys.readouterr().out
