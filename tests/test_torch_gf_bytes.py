"""K4's port (``ceph_tpu_torch.ops.gf_bytes``) and ``GFLinear``'s routes
against ceph_tpu's ``GFLinear(backend="pallas-v1-interpret")`` and
``gf_jax.gf_matmul_gather``.

Same seeded numpy inputs through both packages; the port runs its plain
PyTorch versions on the CPU, ceph_tpu its v1 Pallas kernel in interpret
mode.  Tolerance: exact byte identity (integer math).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ops import gf_jax
from ceph_tpu.ops.gf_jax import GFLinear as JGFLinear
from ceph_tpu_torch.ops import gf_bytes as GB
from ceph_tpu_torch.ops import rs
from ceph_tpu_torch.ops.gf import GF_MUL_TABLE
from ceph_tpu_torch.ops.gf_torch import GFLinear, gf_matmul_gather

# the suite shares the CPU with timing-sensitive cluster tests: keep
# torch's intra-op pool from spinning on every core
torch.set_num_threads(1)


@pytest.mark.parametrize("k,m", [(2, 1), (4, 2), (8, 3)])
@pytest.mark.parametrize("batch,chunk", [((), 128), ((3,), 256),
                                         ((2,), 200)])
def test_bytes_route_matches_pallas_v1(k, m, batch, chunk):
    coding = rs.reed_sol_van_matrix(k, m)
    rng = np.random.default_rng(k * 100 + m)
    data = rng.integers(0, 256, size=(*batch, k, chunk), dtype=np.uint8)
    want = np.asarray(JGFLinear(coding, backend="pallas-v1-interpret")(data))
    got = GFLinear(coding, backend="bytes", device="cpu")(data)
    assert got.shape == (*batch, m, chunk)
    assert np.array_equal(got.numpy(), want)
    gather = GFLinear(coding, use_bits=False, device="cpu")
    assert gather.backend == "bytes"
    assert np.array_equal(gather(data).numpy(), want)


def test_bytes_route_decode_roundtrip():
    k, m = 4, 2
    coding = rs.reed_sol_van_matrix(k, m)
    data = np.random.default_rng(7).integers(0, 256, size=(k, 384),
                                             dtype=np.uint8)
    parity = GFLinear(coding, backend="bytes", device="cpu")(data).numpy()
    jparity = np.asarray(JGFLinear(coding,
                                   backend="pallas-v1-interpret")(data))
    assert np.array_equal(parity, jparity)
    erasures = [0, 2]
    dm = rs.decode_matrix(coding, k, erasures)
    survivors = [i for i in range(k + m) if i not in erasures][:k]
    stack = np.stack([data[i] if i < k else parity[i - k]
                      for i in survivors])
    out = GFLinear(dm, backend="bytes", device="cpu")(stack).numpy()
    assert np.array_equal(out, data)
    assert np.array_equal(
        out, np.asarray(JGFLinear(dm, backend="pallas-v1-interpret")(stack)))


@pytest.mark.parametrize("k,m,shape", [(4, 2, (3, 64)), (8, 3, (2, 5, 100)),
                                       (8, 4, (17,))])
def test_gather_matches_jax(k, m, shape):
    coding = rs.reed_sol_van_matrix(k, m)
    rng = np.random.default_rng(k + m)
    data = rng.integers(0, 256, size=(*shape[:-1], k, shape[-1]),
                        dtype=np.uint8)
    want = np.asarray(gf_jax.gf_matmul_gather(jnp.asarray(coding), data))
    got = gf_matmul_gather(coding, torch.from_numpy(data))
    assert np.array_equal(got.numpy(), want)


def test_k_plus_m_255():
    """The widest matrices GF(2^8) codes take: k + m = 255 at n = 8."""
    k, m = 223, 32
    rng = np.random.default_rng(255)
    coding = rng.integers(0, 256, size=(m, k), dtype=np.uint8)
    data = rng.integers(0, 256, size=(2, k, 8), dtype=np.uint8)
    want = np.asarray(gf_jax.gf_matmul_gather(jnp.asarray(coding), data))
    assert np.array_equal(
        gf_matmul_gather(coding, torch.from_numpy(data)).numpy(), want)
    assert np.array_equal(
        GFLinear(coding, backend="bytes", device="cpu")(data).numpy(), want)


def test_nibble_tables_split_every_product():
    rng = np.random.default_rng(3)
    coding = rng.integers(0, 256, size=(5, 7), dtype=np.uint8)
    tab = GB.nibble_tables(coding)
    assert tab.shape == (5, 7, 8) and tab.dtype == np.uint32
    lohi = tab.view(np.uint8).reshape(5, 7, 32)
    v = np.arange(256)
    for j in range(5):
        for i in range(7):
            assert np.array_equal(lohi[j, i, v & 15] ^ lohi[j, i, 16 + (v >> 4)],
                                  GF_MUL_TABLE[coding[j, i], v])


def test_routes_agree_and_bad_routes_raise():
    coding = rs.reed_sol_van_matrix(6, 3)
    data = np.random.default_rng(5).integers(0, 256, size=(2, 6, 96),
                                             dtype=np.uint8)
    outs = {r: GFLinear(coding, backend=r, device="cpu")(data).numpy()
            for r in GFLinear.ROUTES}
    want = np.asarray(JGFLinear(coding, backend="xla")(data))
    for route, out in outs.items():
        assert np.array_equal(out, want), route
    assert GFLinear(coding, device="cpu").backend == "words"
    with pytest.raises(ValueError, match="backend"):
        GFLinear(coding, backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="use_bits"):
        GFLinear(coding, use_bits=False, backend="words", device="cpu")
