"""The port's CRUSH placement against ceph_tpu's, on the CPU.

- ``crush_ln`` over all 65536 inputs (its overshooting inputs included),
  the three rjenkins hashes on 10^4 random triples, and K7's plain draw
  and choose against ``jax_mapper._straw2_draws`` and
  ``mapper.bucket_straw2_choose``;
- the port's ``BatchMapper(device="cpu")`` against ceph_tpu's
  ``BatchMapper`` and its scalar ``do_rule``, exactly, on flat and
  hierarchy firstn maps, chooseleaf indep with holes, reweights, chunk
  boundaries, short reweight vectors, multi-block rules and weight-only
  rebinds.  ``test_torch_crush_rules.py`` holds the rule families.

Every map is built with ceph_tpu's builders and carried into the port as
its dict form (``crushmap_to_dict`` → the port's ``crushmap_from_dict``).
The tolerance is exact equality everywhere.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.crush import build_flat_map, build_hierarchy
from ceph_tpu.crush import hash as JH
from ceph_tpu.crush import ln as JL
from ceph_tpu.crush import mapper as JM
from ceph_tpu.crush.compiler import crushmap_to_dict
from ceph_tpu.crush.jax_mapper import BatchMapper as JBatchMapper
from ceph_tpu.crush.jax_mapper import _ln16_s_tbl, _straw2_draws
from ceph_tpu.crush.map import Bucket, CrushMap, Rule, Step
from ceph_tpu_torch.crush import hash as PH
from ceph_tpu_torch.crush import ln as PL
from ceph_tpu_torch.crush import mapper as PM
from ceph_tpu_torch.crush import straw2 as K7
from ceph_tpu_torch.crush import torch_mapper as TM
from ceph_tpu_torch.crush.compiler import crushmap_from_dict
from ceph_tpu_torch.crush.map import CRUSH_ITEM_NONE
from ceph_tpu_torch.crush.torch_mapper import BatchMapper

torch.set_num_threads(1)

XS = np.arange(200, dtype=np.uint32)


def port_map(jmap):
    return crushmap_from_dict(crushmap_to_dict(jmap))


def oracle(jmap, rule, xs, result_max, weight=None):
    w = None if weight is None else [int(v) for v in weight]
    out = np.full((len(xs), result_max), CRUSH_ITEM_NONE, dtype=np.int32)
    for j, x in enumerate(xs):
        r = JM.do_rule(jmap, rule, int(x), result_max, w)
        out[j, :len(r)] = r
    return out


def check(jmap, rule, result_max, xs=XS, weight=None, chunk=1 << 8):
    """Port mapper == ceph_tpu's BatchMapper == do_rule, row by row."""
    pm = BatchMapper(port_map(jmap), rule, result_max=result_max,
                     chunk=chunk, device="cpu")
    got = pm(xs, reweight=weight)
    jgot = JBatchMapper(jmap, rule, result_max=result_max,
                        chunk=chunk)(xs, reweight=weight)
    want = oracle(jmap, rule, xs, pm.result_max, weight)
    for name, arr in (("port", got), ("ceph_tpu", jgot)):
        bad = np.nonzero(~(arr == want).all(axis=1))[0]
        assert bad.size == 0, (
            f"{name}: {bad.size}/{len(xs)} differ; first x={xs[bad[0]]}: "
            f"{arr[bad[0]].tolist()} != do_rule {want[bad[0]].tolist()}")
    return got


# -- the primitives --------------------------------------------------------

def test_crush_ln_all_inputs_with_the_overshoot_quirk():
    u = np.arange(0x10000, dtype=np.uint64)
    got = PL.crush_ln(u)
    assert np.array_equal(got, JL.crush_ln(u))
    assert np.array_equal(PL.RH_LH_TBL, JL.RH_LH_TBL)
    assert np.array_equal(PL.LL_TBL, JL.LL_TBL)
    assert np.array_equal(K7.ln16_s_table(), _ln16_s_tbl())
    # the inputs past a coarse-segment boundary overshoot the exact log
    # by ~2^48·log2(1 + 255/2^15)/16: kept, not repaired
    exact = 2.0 ** 44 * np.log2(u.astype(np.float64) + 1)
    quirk = got.astype(np.float64) - exact > 1e11
    assert 300 < quirk.sum() < 600


@pytest.mark.parametrize("arity", [2, 3, 4])
def test_rjenkins_hashes_on_random_triples(arity):
    rng = np.random.default_rng(arity)
    args = [rng.integers(0, 1 << 32, size=10_000, dtype=np.uint64
                         ).astype(np.uint32) for _ in range(arity)]
    # negative item ids hash as their u32 bits
    args[1][::7] = (-1 - np.arange(len(args[1][::7]))).astype(np.uint32)
    jfn = getattr(JH, f"crush_hash32_{arity}")
    want = jfn(*args)
    assert np.array_equal(getattr(PH, f"crush_hash32_{arity}")(*args), want)
    tfn = getattr(K7, f"hash32_{arity}")
    got = tfn(*(torch.from_numpy(a.astype(np.int64)) for a in args))
    assert np.array_equal(got.numpy().astype(np.uint32), want)
    assert PH.ceph_str_hash_rjenkins(b"object-17") == \
        JH.ceph_str_hash_rjenkins(b"object-17")


def test_plain_straw2_draws_match_jax():
    rng = np.random.default_rng(5)
    u = rng.integers(0, 0x10000, size=(64, 33), dtype=np.int64)
    u[0, :16] = np.arange(16)            # the wrapping shift (u <= 255)
    w = rng.integers(0, 5 * 0x10000, size=(64, 33), dtype=np.int64)
    w[:, ::5] = 0
    w[1] = 1
    import jax.numpy as jnp
    want = np.asarray(_straw2_draws(jnp.asarray(u.astype(np.uint32)),
                                    jnp.asarray(w)))
    got = K7.straw2_draws(torch.from_numpy(u), torch.from_numpy(w),
                          torch.from_numpy(K7.ln16_s_table()))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("positions", [1, 3])
def test_plain_straw2_choose_matches_the_oracle(positions):
    """K7's plain version on a table of buckets of sizes 1..65 (zero
    weights, an all-zero bucket, choose_args ids and weight sets) equals
    ``bucket_straw2_choose`` lane by lane."""
    rng = np.random.default_rng(positions)
    cmap = CrushMap()
    sizes = [1, 3, 65, 7, 12]
    for row, size in enumerate(sizes):
        w = rng.integers(0, 3 * 0x10000, size=size).tolist()
        if row == 3:
            w = [0] * size                       # all-zero bucket
        cmap.add_bucket(Bucket(id=-1 - row, type=1,
                               items=list(range(100 * row, 100 * row + size)),
                               weights=w))
    cmap.choose_args[-3] = {
        "ids": [int(v) for v in rng.integers(0, 1 << 31, size=65)],
        "weight_set": [rng.integers(1, 0x20000, size=65).tolist()
                       for _ in range(positions)]}
    S, nb = max(sizes), len(sizes)
    items = np.zeros((nb, S), np.int32)
    hids = np.zeros((nb, S), np.int32)
    weights = np.zeros((positions, nb, S), np.int64)
    for row, b in enumerate(cmap.buckets):
        items[row, :b.size] = b.items
        arg = cmap.choose_args.get(b.id, {})
        hids[row, :b.size] = arg.get("ids", b.items)
        for p in range(positions):
            weights[p, row, :b.size] = (arg["weight_set"][p] if arg
                                        else b.weights)
    tab = K7.Straw2Tables(items, hids, weights, sizes, "cpu")
    n = 3000
    rows = rng.integers(0, nb, size=n)
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.int64)
    r = rng.integers(0, 60, size=n)
    pos = rng.integers(0, 4, size=n)
    got = K7.straw2_choose(tab, *(torch.from_numpy(a) for a in
                                  (rows, x, r, pos)))
    want = [JM.bucket_straw2_choose(cmap, cmap.buckets[rows[i]], int(x[i]),
                                    int(r[i]), int(pos[i]))
            for i in range(n)]
    assert got.tolist() == want


# -- the mapper ------------------------------------------------------------

def _skewed_hierarchy(rule="chooseleaf_firstn"):
    m = build_hierarchy(4, 3, 2, rule=rule)
    rng = np.random.default_rng(2)
    for b in m.buckets:
        if b is not None and b.type == 1:
            b.weights = [int(rng.integers(1, 3 * 0x10000))
                         for _ in b.items]
    for t in (3, 10):
        for b in m.buckets:
            if b is not None and b.type == t:
                b.weights = [m.bucket(h).weight for h in b.items]
    return m


def _rw(n, seed):
    return np.random.default_rng(seed).integers(
        0, 0x10001, size=n).astype(np.uint32)


def _flat_indep():
    m = build_flat_map(10)
    m.rules.append(Rule(id=1, name="flat_ec", steps=[
        Step("take", -1), Step("choose_indep", 0, 0), Step("emit")]))
    return m


FAMILIES = {
    "flat": lambda: (build_flat_map(10), 0, 3, None),
    "flat-skewed": lambda: (build_flat_map(12, weights=np.random.default_rng(
        0).integers(1, 5 * 0x10000, size=12).tolist()), 0, 3, None),
    "flat-zero-crush-weights": lambda: (build_flat_map(
        8, weights=[0x10000, 0x10000, 0] + [0x10000] * 4 + [0]), 0, 4, None),
    "flat-reweights": lambda: (build_flat_map(8), 0, 3, _rw(8, 1)),
    "flat-numrep-equals-size": lambda: (build_flat_map(4), 0, 4, None),
    "hierarchy": lambda: (build_hierarchy(3, 2, 2), 0, 3, None),
    "hierarchy-skewed": lambda: (_skewed_hierarchy(), 0, 3, None),
    "hierarchy-more-reps-than-hosts": lambda: (
        build_hierarchy(2, 2, 2), 0, 6, None),
    "hierarchy-reweights": lambda: (build_hierarchy(3, 2, 2), 0, 3,
                                    _rw(12, 3)),
    "indep": lambda: (build_hierarchy(4, 2, 2, rule="chooseleaf_indep"),
                      0, 4, None),
    "indep-holes": lambda: (build_hierarchy(2, 2, 2, rule="chooseleaf_indep"),
                            0, 6, None),
    "indep-reweights": lambda: (
        build_hierarchy(4, 2, 2, rule="chooseleaf_indep"), 0, 4, _rw(16, 4)),
    "indep-skewed": lambda: (_skewed_hierarchy("chooseleaf_indep"), 0, 5,
                             _rw(24, 5)),
    "flat-indep": lambda: (_flat_indep(), 1, 4, None),
}


# families whose retries make the scalar oracle slow map fewer inputs
SHORT = {"hierarchy-more-reps-than-hosts", "indep-holes", "indep-skewed"}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_mapper_matches_jax_and_do_rule(family):
    m, rule, rm, w = FAMILIES[family]()
    check(m, rule, rm, XS[:100] if family in SHORT else XS, weight=w)


def test_chunk_boundaries_and_short_reweights():
    m = build_hierarchy(3, 2, 2)
    xs = np.arange(200, dtype=np.uint32)     # 3 chunks + a ragged tail
    check(m, 0, 3, xs, chunk=64)
    # a short vector zero-pads: the missing devices are out
    got = check(m, 0, 3, xs, weight=np.full(9, 0x10000, np.uint32),
                chunk=64)
    assert not np.isin(got, [9, 10, 11]).any()


def test_chunk_follows_the_lane_budget(monkeypatch):
    """Without ``chunk`` a call maps as many PGs at once as
    ``CHUNK_BYTES`` of lane intermediates hold: on the CPU, where straw2
    hashes whole ``[S]`` rows, a budget of 50 such lanes cuts 200 PGs
    into four chunks, with the placements of one."""
    m = build_hierarchy(3, 2, 2)
    whole = BatchMapper(port_map(m), 0, result_max=3, device="cpu")
    assert whole._chunk() >= len(XS)
    want = whole(XS)
    monkeypatch.setattr(TM, "CHUNK_BYTES", 50 * 96 * whole._S)
    pm = BatchMapper(port_map(m), 0, result_max=3, device="cpu")
    assert pm._chunk() == 50
    assert np.array_equal(pm(XS), want)
    assert np.array_equal(want, oracle(m, 0, XS, 3))


def _two_root_map():
    """ssd and hdd roots in one map, for hybrid multi-block rules."""
    m = CrushMap(types={0: "osd", 1: "host", 10: "root"})
    osd, bid = 0, -3
    roots = {}
    for root_id in (-1, -2):
        hosts = []
        for _ in range(3):
            hb = Bucket(id=bid, type=1, items=list(range(osd, osd + 4)),
                        weights=[0x10000] * 4)
            m.add_bucket(hb)
            hosts.append(bid)
            bid -= 1
            osd += 4
        roots[root_id] = hosts
    for root_id, hosts in roots.items():
        m.add_bucket(Bucket(id=root_id, type=10, items=hosts,
                            weights=[0x40000] * 3))
    m.max_devices = osd
    for rid, second in ((0, 2), (1, 0), (2, -1)):
        m.rules.append(Rule(id=rid, name=f"hybrid{rid}", steps=[
            Step("take", -1), Step("chooseleaf_firstn", 1, 1),
            Step("emit"),
            Step("take", -2), Step("chooseleaf_firstn", second, 1),
            Step("emit")]))
    return m


@pytest.mark.parametrize("rule,result_max,out", [
    (0, None, None), (1, 4, None), (2, 4, None), (0, None, [0, 13]),
    (0, None, list(range(12))), (0, None, list(range(11))),
    (1, 4, list(range(11)))],
    ids=["hybrid", "numrep-zero", "numrep-negative", "reweights",
         "first-block-out", "first-block-short", "numrep-zero-short"])
def test_multiblock_rules(rule, result_max, out):
    """A first block that comes up short (its root's OSDs all or nearly
    all out) leaves no slot: the second block's items move up."""
    m = _two_root_map()
    w = None
    if out is not None:
        w = _rw(m.max_devices, 7)
        w[out] = 0
    pm = BatchMapper(port_map(m), rule, result_max=result_max, chunk=128,
                     device="cpu")
    jm = JBatchMapper(m, rule, result_max=result_max, chunk=128)
    assert pm.result_max == jm.result_max
    got, jgot = pm(XS, reweight=w), jm(XS, reweight=w)
    assert np.array_equal(got, jgot)
    assert np.array_equal(got, oracle(m, rule, XS, pm.result_max, w))


def test_weight_only_rebind():
    """set_weights and remap rebind the weight tables; a topology change
    is refused."""
    m = build_hierarchy(2, 3, 2)
    pm = BatchMapper(port_map(m), 0, result_max=3, device="cpu")
    host = next(b for b in m.buckets if b is not None and b.type == 1)
    skew = [0x4000, 0x30000]
    pm.remap({host.id: skew})
    host.weights = skew
    assert np.array_equal(pm(XS), oracle(m, 0, XS, 3))
    pm.set_weights(port_map(m))
    assert np.array_equal(pm(XS), oracle(m, 0, XS, 3))
    assert pm.cache_hit is False
    with pytest.raises(ValueError):
        pm.set_weights(port_map(build_hierarchy(2, 3, 3)))


def test_refusals_match_ceph_tpu():
    m = build_hierarchy(2, 2, 2)
    m.tunables.choose_local_tries = 2
    for cls in (BatchMapper, JBatchMapper):
        kw = {"device": "cpu"} if cls is BatchMapper else {}
        mm = port_map(m) if cls is BatchMapper else m
        with pytest.raises(NotImplementedError):
            cls(mm, 0, result_max=3, **kw)
    m = build_hierarchy(2, 2, 2)
    m.rules[0] = Rule(id=0, name="mid", steps=[
        Step("take", -1), Step("chooseleaf_firstn", 2, 3),
        Step("choose_firstn", 1, 0), Step("emit")])
    with pytest.raises(NotImplementedError):
        BatchMapper(port_map(m), 0, result_max=2, device="cpu")
    with pytest.raises(NotImplementedError):
        JBatchMapper(m, 0, result_max=2)


def test_the_port_copies_equal_ceph_tpu_on_the_oracle():
    """The copied scalar oracle gives ceph_tpu's placements."""
    m = build_hierarchy(3, 2, 2, rule="chooseleaf_indep")
    pmap = port_map(m)
    w = [int(v) for v in _rw(12, 9)]
    for x in range(64):
        assert PM.do_rule(pmap, 0, x, 4, w) == JM.do_rule(m, 0, x, 4, w)


def test_bench_measure_checks_the_oracle_before_timing():
    from ceph_tpu_torch.crush import bench
    res = bench.measure(osds=64, pgs=512, device="cpu", sample=16)
    assert res["osds"] == 64 and res["oracle_sample"] == 16
    assert res["placed"] == 3 * 512 and res["pgs_per_sec"] > 0
