"""The port's ``BatchMapper`` on CRUSH's legacy bucket algorithms
(straw, list, tree, uniform), against ceph_tpu's ``BatchMapper`` and
``do_rule`` on the CPU, exactly: flat and mixed maps, skewed and zero
weights, reweights, an indep rule over tree and straw buckets, uniform
host buckets (including the indep (numrep + 1)·ftotal rule), and a
weight-set that legacy buckets ignore — families of
``tests/test_crush_jax.py``."""

import numpy as np
import pytest
import torch

from ceph_tpu.crush import build_flat_map, build_hierarchy
from ceph_tpu.crush.map import Bucket, CrushMap, Rule, Step
from test_torch_crush import _rw, check

torch.set_num_threads(1)

XS = np.arange(120, dtype=np.uint32)


def _flat(alg, n=9, weights=None):
    m = build_flat_map(n, weights=weights)
    m.bucket(-1).alg = alg
    m.bucket(-1).item_weight = 0x10000
    return m


def _mixed(alg):
    m = build_hierarchy(2, 3, 3)
    for b in m.buckets:
        if b is not None and b.type == 1:
            b.alg = alg
    return m


LEGACY = {
    "flat": lambda alg: (_flat(alg), 3, None),
    "flat-skewed": lambda alg: (_flat(alg, 11, np.random.default_rng(
        len(alg)).integers(1, 4 * 0x10000, size=11).tolist()), 3, None),
    "flat-zero-weights": lambda alg: (_flat(
        alg, 8, [0x10000, 0, 0x10000, 0x10000, 0x10000, 0x10000, 0,
                 0x10000]), 4, None),
    "mixed-hierarchy": lambda alg: (_mixed(alg), 3, None),
    "reweights": lambda alg: (_flat(alg, 10), 3, _rw(10, 7)),
}


# a uniform bucket has one item weight: no skewed or zero weights
@pytest.mark.parametrize("family,alg", [
    (f, a) for f in sorted(LEGACY) for a in ("straw", "list", "tree",
                                             "uniform")
    if a != "uniform" or f not in ("flat-skewed", "flat-zero-weights")])
def test_legacy_bucket_algorithms(family, alg):
    m, rm, w = LEGACY[family](alg)
    check(m, 0, rm, XS, weight=w)


def _legacy_indep():
    m = build_hierarchy(3, 2, 2, rule="chooseleaf_indep")
    for b in m.buckets:
        if b is not None and b.type == 1:
            b.alg = "tree"
        if b is not None and b.type == 3:
            b.alg = "straw"
    return m


def _uniform_map():
    """root (straw2) -> hosts (uniform) -> osds; rule 0 replicated,
    rule 1 EC indep."""
    m = CrushMap(types={0: "osd", 1: "host", 10: "root"})
    osd, bid, hosts = 0, -2, []
    for _ in range(8):
        hb = Bucket(id=bid, type=1, alg="uniform",
                    items=list(range(osd, osd + 4)),
                    weights=[0x10000] * 4, item_weight=0x10000)
        m.add_bucket(hb)
        hosts.append(bid)
        bid -= 1
        osd += 4
    m.add_bucket(Bucket(id=-1, type=10, items=hosts,
                        weights=[0x40000] * 8))
    m.max_devices = osd
    m.rules.append(Rule(id=0, name="repl", steps=[
        Step("take", -1), Step("chooseleaf_firstn", 0, 1), Step("emit")]))
    m.rules.append(Rule(id=1, name="ec", type="erasure", steps=[
        Step("take", -1), Step("set_chooseleaf_tries", 5),
        Step("chooseleaf_indep", 0, 1), Step("emit")]))
    return m


def _dead(n, seed, dead):
    w = _rw(n, seed)
    w[list(dead)] = 0
    return w


def _straw_with_weight_set():
    m = _flat("straw", 8)
    m.choose_args[-1] = {"weight_set": [[0x4000] * 8]}
    return m


OTHER = {
    "legacy-indep": lambda: (_legacy_indep(), 0, 4, None),
    "uniform-firstn": lambda: (_uniform_map(), 0, 3, None),
    "uniform-indep": lambda: (_uniform_map(), 1, 4, None),
    "uniform-reweights": lambda: (_uniform_map(), 0, 3,
                                  _dead(32, 5, [3])),
    # (numrep + 1)·ftotal inside a uniform bucket numrep divides
    "uniform-indep-divisible": lambda: (_uniform_map(), 1, 4,
                                        _dead(32, 9, [0, 1, 5, 9])),
    "weight-set-on-legacy-bucket": lambda: (_straw_with_weight_set(), 0, 3,
                                            None),
}


@pytest.mark.parametrize("family", sorted(OTHER))
def test_legacy_indep_uniform_and_ignored_weight_sets(family):
    m, rule, rm, w = OTHER[family]()
    check(m, rule, rm, XS, weight=w)
