"""The port's ``BatchMapper`` on CRUSH's rule families, against ceph_tpu's
``BatchMapper`` and ``do_rule`` on the CPU, exactly: multi-step chains,
the legacy tunables (vary_r, stable, set_* steps), and choose_args
weight-sets and id substitution — families of ``tests/test_crush_jax.py``
(the legacy bucket algorithms are in ``test_torch_crush_algs.py``).

Two cases are held against ``do_rule`` alone, because ceph_tpu's batched
mapper departs from its own oracle there: an indep rule under
multi-position weight-sets (ceph_tpu draws the top level at position
``rep``, ``do_rule`` at the call's ``outpos``) and an indep step whose
numrep exceeds result_max (ceph_tpu strides r by the capped count).
"""

import numpy as np
import pytest
import torch

from ceph_tpu.crush import build_flat_map, build_hierarchy
from ceph_tpu.crush.map import Rule, Step
from ceph_tpu_torch.crush.torch_mapper import BatchMapper
from test_torch_crush import _rw, check, oracle, port_map

torch.set_num_threads(1)

XS = np.arange(120, dtype=np.uint32)


def _rack_rule(nracks=3, hosts=3, osds=2, r1=2, r2=2):
    m = build_hierarchy(nracks, hosts, osds)
    m.rules[0] = Rule(id=0, name="racked", steps=[
        Step("take", -1), Step("choose_firstn", r1, 3),
        Step("chooseleaf_firstn", r2, 1), Step("emit")])
    return m


def _rule(m, steps):
    m.rules[0] = Rule(id=0, name="r", steps=[Step(*s) for s in steps])
    return m


def _tunables(m, **kw):
    for k, v in kw.items():
        setattr(m.tunables, k, v)
    return m


CHAINS = {
    "choose-then-chooseleaf": lambda: (_rack_rule(), 4, None),
    "collisions": lambda: (_rack_rule(2, 2, 2), 4, None),
    "numrep-zero": lambda: (_rack_rule(r1=0, r2=1), 2, None),
    "three-level": lambda: (_rule(build_hierarchy(2, 2, 2), [
        ("take", -1), ("choose_firstn", 2, 3), ("choose_firstn", 1, 1),
        ("choose_firstn", 1, 0), ("emit",)]), 2, None),
    "underfilled": lambda: (_rule(build_hierarchy(2, 2, 2), [
        ("take", -1), ("choose_firstn", 3, 3),
        ("chooseleaf_firstn", 1, 1), ("emit",)]), 3, None),
    "reweights": lambda: (_rack_rule(), 4, _rw(18, 11)),
    "stable0": lambda: (_tunables(build_hierarchy(3, 2, 2),
                                  chooseleaf_stable=0), 3, None),
    "vary_r0": lambda: (_tunables(build_hierarchy(3, 2, 2),
                                  chooseleaf_vary_r=0), 3, None),
    "stable0-vary_r0": lambda: (_tunables(
        build_hierarchy(2, 3, 2), chooseleaf_stable=0,
        chooseleaf_vary_r=0), 4, None),
    "vary_r2": lambda: (_tunables(build_hierarchy(3, 2, 2),
                                  chooseleaf_vary_r=2), 3, None),
    "stable0-chain": lambda: (_tunables(_rack_rule(), chooseleaf_stable=0),
                              4, None),
    "set-steps": lambda: (_rule(build_hierarchy(3, 2, 2), [
        ("take", -1), ("set_chooseleaf_stable", 0, 0),
        ("set_chooseleaf_vary_r", 0, 0), ("set_choose_tries", 80, 0),
        ("chooseleaf_firstn", 0, 1), ("emit",)]), 3, None),
    "legacy-profile": lambda: (_tunables(
        build_hierarchy(3, 2, 2), choose_total_tries=19,
        chooseleaf_descend_once=0, chooseleaf_vary_r=0,
        chooseleaf_stable=0), 3, _rw(12, 12)),
}


@pytest.mark.parametrize("family", sorted(CHAINS))
def test_chains_and_tunables(family):
    m, rm, w = CHAINS[family]()
    check(m, 0, rm, XS, weight=w)


def _weight_sets(m, buckets, sets):
    for b in buckets:
        m.choose_args[b.id] = {"weight_set": sets(b)}
    return m


def _hosts(m):
    return [b for b in m.buckets if b is not None and b.type == 1]


def _one_host_set():
    m = build_hierarchy(2, 3, 2)
    return _weight_sets(m, _hosts(m)[:1], lambda b: [[0x4000, 0x18000]])


def _root_sets(m, sets):
    return _weight_sets(m, [m.bucket(-1)], sets)


def _ids_map():
    m = build_flat_map(6)
    m.choose_args[-1] = {"ids": [100 + i for i in range(6)]}
    return m


def _leaf_sets():
    m = build_hierarchy(1, 3, 3)
    return _weight_sets(m, _hosts(m), lambda b: [
        [0x10000] * b.size, [0x4000 * (i + 1) for i in range(b.size)]])


CHOOSE_ARGS = {
    "single-position": _one_host_set,
    "per-position": lambda: _root_sets(build_flat_map(8), lambda b: [
        [0x10000] * 8, [(i + 1) * 0x3000 for i in range(8)],
        [0x20000, 0x1000] * 4]),
    "ids": _ids_map,
    "zero-position": lambda: _root_sets(build_hierarchy(2, 2, 3), lambda b: [
        [0x8000] * b.size, [0x20000] * b.size]),
    "multi-position-chooseleaf": _leaf_sets,
}


@pytest.mark.parametrize("family", sorted(CHOOSE_ARGS))
def test_choose_args(family):
    m = CHOOSE_ARGS[family]()
    check(m, 0, 4 if family == "zero-position" else 3, XS)


def _indep_weight_sets():
    m = build_hierarchy(1, 4, 3, rule="chooseleaf_indep")
    for b in m.buckets:
        if b is not None and b.type in (1, 3):
            n = b.size
            m.choose_args[b.id] = {"weight_set": [
                [0x10000] * n, [0x4000 * (i + 1) for i in range(n)],
                [0x30000 - 0x8000 * i for i in range(n)]]}
    return m, 0, 4, None


def _indep_numrep_over_result_max():
    m = build_flat_map(10)
    m.rules.append(Rule(id=1, name="ec6", steps=[
        Step("take", -1), Step("choose_indep", 6, 0), Step("emit")]))
    return m, 1, 4, _rw(10, 3)


@pytest.mark.parametrize("case", [_indep_weight_sets,
                                  _indep_numrep_over_result_max],
                         ids=["indep-weight-sets", "indep-numrep-over-max"])
def test_indep_cases_against_do_rule(case):
    m, rule, rm, w = case()
    xs = XS
    got = BatchMapper(port_map(m), rule, result_max=rm,
                      device="cpu")(xs, reweight=w)
    assert np.array_equal(got, oracle(m, rule, xs, rm, w))
