"""The port's upmap balancer against ceph_tpu's, on the CPU.

The same maps go to both packages: ``tests/test_balancer.py``'s two
offline hierarchies (the port maps with ``device="cpu"``, the plain
version of K7; ceph_tpu with its JAX mapper on the CPU), the ``FAST``
``ScaleHarness`` twins of ``tests/test_scale_harness.py`` (injected
placements, no mapper), and ``osdmaptool --upmap`` on a map that
ceph_tpu's ``--createsimple`` wrote.  Proposals must be equal round for
round, and ``pg_upmap_items`` and ``stddev()`` equal after the rounds.
``optimize`` mutates its map, so every side runs on a map of its own.
"""

import json
from pathlib import Path

import numpy as np
import pytest

import ceph_tpu.mgr.balancer as RB
import ceph_tpu.vstart as RV
from ceph_tpu.crush.map import build_hierarchy as ref_build_hierarchy
from ceph_tpu.osd import osdmap as RO
from ceph_tpu.tools import osdmaptool as J
from ceph_tpu_torch.crush.map import CRUSH_ITEM_NONE, build_hierarchy
from ceph_tpu_torch.mgr import UpmapBalancer
from ceph_tpu_torch.osd import osdmap as PO
from ceph_tpu_torch.tools import osdmaptool as P
from ceph_tpu_torch.tools._engine import BatchedRequired
from ceph_tpu_torch.vstart import ScaleHarness

FAST = dict(n_osds=64, pg_num=16384, seed=11, down_osds=2,
            stale_frac=0.001, damaged_frac=5e-4, scrub_late_frac=5e-3)


def hier_map(mod, build, racks, hosts, osds, pg_num, size):
    """``tests/test_balancer.py::_hier_map`` for either package."""
    n = racks * hosts * osds
    m = mod.OSDMap(crush=build(racks, hosts, osds), max_osd=n)
    m.epoch = 1
    for o in range(n):
        m.osd_state[o] = mod.EXISTS | mod.UP
    m.create_pool("bench", pg_num=pg_num, size=size, crush_rule=0)
    return m


def as_pairs(props):
    """Proposals keyed by the pgid's text, so both packages compare."""
    return {str(k): [tuple(map(int, p)) for p in v]
            for k, v in props.items()}


def upmaps(m):
    return as_pairs(m.pg_upmap_items)


@pytest.mark.parametrize("use_arrays", [True, False],
                         ids=["arrays", "legacy"])
@pytest.mark.parametrize("shape", [(4, 8, 8, 2048, 3), (2, 4, 4, 256, 2)],
                         ids=["256osd", "32osd"])
def test_offline_rounds_match_ceph_tpu(shape, use_arrays):
    rm = hier_map(RO, ref_build_hierarchy, *shape)
    pm = hier_map(PO, build_hierarchy, *shape)
    rb = RB.UpmapBalancer(rm, 0)
    pb = UpmapBalancer(pm, 0, device="cpu")
    assert pb._domain_of == rb._domain_of
    assert np.array_equal(pb.pg_counts(), rb.pg_counts())
    assert pb.stddev() == rb.stddev()
    rounds = 0
    for _ in range(40):
        rp = rb.optimize(max_changes=64, deviation_stop=0.5,
                         use_arrays=use_arrays)
        pp = pb.optimize(max_changes=64, deviation_stop=0.5,
                         use_arrays=use_arrays)
        assert as_pairs(pp) == as_pairs(rp), rounds
        rounds += 1
        if not pp:
            break
    assert rounds > 1
    assert upmaps(pm) == upmaps(rm)
    assert pb.stddev() == rb.stddev()
    assert np.array_equal(pb.pg_counts(), rb.pg_counts())


def test_offline_moves_keep_the_failure_domain():
    """The port's own check of ``test_256_osds_stddev_down_5x``: the
    stddev falls at least 5x and no PG holds two replicas on a host."""
    m = hier_map(PO, build_hierarchy, 4, 8, 8, 2048, 3)
    bal = UpmapBalancer(m, 0, device="cpu")
    before = bal.stddev()
    for _ in range(40):
        if not bal.optimize(max_changes=64, deviation_stop=0.5):
            break
    assert bal.stddev() <= before / 5
    raw = P.map_pool_pgs(m, m.pools[0], device="cpu")
    for seed in range(m.pools[0].pg_num):
        row = [o for o in raw[seed] if o != CRUSH_ITEM_NONE]
        row = m._apply_upmap(PO.PGid(0, seed), row)
        hosts = [bal._domain_of[o] for o in row]
        assert len(hosts) == len(set(hosts)), (seed, row)


def test_proposals_are_incremental_items():
    m = hier_map(PO, build_hierarchy, 2, 4, 4, 256, 2)
    props = UpmapBalancer(m, 0, device="cpu").optimize(max_changes=8)
    assert props
    for pgid, items in props.items():
        assert all(isinstance(a, int) and isinstance(b, int)
                   for a, b in items)
        assert m.pg_upmap_items[pgid] == items


def test_scalar_oracle_proposes_the_batched_moves():
    maps = [hier_map(PO, build_hierarchy, 2, 4, 4, 256, 2)
            for _ in range(2)]
    a = UpmapBalancer(maps[0], 0, device="cpu").optimize(max_changes=16)
    b = UpmapBalancer(maps[1], 0, scalar=True).optimize(max_changes=16)
    assert a and as_pairs(a) == as_pairs(b)


@pytest.mark.parametrize("use_arrays", [True, False],
                         ids=["arrays", "legacy"])
def test_scale_harness_twins_match_ceph_tpu(use_arrays):
    rh, ph = RV.ScaleHarness(**FAST), ScaleHarness(**FAST)
    assert np.array_equal(ph.placements, rh.placements)
    rb, pb = rh.balancer(), ph.balancer()
    assert np.array_equal(pb.pg_counts(), rb.pg_counts())
    for _ in range(6):
        rp = rb.optimize(max_changes=16, deviation_stop=0.5,
                         use_arrays=use_arrays)
        pp = pb.optimize(max_changes=16, deviation_stop=0.5,
                         use_arrays=use_arrays)
        assert as_pairs(pp) == as_pairs(rp)
        if not pp:
            break
    assert upmaps(ph.osdmap) == upmaps(rh.osdmap)
    assert pb.stddev() == rb.stddev()


def test_scale_harness_array_round_matches_legacy_walk():
    h1, h2 = ScaleHarness(**FAST), ScaleHarness(**FAST)
    b1, b2 = h1.balancer(), h2.balancer()
    assert np.array_equal(b1.pg_counts(), b2.pg_counts(b2._placements()))
    before, before_counts = b1.stddev(), b1.pg_counts()
    moved = 0
    for _ in range(6):
        p1 = b1.optimize(max_changes=16, deviation_stop=0.5,
                         use_arrays=True)
        p2 = b2.optimize(max_changes=16, deviation_stop=0.5,
                         use_arrays=False)
        assert p1 == p2
        moved += len(p1)
        if not p1:
            break
    assert moved > 0
    assert h1.osdmap.pg_upmap_items == h2.osdmap.pg_upmap_items
    assert b1.stddev() == b2.stddev() < before
    assert b1.pg_counts().sum() == before_counts.sum()


def _run(tool, argv, capsys):
    rc = tool.main([str(a) for a in argv])
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def test_osdmaptool_upmap_matches_ceph_tpu(tmp_path, capsys, monkeypatch):
    src = tmp_path / "m.json"
    assert _run(J, [src, "--createsimple", 32, "--pg-bits", 4],
                capsys)[0] == 0
    outs = {}
    for name, tool, extra in (("ref", J, []),
                              ("port", P, ["--device", "cpu"]),
                              ("scalar", P, ["--scalar"])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)     # one path in each reply
        Path("m.json").write_text(src.read_text())
        rc, out, _err = _run(tool, ["m.json", "--upmap", "out.upmap",
                                    "--upmap-max", 40, "-o", "m.json",
                                    *extra], capsys)
        assert rc == 0
        outs[name] = (out, Path("out.upmap").read_bytes(),
                      json.loads(Path("m.json").read_text()))
    assert outs["port"] == outs["ref"]
    assert outs["scalar"] == outs["ref"]
    out, body, _ = outs["ref"]
    assert out.startswith("pool 0: stddev ") and body.startswith(
        b"ceph osd pg-upmap-items 0.")


def test_osdmaptool_upmap_pool_and_max(tmp_path, capsys):
    path = tmp_path / "m.json"
    m = hier_map(PO, build_hierarchy, 2, 4, 4, 256, 2)
    m.create_pool("second", pg_num=64, size=2, crush_rule=0)
    P.save_osdmap(m, str(path))
    J.save_osdmap(J.load_osdmap(str(path)), str(tmp_path / "j.json"))
    res = {}
    for name, tool, mp, extra in (
            ("ref", J, tmp_path / "j.json", []),
            ("port", P, path, ["--device", "cpu"])):
        up = tmp_path / f"{name}.upmap"
        rc, out, _ = _run(tool, [mp, "--upmap", up, "--upmap-pool", 1,
                                 "--upmap-max", 3, *extra], capsys)
        assert rc == 0
        res[name] = (out, up.read_bytes())
    assert res["port"] == res["ref"]
    out, body = res["port"]
    assert out.startswith("pool 1: ") and "pool 0" not in out
    assert 0 < body.count(b"\n") <= 3


def test_engine_rules(tmp_path, capsys, monkeypatch):
    path = tmp_path / "m.json"
    assert _run(P, [path, "--createsimple", 8, "--pg-bits", 1],
                capsys)[0] == 0
    up = tmp_path / "out.upmap"
    rc, _, err = _run(P, [path, "--upmap", up, "--scalar",
                          "--require-batched"], capsys)
    assert rc == 2 and "--require-batched with --scalar" in err
    # a rule the batched mapper declines stops the balancer: no fallback
    m = P.load_osdmap(str(path))
    m.crush.tunables.choose_local_tries = 2
    with pytest.raises(BatchedRequired, match="declines this rule"):
        UpmapBalancer(m, 0, device="cpu").stddev()
    P.save_osdmap(m, str(path))
    rc, out, err = _run(P, [path, "--upmap", up, "--device", "cpu"], capsys)
    assert rc == 2 and "declines this rule" in err and "stddev" not in out
    # injected placements run no mapper, on any device
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m.crush.tunables.choose_local_tries = 0
    place = np.zeros((m.pools[0].pg_num, 3), dtype=np.int64)
    assert UpmapBalancer(m, 0, placements=place).pg_counts()[0] == 3 * len(
        place)
    with pytest.raises(RuntimeError, match="CUDA"):
        UpmapBalancer(m, 0)
