"""The port's array PGMap, its health checks and K11 against ceph_tpu.

The same seeded ``ScaleHarness`` (64 OSDs, 16 Ki PGs, the fast size of
``tests/test_scale_harness.py``) is built in both packages: its PGMap
columns must be equal array by array, and every reduction, the health
checks and the summary fold must give the same values, the fold value
for value against ceph_tpu's numpy fold and its jitted fold.  K11 runs
its plain version here (CPU tensors); the kernel is held against it on
the card by ``tests/test_torch_cuda.py``.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ceph_tpu.mon import health as RH
from ceph_tpu.vstart import ScaleHarness as RefHarness
from ceph_tpu_torch.mon import health as PH
from ceph_tpu_torch.mon import pgmap as P
from ceph_tpu_torch.vstart import ScaleHarness

NOW = 1.75e9            # whole seconds: now - (now - 6.0) is exactly 6.0
FAST = dict(n_osds=64, pg_num=16384, seed=11, down_osds=2,
            stale_frac=0.001, damaged_frac=5e-4, scrub_late_frac=5e-3,
            now=NOW)


def twins(**kw):
    args = {**FAST, **kw}
    return ScaleHarness(**args), RefHarness(**args)


@pytest.fixture(scope="module")
def fast():
    return twins()


def test_columns_equal_array_by_array(fast):
    port, ref = fast
    a, b = port.pgmap, ref.pgmap
    assert a._n == b._n == FAST["pg_num"]
    assert a._state_names == b._state_names
    assert sorted(a._cols) == sorted(b._cols)
    for name in a._cols:
        assert a._cols[name].dtype == b._cols[name].dtype, name
        assert np.array_equal(a._cols[name], b._cols[name],
                              equal_nan=a._cols[name].dtype.kind == "f"), \
            name
    for name in ("_present", "_pool", "_seed"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert np.array_equal(port.placements, ref.placements)
    assert a.osd_stats == b.osd_stats


def test_reductions_equal_port_legacy_and_reference(fast):
    port, ref = fast
    legacy = port.legacy_pgmap()
    pool = {port.pool.id}
    for m in (port.pgmap, legacy):
        assert m.states(total_expected=port.pg_num, now=NOW) == \
            ref.pgmap.states(total_expected=ref.pg_num, now=NOW)
        assert m.num_objects() == ref.pgmap.num_objects()
        assert m.pool_usage(pool) == ref.pgmap.pool_usage(pool)
        assert m.damaged() == ref.pgmap.damaged()
        assert m.scrub_late(NOW, RH.SCRUB_WARN_INTERVAL) == \
            ref.pgmap.scrub_late(NOW, RH.SCRUB_WARN_INTERVAL)
        assert m.pool_clean_count(port.pool.id, port.pg_num) == \
            ref.pgmap.pool_clean_count(ref.pool.id, ref.pg_num)
    assert port.pgmap.dump() == legacy.pg_stats == ref.pgmap.dump()
    assert json.dumps(port.summary(), sort_keys=True) == \
        json.dumps(ref.summary(), sort_keys=True)


def test_health_checks_equal_codes_counts_details(fast):
    port, ref = fast
    got, want = port.evaluate(), ref.evaluate()
    assert got == want
    assert {c["code"] for c in got} >= {
        "OSD_DOWN", "PG_DEGRADED", "PG_AVAILABILITY", "PG_DAMAGED",
        "PG_NOT_SCRUBBED"}
    ctx = PH.HealthContext(osdmap=port.osdmap, pgmap=port.legacy_pgmap(),
                           monmap_ranks=[0], quorum=[0], now=NOW)
    assert PH.evaluate_checks(ctx) == want
    assert PH.rollup(got) == RH.rollup(want)
    assert PH.diff_reports({"checks": got[:2]}, {"checks": got}) == \
        RH.diff_reports({"checks": want[:2]}, {"checks": want})


def _fold_cases():
    """(label, edit) pairs; ``edit(pgmap, rng)`` changes one harness's
    map the same way in both packages."""
    def nan_stamps(m, rng):
        rows = rng.choice(m._n, 97, replace=False)
        m._cols["stamp"][rows] = np.nan

    def exact_grace(m, rng):
        rows = rng.choice(m._n, 211, replace=False)
        m._cols["stamp"][rows] = NOW - P.PG_STALE_GRACE
        m._cols["stamp"][rows[:50]] = np.nextafter(
            NOW - P.PG_STALE_GRACE, 0.0)        # one ulp past the grace

    def grown_states(m, rng):
        for i, r in enumerate(rng.choice(m._n, 40, replace=False)):
            m.pg_stats[m._pgid_str(int(r))]["state"] = \
                f"active+clean+grown{i % 9}"

    def future_stamps(m, rng):
        rows = rng.choice(m._n, 64, replace=False)
        m._cols["stamp"][rows] = NOW + 100.0     # negative ages

    return [("as built", lambda m, rng: None), ("nan stamps", nan_stamps),
            ("ages of exactly the grace", exact_grace),
            ("grown state table", grown_states),
            ("negative ages", future_stamps)]


@pytest.mark.parametrize("stale_frac", [0.0, 0.01])
@pytest.mark.parametrize("label,edit", _fold_cases(),
                         ids=[c[0] for c in _fold_cases()])
def test_summary_fold_value_for_value(stale_frac, label, edit):
    port, ref = twins(stale_frac=stale_frac, pg_num=4096)
    for h in (port, ref):
        edit(h.pgmap, np.random.default_rng(5))
    got = port.pgmap.summary_arrays(NOW, use_device=True, device="cpu")
    for want in (port.pgmap.summary_arrays(NOW),
                 ref.pgmap.summary_arrays(NOW),
                 ref.pgmap.summary_arrays(NOW, use_jax=True)):
        assert sorted(got) == sorted(want)
        assert got["state_stale_hist"].dtype == np.int64
        assert np.array_equal(got["state_stale_hist"],
                              np.asarray(want["state_stale_hist"]))
        for key in ("num_objects", "missing", "backfill_remaining",
                    "scrub_errors"):
            assert got[key] == int(want[key]), key
            assert type(got[key]) is int
    assert got["state_stale_hist"].shape == \
        (2 * len(port.pgmap._state_names),)
    if label == "ages of exactly the grace":
        # 161 rows at exactly the grace are fresh, 50 just past it stale
        assert got["state_stale_hist"][1::2].sum() >= 50


def test_summary_fold_plain_counts_keys_outside_the_histogram():
    sid = torch.tensor([0, 1, 2, 3, -1], dtype=torch.int64)
    stamp = torch.tensor([NOW, NOW - 7, float("nan"), NOW, NOW],
                         dtype=torch.float64)
    ones = torch.ones(5, dtype=torch.int64)
    hist, sums = P.summary_fold(sid, stamp, NOW, ones, 2 * ones, 3 * ones,
                                -ones, 6)
    assert hist.tolist() == [1, 0, 0, 1, 1, 0]
    assert sums.tolist() == [5, 10, 15, -5, 2]


def test_summary_arrays_refuses_state_ids_outside_the_table():
    port, _ = twins(pg_num=256, n_osds=16)
    port.pgmap._cols["state"][3] = 99
    with pytest.raises(ValueError, match="state id"):
        port.pgmap.summary_arrays(NOW, use_device=True, device="cpu")


def test_summary_fold_checks_its_inputs():
    n = 8
    i64 = torch.zeros(n, dtype=torch.int64)
    f64 = torch.zeros(n, dtype=torch.float64)
    with pytest.raises(ValueError, match="stamp"):
        P.summary_fold(i64, i64, NOW, i64, i64, i64, i64, 4)
    with pytest.raises(ValueError, match="column 2"):
        P.summary_fold(i64, f64, NOW, i64, i64, i64[:4], i64, 4)
    with pytest.raises(ValueError, match="hist_len"):
        P.summary_fold(i64, f64, NOW, i64, i64, i64, i64, 0)


def test_empty_map_folds_to_zeros():
    m = P.PGMap()
    for use_device in (False, True):
        out = m.summary_arrays(NOW, use_device=use_device, device="cpu")
        assert out["num_objects"] == 0
        assert out["state_stale_hist"].tolist() == [0, 0]


def test_shared_cap_matches_the_kernel_source():
    """Both branches of K11 (the per-block shared histogram up to the
    cap, global atomics above it) are selected by ``hist_len``; the
    card tests pick their shapes from ``FOLD_SHARED_CAP``."""
    src = (Path(P.__file__).resolve().parents[1] / "csrc"
           / "pgmap_fold.cu").read_text()
    cap = re.search(r"kSharedCap = (\d+);", src)
    assert cap and int(cap.group(1)) == P.FOLD_SHARED_CAP
    grace = re.search(r"kStaleGrace = ([\d.]+);", src)
    assert grace and float(grace.group(1)) == P.PG_STALE_GRACE


def test_crush_placement_equals_the_reference():
    kw = dict(n_osds=16, pg_num=128, seed=5, placement="crush", now=NOW)
    port = ScaleHarness(**kw, device="cpu")
    ref = RefHarness(**kw)
    assert port.placements.shape == (128, 3)
    assert np.array_equal(port.placements, ref.placements)
    assert port.evaluate() == ref.evaluate()


def test_view_writes_keep_packages_identical():
    port, ref = twins(n_osds=16, pg_num=256, seed=3)
    legacy = port.legacy_pgmap()
    pgid = f"{port.pool.id}.{7:x}"
    for m in (port.pgmap, legacy, ref.pgmap):
        m.pg_stats[pgid]["scrub_errors"] = 9
        m.pg_stats[pgid]["state"] = "active+clean+inconsistent"
        del m.pg_stats[pgid]["last_scrub_stamp"]
    assert port.pgmap.dump() == legacy.pg_stats == ref.pgmap.dump()
    assert port.pgmap.damaged() == ref.pgmap.damaged()
    assert port.evaluate() == ref.evaluate()
    assert port.pgmap.summary_arrays(NOW, use_device=True, device="cpu")[
        "scrub_errors"] == ref.pgmap.summary_arrays(NOW)["scrub_errors"]


def test_reports_apply_identically():
    """``apply_report`` (the MPGStats path) and ``prune`` keep the two
    packages' maps equal, new states and fields included."""
    port, ref = twins(n_osds=16, pg_num=512, seed=8)
    rng = np.random.default_rng(2)
    for _ in range(3):
        stats = {f"{port.pool.id}.{int(s):x}": {
            "state": str(rng.choice(["active+clean", "peering",
                                     "active+recovering"])),
            "num_objects": int(rng.integers(0, 50)),
            "stamp": NOW - float(rng.integers(0, 20)),
            "inconsistent_objects": ["obj"] if s % 7 == 0 else []}
            for s in rng.choice(600, 40, replace=False)}
        osd = {"kb": 1 << 20, "kb_used": int(rng.integers(0, 1 << 20))}
        for h in (port, ref):
            h.pgmap.apply_report(3, json.loads(json.dumps(stats)), osd)
    for h in (port, ref):
        h.pgmap.prune({port.pool.id})

    def unstamped(m):       # apply_report stamps rows with the mon's clock
        return {k: {f: v for f, v in row.items() if f != "stamp"}
                for k, row in m.dump().items()}
    assert unstamped(port.pgmap) == unstamped(ref.pgmap)
    sums = [json.loads(json.dumps(h.summary())) for h in (port, ref)]
    for st in sums:
        for osd in st["osd_stats"].values():
            osd.pop("stamp")
    assert sums[0] == sums[1]
    assert port.pgmap.summary_arrays(NOW, use_device=True, device="cpu")[
        "num_objects"] == ref.pgmap.summary_arrays(NOW)["num_objects"]
