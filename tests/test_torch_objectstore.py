"""The port's object stores (``ceph_tpu_torch.os_store``) against
ceph_tpu's: one seeded sequence of transactions gives byte-identical WAL
files in both packages, each package mounts the other's WAL, and every
crash point, under the same injector seed, leaves the same surviving
state after a remount."""

import os
import threading

import numpy as np
import pytest

import ceph_tpu.os_store as J
import ceph_tpu_torch.os_store as P
from ceph_tpu.compress import dedup as j_dedup
from ceph_tpu_torch.compress import dedup as p_dedup

COLLS = ("1.0s0", "1.0s1", "2.3")


def _txns(T, seed, n=60):
    """A seeded stream of transactions over every opcode.  ``T`` is the
    package's Transaction class; the stream is the same for both."""
    rng = np.random.default_rng(seed)
    live: set = set()                   # (cid, oid) the stream created
    out = [T().create_collection(COLLS[0]).create_collection(COLLS[1])]
    for i in range(n):
        t = T()
        for _ in range(int(rng.integers(1, 4))):
            cid = COLLS[int(rng.integers(0, 2))]
            oid = f"obj{int(rng.integers(0, 6))}"
            op = int(rng.integers(0, 14))
            size = int(rng.integers(0, 3000))
            data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
            if op <= 2:
                t.write(cid, oid, int(rng.integers(0, 500)), data)
                live.add((cid, oid))
            elif op == 3:
                t.zero(cid, oid, int(rng.integers(0, 100)), size // 4)
                live.add((cid, oid))
            elif op == 4:
                t.truncate(cid, oid, size // 2)
                live.add((cid, oid))
            elif op == 5:
                t.touch(cid, oid).setattrs(
                    cid, oid, {"_": data[:40], f"user.{i}": b"v"})
                live.add((cid, oid))
            elif op == 6:
                t.rmattr(cid, oid, "_")
                live.add((cid, oid))
            elif op == 7:
                t.omap_setkeys(cid, oid, {f"k{i}": data[:16], "info": b"{}"})
                live.add((cid, oid))
            elif op == 8:
                t.omap_rmkeys(cid, oid, [f"k{i - 1}", "info"])
                live.add((cid, oid))
            elif op == 9 and (cid, oid) in live:
                dest = f"clone{i}"
                t.clone(cid, oid, dest)
                live.add((cid, dest))
            elif op == 10:
                t.remove(cid, oid)
                live.discard((cid, oid))
            elif op == 11 and (cid, oid) in live:
                t.coll_move(cid, oid, COLLS[2])
                live.discard((cid, oid))
                live.add((COLLS[2], oid))
            elif op == 12:
                fp = f"fp{int(rng.integers(0, 3))}"
                t.dedup_ingest(j_dedup.DEDUP_COLL, fp, data[:64])
            else:
                t.dedup_release(j_dedup.DEDUP_COLL,
                                f"fp{int(rng.integers(0, 3))}")
        out.append(t)
    return out


def _state(store):
    out = {}
    for cid in store.list_collections():
        out[cid] = {oid: (bytes(store.read(cid, oid)),
                          store.getattrs(cid, oid), store.omap_get(cid, oid))
                    for oid in store.list_objects(cid)}
    return out


def _drive(pkg, path, seed, sync_mode="always", compact_every=0,
           compact_min_records=0):
    st = pkg.WALStore(path, sync_mode=sync_mode,
                      compact_min_records=compact_min_records)
    st.mount()
    fired = []
    for i, t in enumerate(_txns(pkg.Transaction, seed)):
        st.queue_transaction(t, on_commit=lambda i=i: fired.append(i))
        if compact_every and i % compact_every == compact_every - 1:
            st.compact()
    assert st.flush_commits(timeout=20)
    state, stats = _state(st), dict(st.wal_stats)
    st.umount()
    with open(path, "rb") as f:
        return f.read(), state, stats, fired


@pytest.mark.parametrize("mode,compact_every,compact_min", [
    ("always", 0, 0), ("none", 17, 0), ("batch", 0, 25)])
def test_same_transactions_same_wal_bytes(tmp_path, mode, compact_every,
                                          compact_min):
    p = _drive(P, str(tmp_path / "p.wal"), 1, mode, compact_every,
               compact_min)
    j = _drive(J, str(tmp_path / "j.wal"), 1, mode, compact_every,
               compact_min)
    assert p[0] == j[0]
    assert p[1] == j[1]
    assert sorted(p[3]) == sorted(j[3]) == list(range(61))
    for key in ("records", "bytes", "compactions", "syncs"):
        assert p[2].get(key) == j[2].get(key), key
    if compact_every or compact_min:
        assert p[2]["compactions"] >= 2


@pytest.mark.parametrize("writer,reader", [(J, P), (P, J)])
def test_each_package_mounts_the_others_wal(tmp_path, writer, reader):
    path = str(tmp_path / "x.wal")
    _, state, _, _ = _drive(writer, path, 2, "none", 23)
    st = reader.WALStore(path)
    st.mount()
    assert st.replay_stats["clean_shutdown"] is True
    assert st.replay_stats["tail"]["status"] == "clean"
    assert _state(st) == state
    # and appends after the other's records stay readable by both
    st.queue_transaction(reader.Transaction().write(COLLS[0], "late", 0,
                                                    b"late"))
    assert st.flush_commits(timeout=20)
    st.umount()
    for pkg in (P, J):
        again = pkg.WALStore(path)
        again.mount()
        assert bytes(again.read(COLLS[0], "late")) == b"late"
        again.umount()


def test_memstore_and_dedup_refcounts_equal():
    states = []
    for pkg, dedup in ((P, p_dedup), (J, j_dedup)):
        st = pkg.MemStore("m")
        for t in _txns(pkg.Transaction, 3):
            st.queue_transaction(t)
        assert st.finisher.wait_for_empty(10)
        states.append((_state(st), dedup.verify_refcounts(st),
                       st.mempool.dump()["bytes"] >= 0))
        st.umount()
    assert states[0] == states[1]


def _crash_run(pkg, path, point, seed):
    """Seeded crash schedule: drive until the point fires, then remount
    what stable storage kept."""
    inj = pkg.CrashInjector(seed=seed, osd="osd.0")
    inj.set_prob(point, 0.1)
    errors = []
    st = pkg.WALStore(path, sync_mode="always", crash=inj,
                      compact_min_records=(4 if point == "mid_compaction"
                                           else 0))
    st.on_error = errors.append
    st.mount()
    acked = []
    for i, t in enumerate(_txns(pkg.Transaction, seed, n=200)):
        try:
            st.queue_transaction(t, on_commit=lambda i=i: acked.append(i))
        except pkg.SimulatedPowerLoss:
            break
    else:
        raise AssertionError(f"{point} never fired")
    with pytest.raises(pkg.StoreError):
        st.queue_transaction(pkg.Transaction().touch(COLLS[0], "after"))
    st.finisher.wait_for_empty(10)
    with open(path, "rb") as f:
        raw = f.read()
    again = pkg.WALStore(path)
    again.mount()
    out = (raw, _state(again), again.replay_stats, list(inj.fired),
           sorted(acked), len(errors), type(errors[0]).__name__)
    again.umount()
    return out


@pytest.mark.parametrize("point", P.CRASH_POINTS)
def test_crash_points_leave_the_same_state(tmp_path, monkeypatch, point):
    monkeypatch.delenv("CEPH_TPU_PROC_DAEMON", raising=False)
    assert P.CRASH_POINTS == J.CRASH_POINTS
    p = _crash_run(P, str(tmp_path / "p.wal"), point, 7)
    j = _crash_run(J, str(tmp_path / "j.wal"), point, 7)
    assert p == j
    raw, state, replay, fired, acked, n_err, err = p
    assert fired[0][0] == point and n_err == 1
    assert err == "SimulatedPowerLoss"
    assert replay["clean_shutdown"] is False
    if point == "mid_record":
        assert replay["tail"]["status"] == "torn"
    # every acknowledged write is there: replaying exactly the acked
    # prefix into a MemStore gives the remounted state (post_fsync_pre_
    # apply also keeps the one durable-but-unacked record)
    shadow = P.MemStore("shadow")
    txns = _txns(P.Transaction, 7, n=200)
    extra = 1 if point == "post_fsync_pre_apply" else 0
    for t in txns[:len(acked) + extra]:
        shadow.queue_transaction(t)
    assert _state(shadow) == state
    shadow.umount()


def test_injector_schedules_equal():
    for point in P.CRASH_POINTS:
        a = P.CrashInjector(seed=42, osd="osd.3")
        b = J.CrashInjector(seed=42, osd="osd.3")
        for inj in (a, b):
            inj.set_prob(point, 0.2)
            inj.arm(point, 5)
        assert a.preview(point, 64) == b.preview(point, 64)
        assert [a.decide(point) for _ in range(10)] == \
            [b.decide(point) for _ in range(10)]
        assert a.describe() == b.describe()
    with pytest.raises(ValueError):
        P.CrashInjector().arm("nowhere")


@pytest.mark.parametrize("how", ["power_loss", "process_death"])
def test_teardowns_equal(tmp_path, how):
    out = []
    for pkg in (P, J):
        path = str(tmp_path / f"{pkg.__name__}.wal")
        st = pkg.WALStore(path, sync_mode="none")
        st.mount()
        for t in _txns(pkg.Transaction, 4, n=12):
            st.queue_transaction(t)
        getattr(st, how)()
        again = pkg.WALStore(path)
        again.mount()
        out.append((_state(again), again.replay_stats))
        again.umount()
    assert out[0] == out[1]
    # none never fsyncs: a power loss keeps nothing, a killed process
    # keeps every appended record
    assert bool(out[0][0]) == (how == "process_death")


def test_group_commit_kick_and_flight_recorder(tmp_path):
    from ceph_tpu_torch.core.flight_recorder import FlightRecorder
    path = str(tmp_path / "g.wal")
    st = P.WALStore(path, sync_mode="batch")
    fr = FlightRecorder(path + ".bbox", daemon="osd.0")
    fr.open()
    st.flight_recorder = fr
    st.mount()
    done = threading.Event()
    acks = []
    txns = _txns(P.Transaction, 5, n=30)
    for i, t in enumerate(txns):
        st.queue_transaction(t, on_commit=lambda i=i: (
            acks.append(i), len(acks) == len(txns) and done.set()))
    st.kick()
    assert done.wait(20) and acks == list(range(len(txns)))
    assert st.flush_commits(timeout=20)
    stats = st.wal_stats
    assert stats["group_commits"] == len(txns)
    assert 1 <= stats["group_syncs"] <= len(txns)
    fr.snap()
    st.set_sync_mode("always")
    st.queue_transaction(P.Transaction().touch(COLLS[0], "x"))
    assert st.wal_stats["syncs"] == 1
    st.umount()
    fr.close()
    from ceph_tpu_torch.core.flight_recorder import timeline
    marks = [e for e in timeline(path + ".bbox") if e["type"] == "mark"]
    assert [m["seq"] for m in marks] == list(range(1, len(txns) + 1))
    assert not os.path.exists(path + ".dirty")
