"""The port's rbd-mirror against ceph_tpu's, on the CPU.

Two sites a package, each a ``MiniCluster`` of ``test_torch_rbd.py``'s
shape (one mon, three OSDs, the EC pool ``ecrbd`` k=2 m=1 on rule 1
with min_size 2 and the replicated pool ``rbd``); the port's on
``device="cpu"``.  One package's two sites run the whole script and
stop before the other package's start, so no more than two clusters
run at once.  ``MirrorDaemon(remote=site A, local=site B)`` replicates
by ``sync_once`` passes, and in one scenario by its own thread
(``start``/``stop``) once every journal entry is written, so that each
pass sees the same state in both packages.

The scenarios, in order on the EC pool: journal-mode replication and
failover (bootstrap, replay of writes and snapshots, the non-primary
refusal, the journal trim, ``promote``), split-brain, snapshot-mode
round trip and failover, snapshot-mode split-brain, diverged snapshot
ids, broken-chain resync, mode exclusivity, the fast-diff-driven
incremental, resize and discard replication (also on the replicated
pool), unjournaled images left alone, the reserved mirror-snapshot
namespace, and the threaded daemon with ``demote``/``promote``.  The
tests compare every return value, each exception's type and message and
each daemon's ``errors`` and ``positions``, then every OSD's store of
both sites; the script asserts its own answers in both packages.

Tolerance: exact.
"""

import pytest

from ceph_tpu.rbd import mirror as R_MIRROR
from ceph_tpu_torch.rbd import mirror as P_MIRROR
from test_torch_cluster import wait_for
from test_torch_rbd import PKGS, seeded, start_side, store_views

MIRROR = {"ceph_tpu": R_MIRROR, "port": P_MIRROR}


class Sites:
    """One package's two sites; replies land in ``a.out``."""

    def __init__(self, pkg, a, b):
        self.pkg, self.a, self.b = pkg, a, b
        b.out = a.out
        self.m = MIRROR[pkg]
        self.call, self.note, self.out = a.call, a.note, a.out
        self.Image, self.RBD = a.Image, a.RBD

    def ios(self, p):
        return self.a.ios[p], self.b.ios[p]

    def daemon(self, p, **kw):
        pio, sio = self.ios(p)
        return self.m.MirrorDaemon(pio, sio, interval=0.05, **kw)

    def read(self, io, name, off, n, **kw):
        with self.Image(io, name, read_only=True, **kw) as img:
            return self.call(img.read, off, n)

    def state(self, d):
        return self.note((list(d.errors), dict(d.positions)))


def sc_journal_replication_and_failover(t, p):
    pio, sio = t.ios(p)
    rbd = t.RBD()
    t.call(rbd.create, pio, "img", 64 << 10, order=12, journaling=True)
    with t.Image(pio, "img") as img:
        t.call(img.write, 0, b"alpha" * 100)
        t.call(img.write, 20000, b"beta")
    d = t.daemon(p)
    assert t.call(d.sync_once) == 0               # bootstrap copies
    assert "img" in t.call(rbd.list, sio)
    assert t.read(sio, "img", 0, 500) == b"alpha" * 100
    assert t.read(sio, "img", 20000, 4) == b"beta"
    with t.Image(sio, "img") as s:
        assert not t.call(s.is_primary)
        t.call(s.write, 0, b"x")                  # non-primary
    with t.Image(pio, "img") as img:
        t.call(img.write, 1000, b"gamma")
        t.call(img.create_snap, "s1")
        t.call(img.write, 1000, b"delta")
        t.call(t.Image, pio, "img")               # the journal's lock
    assert t.call(d.sync_once) == 3
    assert t.read(sio, "img", 1000, 5) == b"delta"
    assert t.read(sio, "img", 1000, 5, snapshot="s1") == b"gamma"
    trim = t.Image._TRIM_EVERY
    with t.Image(pio, "img") as img:
        for i in range(2 * trim):
            t.call(img.write, 2000, f"tick{i:04d}".encode())
    assert t.call(d.sync_once) == 2 * trim
    assert t.read(sio, "img", 2000, 8) == f"tick{2 * trim - 1:04d}".encode()
    with t.Image(pio, "img") as img:
        for _ in range(trim):
            t.call(img.write, 3000, b"tock")
    rows = pio.omap_get(t.a.image_mod._journal_oid("img"))
    live = [k for k in rows if k.startswith("e")]
    assert t.note(len(live)) <= 2 * trim
    t.state(d)
    t.call(t.m.promote, sio, "img")
    with t.Image(sio, "img") as s:
        t.call(s.write, 0, b"post-failover")
        assert t.call(s.read, 0, 13) == b"post-failover"


def sc_split_brain(t, p):
    pio, sio = t.ios(p)
    t.call(t.RBD().create, pio, "sb", 16 << 10, order=12, journaling=True)
    with t.Image(pio, "sb") as img:
        t.call(img.write, 0, b"one")
    d = t.daemon(p)
    t.call(d.sync_once)
    assert t.read(sio, "sb", 0, 3) == b"one"
    t.call(t.m.promote, sio, "sb")                # both primary
    with t.Image(pio, "sb") as img:
        t.call(img.write, 0, b"two")
    t.call(d.sync_once)
    assert any("split-brain" in e for e in t.state(d)[0])
    assert t.read(sio, "sb", 0, 3) == b"one"


def sc_snapshot_round_trip_and_failover(t, p):
    pio, sio = t.ios(p)
    rbd = t.RBD()
    t.call(rbd.create, pio, "snapm", 64 << 10, order=12,
           mirror_snapshot=True)
    with t.Image(pio, "snapm") as img:
        assert t.call(img.mirror_mode) == "snapshot"
        t.call(img.write, 0, b"first" * 40)
        t.call(img.write, 9000, b"tail")
        s1 = t.call(img.mirror_snapshot_create)
    d = t.daemon(p)
    assert t.call(d.sync_once) == 1               # the full delta
    assert t.read(sio, "snapm", 0, 200) == b"first" * 40
    assert t.read(sio, "snapm", 9000, 4) == b"tail"
    with t.Image(sio, "snapm") as s:
        assert not t.call(s.is_primary)
        t.call(s.write, 0, b"x")
    with t.Image(pio, "snapm", read_only=True) as img:
        assert t.call(img.mirror_snap_committed) == \
            img._hdr["snaps"][s1]["id"]
    with t.Image(pio, "snapm") as img:
        t.call(img.write, 20, b"UPDATED")
        t.call(img.write, 50000, b"new-extent")
        s2 = t.call(img.mirror_snapshot_create)
    assert t.call(d.sync_once) == 1
    assert t.read(sio, "snapm", 20, 7) == b"UPDATED"
    assert t.read(sio, "snapm", 50000, 10) == b"new-extent"
    with t.Image(sio, "snapm", read_only=True) as s:
        assert [n for _, n in t.call(s.mirror_snapshots)] == [s2]
    assert t.call(d.sync_once) == 0               # an idle pass
    with t.Image(pio, "snapm") as img:
        t.call(img.write, 0, b"third")
        s3 = t.call(img.mirror_snapshot_create)
        names = [n for _, n in t.call(img.mirror_snapshots)]
        assert s1 not in names and s2 in names and s3 in names
    assert t.call(d.sync_once) == 1
    assert t.read(sio, "snapm", 0, 5) == b"third"
    t.state(d)
    t.call(t.m.promote, sio, "snapm")
    with t.Image(sio, "snapm") as s:
        t.call(s.write, 0, b"post-failover")
        assert t.call(s.read, 0, 13) == b"post-failover"
        t.call(s.mirror_snapshot_create)


def sc_snapshot_split_brain(t, p):
    pio, sio = t.ios(p)
    t.call(t.RBD().create, pio, "snapsb", 16 << 10, order=12,
           mirror_snapshot=True)
    with t.Image(pio, "snapsb") as img:
        t.call(img.write, 0, b"one")
        t.call(img.mirror_snapshot_create)
    d = t.daemon(p)
    assert t.call(d.sync_once) == 1
    t.call(t.m.promote, sio, "snapsb")
    with t.Image(pio, "snapsb") as img:
        t.call(img.write, 0, b"two")
        t.call(img.mirror_snapshot_create)
    t.call(d.sync_once)
    assert any("split-brain" in e for e in t.state(d)[0])
    assert t.read(sio, "snapsb", 0, 3) == b"one"


def sc_diverged_snap_ids(t, p):
    pio, sio = t.ios(p)
    t.call(t.RBD().create, pio, "divg", 16 << 10, order=12,
           mirror_snapshot=True)
    with t.Image(pio, "divg") as img:
        t.call(img.write, 0, b"seed")
        t.call(img.create_snap, "user1")          # remote snap id 1
        m1 = t.call(img.mirror_snapshot_create)   # remote snap id 2
    assert m1 == ".mirror.primary.1"
    with t.Image(pio, "divg", read_only=True) as img:
        assert t.note(img._hdr["snaps"][m1]["id"]) == 2
    d = t.daemon(p)
    assert t.call(d.sync_once) == 1
    with t.Image(sio, "divg", read_only=True) as s:
        assert t.note(s._hdr["snaps"][m1]["id"]) == 1
    t.call(t.m.promote, sio, "divg")
    with t.Image(sio, "divg") as s:
        t.call(s.write, 0, b"over")
        assert t.call(s.mirror_snapshot_create) == ".mirror.primary.2"


def sc_broken_chain_resync(t, p):
    pio, sio = t.ios(p)
    t.call(t.RBD().create, pio, "chainb", 16 << 10, order=12,
           mirror_snapshot=True)
    with t.Image(pio, "chainb") as img:
        t.call(img.write, 0, b"v1-data")
        b1 = t.call(img.mirror_snapshot_create)
    d = t.daemon(p)
    assert t.call(d.sync_once) == 1
    with t.Image(pio, "chainb") as img:
        t.call(img.remove_snap, b1)
        t.call(img.write, 0, b"v2-data")
        t.call(img.mirror_snapshot_create)
    t.call(d.sync_once)                           # drops the local copy
    assert any("resync" in e for e in t.state(d)[0])
    assert t.call(d.sync_once) >= 1               # a full re-bootstrap
    assert t.read(sio, "chainb", 0, 7) == b"v2-data"


def sc_modes_exclusive(t, p):
    pio, _sio = t.ios(p)
    t.call(t.RBD().create, pio, "bothm", 16 << 10, journaling=True,
           mirror_snapshot=True)
    assert t.out[-1][:2] == ("raised", "ValueError")


def sc_fast_diff_incremental(t, p):
    pio, _sio = t.ios(p)
    t.call(t.RBD().create, pio, "fd", 64 << 10, order=12,
           mirror_snapshot=True)
    with t.Image(pio, "fd") as img:
        t.call(img.write, 0, b"a" * 4096)          # object 0
        t.call(img.write, 3 << 12, b"b" * 100)     # object 3
        s1 = t.call(img.mirror_snapshot_create)
        t.call(img.write, 3 << 12, b"c" * 50)      # object 3 only
        t.call(img.mirror_snapshot_create)
    with t.Image(pio, "fd", read_only=True) as img:
        last = t.call(img.mirror_snapshots)[-1][1]
    with t.Image(pio, "fd", snapshot=last, read_only=True) as src:
        diff = t.call(src.export_diff, from_snap=s1)
    offs = {e["off"] for e in diff["extents"]}
    assert offs and all((3 << 12) <= o < (4 << 12) for o in offs)


def sc_resize_and_discard_replicate(t, p):
    pio, sio = t.ios(p)
    rbd = t.RBD()
    t.call(rbd.create, pio, "rz", 32 << 10, order=12, journaling=True)
    d = t.daemon(p)
    t.call(d.sync_once)                           # bootstrap, empty
    assert "rz" in t.call(rbd.list, sio)
    with t.Image(pio, "rz") as img:
        t.call(img.write, 0, b"z" * 1000)
        t.call(img.resize, 64 << 10)
        t.call(img.write, (32 << 10) + 5, b"grown")
        t.call(img.discard, 0, 500)
    assert t.call(d.sync_once) == 4
    with t.Image(sio, "rz", read_only=True) as s:
        assert t.call(s.size) == 64 << 10
        assert t.call(s.read, (32 << 10) + 5, 5) == b"grown"
        assert t.call(s.read, 0, 500) == b"\x00" * 500
        assert t.call(s.read, 500, 500) == b"z" * 500
    with t.Image(pio, "rz") as img:
        t.call(img.resize, 4 << 10)
        t.call(img.resize, 32 << 10)
    assert t.call(d.sync_once) == 2
    with t.Image(sio, "rz", read_only=True) as s:
        assert t.call(s.size) == 32 << 10
        assert t.call(s.read, 4 << 10, 1000) == b"\x00" * 1000


def sc_unjournaled_not_mirrored(t, p):
    pio, sio = t.ios(p)
    rbd = t.RBD()
    t.call(rbd.create, pio, "plain", 16 << 10, order=12)
    with t.Image(pio, "plain") as img:
        t.call(img.write, 0, b"data")
    t.call(t.daemon(p).sync_once)
    assert "plain" not in t.call(rbd.list, sio)


def sc_namespace_reserved(t, p):
    _pio, sio = t.ios(p)
    t.call(t.RBD().create, sio, "resv", 1 << 16, order=12,
           mirror_snapshot=True)
    with t.Image(sio, "resv") as img:
        t.call(img.create_snap, ".mirror.primary.backup")
        t.call(img.create_snap, ".mirror.primary.7")
        assert [o[:2] for o in t.out[-2:]] == [("raised", "ValueError")] * 2
        img._hdr["snaps"][".mirror.primary.stray"] = {
            "id": 999, "size": 1 << 16}
        assert t.call(img.mirror_snapshots) == []
        assert t.call(img.mirror_snapshot_create) == ".mirror.primary.1"


def sc_threaded_daemon_demote_promote(t, p):
    """Every journal entry first, then the daemon's own thread, so each
    of its passes finds the same state in both packages."""
    pio, sio = t.ios(p)
    rbd = t.RBD()
    t.call(rbd.create, pio, "thr", 32 << 10, order=12, journaling=True)
    with t.Image(pio, "thr") as img:
        for i in range(6):
            t.call(img.write, 1500 * i, bytes([65 + i]) * 1000)
        t.call(img.discard, 0, 200)
        t.call(img.create_snap, "ts")
    with t.Image(pio, "thr", read_only=True) as img:
        head = t.call(img.journal_entries)[-1][0]
    d = t.daemon(p).start()
    try:
        assert wait_for(lambda: d.positions.get("thr") == head)
    finally:
        d.stop()
    assert not [e for e in d.errors if "'thr'" in e]
    want = t.read(pio, "thr", 0, 32 << 10)
    assert t.read(sio, "thr", 0, 32 << 10) == want
    t.call(t.m.demote, pio, "thr")
    t.call(t.m.promote, sio, "thr")
    with t.Image(pio, "thr") as img:
        t.call(img.write, 0, b"refused")          # non-primary now
    assert t.out[-1][:2] == ("raised", "ValueError")
    with t.Image(sio, "thr") as s:
        t.call(s.write, 0, b"accepted")
        assert t.call(s.read, 0, 8) == b"accepted"


SCENARIOS = [
    (sc_journal_replication_and_failover, "ec"), (sc_split_brain, "ec"),
    (sc_snapshot_round_trip_and_failover, "ec"),
    (sc_snapshot_split_brain, "ec"), (sc_diverged_snap_ids, "ec"),
    (sc_broken_chain_resync, "ec"), (sc_modes_exclusive, "ec"),
    (sc_fast_diff_incremental, "ec"),
    (sc_resize_and_discard_replicate, "ec"),
    (sc_resize_and_discard_replicate, "rep"),
    (sc_unjournaled_not_mirrored, "ec"), (sc_namespace_reserved, "ec"),
    (sc_threaded_daemon_demote_promote, "ec")]
NAMES = [f"{f.__name__[3:]}-{p}" for f, p in SCENARIOS]


@pytest.fixture(scope="module")
def runs():
    """{pkg: ({scenario: replies}, (site A's stores, site B's))}: one
    package's two sites at a time."""
    out = {}
    with seeded(18):
        for pkg in PKGS:
            clusters = []
            try:
                t = Sites(pkg, start_side(pkg, clusters),
                          start_side(pkg, clusters))
                replies = {}
                for (fn, p), name in zip(SCENARIOS, NAMES):
                    t.a.out.clear()
                    fn(t, p)
                    replies[name] = list(t.a.out)
                out[pkg] = (replies, (store_views(t.a), store_views(t.b)))
            finally:
                for c in clusters:
                    c.stop()
    return out


@pytest.mark.parametrize("name", NAMES)
def test_scenario_replies_match(runs, name):
    got = {pkg: replies[name] for pkg, (replies, _v) in runs.items()}
    assert got["port"] == got["ceph_tpu"]
    assert got["port"]


@pytest.mark.parametrize("site", [0, 1], ids=["site_a", "site_b"])
def test_site_stores_match(runs, site):
    views = {pkg: v[site] for pkg, (_r, v) in runs.items()}
    assert views["port"] == views["ceph_tpu"]
    names = {oid for v in views["port"].values() for _c, oid in v}
    assert any(o.startswith("rbd_journal.") for o in names)
    assert any(o.startswith("rbd_data.thr.") for o in names)
