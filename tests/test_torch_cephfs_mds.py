"""The port's MDS against ceph_tpu's, on the CPU: snapshots, failover
with journal replay and request dedup, two ranks and back to one, and
dirfrag splits.

One ``MiniCluster`` of each package, side by side, as in
``test_torch_cephfs.py`` (one mon, three OSDs on WALStores, upstream's
20 s heartbeat grace, the port on ``device="cpu"``, MDS ``a`` whose
journal flushes only where the scripts flush it, one client of a fixed
name), but with a replicated data pool ``cephfs_data`` (size 2, pg_num
4): CephFS snapshots ride pool snapshots, which neither package serves
on an EC pool.  The tests run in file order on one pair of clusters:

- snapshots: ``mkdir dir/.snap/NAME`` and ``mksnap``, reads, ``stat``
  and ``readdir`` at a snapshot after the head changed, ``lssnap``,
  ``rmsnap`` and ``rmdir dir/.snap/NAME``, and every refusal (EROFS,
  EEXIST, ENOENT, EISDIR);
- dirfrag splits: the split size set to 8 on the active MDS, a
  directory grown in three batches with a flush after each (1 → 2 → 4
  → 8 fragments), then listed, renamed across fragments and unlinked;
- failover: MDS ``b`` as standby, names created and written with no
  flush, one request resent under its tid (its first answer back, not
  EEXIST), ``a`` killed, ``b`` active after the beacon grace with every
  acked name and size replayed from the journal, the same resend
  answered from the replayed completions, a new tid refused EEXIST,
  and the resend of a create whose event a flush trimmed before the
  kill refused EEXIST (a fault of the reference, pinned);
- two ranks: MDS ``c`` as standby, ``max_mds 2`` (``c`` takes rank 1),
  a subtree on each rank with EXDEV across them and EINVAL for a
  snapshot of ``/``, the ``rmdir`` by rank 0 of a rank-1 directory
  whose entries are only in rank 1's journal, ``c`` killed with its subtree's metadata only in
  its journal, ``max_mds 1``, rank 0 adopting the orphan journal.

Compared: every return value, each exception's type, ``rc`` and
message, and at the end every OSD's store of both pools (object bytes,
size and hinfo, omap rows, xattrs).  Tolerance: exact.  Masks: the
``mtime`` and ``created`` fields of every record, in replies and in the
JSON rows of the metadata pool's omaps, and nothing else.
"""

import time
import zlib

import pytest

from test_torch_cephfs import (OBJ, data_oid, flush_mds, payload, pools_of,
                               run_both, started_pair, store_views)

SPLIT = 8                             # the dirfrag split size of the tests


def tops():
    """Three top-level names: one of rank 0 and two of rank 1 at
    max_mds 2."""
    t0, t1, t2 = "alpha", "beta", "gamma"
    assert [zlib.crc32(t.encode()) % 2 for t in (t0, t1, t2)] == [0, 1, 1]
    return t0, t1, t2


def wait(pred, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.05)


def mds_up(s):
    rc, _outs, stat = s.r.mon_command({"prefix": "mds stat"})
    assert rc == 0
    return stat["up"], stat["standby_count"]


def ranks_settled(s, n):
    """``n`` ranks active in the mon's map, in every live MDS and in the
    client, each active MDS at ``max_mds`` n."""
    up, _sb = mds_up(s)
    actives = [m for m in s.c.mdss.values() if m.state == "active"]
    return (len(up) == n and len(actives) == n
            and all(getattr(m, "_last_max_mds", 0) == n for m in actives)
            and s.fs._max_mds() == n)


def set_max_mds(s, n):
    rc, outs, _ = s.r.mon_command({"prefix": "fs set", "fs_name": "cephfs",
                                   "var": "max_mds", "val": str(n)})
    assert rc == 0, outs
    s.note((rc, outs))


def start_standby(s, name):
    s.c.start_mds(name, flush_interval=3600.0).dirfrag_split_size = SPLIT
    wait(lambda: mds_up(s)[1] == 1, f"{s.pkg}: mds.{name} standby")
    s.note(mds_up(s))


def sc_snapshots(s):
    fs = s.fs
    fs.mkdirs("/snapd/sub")
    v1 = payload(80, 3 * OBJ + 11)
    s.call(fs.write_file, "/snapd/f1", v1)
    s.call(fs.write_file, "/snapd/sub/f2", payload(81, 500))
    s.call(fs.mkdir, "/snapd/.snap/s1")              # mkdir is mksnap
    fd = s.call(fs.open, "/snapd/f1", "a")
    s.call(fs.write, fd, b"changed" * 100, OBJ - 300)
    s.call(fs.close, fd)
    s.call(fs.unlink, "/snapd/sub/f2")
    s.call(fs.write_file, "/snapd/f3", b"after s1")
    assert s.call(fs.read_file, "/snapd/.snap/s1/f1") == v1
    assert s.call(fs.read_file, "/snapd/.snap/s1/sub/f2") == \
        payload(81, 500)
    s.call(fs.read_file, "/snapd/.snap/s1/f3")       # not in s1
    assert [n for n, _r in s.call(fs.readdir, "/snapd/.snap")] == ["s1"]
    s.call(fs.readdir, "/snapd/.snap/s1")
    s.call(fs.readdir, "/snapd/.snap/s1/sub")
    s.call(fs.readdir, "/snapd/.snap/s1/f1")         # ENOTDIR
    s.call(fs.stat, "/snapd/.snap/s1/f1")
    s.call(fs.stat, "/snapd/.snap")
    s.call(fs.stat, "/nodir/.snap")
    s.call(fs.mksnap, "/snapd", "s2")
    s.call(fs.mksnap, "/snapd", "s2")                # EEXIST
    s.call(fs.mksnap, "/nodir", "s9")
    s.call(fs.mksnap, "/snapd/f1", "s9")             # ENOTDIR
    s.call(fs.lssnap, "/snapd")
    s.call(fs.open, "/snapd/.snap/s1/f1", "w")       # EROFS
    s.call(fs.unlink, "/snapd/.snap/s1/f1")
    s.call(fs.rename, "/snapd/.snap/s1/f1", "/snapd/g")
    s.call(fs.mkdir, "/snapd/.snap/s1/x")
    s.call(fs.rmdir, "/snapd/.snap/s1/sub")
    s.call(fs.open, "/snapd/.snap/s1", "r")          # EISDIR
    s.call(fs.open, "/snapd/.snap/s1/sub", "r")
    s.call(fs.open, "/snapd/.snap/none/f1", "r")     # ENOENT
    s.call(fs.rmdir, "/snapd/.snap/s1")              # rmdir is rmsnap
    s.call(fs.rmsnap, "/snapd", "s1")                # ENOENT
    s.call(fs.read_file, "/snapd/.snap/s1/f1")
    assert [n for n, _r in s.call(fs.readdir, "/snapd/.snap")] == ["s2"]
    v2 = s.call(fs.read_file, "/snapd/f1")
    assert s.call(fs.read_file, "/snapd/.snap/s2/f1") == v2 != v1
    s.call(fs.listdir, "/snapd/.snap/s2")


def sc_dirfrags(s):
    fs = s.fs
    fs.mkdir("/big")
    ino = s.call(fs.stat, "/big")["ino"]
    names = [f"e{i:03d}" for i in range(40)]
    for lo, hi in ((0, 12), (12, 24), (24, 40)):
        for n in names[lo:hi]:
            s.call(fs.write_file, f"/big/{n}", n.encode())
        flush_mds(s)
        s.note(s.mds._nfrags(ino))
    assert s.out[-1] == 8
    assert s.call(fs.listdir, "/big") == names
    s.call(fs.rename, "/big/e005", "/big/moved-e005")
    s.call(fs.rename, "/big/e017", "/big/e031")      # over another
    for n in names[30:]:
        s.call(fs.unlink, f"/big/{n}")
    flush_mds(s)
    s.call(fs.listdir, "/big")
    assert s.call(fs.read_file, "/big/e002") == b"e002"
    s.call(fs.rmdir, "/big")                         # ENOTEMPTY


def sc_failover(s):
    fs = s.fs
    start_standby(s, "b")
    fs.mkdir("/fo")
    for i in range(6):
        s.call(fs.write_file, f"/fo/f{i}", payload(90 + i, 700 * i + 1))
    dino = s.call(fs.stat, "/fo")["ino"]
    layout = {"stripe_unit": OBJ, "stripe_count": 1, "object_size": OBJ}
    # a create whose journal event a flush trims before the kill: its
    # resend after the failover gets EEXIST, not its first answer, in
    # both packages (the completed requests live in the journal only,
    # ROADMAP.md §3)
    args0 = {"dir": dino, "name": "dup0", "excl": True, "layout": layout}
    s.call(fs._request, "create", args0)
    tid0 = fs._tid
    flush_mds(s)
    args = {"dir": dino, "name": "dup", "excl": True, "layout": layout}
    first = s.call(fs._request, "create", args)
    tid = fs._tid
    fs._tid = tid - 1                                # the resend
    assert s.call(fs._request, "create", args) == first
    victim = s.note(next(n for n, m in s.c.mdss.items()
                         if m.state == "active"))
    s.c.kill_mds(victim)
    s.note(s.c.wait_for_active_mds(timeout=60))
    s.note(mds_up(s))
    top = fs._tid
    fs._tid = tid - 1                                # after the failover
    assert s.call(fs._request, "create", args) == first
    fs._tid = tid0 - 1                               # trimmed before
    assert s.call(fs._request, "create", args0)[:3] == (
        "raised", "CephFSError", -17)
    fs._tid = top
    s.call(fs._request, "create", args)              # a new tid: EEXIST
    assert s.call(fs.listdir, "/fo") == \
        ["dup", "dup0"] + [f"f{i}" for i in range(6)]
    for i in range(6):
        assert s.call(fs.stat, f"/fo/f{i}")["size"] == 700 * i + 1
        assert s.call(fs.read_file, f"/fo/f{i}") == \
            payload(90 + i, 700 * i + 1)
    s.call(fs.write_file, "/fo/after", b"served by the new active")
    s.call(fs.readdir, "/fo")


def sc_two_ranks(s):
    fs = s.fs
    t0, t1, t2 = tops()
    start_standby(s, "c")
    set_max_mds(s, 2)
    wait(lambda: ranks_settled(s, 2), f"{s.pkg}: two ranks")
    s.note(mds_up(s))
    for t in (t0, t1):
        fs.mkdirs(f"/{t}/sub")
        s.call(fs.write_file, f"/{t}/sub/f", payload(len(t), 2 * OBJ + 5))
    st0, st1 = s.call(fs.stat, f"/{t0}/sub/f"), s.call(fs.stat,
                                                       f"/{t1}/sub/f")
    assert (st0["ino"] >> 40, st1["ino"] >> 40) == (0, 1)
    s.call(fs.rename, f"/{t0}/sub/f", f"/{t1}/sub/g")    # EXDEV
    s.call(fs.link, f"/{t0}/sub/f", f"/{t1}/sub/h")
    s.call(fs.rename, f"/{t1}/sub/f", f"/{t1}/f-moved")  # inside rank 1
    s.call(fs.link, f"/{t1}/f-moved", f"/{t1}/sub/f-link")
    s.call(fs.mksnap, "/", "root-snap")                  # spans ranks
    s.call(fs.rmdir, f"/{t0}")                           # ENOTEMPTY
    # rank 0 checks a rank-1 subtree's emptiness on the dirfrags alone:
    # a directory whose entries are only in rank 1's journal goes, and
    # their rows come back under its dead ino when the journal replays
    fs.mkdir(f"/{t2}")
    s.call(fs.write_file, f"/{t2}/journal-only", b"j")
    s.call(fs.rmdir, f"/{t2}")                           # rc 0
    s.call(fs.mkdir, f"/{t1}/empty")
    s.call(fs.readdir, f"/{t1}")
    s.note(len(fs._mds_cons))
    rank1 = s.note(next(n for n, m in s.c.mdss.items()
                        if m.state == "active" and m.rank == 1))
    s.c.kill_mds(rank1)                  # its subtree only in its journal
    set_max_mds(s, 1)
    wait(lambda: ranks_settled(s, 1), f"{s.pkg}: back to one rank")
    s.note(mds_up(s))
    assert s.call(fs.read_file, f"/{t1}/f-moved") == \
        payload(len(t1), 2 * OBJ + 5)
    s.call(fs.stat, f"/{t1}/sub/f-link")
    s.call(fs.readdir, f"/{t1}")
    s.call(fs.readdir, f"/{t1}/sub")
    s.call(fs.rename, f"/{t0}/sub/f", f"/{t1}/sub/g")    # one rank now
    s.call(fs.rmdir, f"/{t1}/empty")
    for oid in [data_oid(st0["ino"], n) for n in range(3)]:
        s.exists(oid)
    s.call(fs.listdir, "/")
    s.call(fs.stat, f"/{t2}")


@pytest.fixture(scope="module")
def pair():
    yield from started_pair("rep", SPLIT)


class TestMDSAgainstCephTpu:
    def test_pools_and_fs(self, pair):
        got = {pkg: pools_of(s) for pkg, s in pair.items()}
        assert got["port"] == got["ceph_tpu"]
        assert got["port"][0] == [(1, 0, 2, 1, 4), (1, 0, 2, 1, 4)]

    @pytest.mark.parametrize("script", [
        sc_snapshots, sc_dirfrags, sc_failover, sc_two_ranks],
        ids=lambda f: f.__name__[3:])
    def test_script_replies_match(self, pair, script):
        outs = run_both(pair, script)
        assert outs["port"] == outs["ceph_tpu"]
        assert any(o[:1] == ("raised",) for o in outs["port"]
                   if isinstance(o, tuple))

    def test_stores_match(self, pair):
        for s in pair.values():
            flush_mds(s)
        views = {pkg: store_views(s) for pkg, s in pair.items()}
        assert views["port"] == views["ceph_tpu"]
        names = {oid for v in views["port"].values() for _c, oid in v}
        for oid in ("mds_snaps", "mds1_journal", "mds1_inotable"):
            assert oid in names, oid
        assert any(o.startswith("snapmeta.") for o in names)
        ino = pair["port"].fs.stat("/big")["ino"]   # eight fragments
        assert {f"{ino:x}.{f:08x}" for f in range(8)} <= names
