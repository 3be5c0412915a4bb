"""The port's CephFS client and MDS against ceph_tpu's, on the CPU: the
namespace and file data on an erasure-coded data pool.

One ``MiniCluster`` of each package, side by side: one mon, three OSDs
on WALStores with upstream's 20 s heartbeat grace; the port's on
``device="cpu"`` (the kernels' plain versions).  Each has a replicated
metadata pool ``cephfs_metadata`` (size 2, pg_num 4), an EC data pool
``cephfs_data`` (k=2 m=1 ``jerasure reed_sol_van``, pg_num 4, rule 1,
min_size 2 = k), ``fs new`` by ``mon_command``, one MDS ``a`` whose
journal flushes only at the points the scripts choose (``flush_interval``
an hour), and one client of a fixed name (``entity=``; the journal rows
carry it) at a small default layout of 8 KiB objects.

Each scenario is one seeded script fed to both packages' ``CephFS``:
the path ops and their errors, rename's edge cases, symlinks, hard
links, reads and writes across objects with a plain and a striped
layout, holes, append, truncate, and the purge of a file's data objects
on unlink and on a rename over it (with two faults of the reference
pinned: a striped file's truncate and purge treat its layout as
unstriped).  The test compares every return
value, and each exception's type, ``rc`` and message; at the end every
OSD's store of both pools: object bytes, size and hinfo, omap rows and
xattrs.  The scripts assert their own answers too, in both packages.

Tolerance: exact.  Masks: the ``mtime`` and ``created`` fields of every
record, in replies and in the JSON rows of the metadata pool's omaps
(each side stamps its own clock), and nothing else.  The tests of the
module run in file order on one pair of clusters.
"""

import contextlib
import json
import random

import pytest
import torch

from ceph_tpu.osdc import striper as R_STRIPER
from ceph_tpu.vstart import MiniCluster as RMiniCluster
from ceph_tpu_torch.osdc import striper as P_STRIPER
from ceph_tpu_torch.vstart import MiniCluster as PMiniCluster
from test_torch_cluster import settled, wait_for

torch.set_num_threads(1)

N_OSDS = 3
PROFILE = ["k=2", "m=1", "plugin=jerasure", "technique=reed_sol_van"]
OSD_CONFIG = {"osd_heartbeat_grace": 20.0}
PKGS = {"ceph_tpu": (RMiniCluster, {}, R_STRIPER),
        "port": (PMiniCluster, {"device": "cpu"}, P_STRIPER)}
POOLS = ("cephfs_metadata", "cephfs_data")
ENTITY = "client.cmp"
OBJ = 8192                        # the client's default object size
TIMES = ("mtime", "created")


def payload(seed, n):
    return random.Random(seed).randbytes(n)


def masked(v):
    """``v`` with every ``mtime`` and ``created`` value replaced."""
    if isinstance(v, dict):
        return {k: "<t>" if k in TIMES else masked(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(masked(x) for x in v)
    return v


def data_oid(ino, objno):
    return f"{ino:x}.{objno:08x}"


class Side:
    """One package's cluster, file system client and script helpers."""

    def __init__(self, pkg, cluster, rados, fs):
        self.pkg, self.c, self.r, self.fs = pkg, cluster, rados, fs
        self.striper = PKGS[pkg][2]
        self.data = rados.open_ioctx("cephfs_data")
        self.out = []

    def layout(self, su, sc, osz):
        return self.striper.FileLayout(stripe_unit=su, stripe_count=sc,
                                       object_size=osz)

    def call(self, fn, *a, **kw):
        """fn's return value (its times masked), or its exception as
        (type name, rc, message); recorded in ``out`` either way."""
        try:
            got = masked(fn(*a, **kw))
        except Exception as e:                  # noqa: BLE001
            got = ("raised", type(e).__name__, getattr(e, "rc", None),
                   str(e))
        self.out.append(got)
        return got

    def note(self, value):
        self.out.append(value)
        return value

    def exists(self, oid):
        """Whether the data pool holds ``oid``, and its size."""
        try:
            return self.note((oid, self.data.stat(oid)["size"]))
        except Exception as e:                  # noqa: BLE001
            return self.note((oid, type(e).__name__))

    @property
    def mds(self):
        return next(m for m in self.c.mdss.values() if m.state == "active")


# -- the scenarios: s is one package's Side ------------------------------

def sc_path_ops(s):
    fs = s.fs
    s.call(fs.mkdir, "/d1")
    s.call(fs.mkdir, "/d1")                          # EEXIST
    s.call(fs.mkdir, "/")
    s.call(fs.mkdirs, "/d1/a/b/c")
    s.call(fs.mkdirs, "/d1/a/b/c")                   # all there: no error
    s.call(fs.mkdir, "/nope/x")                      # ENOENT on the way
    s.call(fs.mkdir, "/d1/..")                       # invalid names
    s.call(fs.mkdir, "/d1/.")
    s.call(fs.write_file, "/d1/f", payload(1, 300))
    assert s.call(fs.readdir, "/d1")[0][0] == "a"
    assert s.call(fs.listdir, "/d1") == ["a", "f"]
    assert s.call(fs.stat, "/d1/f")["size"] == 300
    s.call(fs.stat, "/d1/zz")
    s.call(fs.stat, "/")
    s.call(fs.mkdir, "/d1/f/x")                      # ENOTDIR
    s.call(fs.readdir, "/d1/f")
    s.call(fs.readdir, "/d1/zz")
    s.call(fs.rmdir, "/d1/a")                        # ENOTEMPTY
    s.call(fs.rmdir, "/d1/f")                        # ENOTDIR
    s.call(fs.unlink, "/d1/a")                       # EISDIR
    s.call(fs.unlink, "/d1/none")
    s.call(fs.rmdir, "/d1/a/b/c")
    s.call(fs.rmdir, "/d1/a/b")
    assert s.call(fs.listdir, "/d1/a") == []
    s.call(fs.open, "/d1/a", "r")                    # EISDIR
    s.call(fs.open, "/", "r")
    s.call(fs.open, "/d1/a", "w")
    s.call(fs.open, "/d1/zz", "r")
    s.call(fs.listdir, "/")


def sc_rename_edges(s):
    fs = s.fs
    fs.mkdirs("/r/x/y")
    fs.mkdirs("/r/empty")
    fs.mkdirs("/r/full/kid")
    for i, n in enumerate(("f1", "f2", "f3")):
        s.call(fs.write_file, f"/r/{n}", payload(10 + i, 1000 * (i + 1)))
    s.call(fs.rename, "/r/f1", "/r/g1")              # same directory
    s.call(fs.rename, "/r/g1", "/r/x/g1")            # another directory
    s.call(fs.rename, "/r/x/g1", "/r/x/g1")          # onto itself
    s.call(fs.rename, "/r/f2", "/r/f3")              # over a file
    assert s.call(fs.read_file, "/r/f3") == payload(11, 2000)
    s.call(fs.rename, "/r/x/y", "/r/empty")          # dir over empty dir
    s.call(fs.rename, "/r/empty", "/r/full")         # ENOTEMPTY
    s.call(fs.rename, "/r/f3", "/r/full")            # EISDIR
    s.call(fs.rename, "/r/full", "/r/f3")            # ENOTDIR
    s.call(fs.rename, "/r/x", "/r/x/g1dir")          # into its own subtree
    s.call(fs.rename, "/r", "/r/full/kid/r")
    s.call(fs.rename, "/r/full", "/r/full")          # dir onto itself
    s.call(fs.rename, "/r/none", "/r/n2")            # ENOENT
    s.call(fs.rename, "/", "/r/root")
    s.call(fs.rename, "/r/f3", "/r/nodir/f3")        # ENOENT on the way
    s.call(fs.rename, "/r/f3", "/r/x/g1/f3")         # ENOTDIR on the way
    s.call(fs.rename, "/r/f3", "/r/..")              # invalid name
    for d in ("/r", "/r/x", "/r/empty", "/r/full"):
        s.call(fs.readdir, d)


def sc_symlinks(s):
    fs = s.fs
    fs.mkdirs("/s/real/deep")
    s.call(fs.write_file, "/s/real/deep/t", payload(20, 5000))
    s.call(fs.symlink, "/s/real", "/s/abs")          # absolute target
    s.call(fs.symlink, "real/deep", "/s/rel")        # relative target
    s.call(fs.symlink, "t", "/s/real/deep/tl")       # beside its target
    s.call(fs.symlink, "x", "/s/abs")                # EEXIST
    s.call(fs.symlink, "x", "/")
    assert s.call(fs.readlink, "/s/abs") == "/s/real"
    s.call(fs.readlink, "/s/real")                   # EINVAL
    s.call(fs.readlink, "/s/none")
    assert s.call(fs.read_file, "/s/abs/deep/t") == payload(20, 5000)
    assert s.call(fs.read_file, "/s/rel/t") == payload(20, 5000)
    assert s.call(fs.read_file, "/s/real/deep/tl") == payload(20, 5000)
    s.call(fs.stat, "/s/abs")                        # the link itself
    s.call(fs.listdir, "/s/abs/deep")
    s.call(fs.open, "/s/real/deep/tl", "x")          # EEXIST, not followed
    fd = s.call(fs.open, "/s/real/deep/tl", "w")     # through to t
    s.call(fs.write, fd, b"through the link", 0)
    s.call(fs.close, fd)
    assert s.call(fs.read_file, "/s/real/deep/t") == b"through the link"
    s.call(fs.symlink, "/s/loop2", "/s/loop1")
    s.call(fs.symlink, "/s/loop1", "/s/loop2")
    s.call(fs.read_file, "/s/loop1")                 # ELOOP
    s.call(fs.listdir, "/s/loop1/x")
    s.call(fs.symlink, "/s/nowhere", "/s/dang")
    s.call(fs.read_file, "/s/dang")                  # ENOENT
    s.call(fs.write_file, "/s/dang", b"made through a dangling link")
    s.call(fs.read_file, "/s/nowhere")
    s.call(fs.symlink, "/", "/s/root")
    s.call(fs.read_file, "/s/root")                  # EISDIR
    s.call(fs.unlink, "/s/abs")
    s.call(fs.read_file, "/s/abs/deep/t")
    s.call(fs.listdir, "/s")


def sc_hard_links(s):
    fs = s.fs
    fs.mkdir("/h")
    s.call(fs.write_file, "/h/a", payload(30, 3 * OBJ + 7))
    s.call(fs.link, "/h/a", "/h/b")
    a, b = s.call(fs.stat, "/h/a"), s.call(fs.stat, "/h/b")
    assert a["ino"] == b["ino"] and a["nlink"] == 2
    fd = s.call(fs.open, "/h/b", "a")
    s.call(fs.write, fd, b"appended through b")
    s.call(fs.close, fd)
    assert s.call(fs.read_file, "/h/a") == \
        payload(30, 3 * OBJ + 7) + b"appended through b"
    s.call(fs.link, "/h/b", "/h/c")                  # a third name
    s.call(fs.link, "/h/a", "/h/c")                  # EEXIST
    s.call(fs.link, "/h", "/hdir")                   # a directory
    s.call(fs.link, "/h/none", "/h/d")
    s.call(fs.link, "/", "/h/e")
    s.call(fs.unlink, "/h/a")
    s.call(fs.stat, "/h/c")
    ino = s.call(fs.stat, "/h/b")["ino"]
    s.call(fs.write_file, "/h/other", b"o" * 100)
    s.call(fs.rename, "/h/other", "/h/b")            # over a shared name
    s.call(fs.stat, "/h/c")
    s.call(fs.readdir, "/h")
    for objno in range(5):
        s.exists(data_oid(ino, objno))
    s.call(fs.unlink, "/h/c")                        # the last link
    for objno in range(5):
        s.exists(data_oid(ino, objno))


def sc_io_plain(s):
    fs = s.fs
    fs.mkdir("/io")
    data = payload(40, 5 * OBJ + 300)                # six objects
    s.call(fs.write_file, "/io/plain", data)
    assert s.call(fs.read_file, "/io/plain") == data
    fd = s.call(fs.open, "/io/plain", "r")
    assert s.call(fs.read, fd, 200, OBJ - 100) == data[OBJ - 100:OBJ + 100]
    s.call(fs.read, fd, 100, len(data) - 10)         # clamps at the size
    s.call(fs.read, fd, 100, len(data) + 10)         # past the end
    s.call(fs.read, fd, 0, 0)
    s.call(fs.write, fd, b"x")                       # EBADF: read-only fd
    s.call(fs.close, fd)
    s.call(fs.read, fd, 10)                          # closed
    ino = s.call(fs.stat, "/io/plain")["ino"]
    for objno in range(7):
        s.exists(data_oid(ino, objno))
    # overwrite across an object boundary, then a hole past the end
    fd = s.call(fs.open, "/io/plain", "a")
    s.call(fs.write, fd, b"y" * 500, 2 * OBJ - 250)
    s.call(fs.stat, "/io/plain")                     # unflushed size
    s.call(fs.write, fd, b"tail", 8 * OBJ + 5)
    s.call(fs.stat, "/io/plain")
    s.call(fs.fsync, fd)
    s.call(fs.close, fd)
    want = bytearray(data) + bytes(8 * OBJ + 5 - len(data)) + b"tail"
    want[2 * OBJ - 250:2 * OBJ + 250] = b"y" * 500
    assert s.call(fs.read_file, "/io/plain") == bytes(want)
    for objno in range(9):
        s.exists(data_oid(ino, objno))
    fd = s.call(fs.open, "/io/app", "x")
    s.call(fs.open, "/io/app", "x")                  # EEXIST
    s.call(fs.write, fd, b"12345")
    s.call(fs.close, fd)
    fd = s.call(fs.open, "/io/app", "a")
    s.call(fs.write, fd, b"678")                     # at the size
    s.call(fs.close, fd)
    assert s.call(fs.read_file, "/io/app") == b"12345678"
    s.call(fs.fsync, 999)                            # EBADF
    s.call(fs.readdir, "/io")


def sc_io_striped(s):
    fs = s.fs
    fs.mkdir("/st")
    lay = s.layout(1024, 3, 4096)                    # 3 objects a set
    data = payload(50, 20000)
    s.call(fs.write_file, "/st/f", data, layout=lay)
    rec = s.call(fs.stat, "/st/f")
    assert rec["layout"] == {"stripe_unit": 1024, "stripe_count": 3,
                             "object_size": 4096}
    assert s.call(fs.read_file, "/st/f") == data
    fd = s.call(fs.open, "/st/f", "a")
    s.call(fs.write, fd, b"z" * 3000, 5000)          # across stripe units
    s.call(fs.read, fd, 4000, 4500)
    s.call(fs.close, fd)
    want = bytearray(data)
    want[5000:8000] = b"z" * 3000
    assert s.call(fs.read_file, "/st/f") == bytes(want)
    for objno in range(7):
        s.exists(data_oid(rec["ino"], objno))
    s.call(fs.write_file, "/st/bad", b"x", layout=s.layout(1000, 1, 4096))
    s.call(fs.stat, "/st/bad")


def sc_truncate(s):
    fs = s.fs
    fs.mkdir("/t")
    data = payload(60, 5 * OBJ + 100)
    s.call(fs.write_file, "/t/f", data)
    ino = s.call(fs.stat, "/t/f")["ino"]
    s.call(fs.truncate, "/t/f", 2 * OBJ + 100)       # inside an object
    assert s.call(fs.read_file, "/t/f") == data[:2 * OBJ + 100]
    for objno in range(6):
        s.exists(data_oid(ino, objno))
    s.call(fs.truncate, "/t/f", 4 * OBJ)             # grows: a hole
    assert s.call(fs.read_file, "/t/f") == \
        data[:2 * OBJ + 100] + bytes(2 * OBJ - 100)
    s.call(fs.truncate, "/t/f", OBJ)                 # on a boundary
    s.call(fs.read_file, "/t/f")
    s.call(fs.truncate, "/t/f", 0)
    assert s.call(fs.read_file, "/t/f") == b""
    for objno in range(6):
        s.exists(data_oid(ino, objno))
    s.call(fs.truncate, "/t/none", 10)
    s.call(fs.truncate, "/t", 10)                    # a directory's record
    s.call(fs.write_file, "/t/w", payload(61, 3 * OBJ))
    s.call(fs.write_file, "/t/w", b"short")          # 'w' truncates first
    assert s.call(fs.read_file, "/t/w") == b"short"
    lay = s.layout(1024, 3, 4096)
    s.call(fs.write_file, "/t/st", payload(62, 20000), layout=lay)
    s.call(fs.truncate, "/t/st", 9000)
    # the truncate cuts object 9000 // 4096 at 9000 % 4096 as if the
    # layout were not striped: 2041 of the 9000 bytes read back as
    # zeros, in both packages (ROADMAP.md §3)
    got = s.call(fs.read_file, "/t/st")
    assert sum(a != b for a, b in zip(got, payload(62, 9000))) == 2041
    ino = s.call(fs.stat, "/t/st")["ino"]
    for objno in range(6):
        s.exists(data_oid(ino, objno))


def sc_purge(s):
    fs = s.fs
    fs.mkdir("/p")
    s.call(fs.write_file, "/p/f", payload(70, 3 * OBJ + 1))
    s.call(fs.write_file, "/p/g", payload(71, 2 * OBJ))
    f, g = s.call(fs.stat, "/p/f"), s.call(fs.stat, "/p/g")
    oids = [data_oid(f["ino"], n) for n in range(4)] + \
        [data_oid(g["ino"], n) for n in range(2)]
    for oid in oids:
        assert isinstance(s.exists(oid)[1], int)
    s.call(fs.unlink, "/p/f")
    s.call(fs.rename, "/p/g", "/p/h")
    s.call(fs.write_file, "/p/k", payload(72, OBJ + 3))
    s.call(fs.rename, "/p/k", "/p/h")                # over g's data
    for oid in oids:
        assert s.exists(oid)[1] == "ObjectNotFound"
    s.call(fs.read_file, "/p/h")
    s.call(fs.unlink, "/p/h")
    # the purge counts a file's objects as if the layout were not
    # striped: of the six objects of 20000 bytes striped 3 x 1 KiB over
    # 4 KiB objects, the sixth stays (ROADMAP.md §3)
    s.call(fs.write_file, "/p/st", payload(73, 20000),
           layout=s.layout(1024, 3, 4096))
    ino = s.call(fs.stat, "/p/st")["ino"]
    s.call(fs.unlink, "/p/st")
    assert [isinstance(s.exists(data_oid(ino, n))[1], int)
            for n in range(7)] == [False] * 5 + [True, False]
    s.call(fs.rmdir, "/p")
    s.call(fs.stat, "/p")


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_path_ops, sc_rename_edges, sc_symlinks, sc_hard_links, sc_io_plain,
    sc_io_striped, sc_truncate, sc_purge)}


def store_views(s):
    """{osd: {(cid, oid): (data, size, hinfo, omap, xattrs)}} of both
    pools' collections, the PG meta objects left out; every omap value
    that is JSON is parsed and its times masked."""
    pools = {s.r.pool_lookup(p) for p in POOLS}

    def value(v):
        try:
            return masked(json.loads(bytes(v)))
        except ValueError:
            return bytes(v)

    views = {}
    for i, osd in sorted(s.c.osds.items()):
        st, view = osd.store, {}
        with osd.lock:
            for cid in st.list_collections():
                if int(cid.split(".")[0]) not in pools:
                    continue
                for oid in st.list_objects(cid):
                    if oid.startswith("_"):
                        continue
                    attrs = {k: bytes(v)
                             for k, v in st.getattrs(cid, oid).items()}
                    meta = json.loads(attrs.pop("_", b"{}"))
                    omap = {k: value(v)
                            for k, v in st.omap_get(cid, oid).items()}
                    view[cid, oid] = (bytes(st.read(cid, oid)),
                                      meta.get("size"), meta.get("hinfo"),
                                      omap, attrs)
        views[i] = view
    return views


def flush_mds(s):
    """The active MDS's journal flushed into the dirfrags and trimmed,
    under its lock (the point its beacon loop would flush at)."""
    mds = s.mds
    with mds.lock:
        mds._flush(trim=True)


def start_side(pkg, clusters, data_pool, split=None):
    """One package's cluster with the two pools, the file system, MDS
    ``a`` (its dirfrag split size ``split`` when given) and one client,
    settled; appended to ``clusters`` before it starts, for the caller
    to stop."""
    mc, kw, striper = PKGS[pkg]
    c = mc(n_mons=1, n_osds=N_OSDS, osd_config=OSD_CONFIG, **kw)
    clusters.append(c)
    c.start()
    r = c.rados()
    if data_pool == "ec":
        rc, outs, _ = r.mon_command({
            "prefix": "osd erasure-code-profile set", "name": "k2m1",
            "profile": PROFILE})
        assert rc == 0, outs
        r.create_pool("cephfs_data", pg_num=4, pool_type="erasure",
                      erasure_code_profile="k2m1", rule=1, min_size=2)
    else:
        r.create_pool("cephfs_data", pg_num=4, size=2)
    r.create_pool("cephfs_metadata", pg_num=4, size=2)
    c.wait_for_clean(timeout=120)
    assert wait_for(lambda: settled(c, r), timeout=60), pkg
    rc, outs, _ = r.mon_command({
        "prefix": "fs new", "fs_name": "cephfs",
        "metadata": "cephfs_metadata", "data": "cephfs_data"})
    assert rc == 0, outs
    mds = c.start_mds("a", flush_interval=3600.0)
    if split is not None:
        mds.dirfrag_split_size = split
    assert c.wait_for_active_mds(timeout=60) == "a"
    fs = c.cephfs(entity=ENTITY, default_layout=striper.FileLayout(
        stripe_unit=OBJ, stripe_count=1, object_size=OBJ))
    return Side(pkg, c, r, fs)


def started_pair(data_pool, split=None):
    """{pkg: Side}, both clusters started (a generator: the clusters
    stop when it closes)."""
    clusters = []
    try:
        yield {pkg: start_side(pkg, clusters, data_pool, split)
               for pkg in PKGS}
    finally:
        for c in clusters:
            with contextlib.suppress(Exception):
                c.stop()


def run_both(pair, script, *a):
    """script(s, *a) on each side; → {pkg: its recorded replies}."""
    outs = {}
    for pkg, s in pair.items():
        s.out = []
        script(s, *a)
        outs[pkg] = s.out
    return outs


def pools_of(s):
    rc, _outs, dump = s.r.mon_command({"prefix": "osd dump"})
    assert rc == 0
    pools = {p["name"]: p for p in dump["pools"]}
    rc, _outs, fsls = s.r.mon_command({"prefix": "fs ls"})
    assert rc == 0
    rc, _outs, stat = s.r.mon_command({"prefix": "mds stat"})
    assert rc == 0
    return ([(pools[n]["type"], pools[n]["crush_rule"], pools[n]["size"],
              pools[n]["min_size"], pools[n]["pg_num"]) for n in POOLS],
            fsls, stat["up"], stat["standby_count"])


@pytest.fixture(scope="module")
def pair():
    yield from started_pair("ec")


class TestCephFSAgainstCephTpu:
    def test_pools_and_fs(self, pair):
        got = {pkg: pools_of(s) for pkg, s in pair.items()}
        assert got["port"] == got["ceph_tpu"]
        assert got["port"][0] == [(1, 0, 2, 1, 4), (3, 1, 3, 2, 4)]
        assert got["port"][2] == {"cephfs:mds.0": "a"}

    @pytest.mark.parametrize("scenario", list(SCENARIOS))
    def test_scenario_replies_match(self, pair, scenario):
        outs = run_both(pair, SCENARIOS[scenario])
        assert outs["port"] == outs["ceph_tpu"]
        assert len(outs["port"]) > 10
        assert any(o[:1] == ("raised",) for o in outs["port"]
                   if isinstance(o, tuple))

    def test_stores_match(self, pair):
        for s in pair.values():
            flush_mds(s)
        views = {pkg: store_views(s) for pkg, s in pair.items()}
        assert views["port"] == views["ceph_tpu"]
        names = {oid for v in views["port"].values() for _c, oid in v}
        for oid in ("1.00000000", "mds0_journal", "mds0_inotable",
                    "mds_inodes"):
            assert oid in names, oid
        hinfos = [h for v in views["port"].values()
                  for _d, _s, h, _o, _a in v.values() if h is not None]
        assert hinfos                            # the EC data objects
