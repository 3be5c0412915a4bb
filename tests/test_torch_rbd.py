"""The port's RBD images and ``rbd`` CLI against ceph_tpu's, on the CPU.

One ``MiniCluster`` of each package, side by side: one mon, three OSDs
on WALStores with upstream's 20 s heartbeat grace; the port's on
``device="cpu"`` (the kernels' plain versions).  Each has an EC pool
``ecrbd`` (k=2 m=1 ``jerasure reed_sol_van``, pg_num 4, rule 1,
min_size 2 = k) and a replicated pool ``rbd`` (size 2, pg_num 4).

Each scenario is one seeded script fed to both packages' ``RBD`` and
``Image`` on one pool (live migration moves an image to the other
pool): image I/O spanning objects, plain and striped; snapshots after
overwrite; resize and discard; snapshot removal and clone GC; clone,
copy-up and flatten with the discard, shrink and regrow cases; the
parent-with-children refusal; export/import-diff and its errors; the
object map and fast-diff; at-rest encryption; live migration; and the
``rbd`` CLI's verbs through ``tools.rbd.main``.  The test compares
every return value and each exception's type and message, the CLI's
stdout and return code (times masked in ``bench`` only), and at the end
every OSD's store of both pools: data, size and hinfo of every object,
its omap rows (``rbd_header.*``, ``rbd_journal.*``) and its xattrs
(``cloned_upto``).  The script asserts its own answers too, in both
packages.  The scripts draw ``os.urandom`` (the encryption salt, key
and nonces) and ``uuid.uuid4`` (the lock cookie) from one seeded stream
per package when ``rbd.image`` is on the caller's stack.

Tolerance: exact.  ceph_tpu's clients list with the port's pinned
pgls (``test_torch_cluster.pin_pgls``).  The tests of the module run in
file order on one pair of clusters.
"""

import contextlib
import json
import os
import random
import sys
import uuid

import pytest
import torch

from ceph_tpu import rbd as R_RBD
from ceph_tpu.osdc import librados as R_LIBRADOS
from ceph_tpu.osdc import striper as R_STRIPER
from ceph_tpu.rbd import image as R_IMAGE
from ceph_tpu.tools import rbd as R_CLI
from ceph_tpu.vstart import MiniCluster as RMiniCluster
from ceph_tpu_torch import rbd as P_RBD
from ceph_tpu_torch.osdc import striper as P_STRIPER
from ceph_tpu_torch.rbd import image as P_IMAGE
from ceph_tpu_torch.tools import rbd as P_CLI
from ceph_tpu_torch.vstart import MiniCluster as PMiniCluster
from test_torch_cluster import pin_pgls, settled, wait_for

torch.set_num_threads(1)

N_OSDS = 3
ORDER = 12
OBJ = 1 << ORDER                 # 4 KiB objects
PROFILE = ["k=2", "m=1", "plugin=jerasure", "technique=reed_sol_van"]
OSD_CONFIG = {"osd_heartbeat_grace": 20.0}
POOLS = {"ec": "ecrbd", "rep": "rbd"}
PKGS = {"ceph_tpu": (RMiniCluster, {}, R_RBD, R_IMAGE, R_STRIPER, R_CLI),
        "port": (PMiniCluster, {"device": "cpu"}, P_RBD, P_IMAGE,
                 P_STRIPER, P_CLI)}
BENCH_TIMES = ("seconds", "ops_per_sec", "mb_per_sec")


class PinnedRados(R_LIBRADOS.Rados):
    """ceph_tpu's client for the CLI, listing with the pinned pgls."""

    def connect(self, *a, **kw):
        out = super().connect(*a, **kw)
        pin_pgls(self.objecter)
        return out


class SeededStreams:
    """``os.urandom`` and ``uuid.uuid4`` drawn from one seeded stream
    per package while that package's ``rbd.image`` is on the stack;
    every other caller gets the real ones."""

    def __init__(self, seed):
        self.rngs = {pkg: random.Random(seed) for pkg in PKGS}
        self.real = (os.urandom, uuid.uuid4)

    def _rng(self, depth):
        f = sys._getframe(depth)
        while f is not None:
            name = f.f_globals.get("__name__", "")
            if name.endswith(".rbd.image"):
                return self.rngs["port" if name.startswith(
                    "ceph_tpu_torch.") else "ceph_tpu"]
            f = f.f_back
        return None

    def urandom(self, n):
        rng = self._rng(2)
        return self.real[0](n) if rng is None else rng.randbytes(n)

    def uuid4(self):
        f = sys._getframe(1)
        if not f.f_globals.get("__name__", "").endswith(".rbd.image"):
            return uuid.UUID(bytes=self.real[0](16), version=4)
        return uuid.UUID(bytes=self._rng(1).randbytes(16), version=4)


def payload(seed, n):
    return random.Random(seed).randbytes(n)


class Side:
    """One package's cluster, pools and script helpers."""

    def __init__(self, pkg, cluster, rados):
        self.pkg, self.c, self.r = pkg, cluster, rados
        _mc, _kw, rbd_mod, self.image_mod, self.striper, self.cli = \
            PKGS[pkg]
        self.RBD, self.Image = rbd_mod.RBD, rbd_mod.Image
        self.ImageNotFound = rbd_mod.ImageNotFound
        self.ios = {p: rados.open_ioctx(name) for p, name in POOLS.items()}
        self.mon = ",".join(f"{a.host}:{a.port}"
                            for a in cluster.monmap.mons.values())
        self.out = []

    def call(self, fn, *a, **kw):
        """fn's return value, or its exception as (type name,
        message); recorded in ``out`` either way (an ``Image`` by its
        name and snapshot id)."""
        try:
            got = fn(*a, **kw)
        except (Exception, SystemExit) as e:     # noqa: BLE001
            got = ("raised", type(e).__name__, str(e))
        self.out.append(("Image", got.name, got.snap_id)
                        if isinstance(got, self.Image) else got)
        return got

    def note(self, value):
        self.out.append(value)
        return value

    def rbd_cli(self, pool, *argv):
        """``rbd -m MON -p POOL argv`` in process: (rc, stdout lines)."""
        lines = []

        def capture(*a, file=None, **_k):
            lines.append(" ".join(str(x) for x in a))

        self.cli.print = capture
        if self.pkg == "ceph_tpu":
            self.cli.Rados = PinnedRados
        try:
            try:
                rc = self.cli.main(["-m", self.mon, "-p", POOLS[pool],
                                    *argv])
            except SystemExit as e:
                rc = ("SystemExit", str(e))
            except Exception as e:                  # noqa: BLE001
                rc = ("raised", type(e).__name__, str(e))
        finally:
            del self.cli.print
            if self.pkg == "ceph_tpu":
                self.cli.Rados = R_LIBRADOS.Rados
        if argv[0] == "bench":
            lines = [json.dumps({k: ("<t>" if k in BENCH_TIMES else v)
                                 for k, v in json.loads(ln).items()})
                     for ln in lines]
        # a file by its name: each package has a folder of its own
        argv = tuple(os.path.basename(a) if os.sep in a else a
                     for a in argv)
        return self.note((argv, rc, lines))


# -- the scenarios: s is one package's Side, p the pool's key -------------

def sc_io_spanning_objects(s, p):
    io, rbd = s.ios[p], s.RBD()
    s.call(rbd.create, io, "img", 16 * OBJ, order=ORDER)
    img = s.Image(io, "img")
    assert s.note(img.stat())["size"] == 16 * OBJ
    data = payload(1, 5 * OBJ + 300)                 # six objects
    s.call(img.write, 1000, data)
    assert s.call(img.read, 1000, len(data)) == data
    assert s.call(img.read, 14 * OBJ, 100) == b"\x00" * 100   # sparse
    s.call(img.read, 16 * OBJ - 10, 100)             # clamps at size
    s.call(img.write, 16 * OBJ - 10, b"x" * 11)      # past the end
    datas = [o for o in io.list_objects() if o.startswith("rbd_data.img.")]
    assert len(s.note(sorted(datas))) == 6
    assert "img" in s.call(rbd.list, io)
    s.call(rbd.create, io, "img", OBJ)               # exists
    s.call(rbd.create, io, "neg", -1)
    s.call(s.Image, io, "nosuch")


def sc_striped_image_io(s, p):
    io, rbd = s.ios[p], s.RBD()
    # two objects a set, four stripe units an object
    s.call(rbd.create, io, "strp", 8 * OBJ, order=ORDER,
           stripe_unit=OBJ // 4, stripe_count=2)
    s.call(rbd.create, io, "badl", OBJ, order=ORDER, stripe_unit=3000)
    with s.Image(io, "strp") as img:
        data = payload(2, OBJ + 77)
        s.call(img.write, 500, data)
        assert s.call(img.read, 500, len(data)) == data
        s.note(img.stat())
        s.call(img.create_snap, "g")
        s.call(img.protect_snap, "g")
    s.call(rbd.clone, io, "strp", "g", "strpc")
    with s.Image(io, "strpc") as c:
        # a stripe-aware copy-up keeps the interleaved parent bytes
        s.call(c.write, OBJ // 2 + 5, b"CHILD")
        want = bytearray(data)
        want[OBJ // 2 + 5 - 500:OBJ // 2 + 10 - 500] = b"CHILD"
        assert s.call(c.read, 500, len(data)) == bytes(want)
        s.call(c.flatten)
        assert s.call(c.read, 500, len(data)) == bytes(want)


def sc_snapshot_after_overwrite(s, p):
    io, rbd = s.ios[p], s.RBD()
    s.call(rbd.create, io, "snapimg", 8 * OBJ, order=ORDER)
    img = s.Image(io, "snapimg")
    v1 = payload(3, 2 * OBJ)
    s.call(img.write, 0, v1)
    s.call(img.create_snap, "s1")
    v2 = payload(4, 2 * OBJ)
    s.call(img.write, 0, v2)
    assert s.call(img.read, 0, len(v2)) == v2
    snap = s.call(rbd.open, io, "snapimg", snapshot="s1")
    assert s.call(snap.read, 0, len(v1)) == v1
    s.call(snap.write, 0, b"nope")
    s.call(img.create_snap, "s2")
    s.call(img.create_snap, "s2")                    # exists
    v3 = payload(5, 2 * OBJ)
    s.call(img.write, 0, v3)
    assert s.call(s.Image(io, "snapimg", "s1").read, 0, len(v1)) == v1
    assert s.call(s.Image(io, "snapimg", "s2").read, 0, len(v2)) == v2
    assert s.call(img.read, 0, len(v3)) == v3
    s.call(img.write, 4 * OBJ, b"late-bytes")
    assert s.call(s.Image(io, "snapimg", "s2").read, 4 * OBJ, 10) \
        == b"\x00" * 10
    s.note(img.list_snaps())
    s.call(img.remove_snap, "s1")
    s.call(rbd.open, io, "snapimg", snapshot="s1")
    s.call(img.remove_snap, "s1")


def sc_resize_and_discard(s, p):
    io, rbd = s.ios[p], s.RBD()
    s.call(rbd.create, io, "rsz", 4 * OBJ, order=ORDER)
    img = s.Image(io, "rsz")
    s.call(img.write, 0, b"A" * (4 * OBJ))
    s.call(img.resize, 2 * OBJ)
    assert s.call(img.size) == 2 * OBJ
    assert s.call(img.read, 0, 8 * OBJ) == b"A" * (2 * OBJ)
    s.call(img.discard, 0, OBJ)
    assert s.call(img.read, 0, OBJ) == b"\x00" * OBJ
    assert s.call(img.read, OBJ, OBJ) == b"A" * OBJ
    s.call(img.discard, OBJ + 100, 50)               # zeroes a range
    s.call(img.resize, 3 * OBJ)
    assert s.call(img.read, OBJ, 2 * OBJ) == \
        b"A" * 100 + b"\x00" * 50 + b"A" * (OBJ - 150) + b"\x00" * OBJ


def sc_remove_snap_gc(s, p):
    io, rbd = s.ios[p], s.RBD()
    s.call(rbd.create, io, "gcimg", 2 * OBJ, order=ORDER)
    img = s.Image(io, "gcimg")
    a = b"AAAA" * (OBJ // 4)
    s.call(img.write, 0, a)
    s.call(img.create_snap, "s1")
    s.call(img.create_snap, "s2")
    s.call(img.write, 0, b"BBBB" * (OBJ // 4))       # one clone, @2
    s.call(img.remove_snap, "s2")
    assert s.call(s.Image(io, "gcimg", "s1").read, 0, len(a)) == a
    s.call(img.remove_snap, "s1")
    left = [o for o in io.list_objects()
            if o.startswith("rbd_data.gcimg.") and "@" in o]
    assert s.note(left) == []


def sc_clone_cow_and_flatten(s, p):
    io, rbd = s.ios[p], s.RBD()
    s.call(rbd.create, io, "base", 4 * OBJ, order=ORDER)
    with s.Image(io, "base") as par:
        s.call(par.write, 0, b"parentdata" * 100)
        s.call(par.write, OBJ + 200, b"tail")
        s.call(par.create_snap, "gold")
        s.call(rbd.clone, io, "base", "gold", "childX")   # unprotected
        s.call(par.protect_snap, "gold")
    s.call(rbd.clone, io, "base", "nosnap", "childY")
    s.call(rbd.clone, io, "base", "gold", "child")
    assert s.call(rbd.children, io, "base", "gold") == ["child"]
    with s.Image(io, "child") as c:
        assert s.call(c.read, 0, 10) == b"parentdata"
        assert s.call(c.read, OBJ + 200, 4) == b"tail"
        s.call(c.write, 4, b"XY")                     # copy-up
        assert s.call(c.read, 0, 10) == b"pareXYdata"
    with s.Image(io, "base") as par:
        assert s.call(par.read, 0, 10) == b"parentdata"
        s.call(par.write, 0, b"NEWPARENT!")
    with s.Image(io, "child") as c:
        assert s.call(c.read, 0, 10) == b"pareXYdata"
        assert s.call(c.read, OBJ, 4) == b"\x00" * 4
    with s.Image(io, "base") as par:
        s.call(par.remove_snap, "gold")
        s.call(par.unprotect_snap, "gold")
    with s.Image(io, "child") as c:
        s.call(c.flatten)
        assert s.call(c.read, 0, 10) == b"pareXYdata"
        assert s.call(c.read, OBJ + 200, 4) == b"tail"
    assert s.call(rbd.children, io, "base", "gold") == []
    with s.Image(io, "base") as par:
        s.call(par.unprotect_snap, "gold")
        s.call(par.remove_snap, "gold")


def sc_clone_discard_shrink_regrow(s, p):
    io, rbd = s.ios[p], s.RBD()
    s.call(rbd.create, io, "base2", 2 * OBJ, order=ORDER)
    with s.Image(io, "base2") as par:
        s.call(par.write, 0, b"Z" * OBJ)
        s.call(par.write, OBJ, b"P" * 1000)
        s.call(par.create_snap, "s")
        s.call(par.protect_snap, "s")
    s.call(rbd.clone, io, "base2", "s", "c2")
    s.call(rbd.clone, io, "base2", "s", "c3")
    with s.Image(io, "c2") as c:
        s.call(c.discard, 0, OBJ)                    # zeroed, not removed
        assert s.call(c.read, 0, 100) == b"\x00" * 100
    with s.Image(io, "c3") as c:
        s.call(c.resize, 0)
        s.call(c.resize, 2 * OBJ)
        assert s.call(c.read, OBJ, 1000) == b"\x00" * 1000
    assert s.call(rbd.children, io, "base2", "s") == ["c2", "c3"]
    s.call(rbd.remove, io, "c3")
    assert s.call(rbd.children, io, "base2", "s") == ["c2"]


def sc_parent_with_children_refused(s, p):
    io, rbd = s.ios[p], s.RBD()
    s.call(rbd.create, io, "base4", OBJ, order=ORDER)
    with s.Image(io, "base4") as par:
        s.call(par.write, 0, b"x")
        s.call(par.create_snap, "s")
        s.call(par.protect_snap, "s")
    s.call(rbd.clone, io, "base4", "s", "c4")
    s.call(rbd.remove, io, "base4")                  # children
    with s.Image(io, "c4") as c:
        s.call(c.flatten)
    s.call(rbd.remove, io, "base4")                  # still protected
    with s.Image(io, "base4") as par:
        s.call(par.unprotect_snap, "s")
    s.call(rbd.remove, io, "base4")
    assert "base4" not in s.call(rbd.list, io)


def sc_export_import_diff(s, p):
    io, rbd = s.ios[p], s.RBD()
    s.call(rbd.create, io, "src", 4 * OBJ, order=ORDER)
    with s.Image(io, "src") as src:
        s.call(src.write, 0, b"AAAA" * 500)
        s.call(src.create_snap, "s1")
        s.call(src.write, 1500, b"BBBB" * 10)
        s.call(src.write, 2 * OBJ + 100, b"CCCC")
        s.call(src.create_snap, "s2")
        s.call(src.write, 0, b"XXXX")                # after s2
    with s.Image(io, "src", snapshot="s1") as src:
        full = s.call(src.export_diff)
    with s.Image(io, "src", snapshot="s2") as src:
        inc = s.call(src.export_diff, from_snap="s1")
    assert 0 < sum(len(e["data"]) // 2 for e in inc["extents"]) <= 200
    s.call(rbd.create, io, "restore", 4 * OBJ, order=ORDER)
    with s.Image(io, "restore") as d:
        s.call(d.import_diff, inc)                   # base missing
        s.call(d.import_diff, full)
        s.call(d.import_diff, inc)
        s.note(d.list_snaps())
    with s.Image(io, "src", snapshot="s2") as src, \
            s.Image(io, "restore", read_only=True) as d:
        assert s.call(d.read, 0, 4 * OBJ) == s.call(src.read, 0, 4 * OBJ)
    s.call(rbd.create, io, "de", OBJ, order=ORDER)
    with s.Image(io, "de", read_only=True) as img:
        s.call(img.export_diff, from_snap="nope")
    with s.Image(io, "de") as img:
        s.call(img.import_diff, {"size": OBJ, "from_snap": "missing-base",
                                 "extents": []})


def sc_cli(s, p, tmp):
    data = payload(9, 3 * OBJ + 5)
    tmp = tmp / s.pkg
    tmp.mkdir()
    src, out, d0, d1 = (tmp / n for n in ("in.bin", "out.bin", "d0", "d1"))
    src.write_bytes(data)

    def cli(*argv):
        return s.rbd_cli(p, *argv)[1:]

    def ours(reply):
        rc, lines = reply
        assert rc == 0
        return [n for n in lines[0].split("\n") if n.startswith("cli-")]

    size, order = ["--size", str(4 * OBJ)], ["--order", str(ORDER)]
    assert cli("create", "cli-img", *size, *order) == (0, [])
    cli("create", "cli-jrn", *size, *order, "--journaling")
    cli("create", "cli-snp", *size, *order, "--mirror-snapshot")
    assert ours(cli("ls")) == ["cli-img", "cli-jrn", "cli-snp"]
    assert json.loads(cli("info", "cli-img")[1][0])["num_objs"] == 4
    assert cli("import", str(src), "cli-imp") == (
        0, [f"imported {len(data)} bytes"])
    cli("export", "cli-imp", str(out))
    assert out.read_bytes() == data
    io = ["--io-size", str(OBJ), "--io-total", str(4 * OBJ)]
    rc, lines = cli("bench", "cli-img", "--io-type", "write", *io)
    assert rc == 0 and json.loads(lines[0])["bytes"] == 4 * OBJ
    cli("bench", "cli-img", "--io-type", "read", *io)
    cli("bench", "cli-jrn", "--io-type", "write", "--io-size", "1000",
        "--io-total", "3000")                        # journaled
    cli("snap", "create", "cli-img@s1")
    assert cli("snap", "create", "cli-img") == (
        ("SystemExit", "snap ops want NAME@SNAP"), [])
    cli("resize", "cli-img", "--size", str(2 * OBJ))
    cli("snap", "create", "cli-img@s2")
    cli("snap", "ls", "cli-img")
    cli("export", "cli-img@s1", str(out))
    s.note(out.read_bytes())
    cli("export-diff", "cli-img@s2", str(d0))
    cli("export-diff", "cli-img@s2", str(d1), "--from-snap", "s1")
    s.note(json.loads(d1.read_text()))
    cli("create", "cli-dst", *size, *order)
    cli("import-diff", str(d0), "cli-dst")
    cli("import-diff", str(d1), "cli-dst")               # base s1 missing
    cli("export", "cli-dst", str(out))
    s.note(out.read_bytes())
    cli("snap", "protect", "cli-img@s2")
    cli("clone", "cli-img@s2", "cli-kid")
    cli("clone", "cli-img", "cli-kid2")                     # wants PARENT@SNAP
    assert cli("children", "cli-img@s2") == (0, ["cli-kid"])
    assert cli("rm", "cli-img")[0][:2] == ("raised", "ValueError")
    cli("flatten", "cli-kid")
    assert cli("children", "cli-img@s2") == (0, [""])
    cli("snap", "unprotect", "cli-img@s2")
    cli("snap", "rm", "cli-img@s1")
    cli("snap", "ls", "cli-img")
    cli("mirror", "status", "cli-jrn")
    cli("mirror", "demote", "cli-jrn")
    assert json.loads(cli("mirror", "status", "cli-jrn")[1][0])[
        "primary"] is False
    cli("mirror", "promote", "cli-jrn")
    assert cli("mirror", "snapshot", "cli-snp") == (0, [".mirror.primary.1"])
    cli("mirror", "status", "cli-snp")
    assert cli("mirror", "snapshot", "cli-imp")[0][:2] == (
        "raised", "ValueError")
    cli("rm", "cli-kid")
    assert ours(cli("ls")) == [
        "cli-dst", "cli-img", "cli-imp", "cli-jrn", "cli-snp"]


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_io_spanning_objects, sc_striped_image_io,
    sc_snapshot_after_overwrite, sc_resize_and_discard, sc_remove_snap_gc,
    sc_clone_cow_and_flatten, sc_clone_discard_shrink_regrow,
    sc_parent_with_children_refused, sc_export_import_diff)}
# every scenario on the EC pool, two on the replicated one too
CASES = [(name, "ec") for name in SCENARIOS] + [
    ("io_spanning_objects", "rep"), ("parent_with_children_refused", "rep")]


def store_views(s):
    """{osd: {(cid, oid): (data, size, hinfo, omap, xattrs)}} of both
    pools' collections; the PG meta objects left out."""
    pools = {s.ios[p].pool_id for p in POOLS}
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
                    omap = {k: bytes(v)
                            for k, v in st.omap_get(cid, oid).items()}
                    view[cid, oid] = (bytes(st.read(cid, oid)),
                                      meta.get("size"), meta.get("hinfo"),
                                      omap, attrs)
        views[i] = view
    return views


def start_side(pkg, clusters):
    """One package's cluster, started with both pools and settled; it
    is appended to ``clusters`` before it starts, for the caller to
    stop."""
    mc, kw, *_mods = PKGS[pkg]
    c = mc(n_mons=1, n_osds=N_OSDS, osd_config=OSD_CONFIG, **kw)
    clusters.append(c)
    c.start()
    r = c.rados()
    if pkg == "ceph_tpu":
        pin_pgls(r.objecter)
    rc, outs, _ = r.mon_command({
        "prefix": "osd erasure-code-profile set", "name": "k2m1",
        "profile": PROFILE})
    assert rc == 0, outs
    r.create_pool("ecrbd", pg_num=4, pool_type="erasure",
                  erasure_code_profile="k2m1", rule=1, min_size=2)
    r.create_pool("rbd", pg_num=4, size=2)
    s = Side(pkg, c, r)
    c.wait_for_clean(timeout=120)
    assert wait_for(lambda: settled(c, r), timeout=60), pkg
    return s


@contextlib.contextmanager
def seeded(seed):
    """The seeded ``os.urandom`` and ``uuid.uuid4``, patched in while
    the context is open."""
    streams = SeededStreams(seed)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os, "urandom", streams.urandom)
        mp.setattr(uuid, "uuid4", streams.uuid4)
        yield


def started_pair(seed):
    """{pkg: Side}, both clusters started, on seeded streams (a
    generator: the clusters stop when it closes)."""
    clusters = []
    with seeded(seed):
        try:
            yield {pkg: start_side(pkg, clusters) for pkg in PKGS}
        finally:
            for c in clusters:
                c.stop()


@pytest.fixture(scope="module")
def pair():
    yield from started_pair(16)


@pytest.mark.parametrize("layout,off,length", [
    ((4096, 1, 4096), 0, 10000),
    ((100, 2, 200), 0, 800),
    ((100, 2, 200), 250, 100),
    ((1024, 4, 4096), 3000, 20000),
    ((100, 1, 250), 0, 1),                         # invalid
    ((0, 1, 4096), 0, 1)])                         # invalid
def test_striper_layouts_match(layout, off, length):
    def run(striper):
        su, sc, osz = layout
        try:
            return [(e.object_no, e.offset, e.length, e.logical_offset)
                    for e in striper.file_to_extents(striper.FileLayout(
                        stripe_unit=su, stripe_count=sc, object_size=osz),
                        off, length)]
        except ValueError as e:
            return ("ValueError", str(e))

    got = run(P_STRIPER)
    assert got == run(R_STRIPER)
    if layout == (100, 2, 200) and off == 0:
        assert [(o, x) for o, x, _n, _l in got] == [
            (0, 0), (1, 0), (0, 100), (1, 100),
            (2, 0), (3, 0), (2, 100), (3, 100)]
    if layout[0] == 0 or layout[2] % layout[0]:
        assert got[0] == "ValueError"


class TestRBDAgainstCephTpu:
    def test_pools(self, pair):
        got = {}
        for pkg, s in pair.items():
            rc, _outs, dump = s.r.mon_command({"prefix": "osd dump"})
            assert rc == 0
            pools = {p["name"]: p for p in dump["pools"]}
            got[pkg] = [(pools[n]["type"], pools[n]["crush_rule"],
                         pools[n]["size"], pools[n]["min_size"],
                         pools[n]["pg_num"]) for n in POOLS.values()]
        assert got["port"] == got["ceph_tpu"]
        assert got["port"][0][1:] == (1, 3, 2, 4)

    @pytest.mark.parametrize("scenario,pool", CASES)
    def test_scenario_replies_match(self, pair, scenario, pool):
        outs = {}
        for pkg, s in pair.items():
            s.out = []
            SCENARIOS[scenario](s, pool)
            outs[pkg] = s.out
        assert outs["port"] == outs["ceph_tpu"]
        assert len(outs["port"]) > 5

    def test_cli_matches(self, pair, tmp_path):
        outs = {}
        for pkg, s in pair.items():
            s.out = []
            sc_cli(s, "ec", tmp_path)
            outs[pkg] = s.out
        assert outs["port"] == outs["ceph_tpu"]

    def test_stores_match(self, pair):
        views = {pkg: store_views(s) for pkg, s in pair.items()}
        assert views["port"] == views["ceph_tpu"]
        names = {oid for v in views["port"].values() for _c, oid in v}
        for pre in ("rbd_header.", "rbd_data.", "rbd_object_map.",
                    "rbd_journal."):
            assert any(o.startswith(pre) for o in names), pre
        assert any(k == "cloned_upto" for v in views["port"].values()
                   for *_x, attrs in v.values() for k in attrs)
