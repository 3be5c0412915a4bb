"""The port's client side against ceph_tpu's, on the CPU.

``osdc``: ``file_to_extents`` for seeded layouts, ``RadosStriper`` over
an in-memory I/O context, and ``Objecter._calc_target`` for 10k seeded
object names on a 4096-OSD map with upmaps.  The CLIs: one script of
``ceph`` commands, ``rados lspools``/``mkpool``/``rmpool``, and
librados (``Rados.connect``, ``list_pools``, ``pool_lookup``, the
Objecter's map) run against each package's three-mon quorum, with rc,
stdout and stderr equal once the named fields are normalised; and
``monmaptool`` files crossing between the packages.

Every wait polls with a deadline of at least 10 s; every mon and client
is shut down in a fixture or ``finally``.
"""

import io
import json
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import ceph_tpu.mon as RMON
import ceph_tpu.mon.messages as RMM
import ceph_tpu.msg as RMSG
import ceph_tpu.osdc.librados as RLIB
import ceph_tpu.osdc.objecter as ROBJ
import ceph_tpu.osdc.radosstriper as RRS
import ceph_tpu.osdc.striper as RSTR
import ceph_tpu.tools.ceph as RCEPH
import ceph_tpu.tools.monmaptool as RMMT
import ceph_tpu.tools.rados as RRADOS
import ceph_tpu_torch.mon as PMON
import ceph_tpu_torch.mon.messages as PMM
import ceph_tpu_torch.msg as PMSG
import ceph_tpu_torch.osdc.librados as PLIB
import ceph_tpu_torch.osdc.objecter as POBJ
import ceph_tpu_torch.osdc.radosstriper as PRS
import ceph_tpu_torch.osdc.striper as PSTR
import ceph_tpu_torch.tools.ceph as PCEPH
import ceph_tpu_torch.tools.monmaptool as PMMT
import ceph_tpu_torch.tools.rados as PRADOS
from ceph_tpu.crush.map import build_hierarchy as r_build_hierarchy
from ceph_tpu.osd import osdmap as RO
from ceph_tpu_torch.crush.map import build_hierarchy as p_build_hierarchy
from ceph_tpu_torch.osd import osdmap as PO

PKG = {
    "ceph_tpu": dict(mon=RMON, msg=RMSG, mm=RMM, lib=RLIB, ceph=RCEPH,
                     rados=RRADOS, mmt=RMMT),
    "port": dict(mon=PMON, msg=PMSG, mm=PMM, lib=PLIB, ceph=PCEPH,
                 rados=PRADOS, mmt=PMMT),
}


def wait_for(pred, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def free_ports(n):
    import socket
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


# -- striper ------------------------------------------------------------------

def test_file_to_extents_matches_for_seeded_layouts():
    rng = np.random.default_rng(41)
    for _ in range(300):
        su = 1 << int(rng.integers(9, 16))
        sc = int(rng.integers(1, 6))
        osz = su * int(rng.integers(1, 5))
        off = int(rng.integers(0, 1 << 20))
        ln = int(rng.integers(0, 1 << 19))
        ref = RSTR.file_to_extents(RSTR.FileLayout(su, sc, osz), off, ln)
        port = PSTR.file_to_extents(PSTR.FileLayout(su, sc, osz), off, ln)
        assert [vars(e) for e in port] == [vars(e) for e in ref]
        assert sum(e.length for e in ref) == ln
    for mod in (RSTR, PSTR):
        with pytest.raises(ValueError, match="multiple of stripe_unit"):
            mod.file_to_extents(mod.FileLayout(4096, 1, 6000), 0, 1)


class MemIoCtx:
    """An I/O context over a dict: the calls ``RadosStriper`` makes, with
    the errors of the package it stands in for."""

    def __init__(self, lib):
        self.lib = lib
        self.objs: dict[str, bytearray] = {}
        self.xattrs: dict[str, dict[str, bytes]] = {}

    def _get(self, oid):
        if oid not in self.objs:
            raise self.lib.ObjectNotFound(-2, oid)
        return self.objs[oid]

    def getxattrs(self, oid):
        self._get(oid)
        return dict(self.xattrs.get(oid, {}))

    def getxattr(self, oid, name):
        return self.getxattrs(oid)[name]

    def setxattr(self, oid, name, value):
        self.objs.setdefault(oid, bytearray())
        self.xattrs.setdefault(oid, {})[name] = bytes(value)

    def write_full(self, oid, data):
        self.objs[oid] = bytearray(data)

    def truncate(self, oid, size):
        buf = self._get(oid)
        del buf[size:]
        buf.extend(b"\0" * (size - len(buf)))

    def remove(self, oid):
        self._get(oid)
        del self.objs[oid]
        self.xattrs.pop(oid, None)

    def _done(self, rc=0, results=None):
        c = self.lib.Completion()
        c._complete(rc, "", results, (0, 0))
        return c

    def _aio(self, oid, ops):
        for op in ops:
            if op["op"] == "write":
                buf = self.objs.setdefault(oid, bytearray())
                data = bytes.fromhex(op["data"])
                off = op["off"]
                if len(buf) < off:
                    buf.extend(b"\0" * (off - len(buf)))
                buf[off:off + len(data)] = data
            else:
                raise AssertionError(op)
        return self._done()

    def aio_read(self, oid, length=None, offset=0):
        if oid not in self.objs:
            return self._done(-2)
        data = bytes(self.objs[oid][offset:offset + length])
        return self._done(0, [{"data": data.hex()}])


def _stripe(mod, lib):
    io_ = MemIoCtx(lib)
    rs = mod.RadosStriper(io_, mod.FileLayout(4096, 3, 8192))
    rng = np.random.default_rng(7)
    blob = rng.integers(0, 256, 70000, dtype=np.uint8).tobytes()
    out = []
    rs.write("s", blob)
    out.append(rs.stat("s"))
    rs.write("s", b"x" * 5000, offset=10000)
    rs.append("s", b"tail")
    out.append(rs.read("s"))
    out.append(rs.read("s", 3000, 6000))
    rs.truncate("s", 20000)
    out.append(rs.read("s"))
    rs.truncate("s", 30000)
    out.append(rs.read("s", 12000, 18000))
    rs.setxattr("s", "color", b"blue")
    out.append(rs.getxattr("s", "color"))
    rs.write_full("s", b"short")
    out.append((rs.read("s"), rs.stat("s")))
    out.append(sorted((k, bytes(v)) for k, v in io_.objs.items()))
    out.append(sorted((k, sorted(v.items())) for k, v in io_.xattrs.items()))
    rs.remove("s")
    out.append(sorted(io_.objs))
    with pytest.raises(lib.ObjectNotFound):
        rs.read("s")
    return out


def test_rados_striper_over_the_same_objects():
    ref = _stripe(RRS, RLIB)
    port = _stripe(PRS, PLIB)
    assert port == ref
    assert ref[-1] == []


# -- _calc_target -------------------------------------------------------------

def _target_map(mod, build):
    """64 hosts x 64 OSDs, one replicated pool of 128 PGs, upmaps."""
    m = mod.OSDMap(crush=build(1, 64, 64), max_osd=4096)
    m.epoch = 5
    for o in range(4096):
        m.osd_state[o] = mod.EXISTS | mod.UP
    for o in range(0, 4096, 97):
        m.mark_out(o)
    pool = m.create_pool("rbd", pg_num=128, size=3, crush_rule=0)
    rng = np.random.default_rng(3)
    for seed in rng.choice(128, 24, replace=False):
        pg = mod.PGid(pool.id, int(seed))
        m.pg_upmap_items[pg] = [(int(rng.integers(4096)),
                                 int(rng.integers(4096)))]
    m.pg_upmap[mod.PGid(pool.id, 5)] = [1, 2, 3]
    return m, pool.id


def _targets(objecter_mod, osdmap_mod, build, monkeypatch, names):
    m, pid = _target_map(osdmap_mod, build)
    # the CRUSH step of one PG is the scalar do_rule (~30 ms at 4096
    # OSDs): each package's map computes a PG's raw set once here, which
    # changes no result, since the map does not change in this test
    memo = {}
    raw = m.pg_to_raw_osds

    def once(pg):
        key = (pg.pool, pg.seed)
        if key not in memo:
            memo[key] = raw(pg)
        return memo[key]

    monkeypatch.setattr(m, "pg_to_raw_osds", once)
    o = objecter_mod.Objecter.__new__(objecter_mod.Objecter)
    o.osdmap = m
    return [(str(pg), primary)
            for pg, primary in (o._calc_target(pid, n) for n in names)]


def test_calc_target_matches_for_10k_names(monkeypatch):
    rng = np.random.default_rng(99)
    names = [f"obj-{int(a):x}-{int(b)}" for a, b in
             zip(rng.integers(0, 1 << 40, 10000),
                 rng.integers(0, 1000, 10000))]
    ref = _targets(ROBJ, RO, r_build_hierarchy, monkeypatch, names)
    port = _targets(POBJ, PO, p_build_hierarchy, monkeypatch, names)
    assert port == ref
    assert len({pg for pg, _ in ref}) == 128
    assert ("0.5", 1) in set(ref)        # the full pg_upmap


# -- monmaptool ---------------------------------------------------------------

def _cli(mod, argv):
    """Run a CLI's ``main`` with its ``print`` captured: → (rc or the
    exception, stdout, stderr).  Capturing through the module's own
    ``print`` keeps two packages' CLIs apart in concurrent threads."""
    out, err = io.StringIO(), io.StringIO()

    def cap(*a, file=None, flush=False, **kw):
        print(*a, file=err if file is sys.stderr else out, **kw)

    mod.print = cap
    try:
        try:
            rc = mod.main(list(map(str, argv)))
        except (SystemExit, TimeoutError) as e:
            rc = f"{type(e).__name__}: {e}"
    finally:
        del mod.print
    return rc, out.getvalue(), err.getvalue()


def test_monmaptool_files_cross_packages(tmp_path, monkeypatch):
    res = {}
    for name in ("ceph_tpu", "port"):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        mmt = PKG[name]["mmt"]
        res[name] = [
            _cli(mmt, ["--create", "--add", 0, "127.0.0.1:6789",
                       "--add", 1, "127.0.0.1:6790", "m"]),
            _cli(mmt, ["--create", "m"]),
            _cli(mmt, ["--add", 2, "10.0.0.3:6789", "--rm", 1, "--print",
                       "m"]),
            _cli(mmt, ["--add", 2, "10.0.0.3:1", "m"]),
            _cli(mmt, ["--rm", 9, "m"]),
            _cli(mmt, ["--print", "missing"]),
            _cli(mmt, ["--add", 5, "nohost", "m"]),
            Path("m").read_bytes()]
    assert res["port"] == res["ceph_tpu"]
    # each package reads the other's file and prints it alike
    for a, b in (("ceph_tpu", "port"), ("port", "ceph_tpu")):
        f = str(tmp_path / a / "m")
        assert _cli(PKG[b]["mmt"], ["--print", f]) == _cli(
            PKG[a]["mmt"], ["--print", f])
        m = PKG[b]["mmt"].load_monmap(f)
        assert sorted(m.mons) == [0, 2] and m.epoch == 2


# -- the two quorums ----------------------------------------------------------

class Quorum:
    def __init__(self, pkg):
        self.pkg = pkg
        P = PKG[pkg]
        self.ports = free_ports(3)
        self.addrs = ",".join(f"127.0.0.1:{p}" for p in self.ports)
        self.monmap = P["mon"].MonMap(mons={
            r: P["msg"].EntityAddr("127.0.0.1", p)
            for r, p in enumerate(self.ports)})
        self.mons = [P["mon"].Monitor(r, self.monmap) for r in range(3)]
        self.clients = []
        try:
            for m in self.mons:
                m.start()
            assert wait_for(lambda: any(
                m.is_leader and m.paxos.is_writeable()
                for m in self.mons) and all(
                sorted(m.quorum) == [0, 1, 2] for m in self.mons),
                timeout=15)
        except BaseException:
            self.stop()
            raise

    def client(self, entity="client.admin"):
        mc = PKG[self.pkg]["mon"].MonClient(self.monmap, entity=entity)
        self.clients.append(mc)
        return mc

    def boot(self, osd):
        """One OSD's boot message, as an OSD daemon sends it: the map
        grows to ``osd + 1`` devices."""
        mc = self.client(f"osd.{osd}")
        mc.send(PKG[self.pkg]["mm"].MOSDBoot(osd=osd,
                                             addr="127.0.0.1:7000"))
        leader = next(m for m in self.mons if m.is_leader)
        assert wait_for(lambda: leader.services["osdmap"].osdmap.max_osd
                        > osd, timeout=10)

    def settled(self):
        return wait_for(lambda: len({m.paxos.last_committed
                                     for m in self.mons}) == 1, timeout=10)

    def stop(self):
        for c in self.clients:
            c.shutdown()
        for m in self.mons:
            m.shutdown()


@pytest.fixture(scope="module")
def quorums():
    qs = {}
    try:
        for pkg in ("ceph_tpu", "port"):
            qs[pkg] = Quorum(pkg)
        yield qs
    finally:
        for q in qs.values():
            q.stop()


def normalise(q, reply):
    """A CLI reply with what differs by design taken out: the mons'
    ports (each quorum binds its own), time stamps, the fsid, and the
    cluster-log entries that the health tick writes on the mon's own
    clock ("Health check ...": whether one lands before a ``log last``
    is a race of timers, not of the packages)."""
    rc, out, err = reply
    for r, p in enumerate(q.ports):
        out, err = (s.replace(str(p), f"<mon{r}>") for s in (out, err))
        if isinstance(rc, str):
            rc = rc.replace(str(p), f"<mon{r}>")

    def scrub(v):
        if isinstance(v, list):
            v = [x for x in v if not (isinstance(x, dict) and str(
                x.get("text", "")).startswith("Health check"))]
        if isinstance(v, dict):
            return {k: ("<stamp>" if k in ("stamp", "timestamp", "since",
                                           "last_change_stamp")
                        else "<fsid>" if k == "fsid" else scrub(x))
                    for k, x in v.items()}
        if isinstance(v, list):
            return [scrub(x) for x in v]
        return v

    try:
        out = json.dumps(scrub(json.loads(out)), sort_keys=True)
    except ValueError:
        pass
    return rc, out, err


CEPH_SCRIPT = [
    ["status"],
    ["-s"],
    ["health"],
    ["health", "detail"],
    ["osd", "tree"],
    ["osd", "pool", "create", "data", "--pg-num", 16, "--size", 2],
    ["osd", "pool", "create", "data", "--pg-num", 16],
    ["osd", "pool", "create", "ecp", "--pg-num", 8, "--type", "erasure"],
    ["osd", "pool", "ls"],
    ["osd", "pool", "set", "data", "size", 3],
    ["osd", "pool", "set", "data", "nosuchvar", 1],
    ["osd", "pool", "get", "data"],
    ["osd", "pool", "get", "data", "size"],
    ["osd", "pool", "get", "nopool"],
    ["osd", "pg-upmap-items", "0.3", 0, 5],       # refused: no OSD yet
    "boot",
    ["osd", "tree"],
    ["osd", "stat"],
    ["osd", "out", 7],
    ["osd", "in", 7],
    ["osd", "out", 99],
    ["osd", "reweight", 7, 0.5],
    ["osd", "pg-upmap-items", "0.3", 0, 5, 2, 6],
    ["osd", "pg-upmap-items", "0.4", 0, 99],
    ["osd", "pg-upmap-items", "9.0", 0, 1],
    ["osd", "pg-upmap-items", "1.2", 3, 4],
    ["osd", "rm-pg-upmap-items", "1.2"],     # no CLI verb: free-form
    ["osd", "dump"],
    ["log", "hello", "from", "the", "script"],
    ["log", "last", 3],
    ["log", "last", 5, "audit"],
    ["pg", "stat"],
    ["df"],
    ["no", "such", "command"],
    ["osd", "dump", "--format", "json"],
]


def _run_ceph(q):
    out = []
    for argv in CEPH_SCRIPT:
        if argv == "boot":
            q.boot(7)
            continue
        out.append(normalise(q, _cli(PKG[q.pkg]["ceph"],
                                     ["-m", q.addrs, *argv])))
        assert q.settled()
    return out


def test_ceph_script_replies_match(quorums):
    ref = _run_ceph(quorums["ceph_tpu"])
    port = _run_ceph(quorums["port"])
    for argv, a, b in zip([c for c in CEPH_SCRIPT if c != "boot"],
                          port, ref):
        assert a == b, argv
    rcs = [r[0] for r in ref]
    assert rcs.count(0) > 20 and 1 in rcs
    # the mon refused the first upmap (no OSD existed), took the second
    assert ref[14][0] == 1 and "osd.5 does not exist" in ref[14][2]
    assert ref[21] == (0, "", "set 0.3 pg_upmap_items\n")


def test_mgr_bound_command_without_a_mgr(quorums):
    """``progress`` goes to the mgr; with none, both CLIs give up after
    the client's 10 s budget with the same error (run side by side)."""
    got = {}

    def run(pkg):
        q = quorums[pkg]
        got[pkg] = normalise(q, _cli(PKG[pkg]["ceph"],
                                     ["-m", q.addrs, "progress"]))

    threads = [threading.Thread(target=run, args=(p,)) for p in PKG]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert got["port"] == got["ceph_tpu"]
    assert "no active mgr" in got["port"][0]


def _rados_script(q):
    rados = PKG[q.pkg]["rados"]
    out = []
    for argv in (["lspools"], ["mkpool", "rp", "--pg-num", 8],
                 ["mkpool", "rp"], ["lspools"], ["rmpool", "rp"],
                 ["rmpool", "rp"], ["lspools"]):
        try:
            out.append(normalise(q, _cli(rados, ["-m", q.addrs, *argv])))
        except PKG[q.pkg]["lib"].Error as e:
            out.append(("Error", e.rc, str(e)))
        assert q.settled()
    return out


def test_rados_pool_verbs_match(quorums):
    ref = _rados_script(quorums["ceph_tpu"])
    port = _rados_script(quorums["port"])
    assert port == ref
    assert "rp" in ref[3][1] and "rp" not in ref[6][1]


def _librados(q):
    lib = PKG[q.pkg]["lib"]
    r = lib.Rados(q.monmap).connect()
    try:
        o = r.objecter
        epoch = q.mons[0].services["osdmap"].osdmap.epoch
        assert wait_for(lambda: o.osdmap.epoch >= epoch, timeout=10)
        res = [r.list_pools(), r.pool_lookup("data"),
               sorted((str(k), [list(p) for p in v])
                      for k, v in o.osdmap.pg_upmap_items.items()),
               [o._calc_target(r.pool_lookup("data"), f"o{i}")[0].seed
                for i in range(16)],
               o.osdmap.max_osd]
        with pytest.raises(lib.ObjectNotFound):
            r.pool_lookup("nopool", timeout=0.2)
        r.create_pool("lp", pg_num=4, size=2)
        assert wait_for(lambda: "lp" in o.osdmap.pool_name, timeout=10)
        res.append(r.list_pools())
        r.delete_pool("lp")
        with pytest.raises(lib.Error) as e:
            r.delete_pool("lp")
        res.append((e.value.rc, str(e.value)))
        return res
    finally:
        r.shutdown()


def test_librados_pool_ops_and_map_match(quorums):
    ref = _librados(quorums["ceph_tpu"])
    port = _librados(quorums["port"])
    assert port == ref
    assert ref[2] == [("0.3", [[0, 5], [2, 6]]), ("1.2", [[3, 4]])]
