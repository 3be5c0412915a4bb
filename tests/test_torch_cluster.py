"""The port's live cluster against ceph_tpu's, on the CPU.

One ``MiniCluster`` of each package, side by side: one mon, six OSDs on
WALStores, an EC pool (k=4 m=2 ``jerasure reed_sol_van``, pg_num 4,
rule 1) and a replicated size-3 pool of pg_num 8; the port's on
``device="cpu"`` (the kernels' plain versions).  The same seeded script
goes to both through librados, and the tests compare:

- the librados replies (``read``, ranged ``read``, ``stat``, ``write``
  read-modify-write, ``append``, ``truncate``, ``remove``,
  ``list_objects``) and the daemons' ``dump_batch_engine`` keys;
- every OSD's store: collections, object names, data bytes, and the
  ``"_"`` meta's ``size`` and ``hinfo``;
- after a kill (marked down with ``ceph osd down``), degraded writes
  and reads, the revive and ``wait_for_clean``, the revived OSD's
  shards;
- the deep-scrub report for one flipped parity byte (``scrub_pg``, the
  primary's ``inconsistent_objects`` and the mon's ``pg
  list-inconsistent-obj``), before and after the repair.

Tolerance: exact bytes, digests and replies.  Every wait polls with a
deadline of at least 10 s; no assertion is on elapsed time.  The tests
of the class run in file order on one pair of clusters.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from ceph_tpu.os_store.objectstore import Transaction as RTransaction
from ceph_tpu.osd import messages as RM
from ceph_tpu.osdc.librados import Error as RError
from ceph_tpu.vstart import MiniCluster as RMiniCluster
from ceph_tpu_torch.core.admin_socket import admin_command
from ceph_tpu_torch.ec import create_erasure_code
from ceph_tpu_torch.os_store.objectstore import Transaction as PTransaction
from ceph_tpu_torch.osd import messages as PM
from ceph_tpu_torch.osd.pg import META_OID, SNAPMAP_OID
from ceph_tpu_torch.osdc.librados import Error as PError
from ceph_tpu_torch.scrub.crc32c import crc32c
from ceph_tpu_torch.vstart import MiniCluster as PMiniCluster

torch.set_num_threads(1)

K, M = 4, 2
N_OSDS = 6
KILL = 2
PROFILE = ["k=4", "m=2", "plugin=jerasure", "technique=reed_sol_van"]
SIZES = [1, 100, 4096, 16384 + 17, 40000, 5000, 12345, 777]
NAMES = [f"obj{i}" for i in range(len(SIZES))]
# upstream's heartbeat grace: the suite's other workers load this CPU,
# and MiniCluster's 3 s lets starved daemons mark each other down
OSD_CONFIG = {"osd_heartbeat_grace": 20.0}
PKGS = {"ceph_tpu": (RMiniCluster, {}, RTransaction, RError),
        "port": (PMiniCluster, {"device": "cpu"}, PTransaction, PError)}


def wait_for(pred, timeout=30.0, interval=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def payloads(seed):
    rng = np.random.default_rng(seed)
    return {n: rng.integers(0, 256, size=s, dtype=np.uint8).tobytes()
            for n, s in zip(NAMES, SIZES)}


def pin_pgls(objecter):
    """Give a ceph_tpu client the port's pinned pgls.

    ceph_tpu's Objecter sends every resend of an op to the PG its name
    hashes to; a pgls (``IoCtx._pgls``) names no object, so a resent
    pgls asks the PG of the empty name, and its reply, rc 0, stands as
    the listing of the PG that was asked.  The resend loop resends a
    pgls at its first tick (``_pgls`` never starts the op's schedule),
    so any pgls slower than that tick can come back as another PG's
    listing (ROADMAP.md §3; ``test_resent_pgls_stays_on_its_pg`` shows
    it on ceph_tpu's client as it is).  The port pins the op to its PG.
    The cross-package tests that list a pool hold the port against
    ceph_tpu's client with this one fault mended: every resend of a
    pgls goes to the PG the listing asked, as in the port."""
    send = objecter._send_op
    pins = {}

    def pinned_send(op):
        if not any(o.get("op") == "pgls" for o in op.ops):
            return send(op)
        # the first send is _pgls's own, to op.pgid; this is a resend
        pin = pins.setdefault(op.tid, op.pgid)
        target = (pin, objecter.osdmap.pg_to_up_acting_osds(pin)[3])
        # every caller of _send_op holds objecter.lock, and so does
        # every caller of _calc_target
        objecter._calc_target = lambda _pool, _oid: target
        try:
            return send(op)
        finally:
            del objecter._calc_target

    objecter._send_op = pinned_send


@pytest.fixture(scope="class")
def pair():
    """{pkg: (cluster, rados, {pool: ioctx})}, both started."""
    out = {}
    try:
        for pkg, (mc, kw, _t, _e) in PKGS.items():
            c = mc(n_mons=1, n_osds=N_OSDS, osd_config=OSD_CONFIG, **kw)
            out[pkg] = (c, None, None)
            c.start()
            r = c.rados()
            if pkg == "ceph_tpu":
                pin_pgls(r.objecter)
            rc, outs, _ = r.mon_command({
                "prefix": "osd erasure-code-profile set", "name": "k4m2",
                "profile": PROFILE})
            assert rc == 0, outs
            r.create_pool("ecp", pg_num=4, pool_type="erasure",
                          erasure_code_profile="k4m2", rule=1)
            r.create_pool("rep", pg_num=8, size=3)
            ios = {p: r.open_ioctx(p) for p in ("ecp", "rep")}
            c.wait_for_clean(timeout=120)
            out[pkg] = (c, r, ios)
        yield out
    finally:
        for c, _r, _ios in out.values():
            c.stop()


def reply(fn):
    """A librados call's reply, or its error as (class name, rc, text).
    A ``stat``'s version keeps its per-PG counter: its epoch is the map
    epoch of the write, which follows the boot's timing in each
    cluster."""
    try:
        out = fn()
    except (PError, RError) as e:
        return (type(e).__name__, e.rc, str(e))
    if isinstance(out, dict):
        out = {k: v for k, v in out.items() if k != "mtime"}
        if "version" in out:
            out["version"] = out["version"][1]
    return out


def settled(c, r):
    """Every PG clean on its primary, and the client and every OSD on
    one map epoch: the state the script's listing describes."""
    epoch = r.objecter.osdmap.epoch
    for osd in c.osds.values():
        with osd.lock:
            if osd.osdmap.epoch != epoch or any(
                    pg.state != "active+clean"
                    for pg in osd.pgs.values() if pg.is_primary):
                return False
    return True


def script(c, r, ios, data):
    """The librados script: writes, reads, RMW, append, truncate,
    remove and listings on both pools; → the replies in order."""
    out = []
    for pool in ("ecp", "rep"):
        io = ios[pool]
        for n in NAMES:
            io.write_full(n, data[n])
        for n in NAMES:
            out.append(reply(lambda: io.read(n)))
            out.append(reply(lambda: io.read(n, 50, 100)))
            out.append(reply(lambda: io.stat(n)))
        io.write(NAMES[3], b"zz" * 9, 10)                  # RMW
        io.append(NAMES[4], b"tail" * 100)
        io.truncate(NAMES[5], 500)
        io.remove(NAMES[6])
        for n in NAMES[3:7]:
            out.append(reply(lambda: io.read(n)))
            out.append(reply(lambda: io.stat(n)))
        assert wait_for(lambda: settled(c, r), timeout=30)
        out.append(reply(io.list_objects))
        # restore what the next tests expect
        for n in NAMES[3:7]:
            io.write_full(n, data[n])
    return out


def store_view(osd, names=None):
    """{(cid, oid): (data, size, hinfo)} of one OSD's store; names of
    the PG meta objects with their data left out."""
    st = osd.store
    view = {}
    with osd.lock:
        for cid in st.list_collections():
            for oid in st.list_objects(cid):
                if names is not None and oid not in names:
                    continue
                if oid in (META_OID, SNAPMAP_OID):
                    view[cid, oid] = None
                    continue
                try:
                    meta = json.loads(bytes(st.getattr(cid, oid, "_")))
                except KeyError:
                    meta = {}
                view[cid, oid] = (bytes(st.read(cid, oid)),
                                  meta.get("size"), meta.get("hinfo"))
    return view


def stores(c, names=None):
    return {i: store_view(osd, names) for i, osd in sorted(c.osds.items())}


def ec_shards(data):
    """The k+m shards of every object, encoded on the CPU."""
    ec = create_erasure_code({"plugin": "jerasure",
                              "technique": "reed_sol_van", "k": K,
                              "m": M}, device="cpu")
    out = {}
    for n, d in data.items():
        enc = ec.encode(set(range(K + M)), d)
        out[n] = [bytes(np.asarray(enc[i])) for i in range(K + M)]
    return out


def placement(c, pool, name):
    m = next(iter(c.osds.values())).osdmap
    pid = m.pool_name[pool]
    pgid = m.raw_pg_to_pg(m.object_locator_to_pg(name, pid))
    return pgid, m.pg_to_up_acting_osds(pgid)[2]


class TestClusterAgainstCephTpu:
    def test_librados_replies_match(self, pair):
        data = payloads(1)
        got = {pkg: script(c, r, ios, data)
               for pkg, (c, r, ios) in pair.items()}
        assert got["port"] == got["ceph_tpu"]
        # the script's own answers, so equal-but-wrong cannot pass
        assert got["port"][0] == data[NAMES[0]]
        assert got["port"][1] == data[NAMES[0]][50:150]
        assert got["port"][2]["size"] == SIZES[0]
        assert got["port"][len(NAMES) * 3 + 6][:2] == ("ObjectNotFound", -2)
        dumps = {pkg: admin_command(c.osds[0].admin_socket.path,
                                    "dump_batch_engine")
                 if pkg == "port" else c.osds[0].batch_engine.dump()
                 for pkg, (c, _r, _i) in pair.items()}
        assert sorted(dumps["port"]) == sorted(dumps["ceph_tpu"])
        for k in ("flush_ms", "max_bytes", "max_ops", "recon_flush_ms",
                  "comp_segment_bytes", "bucket_floor", "recon_use_mesh"):
            assert dumps["port"][k] == dumps["ceph_tpu"][k], k

    def test_resent_pgls_stays_on_its_pg(self, pair):
        """A pool listing while one OSD cannot answer: the resent pgls
        of each PG that OSD leads goes to that PG again in the port, so
        the listing waits for it and is whole; ceph_tpu's client
        resends it to the PG of the empty name, whose reply stands as
        the PG's listing, and loses the held OSD's objects."""
        data = payloads(1)
        for pkg, (c, _r, _i) in pair.items():
            r = c.rados()               # a client as its package has it
            io = r.open_ioctx("rep")
            for n in NAMES:
                io.write_full(n, data[n])
            m = r.objecter.osdmap
            pid = m.pool_name["rep"]
            pg = {n: m.raw_pg_to_pg(m.object_locator_to_pg(n, pid))
                  for n in NAMES + [""]}
            pgid = type(pg[""])
            primary = {ps: m.pg_to_up_acting_osds(pgid(pid, ps))[3]
                       for ps in range(m.pools[pid].pg_num)}
            first = {}
            for ps, o in primary.items():
                first.setdefault(o, ps)
            # an OSD that leads neither the empty name's PG nor an
            # empty PG first in the listing's order
            held = next(o for o, ps in sorted(first.items(),
                                              key=lambda kv: kv[1])
                        if o != primary[pg[""].seed] and ps != pg[""].seed
                        and any(pg[n].seed == ps for n in NAMES))
            out = []
            lister = threading.Thread(
                target=lambda: out.append(io.list_objects()))
            with c.osds[held].lock:
                lister.start()
                # ceph_tpu's listing ends without the held OSD; the
                # port's waits for it
                lister.join(timeout=5.0)
            lister.join(timeout=30.0)
            assert out, pkg
            lost = sorted(n for n in NAMES
                          if primary[pg[n].seed] == held)
            assert lost, pkg
            if pkg == "port":
                assert out[0] == sorted(NAMES)
            else:
                assert out[0] == sorted(set(NAMES) - set(lost))
            r.shutdown()

    def test_stores_match(self, pair):
        views = {pkg: stores(c) for pkg, (c, _r, _i) in pair.items()}
        assert views["port"] == views["ceph_tpu"]
        # every EC shard and hinfo is the CPU re-encode's
        c = pair["port"][0]
        want = ec_shards(payloads(1))
        for n in NAMES:
            pgid, acting = placement(c, "ecp", n)
            for s, osd in enumerate(acting):
                data, size, hinfo = views["port"][osd][f"{pgid}s{s}", n]
                assert data == want[n][s] and size == len(payloads(1)[n])
                assert hinfo == crc32c(data)

    def test_live_mesh_setting_refused(self, pair):
        osd = pair["port"][0].osds[0]
        with pytest.raises(NotImplementedError, match="multi-device"):
            osd.config.set("osd_recovery_batch_mesh", True)
        osd.config.set("osd_recovery_batch_mesh", False)

    @pytest.mark.parametrize("helper", [
        "pg_primary", "osd_replay_stats", "blackbox_path", "profiler_dump",
        "dedup_leak_check", "netsplit_heals", "collect_trace", "watch"])
    def test_cluster_helpers_match(self, pair, helper):
        """MiniCluster's helpers give the same answers on both packages
        (the profiler's dump and the event feed by their keys)."""
        def run(c):
            if helper == "pg_primary":
                return [c.pg_primary(f"{pool}.{ps}")
                        for pool, n in ((0, 4), (1, 8)) for ps in range(n)]
            if helper == "osd_replay_stats":
                return sorted(c.osd_replay_stats(0))
            if helper == "blackbox_path":
                return c.blackbox_path(1).rsplit("/", 1)[-1]
            if helper == "profiler_dump":
                return sorted(c.profiler_dump(0))
            if helper == "dedup_leak_check":
                return c.dedup_leak_check()
            if helper == "netsplit_heals":
                c.partition_osds(0, 1)
                c.isolate_osd(3)
                c.heal_netsplit()
                return [sorted(o.msgr.faults.describe()["rules"])
                        for o in c.osds.values()]
            if helper == "collect_trace":
                return (c.collect_trace("no-such-trace"),
                        c.export_chrome_trace("no-such-trace"))
            with c.watch() as w:
                ev = w.next(timeout=10)
            return ev["kind"], sorted(ev["data"])

        got = {pkg: run(c) for pkg, (c, _r, _i) in pair.items()}
        assert got["port"] == got["ceph_tpu"]

    def test_degraded_and_recovery_match(self, pair):
        data = payloads(1)
        fresh = payloads(2)
        rewritten = NAMES[:3]
        for pkg, (c, r, ios) in pair.items():
            c.kill_osd(KILL)
            # the operator's `ceph osd down`, not the 20 s grace
            rc, outs, _ = r.mon_command({"prefix": "osd down",
                                         "ids": [KILL]})
            assert rc == 0, outs
            c.wait_for_osd_down(KILL, timeout=30)
            for n in rewritten:
                for pool in ("ecp", "rep"):
                    ios[pool].write_full(n, fresh[n])
            data_now = {**data, **{n: fresh[n] for n in rewritten}}
            for pool in ("ecp", "rep"):
                for n in NAMES:
                    assert ios[pool].read(n) == data_now[n], (pkg, pool, n)
            c.revive_osd(KILL)
            c.wait_for_clean(timeout=120)
        want = ec_shards({n: fresh[n] for n in rewritten})

        def rebuilt(c):
            if not all(o.osdmap.is_up(KILL) for o in c.osds.values()):
                return False
            view = store_view(c.osds[KILL], set(rewritten))
            for n in rewritten:
                pgid, acting = placement(c, "ecp", n)
                s = acting.index(KILL)
                if view.get((f"{pgid}s{s}", n), (None,))[0] != want[n][s]:
                    return False
                pgid, acting = placement(c, "rep", n)
                if KILL in acting and \
                        view.get((str(pgid), n), (None,))[0] != fresh[n]:
                    return False
            return True

        for pkg, (c, _r, _i) in pair.items():
            assert wait_for(lambda: rebuilt(c), timeout=120), pkg
            c.wait_for_clean(timeout=120)
        revived = {pkg: store_view(c.osds[KILL])
                   for pkg, (c, _r, _i) in pair.items()}
        assert revived["port"] == revived["ceph_tpu"]
        views = {pkg: stores(c) for pkg, (c, _r, _i) in pair.items()}
        assert views["port"] == views["ceph_tpu"]

    def test_scrub_report_matches(self, pair):
        name = NAMES[3]
        reports = {}
        for pkg, (c, r, _ios) in pair.items():
            txn = PKGS[pkg][2]
            pgid, acting = placement(c, "ecp", name)
            bad, cid = acting[K], f"{pgid}s{K}"
            osd = c.osds[bad]
            with osd.lock:
                good = bytes(osd.store.read(cid, name))
                meta = json.loads(bytes(osd.store.getattr(cid, name, "_")))
            broken = bytearray(good)
            broken[len(broken) // 2] ^= 0x40
            meta["hinfo"] = crc32c(bytes(broken))
            with osd.lock:
                osd.store.queue_transaction(
                    txn().write(cid, name, 0, bytes(broken)).setattrs(
                        cid, name, {"_": json.dumps(meta).encode()}))
            assert c.scrub_pg(pgid, timeout=60, deep=False) == 0, pkg
            found = c.scrub_pg(pgid, timeout=60)
            primary = c.osds[c.pg_primary(pgid)]
            with primary.lock:
                entries = list(primary.pgs[pgid].inconsistent_objects)

            def mon_report():
                rc, _outs, out = r.mon_command({
                    "prefix": "pg list-inconsistent-obj",
                    "pgid": str(pgid)})
                return out["inconsistents"] if rc == 0 and out else None

            assert wait_for(lambda: mon_report(), timeout=60), pkg
            before = mon_report()

            def repaired():
                with osd.lock:
                    return bytes(osd.store.read(cid, name)) == good

            assert wait_for(repaired, timeout=60), pkg
            again = c.scrub_pg(pgid, timeout=60)
            assert wait_for(lambda: mon_report() == [], timeout=60), pkg
            with osd.lock:
                meta_after = json.loads(bytes(
                    osd.store.getattr(cid, name, "_")))
            reports[pkg] = (found, entries, before, again, mon_report(),
                            meta_after["hinfo"] == crc32c(good))
        assert reports["port"] == reports["ceph_tpu"]
        found, entries, before, again, after, hinfo_ok = reports["port"]
        pgid, acting = placement(pair["port"][0], "ecp", name)
        assert found >= 1 and again == 0 and after == [] and hinfo_ok
        assert [e["object"]["name"] for e in entries] == [name]
        assert [(s["osd"], s["shard"]) for e in entries
                for s in e["shards"]] == [(acting[K], K)]
        assert before == entries

    def test_repeated_recovery_kick_pushes_once(self, pair):
        """Two recovery kicks while one shard push is on its way: the
        port starts one reconstruct read and push (its record of EC
        pushes in flight), ceph_tpu starts one a kick; both end with
        the peer's shard as it was and nothing missing."""
        name = NAMES[1]
        reads, shards = {}, {}
        for pkg, (c, _r, _i) in pair.items():
            pgid, acting = placement(c, "ecp", name)
            primary = c.osds[c.pg_primary(pgid)]
            peer = next(o for o in acting if o != primary.whoami)
            cid = f"{pgid}s{acting.index(peer)}"
            with c.osds[peer].lock:
                shards[pkg] = bytes(c.osds[peer].store.read(cid, name))
            with primary.lock:
                pg = primary.pgs[pgid]
                backend = pg.backend
                started = []
                read = backend._start_data_read

                def counted(*a, **k):
                    started.append(a[0].oid)
                    return read(*a, **k)

                backend._start_data_read = counted
                ver = tuple(json.loads(bytes(primary.store.getattr(
                    pg.cid, name, "_")))["version"])
                pg.peer_missing.setdefault(peer, {})[name] = ver
                pg._kick_recovery()
                pg._kick_recovery()
                del backend._start_data_read
            reads[pkg] = len(started)

            def settled():
                with primary.lock:
                    return not pg.peer_missing.get(peer) and \
                        not getattr(backend, "_pushes", None)

            assert wait_for(settled, timeout=60), pkg
            with c.osds[peer].lock:
                assert bytes(c.osds[peer].store.read(cid, name)) == \
                    shards[pkg], pkg
        assert reads == {"port": 1, "ceph_tpu": 2}
        assert shards["port"] == shards["ceph_tpu"]

    def test_aborted_scrub_has_no_verdict(self, pair):
        """A deep scrub that its primary gives up on: the port's
        ``scrub_pg`` raises, ceph_tpu's returns the previous scrub's
        count (0) as if the PG had scrubbed clean."""
        got = {}
        for pkg, (c, _r, _i) in pair.items():
            pgid, _acting = placement(c, "ecp", NAMES[0])
            primary = c.osds[c.pg_primary(pgid)]
            with primary.lock:
                pg = primary.pgs[pgid]
                stamp = pg.last_deep_scrub

            def start_then_abort(pgid, deep=True):
                # under the daemon lock: no scrub map lands in between
                with primary.lock:
                    ok = primary.pgs[pgid].start_scrub(deep=deep)
                    if ok:
                        primary.pgs[pgid].check_scrub_timeout(grace=-1.0)
                    return ok

            primary.scrub_pg = start_then_abort
            try:
                if pkg == "port":
                    with pytest.raises(RuntimeError, match="aborted"):
                        c.scrub_pg(pgid, timeout=60)
                    got[pkg] = "raised"
                else:
                    got[pkg] = c.scrub_pg(pgid, timeout=60)
            finally:
                del primary.scrub_pg
            with primary.lock:
                assert pg.last_deep_scrub == stamp and not pg.scrubbing
            assert c.scrub_pg(pgid, timeout=60) == 0, pkg
            with primary.lock:
                assert pg.last_deep_scrub > stamp, pkg
        assert got == {"port": "raised", "ceph_tpu": 0}

    def test_read_resend_joins_the_read_in_flight(self, pair):
        """Two resends of an EC read that is still gathering its
        shards: the port joins both to the read in flight (one fan-out
        of sub-reads, one reply, on the last copy's session) and asks
        each remote shard not yet answered once more, on the first
        resend only; ceph_tpu starts a read for each copy (three
        fan-outs, three replies).  The bytes are the same.  Without the
        join, reads slower than the Objecter's 2 s resend each grow
        another fan-out on a loaded host."""
        name = NAMES[4]
        want = payloads(1)[name]

        def op_and_resend(c, mod, tid):
            pgid, _acting = placement(c, "ecp", name)
            primary = c.osds[c.pg_primary(pgid)]
            replies, asked = [], []

            class Session:
                def send_message(self, m):
                    replies.append((self, m))

            def send_to_osd(osd, m):
                if isinstance(m, mod.MOSDECSubOpRead):
                    asked.append(m.shard)
                send(osd, m)

            sessions = [Session(), Session(), Session()]
            send = primary.send_to_osd
            with primary.lock:
                primary.send_to_osd = send_to_osd
                backend = primary.pgs[pgid].backend
                before = backend._read_tid
                for n, ses in enumerate(sessions):  # the op, 2 resends
                    msg = mod.MOSDOp(
                        tid=tid, client="client.resend-test",
                        pgid=str(pgid), oid=name,
                        epoch=primary.osdmap.epoch,
                        ops=[{"op": "read", "off": 0}], flags=0)
                    msg.connection = ses
                    primary.pgs[pgid].do_op(msg)
                    if n == 0:
                        first = sorted(asked)
                fanouts = backend._read_tid - before
                del primary.send_to_osd
            assert first and wait_for(
                lambda: len(replies) >= fanouts, timeout=30)
            time.sleep(0.5)     # room for a reply that should not come
            return (fanouts, len(asked) // len(first),
                    sorted(asked) == sorted(first * (len(asked) //
                                                     len(first))),
                    sorted(sessions.index(ses) for ses, _m in replies),
                    [(m.rc, bytes.fromhex(m.results[0]["data"]))
                     for _s, m in replies])

        assert op_and_resend(pair["port"][0], PM, 424242) == \
            (1, 2, True, [2], [(0, want)])
        assert op_and_resend(pair["ceph_tpu"][0], RM, 424242) == \
            (3, 3, True, [0, 1, 2], [(0, want)] * 3)

    def test_lost_sub_read_is_asked_again_on_the_resend(self, pair):
        """One sub-read reply of a client's EC read is lost on its way
        to the primary.  The read completes inside the Objecter's 10 s
        op timeout (``S3Client``'s socket timeout too) in both
        packages: in the port the Objecter's first resend (after 2 s)
        joins the read and asks the unanswered shard again, with no
        second fan-out; in ceph_tpu the resend reads afresh."""
        name = NAMES[5]
        want = payloads(1)[name]
        got = {}
        for pkg, (c, _r, ios) in pair.items():
            pgid, _acting = placement(c, "ecp", name)
            primary = c.osds[c.pg_primary(pgid)]
            with primary.lock:
                backend = primary.pgs[pgid].backend
                tid = backend._read_tid + 1
            handle, dropped = backend.handle_sub_read_reply, []

            def drop_one(msg):
                if msg.tid == tid and not dropped:
                    dropped.append(msg.shard)
                    return
                handle(msg)

            backend.handle_sub_read_reply = drop_one
            try:
                data = ios["ecp"].read(name)
            finally:
                del backend.handle_sub_read_reply
            got[pkg] = (data == want, len(dropped),
                        backend._read_tid - tid + 1)
        assert got == {"port": (True, 1, 1), "ceph_tpu": (True, 1, 2)}
