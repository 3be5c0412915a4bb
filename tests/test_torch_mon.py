"""The port's monitor: elections, Paxos, the services, and ceph_tpu.

The Elector/Paxos unit cases and the quorum scenarios of
``tests/test_mon.py`` that need no ``MiniCluster`` run on the port
(3 port mons on ephemeral localhost ports); the down/out machinery runs
on a single port mon with fake-booted OSDs.  Across packages: a port
``MonClient`` against ceph_tpu mons and a ceph_tpu ``MonClient`` against
port mons answer one scripted command sequence alike, and each
package's ``Monitor`` mounts the other's ``MonitorDBStore`` WAL with the
same committed state.

Every wait polls with a deadline of at least 10 s, a window that must
hold (nothing may happen) is polled over its whole length, and every
mon and client is shut down in a fixture or ``finally``.
"""

import json
import socket
import time

import pytest

import ceph_tpu.mon as RMON
import ceph_tpu.msg as RMSG
import ceph_tpu_torch.mon as PMON
import ceph_tpu_torch.msg as PMSG
from ceph_tpu.tools.osdmaptool import osdmap_to_dict as ref_osdmap_to_dict
from ceph_tpu_torch.core import admin_socket
from ceph_tpu_torch.mon import messages as M
from ceph_tpu_torch.mon.monitor import OSDMonitor
from ceph_tpu_torch.mon.paxos import ACK, PROPOSE, Elector, Paxos
from ceph_tpu_torch.tools.osdmaptool import osdmap_to_dict

MonClient, MonitorDBStore = PMON.MonClient, PMON.MonitorDBStore
PKG = {"port": (PMON, PMSG), "ceph_tpu": (RMON, RMSG)}


def wait_for(pred, timeout=10.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def holds_for(pred, seconds, interval=0.02):
    """True when ``pred`` stays true at every poll for ``seconds``."""
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        if not pred():
            return False
        time.sleep(interval)
    return pred()


def free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        ports.append(s.getsockname()[1])
    for s in socks:
        s.close()
    return ports


def monmap_of(pkg, ports):
    mon_mod, msg_mod = PKG[pkg]
    return mon_mod.MonMap(mons={r: msg_mod.EntityAddr("127.0.0.1", p)
                                for r, p in enumerate(ports)})


def start_mons(pkg, ports, stores=None):
    mon_mod, _ = PKG[pkg]
    monmap = monmap_of(pkg, ports)
    mons = [mon_mod.Monitor(r, monmap,
                            store=stores[r] if stores else None)
            for r in range(len(ports))]
    try:
        for m in mons:
            m.start()
    except BaseException:
        for m in mons:
            m.shutdown()
        raise
    return monmap, mons


def make_cluster(n=3, stores=None):
    return start_mons("port", free_ports(n), stores)


def full_quorum(mons, timeout=15.0):
    """Wait until every mon is in one writeable quorum: a first
    election may settle on a majority before the last ack lands, and
    the rejoin widens it a round later."""
    ranks = sorted(m.rank for m in mons)
    return wait_for(lambda: any(
        m.is_leader and m.paxos.is_writeable() for m in mons) and all(
        sorted(m.quorum) == ranks for m in mons), timeout=timeout)


def stop(mons, *clients):
    for c in clients:
        if c is not None:
            c.shutdown()
    for m in mons:
        m.shutdown()


@pytest.fixture
def cluster():
    monmap, mons = make_cluster(3)
    try:
        yield monmap, mons
    finally:
        stop(mons)


@pytest.fixture
def client(cluster):
    monmap, mons = cluster
    assert full_quorum(mons)
    mc = MonClient(monmap)
    try:
        yield mc
    finally:
        mc.shutdown()


# -- Elector and Paxos, unit --------------------------------------------------

class TestElectorUnit:
    def test_solo_wins(self):
        e = Elector(0, [0])
        e.start()
        assert e.state == "leader" and e.quorum == [0]

    def test_three_way(self):
        es = [Elector(r, [0, 1, 2]) for r in range(3)]
        es[2].start()
        for _ in range(20):
            moved = False
            for e in es:
                for to, payload in e.outbox:
                    es[to].handle(payload)
                    moved = True
                e.outbox = []
            if not moved:
                break
        assert es[0].state == "leader"
        assert es[1].leader == 0 and es[2].leader == 0
        q = sorted(es[0].quorum)
        assert 0 in q and len(q) >= 2 and set(q) <= {0, 1, 2}

    def test_defer_withdraws_candidacy(self):
        e = Elector(1, [0, 1, 2, 3, 4])
        e.start()
        ep = e.epoch
        e.handle({"op": ACK, "epoch": ep, "from": 2})
        e.handle({"op": ACK, "epoch": ep, "from": 3})
        e.handle({"op": PROPOSE, "epoch": ep, "from": 0})
        assert not e.electing_me and e.deferred_to == 0
        e.handle({"op": ACK, "epoch": ep, "from": 4})
        e.finalize()
        assert e.state != "leader"

    def test_defer_only_to_strictly_better_candidates(self):
        e = Elector(3, [0, 1, 2, 3, 4])
        e.handle({"op": PROPOSE, "epoch": 3, "from": 1})
        assert e.deferred_to == 1
        assert len([m for _, m in e.outbox if m["op"] == ACK]) == 1
        e.outbox = []
        e.handle({"op": PROPOSE, "epoch": 3, "from": 2})
        assert e.deferred_to == 1 and not e.outbox
        e.handle({"op": PROPOSE, "epoch": 3, "from": 1})
        assert [m["op"] for _, m in e.outbox] == [ACK]
        e.outbox = []
        e.handle({"op": PROPOSE, "epoch": 3, "from": 0})
        assert e.deferred_to == 0
        assert [m["op"] for _, m in e.outbox] == [ACK]

    def test_deferred_mon_does_not_restart_same_epoch(self):
        e = Elector(1, [0, 1, 2])
        e.handle({"op": PROPOSE, "epoch": 3, "from": 0})
        assert not e.electing_me
        e.outbox = []
        e.handle({"op": PROPOSE, "epoch": 3, "from": 2})
        assert not e.electing_me
        assert not [m for _, m in e.outbox if m["op"] == PROPOSE]


class TestPaxosUnit:
    @staticmethod
    def _paxos(rank=0):
        return Paxos(MonitorDBStore(), rank)

    @staticmethod
    def _last(px, pn, frm):
        px.handle({"op": "last", "pn": pn, "from": frm,
                   "last_committed": 0, "values": {}})

    def test_stale_last_from_superseded_collect_ignored(self):
        px = self._paxos()
        px.leader_collect([0, 1, 2])
        first_pn = px._collect_pn
        self._last(px, first_pn + 100, 1)
        assert px._collect_pn > first_pn and px._last_from == {0}
        self._last(px, first_pn, 2)
        assert px._last_from == {0}
        assert px.state == "recovering"

    def test_duplicate_last_counts_once(self):
        px = self._paxos()
        px.leader_collect([0, 1, 2])
        for _ in range(2):
            self._last(px, px._collect_pn, 1)
        assert px._last_from == {0, 1}
        assert px.state == "recovering"

    def test_abort_round_blocks_late_accept_commit(self):
        px = self._paxos()
        px.leader_collect([0, 1])
        self._last(px, px._collect_pn, 1)
        assert px.is_active()
        px.propose(b"value")
        assert px.state == "updating"
        px.abort_round()
        px.handle({"op": "accept", "pn": px.accepted_pn, "v": 1,
                   "from": 1})
        assert px.last_committed == 0

    def test_abort_round_blocks_late_last_activation(self):
        px = self._paxos()
        px.leader_collect([0, 1])
        px.abort_round()
        self._last(px, px._collect_pn, 1)
        assert px.state == "recovering"

    def test_writeable_gate_states(self):
        px = self._paxos()
        assert not px.is_writeable()
        px.leader_collect([0, 1])
        assert not px.is_writeable()
        self._last(px, px._collect_pn, 1)
        assert px.is_writeable()
        px.propose(b"v")
        assert px.is_writeable()

    def test_commit_reaches_the_store_in_order(self):
        """A two-mon round driven by hand: begin → accept → commit
        lands each value at its version in the store."""
        lead, peon = self._paxos(0), self._paxos(1)
        lead.leader_collect([0, 1])
        self._last(lead, lead._collect_pn, 1)
        committed = []
        lead.on_commit = lambda v, val: committed.append((v, val))
        for i, value in enumerate((b"a", b"b"), start=1):
            lead.propose(value)
            lead.handle({"op": "accept", "pn": lead.accepted_pn, "v": i,
                         "from": 1})
        assert lead.last_committed == 2
        assert committed == [(1, b"a"), (2, b"b")]
        assert peon.last_committed == 0


# -- the port's quorum --------------------------------------------------------

class TestMutatingCommandGate:
    def test_refused_until_writeable(self, cluster):
        monmap, mons = cluster
        assert wait_for(lambda: any(m.is_leader for m in mons))
        leader = next(m for m in mons if m.is_leader)
        sent = []

        class FakeCon:
            def send_message(self, m):
                sent.append(m)

        with leader.lock:
            leader.paxos.abort_round()
            msg = M.MMonCommand(tid=7, cmd={"prefix": "osd pool create",
                                            "pool": "gated", "pg_num": 8})
            msg.connection = FakeCon()
            leader._handle_command(msg)
            leader.paxos.state = "active"
        assert sent and sent[0].rc == -11
        assert not leader.services["osdmap"].pending_ops
        assert wait_for(lambda: leader.paxos.is_writeable(), timeout=15)


class TestQuorum:
    def test_leader_elected(self, cluster):
        monmap, mons = cluster
        assert wait_for(lambda: any(m.is_leader for m in mons))
        leaders = [m for m in mons if m.is_leader]
        assert len(leaders) == 1 and leaders[0].rank == 0

    def test_initial_maps_created_everywhere(self, cluster):
        monmap, mons = cluster
        assert wait_for(lambda: all(
            m.services["osdmap"].osdmap.epoch >= 1
            and m.store.get_int("svc_osdmap", "last_epoch") >= 1
            for m in mons), timeout=15)

    def test_admin_sockets_answer_with_the_port_prefix(self, cluster):
        monmap, mons = cluster
        assert wait_for(lambda: all(m.quorum for m in mons), timeout=15)
        for m in mons:
            path = m.admin_socket.path
            assert "/ceph_tpu_torch-mon." in path
            st = admin_socket.admin_command(path, "mon_status")
            assert st["rank"] == m.rank
        assert len({m.admin_socket.path for m in mons}) == 3


class TestCommands:
    def test_pool_create_via_any_mon(self, cluster, client):
        monmap, mons = cluster
        rc, outs, _ = client.command({"prefix": "osd pool create",
                                      "pool": "data", "pg_num": 16})
        assert rc == 0, outs
        assert wait_for(lambda: all(
            "data" in m.services["osdmap"].osdmap.pool_name
            for m in mons), timeout=15)
        rc, _, out = client.command({"prefix": "osd pool ls"})
        assert rc == 0 and "data" in out

    def test_commands_answer_after_their_round_commits(self, cluster,
                                                       client):
        """A mutating command's reply comes after its Paxos round
        committed: when the reply arrives, the value is in the store of
        the mon that committed it (the leader, whichever mon that is by
        then); every mon then reaches that version."""
        monmap, mons = cluster
        for i in range(3):
            before = max(m.paxos.last_committed for m in mons)
            rc, _, _ = client.command({"prefix": "config-key put",
                                       "key": f"k{i}", "val": str(i)})
            assert rc == 0
            assert any(m.store.get_str("svc_config", f"k{i}") == str(i)
                       for m in mons)
            v = max(m.paxos.last_committed for m in mons)
            assert v > before
            assert wait_for(lambda: all(
                m.paxos.last_committed >= v
                and m.store.get_str("svc_config", f"k{i}") == str(i)
                for m in mons), timeout=15)

    def test_ec_profile_and_pool(self, client):
        rc, outs, _ = client.command({
            "prefix": "osd erasure-code-profile set", "name": "ec43",
            "profile": ["k=4", "m=3", "plugin=jerasure"]})
        assert rc == 0, outs
        rc, _, prof = client.command({
            "prefix": "osd erasure-code-profile get", "name": "ec43"})
        assert rc == 0 and prof["k"] == "4" and prof["m"] == "3"
        rc, outs, _ = client.command({
            "prefix": "osd pool create", "pool": "ecpool", "pg_num": 8,
            "pool_type": "erasure", "erasure_code_profile": "ec43"})
        assert rc == 0, outs
        rc, _, dump = client.command({"prefix": "osd dump"})
        pool = next(p for p in dump["pools"] if p["name"] == "ecpool")
        assert pool["type"] == 3 and pool["size"] == 7

    def test_config_key_and_log(self, client):
        rc, _, _ = client.command({"prefix": "config-key put",
                                   "key": "foo/bar", "val": "baz"})
        assert rc == 0
        rc, _, val = client.command({"prefix": "config-key get",
                                     "key": "foo/bar"})
        assert rc == 0 and val == "baz"
        rc, _, _ = client.command({"prefix": "log",
                                   "logtext": "hello cluster"})
        assert rc == 0
        rc, _, entries = client.command({"prefix": "log last"})
        assert rc == 0 and entries[-1]["text"] == "hello cluster"

    def test_clog_round_trip(self, cluster, client):
        from ceph_tpu_torch.core.log_client import LogClient
        monmap, mons = cluster
        clog = LogClient("osd.7", send_fn=client.send)
        clog.info("pg 1.0 scrub starts")
        clog.warn("2 slow requests")
        assert clog.last(2)[-1]["prio"] == "warn"
        assert clog.flush() == 2

        def landed():
            rc, _, entries = client.command({"prefix": "log last",
                                             "num": 10})
            return rc == 0 and "2 slow requests" in [
                e["text"] for e in entries]
        assert wait_for(landed, timeout=10)
        rc, _, entries = client.command({"prefix": "log last", "num": 10})
        ent = next(e for e in entries if e["text"] == "2 slow requests")
        assert (ent["name"], ent["prio"], ent["channel"]) == \
            ("osd.7", "warn", "cluster")
        assert ent["stamp"] > 0
        assert wait_for(lambda: all(
            any(e["text"] == "2 slow requests"
                for e in m.services["log"].last(10)) for m in mons),
            timeout=10)

    def test_status_health_and_auth(self, client):
        rc, _, out = client.command({"prefix": "status"})
        assert rc == 0 and sorted(out["quorum"]) == [0, 1, 2]
        rc, _, health = client.command({"prefix": "health detail"})
        assert rc == 0 and health["health"] == "HEALTH_OK"
        rc, _, summary = client.command({"prefix": "pg summary"})
        assert rc == 0 and summary["reported_pgs"] == 0
        rc, _, out = client.command({"prefix": "auth get-or-create",
                                     "entity": "osd.7",
                                     "caps": ["osd=allow *"]})
        assert rc == 0 and out["key"]
        rc, _, out2 = client.command({"prefix": "auth get",
                                      "entity": "osd.7"})
        assert out2["key"] == out["key"]


class TestSubscriptions:
    def test_osdmap_pushed_on_change(self, client):
        client.sub_want("osdmap")
        client.wait_for_osdmap()
        epoch0 = client.osdmap_epoch
        rc, outs, _ = client.command({"prefix": "osd pool create",
                                      "pool": "subs", "pg_num": 8})
        assert rc == 0, outs
        assert wait_for(lambda: client.osdmap_epoch > epoch0)
        assert any(p["name"] == "subs"
                   for p in client.osdmap_dict["pools"])


class TestFailover:
    def test_leader_death_reelects_and_serves(self):
        monmap, mons = make_cluster(3)
        mc = None
        try:
            assert wait_for(lambda: any(m.is_leader for m in mons))
            mc = MonClient(monmap)
            rc, _, _ = mc.command({"prefix": "config-key put",
                                   "key": "k", "val": "1"})
            assert rc == 0
            mons[0].shutdown()
            assert wait_for(lambda: mons[1].is_leader, timeout=20)
            rc, _, val = mc.command({"prefix": "config-key get",
                                     "key": "k"}, timeout=20)
            assert rc == 0 and val == "1"
            rc, _, _ = mc.command({"prefix": "config-key put",
                                   "key": "k2", "val": "2"}, timeout=20)
            assert rc == 0
        finally:
            stop(mons[1:], mc)

    def test_restart_replays_store(self, tmp_path):
        ports = free_ports(3)
        stores = [MonitorDBStore(str(tmp_path / f"mon{r}.wal"))
                  for r in range(3)]
        monmap, mons = start_mons("port", ports, stores)
        mc = None
        try:
            assert wait_for(lambda: any(m.is_leader for m in mons),
                            timeout=60)
            mc = MonClient(monmap)
            rc = None
            for _ in range(3):      # a retry absorbs an election
                rc, _, _ = mc.command({"prefix": "osd pool create",
                                       "pool": "persist", "pg_num": 8},
                                      timeout=30)
                if rc in (0, -17):
                    break
            assert rc in (0, -17)
            assert wait_for(lambda: all(
                "persist" in m.services["osdmap"].osdmap.pool_name
                for m in mons), timeout=60)
            version = max(m.paxos.last_committed for m in mons)
        finally:
            stop(mons, mc)
        stores2 = [MonitorDBStore(str(tmp_path / f"mon{r}.wal"))
                   for r in range(3)]
        _, mons2 = start_mons("port", free_ports(3), stores2)
        try:
            assert wait_for(lambda: all(
                "persist" in m.services["osdmap"].osdmap.pool_name
                and m.paxos.last_committed >= version
                for m in mons2), timeout=60)
        finally:
            stop(mons2)

    def test_killed_mon_restarts_from_its_wal_and_catches_up(self,
                                                             tmp_path):
        ports = free_ports(3)
        stores = [MonitorDBStore(str(tmp_path / f"mon{r}.wal"))
                  for r in range(3)]
        monmap, mons = start_mons("port", ports, stores)
        mc = None
        try:
            assert wait_for(lambda: any(m.is_leader for m in mons))
            mc = MonClient(monmap)
            mons[2].shutdown()
            for i in range(3):
                rc, _, _ = mc.command({"prefix": "config-key put",
                                       "key": f"late{i}", "val": "x"},
                                      timeout=20)
                assert rc == 0
            version = mons[0].paxos.last_committed
            revived = PMON.Monitor(
                2, monmap,
                store=MonitorDBStore(str(tmp_path / "mon2.wal")))
            mons[2] = revived
            assert revived.paxos.last_committed < version
            revived.start()
            assert wait_for(lambda: revived.paxos.last_committed
                            >= version, timeout=20)
            assert revived.store.get_str("svc_config", "late2") == "x"
        finally:
            stop(mons, mc)


# -- down/out machinery on one port mon ---------------------------------------

class TestDownOutMachinery:
    def _leader_with_osds(self, n=3):
        monmap, mons = make_cluster(1)
        mon = mons[0]
        try:
            assert wait_for(lambda: mon.is_leader and
                            mon.paxos.last_committed > 0, timeout=30)
            svc = mon.services["osdmap"]
            with mon.lock:
                for o in range(n):
                    svc.handle_boot(o, f"127.0.0.1:{7800 + o}")
            assert wait_for(lambda: all(svc.osdmap.is_up(o)
                                        for o in range(n)), timeout=30)
        except BaseException:
            mon.shutdown()
            raise
        return monmap, mon, svc

    def _set_flag(self, monmap, flag, on=True):
        mc = MonClient(monmap)
        try:
            rc, outs, _ = mc.command(
                {"prefix": "osd set" if on else "osd unset", "key": flag},
                timeout=30)
            assert rc == 0, outs
        finally:
            mc.shutdown()

    def test_nodown_refreshes_windows_no_mass_expire_on_lift(self):
        monmap, mon, svc = self._leader_with_osds(3)
        try:
            self._set_flag(monmap, "nodown")
            stale = time.monotonic() - svc.REPORT_TIMEOUT * 3
            with mon.lock:
                for o in range(3):
                    svc._last_report[o] = stale
            assert wait_for(lambda: all(
                time.monotonic() - svc._last_report.get(o, 0) <
                svc.REPORT_TIMEOUT / 2 for o in range(3)), timeout=10)
            assert all(svc.osdmap.is_up(o) for o in range(3))
            self._set_flag(monmap, "nodown", on=False)
            # several tick periods of normal expiry: nobody goes down
            assert holds_for(lambda: all(svc.osdmap.is_up(o)
                                         for o in range(3)), 1.0)
        finally:
            mon.shutdown()

    def test_report_timeout_still_fires_without_nodown(self):
        monmap, mon, svc = self._leader_with_osds(2)
        try:
            with mon.lock:
                svc._last_report[1] = \
                    time.monotonic() - svc.REPORT_TIMEOUT - 5.0
            assert wait_for(lambda: not svc.osdmap.is_up(1), timeout=10)
            assert svc.osdmap.is_up(0)
        finally:
            mon.shutdown()

    def test_noout_suppresses_auto_out_until_lifted(self, monkeypatch):
        monkeypatch.setattr(OSDMonitor, "DOWN_OUT_INTERVAL", 1.0)
        monmap, mon, svc = self._leader_with_osds(2)
        try:
            self._set_flag(monmap, "noout")
            with mon.lock:
                svc._last_report[1] = \
                    time.monotonic() - svc.REPORT_TIMEOUT - 5.0
            assert wait_for(lambda: not svc.osdmap.is_up(1), timeout=10)
            # well past DOWN_OUT_INTERVAL: noout holds the OSD in and
            # does not start its down clock
            assert holds_for(lambda: not svc.osdmap.is_out(1) and 1 not in
                             getattr(svc, "_down_since", {}), 2.5)
            self._set_flag(monmap, "noout", on=False)
            assert wait_for(lambda: 1 in getattr(svc, "_down_since", {}),
                            timeout=10)
            assert not svc.osdmap.is_out(1)
            assert wait_for(lambda: svc.osdmap.is_out(1), timeout=10)
        finally:
            mon.shutdown()

    def test_down_since_cleared_on_revive(self):
        monmap, mon, svc = self._leader_with_osds(2)
        try:
            with mon.lock:
                svc._last_report[1] = \
                    time.monotonic() - svc.REPORT_TIMEOUT - 5.0
            assert wait_for(lambda: not svc.osdmap.is_up(1), timeout=10)
            assert wait_for(lambda: 1 in getattr(svc, "_down_since", {}),
                            timeout=10)
            with mon.lock:
                svc.handle_boot(1, "127.0.0.1:7899")
            assert wait_for(lambda: svc.osdmap.is_up(1), timeout=10)
            assert wait_for(lambda: 1 not in getattr(svc, "_down_since",
                                                     {}), timeout=10)
            assert not svc.osdmap.is_out(1)
        finally:
            mon.shutdown()


# -- across packages ----------------------------------------------------------

SCRIPT = [
    {"prefix": "osd pool create", "pool": "data", "pg_num": 16},
    {"prefix": "osd erasure-code-profile set", "name": "ec43",
     "profile": ["k=4", "m=3", "plugin=jerasure"]},
    {"prefix": "osd erasure-code-profile get", "name": "ec43"},
    {"prefix": "osd pool create", "pool": "ecpool", "pg_num": 8,
     "pool_type": "erasure", "erasure_code_profile": "ec43"},
    {"prefix": "osd pool ls"},
    {"prefix": "osd dump"},
    {"prefix": "osd tree"},
    {"prefix": "config-key put", "key": "foo/bar", "val": "baz"},
    {"prefix": "config-key get", "key": "foo/bar"},
    {"prefix": "config-key get", "key": "missing"},
    {"prefix": "config-key ls"},
    {"prefix": "auth get-or-create", "entity": "osd.7",
     "caps": ["osd=allow *"]},
    {"prefix": "log", "logtext": "hello cluster"},
    {"prefix": "log last", "num": 5},
    {"prefix": "status"},
    {"prefix": "health detail"},
    {"prefix": "pg summary"},
    {"prefix": "no such command"},
]


def _normalized(reply):
    """A reply with what differs by design taken out: fresh random keys
    and the mon's clock."""
    rc, outs, out = json.loads(json.dumps(reply))
    if isinstance(out, dict) and "key" in out:
        out["key"] = bool(out["key"])
    if isinstance(out, list):
        for e in out:
            if isinstance(e, dict) and "stamp" in e:
                e["stamp"] = e["stamp"] > 0
    return rc, outs, out


def _health_logged(mon):
    """Whether ``mon``'s committed cluster log holds a health check."""
    with mon.lock:
        return any(e.get("text", "").startswith("Health check failed")
                   for e in mon.services["log"].last(20))


def _run_script(mon_pkg, client_pkg):
    ports = free_ports(3)
    _, mons = start_mons(mon_pkg, ports)
    mc = None
    try:
        assert full_quorum(mons)
        mc = PKG[client_pkg][0].MonClient(monmap_of(client_pkg, ports))
        replies = []
        for c in SCRIPT:
            replies.append(_normalized(mc.command(dict(c), timeout=20)))
            if c is SCRIPT[0]:
                # the leader's health tick logs the first pool's PGs as
                # stuck on its own clock: wait until every mon holds
                # that entry, so that it precedes the script's own log
                # lines and counts the same PGs in every run
                assert wait_for(lambda: all(_health_logged(m)
                                            for m in mons), timeout=20)
        lc = {m.paxos.last_committed for m in mons}
        assert wait_for(lambda: len({m.paxos.last_committed
                                     for m in mons}) == 1, timeout=10), lc
        return replies
    finally:
        stop(mons, mc)


@pytest.fixture(scope="module")
def same_package_replies():
    return _run_script("ceph_tpu", "ceph_tpu")


@pytest.mark.parametrize("mon_pkg,client_pkg", [("ceph_tpu", "port"),
                                                ("port", "ceph_tpu")])
def test_clients_across_packages_get_the_same_replies(
        mon_pkg, client_pkg, same_package_replies):
    got = _run_script(mon_pkg, client_pkg)
    for cmd, a, b in zip(SCRIPT, got, same_package_replies):
        assert a == b, cmd["prefix"]
    assert got[0][0] == 0 and got[-1][0] != 0


def _populate(pkg, path):
    """One mon of ``pkg`` on a WAL at ``path``: a few committed rounds
    of every service, then a clean shutdown."""
    _, mons = start_mons(pkg, free_ports(1),
                         [PKG[pkg][0].MonitorDBStore(path)])
    mon = mons[0]
    mc = None
    try:
        assert wait_for(lambda: mon.is_leader and mon.paxos.is_writeable(),
                        timeout=15)
        mc = PKG[pkg][0].MonClient(mon.monmap)
        for cmd in SCRIPT[:4] + [
                {"prefix": "config-key put", "key": "a/b", "val": "c"},
                {"prefix": "auth get-or-create", "entity": "client.x",
                 "caps": ["mon=allow r"]},
                {"prefix": "osd set", "key": "noout"}]:
            rc, outs, _ = mc.command(dict(cmd), timeout=20)
            assert rc == 0, (cmd, outs)
        assert wait_for(lambda: mon.services["health"].report is not None
                        and mon.store.get_str("svc_health", "report")
                        is not None, timeout=15)
    finally:
        stop(mons, mc)


def _committed_state(pkg, path):
    """What a ``pkg`` Monitor holds after mounting the WAL at ``path``:
    the services refreshed from the store, the mon never started."""
    mon_mod, _ = PKG[pkg]
    mon = mon_mod.Monitor(0, monmap_of(pkg, free_ports(1)),
                          store=mon_mod.MonitorDBStore(path))
    try:
        with mon.lock:
            for svc in mon.services.values():
                svc.update_from_store()
        osdmap = mon.services["osdmap"].osdmap
        to_dict = osdmap_to_dict if pkg == "port" else ref_osdmap_to_dict
        return {
            "last_committed": mon.paxos.last_committed,
            "osdmap": json.loads(json.dumps(to_dict(osdmap))),
            "profiles": dict(osdmap.erasure_code_profiles),
            "pools": sorted(osdmap.pool_name),
            "config_keys": {k: mon.store.get_str("svc_config", k)
                            for k in mon.store.keys("svc_config")},
            "auth": mon.services["auth"].keyring.dump(),
            "health": mon.services["health"].report,
        }
    finally:
        mon.shutdown()


@pytest.mark.parametrize("writer,reader", [("ceph_tpu", "port"),
                                           ("port", "ceph_tpu")])
def test_store_carries_across_packages(tmp_path, writer, reader):
    path = str(tmp_path / "mon0.wal")
    _populate(writer, path)
    want = _committed_state(writer, path)
    got = _committed_state(reader, path)
    assert got == want
    assert want["last_committed"] > 5
    assert "ecpool" in want["pools"] and "ec43" in want["profiles"]
    assert want["config_keys"]["a/b"] == "c"
    assert "[client.x]" in want["auth"]
    assert want["health"] and "OSDMAP_FLAGS" in json.dumps(want["health"])
    # and the reader's mon serves from it
    _, mons = start_mons(reader, free_ports(1),
                         [PKG[reader][0].MonitorDBStore(path)])
    mc = None
    try:
        assert wait_for(lambda: mons[0].is_leader and
                        mons[0].paxos.is_writeable(), timeout=15)
        mc = PKG[reader][0].MonClient(mons[0].monmap)
        rc, _, val = mc.command({"prefix": "config-key get", "key": "a/b"},
                                timeout=20)
        assert (rc, val) == (0, "c")
        assert mons[0].paxos.last_committed >= want["last_committed"]
    finally:
        stop(mons, mc)
