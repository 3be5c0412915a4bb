"""The port's messenger against ceph_tpu's: wire format, modes, faults.

Every message class of the port's ``msg/``, ``mon/messages.py``,
``osd/messages.py`` and ``mds/messages.py`` must encode seeded values to the same bytes as the
class of the same type in ceph_tpu's registry, and decode there; a
port ``Messenger`` and a ceph_tpu ``Messenger`` exchange pings both ways
in ``crc`` and ``secure`` modes and refuse a mode mismatch; a seeded
``FaultInjector`` makes the same decisions in both.  Every messenger is
shut down in a ``finally``; ports are ephemeral; waits poll with a
deadline.
"""

import threading
import time

import numpy as np
import pytest

import ceph_tpu.mds.messages  # noqa: F401  (fills ceph_tpu's registry)
import ceph_tpu.mon.messages  # noqa: F401
import ceph_tpu.osd.messages  # noqa: F401
import ceph_tpu_torch.mds.messages  # noqa: F401
import ceph_tpu_torch.mon.messages  # noqa: F401
import ceph_tpu_torch.osd.messages  # noqa: F401
from ceph_tpu.core import auth as RA
from ceph_tpu import msg as RM
from ceph_tpu.msg import fault as RF
from ceph_tpu_torch.core import auth as PA
from ceph_tpu_torch import msg as PM
from ceph_tpu_torch.msg import fault as PF

SECRET = b"sixteen byte key"


def wait_for(pred, timeout=10.0, interval=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def _json_value(rng, depth=0):
    kind = int(rng.integers(0, 6 if depth < 2 else 4))
    if kind == 0:
        return int(rng.integers(-1 << 40, 1 << 40))
    if kind == 1:
        return float(rng.standard_normal())
    if kind == 2:
        return "".join(chr(int(c)) for c in rng.integers(32, 0x500, 6))
    if kind == 3:
        return None if rng.integers(0, 2) else bool(rng.integers(0, 2))
    if kind == 4:
        return [_json_value(rng, depth + 1) for _ in range(3)]
    return {f"k{i}": _json_value(rng, depth + 1) for i in range(3)}


def _port_classes():
    wanted = ("ceph_tpu_torch.msg.", "ceph_tpu_torch.mon.messages",
              "ceph_tpu_torch.osd.messages", "ceph_tpu_torch.mds.messages")
    return sorted((cls for cls in PM.MSG_REGISTRY.values()
                   if cls.__module__.startswith(wanted)),
                  key=lambda c: c.TYPE)


def test_registries_hold_the_same_types():
    classes = _port_classes()
    assert len(classes) >= 40
    for cls in classes:
        ref = RM.MSG_REGISTRY[cls.TYPE]
        assert ref.__name__ == cls.__name__
        assert (ref.VERSION, ref.COMPAT) == (cls.VERSION, cls.COMPAT)
        assert getattr(ref, "FIELDS", ()) == getattr(cls, "FIELDS", ())


@pytest.mark.parametrize("cls", _port_classes(), ids=lambda c: c.__name__)
def test_message_encodes_to_the_same_bytes(cls):
    rng = np.random.default_rng(cls.TYPE)
    ref_cls = RM.MSG_REGISTRY[cls.TYPE]
    if cls.__name__ == "MGenericPing":
        args = dict(stamp=float(rng.random() * 1e9))
    elif cls.__name__ == "MGenericReply":
        args = dict(what="reply ü", result=int(rng.integers(-99, 99)))
    else:
        args = {f: _json_value(rng) for f in cls.FIELDS}
    a, b = cls(**args), ref_cls(**args)
    a.seq = b.seq = int(rng.integers(0, 1 << 40))
    a.priority = b.priority = cls.PRIORITY_HIGH
    wire = a.encode()
    assert wire == b.encode()
    for decoded, want_cls in ((RM.Message.decode(wire), ref_cls),
                              (PM.Message.decode(wire), cls)):
        assert type(decoded) is want_cls
        assert decoded.seq == a.seq and decoded.priority == a.priority
        assert decoded.encode() == wire


class Echo:
    """A dispatcher that answers each ping with a reply and keeps what
    it received; built on either package's ``Dispatcher``."""

    def __init__(self, mod):
        self.mod = mod
        self.got = []
        self.lock = threading.Lock()

    def ms_dispatch(self, msg):
        with self.lock:
            self.got.append(msg)
        if isinstance(msg, self.mod.MGenericPing):
            msg.connection.send_message(
                self.mod.MGenericReply(f"pong {msg.stamp}", 7))
        return True

    def ms_handle_reset(self, con):
        pass

    def ms_handle_accept(self, con):
        pass


def _messenger(mod, auth_mod, name, mode):
    if mode == "crc":
        return mod.Messenger(name)
    return mod.Messenger(
        name, **auth_mod.ClusterAuth(SECRET).msgr_kwargs(name, mode))


@pytest.mark.parametrize("mode", ["crc", "secure"])
@pytest.mark.parametrize("server_side", ["port", "ceph_tpu"])
def test_messengers_exchange_pings_across_packages(server_side, mode):
    pkgs = {"port": (PM, PA), "ceph_tpu": (RM, RA)}
    smod, sauth = pkgs[server_side]
    cmod, cauth = pkgs["ceph_tpu" if server_side == "port" else "port"]
    server = _messenger(smod, sauth, "osd.0", mode)
    client = _messenger(cmod, cauth, "client.a", mode)
    try:
        sd, cd = Echo(smod), Echo(cmod)
        server.add_dispatcher(sd)
        client.add_dispatcher(cd)
        addr = server.bind("127.0.0.1", 0)
        con = client.connect_to(cmod.EntityAddr(addr.host, addr.port))
        assert con.secure == (mode == "secure")
        for i in range(5):
            con.send_message(cmod.MGenericPing(stamp=float(i)))
        assert wait_for(lambda: len(cd.got) == 5)
        assert [m.stamp for m in sd.got] == [0.0, 1.0, 2.0, 3.0, 4.0]
        assert all(type(m) is smod.MGenericPing for m in sd.got)
        assert [(m.what, m.result) for m in cd.got] == \
            [(f"pong {float(i)}", 7) for i in range(5)]
        assert all(type(m) is cmod.MGenericReply for m in cd.got)
    finally:
        client.shutdown()
        server.shutdown()


@pytest.mark.parametrize("server_side", ["port", "ceph_tpu"])
def test_mode_mismatch_refused_both_ways(server_side):
    pkgs = {"port": (PM, PA), "ceph_tpu": (RM, RA)}
    smod, sauth = pkgs[server_side]
    cmod, cauth = pkgs["ceph_tpu" if server_side == "port" else "port"]
    for smode, cmode in (("crc", "secure"), ("secure", "crc")):
        server = smod.Messenger(
            "osd.0", **sauth.ClusterAuth(SECRET).msgr_kwargs("osd.0", smode))
        client = cmod.Messenger(
            "client.a",
            **cauth.ClusterAuth(SECRET).msgr_kwargs("client.a", cmode))
        try:
            addr = server.bind("127.0.0.1", 0)
            with pytest.raises(ConnectionError, match="ms_mode mismatch"):
                client.connect_to(cmod.EntityAddr(addr.host, addr.port))
        finally:
            client.shutdown()
            server.shutdown()


def test_secure_mode_requires_auth_in_both():
    for mod in (PM, RM):
        with pytest.raises(ValueError, match="secure mode requires"):
            mod.Messenger("osd.0", mode="secure")
        with pytest.raises(ValueError, match="unknown ms_mode"):
            mod.Messenger("osd.0", mode="tls")


def test_wrong_cluster_key_is_refused_across_packages():
    server = PM.Messenger(
        "osd.0", **PA.ClusterAuth(SECRET).msgr_kwargs("osd.0", "secure"))
    client = RM.Messenger(
        "client.a", **RA.ClusterAuth(b"another 16b key!").msgr_kwargs(
            "client.a", "secure"))
    try:
        addr = server.bind("127.0.0.1", 0)
        with pytest.raises((ConnectionError, RA.AuthError)):
            client.connect_to(RM.EntityAddr(addr.host, addr.port))
    finally:
        client.shutdown()
        server.shutdown()


def _rules(fi):
    fi.set_rule("*", "*", drop=0.1, dup=0.1, delay=0.2, delay_ms=5)
    fi.set_rule("osd.0", "osd.1", reorder=0.3, reorder_ms=7, drop=0.2)
    fi.set_rule("osd.2", "*", dup="0.5")        # admin-socket strings
    fi.partition("osd.3", src="osd.4")


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_fault_injector_same_decisions(seed):
    a, b = PF.FaultInjector(seed=seed), RF.FaultInjector(seed=seed)
    _rules(a)
    _rules(b)
    assert a.describe() == b.describe()
    pairs = [("osd.0", "osd.1"), ("osd.1", "osd.0"), ("osd.2", "mon.0"),
             ("osd.4", "osd.3"), ("client.a", "osd.9")]
    assert a.preview_pairs(pairs, 200) == b.preview_pairs(pairs, 200)
    seen = set()
    for src, dst in pairs * 40:
        da, db = a.decide(src, dst), b.decide(src, dst)
        assert (da.verdict, da.hold_s) == (db.verdict, db.hold_s)
        seen.add(da.verdict)
    assert {PF.DROP, PF.DUP, PF.DELAY, PF.REORDER, PF.PARTITION} <= seen
    assert a.describe()["counters"] == b.describe()["counters"]
    assert [a.socket_cut(3) for _ in range(50)] == \
        [b.socket_cut(3) for _ in range(50)]
    a.heal(src="osd.4")
    b.heal(src="osd.4")
    assert a.preview("osd.4", "osd.3", 20) == b.preview("osd.4", "osd.3", 20)
    assert PF.site_pairs(["a", "b"], ["c"]) == RF.site_pairs(["a", "b"],
                                                             ["c"])


def test_fault_injector_drops_on_the_wire_across_packages():
    """A port messenger with a seeded full-drop rule toward one peer
    delivers nothing to a ceph_tpu messenger; healed, it delivers."""
    fi = PF.FaultInjector(seed=3)
    client = PM.Messenger("client.a", fault_injector=fi)
    server = RM.Messenger("osd.0")
    try:
        sd = Echo(RM)
        server.add_dispatcher(sd)
        client.add_dispatcher(Echo(PM))
        addr = server.bind("127.0.0.1", 0)
        con = client.connect_to(PM.EntityAddr(addr.host, addr.port))
        con.send_message(PM.MGenericPing(stamp=1.0))
        assert wait_for(lambda: len(sd.got) == 1)
        peer = con.peer_name
        fi.set_rule("client.a", peer, drop=1.0)
        for i in range(3):
            con.send_message(PM.MGenericPing(stamp=2.0 + i))
        fi.heal()
        con.send_message(PM.MGenericPing(stamp=9.0))
        assert wait_for(lambda: any(m.stamp == 9.0 for m in sd.got))
        assert [m.stamp for m in sd.got] == [1.0, 9.0]
    finally:
        client.shutdown()
        server.shutdown()
