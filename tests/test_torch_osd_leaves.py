"""The port's OSD leaves against ceph_tpu's, on the CPU: the PG types'
encodings (``LogEntry``, ``PGInfo``, ``PGLog`` with trim, dups and the
missing set), the op schedulers' dequeue orders (WPQ, and mClock under
``tests/test_scheduler.py``'s ``FakeClock``) for one seeded trace, and
every ``cls`` method's output bytes and staged ops on the same object
state.  Both packages get the same inputs; the outputs must be equal.
"""

import json

import numpy as np
import pytest

import ceph_tpu.cls as RCLS
import ceph_tpu.osd.scheduler as RS
import ceph_tpu.osd.types as RT
import ceph_tpu_torch.cls as PCLS
import ceph_tpu_torch.osd.scheduler as PS
import ceph_tpu_torch.osd.types as PT
from ceph_tpu.core.config import ConfigProxy as RConfig
from ceph_tpu.core.options import build_options as r_build_options
from ceph_tpu_torch.core.config import ConfigProxy as PConfig
from ceph_tpu_torch.core.options import build_options as p_build_options

SEED = 23


# -- types --------------------------------------------------------------------

def _pglog(mod, seed):
    rng = np.random.default_rng(seed)
    log = mod.PGLog()
    prior = {}
    for v in range(1, 400):
        oid = f"obj{int(rng.integers(40))}"
        op = [mod.MODIFY, mod.MODIFY, mod.DELETE, mod.ERROR][
            int(rng.integers(4))]
        e = mod.LogEntry(op=op, oid=oid, version=(3 + v // 100, v),
                         prior_version=prior.get(oid, mod.ZERO),
                         reqid=f"client.{int(rng.integers(5))}:{v}"
                         if rng.random() < 0.9 else "",
                         mtime=float(v) / 8)
        prior[oid] = e.version
        log.add(e)
        if v % 50 == 0:
            log.trim((3 + v // 100, v - 30))
    out = [log.to_dict(), list(log.head),
           {k: v for k, v in log.missing_for((5, 250)).items()},
           [e.to_dict() for e in log.entries_after((6, 380))]]
    for rid in (log.dups[0][0], log.entries[-1].reqid, "nope:1"):
        hit = log.find_reqid(rid)
        out.append(None if hit is None else hit.to_dict())
    again = mod.PGLog.from_dict(json.loads(json.dumps(log.to_dict())))
    out.append(again.to_dict() == log.to_dict())
    info = mod.PGInfo(pgid="1.a", last_update=log.head,
                      last_complete=(5, 300), log_tail=log.tail,
                      same_interval_since=9, epoch_created=2,
                      last_epoch_started=8, shards_held=[0, 2])
    out.append(info.to_dict())
    out.append(mod.PGInfo.from_dict(
        json.loads(json.dumps(info.to_dict()))).to_dict())
    out.append(mod.PGInfo.from_dict({"pgid": "2.0", "last_update": [1, 2],
                                     "last_complete": [1, 1]}).to_dict())
    out.append(mod.ver_str(log.head))
    return out


def test_pg_log_and_info_encodings_match():
    ref, port = _pglog(RT, SEED), _pglog(PT, SEED)
    assert json.dumps(port) == json.dumps(ref)
    assert ref[4]["oid"] == "" and ref[6] is None   # a dup, and a miss


# -- schedulers ---------------------------------------------------------------

class FakeClock:
    """``tests/test_scheduler.py``'s virtual clock."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _label(item):
    return getattr(item, "tag", item)


class _Op:
    def __init__(self, tag):
        self.tag = tag


def _wpq_trace(mod, seed):
    rng = np.random.default_rng(seed)
    q = mod.WeightedPriorityQueue({mod.CLIENT: 60, mod.RECOVERY: 6,
                                   mod.SCRUB: 2, mod.PEERING: 1000,
                                   mod.SUBOP: 30})
    classes = [mod.CLIENT, mod.RECOVERY, mod.SCRUB, mod.SUBOP, mod.PEERING]
    out = []
    for i in range(600):
        r = rng.random()
        if r < 0.55:
            k = classes[int(rng.choice(5, p=[.4, .25, .1, .2, .05]))]
            q.enqueue(k, (k, i))
        elif r < 0.6:
            q.account(classes[int(rng.integers(4))],
                      float(rng.integers(1, 5)))
        else:
            out.append(q.dequeue(timeout=0))
        if i % 97 == 0:
            out.append((len(q), sorted(q.depths().items())))
    while len(q):
        out.append(q.dequeue(timeout=0))
    q.close()
    out.append(q.dequeue(timeout=0))
    return out


def test_wpq_dequeue_order_matches():
    ref, port = _wpq_trace(RS, SEED), _wpq_trace(PS, SEED)
    assert port == ref
    assert sum(1 for x in ref if isinstance(x, tuple) and
               x and x[0] == RS.PEERING) > 0


def _mclock_trace(mod, seed):
    rng = np.random.default_rng(seed)
    clk = FakeClock()
    s = mod.MClockScheduler({mod.CLIENT: (100.0, 1.0, 0.0),
                             mod.RECOVERY: (0.0, 100.0, 0.0),
                             mod.SCRUB: (0.0, 10.0, 10.0),
                             mod.SUBOP: (20.0, 5.0, 50.0)},
                            clock=clk,
                            client_qos={"gold": (50.0, 5.0, 0.0),
                                        "capped": (0.0, 1.0, 5.0)})
    classes = [mod.CLIENT, mod.RECOVERY, mod.SCRUB, mod.SUBOP, mod.PEERING]
    clients = [None, "gold", "capped", "a", "b"]
    out = []
    for i in range(1500):
        r = rng.random()
        if r < 0.5:
            k = classes[int(rng.choice(5, p=[.45, .3, .1, .1, .05]))]
            c = clients[int(rng.integers(5))] if k == mod.CLIENT else None
            s.enqueue(k, _Op((k, c, i)), client=c,
                      delta=int(rng.integers(1, 4)),
                      rho=int(rng.integers(1, 3)))
        elif r < 0.53:
            s.account(classes[int(rng.integers(4))],
                      float(rng.integers(1, 4)))
        else:
            clk.advance(float(rng.exponential(0.004)))
            got = s.dequeue(timeout=0)
            out.append(None if got is None else
                       (got[0], _label(got[1]),
                        getattr(got[1], "_dmc_phase", None)))
        if i == 700:
            s.reload_profiles({mod.CLIENT: (30.0, 2.0, 60.0),
                               mod.RECOVERY: (5.0, 50.0, 0.0)})
            s.set_client_qos({"gold": (10.0, 1.0, 20.0)})
        if i % 131 == 0:
            out.append((len(s), sorted(s.depths().items())))
    for _ in range(4000):
        if not len(s):
            break
        clk.advance(0.01)
        got = s.dequeue(timeout=0)
        if got is not None:
            out.append((got[0], _label(got[1]), got[1]._dmc_phase))
    s.close()
    out.append(len(s))
    return out


def test_mclock_dequeue_order_matches():
    ref, port = _mclock_trace(RS, SEED), _mclock_trace(PS, SEED)
    assert port == ref
    phases = {x[2] for x in ref if isinstance(x, tuple) and len(x) == 3}
    assert {"reservation", "priority"} <= phases


@pytest.mark.parametrize("kind", ["wpq", "mclock"])
def test_make_op_queue_from_each_config(kind):
    made = []
    for mod, cfg, opts in ((RS, RConfig, r_build_options),
                           (PS, PConfig, p_build_options)):
        conf = cfg(opts())
        conf.set("osd_op_queue", kind)
        conf.set("osd_mclock_scheduler_client_qos",
                 '{"t1": [5, 2, 9], "bad": [1], "t2": "x"}')
        q = mod.make_op_queue(conf)
        row = [type(q).__name__, mod.profiles_from_config(conf),
               mod.client_qos_from_config(conf),
               sorted(mod.default_mclock_profiles().items())]
        if kind == "mclock":
            conf.set("osd_mclock_scheduler_client_res", "77")
            conf.set("osd_mclock_scheduler_client_qos", "not json")
            row += [sorted(q.profiles.items()), q.client_qos]
        made.append(row)
    assert made[1] == made[0]
    assert made[0][0] == ("MClockScheduler" if kind == "mclock"
                          else "WeightedPriorityQueue")


# -- cls ----------------------------------------------------------------------

class ObjectState:
    """One object's xattrs and omap, applying a method's staged ops."""

    def __init__(self):
        self.exists = False
        self.xattrs: dict[str, bytes] = {}
        self.omap: dict[str, bytes] = {}

    def context(self, mod):
        return mod.ClsContext(self.xattrs.get, lambda: self.exists,
                              lambda: dict(self.omap))

    def apply(self, ops):
        for op in ops:
            kind = op["op"]
            if kind == "write_full":
                self.exists = True
            elif kind == "setxattr":
                self.xattrs[op["name"]] = bytes.fromhex(op["data"])
            elif kind == "rmxattr":
                self.xattrs.pop(op["name"], None)
            elif kind == "omap_set":
                self.omap.update({k: bytes.fromhex(v)
                                  for k, v in op["kv"].items()})
            elif kind == "omap_rm":
                for k in op["keys"]:
                    self.omap.pop(k, None)


CLS_SCRIPT = [
    ("version", "read", b""),
    ("version", "inc", b""),
    ("version", "inc", b""),
    ("version", "read", b""),
    ("lock", "info", b""),
    ("lock", "lock", {"name": "l", "cookie": "c1", "entity": "client.1"}),
    ("lock", "lock", {"name": "l", "cookie": "c2", "entity": "client.2"}),
    ("lock", "lock", {"name": "l", "cookie": "c1", "entity": "client.1"}),
    ("lock", "info", {"name": "l"}),
    ("lock", "unlock", {"name": "l", "cookie": "c9"}),
    ("lock", "unlock", {"name": "l", "cookie": "c1", "entity": "client.1"}),
    ("lock", "lock", {"name": "s", "cookie": "a", "type": "shared"}),
    ("lock", "lock", {"name": "s", "cookie": "b", "type": "shared"}),
    ("lock", "lock", {"name": "s", "cookie": "c"}),
    ("lock", "unlock", {"name": "s", "cookie": "a"}),
    ("lock", "info", {"name": "s"}),
    ("log", "add", {"timestamp": 1700000000.5, "section": "meta",
                    "name": "n0", "data": "d0"}),
    ("log", "add", {"entries": [
        {"timestamp": 1700000001.25, "name": f"n{i}", "data": i}
        for i in range(1, 6)]}),
    ("log", "list", {"max_entries": 3}),
    ("log", "list", {"marker": "log.", "max_entries": 100}),
    ("log", "trim", {"to_marker": "log.1700000001.250000.00000002"}),
    ("log", "list", b""),
    ("log", "trim", {"to_marker": "log.0"}),
    ("log", "add", {"section": "s", "name": "stamped", "data": "x"}),
    ("log", "list", {}),
    ("nope", "x", b""),
    ("lock", "nope", b""),
]


def _run_cls(mod, monkeypatch):
    import time as _time
    # the one method that reads the clock (log.add without a
    # timestamp) reads this pinned value in both packages
    monkeypatch.setattr(_time, "time", lambda: 1700000123.0)
    obj = ObjectState()
    out = []
    for cls_name, meth, inp in CLS_SCRIPT:
        if not isinstance(inp, bytes):
            inp = json.dumps(inp).encode()
        ctx = obj.context(mod)
        try:
            res = mod.call(cls_name, meth, ctx, inp)
            out.append(("ok", res, ctx.staged_ops))
            obj.apply(ctx.staged_ops)
        except mod.ClsError as e:
            out.append(("err", e.rc, str(e), ctx.staged_ops))
    out.append((obj.exists, sorted(obj.xattrs.items()),
                sorted(obj.omap.items())))
    return out


def test_cls_methods_match(monkeypatch):
    ref = _run_cls(RCLS, monkeypatch)
    port = _run_cls(PCLS, monkeypatch)
    assert port == ref
    assert sorted(PCLS._REGISTRY) == sorted(RCLS._REGISTRY)
    for name in RCLS._REGISTRY:
        assert sorted(PCLS._REGISTRY[name]) == sorted(RCLS._REGISTRY[name])
    errs = [r[1] for r in ref if r[0] == "err"]
    assert errs == [-16, -2, -16, -2, -95, -95]
