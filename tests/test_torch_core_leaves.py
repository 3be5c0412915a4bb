"""The rest of the port's ``core/`` against ceph_tpu's, on the CPU.

``Log`` (its sink and its crash ring, under one pinned wall clock),
``Formatter`` in each format, lockdep's ``LockOrderError`` on the same
inversions, the top-K sketches for one seeded stream (``SpaceSaving``,
``TopKSet``, ``merge_sketches``, ``rank``), ``OpTracker`` dumps under a
fake monotonic clock, and ``CephContext``'s admin-socket replies.  Each
case feeds both packages the same inputs and compares the outputs
exactly; the only field set aside is named where it is.
"""

import io
import json
import threading
import types

import numpy as np
import pytest

from ceph_tpu.core import context as RC
from ceph_tpu.core import formatter as RF
from ceph_tpu.core import lockdep as RL
from ceph_tpu.core import log as RLOG
from ceph_tpu.core import topk as RK
from ceph_tpu.core import tracked_op as RT
from ceph_tpu.core.perf_counters import PerfCountersBuilder as RPCB
from ceph_tpu_torch.core import context as PC
from ceph_tpu_torch.core import formatter as PF
from ceph_tpu_torch.core import lockdep as PL
from ceph_tpu_torch.core import log as PLOG
from ceph_tpu_torch.core import topk as PK
from ceph_tpu_torch.core import tracked_op as PT
from ceph_tpu_torch.core.admin_socket import admin_command
from ceph_tpu_torch.core.perf_counters import PerfCountersBuilder as PPCB

BOTH = [("ceph_tpu", RLOG, RF, RL, RK, RT, RC, RPCB),
        ("port", PLOG, PF, PL, PK, PT, PC, PPCB)]


def pinned_time(start=1_700_000_000.25, step=0.125):
    """A stand-in for the ``time`` module whose clocks step by
    ``step`` at every read."""
    now = [start]

    def tick():
        now[0] += step
        return now[0]

    return types.SimpleNamespace(time=tick, monotonic=tick,
                                 strftime=__import__("time").strftime,
                                 localtime=__import__("time").localtime)


# -- log ----------------------------------------------------------------------

def _drive_log(mod, monkeypatch):
    monkeypatch.setattr(mod, "time", pinned_time())
    sink = io.StringIO()
    log = mod.Log(ring_size=8, sink=sink)
    log.set_level("osd", 1, gather=5)
    log.set_level("newsys", 3)
    rng = np.random.default_rng(5)
    for i in range(20):
        sub = ["osd", "mon", "ms", "newsys", "tpu"][int(rng.integers(5))]
        lvl = int(rng.integers(-1, 9))
        log.dout(sub, lvl, f"msg {i} {sub}/{lvl}")
    log.derr("mon", "an error")
    checks = [log.should_log(s, lv) for s in ("osd", "ms", "nope")
              for lv in range(0, 8)]
    dump = io.StringIO()
    n = log.dump_recent(out=dump)
    again = log.dump_recent(out=io.StringIO())
    return sink.getvalue(), dump.getvalue(), n, again, checks


def test_log_sink_and_ring_match(monkeypatch):
    ref = _drive_log(RLOG, monkeypatch)
    port = _drive_log(PLOG, monkeypatch)
    assert port == ref
    assert ref[2] == 8 and ref[3] == 0
    assert dict(PLOG.DEFAULT_SUBSYS) == dict(RLOG.DEFAULT_SUBSYS)


# -- formatter ----------------------------------------------------------------

def _fill(f, rng):
    f.open_object()
    f.dump_int("epoch", int(rng.integers(100)))
    f.dump_float("ratio", float(rng.random()))
    f.dump_string("name", "a<b&c>")
    f.open_array("osds")
    for i in range(int(rng.integers(2, 6))):
        f.open_object()
        f.dump_string("name", f"osd.{i}")
        f.dump_bool("up", bool(rng.integers(2)))
        f.dump("weight", float(rng.integers(1, 4)) / 2)
        f.close_object()
    f.close_array()
    f.open_object("nested")
    f.dump_int("n", 7)
    f.close_object()
    f.close_object()
    return f.flush()


def _table(f, rng):
    for i in range(4):
        f.open_object()
        f.dump_string("name", f"osd.{i}")
        f.dump_int("pgs", int(rng.integers(1000)))
        f.dump_bool("up", bool(i % 2))
        f.close_object()
    return f.flush()


@pytest.mark.parametrize("fmt", ["json", "json-pretty", "xml", "table"])
def test_formatter_output_matches(fmt):
    fill = _table if fmt == "table" else _fill
    ref = fill(RF.Formatter.create(fmt), np.random.default_rng(3))
    port = fill(PF.Formatter.create(fmt), np.random.default_rng(3))
    assert port == ref
    if fmt.startswith("json"):
        assert json.loads(port)["nested"] == {"n": 7}


def test_formatter_rejects_the_same_format():
    for mod in (RF, PF):
        with pytest.raises(ValueError, match="unknown format 'yaml'"):
            mod.Formatter.create("yaml")


# -- lockdep ------------------------------------------------------------------

@pytest.fixture
def lockdep_graphs():
    """Fresh order graphs in both packages; ceph_tpu's stays enabled
    afterwards, as the suite's conftest leaves it."""
    for mod in (RL, PL):
        mod.lockdep_disable()
        mod.lockdep_enable()
    yield
    PL.lockdep_disable()
    RL.lockdep_disable()
    RL.lockdep_enable()


def _inversions(mod):
    """The same three faults in either package → their messages."""
    out = []
    a, b, c = mod.Mutex("A"), mod.Mutex("B"), mod.Mutex("C")
    with a:
        with b:
            pass
    with b:
        with c:
            pass
    for holder, want in ((b, a), (c, a)):
        with holder:
            with pytest.raises(mod.LockOrderError) as e:
                want.acquire()
            out.append(str(e.value))
    with a:
        with pytest.raises(mod.LockOrderError) as e:
            a.acquire()
        out.append(str(e.value))
    # held sets are per thread: another thread's lock orders nothing
    x, y = mod.Mutex("X"), mod.Mutex("Y")
    x.acquire()
    t = threading.Thread(target=lambda: (y.acquire(), y.release()))
    t.start()
    t.join()
    x.release()
    with y:
        x.acquire()
        x.release()
    out.append(sorted((k, sorted(v)) for k, v in mod._edges.items()))
    mod.lockdep_disable()
    with b:
        a.acquire()         # unchecked while disabled
        a.release()
    return out


def test_lock_order_errors_match(lockdep_graphs):
    ref = _inversions(RL)
    port = _inversions(PL)
    assert port == ref
    assert "A -> B" in ref[0] and "recursive" in ref[2]


# -- top-K sketches -----------------------------------------------------------

def _stream(seed, n=4000):
    rng = np.random.default_rng(seed)
    keys = rng.zipf(1.3, n) % 97
    nbytes = rng.integers(0, 1 << 20, n)
    lat = rng.exponential(800.0, n)
    return [(f"client.{int(k)}", int(b), float(t))
            for k, b, t in zip(keys, nbytes, lat)]


def _sketches(mod, seed):
    sks = []
    for part in range(3):
        sk = mod.SpaceSaving(k=12)
        for key, b, t in _stream(seed + part):
            sk.update(key, 1, b, t)
        sks.append(sk)
    dumps = [sk.dump() for sk in sks]
    merged = mod.merge_sketches(dumps, k=10)
    ranks = {by: mod.rank(merged, by=by, n=8)
             for by in ("ops", "bytes", "p99", "other")}
    ts = mod.TopKSet(k=6)
    for i, (key, b, t) in enumerate(_stream(seed + 9, 1500)):
        ts.update(key, f"pool.{i % 3}", f"1.{i % 17:x}", b, t / 1e6)
    before = ts.dump()
    ts.set_k(3)
    ts.enabled = False
    ts.update("client.x", "pool.9", "9.0", 1, 0.1)
    quant = [mod.hist_quantile(list(range(10)), q)
             for q in (0.0, 0.5, 0.99, 1.0)]
    return (dumps, [sk.min_count() for sk in sks], merged, ranks, before,
            ts.dump(), quant, mod.merge_sketches([]))


def test_topk_dumps_merges_and_ranks_match():
    ref = _sketches(RK, 17)
    port = _sketches(PK, 17)
    assert json.dumps(port, sort_keys=True) == json.dumps(ref,
                                                          sort_keys=True)
    assert ref[1] == [m for m in ref[1] if m > 0]     # all saturated


# -- op tracker ---------------------------------------------------------------

def _track(mod, monkeypatch):
    monkeypatch.setattr(mod, "time", pinned_time(start=100.0, step=0.25))
    tr = mod.OpTracker(history_size=3, complaint_time=1.0,
                       history_duration=4.0)
    ops = [tr.create_request(f"osd_op(write obj{i})") for i in range(5)]
    out = []
    for i, op in enumerate(ops):
        op.mark_event("queued")
        if i % 2:
            op.mark_event("started")
    out.append(tr.dump_ops_in_flight())
    out.append([op.description for op in tr.get_slow_ops()])
    out.append(tr.slow_summary())
    for op in ops[:4]:
        op.finish()
    out.append(tr.dump_historic_ops())
    out.append(tr.dump_historic_ops_by_duration())
    out.append(tr.dump_ops_in_flight())
    out.append(tr.slow_summary())
    return out


def test_op_tracker_dumps_match_under_a_fake_clock(monkeypatch):
    ref = _track(RT, monkeypatch)
    port = _track(PT, monkeypatch)
    assert port == ref
    assert ref[0]["num_ops"] == 5 and ref[3]["num_ops"] >= 1


# -- CephContext --------------------------------------------------------------

def _context_replies(mod, builder):
    ctx = mod.CephContext("leafd")
    ctx.start_service_threads()
    try:
        pc = (builder("sub").add_u64_counter("n").add_u64("q")
              .add_time_avg("lat").create_perf_counters())
        pc.inc("n", 4)
        pc.set("q", 2)
        pc.tinc("lat", 0.5)
        ctx.perf.add(pc)
        sock = ctx.admin.path
        out = [admin_command(sock, "version"),
               admin_command(sock, "perf dump"),
               admin_command(sock, "perf schema"),
               admin_command(sock, "config show"),
               admin_command(sock, "config get",
                             var="osd_pool_default_size"),
               admin_command(sock, "config set",
                             var="osd_pool_default_size", val="5"),
               admin_command(sock, "config get",
                             var="osd_pool_default_size"),
               admin_command(sock, "config diff"),
               sorted(admin_command(sock, "help")),
               admin_command(sock, "nonsense")]
        ctx.log.dout("osd", 20, "not gathered")
        ctx.log.set_level("osd", 0, gather=9)
        ctx.log._sink = io.StringIO()
        ctx.log.dout("osd", 9, "gathered")
        out.append(admin_command(sock, "log dump"))
        return sock, out
    finally:
        ctx.shutdown()


def test_ceph_context_admin_replies_match():
    rsock, ref = _context_replies(RC, RPCB)
    psock, port = _context_replies(PC, PPCB)
    # the socket path is each package's own: the port's starts
    # ceph_tpu_torch-, so both contexts of one name coexist in one process
    assert rsock != psock and "ceph_tpu_torch-leafd-" in psock
    assert port == ref
    assert ref[1]["sub"]["n"] == 4 and ref[6]["osd_pool_default_size"] == 5
    assert ref[-1] == {"dumped": 1}
