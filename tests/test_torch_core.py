"""The port's core services (``ceph_tpu_torch.core``) against ceph_tpu's:
the option table, ``ConfigProxy``, perf counters, the threading
primitives and the tracer with its two exports.  Pure host code: the
same calls on both sides must give equal results (ids and clock
readings aside, which are normalised)."""

import random
import threading
import time

import pytest

from ceph_tpu.core import config as j_config
from ceph_tpu.core import options as j_options
from ceph_tpu.core import perf_counters as j_perf
from ceph_tpu.core import threading_utils as j_threading
from ceph_tpu.core import tracer as j_tracer
from ceph_tpu_torch.core import config as p_config
from ceph_tpu_torch.core import mempool as p_mempool
from ceph_tpu_torch.core import options as p_options
from ceph_tpu_torch.core import perf_counters as p_perf
from ceph_tpu_torch.core import threading_utils as p_threading
from ceph_tpu_torch.core import tracer as p_tracer
from ceph_tpu_torch.core.device_profiler import DeviceProfiler

def _option_row(o):
    return (o.name, o.type.__name__, o.default, o.desc, o.level.value,
            o.min, o.max, tuple(o.enum_allowed), tuple(o.see_also))


def test_build_options_equal_option_for_option():
    j = [_option_row(o) for o in j_options.build_options()]
    p = [_option_row(o) for o in p_options.build_options()]
    assert p == j
    names = {r[0] for r in p}
    for key in ("osd_batch_flush_ms", "osd_recovery_batch_max_ops",
                "osd_compress_segment_bytes", "osd_wal_sync_mode",
                "tracer_sampling_rate", "tracer_span_budget",
                "tracer_tail_slow_ms", "jaeger_tracing_enable"):
        assert key in names


@pytest.mark.parametrize("value", [-1, 0.5, "2.5", "x", 1e12])
def test_validators_equal(value):
    """Every option's validator accepts and refuses the same values with
    the same message."""
    def verdicts(mod_cfg, mod_opt):
        out = []
        for o in mod_opt.build_options():
            try:
                out.append(("ok", o.validate(value)))
            except mod_cfg.ConfigError as e:
                out.append(("err", str(e)))
        return out
    assert verdicts(p_config, p_options) == verdicts(j_config, j_options)


def _config_script(cfg_mod, opt_mod, tmp_path):
    """One sequence of config calls; returns everything observable."""
    cfg = cfg_mod.ConfigProxy(opt_mod.build_options())
    seen = []
    cfg.add_observer("osd_batch_flush_ms",
                     lambda n, v: seen.append((n, v)))
    cfg.add_observer("osd_wal_sync_mode",
                     lambda n, v: seen.append((n, v)))
    out = [cfg.get("osd_batch_flush_ms"), cfg.source_of("osd_batch_max_ops")]
    conf = tmp_path / "ceph.conf"
    conf.write_text("[global]\nosd batch flush ms = 2.5  # window\n"
                    "osd_batch_max_ops = 16\nunknown_key = 3\n")
    cfg.load_file(str(conf))
    cfg.set("osd_batch_flush_ms", "7", "mon")
    cfg.set("osd_batch_flush_ms", 7.0, "env")        # no change: no call
    cfg.injectargs("--osd-wal-sync-mode always --osd_batch_max_ops=32")
    cfg.rm("osd_wal_sync_mode", "override")
    out += [cfg.get("osd_batch_flush_ms"), cfg.source_of("osd_batch_flush_ms"),
            cfg.get("osd_batch_max_ops"), cfg.diff(),
            cfg.help("osd_wal_sync_mode"), len(cfg.keys())]
    errors = []
    for call in (lambda: cfg.set("osd_batch_max_ops", 0),
                 lambda: cfg.set("osd_wal_sync_mode", "sometimes"),
                 lambda: cfg.set("tracer_sampling_rate", 1.5),
                 lambda: cfg.set("osd_batch_max_ops", "many"),
                 lambda: cfg.set("no_such_option", 1),
                 lambda: cfg.set("osd_batch_max_ops", 1, "default"),
                 lambda: cfg.injectargs("osd_batch_max_ops 3"),
                 lambda: cfg.injectargs("--osd_batch_max_ops"),
                 lambda: cfg.register(cfg._schema["mon_lease"])):
        try:
            call()
            errors.append(None)
        except cfg_mod.ConfigError as e:
            errors.append(str(e))
    return out, seen, errors


def test_config_proxy_equal(tmp_path):
    p = _config_script(p_config, p_options, tmp_path)
    j = _config_script(j_config, j_options, tmp_path)
    assert p == j
    out, seen, errors = p
    assert seen == [("osd_batch_flush_ms", 2.5), ("osd_batch_flush_ms", 7.0),
                    ("osd_wal_sync_mode", "always"),
                    ("osd_wal_sync_mode", "batch")]
    assert None not in errors


def _perf_script(mod):
    coll = mod.PerfCountersCollection()
    for name in ("osd.0", "osd.1"):
        b = mod.PerfCountersBuilder(name)
        b.add_u64_counter("op", "ops").add_u64("queue", "depth")
        b.add_time_avg("lat", "latency").add_histogram(
            "hist", "sizes", x_buckets=8, y_buckets=2)
        coll.add(b.create_perf_counters())
    pc = coll._loggers["osd.0"]
    pc.inc("op"), pc.inc("op", 4), pc.set("queue", 9), pc.dec("queue", 2)
    pc.tinc("lat", 0.25), pc.tinc("lat", 0.5)
    for x, y in ((0, 0), (1, 0), (300, 3), (10 ** 9, 1)):
        pc.hinc("hist", x, y)
    coll.remove("osd.1")
    with pytest.raises(AssertionError):
        pc.dec("op")
    return (coll.dump(), coll.schema(), pc.dump_histograms(),
            pc.get("op"), pc.avg("lat"))


def test_perf_counters_collection_equal():
    assert _perf_script(p_perf) == _perf_script(j_perf)


def test_profiler_feeds_perf_counters():
    """The device profiler's perf sink, as ceph_tpu's daemon builds it."""
    b = p_perf.PerfCountersBuilder("osd.0")
    b.add_u64_counter("device_launches").add_time_avg("device_dispatch")
    b.add_time_avg("device_compute").add_u64_counter("device_bytes_in")
    b.add_u64_counter("device_bytes_out").add_histogram("device_launch_hist")
    pc = b.create_perf_counters()
    prof = DeviceProfiler("osd.0", enabled=True, perf=pc)
    for n in (100, 200):
        prof.start("k", bytes_in=n).finish(bytes_out=n // 2)
    d = pc.dump()["osd.0"]
    assert d["device_launches"] == 2 and d["device_bytes_in"] == 300
    assert d["device_bytes_out"] == 150
    assert d["device_dispatch"]["avgcount"] == 2
    assert sum(map(sum, d["device_launch_hist"]["values"])) == 2
    assert len(prof.samples()) == 2
    # a profiler without device counters records all the same
    bare = DeviceProfiler("x", enabled=True,
                          perf=p_perf.PerfCounters("x"))
    bare.start("k").finish()
    assert bare.aggregate()["totals"]["launches"] == 1


def test_mempool():
    p = p_mempool.pool("test::torch_core")
    p.adjust(100, 2), p.adjust(-40, -1)
    assert p_mempool.dump_mempools()["test::torch_core"] == \
        {"bytes": 60, "items": 1}


def _timer_order(mod):
    timer = mod.SafeTimer("t")
    order, done = [], threading.Event()
    base = time.monotonic()
    for delay, tag in ((0.06, "c"), (0.02, "a"), (0.04, "b")):
        timer.add_event_at(base + delay, lambda t=tag: order.append(t))
    tok = timer.add_event_after(0.2, lambda: order.append("cancelled"))
    assert timer.cancel_event(tok) and not timer.cancel_event(10 ** 6)
    timer.add_event_after(0.25, done.set)
    assert done.wait(10)
    timer.shutdown()
    fin = mod.Finisher("f")
    seen = []
    for i in range(50):
        fin.queue(lambda i=i: seen.append(i))
    fin.queue(lambda: 1 / 0)            # a raising callback: survived
    fin.queue(lambda: seen.append("last"))
    assert fin.wait_for_empty(10)
    fin.shutdown()
    return order, seen


def test_safe_timer_and_finisher_ordering():
    p, j = _timer_order(p_threading), _timer_order(j_threading)
    assert p == j
    assert p == (["a", "b", "c"], list(range(50)) + ["last"])


def test_throttle_and_sharded_pool():
    for mod in (p_threading, j_threading):
        th = mod.Throttle("t", 4)
        assert th.get(3) and th.get_or_fail(1) and not th.get_or_fail(1)
        assert th.past_midpoint() and not th.get(2, timeout=0.01)
        th.put(4)
        assert th.current == 0 and th.get(9)       # oversized alone
        with pytest.raises(ValueError):
            th.put(10)
        pool = mod.ShardedThreadPool(num_shards=3)
        seen = {k: [] for k in range(6)}
        for i in range(60):
            pool.queue(i % 6, lambda i=i: seen[i % 6].append(i))
        assert pool.wait_for_empty(10)
        pool.shutdown()
        assert all(v == list(range(k, 60, 6)) for k, v in seen.items())


# -- tracer ---------------------------------------------------------------

class _Clock:
    """A settable ``time`` stand-in for the tracer modules."""

    def __init__(self):
        self.now = 1000.25

    def monotonic(self):
        return self.now

    def time(self):
        return 1.7e9 + self.now


@pytest.fixture
def clock(monkeypatch):
    c = _Clock()
    monkeypatch.setattr(j_tracer, "time", c)
    monkeypatch.setattr(p_tracer, "time", c)
    return c


def _normalise(spans):
    """Ids → labels in order of first appearance; times kept (the clock
    is shared and fake)."""
    names = {}

    def lab(x):
        if x is None:
            return None
        return names.setdefault(x, f"id{len(names)}")

    out = []
    for s in spans:
        d = dict(s)
        d["trace_id"], d["span_id"] = lab(s["trace_id"]), lab(s["span_id"])
        d["parent_id"] = lab(s["parent_id"])
        d["links"] = [{"t": lab(l["t"]), "s": lab(l["s"])}
                      for l in s["links"]]
        out.append(d)
    return out


class _Perf:
    def __init__(self):
        self.calls = []

    def tinc(self, name, v):
        if not name.startswith("device"):
            raise KeyError(name)
        self.calls.append((name, v))


def _tracer_script(mod, clock, rng_seed, monkeypatch):
    if mod is p_tracer:
        kw = {"rng": random.Random(rng_seed)}
    else:
        # ceph_tpu's tracer draws from the module-level generator: give
        # it its own, so no other thread's draws can interleave
        monkeypatch.setattr(j_tracer, "random", random.Random(rng_seed))
        kw = {}
    perf = _Perf()
    tr = mod.Tracer(daemon="osd.0", ring_size=64, enabled=True, perf=perf,
                    sampling_rate=0.5, tail_slow_s=0.5, **kw)
    admitted = [tr.start_span("root") is not None for _ in range(40)]
    tr.clear()
    tr.sampling_rate = 1.0
    root = tr.start_span("osd_op", tags={"layer": "osd"})
    clock.now += 0.125
    child = tr.start_span("gf_encode", parent=root,
                          tags={"layer": "device", "bytes": 4096})
    child.event("queued")
    wire = tr.start_span("sub_write", parent=root.ctx())
    flush = tr.start_span("megabatch_flush", tags={"layer": "device"})
    flush.add_link(child), flush.add_link(wire.ctx()), flush.add_link(None)
    clock.now += 0.25
    for s in (flush, wire, child):
        s.finish()
    child.finish()                      # idempotent
    clock.now += 0.5
    root.finish()                       # 0.875 s > tail_slow_s: pinned
    err = tr.start_span("failed_op")
    err.set_tag("error", "EIO")
    err.finish()
    tr.span_budget = 3
    tr.tail_slow_s = 0.0
    budget = [tr.start_span("b") is not None for _ in range(5)]
    clock.now += 1.0
    budget.append(tr.start_span("b2") is not None)
    tr.enabled = False
    off = tr.start_span("off")
    return (admitted, budget, off, len(tr), tr.dump(),
            tr.spans_for(root.trace_id), perf.calls)


def test_tracer_equal(clock, monkeypatch):
    start = clock.now
    p = _tracer_script(p_tracer, clock, 11, monkeypatch)
    clock.now = start
    j = _tracer_script(j_tracer, clock, 11, monkeypatch)
    assert p[:4] == j[:4]
    assert _normalise(p[4]) == _normalise(j[4])
    assert _normalise(p[5]) == _normalise(j[5])
    assert p[6] == j[6]
    admitted, budget, off, n, spans, tree, _ = p
    assert 5 < sum(admitted) < 35       # head sampling really drew
    assert budget == [True, True, True, False, False, True]
    assert off is None
    by_name = {s["name"]: s for s in spans}
    flush = by_name["megabatch_flush"]
    assert [l["s"] for l in flush["links"]] == [
        by_name["gf_encode"]["span_id"], by_name["sub_write"]["span_id"]]
    assert {s["name"] for s in tree} == {"osd_op", "gf_encode", "sub_write"}


def test_tracer_sampling_replays_from_a_seed(clock):
    def draws(seed):
        tr = p_tracer.Tracer(enabled=True, sampling_rate=0.3,
                             rng=random.Random(seed))
        return [tr.start_span("r") is not None for _ in range(64)]
    assert draws(5) == draws(5) and draws(5) != draws(6)


def test_trace_exports_equal(clock, monkeypatch):
    p_out = _tracer_script(p_tracer, clock, 3, monkeypatch)[4]
    spans = _normalise(p_out)
    assert p_tracer.chrome_trace(spans) == j_tracer.chrome_trace(spans)

    def untimed(doc):
        for rs in doc["resourceSpans"]:
            for sc in rs["scopeSpans"]:
                for s in sc["spans"]:
                    s.pop("startTimeUnixNano"), s.pop("endTimeUnixNano")
                    for e in s.get("events", []):
                        e.pop("timeUnixNano")
        return doc
    assert untimed(p_tracer.otlp_trace(spans)) == \
        untimed(j_tracer.otlp_trace(spans))
