"""OSD daemon — boot, map consumption, PG ownership, heartbeats.

The port's copy of ``ceph_tpu.osd.daemon``.  The daemon runs its device
work on ``device`` (``None`` → the card, raising without one;
``"cpu"`` runs the kernels' plain versions): its ``BatchEngine``, its
PGs' erasure codes and its ``ScrubEngine`` all take it.  The engine's
mesh (``osd_recovery_batch_mesh``) is not ported: the port has one card
(ROADMAP's multi-device item), and setting it raises.

Reference behavior re-created (``src/osd/OSD.{h,cc}``; SURVEY.md §3.5,
§4.6):

- **boot**: authenticate to the mons, announce ``MOSDBoot`` (address
  included) and wait to appear up in the committed OSDMap;
- **map consumption**: subscribe to osdmap pushes; every epoch advance
  recomputes this OSD's PG set via ``pg_to_up_acting_osds`` and drives
  each PG's peering state machine (``OSD::handle_osd_map`` →
  ``advance_pg``);
- **dispatch**: client ops and peer sub-ops are routed to the owning
  PG under the daemon lock (the sharded op queue collapses to one
  lock at this scale — the device data plane, not this control loop,
  is the throughput path);
- **heartbeats**: ping PG peers on a timer; silence beyond the grace
  window produces ``MOSDFailure`` reports to the mon cluster
  (``OSD::handle_osd_ping`` / ``send_failures``), which marks OSDs
  down and re-triggers peering everywhere.
"""

from __future__ import annotations

import json
import os
import threading
import time

from ..core.admin_socket import AdminSocket, default_path
from ..core.config import ConfigProxy
from ..core.options import build_options
from ..core.perf_counters import PerfCountersBuilder
from ..core.threading_utils import SafeTimer
from ..core.tracked_op import OpTracker
from ..mon import messages as MM
from ..mon.client import MonClient
from ..msg import Dispatcher, EntityAddr, Messenger
from ..os_store import MemStore, WALStore
from ..os_store.objectstore import Transaction
from ..tools.osdmaptool import shared_osdmap_from_dict
from ..utils.device import resolve_device
from . import messages as M
from .osdmap import OSDMap, PGid
from .pg import PG, ECBackend, ReplicatedBackend, _WRITE_OPS
from .scheduler import (CLIENT, PEERING, RECOVERY, SCRUB, SUBOP,
                        make_op_queue)


# message type → scheduler class (reference op_scheduler_class
# assignment in OSD::enqueue_op).  NB: MOSDPGBackfillPrune rides the
# SUBOP class so it stays FIFO with the live rep-ops whose objects it
# must never prune.
_SCHED_CLASS = {
    M.MOSDOp: CLIENT,
    M.MWatchNotifyAck: CLIENT,
    M.MOSDRepOp: SUBOP,
    M.MOSDRepOpReply: SUBOP,
    M.MOSDECSubOpWrite: SUBOP,
    M.MOSDECSubOpWriteReply: SUBOP,
    M.MOSDECSubOpRead: SUBOP,
    M.MOSDECSubOpReadReply: SUBOP,
    M.MOSDPGBackfillPrune: SUBOP,
    M.MOSDPGQuery: PEERING,
    M.MOSDPGNotify: PEERING,
    M.MOSDPGLog: PEERING,
    M.MOSDPGPush: RECOVERY,
    M.MOSDPGPushReply: RECOVERY,
    M.MOSDPGPull: RECOVERY,
    M.MOSDRepScrub: SCRUB,
    M.MOSDRepScrubMap: SCRUB,
    M.MOSDScrubCommand: SCRUB,
}


def _build_osd_perf(name: str):
    """The OSD's counter set (reference ``OSD::create_logger`` —
    l_osd_op & friends, trimmed to the paths this OSD has)."""
    b = PerfCountersBuilder(name)
    b.add_u64_counter("op", "client operations")
    b.add_u64_counter("op_r", "client read operations")
    b.add_u64_counter("op_w", "client write operations")
    b.add_time_avg("op_latency", "client op latency")
    b.add_u64_counter("subop", "replica/shard sub-operations")
    b.add_u64_counter("recovery_ops", "objects recovered/pushed")
    b.add_u64_counter("scrub_errors_found", "scrub inconsistencies")
    b.add_u64_counter("scrub_errors_repaired",
                      "scrub inconsistencies confirmed repaired")
    b.add_u64_counter("scrub_objects_scanned",
                      "objects digested by deep scrub")
    b.add_u64_counter("scrub_digest_bytes",
                      "payload bytes CRC-32C'd by deep scrub")
    b.add_u64_counter("scrub_parity_recheck_bytes",
                      "EC data bytes re-encoded by parity recheck")
    b.add_u64_counter("scrubs_scheduled",
                      "periodic scrubs started by the tick")
    b.add_u64("numpg", "placement groups hosted")
    # per-layer span durations (tracer perf sink; ceph_*_span_duration
    # in the exporter) — zero until jaeger_tracing_enable is on
    b.add_time_avg("osd_span_duration", "OSD op span duration")
    b.add_time_avg("wire_span_duration", "messenger wire span duration")
    b.add_time_avg("device_span_duration",
                   "device kernel span duration")
    # log2 op-latency distribution in microseconds (reference
    # osd_op_latency histograms; `perf histogram dump`)
    b.add_histogram("op_latency_histogram",
                    "client op latency distribution (us, log2 buckets)")
    # device-plane launch accounting (device_profiler sink) — zero
    # until device_profiling_enable is on
    b.add_u64_counter("op_in_bytes", "client write payload bytes")
    b.add_u64_counter("device_launches", "device kernel launches")
    b.add_time_avg("device_dispatch",
                   "host-side dispatch time per launch")
    b.add_time_avg("device_compute",
                   "device compute time per launch")
    b.add_u64_counter("device_bytes_in", "bytes shipped to device")
    b.add_u64_counter("device_bytes_out", "bytes fetched from device")
    b.add_histogram("device_launch_hist",
                    "launch wall time distribution (us, log2 buckets)")
    return b.create_perf_counters()


def _no_mesh(_name, value):
    """``osd_recovery_batch_mesh`` turned on: the port's engine has no
    mesh, so say so instead of ignoring the setting."""
    if value:
        raise NotImplementedError(
            "osd_recovery_batch_mesh: the port runs on one card; the "
            "mesh waits for ROADMAP's multi-device item")


class OSDaemon(Dispatcher):
    def __init__(self, whoami: int, monmap, store=None, *,
                 heartbeat_interval: float = 0.5,
                 heartbeat_grace: float = 3.0,
                 config: ConfigProxy | None = None,
                 admin_socket_path: str | None = None,
                 auth=None, device=None):
        self.whoami = whoami
        self.monmap = monmap
        self.device = resolve_device(device)
        # every knob below reads through the typed option table
        # (reference md_config_t; ctor kwargs land as overrides so
        # `config set` / injectargs can retune a live daemon)
        self.config = config or ConfigProxy(build_options())
        # ctor kwargs are the TEST-friendly fast defaults, but an
        # explicit override already present in a caller-supplied
        # config (MiniCluster osd_config=...) wins — do not clobber it
        for key, val in (("osd_heartbeat_interval", heartbeat_interval),
                         ("osd_heartbeat_grace", heartbeat_grace)):
            if self.config.source_of(key) == "default":
                self.config.set(key, val)
        self.perf = _build_osd_perf(f"osd.{whoami}")
        self.op_tracker = OpTracker(
            history_size=int(self.config.get("op_history_size") or 20),
            complaint_time=float(
                self.config.get("op_complaint_time") or 30.0),
            history_duration=float(
                self.config.get("osd_op_history_duration") or 600.0))
        self.config.add_observer(
            "op_complaint_time",
            lambda _n, v: setattr(self.op_tracker, "complaint_time",
                                  float(v)))
        self.config.add_observer(
            "osd_op_history_duration",
            lambda _n, v: setattr(self.op_tracker, "history_duration",
                                  float(v)))
        # op tracing: spans adopted from the client ctx riding MOSDOp;
        # the perf sink feeds the *_span_duration counters above
        from ..core.tracer import Tracer
        self.tracer = Tracer(
            daemon=f"osd.{whoami}",
            ring_size=int(self.config.get("tracer_ring_size") or 4096),
            enabled=bool(self.config.get("jaeger_tracing_enable")),
            perf=self.perf,
            sampling_rate=float(
                self.config.get("tracer_sampling_rate") or 1.0),
            span_budget=int(
                self.config.get("tracer_span_budget") or 0))
        self.config.add_observer(
            "jaeger_tracing_enable",
            lambda _n, v: setattr(self.tracer, "enabled", bool(v)))
        self.config.add_observer(
            "tracer_sampling_rate",
            lambda _n, v: setattr(self.tracer, "sampling_rate",
                                  float(v)))
        self.config.add_observer(
            "tracer_span_budget",
            lambda _n, v: setattr(self.tracer, "span_budget", int(v)))
        self.config.add_observer(
            "tracer_tail_slow_ms",
            lambda _n, v: setattr(self.tracer, "tail_slow_s",
                                  float(v) / 1000.0))
        self.tracer.tail_slow_s = float(
            self.config.get("tracer_tail_slow_ms") or 0.0) / 1000.0
        # workload attribution: client/pool/pg space-saving top-K
        # sketches fed from the op-reply path; dumps ride the
        # osd_stats beacon and merge cluster-wide in the mgr
        # (`ceph osd top`)
        from ..core.topk import TopKSet
        self.topk = TopKSet(
            k=int(self.config.get("osd_topk_k") or 16),
            enabled=bool(self.config.get("osd_topk_enable")))
        self.config.add_observer(
            "osd_topk_enable",
            lambda _n, v: setattr(self.topk, "enabled", bool(v)))
        self.config.add_observer(
            "osd_topk_k", lambda _n, v: self.topk.set_k(int(v)))
        # metric→trace exemplar window on the op-latency histogram
        _lat_hist = self.perf._counters["op_latency_histogram"].hist
        _lat_hist.exemplar_window = float(
            self.config.get("osd_exemplar_window_s") or 60.0)
        self.config.add_observer(
            "osd_exemplar_window_s",
            lambda _n, v: setattr(_lat_hist, "exemplar_window",
                                  float(v)))
        # device-plane launch profiler: PG device call sites bind() it
        # so launches attribute to this daemon; aggregates ride the
        # osd_stats beacon into the mgr telemetry spine
        from ..core.device_profiler import DeviceProfiler
        self.profiler = DeviceProfiler(
            name=f"osd.{whoami}",
            ring_size=int(
                self.config.get("device_profiler_ring_size") or 1024),
            enabled=bool(self.config.get("device_profiling_enable")),
            perf=self.perf)
        self.config.add_observer(
            "device_profiling_enable",
            lambda _n, v: self.profiler.set_enabled(bool(v)))
        self.config.add_observer(
            "device_profiler_ring_size",
            lambda _n, v: self.profiler.set_ring_size(int(v)))
        # coalescing device data plane: PG write paths submit encode/
        # digest work here instead of launching per-op; the deadline
        # timer rides SafeTimer (resolved lazily — the timer is
        # constructed below), megabatch launches attribute to the
        # device profiler, flush spans link member op spans
        from .batch_engine import BatchEngine
        _no_mesh("osd_recovery_batch_mesh",
                 self.config.get("osd_recovery_batch_mesh"))
        self.batch_engine = BatchEngine(
            name=f"osd.{whoami}", device=self.device,
            enabled=bool(self.config.get("osd_batch_enable")),
            max_bytes=int(
                self.config.get("osd_batch_max_bytes") or (8 << 20)),
            max_ops=int(self.config.get("osd_batch_max_ops") or 64),
            flush_ms=float(
                self.config.get("osd_batch_flush_ms") or 0.0),
            recon_enabled=bool(
                self.config.get("osd_recovery_batch_enable")),
            recon_max_bytes=int(
                self.config.get("osd_recovery_batch_max_bytes")
                or (8 << 20)),
            recon_max_ops=int(
                self.config.get("osd_recovery_batch_max_ops") or 64),
            recon_flush_ms=float(
                self.config.get("osd_recovery_batch_flush_ms") or 0.0),
            comp_enabled=bool(
                self.config.get("osd_compress_batch_enable")),
            comp_max_bytes=int(
                self.config.get("osd_compress_batch_max_bytes")
                or (8 << 20)),
            comp_max_ops=int(
                self.config.get("osd_compress_batch_max_ops") or 64),
            comp_flush_ms=float(
                self.config.get("osd_compress_batch_flush_ms")
                or 0.0),
            comp_segment_bytes=int(
                self.config.get("osd_compress_segment_bytes")
                or (1 << 20)),
            bucket_floor=int(
                self.config.get("osd_batch_bucket_floor") or 32),
            on_lane_flush=self._on_lane_flush,
            schedule=lambda d, fn: self.timer.add_event_after(d, fn),
            profiler=self.profiler, tracer=self.tracer)
        for _opt, _attr, _cast in (
                ("osd_batch_enable", "enabled", bool),
                ("osd_batch_max_bytes", "max_bytes", int),
                ("osd_batch_max_ops", "max_ops", int),
                ("osd_batch_flush_ms", "flush_ms", float),
                ("osd_recovery_batch_enable", "recon_enabled", bool),
                ("osd_recovery_batch_max_bytes", "recon_max_bytes",
                 int),
                ("osd_recovery_batch_max_ops", "recon_max_ops", int),
                ("osd_recovery_batch_flush_ms", "recon_flush_ms",
                 float),
                ("osd_compress_batch_enable", "comp_enabled", bool),
                ("osd_compress_batch_max_bytes", "comp_max_bytes",
                 int),
                ("osd_compress_batch_max_ops", "comp_max_ops", int),
                ("osd_compress_batch_flush_ms", "comp_flush_ms",
                 float),
                ("osd_compress_segment_bytes", "comp_segment_bytes",
                 int),
                ("osd_batch_bucket_floor", "bucket_floor", int)):
            self.config.add_observer(
                _opt, lambda _n, v, _a=_attr, _c=_cast: setattr(
                    self.batch_engine, _a, _c(v)))
        self.config.add_observer("osd_recovery_batch_mesh", _no_mesh)
        # deep-scrub digests and parity rechecks of this daemon's PGs
        from ..scrub.engine import ScrubEngine
        self.scrub_engine = ScrubEngine(device=self.device)
        # recovery pacing: PGs read this live per backfill kick — an
        # autotuner `config set` retunes the next batch, no restart
        self.recovery_max_active = int(
            self.config.get("osd_recovery_max_active") or 8)
        self.config.add_observer(
            "osd_recovery_max_active",
            lambda _n, v: setattr(self, "recovery_max_active",
                                  max(1, int(v))))
        self.admin_socket = AdminSocket(
            admin_socket_path or default_path(f"osd.{whoami}"))
        self._register_admin_commands()
        self.store = store if store is not None else MemStore(
            name=f"osd.{whoami}")
        # durability wiring: the batch engine nudges the WAL group-
        # commit thread at each megabatch flush boundary (one fsync
        # covers the whole flush), and a failed append/fsync degrades
        # the daemon instead of crashing its op thread
        self._store_error: str | None = None
        self.batch_engine.store_kick = getattr(self.store, "kick", None)
        if isinstance(self.store, WALStore):
            self.store.on_error = self._on_store_error
            self.config.add_observer(
                "osd_wal_sync_mode",
                lambda _n, v: self.store.set_sync_mode(v))
            self.config.add_observer(
                "osd_wal_compact_min_records",
                lambda _n, v: setattr(self.store,
                                      "compact_min_records", int(v)))
        # black-box flight recorder: a crash-surviving sidecar next to
        # the WAL journaling the observability tails (spans/clog/perf/
        # profiler/injector), readable offline from a dead process
        self.flight_recorder = None
        self._crash_report_id: str | None = None
        store_path = getattr(self.store, "_path", None)
        if store_path and bool(self.config.get("osd_blackbox_enable")):
            from ..core.flight_recorder import FlightRecorder
            self.flight_recorder = FlightRecorder(
                store_path + ".bbox", daemon=f"osd.{whoami}",
                max_bytes=int(
                    self.config.get("osd_blackbox_max_bytes")),
                tail_events=int(
                    self.config.get("osd_blackbox_tail_events")))
            self.store.flight_recorder = self.flight_recorder
            self.config.add_observer(
                "osd_blackbox_enable",
                lambda _n, v: setattr(self.flight_recorder,
                                      "enabled", bool(v)))
        self.auth = auth
        # fault fabric: the messenger's injector is built from the
        # ms_inject_* options and stays retunable while the daemon
        # runs — `config set`/injectargs feed the observers below,
        # `fault *` admin commands poke the policy table directly
        from ..msg.fault import injector_from_config
        self.msgr = Messenger(
            f"osd.{whoami}",
            inject_socket_failures=int(
                self.config.get("ms_inject_socket_failures") or 0),
            fault_injector=injector_from_config(self.config),
            **(auth.msgr_kwargs(f"osd.{whoami}") if auth else {}))
        self.config.add_observer(
            "ms_inject_socket_failures",
            lambda _n, v: setattr(self.msgr, "inject_socket_failures",
                                  int(v)))
        for _opt, _knob in (("ms_inject_drop_prob", "drop"),
                            ("ms_inject_delay_prob", "delay"),
                            ("ms_inject_delay_ms", "delay_ms"),
                            ("ms_inject_dup_prob", "dup"),
                            ("ms_inject_reorder_prob", "reorder"),
                            ("ms_inject_reorder_ms", "reorder_ms")):
            self.config.add_observer(
                _opt, lambda _n, v, _k=_knob: self.msgr.faults.set_rule(
                    "*", "*", **{_k: float(v)}))
        self.msgr.add_dispatcher(self)
        self.msgr.tracer = self.tracer
        self.monc = MonClient(monmap, entity=f"osd.{whoami}",
                              auth=auth)
        # cluster log: ring + batched MLog uplink, flushed on the tick
        from ..core.log_client import LogClient
        self.clog = LogClient(f"osd.{whoami}", send_fn=self.monc.send)
        self._slow_ops_logged = 0      # clog on 0→N transitions
        self._scrub_errors_logged = 0
        self.osdmap = OSDMap()
        self.pgs: dict[PGid, PG] = {}
        # interval history per PG, built by walking EVERY map epoch in
        # order (the mon feeds the full range on a start>0
        # subscription).  closed intervals: {"first","last","acting",
        # "primary","maybe_went_rw"} — reference PastIntervals built
        # by check_new_interval over the fetched map range.
        self.pg_intervals: dict[PGid, list[dict]] = {}
        self._open_intervals: dict[PGid, dict] = {}
        self.lock = threading.RLock()
        self.running = False
        self.addr: EntityAddr | None = None
        self._peer_cons: dict[int, object] = {}
        self._hb_interval = self.config.get("osd_heartbeat_interval")
        self._hb_grace = self.config.get("osd_heartbeat_grace")
        self.config.add_observer(
            "osd_heartbeat_interval",
            lambda _n, v: setattr(self, "_hb_interval", v))
        self.config.add_observer(
            "osd_heartbeat_grace",
            lambda _n, v: setattr(self, "_hb_grace", v))
        self._hb_last: dict[int, float] = {}
        self._hb_reported: dict[int, float] = {}  # osd → last report time
        self._stats_interval = max(1.0, heartbeat_interval * 2)
        self._stats_last = 0.0
        self.timer = SafeTimer(f"osd.{whoami}-tick")
        self._tick_token = None
        # the op scheduler (reference ShardedOpWQ + OpScheduler):
        # dispatch classifies work, one worker drains by weighted
        # priority (wpq) or dmclock QoS tags (mclock) per
        # `osd_op_queue`, so recovery/scrub storms can't bury client
        # I/O (heartbeats bypass the queue entirely — their latency
        # IS the failure detector)
        self.op_queue = make_op_queue(self.config)
        self._op_worker = threading.Thread(
            target=self._op_worker_loop, name=f"osd.{whoami}-opwq",
            daemon=True)

    def _register_admin_commands(self):
        """Live-introspection surface (reference AdminSocket hooks:
        `ceph daemon osd.N <cmd>`)."""
        a = self.admin_socket
        a.register("perf dump", lambda c: self.perf.dump(),
                   "dump perf counters")
        a.register("perf schema", lambda c: self.perf.schema(),
                   "perf counter schema")
        a.register("dump_ops_in_flight",
                   lambda c: self.op_tracker.dump_ops_in_flight(),
                   "in-flight client ops")
        a.register("dump_historic_ops",
                   lambda c: self.op_tracker.dump_historic_ops(),
                   "recently completed ops")
        a.register(
            "dump_historic_ops_by_duration",
            lambda c: self.op_tracker.dump_historic_ops_by_duration(),
            "recently completed ops, slowest first")
        a.register("perf histogram dump",
                   lambda c: self.perf.dump_histograms(),
                   "2-D log-bucket histogram counters")
        # op tracing surface (reference `dump_tracing` / blkin):
        # `trace start|stop` rides one registration — the dispatcher
        # hands the full prefix through, so parse the verb here
        # clock header for cross-process merging: span starts and
        # black-box stamps are this process's monotonic clock; readers
        # rebase them onto the wall clock with this pair (the same
        # alignment procs.write_ready stamps into readiness files)
        def _clock():
            return {"wall": time.time(), "mono": time.monotonic()}

        def _dump_tracing(c):
            spans = self.tracer.dump()
            if c.get("format") == "otlp":
                from ..core.tracer import otlp_trace
                return otlp_trace(spans)
            return {"enabled": self.tracer.enabled,
                    "num_spans": len(self.tracer),
                    "clock": _clock(),
                    "spans": spans}
        a.register("dump_tracing", _dump_tracing,
                   "collected spans (format=otlp for OTLP JSON)")

        def _trace_ctl(c):
            verb = c.get("prefix", "").split()[-1]
            if verb == "start":
                self.tracer.enabled = True
            elif verb == "stop":
                self.tracer.enabled = False
            elif verb == "clear":
                self.tracer.clear()
            else:
                return {"error": "usage: trace start|stop|clear"}
            return {"enabled": self.tracer.enabled}
        a.register("trace", _trace_ctl,
                   "trace start|stop|clear — toggle span collection")

        def _profiler_ctl(c):
            verb = c.get("prefix", "").split()[-1]
            if verb == "dump":
                d = self.profiler.dump()
                d["clock"] = _clock()
                return d
            if verb == "reset":
                self.profiler.reset()
                return {"success": "profiler reset"}
            return {"error": "usage: profiler dump|reset"}
        a.register("profiler", _profiler_ctl,
                   "profiler dump|reset — per-launch device profiles")

        def _blackbox(c):
            verb = c.get("prefix", "").split()[-1]
            fr = self.flight_recorder
            if fr is None:
                return {"enabled": False,
                        "error": "no black box (RAM store)"}
            if verb == "snap":
                self._blackbox_snap()
            return {"clock": _clock(), **fr.stats()}
        a.register("blackbox", _blackbox,
                   "blackbox dump|snap — flight-recorder state "
                   "(snap forces a snapshot now)")
        a.register("dump_batch_engine",
                   lambda c: self.batch_engine.dump(),
                   "coalescing data-plane counters + flush config")

        # workload attribution: per-OSD heavy-hitter sketches + the
        # metric→trace exemplars the mgr exporter attaches to
        # `_bucket` lines — both carry the clock pair so procs-mode
        # readers can rebase
        def _topk_dump(c):
            return {"enabled": self.topk.enabled,
                    "clock": _clock(), **self.topk.dump()}
        a.register("topk", _topk_dump,
                   "heavy-hitter sketches (clients/pools/pgs)")

        def _exemplar_dump(c):
            return {"clock": _clock(),
                    "exemplars": self._histogram_exemplars()}
        a.register("dump_exemplars", _exemplar_dump,
                   "slowest-op trace exemplars per histogram bucket")
        a.register("config show", lambda c: {
            k: self.config.get(k) for k in self.config.keys()},
            "effective configuration")
        a.register("config set", lambda c: (
            self.config.set(c["key"], c["value"]),
            {"success": f"{c['key']} = {self.config.get(c['key'])}"}
        )[1], "set a config override")
        a.register("config help", lambda c: self.config.help(c["key"]),
                   "option metadata")
        a.register("injectargs", lambda c: (
            self.config.injectargs(c.get("args", "")),
            {"success": self.config.diff()})[1],
            "apply '--key value ...' runtime overrides")
        from ..core.mempool import dump_mempools
        a.register("dump_mempools", lambda c: dump_mempools(),
                   "per-pool live allocation accounting")
        a.register("status", lambda c: {
            "whoami": self.whoami, "epoch": self.osdmap.epoch,
            "num_pgs": len(self.pgs),
            "state": "active" if self.running else "stopped"},
            "daemon status")
        a.register("dump_replay_stats", lambda c: {
            "replay_stats": getattr(self.store, "replay_stats", None),
            "wal_stats": dict(getattr(self.store, "wal_stats", {}))},
            "WAL mount-replay summary + append/sync counters")
        # fault fabric controls (handlers bind self.msgr lazily — the
        # messenger is constructed after this registration)
        _FAULT_KNOBS = ("drop", "delay", "delay_ms", "dup", "reorder",
                        "reorder_ms")
        a.register("fault show",
                   lambda c: self.msgr.faults.describe(),
                   "dump fault-injection policy table + seed")
        a.register("fault set", lambda c: self.msgr.faults.set_rule(
            c.get("src", "*"), c.get("dst", "*"),
            **{k: float(v) for k, v in c.items()
               if k in _FAULT_KNOBS}).to_dict(),
            "set per-peer-pair fault probabilities")
        a.register("fault partition", lambda c: (
            self.msgr.faults.partition(c["dst"], c.get("src", "*")),
            {"partitioned": f"{c.get('src', '*')}>{c['dst']}"})[1],
            "directed partition: blackhole sends to dst")
        a.register("fault heal", lambda c: (
            self.msgr.faults.heal(c.get("src"), c.get("dst")),
            {"healed": True})[1],
            "remove fault rules (all, or filtered by src/dst)")
        # SMART-style device health (reference: the OSD shells out to
        # smartctl; here synthetic counters steered by a DEV option so
        # devicehealth's scrape→predict→warn pipeline is testable).
        # Raw counters only: the verdict thresholds live in ONE place
        # (mgr devicehealth), never here
        a.register("smart", lambda c: {
            "devid": f"SYNTH-osd{self.whoami}",
            "media_errors": self.config.get(
                "osd_debug_smart_media_errors"),
            "temperature_c": 35,
        }, "device health metrics")

    # -- lifecycle ---------------------------------------------------------
    def start(self, wait_for_up: bool = True, timeout: float = 15.0):
        self.store.mount()
        rs = getattr(self.store, "replay_stats", None)
        if rs and not rs.get("clean_shutdown", True):
            tail = rs.get("tail") or {}
            note = (f"; dropped {tail.get('error')}"
                    if tail.get("status") != "clean" else "")
            self.clog.info(
                f"osd.{self.whoami} unclean shutdown detected: "
                f"replayed {rs.get('records', 0)} WAL records{note}")
        prior_crash = None
        if self.flight_recorder is not None:
            try:
                prior_crash = self.flight_recorder.open()
            except OSError:
                # an unwritable sidecar must not stop the daemon
                self.store.flight_recorder = None
                self.flight_recorder = None
        self.admin_socket.start()
        self.addr = self.msgr.bind()
        self.running = True
        if not self._op_worker.is_alive():
            self._op_worker.start()
        self.monc.on_osdmap = self._on_osdmap
        # subscribe from epoch 1: the full history replay rebuilds
        # pg_intervals (a revived OSD starts a fresh daemon object)
        self.monc.sub_want("osdmap", 1)
        self._send_boot()
        if wait_for_up:
            # re-send boot while waiting: the first MOSDBoot can race a
            # mon election (or land on a peon mid-forward) and be
            # dropped — the reference OSD re-queues boot on every map
            # update while still marked down (OSD::_send_boot / start_boot)
            deadline = time.monotonic() + timeout
            next_boot = time.monotonic() + 2.0
            while time.monotonic() < deadline:
                with self.lock:
                    if self.osdmap.is_up(self.whoami):
                        break
                if time.monotonic() >= next_boot:
                    self._send_boot()
                    next_boot = time.monotonic() + 2.0
                time.sleep(0.02)
            else:
                raise TimeoutError(f"osd.{self.whoami} never came up")
        if prior_crash is not None:
            # the previous incarnation died with its black box dirty:
            # post the synthesized report now that the mon is
            # reachable (reference: the ceph-crash agent posts on the
            # next boot, not at the moment of death)
            self._post_crash_report(prior_crash)
        self._tick_token = self.timer.add_event_after(
            self._hb_interval, self._tick)

    # -- black box / crash post-mortem -------------------------------------
    def _blackbox_snap(self):
        """One flight-recorder snapshot: the observability tails this
        daemon would want read back from its corpse."""
        fr = self.flight_recorder
        if fr is None or not fr.enabled:
            return
        try:
            inj = getattr(self.store, "crash", None)
            fr.snap(
                spans=self.tracer.dump()[-fr.tail_spans:],
                clog=self.clog.last(fr.tail_clog),
                perf=self.perf.dump(),
                profiler=self.profiler.aggregate(),
                crash=inj.describe() if inj is not None else None)
        except Exception:   # noqa: BLE001 — the black box must never
            pass            # take the daemon down

    def _post_crash_report(self, info: dict):
        """Synthesize a crash report from the dead incarnation's black
        box and post it into the mgr crash module's config-key
        namespace (reference ceph-crash agent → `ceph crash post`)."""
        from ..core.flight_recorder import (CRASH_KEY_PREFIX,
                                            crash_id_for)
        entity = f"osd.{self.whoami}"
        stamp = time.time()
        tail_n = int(self.config.get("osd_blackbox_tail_events"))
        report = {
            "entity": entity,
            "timestamp": stamp,
            "boot_nonce": info.get("nonce"),
            "crash_pid": info.get("pid"),
            "crash_point": info.get("crash_point"),
            "timeline": (info.get("events") or [])[-tail_n:],
            "replay_stats": getattr(self.store, "replay_stats", None),
            "blackbox_tail": info.get("tail"),
        }
        crash_id = crash_id_for(entity, stamp)
        try:
            rc, _outs, _ = self.monc.command(
                {"prefix": "config-key put",
                 "key": CRASH_KEY_PREFIX + crash_id,
                 "val": json.dumps(report, default=str)},
                timeout=5.0)
        except Exception:   # noqa: BLE001 — the post-mortem is
            return          # advisory; boot continues without it
        if rc == 0:
            self._crash_report_id = crash_id
            self.clog.warn(
                f"{entity} previous instance crashed uncleanly; "
                f"posted crash report {crash_id}")

    # -- cache-tier agent --------------------------------------------------
    def _tier_rados(self):
        """Lazy internal client for tiering (reference: the OSD's own
        Objecter drives promotes).  The entity name's `client.tier-`
        prefix is the recursion guard the cache PGs check."""
        # guarded: two concurrent promotes (or a promote racing
        # shutdown) must not each connect a client and orphan one
        with self.lock:
            if not self.running:
                raise ConnectionError("osd shutting down")
            if getattr(self, "_tier_client", None) is None:
                import uuid
                from ..osdc.librados import Rados
                self._tier_client = Rados(
                    self.monmap,
                    name=f"client.tier-osd{self.whoami}-"
                         f"{uuid.uuid4().hex[:8]}",
                    auth=self.auth).connect()
            return self._tier_client

    def tier_agent(self, pg, oid: str, base_pool_id: int,
                   delete: bool = False):
        """Background promote (copy base→cache) or base-delete for a
        parked op; runs OFF the op worker so the agent's own client
        ops (which come back through this OSD's queue) can't
        deadlock.  Completion requeues the parked ops under the
        daemon lock."""
        import threading as _threading
        from ..osdc.librados import ObjectNotFound

        def run():
            try:
                r = self._tier_rados()
                base_name = r.objecter.osdmap.pools[base_pool_id].name
                base_io = r.open_ioctx_direct(base_name)
                if delete:
                    try:
                        base_io.remove(oid)
                    except ObjectNotFound:
                        pass
                else:
                    cache_name = \
                        r.objecter.osdmap.pools[pg.pool.id].name
                    cache_io = r.open_ioctx_direct(cache_name)
                    try:
                        data = bytes(base_io.read(oid))
                    except ObjectNotFound:
                        data = None     # miss in base too: plain ENOENT
                    if data is not None:
                        cache_io.write_full(oid, data)
                        try:
                            for k, v in base_io.getxattrs(oid).items():
                                cache_io.setxattr(oid, k, v)
                        except Exception:   # noqa: BLE001 — optional
                            pass
                        try:
                            rows = base_io.omap_get(oid)
                            if rows:
                                cache_io.omap_set(oid, rows)
                        except Exception:   # noqa: BLE001 — optional
                            pass
            except Exception:   # noqa: BLE001 — a failed promote
                pass            # releases the op; it runs as a miss
            finally:
                with self.lock:
                    pg._promote_done(oid)

        _threading.Thread(target=run, daemon=True,
                          name=f"osd.{self.whoami}-tier").start()

    def _op_worker_loop(self):
        while True:
            got = self.op_queue.dequeue(timeout=1.0)
            if got is None:
                if not self.running:
                    return
                continue
            _klass, msg = got
            try:
                self._route(msg)
            except Exception:       # noqa: BLE001 — a poisoned op
                # must not kill the op thread; fail the op visibly
                # instead of leaving the client to time out
                tracked = getattr(msg, "tracked", None)
                if tracked is not None:
                    tracked.finish()
                con = getattr(msg, "connection", None)
                if isinstance(msg, M.MOSDOp) and con is not None:
                    try:
                        con.send_message(M.MOSDOpReply(
                            tid=msg.tid, rc=-5, outs="op faulted",
                            results=None, version=[0, 0],
                            epoch=self.osdmap.epoch,
                            trace=getattr(msg, "trace", None)))
                    except ConnectionError:
                        pass

    def shutdown(self):
        self.running = False
        self.op_queue.close()
        # drain the data plane while the messenger is still up: the
        # flights' completions fan out their sub-writes
        try:
            self.batch_engine.stop()
        except Exception:   # noqa: BLE001 — shutdown is best-effort
            pass
        self.timer.shutdown()
        self.admin_socket.shutdown()
        tier = getattr(self, "_tier_client", None)
        if tier is not None:
            try:
                tier.shutdown()
            except Exception:   # noqa: BLE001
                pass
            self._tier_client = None
        self.monc.shutdown()
        self.msgr.shutdown()
        if self.flight_recorder is not None:
            try:
                self._blackbox_snap()
                self.flight_recorder.close()
            except OSError:
                pass
        self.store.umount()

    def _on_store_error(self, exc):
        """The backing store can no longer durably commit (ENOSPC,
        fsync failure, injected power loss).  Reference behavior
        (BlueStore::_txc_state_proc on EIO → ceph_abort, softened to
        our daemon model): clog the failure, self-report so the mon
        marks us down, stop answering heartbeats so peers confirm it,
        and fail client ops with EIO instead of crashing the op
        thread.  May fire from the op worker (mid-queue_transaction)
        or the WAL commit thread."""
        if self._store_error is not None:
            return
        self._store_error = str(exc)
        try:
            self.clog.error(
                f"osd.{self.whoami} objectstore write failure, "
                f"marking self down: {exc}")
        except Exception:   # noqa: BLE001 — degradation is best-effort
            pass
        try:
            self.monc.send(MM.MOSDFailure(
                target=self.whoami, reporter=self.whoami))
        except Exception:   # noqa: BLE001
            pass

    def _on_lane_flush(self, lane: str, ops: int, nbytes: int):
        """Batch-engine flush hook: debit the op queue for the device
        bandwidth the reconstruct lane just consumed, so queued
        recovery-class work defers in proportion and client ops keep
        their p99 through a recovery sweep (the mClock recovery
        reservation governs the lane even though its megabatches
        bypass the queue itself)."""
        if lane != "recon" or not ops:
            return
        q = getattr(self, "op_queue", None)
        account = getattr(q, "account", None)
        if account is not None:
            account(RECOVERY, float(ops))

    def _send_boot(self):
        self.monc.send(MM.MOSDBoot(
            osd=self.whoami, addr=f"{self.addr.host}:{self.addr.port}"))

    def request_up_thru(self, want: int):
        """Ask the mon to bump our up_thru (idempotent; the committed
        map's arrival re-drives the waiting PGs' peering)."""
        self.monc.send(MM.MOSDAlive(osd=self.whoami, want=want))

    def _start_scrub_or_retry(self, pg, msg, *, max_tries: int = 20):
        """An operator scrub refused (writes in flight, already
        scrubbing, mid-peering) requeues itself instead of silently
        dropping — the mon already acked the command.  ``repair``
        implies deep (a shallow pass can't see what to repair)."""
        deep = bool(getattr(msg, "repair", False)) or \
            getattr(msg, "deep", True) is not False
        if pg.start_scrub(deep=deep,
                          trigger=getattr(msg, "trace", None)):
            return
        tries = getattr(msg, "_scrub_tries", 0)
        if tries >= max_tries:
            return
        msg._scrub_tries = tries + 1
        self.timer.add_event_after(
            0.5, lambda: self.op_queue.enqueue("scrub", msg))

    def scrub_pg(self, pgid: PGid, deep: bool = True) -> bool:
        """Kick a scrub on a PG this OSD is primary for."""
        with self.lock:
            pg = self.pgs.get(pgid)
            return bool(pg is not None and pg.start_scrub(deep=deep))

    # -- map handling ------------------------------------------------------
    def _on_osdmap(self, epoch: int, map_dict: dict, newest: int = 0):
        with self.lock:
            if epoch <= self.osdmap.epoch:
                return
            prev = self.osdmap
            self.osdmap = shared_osdmap_from_dict(map_dict)
            # a peer that came back up starts a fresh grace window —
            # its stale _hb_last would otherwise trip an immediate
            # failure report (one flap per revive)
            for o in range(self.osdmap.max_osd):
                if self.osdmap.is_up(o) and \
                        (o >= prev.max_osd or not prev.is_up(o)):
                    self._hb_last.pop(o, None)
                    self._hb_reported.pop(o, None)
            self._split_pgs(prev)
            placements = self._update_pg_intervals()
            catching_up = epoch < max(newest, self.monc.osdmap_epoch)
            if catching_up:
                # history replay: record intervals only — peering,
                # PG creation and rejoin-boot wait for the live map
                return
            if self.running and not self.osdmap.is_up(self.whoami):
                # marked down but alive: rejoin (reference
                # OSD::_committed_osd_maps → start_boot)
                self._send_boot()
            self._scan_pgs(placements)
            # pool snapshot deletions drive clone trimming (reference
            # snap trim queue fed by OSDMap snap removals)
            for pid, pool in self.osdmap.pools.items():
                prevpool = prev.pools.get(pid)
                if prevpool is None:
                    continue
                removed = set(prevpool.snaps) - set(pool.snaps)
                if not removed:
                    continue
                for pgid, pg in self.pgs.items():
                    if pgid.pool == pid and \
                            self.whoami in pg.acting:
                        fn = getattr(pg.backend, "snap_trim", None)
                        if fn is not None:
                            fn(removed)

    def _split_pgs(self, prev: OSDMap):
        """PG splitting on pg_num growth (reference ``OSD::split_pgs``
        + ``PG::split_into`` + ``pg_t::is_split``): every OSD holding
        a parent collection carves out the child PGs locally — objects
        (with their snap clones), log entries, snap-mapper index, and
        info move by ``ceph_stable_mod`` re-hash; children then peer
        under the new map with their data already in place, and CRUSH
        relocation proceeds as ordinary recovery/backfill."""
        import json as _json

        from ..crush.hash import ceph_str_hash_rjenkins
        from .osdmap import ceph_stable_mod
        from .pg import META_OID, SNAPMAP_OID, _SNAP_SEP

        for pid, pool in self.osdmap.pools.items():
            old = prev.pools.get(pid)
            if old is None or pool.pg_num <= old.pg_num:
                continue
            old_n, old_mask = old.pg_num, old.pg_num_mask

            def head_of(oid: str) -> str:
                return oid.split(_SNAP_SEP, 1)[0]

            def child_ps(oid: str) -> int:
                seed = int(ceph_str_hash_rjenkins(head_of(oid).encode()))
                return pool.raw_pg_to_pg(seed)

            shards = range(pool.size) if pool.is_erasure() else (-1,)
            for p_ps in range(old_n):
                children = [c for c in range(old_n, pool.pg_num)
                            if ceph_stable_mod(c, old_n, old_mask) == p_ps]
                if not children:
                    continue
                parent = PGid(pid, p_ps)
                child_set = set(children)
                for s in shards:
                    pcid = str(parent) if s < 0 else f"{parent}s{s}"
                    if not self.store.collection_exists(pcid):
                        continue
                    try:
                        meta = self.store.omap_get(pcid, META_OID)
                    except KeyError:
                        meta = {}
                    pinfo = (_json.loads(meta["info"])
                             if "info" in meta else None)
                    plog = (_json.loads(meta["log"])
                            if "log" in meta else None)
                    try:
                        snapmap = self.store.omap_get(pcid, SNAPMAP_OID)
                    except KeyError:
                        snapmap = {}
                    # one bucketing pass: hash every object / snap-row /
                    # log entry ONCE and group by destination child
                    # (not once per child — splits can fan 1→64)
                    oids_by_child: dict[int, list] = {}
                    for oid in self.store.list_objects(pcid):
                        if oid in (META_OID, SNAPMAP_OID):
                            continue
                        c = child_ps(oid)
                        if c in child_set:
                            oids_by_child.setdefault(c, []).append(oid)
                    rows_by_child: dict[int, dict] = {}
                    for key, val in snapmap.items():
                        c = child_ps(key.split("|", 1)[1]
                                     .rsplit("|", 1)[0])
                        if c in child_set:
                            rows_by_child.setdefault(c, {})[key] = val
                    entries_by_child: dict[int, list] = {}
                    kept_entries = []
                    for e in (plog or {}).get("entries", []):
                        c = child_ps(e["oid"])
                        if c in child_set:
                            entries_by_child.setdefault(c, []).append(e)
                        else:
                            kept_entries.append(e)
                    for c in children:
                        child = PGid(pid, c)
                        ccid = str(child) if s < 0 else f"{child}s{s}"
                        if self.store.collection_exists(ccid):
                            continue    # idempotent (restart replay)
                        t = Transaction().create_collection(ccid)
                        t.touch(ccid, META_OID)
                        for oid in oids_by_child.get(c, ()):
                            t.coll_move(pcid, oid, ccid)
                        # snap-mapper index rows follow their objects
                        moved_rows = rows_by_child.get(c, {})
                        if moved_rows:
                            t.omap_setkeys(ccid, SNAPMAP_OID,
                                           moved_rows)
                            t.omap_rmkeys(pcid, SNAPMAP_OID,
                                          list(moved_rows))
                        # meta: child inherits the parent's history,
                        # log filtered to its objects (reference
                        # PGLog::split_out_child)
                        if pinfo is not None:
                            cinfo = dict(pinfo, pgid=str(child))
                            clog = dict(plog or {})
                            clog["entries"] = entries_by_child.get(c, [])
                            t.omap_setkeys(ccid, META_OID, {
                                "info": _json.dumps(cinfo).encode(),
                                "log": _json.dumps(clog).encode()})
                        self.store.queue_transaction(t)
                        # child peering must account for the parent's
                        # maybe-went-rw history
                        self.pg_intervals.setdefault(child, [])
                        self.pg_intervals[child][:] = [
                            dict(iv) for iv in
                            self.pg_intervals.get(parent, [])]
                    if pinfo is not None and plog is not None and \
                            len(kept_entries) != \
                            len(plog.get("entries", [])):
                        plog = dict(plog, entries=kept_entries)
                        self.store.queue_transaction(
                            Transaction().omap_setkeys(pcid, META_OID, {
                                "log": _json.dumps(plog).encode()}))
                # in-memory parent drops the moved objects' log rows
                # and missing entries (a re-homed oid must not pin the
                # parent in 'recovering' — its peers also dropped it);
                # everything else reloads naturally on advance_map
                ppg = self.pgs.get(parent)
                if ppg is not None:
                    ppg._held_cache = None
                    ppg.log.entries = [
                        e for e in ppg.log.entries
                        if child_ps(e.oid) == p_ps]
                    for moid in [o for o in ppg.missing
                                 if child_ps(o) != p_ps]:
                        ppg.missing.pop(moid, None)

    def _update_pg_intervals(self):
        """Track acting-set intervals for every PG of every pool at
        every epoch (reference PastIntervals::check_new_interval).
        ``maybe_went_rw``: the interval had a primary and at least
        min_size live members, so it COULD have accepted writes —
        peering must see a member of every such interval since
        last_epoch_started before activating, or acknowledged writes
        could be silently lost (ADVICE r2 high).

        Returns the {pgid: mapping} snapshot so _scan_pgs reuses it
        instead of recomputing every PG's CRUSH placement."""
        m = self.osdmap
        from ..crush.map import CRUSH_ITEM_NONE
        placements: dict[PGid, tuple] = {}
        for pool in m.pools.values():
            for ps in range(pool.pg_num):
                pgid = PGid(pool.id, ps)
                mapping = m.pg_to_up_acting_osds(pgid)
                placements[pgid] = mapping
                _up, _upp, acting, actingp = mapping
                open_iv = self._open_intervals.get(pgid)
                if open_iv is not None and \
                        open_iv["acting"] == acting and \
                        open_iv["primary"] == actingp:
                    continue
                if open_iv is not None and open_iv["primary"] != -1:
                    open_iv["last"] = m.epoch - 1
                    # rw additionally requires the primary to have
                    # bumped up_thru into the interval (reference
                    # check_new_interval's could_have_gone_active):
                    # a primary that was already dead never does, so
                    # its phantom intervals can't block peering
                    open_iv["maybe_went_rw"] = (
                        open_iv["maybe_went_rw"]
                        and m.up_thru(open_iv["primary"])
                        >= open_iv["first"])
                    self.pg_intervals.setdefault(pgid, []).append(open_iv)
                live = sum(1 for o in acting if o != CRUSH_ITEM_NONE)
                self._open_intervals[pgid] = {
                    "first": m.epoch, "acting": list(acting),
                    "primary": actingp,
                    "maybe_went_rw": actingp != -1
                    and live >= max(1, pool.min_size)}
        return placements

    def _scan_pgs(self, placements: dict | None = None):
        """Recompute which PGs this OSD hosts and advance each
        (reference OSD::consume_map / split into advance_pg)."""
        m = self.osdmap
        seen: set[PGid] = set()
        for pool in m.pools.values():
            for ps in range(pool.pg_num):
                pgid = PGid(pool.id, ps)
                mapping = (placements.get(pgid) if placements
                           else None) or m.pg_to_up_acting_osds(pgid)
                up, upp, acting, actingp = mapping
                if self.whoami not in acting and pgid not in self.pgs:
                    continue
                seen.add(pgid)
                pg = self.pgs.get(pgid)
                if pg is None:
                    pg = PG(self, pgid, pool)
                    pg.acting = []   # force interval change on first map
                    # share the daemon-maintained interval history (the
                    # daemon appends under the same lock the PG reads)
                    pg.past_intervals = self.pg_intervals.setdefault(
                        pgid, [])
                    self.pgs[pgid] = pg
                    # adopt whatever an earlier incarnation persisted
                    pg.primary = actingp
                    if self.whoami in acting:
                        pg.shard = acting.index(self.whoami)
                    pg.load_from_store()
                    pg.create_onstore()
                    fn = getattr(pg.backend, "snap_trim", None)
                    if fn is not None:
                        fn(None)    # reconcile missed snap removals
                pg.pool = m.pools[pool.id]
                pg.advance_map(up, upp, acting, actingp, m.epoch)
        self.perf.set("numpg", len(self.pgs))

    # -- peer plumbing -----------------------------------------------------
    def send_to_osd(self, osd: int, msg):
        if osd == self.whoami:
            # loop back through local dispatch (the reference short-
            # circuits local sub-ops the same way)
            self._route(msg)
            return
        addr_s = self.osdmap.osd_addrs.get(osd)
        if not addr_s:
            return
        cached = self._peer_cons.get(osd)
        con = None
        if cached is not None:
            cached_addr, cached_con = cached
            if cached_addr == addr_s and not cached_con._closed:
                con = cached_con
            else:
                # the peer rebooted on a new address (or the link
                # died): drop the stale connection or every message
                # queues forever against the dead incarnation
                cached_con.mark_down()
        if con is None:
            host, _, port = addr_s.rpartition(":")
            con = self.msgr.connect_to_lazy(EntityAddr(host, int(port)))
            self._peer_cons[osd] = (addr_s, con)
        try:
            con.send_message(msg)
        except ConnectionError:
            self._peer_cons.pop(osd, None)

    # -- heartbeats --------------------------------------------------------
    def _hb_peers(self) -> set[int]:
        """PG peers plus every other up OSD: the reference tops up
        heartbeat peers beyond PG membership (OSD::maybe_update_
        heartbeat_peers, osd_heartbeat_min_peers) so failures are
        detected even when the failed OSD shares no PG with a
        survivor; at mini-cluster scale that means everyone."""
        m = self.osdmap
        return {o for o in range(m.max_osd)
                if o != self.whoami and m.is_up(o)}

    def _tick(self):
        if not self.running:
            return
        # deadline backstop for the data plane: a flush whose timer
        # event was lost (or an engine configured without a schedule)
        # still drains within one tick
        self.batch_engine.maybe_flush()
        with self.lock:
            now = time.monotonic()
            # peering retransmit: queries/notifies are fire-and-forget
            # and can race a peer's map update (its reply goes to a
            # stale address); a stuck primary simply re-asks
            for pg in self.pgs.values():
                pg.check_scrub_timeout()
                self._maybe_schedule_scrub(pg)
                if pg.is_primary and pg.state in ("peering",
                                                  "incomplete"):
                    pg._start_peering()
                elif pg.is_primary and pg.state == "down" and \
                        len(pg.acting_live()) >= max(1, pg.pool.min_size):
                    pg._start_peering()
                elif pg.is_primary and pg.state == "active" and \
                        (pg.missing or pg.backfill_targets or
                         any(pg.peer_missing.values())):
                    # recovery retry: a push/pull whose reconstruct
                    # read failed transiently has no event to re-kick
                    # it — the tick is the retry engine (reference:
                    # the recovery work queue re-schedules).  Also
                    # re-deliver activation: a peer whose map advance
                    # raced it sits in 'stray' answering nothing.
                    pg._resend_activation()
                    pg._kick_recovery()
            for o in self._hb_peers():
                self._hb_last.setdefault(o, now)
                self.send_to_osd(o, M.MOSDPing(
                    from_osd=self.whoami, epoch=self.osdmap.epoch,
                    kind="ping", stamp=now))
                if (now - self._hb_last[o] > self._hb_grace
                        and self.osdmap.is_up(o)
                        and now - self._hb_reported.get(o, 0.0)
                        > self._hb_grace):
                    # RE-send while the map still shows the peer up:
                    # a report can be dropped by a mon mid-election
                    # (reference OSD::send_failures retries too)
                    self._hb_reported[o] = now
                    self.monc.send(MM.MOSDFailure(
                        target=o, reporter=self.whoami))
            if now - self._stats_last >= self._stats_interval:
                self._stats_last = now
                self._report_pg_stats()
                self._maybe_clog_health()
                self._blackbox_snap()
                self.clog.flush()
        if self.running:
            self._tick_token = self.timer.add_event_after(
                self._hb_interval, self._tick)

    def _maybe_schedule_scrub(self, pg):
        """Periodic scrub scheduling (reference OSD::sched_scrub):
        when a primary active PG's last (deep-)scrub is older than
        ``osd_scrub_interval`` / ``osd_deep_scrub_interval``, kick one
        from the tick.  0 disables an interval; a refusal (writes in
        flight etc.) just waits for the next tick.  Never-scrubbed PGs
        age from their creation stamp, so a restart doesn't stampede
        every PG at once."""
        # active+clean is the steady state a periodic scrub targets
        if not pg.is_primary or not pg.state.startswith("active") \
                or pg.scrubbing:
            return
        # operator flags gate PERIODIC scrubs only (reference
        # OSD::sched_scrub): noscrub stops shallow, nodeep-scrub stops
        # deep; an explicit `ceph pg scrub` still rides
        # MOSDScrubCommand → _start_scrub_or_retry and overrides both
        from .osdmap import CLUSTER_FLAGS
        flags = self.osdmap.flags
        noscrub = bool(flags & CLUSTER_FLAGS["noscrub"])
        nodeep = bool(flags & CLUSTER_FLAGS["nodeep-scrub"])
        now = time.time()
        floor = pg._scrub_stamp_floor
        deep_iv = float(self.config.get("osd_deep_scrub_interval"))
        if deep_iv > 0 and not nodeep and \
                now - max(pg.last_deep_scrub, floor) >= deep_iv:
            if pg.start_scrub(deep=True):
                self.perf.inc("scrubs_scheduled")
            return
        iv = float(self.config.get("osd_scrub_interval"))
        if iv > 0 and not noscrub and \
                now - max(pg.last_scrub, floor) >= iv:
            if pg.start_scrub(deep=False):
                self.perf.inc("scrubs_scheduled")

    def _maybe_clog_health(self):
        """Cluster-log the SLOW_OPS / scrub-error transitions
        (reference: OSD clog warnings feeding `ceph -w`); only edges
        are logged so a stuck op does not spam an entry per tick."""
        slow = self.op_tracker.slow_summary()
        if slow["count"] > self._slow_ops_logged:
            self.clog.warn(
                f"{slow['count']} slow requests, oldest "
                f"{slow['oldest_age']:.1f}s: {slow['oldest_desc']}")
        self._slow_ops_logged = slow["count"]
        errors = sum(pg.scrub_errors for pg in self.pgs.values()
                     if pg.is_primary)
        if errors > self._scrub_errors_logged:
            self.clog.error(
                f"scrub found {errors} inconsistencies")
        self._scrub_errors_logged = errors

    def _report_pg_stats(self):
        """Primary PGs report state/object counts to the mon (reference
        MPGStats → PGMap; caller holds the lock)."""
        stats = {}
        for pgid, pg in self.pgs.items():
            if not pg.is_primary:
                continue
            # per-PG usage is only rescanned when the PG changed since
            # the last report — the tick must not stat() every object
            # of an idle cluster over and over
            objs = pg._list_objects()
            cache = getattr(pg, "_usage_cache", None)
            # keyed on (last_update, object count): splits, recovery
            # pulls, and backfill move objects WITHOUT bumping
            # last_update, so the listing length must participate or
            # the byte count goes stale (review r3)
            key = (pg.info.last_update, len(objs))
            if cache is not None and cache[0] == key:
                nbytes, lbytes = cache[1], cache[2]
            else:
                # physical (stored) vs logical bytes: sealed objects
                # (pool compression / dedup) store fewer bytes than
                # they logically hold — `num_bytes` stays PHYSICAL so
                # capacity accounting reflects post-compression
                # reality; `num_bytes_logical` feeds the df/ratio view
                nbytes = 0
                lbytes = 0
                for o in objs:
                    phys = 0
                    try:
                        phys = self.store.stat(pg.cid, o)["size"]
                    except KeyError:
                        pass
                    nbytes += phys
                    try:
                        meta = json.loads(bytes(self.store.getattr(
                            pg.cid, o, "_")))
                        lbytes += int(meta.get("size", phys))
                    except (KeyError, ValueError):
                        lbytes += phys
                pg._usage_cache = (key, nbytes, lbytes)
            stats[str(pgid)] = {
                "state": pg.state + ("+scrubbing" if pg.scrubbing
                                     else ""),
                "num_objects": len(objs),
                "num_bytes": nbytes,
                "num_bytes_logical": lbytes,
                "log_size": len(pg.log.entries),
                "missing": len(pg.missing) + sum(
                    len(pm) for pm in pg.peer_missing.values()),
                # misplaced-work analogue: what backfill still owes —
                # the mgr progress module derives its fraction from
                # missing + backfill_remaining deltas
                "backfill_remaining": pg.backfill_remaining(),
                "last_scrub": pg.last_scrub,
                "last_deep_scrub": pg.last_deep_scrub,
                # effective stamp for PG_NOT_SCRUBBED: a never-scrubbed
                # PG counts from creation, not from the epoch
                "last_scrub_stamp": max(pg.last_scrub,
                                        pg._scrub_stamp_floor),
                "scrub_errors": pg.scrub_errors,
                "inconsistent_objects": pg.inconsistent_objects,
            }
            if pg.scrubbing:
                # chunk position of an in-flight scrub (maps gathered
                # vs. acting-set size) — the mgr progress module turns
                # this into a per-PG `pg_scrub/<pgid>` event
                stats[str(pgid)]["scrub_chunks_done"] = \
                    pg.scrub_chunks_done()
                stats[str(pgid)]["scrub_chunks_total"] = \
                    pg.scrub_chunks_total()
        if stats or self.pgs:
            # dedup chunk bytes live in the store-global "dedup"
            # collection, outside any PG — capacity accounting must
            # include them or dedup pools look free
            from ..compress import dedup as dd
            dstats = dd.dedup_stats(self.store)
            bytes_used = sum(st["num_bytes"]
                             for st in stats.values()) \
                + dstats["stored_bytes"]
            eng = self.batch_engine.stats
            self.monc.send(MM.MPGStats(
                osd=self.whoami, epoch=self.osdmap.epoch,
                pg_stats=stats,
                osd_stats={"num_pgs": len(self.pgs),
                           # non-None once the backing store failed
                           # (ENOSPC/fsync error): feeds the
                           # OSD_STORE_ERROR health check
                           "store_error": self._store_error,
                           # storage-efficiency lane aggregates: the
                           # telemetry spine differentiates these into
                           # compress/decompress/fingerprint byte
                           # rates; dedup index totals ride whole
                           "dedup": dstats,
                           "comp": {
                               "bytes_in": eng.get("comp_bytes_in", 0),
                               "bytes_out": eng.get("comp_bytes_out",
                                                    0),
                               "decompress_bytes": eng.get(
                                   "comp_decompress_bytes", 0),
                               "fingerprint_bytes": eng.get(
                                   "comp_fingerprint_bytes", 0),
                               "passthrough": eng.get(
                                   "comp_passthrough", 0)},
                           # stub capacity accounting for the
                           # OSD_NEARFULL check: primary-PG bytes vs a
                           # configured synthetic device size
                           "bytes_used": bytes_used,
                           "bytes_total": int(self.config.get(
                               "osd_stub_capacity_bytes")),
                           # cumulative client-op counters: the mgr
                           # iostat module differentiates these into
                           # IOPS (reference osd_stat_t op counters)
                           "op": self.perf.get("op"),
                           "op_w": self.perf.get("op_w"),
                           "op_r": self.perf.get("op_r"),
                           "op_in_bytes": self.perf.get("op_in_bytes"),
                           # (sum, count) so the spine can derive a
                           # windowed commit latency, not lifetime avg
                           "op_latency": {
                               "sum": self.perf._counters[
                                   "op_latency"].sum,
                               "count": self.perf._counters[
                                   "op_latency"].count},
                           # device-plane launch aggregates for the
                           # telemetry spine (dispatch/compute split,
                           # occupancy, idle gap, launch histogram)
                           "profiler": self.profiler.aggregate(),
                           # slow-op attribution: the mon's SLOW_OPS
                           # health check and the exporter gauges are
                           # fed from here (reference osd_stat_t
                           # num_slow_ops via the mgr report)
                           "slow_ops": self.op_tracker.slow_summary(),
                           # heavy-hitter sketches + slowest-op trace
                           # exemplars: the telemetry spine merges the
                           # sketches cluster-wide (`ceph osd top`)
                           # and serves `tracing exemplar` from these
                           "topk": self.topk.dump(),
                           "exemplars":
                               self._histogram_exemplars()}))

    def _histogram_exemplars(self) -> dict:
        """{counter: {bucket: {trace_id, value, ts}}} for every
        histogram counter carrying live exemplars."""
        out = {}
        for c in self.perf._counters.values():
            if c.hist is not None and c.hist.exemplars:
                out[c.name] = {str(b): dict(ex)
                               for b, ex in c.hist.exemplars.items()}
        return out

    # -- dispatch ----------------------------------------------------------
    def ms_dispatch(self, msg) -> bool:
        # heartbeats answer inline on the messenger thread; everything
        # else is classified into the weighted op queue
        if isinstance(msg, M.MOSDPing):
            return self._route(msg)
        klass = _SCHED_CLASS.get(type(msg))
        if klass is None:
            return False
        dmc = getattr(msg, "dmc", None)
        if klass == CLIENT and isinstance(dmc, dict):
            # distributed dmclock: per-client tags advanced by the
            # client's cross-OSD completion feedback.  Wire values
            # are untrusted JSON — anything non-numeric degrades to
            # the 1-op default instead of killing the dispatch
            try:
                delta = int(dmc.get("delta", 1))
                rho = int(dmc.get("rho", 1))
            except (TypeError, ValueError):
                delta = rho = 1
            # the tenant QoS tag (RGW auth uid) outranks the wire
            # entity as the mClock client key: isolation is
            # per-tenant, not per-connection — every connection a
            # tenant opens shares ONE set of QoS streams
            self.op_queue.enqueue(
                klass, msg,
                client=(getattr(msg, "qos_client", None)
                        or getattr(msg, "client", None)),
                delta=delta, rho=rho)
        else:
            self.op_queue.enqueue(klass, msg)
        return True

    def _route(self, msg) -> bool:
        with self.lock:
            if self._store_error is not None:
                # dead backing store: a silent heartbeat lets peers
                # report us down, and client ops fail fast with EIO
                # rather than acking writes that can never commit
                if isinstance(msg, M.MOSDPing):
                    return True
                if isinstance(msg, M.MOSDOp):
                    tracked = getattr(msg, "tracked", None)
                    if tracked is not None:
                        tracked.finish()
                    if msg.connection is not None:
                        try:
                            msg.connection.send_message(M.MOSDOpReply(
                                tid=msg.tid, rc=-5,
                                outs="objectstore error: "
                                     + self._store_error,
                                results=None, version=[0, 0],
                                epoch=self.osdmap.epoch,
                                trace=getattr(msg, "trace", None)))
                        except ConnectionError:
                            pass
                    return True
            if isinstance(msg, M.MOSDPing):
                if msg.kind == "ping":
                    if msg.connection is not None:
                        try:
                            msg.connection.send_message(M.MOSDPing(
                                from_osd=self.whoami,
                                epoch=self.osdmap.epoch,
                                kind="ping_reply", stamp=msg.stamp))
                        except ConnectionError:
                            pass
                else:
                    self._hb_last[msg.from_osd] = time.monotonic()
                    self._hb_reported.pop(msg.from_osd, None)
                return True
            if isinstance(msg, M.MOSDOp):
                self._handle_client_op(msg)
                return True
            handlers = {
                M.MOSDPGQuery: lambda pg: pg.handle_query(msg),
                M.MOSDPGNotify: lambda pg: pg.handle_notify(msg),
                M.MOSDPGLog: lambda pg: pg.handle_log(msg),
                M.MOSDPGPush: lambda pg: pg.handle_push(msg),
                M.MOSDPGPushReply: lambda pg: pg.handle_push_reply(msg),
                M.MOSDPGPull: lambda pg: pg.handle_pull(msg),
                M.MOSDRepOp: lambda pg: pg.backend.apply_rep_op(msg),
                M.MOSDRepOpReply:
                    lambda pg: pg.backend.handle_rep_reply(msg),
                M.MOSDECSubOpWrite:
                    lambda pg: pg.backend.apply_sub_write(msg),
                M.MOSDECSubOpWriteReply:
                    lambda pg: pg.backend.handle_sub_write_reply(msg),
                M.MOSDECSubOpRead:
                    lambda pg: pg.backend.handle_sub_read(msg),
                M.MOSDECSubOpReadReply:
                    lambda pg: pg.backend.handle_sub_read_reply(msg),
                M.MOSDRepScrub: lambda pg: pg.handle_rep_scrub(msg),
                M.MOSDRepScrubMap:
                    lambda pg: pg.handle_scrub_map(msg),
                M.MWatchNotifyAck:
                    lambda pg: pg.handle_notify_ack(msg),
                M.MOSDPGBackfillPrune:
                    lambda pg: pg.handle_backfill_prune(msg),
                M.MOSDScrubCommand:
                    lambda pg: self._start_scrub_or_retry(pg, msg),
            }
            fn = handlers.get(type(msg))
            if fn is None:
                return False
            pg = self._pg_for(msg)
            if pg is None and isinstance(msg, (M.MOSDPGQuery,
                                               M.MOSDPGPull,
                                               M.MOSDRepScrub)):
                # a peering primary is probing a prior-interval holder
                # that hasn't instantiated this PG (e.g. just revived,
                # no longer acting): materialize it from the store so
                # its info/objects can flow back (the reference
                # likewise answers queries for PGs it only has on disk)
                pg = self._create_stray_pg(msg.pgid)
            if pg is None:
                return True
            backend_kind = (ECBackend if isinstance(msg, (
                M.MOSDECSubOpWrite, M.MOSDECSubOpWriteReply,
                M.MOSDECSubOpRead, M.MOSDECSubOpReadReply))
                else None)
            if backend_kind and not isinstance(pg.backend, backend_kind):
                return True
            rep_kind = (ReplicatedBackend if isinstance(msg, (
                M.MOSDRepOp, M.MOSDRepOpReply)) else None)
            if rep_kind and not isinstance(pg.backend, rep_kind):
                return True
            fn(pg)
            return True

    def _create_stray_pg(self, pgid_s: str) -> PG | None:
        try:
            pgid = PGid.parse(pgid_s)
        except (ValueError, AttributeError):
            return None
        pool = self.osdmap.pools.get(pgid.pool)
        if pool is None:
            return None
        pg = PG(self, pgid, pool)
        pg.past_intervals = self.pg_intervals.setdefault(pgid, [])
        _up, _upp, acting, actingp = \
            self.osdmap.pg_to_up_acting_osds(pgid)
        pg.acting = list(acting)
        pg.primary = actingp
        pg.state = "stray"
        pg.interval_epoch = self.osdmap.epoch
        if self.whoami in acting:
            pg.shard = acting.index(self.whoami)
        elif pool.is_erasure():
            # find which shard collection an earlier incarnation left
            for s in range(pool.size):
                if self.store.collection_exists(f"{pgid}s{s}"):
                    pg.shard = s
                    break
        pg.load_from_store()
        self.pgs[pgid] = pg
        return pg

    def _pg_for(self, msg) -> PG | None:
        try:
            pgid = PGid.parse(msg.pgid)
        except (AttributeError, ValueError):
            return None
        pg = self.pgs.get(pgid)
        if pg is None:
            return None
        # discard cross-interval stragglers (the reference drops
        # messages from older intervals after comparing epochs)
        if getattr(msg, "epoch", None) is not None and \
                msg.epoch < pg.interval_epoch:
            return None
        return pg

    def _handle_client_op(self, msg: M.MOSDOp):
        # TrackedOp + counters on the op path (reference
        # OSD::ms_fast_dispatch → op_tracker.create_request)
        kinds = {op.get("op") for op in (msg.ops or [])}
        is_write = bool(kinds & _WRITE_OPS)
        self.perf.inc("op")
        self.perf.inc("op_w" if is_write else "op_r")
        if is_write:
            # payload rides as hex text: 2 chars per byte
            in_bytes = sum(
                len(op.get("data", "")) // 2 for op in (msg.ops or [])
                if op.get("op") in _WRITE_OPS)
            self.perf.inc("op_in_bytes", in_bytes)
            # stash for the reply-path attribution sketch (reads
            # account ops + latency only; write bytes are what the
            # heavy-hitter byte ranking attributes)
            msg._acct_bytes = in_bytes
        msg.tracked = self.op_tracker.create_request(
            f"osd_op({msg.client}.{msg.tid} {msg.pgid} {msg.oid} "
            f"{'+'.join(sorted(k for k in kinds if k))})")
        # adopt the client's trace ctx: every mark_event on the
        # tracked op becomes a span event, finish() closes the span
        msg.tracked.span = self.tracer.start_span(
            f"osd_op:{msg.oid}", parent=getattr(msg, "trace", None),
            tags={"layer": "osd", "pgid": msg.pgid,
                  "write": is_write})
        pg = self.pgs.get(PGid.parse(msg.pgid))
        if pg is None:
            msg.tracked.finish()
            msg.tracked = None
            try:
                msg.connection.send_message(M.MOSDOpReply(
                    tid=msg.tid, rc=-11, outs="pg not here",
                    results=None, version=[0, 0],
                    epoch=self.osdmap.epoch,
                    trace=getattr(msg, "trace", None)))
            except (ConnectionError, AttributeError):
                pass
            return
        pg.do_op(msg)

    def ms_handle_reset(self, con):
        with self.lock:
            for o, (_a, c) in list(self._peer_cons.items()):
                if c is con:
                    del self._peer_cons[o]
            for pg in self.pgs.values():
                pg.con_reset(con)

