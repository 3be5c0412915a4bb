"""The option table — typed defaults for every subsystem.

The port's copy of ``ceph_tpu.core.options``.

Reference counterpart: ``src/common/options.cc`` /
``src/common/options/*.yaml.in`` (SURVEY.md §3.1 — ~2000 options
upstream; this table carries the ones this framework's subsystems
actually read, same metadata shape)."""

from __future__ import annotations

from .config import Level, Option


def build_options() -> list[Option]:
    return [
        # -- messenger ----------------------------------------------------
        Option("ms_bind_port_min", int, 6800, "bind port range start"),
        Option("ms_bind_port_max", int, 7300, "bind port range end"),
        Option("ms_connection_timeout", float, 10.0,
               "connect/handshake timeout (s)"),
        Option("ms_inject_socket_failures", int, 0,
               "fault injection: drop 1-in-N sends (0=off)",
               Level.DEV),
        # fault-fabric knobs (msg/fault.py FaultInjector): the seed
        # makes every probabilistic verdict a pure function of
        # (seed, src, dst, n) so a thrash failure replays exactly
        Option("ms_inject_seed", int, 0,
               "fault injection RNG seed (0 = random, logged)",
               Level.DEV),
        Option("ms_inject_drop_prob", float, 0.0,
               "fault injection: P(drop) per message", Level.DEV,
               min=0.0, max=1.0),
        Option("ms_inject_delay_prob", float, 0.0,
               "fault injection: P(delay) per message", Level.DEV,
               min=0.0, max=1.0),
        Option("ms_inject_delay_ms", float, 20.0,
               "fault injection: delay length (ms)", Level.DEV,
               min=0.0),
        Option("ms_inject_dup_prob", float, 0.0,
               "fault injection: P(duplicate) per message", Level.DEV,
               min=0.0, max=1.0),
        Option("ms_inject_reorder_prob", float, 0.0,
               "fault injection: P(reorder) per message", Level.DEV,
               min=0.0, max=1.0),
        Option("ms_inject_reorder_ms", float, 40.0,
               "fault injection: reorder hold-back window (ms)",
               Level.DEV, min=0.0),
        Option("ms_crc_data", bool, True, "checksum frame payloads"),
        # -- mon ----------------------------------------------------------
        Option("mon_lease", float, 5.0, "paxos lease duration (s)"),
        Option("mon_election_timeout", float, 5.0,
               "election restart timeout (s)"),
        Option("mon_tick_interval", float, 1.0, "mon tick period (s)"),
        # -- osd ----------------------------------------------------------
        Option("osd_heartbeat_interval", float, 1.0,
               "peer ping period (s)"),
        Option("osd_heartbeat_grace", float, 6.0,
               "declare peer dead after this silence (s)"),
        Option("osd_pool_default_size", int, 3, "replicas per object"),
        Option("osd_pool_default_min_size", int, 2,
               "min replicas to serve writes"),
        Option("osd_pool_default_pg_num", int, 32, "default pg count"),
        Option("osd_max_write_size", int, 90 << 20,
               "largest single write (bytes)"),
        Option("osd_max_pg_log_entries", int, 500,
               "trim the PG log beyond this many entries (a peer "
               "whose gap exceeds the log is backfilled)"),
        Option("osd_op_queue", str, "wpq", "op scheduler",
               enum_allowed=("wpq", "mclock")),
        # dmclock QoS knobs (reference osd_mclock_scheduler_*): per
        # op class, reservation (guaranteed ops/s, 0=none), weight
        # (share of the excess), limit (ops/s ceiling, 0=none)
        Option("osd_mclock_scheduler_client_res", float, 200.0,
               "client ops: reserved ops/s",
               min=0.0),
        Option("osd_mclock_scheduler_client_wgt", float, 100.0,
               "client ops: weight",
               min=0.0),
        Option("osd_mclock_scheduler_client_lim", float, 0.0,
               "client ops: limit ops/s (0 = unlimited)",
               min=0.0),
        Option("osd_mclock_scheduler_subop_res", float, 200.0,
               "replication sub-ops: reserved ops/s",
               min=0.0),
        Option("osd_mclock_scheduler_subop_wgt", float, 100.0,
               "replication sub-ops: weight",
               min=0.0),
        Option("osd_mclock_scheduler_subop_lim", float, 0.0,
               "replication sub-ops: limit ops/s (0 = unlimited)",
               min=0.0),
        Option("osd_mclock_scheduler_recovery_res", float, 20.0,
               "recovery: reserved ops/s",
               min=0.0),
        Option("osd_mclock_scheduler_recovery_wgt", float, 10.0,
               "recovery: weight",
               min=0.0),
        Option("osd_mclock_scheduler_recovery_lim", float, 200.0,
               "recovery: limit ops/s (0 = unlimited)",
               min=0.0),
        Option("osd_mclock_scheduler_scrub_res", float, 5.0,
               "scrub: reserved ops/s",
               min=0.0),
        Option("osd_mclock_scheduler_scrub_wgt", float, 5.0,
               "scrub: weight",
               min=0.0),
        Option("osd_mclock_scheduler_scrub_lim", float, 100.0,
               "scrub: limit ops/s (0 = unlimited)",
               min=0.0),
        # per-tenant QoS overrides: JSON {tenant: [res, wgt, lim]}.
        # A tenant named here gets its own reservation/weight/limit
        # streams inside the client class (the limit becomes
        # per-tenant, so capping an aggressor never caps the victim);
        # unnamed tenants keep the class-wide triple above.
        Option("osd_mclock_scheduler_client_qos", str, "",
               "per-tenant client QoS: JSON {tenant: [res, wgt, "
               "lim]} ('' = none)"),
        Option("osd_recovery_max_active", int, 8,
               "in-flight recovery/backfill pushes per PG kick "
               "(paces the backfill batch)", min=1, max=64),
        Option("osd_scrub_interval", float, 86400.0,
               "periodic (shallow) scrub target (s; 0 disables)"),
        Option("osd_deep_scrub_interval", float, 604800.0,
               "periodic deep scrub target (s; 0 disables)"),
        Option("osd_client_message_cap", int, 256,
               "max in-flight client messages"),
        Option("osd_stub_capacity_bytes", int, 1 << 30,
               "synthetic device capacity reported in osd_stats "
               "(drives OSD_NEARFULL)", min=1),
        # -- durable data path (os_store/kvstore.py) ----------------------
        Option("osd_objectstore", str, "walstore",
               "backing store vstart builds for each OSD: walstore = "
               "durable WAL-backed (crash-restartable), memstore = "
               "RAM only",
               enum_allowed=("walstore", "memstore")),
        Option("osd_wal_sync_mode", str, "batch",
               "WAL durability policy: none = never fsync (power "
               "loss eats the tail), batch = group-commit (one fsync "
               "amortized across a flush, the default), always = "
               "fsync per transaction",
               enum_allowed=("none", "batch", "always")),
        Option("osd_wal_compact_min_records", int, 0,
               "checkpoint-compact the WAL (snapshot + atomic "
               "rename) once it holds this many records (0 = manual "
               "compaction only)", min=0),
        # -- device data plane (osd/batch_engine.py) ----------------------
        Option("osd_batch_enable", bool, True,
               "coalesce device ops (EC encode + CRC digest) into "
               "megabatch launches"),
        Option("osd_batch_max_bytes", int, 8 << 20,
               "flush the batch engine at this many pending payload "
               "bytes", min=1),
        Option("osd_batch_max_ops", int, 64,
               "flush the batch engine at this many pending ops",
               min=1),
        Option("osd_batch_flush_ms", float, 0.0,
               "batch accumulation window (ms); 0 = flush each submit "
               "immediately (the CPU-safe synchronous default)",
               min=0.0),
        Option("osd_batch_bucket_floor", int, 32,
               "size-bucket ladder floor (bytes): payloads shorter "
               "than this pad up to it, so a higher floor merges "
               "small-op buckets into fewer launches at the cost of "
               "padding", min=1, max=1 << 20),
        Option("osd_recovery_batch_enable", bool, True,
               "coalesce degraded reads / recovery / backfill decodes "
               "into the batch engine's reconstruct lane"),
        Option("osd_recovery_batch_max_bytes", int, 8 << 20,
               "flush the reconstruct lane at this many pending "
               "survivor bytes", min=1),
        Option("osd_recovery_batch_max_ops", int, 64,
               "flush the reconstruct lane at this many pending "
               "decodes", min=1),
        Option("osd_recovery_batch_flush_ms", float, 0.0,
               "reconstruct-lane accumulation window (ms); 0 = flush "
               "each submit immediately (the CPU-safe synchronous "
               "default)", min=0.0),
        Option("osd_recovery_batch_mesh", bool, False,
               "shard reconstruct megabatches over a (dp, shard) "
               "device mesh when more than one device is visible"),
        Option("osd_compress_batch_enable", bool, True,
               "coalesce inline compression / fingerprint scans into "
               "the batch engine's compression lane"),
        Option("osd_compress_batch_max_bytes", int, 8 << 20,
               "flush the compression lane at this many pending "
               "payload bytes", min=1),
        Option("osd_compress_batch_max_ops", int, 64,
               "flush the compression lane at this many pending ops",
               min=1),
        Option("osd_compress_batch_flush_ms", float, 0.0,
               "compression-lane accumulation window (ms); 0 = flush "
               "each submit immediately (the CPU-safe synchronous "
               "default)", min=0.0),
        Option("osd_compress_segment_bytes", int, 1 << 20,
               "payloads above this split into fixed segments that "
               "batch across objects (streaming compression); 0 = "
               "never segment", min=0),
        Option("osd_dedup_chunk_avg", int, 4096,
               "content-defined chunking target size for dedup "
               "fingerprint scans (min/max derive from it)", min=64),
        # -- erasure coding ----------------------------------------------
        Option("osd_pool_default_erasure_code_profile", str,
               "plugin=jerasure technique=reed_sol_van k=2 m=2",
               "profile for new EC pools"),
        Option("ec_batch_stripes", int, 64,
               "stripes coalesced per TPU launch", Level.ADVANCED,
               min=1, max=65536),
        # -- rgw front door (rgw/gateway.py) ------------------------------
        Option("rgw_frontend_threads", int, 16,
               "request-handler worker pool size (reference "
               "rgw_thread_pool_size)", min=1),
        Option("rgw_max_concurrent_requests", int, 64,
               "admission ceiling: in-flight + queued requests above "
               "the pool get 503 SlowDown (reference "
               "rgw_max_concurrent_requests)", min=0),
        Option("rgw_retry_after", float, 1.0,
               "Retry-After seconds sent with 503 SlowDown",
               min=0.0),
        Option("rgw_obj_stripe_size", int, 4 << 20,
               "multipart part bodies above this stripe into "
               "rgw_obj_stripe_size RADOS objects written "
               "concurrently (feeds the batch engine); 0 = never "
               "stripe (reference rgw_obj_stripe_size)", min=0),
        # -- objectstore --------------------------------------------------
        Option("objectstore", str, "memstore", "backend",
               enum_allowed=("memstore", "kstore")),
        Option("kstore_path", str, "", "kstore data directory"),
        Option("kstore_wal_sync", bool, True,
               "fsync the WAL on each transaction commit"),
        Option("bluestore_debug_inject_read_err", bool, False,
               "fault injection: EIO on reads", Level.DEV),
        Option("osd_debug_smart_media_errors", int, 0,
               "fault injection: synthetic SMART media errors",
               Level.DEV, min=0),
        # -- client -------------------------------------------------------
        Option("client_mount_timeout", float, 30.0,
               "initial mon hunt timeout (s)"),
        Option("objecter_inflight_ops", int, 1024,
               "client op throttle"),
        # RADOS backoff / resend schedule (osdc/objecter.py): the
        # periodic resend ramps exponentially from the base interval
        # to the max, jittered so a wounded cluster sees decorrelated
        # retries; server MOSDBackoff blocks park ops entirely, with
        # the expire guard in case the unblock is lost on the wire
        Option("objecter_resend_interval", float, 2.0,
               "base op resend interval (s)", min=0.1),
        Option("objecter_resend_max", float, 16.0,
               "resend backoff ceiling (s)", min=0.1),
        Option("objecter_resend_jitter", float, 0.25,
               "resend jitter fraction (+/-)", min=0.0, max=1.0),
        Option("objecter_backoff_expire", float, 10.0,
               "drop a server backoff not unblocked within (s)",
               min=0.1),
        # -- tpu ----------------------------------------------------------
        Option("tpu_mesh_shape", str, "auto",
               "device mesh, e.g. '2x4' or 'auto'"),
        Option("tpu_ec_min_batch", int, 8,
               "flush the coalescing ring at this depth", min=1),
        # -- logging / tracking ------------------------------------------
        Option("log_ring_size", int, 10000, "gathered entries kept"),
        Option("op_complaint_time", float, 30.0,
               "slow-op warning age (s)"),
        Option("op_history_size", int, 20, "completed ops kept"),
        Option("osd_op_history_duration", float, 600.0,
               "drop historic ops older than this (s)", min=0.0),
        # -- tracing ------------------------------------------------------
        Option("jaeger_tracing_enable", bool, False,
               "collect per-op spans across daemons"),
        Option("tracer_ring_size", int, 4096,
               "finished spans kept per daemon", min=1),
        Option("tracer_sampling_rate", float, 1.0,
               "fraction of trace roots kept (head sampling)",
               min=0.0, max=1.0),
        Option("tracer_span_budget", int, 0,
               "max trace roots started per second (0 = unlimited)",
               min=0),
        Option("tracer_tail_slow_ms", float, 0.0,
               "pin whole traces whose root closes slower than this "
               "or with an error tag (0 = tail sampling off)",
               min=0.0),
        # -- device profiling ---------------------------------------------
        Option("device_profiling_enable", bool, False,
               "record per-launch device profiles (dispatch/compute "
               "split, bytes, occupancy)"),
        Option("device_profiler_ring_size", int, 1024,
               "launch samples kept per daemon", min=1),
        # -- workload attribution (core/topk.py) --------------------------
        Option("osd_topk_enable", bool, True,
               "track heavy-hitter clients/pools/PGs with per-OSD "
               "space-saving sketches (`ceph osd top`)"),
        Option("osd_topk_k", int, 16,
               "tracked keys per attribution dimension (error bound "
               "shrinks as k grows)", min=1, max=1024),
        Option("osd_exemplar_window_s", float, 60.0,
               "metric→trace exemplar window: the slowest-op trace id "
               "kept per histogram bucket resets this often (s)",
               min=0.1),
        # -- mgr alerts (mgr/alerts.py) -----------------------------------
        Option("mgr_alerts_enable", bool, True,
               "evaluate burn-rate + anomaly alert rules each mgr "
               "tick and post them into mon health"),
        Option("mgr_alerts_slo_budget", float, 0.01,
               "SLO error budget: tolerated fraction of wall time in "
               "violation (burn rate 1.0 = spending exactly this)",
               min=1e-6, max=1.0),
        Option("mgr_alerts_fast_window_s", float, 300.0,
               "fast burn-rate window (SRE 5m); its long "
               "confirmation window is 12x this", min=1.0),
        Option("mgr_alerts_slow_window_s", float, 1800.0,
               "slow burn-rate window (SRE 30m); its long "
               "confirmation window is 12x this", min=1.0),
        Option("mgr_alerts_fast_burn", float, 14.4,
               "burn-rate threshold for the fast (page) rule",
               min=0.0),
        Option("mgr_alerts_slow_burn", float, 6.0,
               "burn-rate threshold for the slow (ticket) rule",
               min=0.0),
        Option("mgr_alerts_anomaly_z", float, 6.0,
               "MAD z-score above which a device-plane rate is "
               "anomalous", min=0.1),
        Option("mgr_alerts_anomaly_min_samples", int, 8,
               "rate samples required before the anomaly detector "
               "judges a series", min=3),
        Option("mgr_alerts_history_size", int, 256,
               "fired/cleared alert transitions kept in the history "
               "ring", min=1),
        # -- black-box flight recorder ------------------------------------
        Option("osd_blackbox_enable", bool, True,
               "journal a crash-surviving per-daemon black box next "
               "to the WAL (spans/clog/perf/profiler tails)"),
        Option("osd_blackbox_max_bytes", int, 1 << 20,
               "rotate the black-box sidecar past this size",
               min=4096),
        Option("osd_blackbox_tail_events", int, 64,
               "timeline entries kept per snapshot and carried into "
               "crash reports", min=1),
    ]
