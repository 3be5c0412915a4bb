#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ceph_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA device; without
one, or without the package beside it, it exits non-zero and prints no
result.  Phases (any failure exits non-zero; each prints its wall
time):

1. build the ten CUDA kernels from ``ceph_tpu_torch/csrc`` with nvcc
   and print the ``-Xptxas -v`` registers and spills of ``gf_words``,
   ``gf_bytes``, ``gf_planes``, ``crc32c_batch``, ``gf2_packets``,
   ``crush_straw2``, ``gear_hash``, ``run_starts`` and ``pgmap_fold``,
   and the
   instructions of one item of ``crush_straw2``'s loop by pipe, read
   from its SASS (``cuobjdump``);
2. hold each kernel against its plain PyTorch version on the card, at
   the main path's shapes and at edge shapes (odd lengths; for
   ``gf_words`` and ``gf_planes`` rows beyond their register tiles, word
   counts off their vector width, batch 1; for ``crc32c_batch`` lengths
   1 to 65539, 1 to 1024 rows, unaligned views and the two-row-set
   entry), byte for byte; and at the write lane's other digest launches
   ([6, 524288] parity rows, the fused [16 + 6, 524288] launch,
   [512, 8192] rows of 64 KiB objects) and the liberation (0, 1) decode
   of ``gf2_packets``; ``crush_straw2`` (K7) at the host level of the
   4096-OSD map ([1 Mi lanes, 64 items]) and at edge shapes (buckets of
   1, 3 and 65 items, an all-zero bucket, 3 weight sets, lane counts off
   the block, [131072, 64]); ``gear_hash`` (K8) and ``run_starts`` (K9)
   at the comp lane's flush ([64, 1 MiB], a row of leading zero bytes)
   and at edge shapes (L 1/31/32/33/4097, rows 1 and 3, views off the
   16-byte boundary); ``crc32c_batch`` at the fingerprint lane's launch
   ([16384, 16384]); ``pgmap_fold`` (K11) exactly at [2^20] PGs of 7
   states, at n 1/31/32/33/1023/65537, with hist_len 2 and above its
   shared-memory cap, and with NaN, exactly-the-grace and negative
   ages, all stale and all fresh;
3. drive the main path at full width, launch counts set to 0 first and
   read after each phase:
   - ``ec_bench``: encode and decode sweep (EC pool k=8 m=3
     reed_sol_van, 4 KiB / 64 KiB / 1 MiB stripes, 64 MiB per launch,
     erasures (0, 9), ``--verify``);
   - K4 leg: ``GFLinear(backend="bytes")`` on the 1 MiB launch shape,
     encode and the (0, 9) decode matrix, held equal to the plain
     ``gf_matmul_gather`` and to the ``words`` route, plus edge lengths
     (n 4/100/1000/4132) at k=8 m=3 and k=20 m=4;
   - plugin sweep: ``ec_bench --verify`` encode and decode at 1 MiB
     stripes, 64 MiB per launch, erasures (0, 1), for jerasure
     liberation / liber8tion / blaum_roth (k=6 m=2), shec k=4 m=3 c=2
     and lrc k=4 m=2 l=3; clay k=4 m=2 d=5 on the host at 8 stripes;
   - OSD write lane (64 writes of 4 MiB objects, then 64 of 64 KiB,
     engine at the OSD option defaults with a 5 ms flush window);
   - recovery lane (the 4 MiB objects rebuilt with shards {1, 9} lost)
     plus 8 recon-lane rechecks;
   - deep scrub: digests of all 64 x 11 stored shards and of 8 objects
     of 16 MiB (segmented), the parity recheck of the 64 stripes with
     two of them corrupted (through the recovery engine's
     ``flush_sync`` and standalone), and culprit isolation;
   - comp (``bench.py::_efficiency_leg``'s sizes): 64 objects of 1 MiB
     through the rle codec (7 of 8 run-structured, 1 of 8 random), one
     K9 launch; 16 objects of 4 MiB through the segment path; a zlib
     pass; every blob expanded and held against a disabled engine,
     pass-throughs, ratio > 1.5; ``[comp]`` GB/s (host clock);
   - fingerprint: 16 random 1 MiB blocks written 4 times each, one flush
     (one K8 launch, one K6 launch over every chunk); spans against the
     host chunker, dedup ratio exactly 4, 256 sampled fingerprints
     against the host's; ``[fingerprint]`` MB/s (host clock);
   - crush: BASELINE row 4's map (4096 OSDs, 64 hosts x 64) with 5% of
     the OSDs out and 5% at half weight; 1 Mi PGs through the replicated
     rule (``chooseleaf_firstn host``, size 3) and an EC pool's
     ``chooseleaf_indep`` rule (result_max 11) on the card, each held
     equal to the plain version on the card for every PG and to the
     scalar ``do_rule`` on 1024 sampled PGs (host processes in
     parallel); then ``osdmaptool --createsimple 4096`` and
     ``--test-map-pgs --require-batched`` (262144 PGs), its PG count and
     engine checked; ``[crush]`` lines give PGs/s (host clock);
   - crushtool: ``--build`` of 4096 OSDs in hosts of 64, ``--test
     --num-rep 3 --show-statistics`` over 1 Mi inputs on the card
     (engine ``batched (cuda)``), and ``--show-mappings`` of 1024 inputs
     equal line for line to ``--scalar`` (8 host processes);
   - store (the OSD's write path below the PG, ``store_phase``): the
     batch engine built from the option defaults as the OSD daemon
     builds it, with a 5 ms window on a ``SafeTimer``, an enabled
     ``Tracer`` and ``store_kick`` on a ``WALStore`` (``sync_mode``
     batch, in a fresh temporary directory whose filesystem type is
     printed); 64 objects of 4 MiB, k=8 m=3, through
     ``submit_encode(span=...)``, each completion queueing one
     transaction per shard into ``1.0s<shard>`` (remove, touch, write,
     the ``"_"`` attribute with the shard's hinfo); kicks equal to the
     flushes, ``megabatch_flush`` spans equal to the launches and
     linking their members, every ``on_commit``; a ``mid_record`` power
     cut in the last flush, recorded by ``on_error``; the remount
     truncates the torn tail, every acknowledged object is read back,
     its data shards held against its payload and every shard
     re-digested by K6 against its stored hinfo; ``objectstore_tool
     --op fsck`` / ``--op list-pgs`` and ``kvstore_tool list``, run as
     three ``python -m`` processes at once, report the store clean; one
     ``store`` JSON line (objects, MiB, records, fsyncs, kicks, flushes,
     append / framing / CRC / replay ms, the host CRC's path and MiB/s,
     spans, the lane's device profiler split);
   - balancer (``balancer_phase``): the crush phase's 64 x 64
     hierarchy with every OSD up and one size-3 replicated pool of 2^20
     PGs (``chooseleaf_firstn host``); ``UpmapBalancer(m, 0,
     device=cuda)`` maps it through K7, every PG equal to the plain
     mapper on the card; ``optimize(max_changes=10)`` equal to a twin
     balancer over the plain placements, the stddev down, no PG with
     two replicas on a host; ``osdmaptool --upmap --upmap-max 10
     --device cuda`` as a process on the same map file writes the same
     commands; one ``[balancer]`` line (mapping ms and launches, round
     ms, stddev before and after, the tool's wall);
   - mon (``mon_phase``), in ``crc`` and then in ``secure`` mode (one
     ``ClusterAuth``; the line names the AEAD branch that ran): three
     port ``Monitor``s on 127.0.0.1 ephemeral ports, each on a
     ``MonitorDBStore`` WAL in a fresh temporary directory (filesystem
     type printed); quorum, then through a ``MonClient``: ``osd
     setcrushmap`` with the crush phase's 4096-OSD map, an EC profile
     k=8 m=3 ``reed_sol_van``, an EC pool and a replicated pool of 2^20
     PGs, ``config-key put/get``, ``log``, ``status``, ``health
     detail``, ``pg summary``; each mutating command answered only
     after its Paxos round committed, every mon at the same version;
     the leader killed, a new one elected and serving, the killed mon
     restarted from its WAL and caught up; one ``[mon]`` line a mode;
     in ``crc`` mode, before the failover, the clients
     (``client_steps``): ``monmaptool --create`` with the quorum's
     addresses, one OSD's boot message (osd.4095, so the mon takes
     upmaps to any of the 4096 OSDs), ``ceph -m`` status, osd tree,
     osd pool ls, osd pool create, osd dump (in process,
     ``main(argv)``), the balancer phase's 10 proposals applied to the
     2^20-PG pool with ``ceph osd pg-upmap-items``, ``Rados.connect``
     with its Objecter at the epoch that carries exactly those upmaps,
     ``list_pools``, ``pool_lookup`` and ``rados lspools``; one
     ``[clients]`` line of host-clock times;
   - controlplane (``controlplane_phase``, ``bench.py::
     _controlplane_leg``'s size): ``ScaleHarness(n_osds=4096,
     pg_num=2^20, seed=1, placement="crush")`` on the card (K7), 1024
     sampled placements against the plain mapper, ``evaluate()`` best
     of 5 beside the reference's 100 ms bar (reported, not gated),
     ``summary()``, ``balancer().optimize(max_changes=10)`` over the
     harness's placements (``balancer_round_ms@1M``), and ``summary_arrays(use_device=True)`` (K11) equal
     to the numpy fold, also at 1% stale PGs and with NaN stamps;
   - cluster (``cluster_phase``): the port's live cluster,
     ``MiniCluster(3 mons, 11 OSDs, device=cuda)`` on WALStores, driven
     through librados: an EC pool k=8 m=3 ``jerasure reed_sol_van`` of
     32 PGs on rule 1 (``choose_indep``, one shard of every object on
     each OSD), the OSDs' options at their defaults but for the
     heartbeat grace; 16 objects of 4 MiB written and read back 16 at a
     time (``rados bench``'s default); osd.3 killed and marked down
     (heartbeat grace 20 s, upstream's), 8 objects rewritten and all 16
     read degraded; the revive, with its 8 shards rebuilt through the recon
     lane, until every PG is clean; every shard and hinfo of every OSD
     against a re-encode on the CPU; a deep scrub of every PG; one
     parity byte flipped with its hinfo rewritten to match, found by the
     deep scrub, attributed to its shard and repaired; one ``[cluster]``
     line a step (wall, kernel launches) and a summary line (write and
     read MB/s, degraded read ms, revive to clean, deep scrub ms a PG,
     the engines' flushes and ops a launch summed over the daemons);
   - rgw (``rgw_phase``), on a ``MiniCluster`` of its own started after
     the cluster phase's has stopped (3 mons, 11 OSDs, ``device=cuda``,
     WALStores, the option defaults but the heartbeat grace):
     ``start_rgw(require_auth=True)`` at ``RGWService``'s defaults
     (pool_size 16, max_concurrent 64, stripe_size 4 MiB) on an EC data
     pool k=8 m=3 ``jerasure reed_sol_van`` of 32 PGs on rule 1; the
     pool read back from the mon (erasure, the k8m3 profile, rule 1);
     ``radosgw-admin user create`` in process, its keys from its JSON;
     every request SigV4-signed by the port's ``S3Client``: a bucket, 16
     seeded PUTs of 4 MiB 2 at a time (each ETag against md5), every GET
     byte for byte 2 at a time and the listing; one multipart upload of
     2 parts of 8 MiB, one part at a time (each part's 2 stripes written
     together), its ETag against the md5 of the part md5s, its GET
     whole; osd.3 killed and marked down (the 20 s grace; the gateway's
     client on that map too, every PG active again), all 17 objects GET
     degraded 2 at a time, with each RADOS op the gateway's client
     resent in that step;
     the revive, until every PG is clean; every OSD's shards and hinfos
     of every ``.rgw.data`` object against a re-encode on the CPU and
     the host CRC-32C; any request the client sent twice (after its 10 s
     socket timeout or a dropped connection) fails the phase; one
     ``[rgw]`` line a step (wall, requests, each request's latency and
     their median and max, launches) and a summary line (PUT, GET and
     multipart MB/s, degraded GET ms an object, revive to clean, the
     write lane's ops a launch summed over the daemons);
   - rbd (``rbd_phase``), on a ``MiniCluster`` of its own started after
     the rgw phase's has stopped (3 mons, 11 OSDs, ``device=cuda``,
     WALStores, the option defaults but the heartbeat grace), every
     launch count set to 0 just before it: an EC pool ``rbd`` k=8 m=3
     ``jerasure reed_sol_van`` of 32 PGs on rule 1, created through
     librados and read back from the mon (erasure, the k8m3 profile,
     rule 1) before the first ``rbd`` command; the ``rbd`` CLI in
     process (``tools.rbd.main``) and the ``Image`` API: ``create`` of a
     16 MiB image at order 22 (4 objects of 4 MiB) and ``info``;
     ``import`` of a seeded 16 MiB file as ``img0`` and its ``export``
     byte for byte; ``bench`` write and read with I/Os of 4 MiB;
     ``snap create img0@s1``, 8 seeded partial writes of 64 KiB (EC
     read-modify-writes), the head against a host model and ``img0@s1``
     against the import; ``snap create img0@s2``, ``export-diff
     --from-snap s1`` applied by ``import-diff`` to a second image that
     holds ``s1``'s bytes, compared with ``s2``; ``snap protect``,
     ``clone img0@s1 child``, one object written into it, ``flatten``,
     ``child`` whole; osd.3 killed, marked down by ``osd down`` and
     waited for in the OSDs' and the client's maps, every PG active, ``img0`` and ``child`` read whole
     degraded and one object written; the revive, until every PG is
     clean; every OSD's shards and hinfos of every ``rbd_data.*``
     object against a re-encode of the host models on the CPU and the
     host CRC-32C; then site B (``MiniCluster(1 mon, 11 OSDs)``, the
     same pool) and ``MirrorDaemon(remote=A, local=B)`` on its own
     thread: a journaled 8 MiB image with 8 seeded writes of 64 KiB,
     a discard, a shrink and a snapshot, replayed until the daemon's
     position is A's journal head and compared on both sites, ``mirror
     demote`` on A and ``mirror promote`` on B (a write on B accepted,
     one on A refused as non-primary); a snapshot-mode 8 MiB image with
     two mirror snapshots and seeded writes between them, each synced
     to B before the next writes, compared; any failed object read of
     the phase's handles (``Image.read`` returns zeros for it), any
     read not done in 300 s (dumped) or any entry in the daemon's
     ``errors`` fails the phase; one ``[rbd]`` line a step (wall, bytes,
     each I/O's latency with their median and max, launches) and a
     summary line (import, export and degraded read MB/s, bench ops/s
     and MB/s, partial-write median and max, revive to clean, the
     mirror lag from the last journaled event to B equal, the write
     lane's ops a launch summed over the daemons);
   - cephfs (``cephfs_phase``), on a ``MiniCluster`` of its own started
     after the rbd phase's have stopped (3 mons, 11 OSDs,
     ``device=cuda``, WALStores, the option defaults but the heartbeat
     grace), every launch count set to 0 just before it, as upstream's
     "Erasure code with CephFS" sets it up: a replicated metadata pool
     (size 3, 16 PGs) and an EC data pool k=8 m=3 ``jerasure
     reed_sol_van`` of 32 PGs on rule 1, both created through librados
     and read back from the mon, ``fs new`` by ``mon_command``; MDS
     ``a`` active and ``b`` standby at the daemon's defaults; one
     client at Ceph's default layout (4 MiB objects): mdtest "easy" over
     4 directories of 16 empty files (mkdir, create, stat, readdir,
     rename, unlink, ops/s a verb); 8 files of 4 MiB and one of 16 MiB,
     each object one ``write`` call, read back byte for byte; 8 seeded
     partial writes of 64 KiB into the 16 MiB file (EC read-modify-
     writes) against a host model; 16 files acked, one request resent
     under its tid, the active MDS killed with its journal unflushed,
     the time until the standby is active, every acked name and size
     and the resend's first answer back; osd.3 marked down by ``osd
     down`` and every file read degraded one object a read, each read's
     hole and gf_planes launches logged; the revive until every PG is
     clean; every OSD's shards and hinfos of every data object against
     a re-encode of the host models on the CPU and the host CRC-32C; the
     16 MiB file unlinked and its data objects gone; one ``[cephfs]``
     line a step (wall, bytes, each op's latency with their median and
     max, launches) and a summary line (ops/s a verb, write, read and
     degraded read MB/s, partial-write median and max, the failover's
     seconds and unflushed journal events, spurious failovers, revive
     to clean, the MDS's perf counters, the write lane's ops a launch);
4. check what came out: every write's shards against the numpy oracle
   ``rs.encode_oracle`` and its hinfo digests against a host CRC-32C,
   the rebuilt shards against the originals, every scrub digest
   against the host CRC-32C, the rechecks and the culprits against the
   corruptions made;
5. time every kernel (CUDA graphs of 20 launches, replayed over 5
   windows of at least 50 ms and 200 launches; median and spread) and
   its plain version at the main path's shape, ``crc32c_batch`` also
   cold (graphs cycling through >= 96 MiB of distinct inputs, twice the
   L2) at the write lane's launch shapes, ``gf2_packets`` also at the
   decode shape, and gf_words at the lrc plugin's per-stripe layer
   shapes, ``crush_straw2`` at the host level's launch shape (its
   operations bound from the SASS count of phase 1: the most loaded of
   issue and the pipes, at the card's SM count and maximum SM clock);
   ``gear_hash`` and ``run_starts`` at [64, 1 MiB] (``run_starts``
   beside the one PyTorch call ``torch.ne(x[:, 1:], x[:, :-1])``);
   ``pgmap_fold`` on the controlplane harness's 2^20 columns, then the
   ``[controlplane]`` line (health, summary, numpy and device folds with
   the copy-in, K11's graph-timed ms); then
   ``[profile]`` lines: per lane (write, recon, comp, fingerprint, store,
   and the cluster's, the gateway's, the block images' and the file
   system's write and recon lanes summed over their daemons)
   and for the crush mappings, the device profiler's launches, dispatch,
   compute (the host's wait at the CUDA events) and gap against the lane's wall,
   and a device-busy estimate (every launch at its kernel's graph-timed
   ms); print one ``kernels`` JSON line (``crc32c_batch``'s ``ms`` is
   its cold time, ``ms_warm`` the graph time of one held input),
   then the card's name and power limit, and last
   ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

K, M = 8, 3
SIZES = (4096, 65536, 1 << 20)          # logical stripe bytes
LAUNCH_BYTES = 64 << 20                 # data bytes per ec_bench launch
ERASED = (0, 9)                         # ec_bench decode erasures
LOST = (1, 9)                           # recovery lane: one data, one parity
OBJ_BIG, OBJ_SMALL, N_OBJ = 4 << 20, 64 << 10, 64
PLUGIN_ERASED = (0, 1)                  # plugin sweep decode erasures
PLUGINS = (                             # (label, ec_bench args, stripes)
    ("jerasure liberation k=6 m=2",
     ["--plugin", "jerasure", "--parameter", "technique=liberation",
      "--parameter", "k=6", "--parameter", "m=2"], 64),
    ("jerasure liber8tion k=6 m=2",
     ["--plugin", "jerasure", "--parameter", "technique=liber8tion",
      "--parameter", "k=6", "--parameter", "m=2"], 64),
    ("jerasure blaum_roth k=6 m=2",
     ["--plugin", "jerasure", "--parameter", "technique=blaum_roth",
      "--parameter", "k=6", "--parameter", "m=2"], 64),
    ("shec k=4 m=3 c=2",
     ["--plugin", "shec", "--parameter", "k=4", "--parameter", "m=3",
      "--parameter", "c=2"], 64),
    ("lrc k=4 m=2 l=3",
     ["--plugin", "lrc", "--parameter", "k=4", "--parameter", "m=2",
      "--parameter", "l=3"], 64),
    # host numpy only: no kernel runs for clay
    ("clay k=4 m=2 d=5",
     ["--plugin", "clay", "--parameter", "k=4", "--parameter", "m=2",
      "--parameter", "d=5"], 8),
)
SCRUB_BIG, N_SCRUB_BIG = 16 << 20, 8    # segmented deep-scrub objects
LRC_CHUNK = 256 << 10                   # lrc k=4 chunk of a 1 MiB stripe
CORRUPT_ONE, CORRUPT_PAIR = (0, 2), (1, (1, 9))  # (object, shard(s))
HBM_BPS = 3.35e12                       # H100 SXM memory rate
INT8_OPS = 1979e12                      # H100 SXM dense int8 rate
CRUSH_HOSTS, CRUSH_PER_HOST = 64, 64    # BASELINE row 4: 4096 OSDs
CRUSH_PGS, CRUSH_SAMPLE = 1 << 20, 1024
CRUSH_EC_WIDTH = 11                     # an EC pool's k + m (8 + 3)
CRUSH_NONE = -0x7FFFFFFF
COMP_OBJ, COMP_N = 1 << 20, 64          # bench.py::_efficiency_leg (chip)
COMP_BIG, COMP_N_BIG = 4 << 20, 16      # the segment path: 64 x 1 MiB
FP_BLOCKS, FP_COPIES = 16, 4            # distinct 1 MiB blocks, copies
FP_AVG, FP_SAMPLE = 4096, 256           # chunker average, sampled fps
FP_CHUNK_ROWS, FP_CHUNK_LEN = 16384, 16384  # K6 at the fingerprint launch
CT_OSDS, CT_PGS, CT_MAPPINGS = 4096, 1 << 20, 1024  # crushtool --test
EDGE_LENGTHS, EDGE_ROWS = (1, 31, 32, 33, 4097), (1, 3)   # K8 / K9 edges
INT_OPS_PER_SM = 64                     # int32 lanes per SM and clock
STORE_N, STORE_OBJ = 64, 4 << 20        # store phase: the write lane's width
STORE_PGID, STORE_FLUSH_MS = "1.0", 5.0
MON_PG_NUM, MON_EC_PG_NUM = 1 << 20, 4096  # mon phase: the pools created
CP_OSDS, CP_PGS, CP_SAMPLE = 4096, 1 << 20, 1024  # _controlplane_leg
BAL_PGS, BAL_MOVES = 1 << 20, 10        # balancer phase: pool, moves
BOOT_OSD = CRUSH_HOSTS * CRUSH_PER_HOST - 1  # the mon phase's booted OSD
HEALTH_BAR_MS = 100.0                   # bench.py:1567, reported only
FOLD_EDGE_ROWS = (1, 31, 32, 33, 1023, 65537)   # K11 edge row counts
CLUSTER_MONS, CLUSTER_OSDS, CLUSTER_PG_NUM = 3, K + M, 32  # live cluster
# RADOS's default object size; 16 objects, not 64 or 32, keep the smoke
# inside its run's 1200 s: at 64 the cluster phase took 380 s on an H100
# 80GB HBM3 host, at 32 up to 230 s, and with the rbd phase a slow host
# had spent 840 s before that phase's second cluster started
CLUSTER_N, CLUSTER_OBJ = 16, 4 << 20
CLUSTER_REWRITE, CLUSTER_KILL = 8, 3    # rewritten while osd.3 is down
CLUSTER_INFLIGHT = 16                   # rados bench's default -t
STUCK_S = 300.0                         # a read's wait before its dump
CLUSTER_HB_GRACE = 20.0                 # upstream's osd_heartbeat_grace
RGW_N, RGW_OBJ = 16, 4 << 20            # S3 PUTs of RADOS's default size
RGW_PART, RGW_PARTS = 8 << 20, 2        # multipart: 2 stripes of 4 MiB a part
# requests in flight: at 4, PUTs took up to 10.04 s and GETs 6.8 s of
# the client's 10 s socket timeout on an H100 80GB HBM3 host
RGW_INFLIGHT = 2
RGW_KILL = 3
# rbd: an image of 4 objects of RADOS's default 4 MiB (order 22), 8
# partial writes of 64 KiB (EC read-modify-writes), mirror images of
# 8 MiB with 8 journaled writes of 64 KiB (journal rows carry the data
# as hex JSON); cut by 4 from 64 MiB, 32 writes, 16 MiB and 32 writes:
# at those sizes the phase took 480 s up to the revive on an H100 80GB
# HBM3 host, and at 16 MiB and 16 journaled writes 354 s on another
RBD_SIZE, RBD_ORDER = 16 << 20, 22
RBD_WRITES, RBD_WRITE = 8, 64 << 10
RBD_KILL = 3
MIRROR_SIZE, MIRROR_WRITES, MIRROR_WRITE = 8 << 20, 8, 64 << 10
# the daemon's pass: each one lists the remote pool and reads every
# journal whole, in the process that serves both sites
MIRROR_INTERVAL = 1.0
# cephfs: upstream's "Erasure code with CephFS" (replicated metadata
# pool of 16 PGs, EC data pool), Ceph's default layout of 4 MiB objects;
# mdtest "easy" at 4 directories of 16 empty files, 8 files of one
# object and one of 4, 8 partial writes of 64 KiB, 16 files acked
# before the MDS failover; cut from a deployment's millions of files.
# At 4 x 64 files the mdtest pass took 105 s of a 177.8 s phase (create
# 14, rename 9.7, unlink 4.3 ops/s) and the smoke 835 s on an H100 80GB
# HBM3 host, where a slow one had spent 717 s before the rbd phase
FS_META_PG = 16
FS_DIRS, FS_FILES = 4, 16
FS_WHOLE, FS_BIG_OBJS = 8, 4
FS_WRITES, FS_WRITE = 8, 64 << 10
FS_ACKED = 16
FS_KILL = 3


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def crc32c_rows_host(rows: np.ndarray, init=0xFFFFFFFF) -> np.ndarray:
    """Host CRC-32C of every row of [n, L] uint8 from the raw register
    ``init`` (scalar or [n]), slice-by-8 vectorised over rows with the
    port's host tables (checked against the scalar ``crc32c`` before
    use)."""
    from ceph_tpu_torch.scrub.crc32c import _T8, _TABLE
    t8 = [np.asarray(t, dtype=np.uint32) for t in _T8]
    tab = np.asarray(_TABLE, dtype=np.uint32)
    n, length = rows.shape
    c = np.zeros(n, dtype=np.uint32) ^ np.uint32(init) \
        if np.isscalar(init) else np.asarray(init, dtype=np.uint32).copy()
    n8 = length & ~7
    words = np.ascontiguousarray(rows[:, :n8]).view("<u4").reshape(n, -1, 2)
    for g in range(words.shape[1]):
        lo = c ^ words[:, g, 0]
        hi = words[:, g, 1]
        c = (t8[0][lo & 0xFF] ^ t8[1][(lo >> 8) & 0xFF]
             ^ t8[2][(lo >> 16) & 0xFF] ^ t8[3][lo >> 24]
             ^ t8[4][hi & 0xFF] ^ t8[5][(hi >> 8) & 0xFF]
             ^ t8[6][(hi >> 16) & 0xFF] ^ t8[7][hi >> 24])
    for j in range(n8, length):
        c = (c >> 8) ^ tab[(c ^ rows[:, j]) & 0xFF]
    return c ^ np.uint32(0xFFFFFFFF)


def crc32c_long_host(objs: np.ndarray, piece: int = 64 << 10) -> np.ndarray:
    """Host CRC-32C of every row of [n, L] uint8 (L a multiple of
    ``piece``): pieces digested side by side by
    :func:`crc32c_rows_host`, then chained with crc(A||B) = T(crc(A))
    ^ crc(B), T the linear map of ``piece`` zero bytes on the raw
    register (its 32 columns from the same host CRC)."""
    n, length = objs.shape
    parts = crc32c_rows_host(objs.reshape(-1, piece)).reshape(n, -1)
    unit = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32))
    cols = crc32c_rows_host(np.zeros((32, piece), dtype=np.uint8),
                            init=unit) ^ np.uint32(0xFFFFFFFF)
    c = parts[:, 0]
    for p in range(1, parts.shape[1]):
        bits = (c[:, None] >> np.arange(32, dtype=np.uint32)) & 1
        c = np.bitwise_xor.reduce(np.where(bits == 1, cols, 0), axis=1,
                                  dtype=np.uint32) ^ parts[:, p]
    return c


def oracle_rows(cmap, rule, xs, result_max, weight) -> np.ndarray:
    """The scalar ``do_rule`` of every input, NONE-padded rows."""
    from ceph_tpu_torch.crush.mapper import do_rule
    out = np.full((len(xs), result_max), CRUSH_NONE, dtype=np.int32)
    for j, x in enumerate(xs):
        row = do_rule(cmap, rule, int(x), result_max, weight)
        out[j, :len(row)] = row
    return out


def straw2_edge_tables(K7, dev, sizes, positions, seed, zero_rows=()):
    """Random K7 tables of buckets of ``sizes`` items (every 7th weight
    0, ``zero_rows`` all 0) with ``positions`` weight sets."""
    rng = np.random.default_rng(seed)
    nb, S = len(sizes), max(sizes)
    items = rng.integers(0, 1 << 20, size=(nb, S)).astype(np.int32)
    hids = rng.integers(-(1 << 31), 1 << 31, size=(nb, S)).astype(np.int32)
    w = rng.integers(0, 4 * 0x10000, size=(positions, nb, S))
    w[:, :, ::7] = 0
    for row in zero_rows:
        w[:, row] = 0
    return K7.Straw2Tables(items, hids, w, sizes, dev), rng


def straw2_lanes(torch, dev, rng, rows, n, positions):
    """K7 lane arguments: bucket rows drawn from ``rows``, u32 inputs,
    draw indices 0..7, positions (some past the last weight set)."""
    return [torch.from_numpy(a).to(dev) for a in (
        rng.choice(np.asarray(rows), size=n),
        rng.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.int64),
        rng.integers(0, 8, size=n), rng.integers(0, positions + 1, size=n))]


def crush_phase(dev, rng, build, hosts: int, per_host: int, n_pgs: int,
                n_sample: int, profiler) -> tuple[float, int]:
    """Map ``n_pgs`` PGs on the ``hosts`` x ``per_host`` OSD map through
    the replicated and the EC rule on ``dev`` (the two mappings recorded
    by ``profiler``), each held against the plain version and
    ``do_rule``, then run ``osdmaptool --createsimple`` and
    ``--test-map-pgs`` on it.  Returns the two mappings' wall seconds
    and their K7 launches."""
    import torch
    from ceph_tpu_torch.crush import straw2 as K7
    from ceph_tpu_torch.crush.map import build_hierarchy
    from ceph_tpu_torch.crush.torch_mapper import BatchMapper
    from ceph_tpu_torch.tools import osdmaptool
    # CRUSH placement: BASELINE row 4 (4096 OSDs, 1 Mi PGs), with 5% of
    # the OSDs out and 5% at half weight so is_out and the retries run
    n_osd = hosts * per_host
    crush_rw = np.full(n_osd, 0x10000, dtype=np.uint32)
    order = rng.permutation(n_osd)
    crush_rw[order[:n_osd // 20]] = 0
    crush_rw[order[n_osd // 20:n_osd // 10]] = 0x8000
    pgs = np.arange(n_pgs, dtype=np.uint32)
    sample = np.sort(rng.choice(n_pgs, size=n_sample, replace=False))
    rules = (("replicated chooseleaf_firstn host", "chooseleaf_firstn", 3),
             ("EC chooseleaf_indep host", "chooseleaf_indep",
              CRUSH_EC_WIDTH))
    maps = {name: build_hierarchy(1, hosts, per_host, rule=name)
            for _label, name, _w in rules}
    got = {}
    mapped_s, mapped_k7 = 0.0, 0
    for label, name, width in rules:
        mapper = BatchMapper(maps[name], 0, result_max=width, device=dev)
        before = build.counts()["crush_straw2"]
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        with profiler.bind():
            got[name] = mapper(pgs, crush_rw)
        dt = time.perf_counter() - t0
        mapped_s += dt
        k7_launches = build.counts()["crush_straw2"] - before
        mapped_k7 += k7_launches
        if k7_launches <= 0:
            fail(f"crush {label}: K7 was not launched")
        log(f"[crush] {label}: {n_pgs} PGs on {n_osd} OSDs in "
            f"{dt * 1e3:.1f} ms = {n_pgs / dt:,.0f} PGs/s (host clock, "
            f"chunks of {mapper._chunk()} PGs, {k7_launches} crush_straw2 "
            f"launches, peak {torch.cuda.max_memory_allocated(dev) >> 20} "
            f"MiB allocated, {got[name].shape[1]} slots, "
            f"{int((got[name] == CRUSH_NONE).sum())} NONE)")
    # then, with the timings taken, do_rule on the sample in host
    # processes (spawned, joined on leaving the block) while the card
    # runs the plain version (in the smaller chunks its [lanes, S] rows
    # allow: placements do not depend on the chunk)
    workers = max(1, min(8, os.cpu_count() or 1))
    t_ref = time.perf_counter()
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        refs = {name: [pool.submit(oracle_rows, maps[name], 0, part, width,
                                   [int(v) for v in crush_rw])
                       for part in np.array_split(pgs[sample], workers)]
                for _label, name, width in rules}
        for label, name, width in rules:
            plain = BatchMapper(maps[name], 0, result_max=width, device=dev)
            plain._straw2 = K7.straw2_plain
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            want = plain(pgs, crush_rw)
            dt_plain = time.perf_counter() - t0
            diff = int((~(got[name] == want).all(axis=1)).sum())
            if diff:
                fail(f"crush {label}: {diff} PGs differ from the plain "
                     f"version")
            log(f"[crush] {label}: all {n_pgs} PGs equal the plain version "
                f"on the card ({dt_plain * 1e3:.1f} ms in chunks of "
                f"{plain._chunk()} PGs, peak "
                f"{torch.cuda.max_memory_allocated(dev) >> 20} MiB "
                f"allocated, host processes running beside it)")
        for label, name, width in rules:
            ref = np.concatenate([f.result() for f in refs[name]])
            diff = int((~(got[name][sample] == ref).all(axis=1)).sum())
            if diff:
                fail(f"crush {label}: {diff} of {n_sample} sampled PGs "
                     f"differ from do_rule")
            log(f"[crush] {label}: {n_sample} sampled PGs equal do_rule "
                f"({workers} host processes, "
                f"{time.perf_counter() - t_ref:.1f} s since they started)")
    with tempfile.TemporaryDirectory() as tmp:
        mapfile = os.path.join(tmp, "osdmap.json")
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = osdmaptool.main([mapfile, "--createsimple", str(n_osd)])
            t0 = time.perf_counter()
            rc2 = osdmaptool.main([mapfile, "--test-map-pgs",
                                   "--require-batched", "--device",
                                   dev.type])
            dt = time.perf_counter() - t0
        if rc or rc2:
            fail(f"osdmaptool exited {rc}, {rc2}: {err.getvalue()[-400:]}")
        pool = osdmaptool.load_osdmap(mapfile).pools[0]
    report = out.getvalue().splitlines()
    mapped = sum(int(ln.split("\t")[1]) for ln in report
                 if ln.startswith("osd."))
    if mapped != pool.pg_num * pool.size:
        fail(f"osdmaptool --test-map-pgs mapped {mapped} PG slots, want "
             f"{pool.pg_num} x {pool.size}")
    if f"osdmaptool: engine: batched ({dev.type})" not in err.getvalue():
        fail(f"osdmaptool did not name the batched mapper: "
             f"{err.getvalue()[-400:]}")
    log(f"[crush] osdmaptool --createsimple {n_osd} --test-map-pgs "
        f"--require-batched: {pool.pg_num} PGs x {pool.size} = {mapped} "
        f"slots, engine batched ({dev.type}); "
        f"{[ln for ln in report if ln.startswith('mapped ')][0]}; "
        f"{pool.pg_num / dt:,.0f} PGs/s with the report (host clock)")
    return mapped_s, mapped_k7


def comp_payloads(rng, n: int, size: int) -> list[bytes]:
    """bench.py::_efficiency_leg's mix: 7 of 8 run-structured (runs of
    16-127 bytes, device logs and zero pages), 1 of 8 random (must pass
    through)."""
    out = []
    for i in range(n):
        if i % 8 == 7:
            out.append(rng.integers(0, 256, size, np.uint8).tobytes())
        else:
            run = int(rng.integers(16, 128))
            vals = rng.integers(0, 256, size // run + 1, np.uint8)
            out.append(np.repeat(vals, run)[:size].tobytes())
    return out


def comp_phase(dev, n_obj: int, obj: int, n_big: int, big: int,
               profiler) -> dict:
    """The comp lane's compress path on ``dev``: ``n_obj`` objects of
    ``obj`` bytes through the rle codec (one K9 launch when they fill
    ``max_ops``), ``n_big`` objects of ``big`` bytes through the segment
    path, and one zlib pass (host codec, no launch); every result held
    against a disabled engine's and expanded back to its payload."""
    from ceph_tpu_torch.compress.registry import create_codec
    from ceph_tpu_torch.osd.batch_engine import BatchEngine
    rng = np.random.default_rng(19)
    payloads = comp_payloads(rng, n_obj, obj)
    bigs = comp_payloads(rng, n_big, big)
    rle, zlib_codec = create_codec("rle"), create_codec("zlib")
    # bench.py's engine: no deadline timer, so the lane flushes when
    # max_ops members have come (one launch of all of them) or at drain
    eng = BatchEngine("comp", device=dev, flush_ms=2.0, max_ops=n_obj,
                      max_bytes=n_obj * obj, comp_segment_bytes=obj,
                      profiler=profiler)
    eng.submit_compress(rle, payloads[0])           # warm the bucket
    eng.drain()
    eng.stats.clear()
    profiler.reset()
    t0 = time.perf_counter()
    comps = [eng.submit_compress(rle, p) for p in payloads]
    eng.drain()
    wall = time.perf_counter() - t0
    stats = dict(eng.stats)
    profile = profiler.aggregate()["totals"]
    seg = [eng.submit_compress(rle, p) for p in bigs]
    eng.drain()
    zc = [eng.submit_compress(zlib_codec, p) for p in payloads]
    eng.drain()
    off = BatchEngine("comp-off", device=dev, enabled=False,
                      comp_segment_bytes=obj)
    results = {}
    for label, cs, ps, codec in (("rle", comps, payloads, rle),
                                 ("rle segmented", seg, bigs, rle),
                                 ("zlib", zc, payloads, zlib_codec)):
        got = [c.result(timeout=600) for c in cs]
        for (blob, hdr), p in zip(got, ps):
            if (bytes(blob) if hdr is None else eng.decompress(blob, hdr)) \
                    != p:
                fail(f"comp {label}: a sealed blob does not expand to its "
                     f"payload")
        if got != [off.submit_compress(codec, p).result() for p in ps]:
            fail(f"comp {label}: results differ from the disabled engine")
        results[label] = got
    passthrough = sum(hdr is None for _b, hdr in results["rle"])
    ratio = stats["comp_bytes_in"] / max(1, stats["comp_bytes_out"])
    if passthrough < n_obj // 8:
        fail(f"comp: {passthrough} pass-throughs, want >= {n_obj // 8}")
    if ratio <= 1.5:
        fail(f"comp: ratio {ratio:.3f} <= 1.5")
    segs = [hdr for _b, hdr in results["rle segmented"] if hdr]
    eng.stop()
    off.stop()
    return {"wall_s": wall, "GBps": n_obj * obj / wall / 1e9,
            "profile": profile, "ratio": ratio, "passthrough": passthrough,
            "launches": stats.get("comp_launches", 0),
            "segmented": len(segs),
            "segments": sum(len(h["segs"]) for h in segs)}


def fingerprint_phase(dev, n_blocks: int, copies: int, size: int, avg: int,
                      n_sample: int, profiler) -> dict:
    """The comp lane's fingerprint path on ``dev``: ``n_blocks`` random
    blocks of ``size`` bytes, each written ``copies`` times in a shuffled
    order (backup and VM-image copies into a dedup pool), in one flush;
    spans held against the host chunker, the dedup ratio against
    ``copies``, sampled fingerprints against the host ``fingerprint``."""
    from ceph_tpu_torch.compress.chunker import Chunker, fingerprint
    from ceph_tpu_torch.osd.batch_engine import BatchEngine
    rng = np.random.default_rng(23)
    blocks = [rng.integers(0, 256, size, np.uint8).tobytes()
              for _ in range(n_blocks)]
    order = list(range(n_blocks)) * copies
    rng.shuffle(order)
    chunker = Chunker(avg_size=avg)
    n = len(order)
    eng = BatchEngine("fingerprint", device=dev, flush_ms=2.0, max_ops=n,
                      max_bytes=n * size, profiler=profiler)
    t0 = time.perf_counter()
    comps = [eng.submit_fingerprint(chunker, blocks[i]) for i in order]
    eng.drain()
    wall = time.perf_counter() - t0
    profile = profiler.aggregate()["totals"]
    spans = [c.result(timeout=600) for c in comps]
    host = {}
    for b, got in zip(order, spans):
        if b not in host:
            host[b] = chunker.chunks(blocks[b])
        if [(o, ln) for o, ln, _f in got] != host[b]:
            fail("fingerprint: spans differ from the host Chunker.chunks")
        if sum(ln for _o, ln, _f in got) != size:
            fail("fingerprint: spans do not tile their object")
    uniq = {}
    for got in spans:
        for _o, ln, fp in got:
            uniq.setdefault(fp, ln)
    referenced = sum(ln for got in spans for _o, ln, _f in got)
    if referenced != copies * sum(uniq.values()):
        fail(f"fingerprint: dedup ratio "
             f"{referenced / sum(uniq.values()):.4f} != {copies}")
    flat = [(b, o, ln, fp) for b, got in zip(order, spans)
            for o, ln, fp in got]
    for j in rng.choice(len(flat), size=min(n_sample, len(flat)),
                        replace=False):
        b, o, ln, fp = flat[j]
        if fingerprint(blocks[b][o:o + ln]) != fp:
            fail("fingerprint: a lane fingerprint differs from the host's")
    stats = dict(eng.stats)
    eng.stop()
    return {"wall_s": wall, "MBps": n * size / wall / 1e6, "profile": profile,
            "chunks": len(flat), "unique": len(uniq),
            "dedup_ratio": referenced / sum(uniq.values()),
            "launches": stats.get("comp_launches", 0)}


def crushtool_phase(dev, n_osd: int, n_pgs: int, n_mappings: int) -> dict:
    """``crushtool --build`` (4096 OSDs, hosts of 64 under one straw2
    root), ``--test --show-statistics`` over ``n_pgs`` inputs on ``dev``,
    and ``--show-mappings`` of the first ``n_mappings`` on ``dev``
    against ``--scalar`` (in 8 host processes, each a slice of x)."""
    from ceph_tpu_torch.tools import crushtool
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        mapf = os.path.join(tmp, "crush.json")
        if crushtool.main(["--build", "--num-osds", str(n_osd), "host",
                           "straw2", "64", "root", "straw2", "0", "-o",
                           mapf]):
            fail("crushtool --build failed")
        test = ["-i", mapf, "--test", "--num-rep", "3"]
        workers = max(1, min(8, os.cpu_count() or 1))
        bounds = np.linspace(0, n_mappings, workers + 1).astype(int)
        procs = [subprocess.Popen(
            [sys.executable, "-m", "ceph_tpu_torch.tools.crushtool", *test,
             "--min-x", str(lo), "--max-x", str(hi - 1), "--show-mappings",
             "--scalar"], cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for lo, hi in zip(bounds[:-1], bounds[1:])]
        try:
            runs = {}
            for label, args in (
                    ("statistics", ["--min-x", "0", "--max-x",
                                    str(n_pgs - 1), "--show-statistics"]),
                    ("mappings", ["--min-x", "0", "--max-x",
                                  str(n_mappings - 1), "--show-mappings"])):
                out, err = io.StringIO(), io.StringIO()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(out), \
                        contextlib.redirect_stderr(err):
                    rc = crushtool.main(test + args + [
                        "--require-batched", "--device", dev.type])
                runs[label] = (rc, out.getvalue(), err.getvalue(),
                               time.perf_counter() - t0)
            scalar = [p.communicate(timeout=600) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for label, (rc, _out, err, _dt) in runs.items():
        if rc:
            fail(f"crushtool --test --show-{label} exited {rc}: {err[-400:]}")
        if f"crushtool: engine: batched ({dev.type})" not in err:
            fail(f"crushtool --show-{label} did not name the batched "
                 f"mapper: {err[-400:]}")
    if any(p.returncode for p in procs):
        fail(f"crushtool --scalar failed: {scalar[0][1][-400:]}")
    stats = runs["statistics"][1].splitlines()
    counted = sum(int(ln.split("\t")[1].split("/")[0]) for ln in stats)
    if counted != n_pgs or not stats:
        fail(f"crushtool --show-statistics counts {counted} of {n_pgs}")
    if runs["mappings"][1] != "".join(out for out, _err in scalar):
        fail("crushtool --show-mappings differs from --scalar")
    return {"stats": stats, "seconds": runs["statistics"][3],
            "mappings_s": runs["mappings"][3], "workers": workers}


def obj_meta(version, size: int, hinfo: int | None = None) -> bytes:
    """An object's ``"_"`` attribute as ``ceph_tpu.osd.pg._obj_meta``
    builds it: version, logical size and the shard's hinfo CRC-32C."""
    d = {"version": list(version), "size": size}
    if hinfo is not None:
        d["hinfo"] = hinfo
    return json.dumps(d).encode()


def osd_engine(cfg, dev, **hooks):
    """The batch engine as ``ceph_tpu.osd.daemon`` builds it from its
    ``osd_*batch*`` options (the port has no ``use_mesh``)."""
    from ceph_tpu_torch.osd.batch_engine import BatchEngine
    return BatchEngine(
        "osd.0", device=dev, enabled=cfg["osd_batch_enable"],
        max_bytes=cfg["osd_batch_max_bytes"],
        max_ops=cfg["osd_batch_max_ops"],
        flush_ms=cfg["osd_batch_flush_ms"],
        recon_enabled=cfg["osd_recovery_batch_enable"],
        recon_max_bytes=cfg["osd_recovery_batch_max_bytes"],
        recon_max_ops=cfg["osd_recovery_batch_max_ops"],
        recon_flush_ms=cfg["osd_recovery_batch_flush_ms"],
        comp_enabled=cfg["osd_compress_batch_enable"],
        comp_max_bytes=cfg["osd_compress_batch_max_bytes"],
        comp_max_ops=cfg["osd_compress_batch_max_ops"],
        comp_flush_ms=cfg["osd_compress_batch_flush_ms"],
        comp_segment_bytes=cfg["osd_compress_segment_bytes"],
        bucket_floor=cfg["osd_batch_bucket_floor"], **hooks)


def fs_type(path: str) -> str:
    """The filesystem type of the mount holding ``path``."""
    path, best = os.path.realpath(path), ("", "?")
    with open("/proc/mounts") as f:
        for line in f:
            mnt, kind = line.split()[1:3]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) \
                    and len(mnt) >= len(best[0]):
                best = (mnt, kind)
    return best[1]


def run_tools(commands: dict) -> dict:
    """Offline tools of the port as a user runs them (``python -m``), all
    at once, one process each: {label: (exit code, stdout)}."""
    here = os.path.dirname(os.path.abspath(__file__))
    procs = {label: subprocess.Popen(
        [sys.executable, "-m", f"ceph_tpu_torch.tools.{tool}", *argv],
        cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for label, (tool, argv) in commands.items()}
    out = {}
    for label, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        if proc.returncode and stderr:
            log(f"[tools] {label}: {stderr.strip()[-2000:]}")
        out[label] = (proc.returncode, stdout)
    return out


def store_phase(dev, n_obj: int, obj: int, seed: int = 23) -> dict:
    """The OSD's write path below the PG on ``dev``: the batch engine as
    the daemon builds it (option defaults, a ``flush_ms`` window on a
    ``SafeTimer``, an enabled ``Tracer``, ``store_kick`` on the store)
    encodes ``n_obj`` objects of ``obj`` bytes at k=8 m=3; each
    completion queues one transaction per shard (remove, touch, write,
    the ``"_"`` attribute with the shard's hinfo) into collection
    ``<pgid>s<shard>`` of one ``WALStore`` in ``sync_mode="batch"``.
    The last flush meets a ``mid_record`` power cut; the store is
    remounted, every acknowledged object read back and re-digested on
    ``dev`` with K6, and the offline tools check the store."""
    import random

    import torch
    from ceph_tpu_torch.core.config import ConfigProxy
    from ceph_tpu_torch.core.device_profiler import DeviceProfiler
    from ceph_tpu_torch.core.options import build_options
    from ceph_tpu_torch.core.perf_counters import PerfCountersBuilder
    from ceph_tpu_torch.core.threading_utils import SafeTimer
    from ceph_tpu_torch.core.tracer import Tracer
    from ceph_tpu_torch.ec import create_erasure_code
    from ceph_tpu_torch.os_store import (CrashInjector, SimulatedPowerLoss,
                                         Transaction, WALStore, walog)
    from ceph_tpu_torch.scrub.crc32c import crc32c_rows
    n = K + M
    chunk = obj // K
    cfg = ConfigProxy(build_options())
    cfg.set("osd_batch_flush_ms", STORE_FLUSH_MS, "cmdline")
    cfg.set("jaeger_tracing_enable", True, "cmdline")
    per_flush = min(cfg["osd_batch_max_ops"],
                    -(-cfg["osd_batch_max_bytes"] // obj))
    if n_obj % per_flush or n_obj < 2 * per_flush:
        fail(f"store: {n_obj} objects do not fill whole flushes of "
             f"{per_flush}")
    perf = (PerfCountersBuilder("osd.0")
            .add_u64_counter("device_launches").add_time_avg("device_dispatch")
            .add_time_avg("device_compute").add_u64_counter("device_bytes_in")
            .add_u64_counter("device_bytes_out")
            .add_histogram("device_launch_hist").create_perf_counters())
    prof = DeviceProfiler("osd.0", enabled=True, perf=perf)
    tracer = Tracer(daemon="osd.0", ring_size=cfg["tracer_ring_size"],
                    enabled=cfg["jaeger_tracing_enable"],
                    sampling_rate=cfg["tracer_sampling_rate"],
                    span_budget=cfg["tracer_span_budget"],
                    tail_slow_s=cfg["tracer_tail_slow_ms"] / 1e3,
                    rng=random.Random(seed))
    tmp = tempfile.mkdtemp(prefix="store_phase_")
    path = os.path.join(tmp, "osd.0.wal")
    crash = CrashInjector(seed=seed, osd="osd.0")
    store = WALStore(path, sync_mode=cfg["osd_wal_sync_mode"], crash=crash,
                     name="osd.0")
    errors, unexpected = [], []
    store.on_error = errors.append          # the daemon's _on_store_error
    store.mount()
    mk = Transaction()
    for s in range(n):
        mk.create_collection(f"{STORE_PGID}s{s}")
    store.queue_transaction(mk)
    timer = SafeTimer("osd.0-timer")
    eng = osd_engine(cfg, dev, profiler=prof, tracer=tracer,
                     schedule=lambda d, fn: timer.add_event_after(d, fn),
                     store_kick=store.kick)
    ec = create_erasure_code({"plugin": "torch_cuda", "k": K, "m": M,
                              "technique": "reed_sol_van"}, device=dev)
    payloads = np.random.default_rng(seed).integers(
        0, 256, size=(n_obj, obj), dtype=np.uint8)
    lock = threading.Lock()
    acks = [0] * n_obj
    held, lost = {}, []
    queue_s = [0.0]
    fsyncs = [0, 0.0]
    real_fsync = os.fsync

    def timed_fsync(fd):
        t0 = time.perf_counter()
        real_fsync(fd)
        fsyncs[0] += 1
        fsyncs[1] += time.perf_counter() - t0

    def committed(i):
        with lock:
            acks[i] += 1

    def encoded(i, comp):
        try:
            shards, hinfos = comp.value
            held[i] = hinfos
            oid = f"obj{i}"
            for s in range(n):
                cid = f"{STORE_PGID}s{s}"
                t0 = time.perf_counter()
                txn = (Transaction().remove(cid, oid).touch(cid, oid)
                       .write(cid, oid, 0, shards[s])
                       .setattrs(cid, oid, {"_": obj_meta(
                           (1, i + 1), obj, hinfo=hinfos[s])}))
                try:
                    store.queue_transaction(
                        txn, on_commit=lambda i=i: committed(i))
                except SimulatedPowerLoss:
                    lost.append((i, s))
                queue_s[0] += time.perf_counter() - t0
        except Exception as e:      # noqa: BLE001 — reported, fails below
            unexpected.append(repr(e))

    def submit(ids):
        out = []
        for i in ids:
            op = tracer.start_span("osd_op", tags={"layer": "osd"})
            span = tracer.start_span("gf_encode", parent=op, tags={
                "layer": "device", "kernel": "gf_encode", "bytes": obj})
            out.append((i, op, span, eng.submit_encode(
                ec, payloads[i], span=span,
                callback=lambda c, i=i: encoded(i, c))))
        eng.drain()             # every completion has queued its shards
        for i, op, span, comp in out:
            comp.result(timeout=600)
            span.finish()
            op.finish()
        return [span.span_id for _i, _o, span, _c in out]

    os.fsync = timed_fsync
    try:
        t0 = time.perf_counter()
        encode_spans = submit(range(n_obj - per_flush))
        if not store.flush_commits(timeout=600):
            fail("store: group commit did not drain")
        wall = time.perf_counter() - t0
        acked = [i for i, a in enumerate(acks) if a == n]
        if acked != list(range(n_obj - per_flush)):
            fail(f"store: {n_obj - per_flush - len(acked)} objects lack "
                 f"their on_commit")
        stats_pre = dict(store.wal_stats)
        # the crash leg: a power cut partway through the first record of
        # the last flush
        crash.arm("mid_record")
        encode_spans += submit(range(n_obj - per_flush, n_obj))
    finally:
        os.fsync = real_fsync
    eng.stop()
    timer.shutdown()
    stats = dict(eng.stats)
    if unexpected:
        fail(f"store: completion errors {unexpected}")
    if len(errors) != 1 or not isinstance(errors[0], SimulatedPowerLoss) \
            or [p for p, _n in crash.fired] != ["mid_record"]:
        fail(f"store: want one injected mid_record power loss, got "
             f"{errors} (fired {crash.fired})")
    if sorted({i for i, _s in lost}) != list(range(n_obj - per_flush,
                                                   n_obj)) \
            or any(acks[i] for i in range(n_obj - per_flush, n_obj)):
        fail(f"store: the last flush's objects were acknowledged ({lost})")
    wal_bytes = store.wal_stats["bytes"]
    store.process_death()                   # forget it, remount the path
    flushes = sum(v for k, v in stats.items() if k.startswith("flush_"))
    if stats.get("store_kicks") != flushes:
        fail(f"store: {stats.get('store_kicks')} kicks for {flushes} "
             f"flushes")
    spans = [s for s in tracer.dump() if s["name"] == "megabatch_flush"]
    if len(spans) != stats["launches"]:
        fail(f"store: {len(spans)} megabatch_flush spans for "
             f"{stats['launches']} launches")
    if sorted(l["s"] for s in spans for l in s["links"]) != \
            sorted(encode_spans) or any(
                len(s["links"]) != s["tags"]["members"] for s in spans):
        fail("store: the flush spans do not link their member op spans")

    t0 = time.perf_counter()
    again = WALStore(path, name="osd.0")
    again.mount()
    replay = time.perf_counter() - t0
    rs_ = again.replay_stats
    n_acked = n_obj - per_flush
    if rs_["clean_shutdown"] or rs_["tail"]["status"] != "torn" \
            or rs_["records"] != 1 + n_acked * n \
            or os.path.getsize(path) != wal_bytes:
        fail(f"store: remount replay {rs_}, size {os.path.getsize(path)} "
             f"(want the torn tail truncated to {wal_bytes})")
    rows, metas = [], []
    for i in range(n_obj):
        for s in range(n):
            cid, oid = f"{STORE_PGID}s{s}", f"obj{i}"
            if i >= n_acked:
                if again.exists(cid, oid):
                    fail(f"store: unacknowledged {cid}/{oid} survived")
                continue
            rows.append(np.frombuffer(again.read(cid, oid), np.uint8))
            meta = json.loads(again.getattr(cid, oid, "_"))
            if meta["version"] != [1, i + 1] or meta["size"] != obj:
                fail(f"store: {cid}/{oid} meta {meta}")
            metas.append(meta["hinfo"])
        if i < n_acked and b"".join(
                rows[-n + s].tobytes() for s in range(K)) != \
                payloads[i].tobytes():
            fail(f"store: object {i}'s data shards differ from its payload")
    stack = torch.from_numpy(np.stack(rows)).to(dev)
    digests = crc32c_rows(stack).cpu().numpy().view(np.uint32).tolist()
    want = [held[i][s] for i in range(n_acked) for s in range(n)]
    if digests != metas or metas != want:
        fail("store: shards read back do not digest to their hinfos")
    again.umount()
    del stack

    # the host CRC of the records, alone
    with open(path, "rb") as f:
        head = f.read(64 << 20)
    recs = walog.scan_records(head)[0]
    t0 = time.perf_counter()
    for r in recs:
        walog.crc32c(r)
    crc_s = time.perf_counter() - t0
    crc_mib = sum(map(len, recs)) / 2**20
    # the hex + JSON framing of one shard record, alone (8 samples)
    sample = Transaction().remove("c", "o").touch("c", "o").write(
        "c", "o", 0, payloads[0][:chunk].tobytes()).setattrs(
        "c", "o", {"_": obj_meta((1, 1), obj, hinfo=0)})
    t0 = time.perf_counter()
    for _ in range(8):
        json.dumps(sample.to_dict(), separators=(",", ":")).encode()
    frame_s = (time.perf_counter() - t0) / 8
    t0 = time.perf_counter()
    runs = run_tools({
        "fsck": ("objectstore_tool", ["--data-path", path, "--op", "fsck"]),
        "list-pgs": ("objectstore_tool",
                     ["--data-path", path, "--op", "list-pgs"]),
        "kvstore": ("kvstore_tool", [path, "list"])})
    tools_s = time.perf_counter() - t0
    rc, out = runs["fsck"]
    report = json.loads(out) if out.strip() else {}
    if rc or not report or report["issues"] \
            or report["tail"]["status"] != "clean" \
            or report["records"] != 1 + n_acked * n:
        fail(f"store: objectstore_tool fsck rc {rc}: {report}")
    rc, out = runs["list-pgs"]
    if rc or out.split() != [STORE_PGID]:
        fail(f"store: objectstore_tool list-pgs rc {rc}: {out!r}")
    rc, out = runs["kvstore"]
    if rc or out or os.path.getsize(path) != wal_bytes:
        fail(f"store: kvstore_tool list rc {rc}: {out!r}")
    kind = fs_type(tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    tot = prof.aggregate()["totals"]
    return {
        "objects": n_obj, "acked": n_acked, "fs": kind,
        "shard_MiB": n_acked * n * chunk / 2**20,
        "wal_MiB": wal_bytes / 2**20, "records": stats_pre["records"],
        "syncs": stats_pre.get("group_syncs", 0),
        "fsyncs": fsyncs[0], "fsync_ms": fsyncs[1] * 1e3,
        "kicks": stats["store_kicks"], "flushes": flushes,
        "launches": stats["launches"], "spans": len(spans),
        "append_ms": queue_s[0] * 1e3, "wall_ms": wall * 1e3,
        "frame_ms": frame_s * stats_pre["records"] * 1e3,
        "crc_ms": wal_bytes / 2**20 / (crc_mib / crc_s) * 1e3,
        "replay_ms": replay * 1e3, "tools_ms": tools_s * 1e3,
        "crc_path": walog.CRC_PATH, "crc_MiBps": crc_mib / crc_s,
        "torn_tail": rs_["tail"],
        "profile": {"launches": tot["launches"],
                    "dispatch_ms": tot["dispatch_s"] * 1e3,
                    "compute_ms": tot["compute_s"] * 1e3,
                    "gap_ms": tot["gap_s"] * 1e3}, "totals": tot,
        "perf_device_launches": perf.get("device_launches")}


class StepClock:
    """The steps of a live-cluster phase: each one's wall, its kernel
    launches and its OSDs' device-profiler lanes summed over
    ``daemons`` (every OSD daemon of the run, a killed one too; each
    profiler restarts for the next step)."""

    def __init__(self, tag: str, dev):
        from ceph_tpu_torch.kernels import build
        self.tag, self.dev, self.build = tag, dev, build
        self.steps, self.daemons = {}, []
        self.mark = [build.counts(), time.perf_counter()]

    def close(self, name: str, extra: str = "") -> dict:
        if self.dev.type == "cuda":
            import torch
            torch.cuda.synchronize(self.dev)
        now, t = self.build.counts(), time.perf_counter()
        lanes = {}
        for d in self.daemons:
            for lane, agg in d.profiler.aggregate()["lanes"].items():
                tot = lanes.setdefault(lane, dict.fromkeys(agg, 0))
                for k, v in agg.items():
                    tot[k] += v
            d.profiler.reset()
        then = self.mark[0]
        step = self.steps[name] = {
            "s": t - self.mark[1], "lanes": lanes, "launches": {
                k: now[k] - then.get(k, 0) for k in now
                if now[k] - then.get(k, 0)}}
        self.mark = [now, t]
        log(f"[{self.tag}] {name}: {step['s']:.3f} s (host clock)"
            f"{extra}, launches {step['launches']}")
        return step


def pgs_clean(c, n_pgs: int) -> bool:
    """Every one of the cluster's ``n_pgs`` PGs active+clean on its
    primary, nothing missing and no backfill left (stricter than
    ``wait_for_clean``, which also takes ``active``)."""
    seen = 0
    for d in c.osds.values():
        with d.lock:
            for pg in d.pgs.values():
                if not pg.is_primary:
                    continue
                seen += 1
                if pg.state != "active+clean" or pg.missing \
                        or any(pg.peer_missing.values()) \
                        or pg.backfill_targets:
                    return False
    return seen == n_pgs


def unclean_pgs(c) -> list:
    """(pgid, state, missing, peer_missing, backfill targets, epoch)
    of every primary PG that ``pgs_clean`` does not count as clean."""
    out = []
    for i, d in sorted(c.osds.items()):
        with d.lock:
            for pg in d.pgs.values():
                if not pg.is_primary:
                    continue
                peer = {o: sorted(v)[:4] for o, v in pg.peer_missing.items()
                        if v}
                if pg.state != "active+clean" or pg.missing or peer \
                        or pg.backfill_targets:
                    out.append((str(pg.pgid), f"osd.{i}", pg.state,
                                sorted(pg.missing)[:4], peer,
                                sorted(pg.backfill_targets),
                                d.osdmap.epoch))
    return out


def cpu_shards(ec_cpu, data: bytes) -> list[bytes]:
    """The k+m shards of one object, encoded on the CPU (the plain
    versions)."""
    enc = ec_cpu.encode(set(range(K + M)), data)
    return [bytes(np.asarray(enc[s])) for s in range(K + M)]


def place_shards(c, pool_id: int, names, what: str) -> dict:
    """{object: (pgid, acting)} from an OSD's map; fails unless every
    object has one shard on each OSD (``choose_indep`` over the flat
    root with k + m OSDs)."""
    omap = c.osds[0].osdmap
    placed = {}
    for o in names:
        pgid = omap.raw_pg_to_pg(omap.object_locator_to_pg(o, pool_id))
        acting = omap.pg_to_up_acting_osds(pgid)[2]
        if sorted(acting) != list(range(K + M)):
            fail(f"{what}: {o!r} maps to {acting}, not one shard on each "
                 f"of the {K + M} OSDs")
        placed[o] = (pgid, acting)
    return placed


def hold_shards(c, placed: dict) -> list:
    """Every OSD's shard and ``"_"`` meta of each placed object, copied
    under each daemon's lock once: checked after the cluster stops (no
    daemon threads then to take the interpreter lock from the host
    CRC)."""
    held = []
    for i in range(K + M):
        d = c.osds[i]
        with d.lock:
            for o, (pgid, acting) in placed.items():
                s = acting.index(i)
                cid = f"{pgid}s{s}"
                held.append((i, o, s, bytes(d.store.read(cid, o)),
                             json.loads(bytes(d.store.getattr(cid, o, "_")))))
    return held


def check_shards(held: list, want: dict, sizes: dict, what: str):
    """Every held shard against the CPU re-encode ``want``, its meta's
    size against ``sizes`` and its hinfo against the host CRC-32C."""
    t0 = time.perf_counter()
    for i, o, s, data, meta in held:
        if data != want[o][s]:
            fail(f"{what}: osd.{i} shard {s} of {o!r} differs from the CPU "
                 f"re-encode")
        if meta["size"] != sizes[o]:
            fail(f"{what}: osd.{i} shard {s} of {o!r}: meta {meta}")
    for n in sorted({len(h[3]) for h in held}):
        same = [h for h in held if len(h[3]) == n]
        rows = np.frombuffer(b"".join(h[3] for h in same),
                             np.uint8).reshape(len(same), n)
        if crc32c_rows_host(rows).tolist() != [h[4]["hinfo"] for h in same]:
            fail(f"{what}: a stored hinfo differs from the host CRC-32C of "
                 f"its shard")
    log(f"[{what}] checks: {len(held)} shards and hinfos of {K + M} OSDs "
        f"equal the CPU re-encode and the host CRC-32C "
        f"({time.perf_counter() - t0:.3f} s, host clock)")


def dump_stuck(c, objecter, oid: str):
    """What a client op on ``oid`` that has not completed waits on: its
    sends, the primary's PG and that PG's EC reads in flight, and every
    thread's stack (on stderr)."""
    import faulthandler
    with objecter.lock:
        ops = [(op.pgid, op.target_osd, op.attempts,
                round(time.monotonic() - op.submitted, 1))
               for op in objecter.inflight.values() if op.oid == oid]
    log(f"[stuck] {oid}: the client's ops (pgid, primary, sends, s since "
        f"the last) {ops}")
    for pgid, osd, _n, _s in ops:
        d = c.osds.get(osd)
        if d is None or not d.lock.acquire(timeout=5):
            log(f"[stuck] osd.{osd}: {'gone' if d is None else 'locked'}")
            continue
        try:
            pg = d.pgs.get(pgid)
            reads = [(tid, sorted(st["need"]), sorted(st["chunks"]),
                      st.get("sent"))
                     for tid, st in getattr(getattr(pg, "backend", None),
                                            "_reads", {}).items()
                     if st.get("oid") == oid]
            log(f"[stuck] osd.{osd} pg {pgid}: state "
                f"{getattr(pg, 'state', None)}, epoch {d.osdmap.epoch}, "
                f"its reads of {oid} (tid, need, chunks, sent) {reads}")
        finally:
            d.lock.release()
    faulthandler.dump_traceback(all_threads=True)


def dump_sessions(c):
    """Each OSD's map epoch and mon session (its rank, whether it is
    connected, seconds since the mon last answered, its
    subscriptions), then every thread's stack (on stderr): what an OSD
    whose map stopped advancing waits on."""
    import faulthandler
    now = time.monotonic()
    for i, d in sorted(c.osds.items()):
        mc = d.monc
        con = mc._con
        log(f"[stuck] osd.{i}: map epoch {d.osdmap.epoch}, mon session "
            f"rank {mc._cur_rank}, connected "
            f"{con is not None and con.is_connected}, last answer "
            f"{now - mc._last_ack:.1f} s ago, monc map epoch "
            f"{mc.osdmap_epoch}, subscriptions {mc._subs}")
    faulthandler.dump_traceback(all_threads=True)


def cluster_phase(dev, n_mons: int, n_osds: int, n_obj: int, obj: int,
                  pg_num: int, rewrite: int, seed: int = 31) -> dict:
    """The port's live cluster on ``dev``, driven through librados:
    ``MiniCluster(n_mons, n_osds, device=dev)`` on WALStores, an EC pool
    (k=8 m=3 ``jerasure reed_sol_van``, ``pg_num`` PGs, rule 1:
    ``choose_indep`` over the flat root, so every OSD holds one shard
    of every object) with the OSDs' options at their defaults but for
    the heartbeat grace.  Steps, each with its wall time and
    kernel launches: ``aio_write_full`` of ``n_obj`` seeded objects of
    ``obj`` bytes, then ``aio_read`` of all; kill ``CLUSTER_KILL``, wait
    until the mon marks it down, rewrite ``rewrite`` objects (so the
    OSD misses their shards) and read all ``n_obj`` degraded; revive it
    and wait until every PG is clean and its shards are rebuilt
    (recovery); deep-scrub every PG (no inconsistency); flip one byte
    of one parity shard with its hinfo rewritten to match and deep-scrub
    its PG (found, attributed to that shard, repaired).  Every read and
    every OSD's shard bytes and hinfo are held against a re-encode on
    the CPU (``create_erasure_code(..., device="cpu")``, the plain
    versions) and the host CRC-32C."""
    from ceph_tpu_torch.ec import create_erasure_code
    from ceph_tpu_torch.os_store import Transaction
    from ceph_tpu_torch.osd.osdmap import PGid
    from ceph_tpu_torch.scrub.crc32c import crc32c_blocks
    from ceph_tpu_torch.vstart import MiniCluster
    profile = {"plugin": "jerasure", "technique": "reed_sol_van",
               "k": K, "m": M}
    ec_cpu = create_erasure_code(profile, device="cpu")
    payloads = {f"obj{i}": np.random.default_rng(seed + i).integers(
        0, 256, size=obj, dtype=np.uint8).tobytes() for i in range(n_obj)}
    names = sorted(payloads, key=lambda s: int(s[3:]))

    clock = StepClock("cluster", dev)
    steps, daemons, step = clock.steps, clock.daemons, clock.close

    c = MiniCluster(n_mons=n_mons, n_osds=n_osds, device=dev, osd_config={
        "osd_heartbeat_grace": CLUSTER_HB_GRACE,
        "device_profiling_enable": True})
    try:
        c.start(timeout=60)
        daemons += c.osds.values()
        r = c.rados()
        rc, outs, _ = r.mon_command({
            "prefix": "osd erasure-code-profile set", "name": "k8m3",
            "profile": [f"{k}={v}" for k, v in profile.items()]})
        if rc:
            fail(f"cluster: erasure-code-profile set: {outs}")
        r.create_pool("ecpool", pg_num=pg_num, pool_type="erasure",
                      erasure_code_profile="k8m3", rule=1)
        io = r.open_ioctx("ecpool")
        c.wait_for_clean(timeout=120)
        fs = c._wal_dir and fs_type(c._wal_dir)
        step("start")

        def windowed(ids, submit, done):
            """``CLUSTER_INFLIGHT`` ops in flight, as ``rados bench``
            keeps them; ``done(oid, completion)`` checks each."""
            inflight = []
            for o in ids:
                inflight.append((o, submit(o)))
                if len(inflight) >= CLUSTER_INFLIGHT:
                    done(*inflight.pop(0))
            for o, cp in inflight:
                done(o, cp)

        def read_all(what):
            def done(o, cp):
                if not cp.wait_for_complete(STUCK_S):
                    dump_stuck(c, r.objecter, o)
                if not cp.wait_for_complete(0) or cp.rc:
                    fail(f"cluster: {what} read of {o}: rc {cp.rc}")
                if bytes.fromhex(cp.results[0]["data"]) != payloads[o]:
                    fail(f"cluster: {what} read of {o} differs from what "
                         f"was written")
            windowed(names, io.aio_read, done)

        def write(ids):
            def done(o, cp):
                if not cp.wait_for_complete(600) or cp.rc:
                    fail(f"cluster: write of {o}: rc {cp.rc}")
            windowed(ids, lambda o: io.aio_write_full(o, payloads[o]), done)

        write(names)
        step("write")
        read_all("clean")
        step("read")
        c.kill_osd(CLUSTER_KILL)
        c.wait_for_osd_down(CLUSTER_KILL, timeout=4 * CLUSTER_HB_GRACE)
        step("kill")
        rng = np.random.default_rng(seed - 1)
        for o in names[:rewrite]:
            payloads[o] = rng.integers(0, 256, size=obj,
                                       dtype=np.uint8).tobytes()
        write(names[:rewrite])
        step("degraded_write")
        read_all("degraded")
        step("degraded_read")
        c.revive_osd(CLUSTER_KILL, timeout=60)
        daemons.append(c.osds[CLUSTER_KILL])
        wait_until(lambda: all(d.osdmap.is_up(CLUSTER_KILL)
                               for d in c.osds.values()), 120,
                   f"every OSD to see osd.{CLUSTER_KILL} up", 0.05)
        c.wait_for_clean(timeout=120)
        pool_id = io.pool_id
        placed = place_shards(c, pool_id, names, "cluster")
        want = {o: cpu_shards(ec_cpu, payloads[o]) for o in names}

        def shard(i, o):
            pgid, acting = placed[o]
            s = acting.index(i)
            st = c.osds[i].store
            cid = f"{pgid}s{s}"
            with c.osds[i].lock:
                if not st.exists(cid, o):
                    return None, None, s
                return (bytes(st.read(cid, o)),
                        json.loads(bytes(st.getattr(cid, o, "_"))), s)

        def rebuilt():
            return all(shard(CLUSTER_KILL, o)[0] == want[o][placed[o][1]
                                                         .index(CLUSTER_KILL)]
                       for o in names[:rewrite])

        wait_until(rebuilt, 300, "the revived OSD's rebuilt shards", 0.05)
        wait_until(lambda: pgs_clean(c, pg_num), 300,
                   "every PG clean after the revive", 0.05)
        step("recovery")
        held = hold_shards(c, placed)
        step("snapshot")
        reinterval = []     # scrubs a new interval aborted, restarted

        def deep_scrub(pgid):
            """One deep scrub of ``pgid`` to its verdict: the error
            count, once the primary's ``last_deep_scrub`` moved forward.
            A scrub that a new interval aborted (the PG re-peered under
            it) starts again, at most twice, and is counted; one that
            ended without a verdict in its own interval (a member never
            sent its map) fails the smoke."""
            for _ in range(3):
                d = c.osds[c.pg_primary(pgid)]
                with d.lock:
                    pg = d.pgs[pgid]
                    before, interval = pg.last_deep_scrub, pg.interval_epoch
                try:
                    errs = c.scrub_pg(pgid, timeout=120)
                except TimeoutError as e:
                    fail(f"cluster: deep scrub of {pgid}: {e}")
                except RuntimeError as e:
                    with d.lock:
                        if d.pgs.get(pgid) is pg and \
                                pg.interval_epoch == interval:
                            fail(f"cluster: deep scrub of {pgid}: {e}, "
                                 f"in its own interval")
                    reinterval.append(str(pgid))
                    continue
                with d.lock:
                    if not d.pgs[pgid].last_deep_scrub > before:
                        fail(f"cluster: deep scrub of {pgid} on osd."
                             f"{d.whoami} returned {errs} without a "
                             f"verdict")
                return errs
            fail(f"cluster: deep scrub of {pgid}: three new intervals")

        pgids = [PGid(pool_id, p) for p in range(pg_num)]
        scrub_ms = []
        for pgid in pgids:
            t0 = time.perf_counter()
            errs = deep_scrub(pgid)
            scrub_ms.append((time.perf_counter() - t0) * 1e3)
            if errs:
                fail(f"cluster: deep scrub of {pgid} found {errs} errors")
        step("scrub")
        # one parity shard's byte flipped and its hinfo rewritten to
        # match: only the deep scrub's parity recheck can see it
        o = names[0]
        pgid, acting = placed[o]
        bad_osd = acting[K]
        good, meta, s = shard(bad_osd, o)
        bad = (o, bad_osd, s)
        broken = bytearray(good)
        broken[len(broken) // 2] ^= 0x40
        meta["hinfo"] = crc32c_blocks(bytes(broken))
        cid = f"{pgid}s{s}"
        with c.osds[bad_osd].lock:
            c.osds[bad_osd].store.queue_transaction(
                Transaction().write(cid, o, 0, bytes(broken)).setattrs(
                    cid, o, {"_": json.dumps(meta).encode()}))
        t0 = time.perf_counter()
        found = deep_scrub(pgid)
        primary = c.osds[c.pg_primary(pgid)]
        with primary.lock:
            report = list(primary.pgs[pgid].inconsistent_objects)
        culprits = [(sh["osd"], sh["shard"]) for e in report
                    for sh in e["shards"]]
        if found < 1 or [e["object"]["name"] for e in report] != [o] \
                or culprits != [(bad_osd, s)]:
            fail(f"cluster: the flipped parity byte of {o} on osd."
                 f"{bad_osd} shard {s}: scrub found {found}, report "
                 f"{report}")
        wait_until(lambda: shard(bad_osd, o)[0] == good, 120,
                   "the flipped shard's repair", 0.05)
        repair_ms = (time.perf_counter() - t0) * 1e3
        again = deep_scrub(pgid)
        if again or shard(bad_osd, o)[1]["hinfo"] != crc32c_blocks(good):
            with primary.lock:
                report = list(primary.pgs[pgid].inconsistent_objects)
            fail(f"cluster: the repaired PG does not scrub clean: {again} "
                 f"errors, report {report}, hinfo "
                 f"{shard(bad_osd, o)[1]['hinfo']} for "
                 f"{crc32c_blocks(good)}")
        step("scrub_repair")
        engines = [d.batch_engine.dump() for d in daemons]
    finally:
        c.stop()
    check_shards(held, want, {o: obj for o in names}, "cluster")
    summed = {k: sum(e.get(k, 0) for e in engines)
              for k in ("launches", "ops_completed", "recon_launches",
                        "recon_ops_completed", "store_kicks")}
    for lane, prefix in (("flushes", "flush_"),
                         ("recon_flushes", "recon_flush_")):
        summed[lane] = sum(v for e in engines for k, v in e.items()
                           if k.startswith(prefix) and k != prefix + "ms")
    return {"steps": steps, "fs": fs, "engine": summed,
            "daemons": len(engines), "scrub_ms": scrub_ms,
            "repair_ms": repair_ms, "bad": bad, "reinterval": reinterval}


def latencies(ms: list) -> str:
    """A step's requests and their latency, median and max, then each
    request's."""
    if not ms:
        return ""
    return (f", {len(ms)} requests, latency median "
            f"{float(np.median(ms)):.1f} ms, max {max(ms):.1f} ms "
            f"(each: {', '.join(f'{x:.1f}' for x in ms)})")


def timed(fn, *a, **kw):
    """fn(*a, **kw) and its wall on the host clock, in ms."""
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    return out, (time.perf_counter() - t0) * 1e3


def guarded(tag: str, c, objecter, what: str, fn, *a):
    """fn(*a) on a thread of its own: the phase ``tag`` fails if it
    raises or is not done in ``STUCK_S``, and then ``dump_stuck`` dumps
    every op of ``objecter`` in flight first."""
    box = {}

    def run():
        try:
            box["out"] = fn(*a)
        except BaseException as e:          # noqa: BLE001
            box["err"] = e

    th = threading.Thread(target=run, name=f"{tag}-{what}", daemon=True)
    th.start()
    th.join(STUCK_S)
    if th.is_alive():
        with objecter.lock:
            oids = sorted({op.oid for op in objecter.inflight.values()})
        for oid in oids:
            dump_stuck(c, objecter, oid)
        fail(f"{tag}: {what} not done in {STUCK_S:.0f} s")
    if "err" in box:
        fail(f"{tag}: {what}: {box['err']!r}")
    return box["out"]


def same(tag: str, got: bytes, want: bytes, what: str):
    """Fail the phase ``tag`` unless ``got`` equals ``want``."""
    if got != want:
        diff = next(i for i in range(min(len(got), len(want)))
                    if got[i] != want[i]) if len(got) == len(want) \
            else None
        fail(f"{tag}: {what}: {len(got)} bytes differ from the "
             f"{len(want)} expected (first differing byte {diff})")


def wait_clean(tag: str, c, n_pgs: int, what: str, timeout: float = 300.0):
    """Every PG clean (``pgs_clean``); after ``timeout`` the phase
    ``tag`` fails with the OSDs up in osd.0's map and the PGs not
    clean."""
    deadline = time.monotonic() + timeout
    while not pgs_clean(c, n_pgs):
        if time.monotonic() > deadline:
            dump_sessions(c)
            m = c.osds[0].osdmap
            fail(f"{tag}: {what}: not in {timeout:.0f} s; OSDs up in "
                 f"osd.0's map (epoch {m.epoch}) "
                 f"{[o for o in sorted(c.osds) if m.is_up(o)]}; PGs not "
                 f"clean {unclean_pgs(c)}")
        time.sleep(0.05)


def rgw_phase(dev, n_mons: int, n_osds: int, n_obj: int, obj: int,
              part: int, parts: int, pg_num: int, seed: int = 43) -> dict:
    """The port's object gateway on ``dev``: ``MiniCluster(n_mons,
    n_osds, device=dev)`` on WALStores with the OSDs' options at their
    defaults but the heartbeat grace, and ``start_rgw(require_auth=True,
    data_pool_opts=...)`` on an EC data pool (k=8 m=3 ``jerasure
    reed_sol_van``, ``pg_num`` PGs, rule 1), everything else at
    ``RGWService``'s defaults (``stripe_size`` 4 MiB).  Steps, each
    with its wall time, requests, latencies and kernel launches: the
    data pool read back from the mon (erasure, the k8m3 profile, rule
    1); ``radosgw-admin user create`` in process, its keys taken from
    its JSON; a bucket and ``n_obj`` seeded PUTs of ``obj`` bytes,
    ``RGW_INFLIGHT`` in flight, each ETag against ``hashlib.md5``;
    every GET byte for byte (as many in flight) and the listing; one multipart upload of ``parts`` parts of ``part`` bytes,
    one part at a time (each part's stripes written together by
    ``put_part``), its ETag against the md5 of the part md5s, its GET
    whole; osd
    ``RGW_KILL`` killed and waited for until marked down in the OSDs'
    and the gateway's maps and every PG is active again; every object
    GET degraded, ``RGW_INFLIGHT`` in flight, with the RADOS
    ops that the gateway's client resent meanwhile; the revive, until
    every PG is clean; every OSD's shards and hinfos of every
    ``.rgw.data`` object against a re-encode on the CPU and the host
    CRC-32C.  Every request is SigV4-signed by the port's
    ``S3Client``, and the phase fails on a request that ``S3Client``
    sent twice (it retries once on a fresh connection when a reused one
    fails, its 10 s socket timeout among the failures)."""
    import hashlib
    import re
    from concurrent.futures import ThreadPoolExecutor
    from ceph_tpu_torch.ec import create_erasure_code
    from ceph_tpu_torch.osd.osdmap import TYPE_ERASURE
    from ceph_tpu_torch.rgw import S3Client
    from ceph_tpu_torch.tools import radosgw_admin
    from ceph_tpu_torch.vstart import MiniCluster
    profile = {"plugin": "jerasure", "technique": "reed_sol_van",
               "k": K, "m": M}
    ec_cpu = create_erasure_code(profile, device="cpu")
    rng = np.random.default_rng(seed)
    bucket = "smoke"
    payloads = {f"obj{i}": rng.integers(0, 256, size=obj,
                                        dtype=np.uint8).tobytes()
                for i in range(n_obj)}
    names = sorted(payloads, key=lambda s: int(s[3:]))
    part_data = [rng.integers(0, 256, size=part, dtype=np.uint8).tobytes()
                 for _ in range(parts)]
    whole = b"".join(part_data)
    clock = StepClock("rgw", dev)

    def step(name, ms=()):
        clock.close(name, latencies(list(ms)))["ms"] = list(ms)

    def md5(b):
        return hashlib.md5(b).hexdigest()

    class Client(S3Client):
        """The port's client, counting each request's attempts."""

        def _conn(self):
            self._local.attempts = getattr(self._local, "attempts", 0) + 1
            return super()._conn()

        def _req(self, method, path, body=b""):
            self._local.attempts = 0
            out = super()._req(method, path, body)
            if self._local.attempts != 1:
                fail(f"rgw: {method} {path} was sent "
                     f"{self._local.attempts} times (a timeout or a "
                     f"dropped connection)")
            return out

    c = MiniCluster(n_mons=n_mons, n_osds=n_osds, device=dev, osd_config={
        "osd_heartbeat_grace": CLUSTER_HB_GRACE,
        "device_profiling_enable": True})
    try:
        c.start(timeout=60)
        clock.daemons += c.osds.values()
        r = c.rados()
        rc, outs, _ = r.mon_command({
            "prefix": "osd erasure-code-profile set", "name": "k8m3",
            "profile": [f"{k}={v}" for k, v in profile.items()]})
        if rc:
            fail(f"rgw: erasure-code-profile set: {outs}")
        gw = c.start_rgw(require_auth=True, data_pool_opts={
            "pool_type": "erasure", "erasure_code_profile": "k8m3",
            "pg_num": pg_num, "rule": 1})
        c.wait_for_clean(timeout=120)
        step("start")
        # 1. the data pool as the mon has it: a pool created replicated
        # (or on rule 0) would pass every byte check below
        (rc, outs, dump), ms0 = timed(r.mon_command, {"prefix": "osd dump"})
        if rc:
            fail(f"rgw: osd dump: {outs}")
        pools = {p["name"]: p for p in dump["pools"]}
        data = pools.get(".rgw.data")
        if data is None:
            fail(f"rgw: no .rgw.data pool in the mon's map: {sorted(pools)}")
        (rc, outs, prof), ms1 = timed(r.mon_command, {
            "prefix": "osd erasure-code-profile get",
            "name": data["erasure_code_profile"]})
        got = (data["type"], data["erasure_code_profile"],
               data["crush_rule"], data["size"], data["pg_num"],
               rc == 0 and prof.get("k"), rc == 0 and prof.get("m"),
               rc == 0 and prof.get("technique"))
        if got != (TYPE_ERASURE, "k8m3", 1, K + M, pg_num, str(K), str(M),
                   "reed_sol_van"):
            fail(f"rgw: .rgw.data is not erasure k={K} m={M} on rule 1: "
                 f"(type, profile, rule, size, pg_num, k, m, technique) "
                 f"= {got}, pool {data}")
        log(f"[rgw] .rgw.data read back from the mon: type erasure "
            f"({data['type']}), profile k8m3 {prof}, crush_rule "
            f"{data['crush_rule']}, size {data['size']}, min_size "
            f"{data['min_size']}, pg_num {data['pg_num']}; .rgw.meta "
            f"type {pools['.rgw.meta']['type']}, size "
            f"{pools['.rgw.meta']['size']}")
        step("pool", [ms0, ms1])
        # 2. the user, through the port's radosgw-admin
        mon = ",".join(f"{a.host}:{a.port}" for a in c.monmap.mons.values())
        (rc, out, err), ms = timed(cli, radosgw_admin, [
            "-m", mon, "user", "create", "--uid", "smoke",
            "--display-name", "chip smoke"])
        if rc:
            fail(f"rgw: radosgw-admin user create: rc {rc}: {err}")
        user = json.loads(out)
        cl = Client("127.0.0.1", gw.port, user["access_key"],
                    user["secret_key"])
        step("user", [ms])
        # 3. a bucket, PUTs, GETs and the listing
        st, ms = timed(cl.make_bucket, bucket)
        if st != 200:
            fail(f"rgw: PUT /{bucket}: {st}")
        put_ms = [ms]

        def put(o):
            (st, etag), ms = timed(cl.put, bucket, o, payloads[o])
            if st != 200 or etag != md5(payloads[o]):
                fail(f"rgw: PUT {o}: {st}, ETag {etag} for "
                     f"{md5(payloads[o])}")
            return ms

        def get(item):
            o, want = item
            (st, body), ms = timed(cl.get, bucket, o)
            if st != 200 or body != want:
                fail(f"rgw: GET {o}: {st}, {len(body)} bytes differ from "
                     f"the {len(want)} written")
            return ms

        with ThreadPoolExecutor(RGW_INFLIGHT) as ex:
            put_ms += list(ex.map(put, names))
        step("put", put_ms)
        with ThreadPoolExecutor(RGW_INFLIGHT) as ex:
            get_ms = list(ex.map(get, payloads.items()))
        (st, _h, body), ms = timed(cl.list, bucket)
        listed = re.findall(rb"<Key>([^<]*)</Key><Size>(\d+)</Size>"
                            rb"<ETag>&quot;([0-9a-f]+)&quot;</ETag>", body)
        want_list = sorted((o.encode(), str(obj).encode(),
                            md5(payloads[o]).encode()) for o in names)
        if st != 200 or listed != want_list:
            fail(f"rgw: GET /{bucket}: {st}, listing {listed[:3]}... of "
                 f"{len(listed)} for {len(want_list)}")
        step("get", get_ms + [ms])
        # 4. one multipart upload, one part at a time
        (st, up), ms = timed(cl.initiate_multipart, bucket, "mp")
        if st != 200:
            fail(f"rgw: initiate multipart: {st}")
        mp_ms = [ms]
        for n, data_n in enumerate(part_data, 1):
            (st, etag), ms = timed(cl.put_part, bucket, "mp", up, n, data_n)
            if st != 200 or etag != md5(data_n):
                fail(f"rgw: part {n}: {st}, ETag {etag}")
            mp_ms.append(ms)
        (st, etag), ms = timed(cl.complete_multipart, bucket, "mp", up)
        want_etag = hashlib.md5(b"".join(
            hashlib.md5(p).digest() for p in part_data)).hexdigest()
        if st != 200 or etag != f"{want_etag}-{parts}":
            fail(f"rgw: complete multipart: {st}, ETag {etag} for "
                 f"{want_etag}-{parts}")
        mp_ms.append(ms)
        manifest = gw.store.head_object(bucket, "mp")["parts"]
        step("multipart_put", mp_ms)
        step("multipart_get", [get(("mp", whole))])
        # 5. one OSD down: every object read degraded
        c.kill_osd(RGW_KILL)
        c.wait_for_osd_down(RGW_KILL, timeout=4 * CLUSTER_HB_GRACE)
        # the gateway's client too (a GET sent on the map before waits
        # out the Objecter's resend), and every PG re-peered (a GET to a
        # PG still peering is parked until it activates)
        wait_until(lambda: not gw.store.rados.objecter.osdmap.is_up(
            RGW_KILL), 60, f"the gateway's map to mark osd.{RGW_KILL} down",
            0.05)
        c.wait_for_clean(timeout=120)
        step("kill")
        objects = {**payloads, "mp": whole}
        # each send of the gateway's client, to tell a degraded GET's
        # wait for the Objecter's resend (2 s) from its read
        objecter, sends = gw.store.rados.objecter, []
        send_op, t0 = objecter._send_op, time.perf_counter()

        def traced(op):
            send_op(op)
            sends.append((time.perf_counter() - t0, op.oid, op.attempts))

        def deg_get(item):
            t = time.perf_counter() - t0
            spans[item[0]] = (t, None)
            spans[item[0]] = (t, get(item))
            return spans[item[0]][1]

        spans = {}
        objecter._send_op = traced
        try:
            with ThreadPoolExecutor(RGW_INFLIGHT) as ex:
                deg_ms = list(ex.map(deg_get, objects.items()))
        finally:
            # printed when a GET fails too
            del objecter._send_op
            resent = [f"{oid} (resend {n - 1} at {t:.2f} s)".replace(
                "\x00", "/") for t, oid, n in sends if n > 1]
            each = ", ".join(
                f"{o} {t:.2f}-" + ("unanswered" if ms is None else
                                   f"{t + ms / 1e3:.2f}")
                for o, (t, ms) in spans.items())
            log(f"[rgw] degraded GETs, seconds since the first: {each}; "
                f"{len(sends)} RADOS sends of the gateway's client, "
                f"{len(resent)} of them resends"
                f"{': ' + ', '.join(resent) if resent else ''}")
        step("degraded_get", deg_ms)
        # 6. the revive, until every PG of both pools is clean
        c.revive_osd(RGW_KILL, timeout=60)
        clock.daemons.append(c.osds[RGW_KILL])
        wait_until(lambda: all(d.osdmap.is_up(RGW_KILL)
                               for d in c.osds.values()), 120,
                   f"every OSD to see osd.{RGW_KILL} up", 0.05)
        n_pgs = pg_num + pools[".rgw.meta"]["pg_num"]
        wait_until(lambda: pgs_clean(c, n_pgs), 300,
                   "every PG clean after the revive", 0.05)
        step("recovery")
        # 7. every data object's shards and hinfos, held for the check;
        # the listing waits for the gateway's client and every OSD to
        # share one map (a PG answered with EAGAIN while an epoch
        # spreads is left out of a listing)
        wait_until(lambda: all(d.osdmap.epoch == objecter.osdmap.epoch
                               for d in c.osds.values()), 60,
                   "the gateway's client and the OSDs on one map", 0.05)
        ss = gw.store.stripe_size
        stored = {f"{bucket}\x00{o}": d for o, d in payloads.items()}
        # a part above stripe_size is cut into stripes of that size
        chunks = [p[j:j + ss] if len(p) > ss else p
                  for p in part_data for j in range(0, len(p), ss)]
        if len(chunks) != len(manifest):
            fail(f"rgw: the manifest has {len(manifest)} data objects for "
                 f"{len(chunks)} stripes")
        stored.update(zip(manifest, chunks))
        listed = sorted(gw.store.data.list_objects())
        if listed != sorted(stored):
            fail(f"rgw: .rgw.data holds {len(listed)} objects "
                 f"{listed[:4]}..., not the {len(stored)} written")
        held = hold_shards(c, place_shards(c, gw.store.data.pool_id,
                                           listed, "rgw"))
        step("snapshot")
        engines = [d.batch_engine.dump() for d in clock.daemons]
    finally:
        c.stop()
    check_shards(held, {o: cpu_shards(ec_cpu, d) for o, d in stored.items()},
                 {o: len(d) for o, d in stored.items()}, "rgw")
    summed = {k: sum(e.get(k, 0) for e in engines)
              for k in ("launches", "ops_completed", "recon_launches",
                        "recon_ops_completed")}
    summed["flushes"] = sum(v for e in engines for k, v in e.items()
                            if k.startswith("flush_") and k != "flush_ms")
    return {"steps": clock.steps, "engine": summed, "daemons": len(engines),
            "stripes": len(manifest), "objects": len(stored)}


def rbd_phase(dev, n_mons: int, n_osds: int, pg_num: int, size: int,
              order: int, n_writes: int, write: int, m_size: int,
              m_writes: int, m_write: int, seed: int = 47) -> dict:
    """The port's block images on ``dev``: ``MiniCluster(n_mons, n_osds,
    device=dev)`` on WALStores with the OSDs' options at their defaults
    but the heartbeat grace, and one EC pool ``rbd`` (k=8 m=3
    ``jerasure reed_sol_van``, ``pg_num`` PGs, rule 1) created through
    librados and read back from the mon before the first ``rbd``
    command.  The ``rbd`` CLI runs in process (``tools.rbd.main``) for
    its verbs, the ``Image`` API for the rest.  Steps, each with its
    wall time, bytes, each I/O's latency and kernel launches: ``create``
    of a ``size`` image at ``order`` (the bench's), ``import`` of a
    seeded file of ``size`` bytes as ``img0`` and its ``export``
    compared byte for byte; ``bench`` write and read of the first image
    with I/Os of one object; ``snap create img0@s1``, ``n_writes``
    seeded partial writes of ``write`` bytes (EC read-modify-writes),
    the head against a host model and the image at ``s1`` against the
    import, byte for byte; ``snap create img0@s2``, ``export-diff
    --from-snap s1`` applied by ``import-diff`` to a second image that
    holds ``s1``'s bytes, compared with ``s2``; ``snap protect``,
    ``clone img0@s1 child``, one object's write into ``child``,
    ``flatten`` and ``child`` compared whole; osd ``RBD_KILL`` killed,
    marked down by ``osd down`` and waited for in the OSDs' and the
    client's maps until every PG is active, ``img0`` and ``child`` read whole degraded and
    compared, and one object's write; the revive, until every PG is
    clean; every OSD's shards and hinfos of every ``rbd_data.*`` object
    against a re-encode of the host model on the CPU and the host
    CRC-32C.  Then a second cluster, site B (1 mon, ``n_osds`` OSDs,
    the same pool), and ``MirrorDaemon(remote=site A, local=site B)`` on
    its own thread: a journaled image of ``m_size`` bytes with
    ``m_writes`` seeded writes of ``m_write`` bytes, one discard, one
    resize and one snapshot, replayed until the daemon's position is
    site A's journal head and compared byte for byte, ``mirror demote``
    on A and ``mirror promote`` on B (a write on B accepted, one on A
    refused as non-primary); a snapshot-mode image with two mirror
    snapshots and seeded writes between them, synced to B and compared.
    A read that fails comes back as zeros from ``Image.read``: every
    read is compared with its model, any failed object read of the
    phase's own handles fails it, and a read not done in ``STUCK_S`` is
    dumped by ``dump_stuck``.  The daemon's ``errors`` must stay empty."""
    import random
    from ceph_tpu_torch.ec import create_erasure_code
    from ceph_tpu_torch.kernels import build
    from ceph_tpu_torch.osd.osdmap import TYPE_ERASURE
    from ceph_tpu_torch.osdc.librados import ObjectNotFound
    from ceph_tpu_torch.rbd import Image
    from ceph_tpu_torch.rbd.image import _journal_oid
    from ceph_tpu_torch.rbd.mirror import MirrorDaemon
    from ceph_tpu_torch.tools import rbd as rbd_tool
    from ceph_tpu_torch.vstart import MiniCluster
    profile = {"plugin": "jerasure", "technique": "reed_sol_van",
               "k": K, "m": M}
    ec_cpu = create_erasure_code(profile, device="cpu")
    obj = 1 << order
    n_obj = size // obj
    rng = np.random.default_rng(seed)
    seeded = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
    clock = StepClock("rbd", dev)
    osd_config = {"osd_heartbeat_grace": CLUSTER_HB_GRACE,
                  "device_profiling_enable": True}
    tmp = tempfile.mkdtemp(prefix="rbd_smoke_")
    read_errors = []          # failed object reads of the phase's handles

    def step(name, nbytes=0, ms=()):
        checked(name)
        extra = (f", {nbytes / 1e6:.1f} MB" if nbytes else "") \
            + latencies(list(ms))
        out = clock.close(name, extra)
        out["ms"], out["bytes"] = list(ms), nbytes

    class Watched:
        """An ioctx whose failed reads (other than a missing object)
        are recorded: ``Image.read`` turns them into zeros."""

        def __init__(self, io):
            self._io = io

        def __getattr__(self, name):
            return getattr(self._io, name)

        def read(self, oid, *a, **kw):
            try:
                return self._io.read(oid, *a, **kw)
            except ObjectNotFound:
                raise
            except Exception as e:              # noqa: BLE001
                read_errors.append((oid, repr(e)))
                raise

    def checked(what):
        if read_errors:
            fail(f"rbd: {what}: {len(read_errors)} object reads failed "
                 f"(Image.read returns zeros for them): {read_errors[:4]}")

    def read_whole(c, r, img, what):
        """The image read whole, one object an I/O: (bytes, each I/O's
        ms, each I/O's gf_planes launches)."""
        out, ms, k2 = bytearray(), [], []
        step_ = img.layout.object_size
        for off in range(0, img.size(), step_):
            before = build.counts()["gf_planes"]
            piece, t = timed(guarded, "rbd", c, r.objecter,
                             f"{what} at {off}", img.read, off,
                             min(step_, img.size() - off))
            out += piece
            ms.append(t)
            k2.append(build.counts()["gf_planes"] - before)
        checked(what)
        return bytes(out), ms, k2

    def start_site(nm):
        c = MiniCluster(n_mons=nm, n_osds=n_osds, device=dev,
                        osd_config=osd_config)
        clusters.append(c)
        c.start(timeout=60)
        clock.daemons.extend(c.osds.values())
        r = c.rados()
        rc, outs, _ = r.mon_command({
            "prefix": "osd erasure-code-profile set", "name": "k8m3",
            "profile": [f"{k}={v}" for k, v in profile.items()]})
        if rc:
            fail(f"rbd: erasure-code-profile set: {outs}")
        r.create_pool("rbd", pg_num=pg_num, pool_type="erasure",
                      erasure_code_profile="k8m3", rule=1)
        wait_clean("rbd", c, pg_num, f"{nm}-mon site's PGs clean after "
                   f"the pool's creation")
        # the pool as the mon has it: tools/rbd.py makes a replicated
        # pool of 8 PGs when the named one is missing
        rc, outs, dump = r.mon_command({"prefix": "osd dump"})
        pool = {p["name"]: p for p in dump["pools"]}.get("rbd") \
            if rc == 0 else None
        if pool is None:
            fail(f"rbd: no pool rbd in the mon's map: {outs}")
        rc, outs, prof = r.mon_command({
            "prefix": "osd erasure-code-profile get",
            "name": pool["erasure_code_profile"]})
        got = (pool["type"], pool["erasure_code_profile"],
               pool["crush_rule"], pool["size"], pool["pg_num"],
               rc == 0 and prof.get("k"), rc == 0 and prof.get("m"),
               rc == 0 and prof.get("technique"))
        if got != (TYPE_ERASURE, "k8m3", 1, K + M, pg_num, str(K), str(M),
                   "reed_sol_van"):
            fail(f"rbd: pool rbd is not erasure k={K} m={M} on rule 1: "
                 f"(type, profile, rule, size, pg_num, k, m, technique) "
                 f"= {got}, pool {pool}")
        mon = ",".join(f"{a.host}:{a.port}" for a in c.monmap.mons.values())
        return c, r, r.open_ioctx("rbd"), mon, pool

    def rbd_cmd(mon, *argv):
        """``rbd -m MON -p rbd argv`` in process: (stdout, ms)."""
        try:
            (rc, out, err), ms = timed(cli, rbd_tool,
                                       ["-m", mon, "-p", "rbd", *argv])
        except (Exception, SystemExit) as e:      # noqa: BLE001
            fail(f"rbd: rbd {' '.join(map(str, argv))}: {e!r}")
        if rc:
            fail(f"rbd: rbd {' '.join(map(str, argv))}: rc {rc}: {err}")
        return out, ms

    clusters = []
    models = {}             # image → its bytes now
    try:
        c, r, io, mon, pool = start_site(n_mons)
        log(f"[rbd] pool rbd read back from the mon: type erasure "
            f"({pool['type']}), profile k8m3, crush_rule "
            f"{pool['crush_rule']}, size {pool['size']}, min_size "
            f"{pool['min_size']}, pg_num {pool['pg_num']}")
        wio = Watched(io)
        step("start")
        # 1. the bench's image, and 2. the seeded file through import
        _, ms0 = rbd_cmd(mon, "create", "bench0", "--size", size,
                         "--order", order)
        out, ms1 = rbd_cmd(mon, "info", "bench0")
        if json.loads(out)["num_objs"] != n_obj:
            fail(f"rbd: info bench0: {out}")
        step("create", 0, [ms0, ms1])
        src = os.path.join(tmp, "seeded.bin")
        with open(src, "wb") as f:
            f.write(seeded)
        out, ms = rbd_cmd(mon, "import", src, "img0")
        if out.strip() != f"imported {size} bytes":
            fail(f"rbd: import: {out!r}")
        models["img0"] = bytearray(seeded)
        with Image(io, "img0", read_only=True) as img:
            # the tool's default order; an object's write below (the
            # whole image when it is smaller)
            iobj = min(img.layout.object_size, size)
        step("import", size, [ms])
        dst = os.path.join(tmp, "export.bin")
        _, ms = rbd_cmd(mon, "export", "img0", dst)
        with open(dst, "rb") as f:
            same("rbd", f.read(), seeded, "export of img0")
        step("export", size, [ms])
        # 3. rbd bench, one object an I/O
        bench = {}
        for io_type in ("write", "read"):
            # --seconds past the run: the tool stops at 10 s otherwise
            out, ms = rbd_cmd(mon, "bench", "bench0", "--io-type", io_type,
                              "--io-size", obj, "--io-total", size,
                              "--seconds", 1200)
            bench[io_type] = json.loads(out)
            if bench[io_type]["bytes"] != size:
                fail(f"rbd: bench {io_type}: {out}")
            step(f"bench_{io_type}", size, [ms])
        brng = random.Random(0)         # the tool's own payload
        payload = bytes(brng.randrange(256) for _ in range(obj))
        models["bench0"] = bytearray(payload * n_obj)
        # 4. a snapshot, then partial writes: EC read-modify-writes
        _, ms = rbd_cmd(mon, "snap", "create", "img0@s1")
        step("snap_s1", 0, [ms])
        wrng = np.random.default_rng(seed + 1)
        offs = [int(x) for x in wrng.integers(0, size - write, n_writes)]
        model = models["img0"]
        part_ms = []
        with Image(wio, "img0") as img:
            for off in offs:
                data = wrng.integers(0, 256, size=write,
                                     dtype=np.uint8).tobytes()
                _, ms = timed(img.write, off, data)
                model[off:off + write] = data
                part_ms.append(ms)
        step("partial_writes", n_writes * write, part_ms)
        with Image(wio, "img0", read_only=True) as img:
            got, ms, _k2 = read_whole(c, r, img, "head of img0")
        same("rbd", got, bytes(model), "head of img0 after the partial writes")
        step("read_head", size, ms)
        with Image(wio, "img0", snapshot="s1") as img:
            got, ms, _k2 = read_whole(c, r, img, "img0@s1")
        same("rbd", got, seeded, "img0@s1")
        step("read_s1", size, ms)
        # 5. an incremental: s1 to s2 onto a second image holding s1
        s2 = bytes(model)
        _, ms0 = rbd_cmd(mon, "snap", "create", "img0@s2")
        diff = os.path.join(tmp, "s1-s2.diff")
        out, ms1 = rbd_cmd(mon, "export-diff", "img0@s2", diff,
                           "--from-snap", "s1")
        step("export_diff", 0, [ms0, ms1])
        log(f"[rbd] export-diff: {out.strip()}")
        _, ms0 = rbd_cmd(mon, "import", src, "img1")
        _, ms1 = rbd_cmd(mon, "snap", "create", "img1@s1")
        _, ms2 = rbd_cmd(mon, "import-diff", diff, "img1")
        models["img1"] = bytearray(s2)
        with Image(wio, "img1", read_only=True) as img:
            got, ms, _k2 = read_whole(c, r, img, "img1")
            snaps = [s["name"] for s in img.list_snaps()]
        if snaps != ["s1", "s2"]:
            fail(f"rbd: import-diff left img1 with the snapshots {snaps}")
        same("rbd", got, s2, "img1 after import-diff against img0@s2")
        step("import_diff", size, [ms0, ms1, ms2] + ms)
        # 6. a clone of s1, one object written into it, flattened
        _, ms0 = rbd_cmd(mon, "snap", "protect", "img0@s1")
        _, ms1 = rbd_cmd(mon, "clone", "img0@s1", "child")
        out, ms2 = rbd_cmd(mon, "children", "img0@s1")
        if out.split() != ["child"]:
            fail(f"rbd: children of img0@s1: {out!r}")
        child = models["child"] = bytearray(seeded)
        cw = rng.integers(0, 256, size=iobj, dtype=np.uint8).tobytes()
        cobj = size // iobj // 2
        with Image(wio, "child") as img:
            _, ms3 = timed(img.write, cobj * iobj, cw)
        child[cobj * iobj:(cobj + 1) * iobj] = cw
        _, ms4 = rbd_cmd(mon, "flatten", "child")
        with Image(wio, "child", read_only=True) as img:
            got, ms, _k2 = read_whole(c, r, img, "child")
        same("rbd", got, bytes(child), "child after flatten")
        step("clone_flatten", size + iobj, [ms0, ms1, ms2, ms3, ms4] + ms)
        # 7. one OSD down: both images read whole, degraded
        c.kill_osd(RBD_KILL)
        # the operator's `ceph osd down`: the cluster phase waits out
        # the heartbeat grace
        rc, outs, _ = r.mon_command({"prefix": "osd down",
                                     "ids": [RBD_KILL]})
        if rc:
            fail(f"rbd: osd down: {outs}")
        c.wait_for_osd_down(RBD_KILL, timeout=4 * CLUSTER_HB_GRACE)
        wait_until(lambda: not r.objecter.osdmap.is_up(RBD_KILL), 60,
                   f"the client's map to mark osd.{RBD_KILL} down", 0.05)
        c.wait_for_clean(timeout=120)
        step("kill")
        deg_ms, decodes = [], []
        omap_ = r.objecter.osdmap
        for name in ("img0", "child"):
            with Image(wio, name, read_only=True) as img:
                got, ms, k2 = read_whole(c, r, img, f"degraded {name}")
            same("rbd", got, bytes(models[name]), f"degraded read of {name}")
            deg_ms += ms
            for n, launched in enumerate(k2):
                pgid = omap_.raw_pg_to_pg(omap_.object_locator_to_pg(
                    f"rbd_data.{name}.{n:016x}", io.pool_id))
                decodes.append(f"{name}.{n} {pgid} "
                               f"{omap_.pg_to_up_acting_osds(pgid)[2]} "
                               f"{launched}")
        # osd.RBD_KILL's position is the hole in the acting set: a read
        # decodes (gf_planes) when it is one of the k data shards
        log("[rbd] degraded reads (object, pg, acting in the client's map, "
            "gf_planes launches): " + "; ".join(decodes))
        step("degraded_read", 2 * size, deg_ms)
        dw = rng.integers(0, 256, size=iobj, dtype=np.uint8).tobytes()
        with Image(wio, "img0") as img:
            _, ms = timed(img.write, 0, dw)
        model[:iobj] = dw
        step("degraded_write", iobj, [ms])
        # 8. the revive, until every PG is clean
        c.revive_osd(RBD_KILL, timeout=60)
        clock.daemons.append(c.osds[RBD_KILL])
        wait_until(lambda: all(d.osdmap.is_up(RBD_KILL)
                               for d in c.osds.values()), 120,
                   f"every OSD to see osd.{RBD_KILL} up", 0.05)
        wait_clean("rbd", c, pg_num, "every PG clean after the revive")
        step("recovery")
        # 9. every data object's shards and hinfos, against the models
        wait_until(lambda: all(d.osdmap.epoch == r.objecter.osdmap.epoch
                               for d in c.osds.values()), 60,
                   "the client and the OSDs on one map", 0.05)
        clones = {"img0": {1: seeded, 2: s2}, "img1": {1: seeded}}
        stored = {}
        for oid in sorted(io.list_objects()):
            if not oid.startswith("rbd_data."):
                continue
            name, _, rest = oid[len("rbd_data."):].rpartition(".")
            objno, _, snap = rest.partition("@")
            src_b = clones.get(name, {}).get(int(snap)) if snap \
                else models.get(name)
            if src_b is None:
                fail(f"rbd: {oid!r} is no object the phase wrote")
            n, oz = int(objno, 16), obj if name == "bench0" else iobj
            stored[oid] = bytes(src_b[n * oz:(n + 1) * oz])
        held = hold_shards(c, place_shards(c, io.pool_id, stored, "rbd"))
        step("snapshot")
        # 10. rbd-mirror: site B, the daemon on its own thread
        cb, rb, iob, monb, _ = start_site(1)
        d = MirrorDaemon(io, iob, interval=MIRROR_INTERVAL).start()
        step("site_b")
        mrng = np.random.default_rng(seed + 2)
        rbd_cmd(mon, "create", "jimg", "--size", m_size, "--journaling")
        jm = bytearray(m_size)
        j_ms = []
        with Image(wio, "jimg") as img:
            for off in mrng.integers(0, m_size - m_write, m_writes):
                off = int(off)
                data = mrng.integers(0, 256, size=m_write,
                                     dtype=np.uint8).tobytes()
                _, ms = timed(img.write, off, data)
                jm[off:off + m_write] = data
                j_ms.append(ms)
            doff = int(mrng.integers(0, m_size // 2)) & ~4095
            _, ms = timed(img.discard, doff, m_size // 16)
            jm[doff:doff + m_size // 16] = bytes(m_size // 16)
            j_ms.append(ms)
            shrunk = m_size * 3 // 4
            _, ms = timed(img.resize, shrunk)
            del jm[shrunk:]
            j_ms.append(ms)
            _, ms = timed(img.create_snap, "js1")
            j_ms.append(ms)
        t_last = time.perf_counter()
        head = int(io.omap_get(_journal_oid("jimg"))["head_seq"])
        step("journal_writes", m_writes * m_write, j_ms)
        guarded("rbd", cb, rb.objecter, "the journal replay", wait_until,
                lambda: d.positions.get("jimg") == head, 300,
                f"the mirror daemon to replay jimg to {head}", 0.05)
        lag = time.perf_counter() - t_last
        for side, sio in (("A", wio), ("B", Watched(iob))):
            with Image(sio, "jimg", read_only=True) as img:
                if img.size() != shrunk:
                    fail(f"rbd: jimg on site {side} is {img.size()} bytes, "
                         f"not {shrunk}")
                got, _ms, _k2 = read_whole(c if side == "A" else cb,
                                      r if side == "A" else rb, img,
                                      f"jimg on site {side}")
            same("rbd", got, bytes(jm), f"jimg on site {side}")
        with Image(iob, "jimg", snapshot="js1") as img:
            same("rbd", img.read(0, shrunk), bytes(jm), "jimg@js1 on site B")
        step("journal_replayed", 2 * shrunk)
        _, ms0 = rbd_cmd(mon, "mirror", "demote", "jimg")
        _, ms1 = rbd_cmd(monb, "mirror", "promote", "jimg")
        with Image(iob, "jimg") as img:
            img.write(0, b"written on site B")
            same("rbd", img.read(0, 17), b"written on site B", "a write on B")
        with Image(io, "jimg") as img:
            try:
                img.write(0, b"written on site A")
            except ValueError as e:
                if "non-primary" not in str(e):
                    fail(f"rbd: a write on the demoted site A: {e}")
            else:
                fail("rbd: the demoted site A took a write")
        step("failover", 0, [ms0, ms1])
        rbd_cmd(mon, "create", "simg", "--size", m_size,
                "--mirror-snapshot")
        sm = bytearray(m_size)
        s_ms = []

        def synced(name):
            try:
                with Image(iob, "simg", read_only=True) as img:
                    return name in img._hdr["snaps"]
            except Exception:                   # noqa: BLE001 — not yet
                return False

        for round_ in range(2):
            with Image(wio, "simg") as img:
                for off in mrng.integers(0, m_size - m_write,
                                         m_writes // 4):
                    off = int(off)
                    data = mrng.integers(0, 256, size=m_write,
                                         dtype=np.uint8).tobytes()
                    _, ms = timed(img.write, off, data)
                    sm[off:off + m_write] = data
                    s_ms.append(ms)
            out, ms = rbd_cmd(mon, "mirror", "snapshot", "simg")
            name = f".mirror.primary.{round_ + 1}"
            if out.strip() != name:
                fail(f"rbd: mirror snapshot simg: {out!r}")
            s_ms.append(ms)
            # synced before the next writes: a read at a snapshot that
            # races a write to its object can return the write's bytes
            # (Image._read_object_at_snap reads the head when no clone
            # is listed yet)
            guarded("rbd", cb, rb.objecter, f"the sync of {name}", wait_until,
                    lambda: synced(name), 300,
                    f"the mirror daemon to sync simg's {name}", 0.05)
        with Image(Watched(iob), "simg", read_only=True) as img:
            got, _ms, _k2 = read_whole(cb, rb, img, "simg on site B")
        same("rbd", got, bytes(sm), "simg on site B")
        step("snapshot_mirror", 2 * m_size, s_ms)
        d.stop()
        if d.errors:
            fail(f"rbd: the mirror daemon's errors: {d.errors}")
        positions = dict(d.positions)
        engines = [dm.batch_engine.dump() for dm in clock.daemons]
    finally:
        for cl in clusters[::-1]:
            cl.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    check_shards(held, {o: cpu_shards(ec_cpu, b) for o, b in stored.items()},
                 {o: len(b) for o, b in stored.items()}, "rbd")
    summed = {k: sum(e.get(k, 0) for e in engines)
              for k in ("launches", "ops_completed", "recon_launches",
                        "recon_ops_completed")}
    summed["flushes"] = sum(v for e in engines for k, v in e.items()
                            if k.startswith("flush_") and k != "flush_ms")
    return {"steps": clock.steps, "engine": summed, "daemons": len(engines),
            "objects": len(stored), "bench": bench, "lag_s": lag,
            "positions": positions}


def cephfs_phase(dev, n_mons: int, n_osds: int, pg_num: int, meta_pg: int,
                 obj: int, n_dirs: int, n_files: int, n_whole: int,
                 big_objs: int, n_writes: int, write: int, n_acked: int,
                 seed: int = 53) -> dict:
    """The port's file system on ``dev``, as upstream's "Erasure code
    with CephFS" sets it up: ``MiniCluster(n_mons, n_osds, device=dev)``
    on WALStores with the OSDs' options at their defaults but the
    heartbeat grace; a replicated metadata pool ``cephfs_metadata``
    (size 3, ``meta_pg`` PGs) and an EC data pool ``cephfs_data`` (k=8
    m=3 ``jerasure reed_sol_van``, ``pg_num`` PGs, rule 1), both created
    through librados and read back from the mon, then ``fs new`` by
    ``mon_command``; MDS ``a`` (active) and ``b`` (standby) at the
    daemon's defaults; one client of a fixed name at a layout of
    ``obj``-byte objects, one object a stripe.  Steps, each with its
    wall time, bytes, each op's latency and kernel launches: mdtest
    "easy" (IO500's metadata test) over ``n_dirs`` directories of
    ``n_files`` empty files, one step a verb (mkdir, create, stat,
    readdir, rename, unlink); ``n_whole`` files of one object and one of
    ``big_objs`` objects, each object one ``write`` call, read back byte
    for byte; ``n_writes`` seeded writes of ``write`` bytes at seeded
    offsets into the big file (EC read-modify-writes) against a host
    model; ``n_acked`` small files written, one request resent under its
    tid, the active MDS killed with its journal unflushed, the time
    until the standby is active, every acked name and size and the
    resend's first answer back; osd ``FS_KILL`` marked down by ``osd
    down`` and every file read degraded, one object a read, each read's
    hole and gf_planes launches logged; the revive until every PG is
    clean; every OSD's shards and hinfos of every data object against a
    re-encode of the host models on the CPU and the host CRC-32C; the
    big file unlinked and its data objects gone.  Any wrong byte, name
    or size, an MDS not active in its wait, a read not done in
    ``STUCK_S`` (dumped by ``dump_stuck``) or a failed op fails the
    phase; a change of the active MDS outside the failover step is
    printed as a spurious failover."""
    from ceph_tpu_torch.ec import create_erasure_code
    from ceph_tpu_torch.kernels import build
    from ceph_tpu_torch.mds.daemon import data_oid
    from ceph_tpu_torch.osd.osdmap import TYPE_ERASURE, TYPE_REPLICATED
    from ceph_tpu_torch.osdc.librados import ObjectNotFound
    from ceph_tpu_torch.osdc.striper import FileLayout
    from ceph_tpu_torch.vstart import MiniCluster
    profile = {"plugin": "jerasure", "technique": "reed_sol_van",
               "k": K, "m": M}
    ec_cpu = create_erasure_code(profile, device="cpu")
    rng = np.random.default_rng(seed)
    clock = StepClock("cephfs", dev)
    osd_config = {"osd_heartbeat_grace": CLUSTER_HB_GRACE,
                  "device_profiling_enable": True}
    n_pgs = pg_num + meta_pg
    models = {}             # path → its bytes now
    expect = ["a"]          # the MDS that should be active
    spurious = []

    def actives():
        return sorted(n for n, m in c.mdss.items() if m.state == "active")

    def step(name, nbytes=0, ms=(), extra=""):
        now = actives()
        if now != expect:
            spurious.append((name, now))
            log(f"[cephfs] spurious failover: after {name} the active MDS "
                f"is {now}, not {expect}")
            expect[:] = now
        out = clock.close(name, (f", {nbytes / 1e6:.1f} MB" if nbytes
                                 else "") + latencies(list(ms)) + extra)
        out["ms"], out["bytes"] = list(ms), nbytes
        return out

    def guard(what, fn, *a):
        return guarded("cephfs", c, fs.rados.objecter, what, fn, *a)

    def ops(what, fn, args_list):
        """fn(*args) for each args, guarded and timed: (results, ms)."""
        out, ms = [], []
        for a in args_list:
            got, t = timed(guard, f"{what} {a[0]}", fn, *a)
            out.append(got)
            ms.append(t)
        return out, ms

    def read_objects(path, what):
        """The file read one object at a time: (bytes, each read's ms,
        each read's gf_planes launches)."""
        out, ms, k2 = bytearray(), [], []
        fd = fs.open(path, "r")
        size = len(models[path])
        for off in range(0, size, obj):
            before = build.counts()["gf_planes"]
            piece, t = timed(guard, f"{what} of {path} at {off}",
                             fs.read, fd, min(obj, size - off), off)
            out += piece
            ms.append(t)
            k2.append(build.counts()["gf_planes"] - before)
        fs.close(fd)
        return bytes(out), ms, k2

    c = MiniCluster(n_mons=n_mons, n_osds=n_osds, device=dev,
                    osd_config=osd_config)
    try:
        c.start(timeout=60)
        clock.daemons.extend(c.osds.values())
        r = c.rados()
        rc, outs, _ = r.mon_command({
            "prefix": "osd erasure-code-profile set", "name": "k8m3",
            "profile": [f"{k}={v}" for k, v in profile.items()]})
        if rc:
            fail(f"cephfs: erasure-code-profile set: {outs}")
        r.create_pool("cephfs_data", pg_num=pg_num, pool_type="erasure",
                      erasure_code_profile="k8m3", rule=1)
        r.create_pool("cephfs_metadata", pg_num=meta_pg, size=3)
        wait_clean("cephfs", c, n_pgs,
                   "every PG clean after the pools' creation")
        rc, outs, dump = r.mon_command({"prefix": "osd dump"})
        pools = {p["name"]: p for p in dump["pools"]} if rc == 0 else {}
        got = [(n, pools[n]["type"], pools[n]["crush_rule"],
                pools[n]["size"], pools[n]["pg_num"]) if n in pools else n
               for n in ("cephfs_data", "cephfs_metadata")]
        if got != [("cephfs_data", TYPE_ERASURE, 1, K + M, pg_num),
                   ("cephfs_metadata", TYPE_REPLICATED, 0, 3, meta_pg)] \
                or pools["cephfs_data"]["erasure_code_profile"] != "k8m3":
            fail(f"cephfs: the pools as the mon has them (name, type, "
                 f"rule, size, pg_num): {got}; {outs}")
        log(f"[cephfs] pools read back from the mon: cephfs_data erasure "
            f"profile k8m3 crush_rule 1 size {K + M} min_size "
            f"{pools['cephfs_data']['min_size']} pg_num {pg_num}; "
            f"cephfs_metadata replicated crush_rule 0 size 3 pg_num "
            f"{meta_pg}")
        rc, outs, _ = r.mon_command({
            "prefix": "fs new", "fs_name": "cephfs",
            "metadata": "cephfs_metadata", "data": "cephfs_data"})
        if rc:
            fail(f"cephfs: fs new: {outs}")
        c.start_mds("a")
        try:
            if c.wait_for_active_mds(timeout=60) != "a":
                fail(f"cephfs: MDS a is not the active one: {actives()}")
            c.start_mds("b")
            wait_until(lambda: r.mon_command({"prefix": "mds stat"})[2][
                "standby_count"] == 1, 60, "MDS b to stand by", 0.1)
            fs = c.cephfs(entity="client.smoke", default_layout=FileLayout(
                stripe_unit=obj, stripe_count=1, object_size=obj))
        except TimeoutError as e:
            fail(f"cephfs: {e}")
        data_pool = fs.data.pool_id
        step("start")
        # 1. mdtest "easy": every verb over every file, one step a verb
        fs.mkdir("/mdtest")
        dirs = [f"/mdtest/d{i}" for i in range(n_dirs)]
        files = [f"{d}/f{j:03d}" for d in dirs for j in range(n_files)]
        verbs = {}

        def create(p):
            fs.close(fs.open(p, "x"))

        def stat_empty(p):
            rec = fs.stat(p)
            if rec["type"] != "file" or rec["size"] != 0:
                raise AssertionError(f"stat {p}: {rec}")

        def readdir(d, want):
            names = fs.listdir(d)
            if names != want:
                raise AssertionError(f"readdir {d}: {names[:4]} ...")

        _, ms = ops("mkdir", fs.mkdir, [(d,) for d in dirs])
        verbs["mkdir"] = step("md_mkdir", 0, ms)
        _, ms = ops("create", create, [(p,) for p in files])
        verbs["create"] = step("md_create", 0, ms)
        _, ms = ops("stat", stat_empty, [(p,) for p in files])
        verbs["stat"] = step("md_stat", 0, ms)
        names = [f"f{j:03d}" for j in range(n_files)]
        _, ms = ops("readdir", readdir, [(d, names) for d in dirs])
        verbs["readdir"] = step("md_readdir", 0, ms)
        _, ms = ops("rename", fs.rename,
                    [(p, p.replace("/f", "/r")) for p in files])
        verbs["rename"] = step("md_rename", 0, ms)
        ops("readdir", readdir,
            [(d, [n.replace("f", "r") for n in names]) for d in dirs])
        _, ms = ops("unlink", fs.unlink,
                    [(p.replace("/f", "/r"),) for p in files])
        verbs["unlink"] = step("md_unlink", 0, ms)
        ops("readdir", readdir, [(d, []) for d in dirs])
        # 2. whole files: each object written in one call, read back
        fs.mkdir("/data")
        sizes = {f"/data/w{i}": obj for i in range(n_whole)}
        sizes["/data/big"] = big_objs * obj
        w_ms = []
        for path, size in sizes.items():
            data = rng.integers(0, 256, size=size, dtype=np.uint8).tobytes()
            fd = fs.open(path, "w")
            for off in range(0, size, obj):
                _, t = timed(guard, f"write of {path} at {off}", fs.write,
                             fd, data[off:off + obj], off)
                w_ms.append(t)
            guard(f"close of {path}", fs.close, fd)
            models[path] = bytearray(data)
        total = sum(sizes.values())
        step("write_files", total, w_ms)
        got, r_ms = ops("read", fs.read_file, [(p,) for p in sizes])
        for p, g in zip(sizes, got):
            same("cephfs", g, bytes(models[p]), f"read of {p}")
        step("read_files", total, r_ms)
        # 3. partial writes into the big file: EC read-modify-writes
        big = models["/data/big"]
        wrng = np.random.default_rng(seed + 1)
        p_ms = []
        fd = fs.open("/data/big", "a")
        for off in wrng.integers(0, len(big) - write, n_writes):
            off = int(off)
            data = wrng.integers(0, 256, size=write, dtype=np.uint8).tobytes()
            _, t = timed(guard, f"partial write at {off}", fs.write, fd,
                         data, off)
            big[off:off + write] = data
            p_ms.append(t)
        guard("close of /data/big", fs.close, fd)
        step("partial_writes", n_writes * write, p_ms)
        got, t = timed(guard, "read of /data/big", fs.read_file,
                       "/data/big")
        same("cephfs", got, bytes(big), "/data/big after the partial writes")
        step("read_partial", len(big), [t])
        # 4. MDS failover right after acked creates, with no flush
        fs.mkdir("/fo")
        a_ms = []
        for i in range(n_acked):
            p = f"/fo/a{i:02d}"
            data = rng.integers(0, 256, size=1000 * (i + 1),
                                dtype=np.uint8).tobytes()
            _, t = timed(guard, f"write_file {p}", fs.write_file, p, data)
            models[p] = bytearray(data)
            a_ms.append(t)
        args = {"dir": fs.stat("/fo")["ino"], "excl": True,
                "layout": {"stripe_unit": obj, "stripe_count": 1,
                           "object_size": obj}}
        victim = expect[0]
        m = c.mdss[victim]
        # the resend is answered from the journal's completed requests,
        # which a flush trims (ROADMAP.md §3): the probe's create goes
        # right after a flush and the kill, under the daemon's lock,
        # follows while its event is still in the journal
        for attempt in range(5):
            last = m._last_flush
            wait_until(lambda: m._last_flush != last, 60,
                       f"mds.{victim} to flush its journal", 0.005)
            args["name"] = dup = f"dup{attempt}"
            first = guard(f"create of /fo/{dup}", fs._request, "create",
                          args)
            tid, seq = fs._tid, m._jseq - 1
            with m.lock:
                unflushed = m._jseq - m._jfirst
                if m._jfirst <= seq:
                    t0 = time.perf_counter()
                    c.kill_mds(victim)
                    break
        else:
            fail(f"cephfs: mds.{victim} flushed its journal before the kill "
                 f"in each of 5 tries")
        try:
            survivor = c.wait_for_active_mds(timeout=60)
        except TimeoutError as e:
            fail(f"cephfs: after the kill of mds.{victim}: {e}")
        fail_s = time.perf_counter() - t0
        expect[:] = [survivor]
        top = fs._tid
        fs._tid = tid - 1               # the resend, under its first tid
        again, t_re = timed(guard, f"resend of the create of /fo/{dup}",
                            fs._request, "create", args)
        fs._tid = top
        if again != first:
            fail(f"cephfs: the resent create got {again}, not its first "
                 f"answer {first}")
        want = sorted([f"dup{i}" for i in range(attempt + 1)]
                      + [f"a{i:02d}" for i in range(n_acked)])
        if guard("readdir /fo", fs.listdir, "/fo") != want:
            fail("cephfs: the names acked before the failover are not all "
                 "there after it")
        for i in range(n_acked):
            p = f"/fo/a{i:02d}"
            size = guard(f"stat {p}", fs.stat, p)["size"]
            if size != len(models[p]):
                fail(f"cephfs: {p} is {size} bytes after the failover, not "
                     f"{len(models[p])}")
            same("cephfs", guard(f"read {p}", fs.read_file, p),
                 bytes(models[p]), f"{p} after the failover")
        step("failover", sum(1000 * (i + 1) for i in range(n_acked)),
             a_ms + [t_re], f"; {unflushed} journal events unflushed at "
             f"the kill of mds.{victim} (try {attempt + 1}), "
             f"mds.{survivor} active {fail_s:.3f} s after it")
        # 5. one OSD down: every file read degraded, one object a read;
        # each object's hole is osd.FS_KILL's shard in the map before
        omap_ = fs.rados.objecter.osdmap
        inos = {p: guard(f"stat {p}", fs.stat, p)["ino"] for p in models}
        holes = {}
        for path, b in models.items():
            for n in range(-(-len(b) // obj)):
                oid = data_oid(inos[path], n)
                pgid = omap_.raw_pg_to_pg(omap_.object_locator_to_pg(
                    oid, data_pool))
                holes[oid] = (pgid, omap_.pg_to_up_acting_osds(
                    pgid)[2].index(FS_KILL))
        c.kill_osd(FS_KILL)
        rc, outs, _ = r.mon_command({"prefix": "osd down",
                                     "ids": [FS_KILL]})
        if rc:
            fail(f"cephfs: osd down: {outs}")
        c.wait_for_osd_down(FS_KILL, timeout=4 * CLUSTER_HB_GRACE)
        wait_until(lambda: not fs.rados.objecter.osdmap.is_up(FS_KILL), 60,
                   f"the client's map to mark osd.{FS_KILL} down", 0.05)
        c.wait_for_clean(timeout=120)
        step("kill")
        d_ms, decodes = [], []
        for path in models:
            got, ms, k2 = read_objects(path, "degraded read")
            same("cephfs", got, bytes(models[path]),
                 f"degraded read of {path}")
            d_ms += ms
            for n, launched in enumerate(k2):
                oid = data_oid(inos[path], n)
                decodes.append(f"{oid} {holes[oid][0]} {holes[oid][1]} "
                               f"{launched}")
        log("[cephfs] degraded reads (object, pg, the hole's shard, "
            f"gf_planes launches; a hole below {K} is a data shard and "
            "decodes): " + "; ".join(decodes))
        step("degraded_read", sum(len(b) for b in models.values()), d_ms)
        # 6. the revive, until every PG is clean
        c.revive_osd(FS_KILL, timeout=60)
        clock.daemons.append(c.osds[FS_KILL])
        wait_until(lambda: all(d.osdmap.is_up(FS_KILL)
                               for d in c.osds.values()), 120,
                   f"every OSD to see osd.{FS_KILL} up", 0.05)
        wait_clean("cephfs", c, n_pgs, "every PG clean after the revive")
        step("recovery")
        # 7. every data object's shards and hinfos, against the models
        wait_until(lambda: all(
            d.osdmap.epoch == fs.rados.objecter.osdmap.epoch
            for d in c.osds.values()), 60,
                   "the client and the OSDs on one map", 0.05)
        stored = {data_oid(inos[p], n): bytes(b[n * obj:(n + 1) * obj])
                  for p, b in models.items()
                  for n in range(-(-len(b) // obj))}
        held = hold_shards(c, place_shards(c, data_pool, stored, "cephfs"))
        step("hold_shards")
        # 8. the purge: the big file's data objects go with its name
        big_oids = [data_oid(inos["/data/big"], n) for n in range(big_objs)]
        _, t = timed(guard, "unlink /data/big", fs.unlink, "/data/big")
        for oid in big_oids:
            try:
                fs.data.stat(oid)
            except ObjectNotFound:
                continue
            fail(f"cephfs: {oid} is still in the data pool after the "
                 f"unlink of /data/big")
        step("purge", 0, [t])
        perf = c.mdss[expect[0]].perf.dump()
        engines = [dm.batch_engine.dump() for dm in clock.daemons]
    finally:
        c.stop()
    check_shards(held, {o: cpu_shards(ec_cpu, b) for o, b in stored.items()},
                 {o: len(b) for o, b in stored.items()}, "cephfs")
    summed = {k: sum(e.get(k, 0) for e in engines)
              for k in ("launches", "ops_completed", "recon_launches",
                        "recon_ops_completed")}
    summed["flushes"] = sum(v for e in engines for k, v in e.items()
                            if k.startswith("flush_") and k != "flush_ms")
    return {"steps": clock.steps, "engine": summed, "daemons": len(engines),
            "objects": len(stored), "verbs": verbs, "failover_s": fail_s,
            "unflushed": unflushed, "spurious": spurious, "mds_perf": perf}


def wait_until(pred, timeout: float, what: str, interval: float = 0.01):
    """Poll ``pred`` until it holds; fail the smoke after ``timeout``."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(interval)
    fail(f"timed out after {timeout:.0f} s waiting for {what}")


def free_ports(n: int) -> list[int]:
    """``n`` ephemeral localhost ports, as the OS hands them out."""
    import socket
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def upmap_lines(props: dict) -> list[str]:
    """Proposals as ``osdmaptool --upmap`` writes them, one command a
    PG in the order of the pgid's text."""
    return [f"ceph osd pg-upmap-items {pgid} "
            + " ".join(f"{a} {b}" for a, b in items)
            for pgid, items in sorted(props.items(), key=lambda kv: str(
                kv[0]))]


def balancer_phase(dev, hosts: int, per_host: int, pg_num: int,
                   moves: int) -> dict:
    """The upmap balancer at full width: ``hosts`` x ``per_host`` OSDs
    (the crush phase's hierarchy), every OSD up, one size-3 replicated
    pool of ``pg_num`` PGs on ``chooseleaf_firstn host``.
    ``UpmapBalancer(m, pool, device=dev)`` maps the pool through K7 (no
    injected placements) and proposes ``moves`` moves; a twin balancer
    over the plain mapper's placements (``straw2_plain`` on the card)
    must propose the same; the whole K7 matrix equals the plain one; no
    PG holds two replicas on a host after the moves; the stddev falls;
    and ``osdmaptool --upmap --upmap-max moves --device cuda``, run as a
    process on the same map file, writes the same commands."""
    import torch
    from ceph_tpu_torch.crush import straw2 as K7
    from ceph_tpu_torch.crush.map import build_hierarchy
    from ceph_tpu_torch.kernels import build
    from ceph_tpu_torch.mgr import UpmapBalancer
    from ceph_tpu_torch.osd.osdmap import EXISTS, UP, OSDMap
    from ceph_tpu_torch.tools.osdmaptool import map_pool_pgs, save_osdmap

    def k7_count():
        return build.counts()["crush_straw2"]

    def pool_map():
        m = OSDMap(crush=build_hierarchy(1, hosts, per_host),
                   max_osd=hosts * per_host)
        m.epoch = 1
        for o in range(m.max_osd):
            m.osd_state[o] = EXISTS | UP
        m.create_pool("bench", pg_num=pg_num, size=3, crush_rule=0)
        return m

    def timed(fn):
        torch.cuda.synchronize()
        n, t = k7_count(), time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t) * 1e3, k7_count() - n

    out = {}
    m, twin_map = pool_map(), pool_map()
    tmp = tempfile.mkdtemp(prefix="ctt_bal_")
    try:
        mapfile = os.path.join(tmp, "map.json")
        save_osdmap(m, mapfile)              # before any move
        pool = m.pools[0]
        bal = UpmapBalancer(m, pool.id, device=dev)
        raw, out["map_ms"], out["map_launches"] = timed(
            lambda: map_pool_pgs(m, pool, device=dev))
        raw = np.asarray(raw)
        twin_map.batch_mapper(0, 3, device=dev)._straw2 = K7.straw2_plain
        plain, out["plain_map_ms"], _ = timed(
            lambda: np.asarray(map_pool_pgs(twin_map, twin_map.pools[0],
                                            device=dev)))
        if not np.array_equal(raw, plain):
            bad = int((raw != plain).any(axis=1).sum())
            fail(f"balancer: K7 placements differ from the plain mapper "
                 f"on {bad} of {pg_num} PGs")
        twin = UpmapBalancer(twin_map, 0, placements=plain)
        out["stddev_before"], out["stddev_ms"], _ = timed(bal.stddev)
        props, out["round_ms"], out["round_launches"] = timed(
            lambda: bal.optimize(max_changes=moves))
        out["stddev_after"] = bal.stddev()
        # where a round's host time goes: the placement matrix (its
        # mapping included), the targets, and one of the round's scans
        # for the PGs on the fullest OSD, each once more on its own
        mat, out["matrix_ms"], _ = timed(bal._placement_matrix)
        _, out["targets_ms"], _ = timed(bal._targets)
        _, out["scan_ms"], _ = timed(lambda: (mat == mat[0, 0]).any(axis=1))
        if len(props) != moves:
            fail(f"balancer: {len(props)} proposals, want {moves}")
        if twin.stddev() != out["stddev_before"] or \
                twin.optimize(max_changes=moves) != props or \
                twin.stddev() != out["stddev_after"]:
            fail("balancer: the proposals differ from those over the "
                 "plain mapper's placements")
        if not out["stddev_after"] < out["stddev_before"]:
            fail(f"balancer: stddev {out['stddev_before']} -> "
                 f"{out['stddev_after']} did not fall")
        # every PG after the moves: replicas on distinct hosts
        final = raw.astype(np.int64)
        for pgid, items in props.items():
            row = m._apply_upmap(pgid, [int(o) for o in raw[pgid.seed]])
            final[pgid.seed] = row
        dom = np.zeros(m.max_osd, dtype=np.int64)    # bucket ids are < 0
        for o, d in bal._domain_of.items():
            dom[o] = d
        hosts_of = np.sort(dom[final], axis=1)
        if (hosts_of == 0).any() or \
                (hosts_of[:, 1:] == hosts_of[:, :-1]).any():
            fail("balancer: a PG holds two replicas on one host")
        # osdmaptool --upmap on the same map, as a process on the card
        upfile = os.path.join(tmp, "upmap.txt")
        t = time.perf_counter()
        rc, stdout = run_tools({"--upmap": ("osdmaptool", [
            mapfile, "--upmap", upfile, "--upmap-max", str(moves),
            "--device", dev.type])})["--upmap"]
        out["tool_s"] = time.perf_counter() - t
        if rc:
            fail(f"osdmaptool --upmap exited {rc}")
        with open(upfile) as f:
            lines = f.read().splitlines()
        if lines != upmap_lines(props):
            fail(f"osdmaptool --upmap wrote {lines[:3]}..., the balancer "
                 f"proposed {upmap_lines(props)[:3]}...")
        out["tool_stdout"] = stdout.strip()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["proposals"] = props
    out["moves"] = len(props)
    return out


def mon_crushmap(hosts: int, per_host: int) -> dict:
    """The crush phase's map (``hosts`` x ``per_host`` OSDs) as a dict
    for ``osd setcrushmap``: its replicated rule (id 0) and its EC rule
    (``chooseleaf_indep host``) as rule 1, the erasure rule id the mon
    gives an EC pool."""
    from ceph_tpu_torch.crush.compiler import crushmap_to_dict
    from ceph_tpu_torch.crush.map import build_hierarchy
    out = crushmap_to_dict(build_hierarchy(1, hosts, per_host))
    ec = crushmap_to_dict(build_hierarchy(1, hosts, per_host,
                                          rule="chooseleaf_indep"))
    rule = dict(ec["rules"][0], id=1, name="erasure_rule")
    out["rules"].append(rule)
    return out


def cli(tool, argv: list) -> tuple[int, str, str]:
    """A CLI of the port run in process as ``main(argv)``: (exit code,
    stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tool.main([str(a) for a in argv])
    return rc, out.getvalue(), err.getvalue()


def client_steps(monmap, leader, proposals: dict) -> dict:
    """The clients against the port's quorum: ``monmaptool --create``
    with the quorum's addresses; one OSD's boot message (``BOOT_OSD``,
    so the map has ``BOOT_OSD + 1`` devices and the mon takes upmaps to
    any of them); ``ceph -m`` status, osd tree, osd pool ls, osd pool
    create, osd dump; the balancer phase's ``proposals`` applied to the
    replicated pool ``rbd`` with ``ceph osd pg-upmap-items``; then
    ``Rados(monmap).connect()``, whose Objecter must reach the epoch
    that carries the upmaps and hold exactly them, ``list_pools``,
    ``pool_lookup`` and ``rados lspools``.  Returns the host-clock
    times."""
    from ceph_tpu_torch.mon import MonClient
    from ceph_tpu_torch.mon.messages import MOSDBoot
    from ceph_tpu_torch.osd.osdmap import PGid
    from ceph_tpu_torch.osdc.librados import Rados
    from ceph_tpu_torch.tools import ceph, monmaptool, rados
    out = {}
    addrs = ",".join(f"{monmap.mons[r].host}:{monmap.mons[r].port}"
                     for r in monmap.ranks())
    svc = leader.services["osdmap"]
    tmp = tempfile.mkdtemp(prefix="ctt_cli_")
    boot = None
    try:
        mmfile = os.path.join(tmp, "monmap")
        argv = ["--create"]
        for r in monmap.ranks():
            argv += ["--add", r, f"{monmap.mons[r].host}:"
                                 f"{monmap.mons[r].port}"]
        t = time.perf_counter()
        rc, text, err = cli(monmaptool, argv + ["--print", mmfile])
        out["monmaptool_ms"] = (time.perf_counter() - t) * 1e3
        made = monmaptool.load_monmap(mmfile)
        if rc or {r: (a.host, a.port) for r, a in made.mons.items()} != {
                r: (a.host, a.port) for r, a in monmap.mons.items()}:
            fail(f"monmaptool --create: rc {rc}, {text}{err}")
        t = time.perf_counter()
        boot = MonClient(monmap, entity=f"osd.{BOOT_OSD}")
        boot.send(MOSDBoot(osd=BOOT_OSD, addr="127.0.0.1:7000"))
        wait_until(lambda: svc.osdmap.max_osd > BOOT_OSD, 30,
                   f"osd.{BOOT_OSD}'s boot in the committed map")
        out["boot_ms"] = (time.perf_counter() - t) * 1e3
        times = {}
        for words in (["status"], ["osd", "tree"], ["osd", "pool", "ls"],
                      ["osd", "pool", "create", "clipool", "--pg-num", 64],
                      ["osd", "dump"]):
            t = time.perf_counter()
            rc, text, err = cli(ceph, ["-m", addrs, *words])
            times[" ".join(map(str, words[:3]))] = \
                (time.perf_counter() - t) * 1e3
            if rc:
                fail(f"ceph {' '.join(map(str, words))}: rc {rc}: {err}")
        if "clipool" not in {p["name"] for p in json.loads(text)["pools"]}:
            fail("ceph osd dump does not show the pool the CLI created")
        out["ceph_ms"] = times
        pool_id = svc.osdmap.pool_name["rbd"]
        want = {PGid(pool_id, pg.seed): [tuple(p) for p in items]
                for pg, items in proposals.items()}
        t = time.perf_counter()
        for line in upmap_lines(want):
            rc, _text, err = cli(ceph, ["-m", addrs, *line.split()[1:]])
            if rc:
                fail(f"{line}: rc {rc}: {err}")
        out["upmap_ms"] = (time.perf_counter() - t) * 1e3
        epoch = svc.osdmap.epoch
        t = time.perf_counter()
        r = Rados(monmap).connect()
        try:
            out["connect_ms"] = (time.perf_counter() - t) * 1e3
            o = r.objecter
            wait_until(lambda: o.osdmap.epoch >= epoch, 30,
                       f"the Objecter at epoch {epoch}")
            out["objecter_ms"] = (time.perf_counter() - t) * 1e3
            got = {pg: [tuple(p) for p in items]
                   for pg, items in o.osdmap.pg_upmap_items.items()}
            if got != want:
                fail(f"the Objecter's pg_upmap_items {sorted(got)[:3]} "
                     f"differ from the proposals {sorted(want)[:3]}")
            pools = r.list_pools()
            if sorted(pools) != sorted(["ecpool", "rbd", "clipool"]) or \
                    r.pool_lookup("rbd") != pool_id:
                fail(f"librados: list_pools {pools}, pool_lookup "
                     f"{r.pool_lookup('rbd')} (want {pool_id})")
        finally:
            r.shutdown()
        t = time.perf_counter()
        rc, text, err = cli(rados, ["-m", addrs, "lspools"])
        out["rados_ms"] = (time.perf_counter() - t) * 1e3
        if rc or sorted(text.split()) != sorted(pools):
            fail(f"rados lspools: rc {rc}: {text!r} {err}")
        out["epoch"] = epoch
        out["pool_id"] = pool_id
    finally:
        if boot is not None:
            boot.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def mon_phase(crushmap: dict, mode: str, proposals: dict | None = None
              ) -> dict:
    """Three port monitors on localhost, each on a ``MonitorDBStore``
    WAL in a fresh temporary directory, driven through a ``MonClient``
    in ``mode`` (``crc``, or ``secure`` with one ``ClusterAuth``):
    quorum, the 4096-OSD crush map, an EC profile, an EC pool and a
    replicated pool of ``MON_PG_NUM`` PGs, config-keys, the log and the
    read commands, every mutating command answered after its round
    committed and every mon at the same version; with ``proposals``
    (the balancer phase's), the clients of ``client_steps``; then the
    leader is killed, a new one elected and serving, and the killed mon
    restarted from its WAL catches up.  Returns the timings."""
    from ceph_tpu_torch.core import auth as A
    from ceph_tpu_torch.mon import MonClient, MonitorDBStore, Monitor, MonMap
    from ceph_tpu_torch.msg import EntityAddr
    tmp = tempfile.mkdtemp(prefix="ctt_mon_")
    auth = A.ClusterAuth(b"mon-phase secret") if mode == "secure" else None
    ports = free_ports(3)
    monmap = MonMap(mons={r: EntityAddr("127.0.0.1", p)
                          for r, p in enumerate(ports)})
    wals = [os.path.join(tmp, f"mon{r}.wal") for r in range(3)]
    mons = [Monitor(r, monmap, store=MonitorDBStore(wals[r]), auth=auth)
            for r in range(3)]
    mc = None
    out = {"mode": mode, "fs": fs_type(tmp),
           "aead": "AESGCM" if A.AESGCM is not None else "HMAC-SHA256"}
    try:
        t0 = time.perf_counter()
        for m in mons:
            m.start()
        wait_until(lambda: any(m.is_leader and m.paxos.is_writeable()
                               for m in mons) and all(
            sorted(m.quorum) == [0, 1, 2] for m in mons), 30,
            f"a {mode} quorum of the three mons")
        out["election_ms"] = (time.perf_counter() - t0) * 1e3
        leader = next(m for m in mons if m.is_leader)
        out["quorum"] = sorted(leader.quorum)
        mc = MonClient(monmap, auth=auth)
        commit_ms = []

        def command(cmd, mutating):
            before = leader.paxos.last_committed
            t = time.perf_counter()
            rc, outs, res = mc.command(cmd, timeout=60)
            dt = (time.perf_counter() - t) * 1e3
            if rc != 0:
                fail(f"mon ({mode}): {cmd['prefix']} rc {rc}: {outs}")
            if mutating:
                if leader.paxos.last_committed <= before:
                    fail(f"mon ({mode}): {cmd['prefix']} answered before "
                         f"its round committed")
                commit_ms.append(dt)
                version = leader.paxos.last_committed
                wait_until(lambda: all(m.paxos.last_committed >= version
                                       for m in mons if m.running), 30,
                           f"every mon at version {version} after "
                           f"{cmd['prefix']}")
            return res

        command({"prefix": "osd setcrushmap", "crushmap": crushmap}, True)
        command({"prefix": "osd erasure-code-profile set", "name": "ec83",
                 "profile": [f"k={K}", f"m={M}", "plugin=jerasure",
                             "technique=reed_sol_van"]}, True)
        command({"prefix": "osd pool create", "pool": "ecpool",
                 "pg_num": MON_EC_PG_NUM, "pool_type": "erasure",
                 "erasure_code_profile": "ec83"}, True)
        command({"prefix": "osd pool create", "pool": "rbd",
                 "pg_num": MON_PG_NUM}, True)
        command({"prefix": "config-key put", "key": "smoke/mode",
                 "val": mode}, True)
        if command({"prefix": "config-key get", "key": "smoke/mode"},
                   False) != mode:
            fail(f"mon ({mode}): config-key get returned another value")
        command({"prefix": "log", "logtext": f"chip smoke {mode}"}, True)
        dump = command({"prefix": "osd dump"}, False)
        pools = {p["name"]: p for p in dump["pools"]}
        if pools["rbd"]["pg_num"] != MON_PG_NUM or \
                pools["ecpool"]["size"] != K + M:
            fail(f"mon ({mode}): osd dump pools {pools}")
        status = command({"prefix": "status"}, False)
        if sorted(status["quorum"]) != [0, 1, 2]:
            fail(f"mon ({mode}): status quorum {status['quorum']}")
        health = command({"prefix": "health detail"}, False)
        summary = command({"prefix": "pg summary"}, False)
        if "health" not in health or "reported_pgs" not in summary:
            fail(f"mon ({mode}): health detail / pg summary replies")
        if leader.services["osdmap"].osdmap.crush.max_devices != \
                crushmap["max_devices"]:
            fail(f"mon ({mode}): the committed crush map lost devices")
        if proposals is not None:
            out["clients"] = client_steps(monmap, leader, proposals)
        wait_until(lambda: len({m.paxos.last_committed
                                for m in mons}) == 1, 30,
                   "every mon at the same paxos version")
        out["version"] = leader.paxos.last_committed
        out["commit_ms"] = commit_ms
        # kill the leader: the two left elect one and serve
        t0 = time.perf_counter()
        killed = leader.rank
        leader.shutdown()
        rest = [m for m in mons if m.rank != killed]
        wait_until(lambda: any(m.is_leader and m.paxos.is_writeable()
                               for m in rest), 30, "a new leader")
        out["reelection_ms"] = (time.perf_counter() - t0) * 1e3
        leader = next(m for m in rest if m.is_leader)
        command({"prefix": "config-key put", "key": "smoke/after",
                 "val": "failover"}, True)
        out["new_leader"] = leader.rank
        version = leader.paxos.last_committed
        # restart the killed mon from its WAL: it catches up
        t0 = time.perf_counter()
        store = MonitorDBStore(wals[killed])
        out["replay_ms"] = (time.perf_counter() - t0) * 1e3
        out["wal_MiB"] = os.path.getsize(wals[killed]) / 2**20
        revived = Monitor(killed, monmap, store=store, auth=auth)
        mons[killed] = revived
        if revived.paxos.last_committed >= version:
            fail(f"mon ({mode}): the killed mon was not behind")
        revived.start()
        wait_until(lambda: revived.paxos.last_committed >= version, 30,
                   "the restarted mon to catch up")
        out["catch_up_ms"] = (time.perf_counter() - t0) * 1e3
        out["caught_up_to"] = version
        if revived.store.get_str("svc_config", "smoke/after") != "failover":
            fail(f"mon ({mode}): the restarted mon lacks the new round")
    finally:
        if mc is not None:
            mc.shutdown()
        for m in mons:
            if m.running:
                m.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def pgmap_fold_args(torch, dev, n: int, n_states: int, ages: str,
                    seed: int):
    """K11's arguments for ``n`` PGs on ``dev``: (sid, stamp, now,
    objects, missing, backfill, scrub errors, hist_len).  ``ages``:
    ``mix`` (fresh, stale, exactly the grace, NaN and negative ages),
    ``stale`` (all stale) or ``fresh`` (all fresh)."""
    from ceph_tpu_torch.mon.pgmap import PG_STALE_GRACE
    rng = np.random.default_rng(seed)
    now = 1.75e9
    age = {"mix": rng.choice([0.0, 1.5, PG_STALE_GRACE, 7.0, 60.0,
                              -3.0, np.nan], n),
           "stale": rng.uniform(PG_STALE_GRACE + 1, 600.0, n),
           "fresh": rng.uniform(0.0, PG_STALE_GRACE, n)}[ages]
    cols = [rng.integers(0, n_states, n), now - age,
            rng.integers(0, 2000, n), rng.integers(0, 50, n),
            rng.integers(0, 200, n), rng.integers(0, 5, n)]
    t = [torch.from_numpy(a).to(dev) for a in cols]
    return (t[0], t[1], now, *t[2:], 2 * n_states)


def controlplane_phase(dev, n_osds: int, pg_num: int, sample: int) -> dict:
    """``ScaleHarness(placement="crush")`` at ``n_osds`` x ``pg_num`` on
    ``dev`` (the pool mapped by K7), its placements held against the
    plain mapper on ``sample`` PGs, the health pass (best of 5), the
    ``pg summary`` payload, and the summary fold on the card (K11) held
    equal to the numpy fold, also with 1% stale PGs and NaN stamps."""
    import torch
    from ceph_tpu_torch.crush import straw2 as K7
    from ceph_tpu_torch.crush.torch_mapper import BatchMapper
    from ceph_tpu_torch.vstart import ScaleHarness
    out = {}
    t0 = time.perf_counter()
    h = ScaleHarness(n_osds=n_osds, pg_num=pg_num, seed=1,
                     placement="crush", device=dev)
    out["build_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    rows = np.sort(rng.choice(pg_num, size=sample, replace=False))
    pps = h.pool.raw_pg_to_pps_batch(rows.astype(np.uint32))
    plain = BatchMapper(h.osdmap.crush, h.pool.crush_rule,
                        result_max=h.pool.size, device=dev)
    plain._straw2 = K7.straw2_plain
    want = plain(pps, np.asarray(h.osdmap.osd_weight, dtype=np.uint32))
    if not np.array_equal(h.placements[rows], want):
        fail("controlplane: crush placements differ from the plain mapper")
    h.evaluate()                        # warm interning and caches
    best = float("inf")
    for _ in range(5):
        t = time.perf_counter()
        checks = h.evaluate()
        best = min(best, time.perf_counter() - t)
    out["health_ms"] = best * 1e3
    out["codes"] = sorted(c["code"] for c in checks)
    if not {"PG_DEGRADED", "PG_DAMAGED", "PG_NOT_SCRUBBED"} <= \
            set(out["codes"]):
        fail(f"controlplane: health codes {out['codes']}")
    t = time.perf_counter()
    s = h.summary()
    out["summary_ms"] = (time.perf_counter() - t) * 1e3
    if s["reported_pgs"] != pg_num or sum(
            s["pools"][str(h.pool.id)]["by_state"].values()) != pg_num:
        fail("controlplane: pg summary does not cover every PG")
    # bench.py::_controlplane_leg's balancer round, over the harness's
    # placements (no mapping)
    t = time.perf_counter()
    b = h.balancer()
    moves = b.optimize(max_changes=10, use_arrays=True)
    out["balancer_round_ms@1M"] = (time.perf_counter() - t) * 1e3
    out["balancer_moves"] = len(moves)
    mat = b._placement_matrix()
    for part, fn in (("matrix", b._placement_matrix),
                     ("targets", b._targets),
                     ("scan", lambda: (mat == mat[0, 0]).any(axis=1))):
        t = time.perf_counter()
        fn()
        out[f"balancer_{part}_ms"] = (time.perf_counter() - t) * 1e3
    if len(moves) != 10:
        fail(f"controlplane: the balancer round made {len(moves)} moves")
    stale = ScaleHarness(n_osds=n_osds, pg_num=pg_num, seed=2,
                         stale_frac=0.01)
    nan_rows = np.random.default_rng(4).choice(pg_num, pg_num // 100,
                                               replace=False)
    for label, pgm in (("as built", h.pgmap), ("1% stale", stale.pgmap),
                       ("1% stale, 1% NaN stamps", stale.pgmap)):
        if label.endswith("stamps"):
            pgm._cols["stamp"][nan_rows] = np.nan
        t = time.perf_counter()
        host = pgm.summary_arrays(h.now)
        np_ms = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        t = time.perf_counter()
        card = pgm.summary_arrays(h.now, use_device=True, device=dev)
        dev_ms = (time.perf_counter() - t) * 1e3
        if not np.array_equal(card["state_stale_hist"],
                              host["state_stale_hist"]) or any(
                card[k] != host[k] for k in host if k != "state_stale_hist"):
            fail(f"controlplane: the device fold differs from the numpy "
                 f"fold ({label})")
        out.setdefault("folds", []).append(
            {"label": label, "numpy_ms": np_ms, "device_ms": dev_ms,
             "stale": int(card["state_stale_hist"][1::2].sum())})
    # the device fold's copy-in alone: the six columns to the card
    n = h.pgmap._n
    cols = [h.pgmap._cols[c][:n] for c in (
        "state", "stamp", "num_objects", "missing", "backfill_remaining",
        "scrub_errors")]
    torch.cuda.synchronize()
    t = time.perf_counter()
    on_card = [torch.from_numpy(np.ascontiguousarray(c)).to(dev)
               for c in cols]
    torch.cuda.synchronize()
    out["copy_in_ms"] = (time.perf_counter() - t) * 1e3
    out["copy_MiB"] = sum(c.nbytes for c in cols) / 2**20
    out["fold_args"] = (on_card[0], on_card[1], h.now, *on_card[2:],
                        2 * len(h.pgmap._state_names))
    return out


def time_plain(torch, fn, iters: int = 2) -> float:
    """Mean ms per call of a plain version over ``iters`` calls, CUDA
    events, warm (the plain versions upload tables; no graph)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def time_kernel(torch, fn, windows: int = 5, min_ms: float = 50.0,
                min_launches: int = 200, per_graph: int = 20):
    """(median ms per launch, min, max, launches per window) over
    ``windows`` windows.  ``fn`` (one kernel launch, its tables held)
    is captured ``per_graph`` times into a CUDA graph, so the host's
    per-call cost does not leave the card idle between launches; each
    window replays the graph for at least ``min_ms`` and
    ``min_launches`` launches."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                 # warm on the capture stream
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def window(replays):
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / (replays * per_graph)

    probe = window(2)
    replays = max(math.ceil(min_launches / per_graph),
                  math.ceil(min_ms / max(probe * per_graph, 1e-6)))
    per = sorted(window(replays) for _ in range(windows))
    return per[len(per) // 2], per[0], per[-1], replays * per_graph


def cold_inputs(torch, shape, dev, seed: int, total: int = 96 << 20):
    """Distinct random uint8 inputs of ``shape``, made on the card, at
    least 8 and together at least ``total`` bytes (twice the 50 MB L2):
    a graph that cycles through them finds each input cold."""
    count = max(8, math.ceil(total / math.prod(shape)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return [torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                          generator=gen) for _ in range(count)]


def time_cold(torch, fn, inputs):
    """``time_kernel`` of ``fn(x)`` over a graph that launches it once on
    each of ``inputs`` in turn (every reuse is ``len(inputs)`` launches
    apart, so no input is left in L2)."""
    turn = [0]

    def launch():
        x = inputs[turn[0] % len(inputs)]
        turn[0] += 1
        return fn(x)
    return time_kernel(torch, launch, per_graph=len(inputs))


def max_abs_err(torch, a, b) -> int:
    if a.shape != b.shape:
        fail(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item())


def clocks() -> str:
    """SM clock (current/max), power draw and temperature, as
    nvidia-smi reads them: the card may run below its maximum."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or out.stderr.strip()


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock, as nvidia-smi reads it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if out.returncode:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return float(out.stdout.split()[0]) * 1e6


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: chip_smoke needs a GPU")
    try:
        from ceph_tpu_torch.compress import chunker as CH
        from ceph_tpu_torch.compress import codec as CO
        from ceph_tpu_torch.core.device_profiler import DeviceProfiler
        from ceph_tpu_torch.kernels import build, sass
        from ceph_tpu_torch.crush import straw2 as K7
        from ceph_tpu_torch.crush.map import build_hierarchy
        from ceph_tpu_torch.crush.torch_mapper import BatchMapper
        from ceph_tpu_torch.ec import bitmatrix as BM
        from ceph_tpu_torch.ec import create_erasure_code
        from ceph_tpu_torch.ops import gf_bytes as GB
        from ceph_tpu_torch.ops import rs
        from ceph_tpu_torch.ops import gf_words as W
        from ceph_tpu_torch.ops.gf_torch import GFLinear
        from ceph_tpu_torch.osd.batch_engine import BatchEngine, _Op
        from ceph_tpu_torch.parallel.decode_plan import decode_plan
        from ceph_tpu_torch.scrub import crc32c as C
        from ceph_tpu_torch.scrub import engine as S
        from ceph_tpu_torch.tools import ec_bench
        from ceph_tpu_torch.mon import pgmap as PG
    except ImportError as e:
        fail(f"ceph_tpu_torch is not importable beside chip_smoke.py: {e}")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}")

    t_start = time.perf_counter()
    phase_t = [t_start]

    def phase_done(name):
        now = time.perf_counter()
        log(f"[phase] {name}: {now - phase_t[0]:.1f} s wall "
            f"({now - t_start:.1f} s since start)")
        phase_t[0] = now

    # -- 1. build ---------------------------------------------------------
    lib_path = build.build(verbose=True)
    build.library()
    for stem in ("gf_words", "gf_bytes", "gf_planes", "crc32c_batch",
                 "gf2_packets", "crush_straw2", "gear_hash", "run_starts",
                 "pgmap_fold"):
        for line in build.ptxas_report(stem):
            log(f"[ptxas] {stem}.cu {line}")
    # K7's operations bound: one item of its loop as compiled, on the
    # path this run's items take (weight > 0, a numerator past 32 bits:
    # every forward branch falls through)
    k7_mix = sass.loop_mix(sass.disassemble(lib_path), "crush_straw2_kernel")
    k7_pipes = sass.pipe_counts(k7_mix)
    k7_item_clocks = sass.clocks_per_iteration(k7_mix)
    k7_by = max(k7_pipes, key=lambda p: k7_pipes[p] / sass.SM_RATES[p])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sm_hz = max_sm_clock_hz()
    log(f"[sass] crush_straw2 loop, one item: {k7_pipes} instructions "
        f"(per SM and clock: {sass.SM_RATES}); {k7_item_clocks:.4f} SM "
        f"clocks a thread, bound by {k7_by}; {sms} SMs at "
        f"{sm_hz / 1e6:.0f} MHz; top opcodes "
        f"{k7_mix.most_common(8)}")
    phase_done("build")

    coding = rs.reed_sol_van_matrix(K, M)
    plan = decode_plan(coding, K, M, LOST)
    rng = np.random.default_rng(7)

    def rand_u8(*shape):
        return torch.from_numpy(
            rng.integers(0, 256, size=shape, dtype=np.uint8)).to(dev)

    # -- 2. kernels against their plain versions ---------------------------
    big = OBJ_BIG // K                       # chunk of a 4 MiB object
    shapes = {
        # ec_bench 1 MiB sweep launch: [64, 8, 128 KiB] bytes as words
        "gf_words": rand_u8(LAUNCH_BYTES // SIZES[2], K, SIZES[2] // K),
        # recovery lane flush: 2 survivor stacks of 4 MiB objects
        "gf_expand": rand_u8(2, K, big),
        # write-lane flush: data rows of 2 stripes of 4 MiB objects
        "crc32c_batch": rand_u8(2 * K, big),
        # comp lane flushes: 64 objects of 1 MiB (fingerprint and rle)
        "gear_hash": rand_u8(FP_BLOCKS * FP_COPIES, COMP_OBJ),
        "run_starts": rand_u8(COMP_N, COMP_OBJ),
    }
    shapes["gear_hash"][0, :4096] = 0       # GEAR[0] != 0: a wrong pad shows
    shapes["run_starts"][1] = torch.repeat_interleave(
        shapes["run_starts"][1, :COMP_OBJ // 64], 64)   # runs of 64
    shapes["gf_planes"] = W.gf_expand_words(shapes["gf_expand"])
    # K4 leg: the same 1 MiB launch shape as gf_words, as bytes
    shapes["gf_bytes"] = shapes["gf_words"]
    # plugin sweep: a 64 MiB launch of 1 MiB liberation k=6 stripes
    lib_ec = create_erasure_code({"plugin": "jerasure",
                                  "technique": "liberation", "k": 6,
                                  "m": 2})
    lib_chunk = lib_ec.get_chunk_size(SIZES[2])
    lib_bits = lib_ec.coding_matrix
    shapes["gf2_packets"] = rand_u8(LAUNCH_BYTES // SIZES[2],
                                    lib_ec.k * lib_ec.w,
                                    lib_chunk // lib_ec.w)
    # K7 at the host level of BASELINE row 4's map: the mapper maps the
    # 1 Mi PGs in one chunk, so the first rep's host level launches 1 Mi
    # lanes over host buckets of 64 OSDs
    crush_map = build_hierarchy(1, CRUSH_HOSTS, CRUSH_PER_HOST)
    k7_mapper = BatchMapper(crush_map, 0, result_max=3, device=dev)
    if k7_mapper._chunk() < CRUSH_PGS:
        fail(f"the mapper cuts {CRUSH_PGS} PGs into chunks of "
             f"{k7_mapper._chunk()}")
    k7_tab = k7_mapper._tab
    host_rows = [row for row, b in enumerate(crush_map.buckets)
                 if b is not None and b.type == 1]
    k7_args = straw2_lanes(torch, dev, rng, host_rows, CRUSH_PGS, 1)
    k7_shape = [CRUSH_PGS, CRUSH_PER_HOST]
    seeds = torch.from_numpy(rng.integers(0, 2 ** 32, size=(2 * K,),
                                          dtype=np.uint32).view(np.int32)
                             ).to(dev)
    words_in = shapes["gf_words"].view(torch.int32)
    # K11 at the controlplane's shape: 2^20 PGs of the harness's 7 states
    fold_args = pgmap_fold_args(torch, dev, CP_PGS, 7, "mix", seed=11)
    # device tables held across calls, as the engines hold them, so a
    # timed call is the launch alone
    tables = {}
    runs = {
        "gf_words": (lambda: W.gf_matmul_words(coding, words_in, tables),
                     lambda: W.gf_matmul_words_plain(coding, words_in)),
        "gf_expand": (lambda: W.gf_expand_words(shapes["gf_expand"]),
                      lambda: W.gf_expand_words_plain(shapes["gf_expand"])),
        "gf_planes": (lambda: W.gf_matmul_planes(plan.matrix,
                                                 shapes["gf_planes"],
                                                 tables),
                      lambda: W.gf_matmul_planes_plain(plan.matrix,
                                                       shapes["gf_planes"])),
        "crc32c_batch": (lambda: C.crc32c_rows(shapes["crc32c_batch"], seeds),
                         lambda: C.crc32c_rows_plain(shapes["crc32c_batch"],
                                                     seeds)),
        "gf_bytes": (lambda: GB.gf_matmul_tables(coding, shapes["gf_bytes"],
                                                 tables),
                     lambda: GB.gf_matmul_gather(coding, shapes["gf_bytes"])),
        "gf2_packets": (lambda: BM.gf2_packets(lib_bits,
                                               shapes["gf2_packets"], tables),
                        lambda: BM.gf2_packets_plain(lib_bits,
                                                     shapes["gf2_packets"])),
        "crush_straw2": (lambda: K7.straw2_choose(k7_tab, *k7_args),
                         lambda: K7.straw2_plain(k7_tab, *k7_args)),
        "gear_hash": (lambda: CH.gear_hashes(shapes["gear_hash"]),
                      lambda: CH.gear_hashes_plain(shapes["gear_hash"])),
        "run_starts": (lambda: CO.run_starts(shapes["run_starts"]),
                       lambda: CO.run_starts_plain(shapes["run_starts"])),
        "pgmap_fold": (lambda: PG.summary_fold(*fold_args),
                       lambda: PG._summary_fold_plain(*fold_args)),
    }
    errs = {}
    for name, (kern, plain) in runs.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if isinstance(got, tuple):              # K11: histogram and sums
            got, want = torch.cat(got), torch.cat(want)
        errs[name] = max_abs_err(torch, got, want)
        log(f"[check] {name} {tuple(got.shape)} max_abs_err {errs[name]}")
        if errs[name]:
            fail(f"{name} disagrees with its plain version")
    phase_done("kernel checks, main shapes")
    # edge shapes: odd lengths (pad paths), the square decode matrix
    dm = rs.decode_matrix(coding, K, list(ERASED))
    for n in (4, 100, 1000, 4096 + 36):
        x = rand_u8(3, K, n)
        for mat in (coding, dm, plan.matrix):
            if not torch.equal(W.gf_matmul_bytes(mat, x),
                               W.gf_matmul_bytes_plain(mat, x)):
                fail(f"gf_words byte API disagrees at n={n}")
        rows = rand_u8(5, n)
        s = torch.from_numpy(rng.integers(0, 2 ** 32, size=(5,),
                                          dtype=np.uint32).view(np.int32)
                             ).to(dev)
        if not torch.equal(C.crc32c_rows(rows, s),
                           C.crc32c_rows_plain(rows, s)):
            fail(f"crc32c_batch disagrees at L={n}")
    # crc32c_batch: lengths around the 16-byte granule, 1 to 1024 rows,
    # a view that is not 16-byte aligned, the two-row-set entry
    for nrows, n in ((1, 1), (7, 15), (1024, 16), (3, 17), (1024, 33),
                     (2, 4097), (1, 65536 + 3)):
        rows = rand_u8(nrows, n + 1)[:, 1:]
        if not torch.equal(C.crc32c_rows(rows),
                           C.crc32c_rows_plain(rows.contiguous())):
            fail(f"crc32c_batch disagrees at [{nrows}, {n}]")
        if not torch.equal(C.crc32c_row_sets(rows, rows[:1]),
                           C.crc32c_rows_plain(torch.cat([rows, rows[:1]]))):
            fail(f"crc32c_batch two row sets disagree at [{nrows}, {n}]")
    log("[check] crc32c_batch edge shapes (L 1/15/16/17/33/4097/65539, "
        "rows 1-1024, unaligned views, two row sets) equal the plain "
        "version")
    x = rand_u8(3, K, 2048)
    rp = W.ResidentPlanes(x)
    if not torch.equal(rp.multiply(dm), W.gf_matmul_bytes_plain(dm, x)):
        fail("ResidentPlanes disagrees with the plain GF matmul")
    # gf_words tilings: rows beyond the register tile of 8 (the square
    # decode matrix, the 9-row recovery plan, 17 rows), word counts off
    # the 4-word segment (masked tail), batch 1
    for mat in (dm, plan.matrix, rs.reed_sol_van_matrix(K, 17)):
        for bsz, nw in ((1, 1), (1, 4099), (3, 127), (1, 32768)):
            x = rand_u8(bsz, mat.shape[1], 4 * nw).view(torch.int32)
            if not torch.equal(W.gf_matmul_words(mat, x),
                               W.gf_matmul_words_plain(mat, x)):
                fail(f"gf_words disagrees at rows={mat.shape[0]} "
                     f"batch={bsz} nw={nw}")
    # gf_planes tilings: 1, 3, 9 rows (n8 tiles held in registers), word
    # counts 1, 127, 389 (bytewise plane loads), batch 1
    for rows_e in (1, 3, 9):
        mat = plan.matrix[:rows_e]
        for bsz, nw in ((1, 1), (2, 127), (1, 389), (1, 4096)):
            pl = W.gf_expand_words(rand_u8(bsz, K, 4 * nw))
            if not torch.equal(W.gf_matmul_planes(mat, pl),
                               W.gf_matmul_planes_plain(mat, pl)):
                fail(f"gf_planes disagrees at rows={rows_e} batch={bsz} "
                     f"nw={nw}")
    log("[check] gf_words edge shapes (rows 8/9/17, nw 1/127/4099/32768, "
        "batch 1 and 3) and gf_planes edge shapes (rows 1/3/9, nw "
        "1/127/389/4096, batch 1 and 2) equal their plain versions")
    # K10: the decode inverse (R = k*w rows, two row tiles) and packets
    # that are not a multiple of 4 or 16 bytes
    lib_inv, _ = lib_ec.engine._inverse_for(PLUGIN_ERASED)
    for pw in (1, 7, 100, 1001):
        x = rand_u8(3, lib_ec.k * lib_ec.w, pw)
        for mat in (lib_bits, lib_inv):
            if not torch.equal(BM.gf2_packets(mat, x),
                               BM.gf2_packets_plain(mat, x)):
                fail(f"gf2_packets disagrees at pw={pw}")
    # K7: buckets of 1, 3 and 65 items, an all-zero bucket, 3 weight
    # sets, lane counts off the 256-thread block
    for sizes, positions, lanes in (([1, 3, 65], 1, 1000),
                                    ([3, 65, 1, 64], 3, 4099),
                                    ([65, 5], 2, 257),
                                    ([64] * 8, 1, 131072)):
        tab, erng = straw2_edge_tables(K7, dev, sizes, positions, lanes,
                                       zero_rows=(1,))
        args = straw2_lanes(torch, dev, erng, range(len(sizes)), lanes,
                            positions)
        err = max_abs_err(torch, K7.straw2_choose(tab, *args),
                          K7.straw2_plain(tab, *args))
        if err:
            fail(f"crush_straw2 disagrees at sizes {sizes} P={positions} "
                 f"lanes={lanes}")
    log("[check] crush_straw2 edge shapes (buckets of 1/3/65 items, an "
        "all-zero bucket, 1-3 weight sets, 257/1000/4099 lanes, [131072, "
        "64]) equal the plain version")
    phase_done("kernel checks, edge shapes")
    # K8 and K9 at edge lengths (the byte path off multiples of 16, a
    # warp's chunks across 480 bytes), rows of zeros first, unaligned
    for nrows in EDGE_ROWS:
        for n in EDGE_LENGTHS:
            x = rand_u8(nrows * n + 1)
            x[:40] = 0
            for view in (x[:-1].view(nrows, n), x[1:].view(nrows, n)):
                for name, kern, plain in (
                        ("gear_hash", CH.gear_hashes, CH.gear_hashes_plain),
                        ("run_starts", CO.run_starts, CO.run_starts_plain)):
                    err = max_abs_err(torch, kern(view),
                                      plain(view.contiguous()))
                    if err:
                        fail(f"{name} disagrees at [{nrows}, {n}]")
    log(f"[check] gear_hash and run_starts edge shapes (L "
        f"{'/'.join(map(str, EDGE_LENGTHS))}, rows "
        f"{'/'.join(map(str, EDGE_ROWS))}, leading zero bytes, unaligned "
        f"views) max_abs_err 0")
    # the write lane's other crc32c_batch launches (parity rows of a 4 MiB
    # flush; GFEncodeDigest's one launch over data and parity rows; data
    # rows of a 64 KiB-object flush) and the liberation (0, 1) decode
    par_rows = rand_u8(2 * M, big)
    small_rows = rand_u8(N_OBJ * K, OBJ_SMALL // K)
    fp_rows = rand_u8(FP_CHUNK_ROWS, FP_CHUNK_LEN)
    seeds22 = torch.cat([seeds, seeds[:2 * M]])
    extra = {
        "crc32c_batch parity": (
            par_rows, lambda x: C.crc32c_rows(x),
            lambda x: C.crc32c_rows_plain(x)),
        "crc32c_batch fused": (
            par_rows,
            lambda x: C.crc32c_row_sets(shapes["crc32c_batch"], x, seeds22),
            lambda x: torch.cat([
                C.crc32c_rows_plain(shapes["crc32c_batch"], seeds),
                C.crc32c_rows_plain(x, seeds22[2 * K:])])),
        "crc32c_batch 64KiB": (
            small_rows, lambda x: C.crc32c_rows(x),
            lambda x: C.crc32c_rows_plain(x)),
        "gf2_packets decode": (
            shapes["gf2_packets"],
            lambda x: BM.gf2_packets(lib_inv, x, tables),
            lambda x: BM.gf2_packets_plain(lib_inv, x)),
        # the fingerprint lane's launch: every chunk of a 64 MiB flush,
        # zero-padded at the back (the plain version in blocks of rows)
        "crc32c_batch fingerprint": (
            fp_rows, lambda x: C.crc32c_rows(x),
            lambda x: torch.cat([C.crc32c_rows_plain(x[i:i + 1024])
                                 for i in range(0, x.shape[0], 1024)])),
    }
    for label, (x, kern, plain) in extra.items():
        got, want = kern(x), plain(x)
        torch.cuda.synchronize()
        err = max_abs_err(torch, got, want)
        rows_in = (list(shapes["crc32c_batch"].shape) + ["+"] + list(x.shape)
                   if label.endswith("fused") else list(x.shape))
        log(f"[check] {label} {rows_in} -> {list(got.shape)} "
            f"max_abs_err {err}")
        if err:
            fail(f"{label} disagrees with its plain version")
    torch.cuda.synchronize()
    # K11: row counts around a warp, a block and the grid stride,
    # hist_len 2 and above the shared-memory cap (global atomics), NaN,
    # exactly-the-grace and negative ages, all stale and all fresh
    fold_cases = [(n, 7, "mix") for n in FOLD_EDGE_ROWS] + [
        (65537, 1, "mix"), (65537, PG.FOLD_SHARED_CAP // 2 + 1, "mix"),
        (CP_PGS, PG.FOLD_SHARED_CAP // 2 + 1, "mix"),
        (CP_PGS, 7, "stale"), (CP_PGS, 7, "fresh")]
    for n, n_states, ages in fold_cases:
        args = pgmap_fold_args(torch, dev, n, n_states, ages, seed=n)
        got = torch.cat(PG.summary_fold(*args))
        want = torch.cat(PG._summary_fold_plain(*args))
        torch.cuda.synchronize()
        if max_abs_err(torch, got, want):
            fail(f"pgmap_fold disagrees at n={n} hist_len={2 * n_states} "
                 f"ages={ages}")
    log(f"[check] pgmap_fold edge shapes (n "
        f"{'/'.join(map(str, FOLD_EDGE_ROWS))} and {CP_PGS}, hist_len 2, "
        f"14 and {PG.FOLD_SHARED_CAP + 2} > the shared cap, NaN / "
        f"exactly-the-grace / negative ages, all stale, all fresh) "
        f"max_abs_err 0")
    phase_done("kernel checks, other launch shapes")

    # -- 3. the main path, counted ------------------------------------------
    build.reset_counts()
    phase_counts = {}
    mark = build.counts()

    def close_phase(name):
        nonlocal mark
        now = build.counts()
        phase_counts[name] = {k: now[k] - mark[k] for k in now}
        mark = now
        phase_done(name)

    sweep = {}
    common = ["--plugin", "torch_cuda", "--parameter", f"k={K}",
              "--parameter", f"m={M}", "--parameter",
              "technique=reed_sol_van", "--iterations", "10", "--verify"]
    for size in SIZES:
        batch = str(LAUNCH_BYTES // size)
        enc = ec_bench.run(common + ["--workload", "encode", "--size",
                                     str(size), "--batch", batch])
        dec = ec_bench.run(common + ["--workload", "decode", "--size",
                                     str(size), "--batch", batch,
                                     "--erased", str(ERASED[0]),
                                     "--erased", str(ERASED[1])])
        sweep[size] = (enc["GBps"], dec["GBps"])
        log(f"[ec_bench] stripe {size} batch {batch}: encode "
            f"{enc['GBps']} GB/s, decode {dec['GBps']} GB/s "
            f"(host clock, synchronised per launch)")
    close_phase("ec_bench")

    # K4 leg: GFLinear's "bytes" route against its "words" route
    k4_in = rand_u8(LAUNCH_BYTES // SIZES[2], K, SIZES[2] // K)
    k4_out = {}
    for label, mat in (("encode", coding), ("decode (0, 9)", dm)):
        by = GFLinear(mat, backend="bytes", device=dev)
        wo = GFLinear(mat, backend="words", device=dev)
        got = by(k4_in)
        err = max_abs_err(torch, got, GB.gf_matmul_gather(mat, k4_in))
        if err:
            fail(f"K4 leg {label}: bytes route differs from the plain "
                 f"gf_matmul_gather")
        if not torch.equal(got, wo(k4_in)):
            fail(f"K4 leg {label}: bytes route differs from words route")
        k4_out[label] = got
        log(f"[k4] {label} {list(k4_in.shape)} -> {list(got.shape)}: "
            f"bytes route equals the plain gf_matmul_gather (max_abs_err "
            f"{err}) and the words route")
    for n in (4, 100, 1000, 4096 + 36):
        for k, m in ((K, M), (20, 4)):
            mat = rs.reed_sol_van_matrix(k, m)
            x = rand_u8(3, k, n)
            if not torch.equal(GFLinear(mat, backend="bytes", device=dev)(x),
                               GB.gf_matmul_gather(mat, x)):
                fail(f"K4 leg: bytes route differs from the plain version "
                     f"at k={k} m={m} n={n}")
    torch.cuda.synchronize()
    log("[k4] edge shapes (n 4/100/1000/4132, k=8 m=3 and k=20 m=4) equal "
        "the plain gf_matmul_gather")
    close_phase("k4_leg")

    plugin_runs = {}
    for label, args, stripes in PLUGINS:
        t0 = time.perf_counter()
        size_args = ["--size", str(SIZES[2]), "--batch", str(stripes),
                     "--iterations", "3", "--verify"]
        enc = ec_bench.run(args + size_args + ["--workload", "encode"])
        dec = ec_bench.run(args + size_args + [
            "--workload", "decode", "--erased", str(PLUGIN_ERASED[0]),
            "--erased", str(PLUGIN_ERASED[1])])
        plugin_runs[label] = (enc["GBps"], dec["GBps"])
        log(f"[plugins] {label}: {stripes} x 1 MiB stripes, parity and "
            f"decode verified; encode {enc['GBps']} GB/s, decode "
            f"{dec['GBps']} GB/s, {time.perf_counter() - t0:.1f} s wall "
            f"(host clock)")
    close_phase("plugin_sweep")

    ec = create_erasure_code({"plugin": "torch_cuda", "k": K, "m": M,
                              "technique": "reed_sol_van"})
    timers = []

    def schedule(delay, fn):
        t = threading.Timer(delay, fn)
        t.daemon = True
        timers.append(t)
        t.start()
        return t

    # one device profiler a lane: the host's dispatch against its wait at
    # each flight's CUDA event, and the idle gaps between launches
    profs = {lane: DeviceProfiler(name=lane, enabled=True)
             for lane in ("write", "recon", "comp", "fingerprint", "crush")}
    walls, totals = {}, {}          # each lane's measured section

    def engine(name, lane):
        # OSD option defaults (osd_batch_max_bytes 8 MiB, max_ops 64)
        # with a 5 ms window: the flight pipeline and completion worker
        return BatchEngine(name, max_bytes=8 << 20, max_ops=64,
                           flush_ms=5.0, schedule=schedule,
                           profiler=profs[lane])

    wdata = rng.integers(0, 256, size=(N_OBJ, OBJ_BIG), dtype=np.uint8)
    sdata = rng.integers(0, 256, size=(N_OBJ, OBJ_SMALL), dtype=np.uint8)
    weng = engine("write", "write")
    written = {}
    walls["write"] = 0.0
    for label, objs in (("4MiB", wdata), ("64KiB", sdata)):
        t0 = time.perf_counter()
        comps = [weng.submit_encode(ec, o) for o in objs]
        written[label] = [c.result(timeout=600) for c in comps]
        dt = time.perf_counter() - t0
        walls["write"] += dt
        log(f"[write] {N_OBJ} x {label}: {dt * 1e3:.1f} ms "
            f"({objs.nbytes / dt / 1e9:.3f} GB/s of client data, host "
            f"clock), stats {dict(weng.stats)}")
    weng.stop()
    totals["write"] = profs["write"].aggregate()["totals"]
    # the two host candidates of the write lane, for one 8 MiB flush of
    # two 4 MiB objects: the numpy packing (_batch) and the pageable
    # host-to-device copy (_stage_in)
    flush_ops = [_Op("encode", None, None, OBJ_BIG // K, OBJ_BIG,
                     chunks=ec.encode_prepare(o)) for o in wdata[:2]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        packed = weng._batch(flush_ops, 2, K, OBJ_BIG // K)
    t1 = time.perf_counter()
    for _ in range(10):
        weng._stage_in(packed)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    stage_ms = ((t1 - t0) * 100, (t2 - t1) * 100)
    close_phase("write_lane")

    reng = engine("recovery", "recon")
    t0 = time.perf_counter()
    comps = []
    for shards, _h in written["4MiB"]:
        avail = {i: np.frombuffer(shards[i], dtype=np.uint8)
                 for i in range(K + M) if i not in LOST}
        comps.append(reng.submit_reconstruct(ec, avail, want=set(LOST)))
    rebuilt = [c.result(timeout=600) for c in comps]
    dt = time.perf_counter() - t0
    walls["recon"] = dt
    totals["recon"] = profs["recon"].aggregate()["totals"]
    log(f"[recovery] {N_OBJ} x 4MiB, lost {LOST}: {dt * 1e3:.1f} ms, "
        f"stats {dict(reng.stats)}")
    chunks = [ec.encode_prepare(o) for o in wdata[:8]]
    rechecks = [reng.submit_recheck(ec, c) for c in chunks]
    rechecked = [c.result(timeout=600) for c in rechecks]
    close_phase("recovery_lane")

    # deep scrub over what the write lane stored
    scrub = S.ScrubEngine(device=dev)
    big_objs = rng.integers(0, 256, size=(N_SCRUB_BIG, SCRUB_BIG),
                            dtype=np.uint8)
    payloads = {(o, i): shards[i]
                for o, (shards, _h) in enumerate(written["4MiB"])
                for i in range(K + M)}
    payloads.update({("big", o): big_objs[o] for o in range(N_SCRUB_BIG)})
    t0 = time.perf_counter()
    digests = scrub.compute_digests(payloads)
    log(f"[scrub] digests of {N_OBJ} x {K + M} shards + {N_SCRUB_BIG} x "
        f"16 MiB objects ({scrub.segmented_objects} segmented): "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms, "
        f"{scrub.device_digest_bytes} of {scrub.digest_bytes} bytes on "
        f"the card")
    stripes = {o: dict(shards) for o, (shards, _h)
               in enumerate(written["4MiB"])}

    def corrupt(obj, shard):
        buf = bytearray(stripes[obj][shard])
        buf[12345] ^= 0x5A
        stripes[obj][shard] = bytes(buf)

    corrupt(*CORRUPT_ONE)
    for shard in CORRUPT_PAIR[1]:
        corrupt(CORRUPT_PAIR[0], shard)
    t0 = time.perf_counter()
    recheck_lane = scrub.recheck_parity(ec, stripes, batch=reng)
    t1 = time.perf_counter()
    recheck_alone = scrub.recheck_parity(ec, stripes)
    t2 = time.perf_counter()
    culprit = S.isolate_culprit(ec, stripes[CORRUPT_ONE[0]])
    culprits = S.isolate_culprits(ec, stripes[CORRUPT_PAIR[0]])
    t3 = time.perf_counter()
    log(f"[scrub] recheck of {N_OBJ} stripes: {(t1 - t0) * 1e3:.1f} ms "
        f"through the recovery engine's flush_sync, "
        f"{(t2 - t1) * 1e3:.1f} ms standalone; culprit isolation "
        f"{(t3 - t2) * 1e3:.1f} ms (host clock)")
    reng.stop()
    for t in timers:
        t.join(timeout=10)
    close_phase("deep_scrub")

    comp = comp_phase(dev, COMP_N, COMP_OBJ, COMP_N_BIG, COMP_BIG,
                      profs["comp"])
    walls["comp"], totals["comp"] = comp["wall_s"], comp["profile"]
    log(f"[comp] rle, {COMP_N} x {COMP_OBJ >> 20} MiB (7 of 8 runs of "
        f"16-127 B, 1 of 8 random): {comp['GBps']:.3f} GB/s (host clock, "
        f"{comp['wall_s'] * 1e3:.1f} ms), ratio {comp['ratio']:.3f}, "
        f"{comp['passthrough']} pass-throughs, {comp['launches']} lane "
        f"launch(es); {COMP_N_BIG} x {COMP_BIG >> 20} MiB segmented "
        f"({comp['segments']} segments in {comp['segmented']} sealed "
        f"objects); zlib pass on the host; every blob expands to its "
        f"payload and equals a disabled engine's")
    close_phase("comp")
    if phase_counts["comp"]["run_starts"] <= 0:
        fail("comp: run_starts was not launched")
    log(f"[comp] run_starts launches {phase_counts['comp']['run_starts']} "
        f"(one warm-up, one [{COMP_N}, {COMP_OBJ}] flush, one flush of "
        f"the segments)")

    fpr = fingerprint_phase(dev, FP_BLOCKS, FP_COPIES, COMP_OBJ, FP_AVG,
                            FP_SAMPLE, profs["fingerprint"])
    walls["fingerprint"], totals["fingerprint"] = fpr["wall_s"], \
        fpr["profile"]
    close_phase("fingerprint")
    fp_counts = phase_counts["fingerprint"]
    if fp_counts["gear_hash"] != 1 or fp_counts["crc32c_batch"] != 1:
        fail(f"fingerprint: want one gear_hash and one crc32c_batch launch, "
             f"got {fp_counts['gear_hash']} and {fp_counts['crc32c_batch']}")
    log(f"[fingerprint] {FP_BLOCKS} blocks x {FP_COPIES} copies of "
        f"{COMP_OBJ >> 20} MiB, chunker avg {FP_AVG}: {fpr['MBps']:.1f} MB/s "
        f"(host clock, {fpr['wall_s'] * 1e3:.1f} ms), {fpr['chunks']} "
        f"chunks ({fpr['unique']} unique), dedup ratio "
        f"{fpr['dedup_ratio']:.2f}, gear_hash launches "
        f"{fp_counts['gear_hash']}, crc32c_batch launches "
        f"{fp_counts['crc32c_batch']}; spans equal the host chunker on all "
        f"{FP_BLOCKS * FP_COPIES}, {FP_SAMPLE} sampled fingerprints equal "
        f"the host's")

    walls["crush"], crush_k7 = crush_phase(
        dev, rng, build, CRUSH_HOSTS, CRUSH_PER_HOST, CRUSH_PGS,
        CRUSH_SAMPLE, profs["crush"])
    totals["crush"] = profs["crush"].aggregate()["totals"]
    close_phase("crush")

    ct = crushtool_phase(dev, CT_OSDS, CT_PGS, CT_MAPPINGS)
    close_phase("crushtool")
    log(f"[crushtool] --build --num-osds {CT_OSDS} host straw2 64 root "
        f"straw2 0; --test --num-rep 3 --max-x {CT_PGS - 1} "
        f"--show-statistics on engine batched ({dev.type}) in "
        f"{ct['seconds']:.3f} s ({CT_PGS / ct['seconds']:,.0f} x/s with "
        f"its report, host clock, "
        f"{phase_counts['crushtool']['crush_straw2']} crush_straw2 "
        f"launches): {' | '.join(ct['stats'])}; --max-x {CT_MAPPINGS - 1} "
        f"--show-mappings equals --scalar line for line ({ct['workers']} "
        f"host processes)")

    store = store_phase(dev, STORE_N, STORE_OBJ)
    close_phase("store")
    log(f"[store] {STORE_N} x {STORE_OBJ >> 20} MiB, k={K} m={M}, through "
        f"the engine built from the option defaults (flush_ms "
        f"{STORE_FLUSH_MS}) into a WALStore in sync_mode batch on "
        f"{store['fs']}: {store['acked']} objects acknowledged, "
        f"{store['shard_MiB']:.1f} MiB of shards in {store['records']} "
        f"records ({store['wal_MiB']:.1f} MiB of WAL) with "
        f"{store['syncs']} group fsyncs for {store['flushes']} flushes "
        f"({store['kicks']} kicks); {store['wall_ms']:.1f} ms wall, of "
        f"which {store['append_ms']:.1f} ms queueing transactions (hex "
        f"and JSON framing ~{store['frame_ms']:.1f} ms, record CRC "
        f"~{store['crc_ms']:.1f} ms, from samples) and, on the commit "
        f"thread, {store['fsync_ms']:.1f} ms in fsync (host clock); the last "
        f"flush's mid_record power cut left a torn tail "
        f"({store['torn_tail']['lost_bytes']} bytes) that the remount "
        f"truncated; replay {store['replay_ms']:.1f} ms; every "
        f"acknowledged shard re-digested by crc32c_batch equals its "
        f"hinfo; fsck, list-pgs and kvstore_tool clean "
        f"({store['tools_ms']:.1f} ms); host CRC {store['crc_path']} at "
        f"{store['crc_MiBps']:.1f} MiB/s; "
        f"{phase_counts['store']['gf_words']} gf_words and "
        f"{phase_counts['store']['crc32c_batch']} crc32c_batch launches")
    walls["store"], totals["store"] = store["wall_ms"] / 1e3, \
        store.pop("totals")
    log(json.dumps({"store": store}))

    bal = balancer_phase(dev, CRUSH_HOSTS, CRUSH_PER_HOST, BAL_PGS,
                         BAL_MOVES)
    close_phase("balancer")
    log(f"[balancer] UpmapBalancer on {CRUSH_HOSTS} hosts x "
        f"{CRUSH_PER_HOST} OSDs, a size-3 replicated pool of {BAL_PGS} PGs "
        f"(chooseleaf_firstn host), every OSD up, mapped on {dev.type}: "
        f"one mapping {bal['map_ms']:.1f} ms with {bal['map_launches']} "
        f"crush_straw2 launches (the plain mapper on the card "
        f"{bal['plain_map_ms']:.1f} ms; all {BAL_PGS} PGs equal); "
        f"stddev() {bal['stddev_ms']:.1f} ms; optimize(max_changes="
        f"{BAL_MOVES}) {bal['round_ms']:.1f} ms with "
        f"{bal['round_launches']} launches (its own mapping included; "
        f"alone, the placement matrix with its mapping "
        f"{bal['matrix_ms']:.1f} ms, the targets {bal['targets_ms']:.1f} "
        f"ms, one scan for the PGs on the fullest OSD "
        f"{bal['scan_ms']:.1f} ms); "
        f"stddev {bal['stddev_before']:.4f} -> {bal['stddev_after']:.4f}, "
        f"{bal['moves']} moves equal to the twin over the plain "
        f"placements, every PG on distinct hosts; "
        f"{phase_counts['balancer']['crush_straw2']} crush_straw2 launches "
        f"in the phase (host clock); osdmaptool --upmap --upmap-max "
        f"{BAL_MOVES} --device cuda as a process: {bal['tool_s']:.2f} s "
        f"wall (three mappings, the process start and its imports), its "
        f"file equal to the proposals ({bal['tool_stdout']})")

    crushmap = mon_crushmap(CRUSH_HOSTS, CRUSH_PER_HOST)
    mon_runs = [mon_phase(crushmap, mode, bal["proposals"]
                          if mode == "crc" else None)
                for mode in ("crc", "secure")]
    close_phase("mon")
    for run in mon_runs:
        ms = sorted(run["commit_ms"])
        aead = run["aead"] if run["mode"] == "secure" else "no"
        log(f"[mon] {run['mode']} ({aead} AEAD): 3 mons on 127.0.0.1, "
            f"WALs on {run['fs']}; quorum "
            f"{run['quorum']} elected in {run['election_ms']:.1f} ms; "
            f"{len(ms)} mutating commands (osd setcrushmap of "
            f"{crushmap['max_devices']} OSDs, erasure-code-profile k={K} "
            f"m={M}, EC pool of {MON_EC_PG_NUM} PGs, replicated pool of "
            f"{MON_PG_NUM} PGs, config-key, log) each answered after its "
            f"round committed: commit ms median {ms[len(ms) // 2]:.1f}, "
            f"max {ms[-1]:.1f} (host clock); every mon at paxos version "
            f"{run['version']}; leader killed, mon.{run['new_leader']} "
            f"elected in {run['reelection_ms']:.1f} ms and serving; the "
            f"killed mon's WAL ({run['wal_MiB']:.2f} MiB) replayed in "
            f"{run['replay_ms']:.1f} ms; restarted, it caught up to the "
            f"quorum's version {run['caught_up_to']} in "
            f"{run['catch_up_ms']:.1f} ms")
    cl = mon_runs[0]["clients"]
    log(f"[clients] against the crc quorum (host clock): monmaptool "
        f"--create {cl['monmaptool_ms']:.1f} ms; osd.{BOOT_OSD}'s boot "
        f"message committed in {cl['boot_ms']:.1f} ms; ceph -m "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in cl["ceph_ms"].items())
        + f"; {BAL_MOVES} ceph osd pg-upmap-items of the balancer's "
        f"proposals on pool rbd (id {cl['pool_id']}) {cl['upmap_ms']:.1f} "
        f"ms; Rados.connect {cl['connect_ms']:.1f} ms, its Objecter at "
        f"epoch {cl['epoch']} with exactly those upmaps after "
        f"{cl['objecter_ms']:.1f} ms; list_pools and pool_lookup agree; "
        f"rados lspools {cl['rados_ms']:.1f} ms")
    cp = controlplane_phase(dev, CP_OSDS, CP_PGS, CP_SAMPLE)
    close_phase("controlplane")

    log(f"[cluster] MiniCluster({CLUSTER_MONS} mons, {CLUSTER_OSDS} OSDs, "
        f"device {dev}) on WALStores; EC pool k={K} m={M} jerasure "
        f"reed_sol_van, pg_num {CLUSTER_PG_NUM}, rule 1 (choose_indep over "
        f"the flat root); scale cut: {CLUSTER_N} objects of "
        f"{CLUSTER_OBJ >> 20} MiB, not a deployment's millions (the whole "
        f"cluster is one host process that moves ~3-8 MB/s)")
    cluster = cluster_phase(dev, CLUSTER_MONS, CLUSTER_OSDS, CLUSTER_N,
                       CLUSTER_OBJ, CLUSTER_PG_NUM, CLUSTER_REWRITE)
    close_phase("cluster")
    st = cluster["steps"]
    for name, kernels in (("write", ("gf_words", "crc32c_batch")),
                          ("degraded_read", ("gf_expand", "gf_planes")),
                          ("recovery", ("gf_expand", "gf_planes")),
                          ("scrub", ("crc32c_batch",))):
        for k in kernels:
            if st[name]["launches"].get(k, 0) <= 0:
                fail(f"cluster: {k} was not launched in the {name} step")
    mb = CLUSTER_N * CLUSTER_OBJ / 1e6
    eng, bad = cluster["engine"], cluster["bad"]
    scrub_ms = cluster["scrub_ms"]
    log(f"[cluster] write {mb / st['write']['s']:.1f} MB/s, read "
        f"{mb / st['read']['s']:.1f} MB/s ({CLUSTER_N} x "
        f"{CLUSTER_OBJ >> 20} MiB through aio_write_full / aio_read); "
        f"osd.{CLUSTER_KILL} killed and marked down in "
        f"{st['kill']['s'] * 1e3:.1f} ms; {CLUSTER_REWRITE} objects "
        f"rewritten degraded in {st['degraded_write']['s'] * 1e3:.1f} ms; "
        f"degraded read of all {CLUSTER_N} "
        f"{st['degraded_read']['s'] * 1e3:.1f} ms; revive to clean, its {CLUSTER_REWRITE} shards rebuilt, "
        f"{st['recovery']['s'] * 1e3:.1f} ms; every read and all "
        f"{CLUSTER_N * CLUSTER_OSDS} shards and hinfos equal the CPU "
        f"re-encode; recon route planes (gf_expand + gf_planes); deep scrub "
        f"of {len(scrub_ms)} PGs {sum(scrub_ms) / len(scrub_ms):.1f} ms a PG "
        f"(max {max(scrub_ms):.1f}), no inconsistency, each to a verdict "
        f"({len(cluster['reinterval'])} restarted after a new interval "
        f"{cluster['reinterval']}); the flipped parity "
        f"byte of {bad[0]} on osd.{bad[1]} shard {bad[2]} found, "
        f"attributed and repaired in {cluster['repair_ms']:.1f} ms; "
        f"engines summed over {cluster['daemons']} daemons: "
        f"{eng['flushes']} write flushes, {eng['launches']} launches, "
        f"{eng['ops_completed'] / max(eng['launches'], 1):.2f} ops a "
        f"launch; {eng['recon_flushes']} recon flushes, "
        f"{eng['recon_launches']} launches, "
        f"{eng['recon_ops_completed'] / max(eng['recon_launches'], 1):.2f} "
        f"ops a launch; {eng['store_kicks']} store kicks; WALs on "
        f"{cluster['fs']} (host clock) on {card}")

    log(f"[rgw] MiniCluster({CLUSTER_MONS} mons, {CLUSTER_OSDS} OSDs, "
        f"device {dev}) on WALStores, the option defaults but the "
        f"heartbeat grace; RGWService(require_auth=True) at its option "
        f"defaults (pool_size 16, max_concurrent 64, stripe_size 4 MiB) on "
        f"an EC data pool k={K} m={M} jerasure reed_sol_van, pg_num "
        f"{CLUSTER_PG_NUM}, rule 1, and the replicated meta pool; scale "
        f"cut: {RGW_N} PUTs of {RGW_OBJ >> 20} MiB and one multipart upload "
        f"of {RGW_PARTS} x {RGW_PART >> 20} MiB, not a deployment's "
        f"millions of objects")
    rgw = rgw_phase(dev, CLUSTER_MONS, CLUSTER_OSDS, RGW_N, RGW_OBJ,
                    RGW_PART, RGW_PARTS, CLUSTER_PG_NUM)
    close_phase("rgw")
    gst = rgw["steps"]
    for name, kernels in (("put", ("gf_words", "crc32c_batch")),
                          ("multipart_put", ("gf_words", "crc32c_batch")),
                          ("degraded_get", ("gf_expand", "gf_planes"))):
        for k in kernels:
            if gst[name]["launches"].get(k, 0) <= 0:
                fail(f"rgw: {k} was not launched in the {name} step")
    mb, mp_mb = RGW_N * RGW_OBJ / 1e6, RGW_PARTS * RGW_PART / 1e6
    eng = rgw["engine"]
    deg = gst["degraded_get"]
    log(f"[rgw] PUT {mb / gst['put']['s']:.2f} MB/s, GET "
        f"{mb / gst['get']['s']:.2f} MB/s ({RGW_N} x {RGW_OBJ >> 20} MiB, "
        f"{RGW_INFLIGHT} in flight); multipart "
        f"upload "
        f"{mp_mb / gst['multipart_put']['s']:.2f} MB/s ({RGW_PARTS} parts of "
        f"{RGW_PART >> 20} MiB in {rgw['stripes']} stripes), its GET "
        f"{mp_mb / gst['multipart_get']['s']:.2f} MB/s; degraded GET "
        f"{deg['s'] * 1e3 / len(deg['ms']):.1f} ms an object of the wall "
        f"({len(deg['ms'])} objects, {RGW_INFLIGHT} in flight, "
        f"latency median {float(np.median(deg['ms'])):.1f} ms, max "
        f"{max(deg['ms']):.1f} ms); revive to clean "
        f"{gst['recovery']['s']:.3f} s; every PUT ETag equals md5, every "
        f"GET and degraded GET and all {rgw['objects'] * (K + M)} shards "
        f"and hinfos of the {rgw['objects']} data objects equal what was "
        f"written and its CPU re-encode; engines summed over "
        f"{rgw['daemons']} daemons: {eng['flushes']} write flushes, "
        f"{eng['launches']} launches, "
        f"{eng['ops_completed'] / max(eng['launches'], 1):.2f} ops a "
        f"launch; {eng['recon_launches']} recon launches, "
        f"{eng['recon_ops_completed'] / max(eng['recon_launches'], 1):.2f} "
        f"ops a launch (host clock) on {card}")

    # the block images: every count set to 0 just before the phase
    build.reset_counts()
    mark = build.counts()
    log(f"[rbd] MiniCluster({CLUSTER_MONS} mons, {CLUSTER_OSDS} OSDs, "
        f"device {dev}) on WALStores, the option defaults but the "
        f"heartbeat grace; EC pool rbd k={K} m={M} jerasure reed_sol_van, "
        f"pg_num {CLUSTER_PG_NUM}, rule 1; images of {RBD_SIZE >> 20} MiB "
        f"at order {RBD_ORDER}, {RBD_WRITES} partial writes of "
        f"{RBD_WRITE >> 10} KiB; site B MiniCluster(1 mon, {CLUSTER_OSDS} "
        f"OSDs) for rbd-mirror, images of {MIRROR_SIZE >> 20} MiB with "
        f"{MIRROR_WRITES} journaled writes of {MIRROR_WRITE >> 10} KiB, the "
        f"daemon's pass {MIRROR_INTERVAL} s; scale cut: MiB images, not a "
        f"deployment's GiB volumes")
    rbd = rbd_phase(dev, CLUSTER_MONS, CLUSTER_OSDS, CLUSTER_PG_NUM,
                    RBD_SIZE, RBD_ORDER, RBD_WRITES, RBD_WRITE, MIRROR_SIZE,
                    MIRROR_WRITES, MIRROR_WRITE)
    close_phase("rbd")
    rst = rbd["steps"]
    for name, kernels in (("import", ("gf_words", "crc32c_batch")),
                          ("bench_write", ("gf_words", "crc32c_batch")),
                          ("partial_writes", ("gf_words", "crc32c_batch")),
                          ("degraded_read", ("gf_expand", "gf_planes"))):
        for k in kernels:
            if rst[name]["launches"].get(k, 0) <= 0:
                fail(f"rbd: {k} was not launched in the {name} step")

    def mbps(name):
        return rst[name]["bytes"] / rst[name]["s"] / 1e6

    eng, pw = rbd["engine"], rst["partial_writes"]["ms"]
    log(f"[rbd] import {mbps('import'):.2f} MB/s, export "
        f"{mbps('export'):.2f} MB/s; bench write "
        f"{rbd['bench']['write']['ops_per_sec']} ops/s "
        f"{rbd['bench']['write']['mb_per_sec']} MB/s, read "
        f"{rbd['bench']['read']['ops_per_sec']} ops/s "
        f"{rbd['bench']['read']['mb_per_sec']} MB/s (the tool's own "
        f"figures, {RBD_ORDER}-bit I/Os); partial writes of "
        f"{RBD_WRITE >> 10} KiB median {float(np.median(pw)):.1f} ms, max "
        f"{max(pw):.1f} ms; degraded read {mbps('degraded_read'):.2f} "
        f"MB/s (img0 and child whole, osd.{RBD_KILL} down); revive to "
        f"clean {rst['recovery']['s']:.3f} s; mirror lag from the last "
        f"journaled event on A to B equal {rbd['lag_s']:.3f} s "
        f"(positions {rbd['positions']}); every read and all "
        f"{rbd['objects'] * (K + M)} shards and hinfos of the "
        f"{rbd['objects']} rbd_data objects equal the host models and "
        f"their CPU re-encode; engines summed over {rbd['daemons']} "
        f"daemons: {eng['flushes']} write flushes, {eng['launches']} "
        f"launches, {eng['ops_completed'] / max(eng['launches'], 1):.2f} "
        f"ops a launch; {eng['recon_launches']} recon launches, "
        f"{eng['recon_ops_completed'] / max(eng['recon_launches'], 1):.2f} "
        f"ops a launch (host clock) on {card}")

    # the file system: every count set to 0 just before the phase
    build.reset_counts()
    mark = build.counts()
    log(f"[cephfs] MiniCluster({CLUSTER_MONS} mons, {CLUSTER_OSDS} OSDs, "
        f"device {dev}) on WALStores, the option defaults but the "
        f"heartbeat grace; metadata pool replicated size 3, pg_num "
        f"{FS_META_PG}; data pool EC k={K} m={M} jerasure reed_sol_van, "
        f"pg_num {CLUSTER_PG_NUM}, rule 1; MDS a and b at the daemon's "
        f"defaults; objects of {CLUSTER_OBJ >> 20} MiB; mdtest easy "
        f"{FS_DIRS} x {FS_FILES} files, {FS_WHOLE} files of one object and "
        f"one of {FS_BIG_OBJS}, {FS_WRITES} partial writes of "
        f"{FS_WRITE >> 10} KiB, {FS_ACKED} files acked before the failover; "
        f"scale cut: hundreds of files, not a deployment's millions")
    cfs = cephfs_phase(dev, CLUSTER_MONS, CLUSTER_OSDS, CLUSTER_PG_NUM,
                       FS_META_PG, CLUSTER_OBJ, FS_DIRS, FS_FILES, FS_WHOLE,
                       FS_BIG_OBJS, FS_WRITES, FS_WRITE, FS_ACKED)
    close_phase("cephfs")
    fst = cfs["steps"]
    for name, kernels in (("write_files", ("gf_words", "crc32c_batch")),
                          ("partial_writes", ("gf_words", "crc32c_batch")),
                          ("degraded_read", ("gf_expand", "gf_planes"))):
        for k in kernels:
            if fst[name]["launches"].get(k, 0) <= 0:
                fail(f"cephfs: {k} was not launched in the {name} step")

    def fs_mbps(name):
        return fst[name]["bytes"] / fst[name]["s"] / 1e6

    eng, pw = cfs["engine"], fst["partial_writes"]["ms"]
    verbs = ", ".join(f"{v} {len(st_['ms']) / st_['s']:.1f}"
                      for v, st_ in cfs["verbs"].items())
    log(f"[cephfs] mdtest easy ops/s: {verbs}; write "
        f"{fs_mbps('write_files'):.2f} MB/s, read "
        f"{fs_mbps('read_files'):.2f} MB/s ({FS_WHOLE} x "
        f"{CLUSTER_OBJ >> 20} MiB and one of {FS_BIG_OBJS * CLUSTER_OBJ >> 20}"
        f" MiB); partial writes of {FS_WRITE >> 10} KiB median "
        f"{float(np.median(pw)):.1f} ms, max {max(pw):.1f} ms; MDS failover "
        f"{cfs['failover_s']:.3f} s with {cfs['unflushed']} journal events "
        f"unflushed, every acked name and size kept, the resend answered "
        f"as first; spurious failovers {len(cfs['spurious'])} "
        f"{cfs['spurious']}; degraded read {fs_mbps('degraded_read'):.2f} "
        f"MB/s (osd.{FS_KILL} down); revive to clean "
        f"{fst['recovery']['s']:.3f} s; every read and all "
        f"{cfs['objects'] * (K + M)} shards and hinfos of the "
        f"{cfs['objects']} data objects equal the host models and their "
        f"CPU re-encode; the unlinked file's objects purged; MDS perf "
        f"{json.dumps(cfs['mds_perf'])}; engines summed over "
        f"{cfs['daemons']} daemons: {eng['flushes']} write flushes, "
        f"{eng['launches']} launches, "
        f"{eng['ops_completed'] / max(eng['launches'], 1):.2f} ops a "
        f"launch; {eng['recon_launches']} recon launches, "
        f"{eng['recon_ops_completed'] / max(eng['recon_launches'], 1):.2f} "
        f"ops a launch (host clock) on {card}")

    launches = {k: sum(p[k] for p in phase_counts.values())
                for k in build.KERNELS}
    log(f"[launches] {json.dumps(phase_counts)}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    for phase, name in (("k4_leg", "gf_bytes"),
                        ("plugin_sweep", "gf2_packets"),
                        ("crush", "crush_straw2"),
                        ("comp", "run_starts"),
                        ("fingerprint", "gear_hash"),
                        ("fingerprint", "crc32c_batch"),
                        ("crushtool", "crush_straw2"),
                        ("store", "gf_words"),
                        ("store", "crc32c_batch"),
                        ("balancer", "crush_straw2"),
                        ("controlplane", "crush_straw2"),
                        ("controlplane", "pgmap_fold"),
                        ("rgw", "gf_words"), ("rgw", "crc32c_batch"),
                        ("rgw", "gf_expand"), ("rgw", "gf_planes"),
                        ("rbd", "gf_words"), ("rbd", "crc32c_batch"),
                        ("rbd", "gf_expand"), ("rbd", "gf_planes"),
                        ("cephfs", "gf_words"), ("cephfs", "crc32c_batch"),
                        ("cephfs", "gf_expand"), ("cephfs", "gf_planes")):
        if phase_counts[phase][name] <= 0:
            fail(f"kernel {name} was not launched on its phase {phase}")

    # -- 4. the results are right -------------------------------------------
    probe = rng.integers(0, 256, size=(3, 1000), dtype=np.uint8)
    host = crc32c_rows_host(probe)
    if any(int(host[i]) != C.crc32c(probe[i]) for i in range(3)):
        fail("host CRC-32C reference disagrees with scalar crc32c")
    probe = probe[:, :768]
    if any(int(h) != C.crc32c(r)
           for h, r in zip(crc32c_long_host(probe, piece=256), probe)):
        fail("host long-row CRC-32C reference disagrees with scalar crc32c")
    host_oracle = rs.encode_oracle(coding, k4_in[0].cpu().numpy())
    if not np.array_equal(k4_out["encode"][0].cpu().numpy(), host_oracle):
        fail("K4 leg: encode differs from the numpy oracle")
    shard_crc = {}
    for label, objs in (("4MiB", wdata), ("64KiB", sdata)):
        rows, digests_w = [], []
        for obj, (shards, hinfos) in zip(objs, written[label]):
            data = ec.encode_prepare(obj)
            want = np.concatenate([data, rs.encode_oracle(coding, data)])
            for i in range(K + M):
                if shards[i] != want[i].tobytes():
                    fail(f"write lane {label}: shard {i} differs from "
                         f"the numpy oracle encode")
                rows.append(np.frombuffer(shards[i], dtype=np.uint8))
                digests_w.append(hinfos[i])
        ref = crc32c_rows_host(np.stack(rows))
        if not np.array_equal(ref, np.asarray(digests_w, dtype=np.uint32)):
            fail(f"write lane {label}: hinfo digests differ from host crc32c")
        shard_crc[label] = ref
        log(f"[verify] write lane {label}: {len(rows)} shards and hinfos "
            f"equal the numpy oracle encode + host crc32c")
    for (shards, _h), got in zip(written["4MiB"], rebuilt):
        for i in LOST:
            if got[i].tobytes() != shards[i]:
                fail(f"recovery lane: shard {i} differs from the original")
    for c, got in zip(chunks, rechecked):
        if not np.array_equal(got, rs.encode_oracle(coding, c)):
            fail("recheck parity differs from the oracle")
    log(f"[verify] recovery lane: {N_OBJ} objects, shards {LOST} equal "
        f"the originals; 8 rechecks equal the oracle")
    scrub_shards = np.asarray([digests[(o, i)] for o in range(N_OBJ)
                               for i in range(K + M)], dtype=np.uint32)
    if not np.array_equal(scrub_shards, shard_crc["4MiB"]):
        fail("deep scrub: shard digests differ from host crc32c")
    big_ref = crc32c_long_host(big_objs)
    if any(digests[("big", o)] != int(big_ref[o])
           for o in range(N_SCRUB_BIG)):
        fail("deep scrub: segmented digests differ from host crc32c")
    bad = {CORRUPT_ONE[0], CORRUPT_PAIR[0]}
    for how, rep in (("flush_sync", recheck_lane),
                     ("standalone", recheck_alone)):
        if {o for o, flag in rep.items() if flag} != bad:
            fail(f"deep scrub: {how} recheck flagged "
                 f"{sorted(o for o, f in rep.items() if f)}, want "
                 f"{sorted(bad)}")
    if culprit != CORRUPT_ONE[1]:
        fail(f"deep scrub: isolate_culprit gave {culprit}, want "
             f"{CORRUPT_ONE[1]}")
    if tuple(culprits) != CORRUPT_PAIR[1]:
        fail(f"deep scrub: isolate_culprits gave {culprits}, want "
             f"{CORRUPT_PAIR[1]}")
    log(f"[verify] deep scrub: {len(scrub_shards)} shard digests and "
        f"{N_SCRUB_BIG} segmented digests equal host crc32c; both "
        f"rechecks flag objects {sorted(bad)}; culprit {culprit}, "
        f"pair {tuple(culprits)}")
    phase_done("verify")

    # -- 5. timings -----------------------------------------------------------
    def bound(nbytes, ops, rate=INT8_OPS):
        tb, to = nbytes / HBM_BPS * 1e3, ops / rate * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    gw, ge = shapes["gf_words"], shapes["gf_expand"]
    gp, gc = shapes["gf_planes"], shapes["crc32c_batch"]
    g2 = shapes["gf2_packets"]
    rows_p = plan.matrix.shape[0]
    r2, n2 = lib_bits.shape
    work = {
        # read k rows + write m rows; bit-matrix MACs 8m x 8k per byte column
        "gf_words": (gw.numel() * (K + M) // K,
                     2 * 64 * K * M * gw.numel() // K),
        # read n bytes, write 8 n plane bytes
        "gf_expand": (9 * ge.numel(), 0),
        # read planes, write rows words per column; int8 MACs 32 rows x 32k
        "gf_planes": (gp.numel() + 4 * rows_p * gp.numel() // (32 * K),
                      2 * 32 * rows_p * gp.numel()),
        # read each row once (+ seeds, digests); GF(2) matvec 32 x 8L a row
        "crc32c_batch": (gc.numel() + 8 * gc.shape[0],
                         2 * 32 * 8 * gc.numel()),
        # as gf_words, on bytes
        "gf_bytes": (gw.numel() * (K + M) // K,
                     2 * 64 * K * M * gw.numel() // K),
        # read N packets, write R; 0/1 MACs R x N per bit column
        "gf2_packets": (g2.numel() * (r2 + n2) // n2,
                        2 * r2 * 8 * g2.numel()),
        # read 4 int32 a lane and the tables, write 1; the SM clocks of
        # one loop item (the SASS count) for each item of positive
        # weight in this run's rows, over the card's SMs
        "crush_straw2": (
            20 * k7_args[0].numel() + sum(
                a.numel() * a.element_size() for a in (
                    k7_tab.items, k7_tab.hash_ids, k7_tab.weights,
                    k7_tab.sizes, k7_tab.ln16)),
            k7_item_clocks * int((k7_tab.weights[0][k7_args[0]] > 0).sum()),
            sms * sm_hz),
        # read a byte, write a word; a shared-memory table load, a shift
        # and two adds an output, on the int32 lanes
        "gear_hash": (5 * shapes["gear_hash"].numel(),
                      4 * shapes["gear_hash"].numel(),
                      INT_OPS_PER_SM * sms * sm_hz),
        # read a byte, write a byte; one compare a byte
        "run_starts": (2 * shapes["run_starts"].numel(),
                       shapes["run_starts"].numel(),
                       INT_OPS_PER_SM * sms * sm_hz),
        # read 48 bytes a PG, write the histogram and the sums; about six
        # integer operations a PG on the int32 lanes
        "pgmap_fold": (48 * CP_PGS + 8 * (cp["fold_args"][-1] + 5),
                       6 * CP_PGS, INT_OPS_PER_SM * sms * sm_hz),
    }
    # K11 is timed on the controlplane harness's own columns
    runs["pgmap_fold"] = (lambda: PG.summary_fold(*cp["fold_args"]),
                          lambda: PG._summary_fold_plain(*cp["fold_args"]))
    rs_in = shapes["run_starts"]
    library = {
        # the one PyTorch call of the same compare (column 0 aside)
        "run_starts": lambda: torch.ne(rs_in[:, 1:], rs_in[:, :-1]),
    }
    log(f"[clocks] before timing: {clocks()}")
    # crc32c_batch cold (graphs cycling through >= 96 MiB of distinct
    # inputs) at the write lane's launch shapes; the kernel table takes
    # the cold time of the main shape, the warm time is printed beside it
    cold = {}
    n_data, n_par = shapes["crc32c_batch"].shape[0], par_rows.shape[0]
    for label, shape, fn in (
            ("data rows of a 4 MiB flush", tuple(gc.shape),
             lambda x: C.crc32c_rows(x, seeds)),
            ("parity rows of a 4 MiB flush", tuple(par_rows.shape),
             lambda x: C.crc32c_rows(x)),
            ("fused data + parity rows of a 4 MiB flush",
             (n_data + n_par, gc.shape[1]),
             lambda x: C.crc32c_row_sets(x[:n_data], x[n_data:])),
            ("data rows of a 64 KiB-object flush", tuple(small_rows.shape),
             lambda x: C.crc32c_rows(x)),
            ("fused data + parity rows of a 64 KiB-object flush",
             (N_OBJ * (K + M), small_rows.shape[1]),
             lambda x: C.crc32c_row_sets(x[:N_OBJ * K], x[N_OBJ * K:]))):
        inputs = cold_inputs(torch, shape, dev, seed=len(cold))
        ms, lo, hi, n_win = time_cold(torch, fn, inputs)
        b_ms, b_by = bound(math.prod(shape) + 8 * shape[0],
                           2 * 32 * 8 * math.prod(shape))
        cold[label] = (ms, lo, hi)
        log(f"[time] crc32c_batch cold {list(shape)} ({label}): {ms:.4f} ms "
            f"median of 5 windows of {n_win} launches over "
            f"{len(inputs)} distinct inputs (spread {lo:.4f}-{hi:.4f} ms; "
            f"bound {b_ms:.4f} ms by {b_by}) on {card}")
        del inputs
    entries = []
    for name, (kern, plain) in runs.items():
        ms, lo, hi, n_win = time_kernel(torch, kern)
        warm, warm_lo, warm_hi = ms, lo, hi
        if name == "crc32c_batch":
            ms, lo, hi = cold["data rows of a 4 MiB flush"]
        plain_ms = time_plain(torch, plain)
        lib_ms = (time_kernel(torch, library[name])[0]
                  if name in library else None)
        b_ms, b_by = bound(*work[name])
        k = build.KERNELS[name]
        shape = (k7_shape if name == "crush_straw2" else words_in.shape
                 if name == "gf_words" else [CP_PGS]
                 if name == "pgmap_fold" else shapes[name].shape)
        entries.append({
            "name": name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "shape": list(shape), "ms_min": lo, "ms_max": hi,
            "window_launches": n_win, "ms_warm": warm})
        log(f"[time] {name} {list(shape)}: {warm:.4f} ms median of 5 windows "
            f"of {n_win} launches (spread {warm_lo:.4f}-{warm_hi:.4f} ms; plain "
            f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms by {b_by}"
            + (f", library {lib_ms:.4f} ms" if lib_ms is not None else "")
            + f") on {card}"
            + (f"; warm, against {ms:.4f} ms cold" if ms != warm else ""))
    # gf2_packets at the liberation (0, 1) decode shape: [64, 42, 24968]
    # in and out (64 MiB each way: no input stays in L2)
    ms, lo, hi, n_win = time_kernel(
        torch, lambda: BM.gf2_packets(lib_inv, g2, tables))
    b_ms, b_by = bound(2 * g2.numel(), 2 * lib_inv.shape[0] * 8 * g2.numel())
    log(f"[time] gf2_packets decode {list(g2.shape)} -> {list(g2.shape)}: "
        f"{ms:.4f} ms median of 5 windows of {n_win} launches (spread "
        f"{lo:.4f}-{hi:.4f} ms; bound {b_ms:.4f} ms by {b_by}) on {card}")
    # the lrc plugin's per-stripe layer launches (2694 of gf_words' in
    # the plugin sweep): kernel alone in graph windows, and the wrapper's
    # host wall per call as the plugin makes it
    for mat_shape in ((1, 3), (2, 4)):
        mat = coding[:mat_shape[0], :mat_shape[1]]
        x = rand_u8(mat_shape[1], LRC_CHUNK)
        ms, lo, hi, _ = time_kernel(
            torch, lambda: W.gf_matmul_bytes(mat, x, tables))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            W.gf_matmul_bytes(mat, x, tables)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 200 * 1e3
        log(f"[time] gf_words lrc layer {list(mat_shape)} x "
            f"{[mat_shape[1], LRC_CHUNK]} B: {ms:.4f} ms median of 5 "
            f"windows (spread {lo:.4f}-{hi:.4f} ms); {wall:.4f} ms host "
            f"wall per call on {card}")
    log(f"[clocks] after timing: {clocks()}")
    fold_ms = next(e["ms"] for e in entries if e["name"] == "pgmap_fold")
    folds = "; ".join(
        f"{f['label']}: numpy fold {f['numpy_ms']:.2f} ms, device fold "
        f"{f['device_ms']:.2f} ms ({f['stale']} stale)" for f in cp["folds"])
    log(f"[controlplane] ScaleHarness {CP_OSDS} OSDs x {CP_PGS} PGs, "
        f"placement crush on {dev.type} ({cp['build_s']:.2f} s to build, "
        f"{phase_counts['controlplane']['crush_straw2']} crush_straw2 "
        f"launches; {CP_SAMPLE} sampled PGs equal the plain mapper): "
        f"health {cp['health_ms']:.2f} ms best of 5 (bar "
        f"{HEALTH_BAR_MS:.0f} ms, reported only), codes {cp['codes']}; "
        f"summary {cp['summary_ms']:.2f} ms; balancer_round_ms@1M "
        f"{cp['balancer_round_ms@1M']:.2f} ({cp['balancer_moves']} "
        f"balancer_moves; alone, its placement matrix "
        f"{cp['balancer_matrix_ms']:.2f} ms, its targets "
        f"{cp['balancer_targets_ms']:.2f} ms, one scan for the PGs on the "
        f"fullest OSD {cp['balancer_scan_ms']:.2f} ms); {folds} (host "
        f"clock, the "
        f"device fold with its {cp['copy_MiB']:.0f} MiB copy-in of "
        f"{cp['copy_in_ms']:.2f} ms); pgmap_fold {fold_ms:.4f} ms graph-"
        f"timed on {card}")
    phase_done("timings")
    # the host against the device, lane by lane: the profiler's dispatch
    # (host time to enqueue, staging included), compute (the host's wait
    # at the flights' CUDA events) and idle gaps, against the lane's wall
    # time; the device-busy estimate counts every launch of the lane at
    # its kernel's graph-timed ms at the main shapes above
    kernel_ms = {e["name"]: e["ms_warm"] for e in entries}
    for lane, phase in (("write", "write_lane"), ("recon", "recovery_lane"),
                        ("comp", "comp"), ("fingerprint", "fingerprint"),
                        ("crush", "crush"), ("store", "store")):
        tot = totals[lane]
        busy = sum(n * kernel_ms[k] for k, n in phase_counts[phase].items())
        if lane == "crush":     # the two timed mappings' K7 launches only
            busy = crush_k7 * kernel_ms["crush_straw2"]
        wall_ms = walls[lane] * 1e3
        log(f"[profile] {lane}: {tot['launches']} profiled launches, "
            f"dispatch {tot['dispatch_s'] * 1e3:.1f} ms, compute "
            f"{tot['compute_s'] * 1e3:.1f} ms, gap {tot['gap_s'] * 1e3:.1f} "
            f"ms ({tot['gaps']} gaps), wall {wall_ms:.1f} ms; device busy "
            f"<= {busy:.2f} ms ({busy / wall_ms:.2%} of the wall, idle "
            f">= {1 - busy / wall_ms:.2%}) on {card}")
    for tag, steps, lane, names in (
            ("cluster", st, "write", ("write", "degraded_write")),
            ("cluster", st, "recon", ("degraded_read", "recovery")),
            ("rgw", gst, "write", ("put", "multipart_put")),
            ("rgw", gst, "recon", ("degraded_get", "recovery")),
            ("rbd", rst, "write", ("import", "bench_write",
                                   "partial_writes", "import_diff",
                                   "clone_flatten", "degraded_write",
                                   "journal_writes", "snapshot_mirror")),
            ("rbd", rst, "recon", ("degraded_read", "recovery")),
            ("cephfs", fst, "write", ("write_files", "partial_writes",
                                      "failover")),
            ("cephfs", fst, "recon", ("degraded_read", "recovery"))):
        agg = dict.fromkeys(("launches", "dispatch_s", "compute_s"), 0)
        wall_ms = busy = 0.0
        for name in names:
            wall_ms += steps[name]["s"] * 1e3
            for k in agg:
                agg[k] += steps[name]["lanes"].get(lane, {}).get(k, 0)
            busy += sum(n * kernel_ms[k]
                        for k, n in steps[name]["launches"].items())
        osds = f"{CLUSTER_OSDS} OSDs" + (" a site" if tag == "rbd" else "")
        log(f"[profile] {tag} {lane} lane ({' + '.join(names)} steps, "
            f"{osds}): {agg['launches']} profiled launches, "
            f"dispatch {agg['dispatch_s'] * 1e3:.1f} ms, compute "
            f"{agg['compute_s'] * 1e3:.1f} ms summed over the daemons, "
            f"wall {wall_ms:.1f} ms; device busy <= {busy:.2f} ms "
            f"({busy / wall_ms:.2%} of the wall, idle >= "
            f"{1 - busy / wall_ms:.2%}) on {card}")
    log(f"[profile] write lane, one flush of 2 x 4 MiB (host clock, mean "
        f"of 10): _batch packing {stage_ms[0]:.3f} ms, _stage_in pageable "
        f"host-to-device copy {stage_ms[1]:.3f} ms")
    log(json.dumps({"kernels": entries}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
