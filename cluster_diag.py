"""Diagnostic run of ``chip_smoke.cluster_phase``, the port's live cluster.

    python3 cluster_diag.py MODE DEVICE N_OBJ OBJ REWRITE [FLUSH_MS]

MODE ``A`` runs the OSDs' EC recovery as ceph_tpu does it, without the
record of shard pushes in flight (``ECBackend._pushes`` is emptied before
every ``push_object``), so each tick of a daemon reconstructs and pushes
again every shard still on its way; MODE ``B`` runs the port as it is.
DEVICE is ``cuda`` or ``cpu``; N_OBJ objects of OBJ bytes, REWRITE of them
rewritten while osd.3 is down; FLUSH_MS, when given, sets the OSDs' write
and recovery lanes' flush window (ms; the option default is 0).

On the card it first prints the card's name and power limit.  Besides
the phase's own ``[cluster]`` lines it prints one ``ABORT`` line
for each deep scrub whose primary gives up on a member
(``PG.check_scrub_timeout``), with each silent member's map epoch, op
queue depths, PG state and whether it handled the request or its map
arrived; one ``DROP`` line for each scrub message that ``_pg_for``
refused as a straggler of an older interval (the daemon then answers a
``MOSDRepScrub`` from a stray PG it loads from its store); and a last
``RESULT`` line with the
steps' walls and launches, the scrub times a PG and the messages the
daemons sent, by type.  Example (the H100 runs in PERF.md section 6):

    python3 cluster_diag.py B cuda 64 4194304 16
    python3 cluster_diag.py A cuda 32 4194304 8 5
"""

import collections
import json
import subprocess
import sys
import time

import torch

import chip_smoke as S
import ceph_tpu_torch.vstart as V
from ceph_tpu_torch.kernels import build
from ceph_tpu_torch.osd import daemon as D
from ceph_tpu_torch.osd import pg as P

mode, devname = sys.argv[1], sys.argv[2]
n_obj, obj, rewrite = map(int, sys.argv[3:6])
dev = torch.device(devname)
if dev.type == "cuda":
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    build.build()
    build.library()

clusters = []
sent = collections.Counter()
rep_seen, map_seen = {}, {}

_send = D.OSDaemon.send_to_osd


def send(self, osd, msg):
    sent[type(msg).__name__] += 1
    return _send(self, osd, msg)


_mc_init = V.MiniCluster.__init__


def mc_init(self, *a, osd_config=None, **k):
    if len(sys.argv) > 6:
        window = float(sys.argv[6])
        osd_config = dict(osd_config or {}, osd_batch_flush_ms=window,
                          osd_recovery_batch_flush_ms=window)
    _mc_init(self, *a, osd_config=osd_config, **k)
    clusters.append(self)


_push = P.ECBackend.push_object


def push_without_record(self, peer, oid, version):
    self._pushes.clear()
    return _push(self, peer, oid, version)


_handle_rep_scrub = P.PG.handle_rep_scrub


def handle_rep_scrub(self, msg):
    t = time.monotonic()
    _handle_rep_scrub(self, msg)
    rep_seen[(str(self.pgid), msg.scrub_tid, self.daemon.whoami)] = (
        round(t, 3), round(time.monotonic() - t, 3))


_handle_scrub_map = P.PG.handle_scrub_map


def handle_scrub_map(self, msg):
    map_seen[(str(self.pgid), msg.scrub_tid, msg.from_osd)] = (
        round(time.monotonic(), 3), self.scrubbing, self._scrub_tid)
    return _handle_scrub_map(self, msg)


_check_scrub_timeout = P.PG.check_scrub_timeout


def check_scrub_timeout(self, grace=30.0):
    if self.scrubbing and \
            time.monotonic() - getattr(self, "_scrub_started", 0.0) > grace:
        info = {"pg": str(self.pgid), "primary": self.daemon.whoami,
                "primary_epoch": self.daemon.osdmap.epoch,
                "interval": self.interval_epoch, "tid": self._scrub_tid,
                "waiting": sorted(self._scrub_waiting), "peers": {}}
        for o in self._scrub_waiting:
            d = clusters[-1].osds.get(o)
            if d is None:
                info["peers"][o] = "no daemon"
                continue
            p = d.pgs.get(self.pgid)
            key = (str(self.pgid), self._scrub_tid, o)
            info["peers"][o] = {
                "epoch": d.osdmap.epoch, "queue": d.op_queue.depths(),
                "pg": None if p is None else {
                    "state": p.state, "interval": p.interval_epoch,
                    "shard": p.shard, "acting": p.acting},
                "running": d.running,
                "rep_scrub_handled": rep_seen.get(key),
                "map_arrived": map_seen.get(key),
                "started": round(self._scrub_started, 3),
                "now": round(time.monotonic(), 3),
                "engine_pending": {k: len(v) for k, v in
                                   d.batch_engine._pending.items()},
                "peer_pushes": sum(len(getattr(q.backend, "_pushes", {}))
                                   for q in d.pgs.values())}
        print("ABORT", json.dumps(info, default=str), flush=True)
    return _check_scrub_timeout(self, grace)


_pg_for = D.OSDaemon._pg_for


def pg_for(self, msg):
    pg = _pg_for(self, msg)
    if pg is None and "Scrub" in type(msg).__name__:
        p = self.pgs.get(D.PGid.parse(msg.pgid))
        print(f"DROP {type(msg).__name__} {msg.pgid} at osd.{self.whoami} "
              f"epoch {msg.epoch} interval {p and p.interval_epoch}",
              flush=True)
    return pg


D.OSDaemon.send_to_osd = send
V.MiniCluster.__init__ = mc_init
if mode == "A":
    P.ECBackend.push_object = push_without_record
P.PG.handle_rep_scrub = handle_rep_scrub
P.PG.handle_scrub_map = handle_scrub_map
P.PG.check_scrub_timeout = check_scrub_timeout
D.OSDaemon._pg_for = pg_for

t0 = time.perf_counter()
out = S.cluster_phase(dev, S.CLUSTER_MONS, S.CLUSTER_OSDS, n_obj, obj,
                      S.CLUSTER_PG_NUM, rewrite)
print("RESULT", mode, json.dumps({
    "wall_s": time.perf_counter() - t0,
    "steps": {k: {"s": v["s"], "launches": v["launches"]}
              for k, v in out["steps"].items()},
    "scrub_ms": out["scrub_ms"], "engine": out["engine"],
    "reinterval": out["reinterval"], "sent": dict(sent)}), flush=True)
