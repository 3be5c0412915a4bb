"""Monitor daemon — elections, Paxos services, subscriptions, commands.

The port's copy of ``ceph_tpu.mon.monitor``.

Reference behavior re-created (``src/mon/Monitor.{h,cc}``,
``PaxosService.{h,cc}``, ``OSDMonitor.cc``, ``AuthMonitor.cc``,
``ConfigMonitor.cc``, ``LogMonitor.cc``, ``HealthMonitor.cc``;
SURVEY.md §3.4):

- boots into an election; the quorum then runs one Paxos log whose
  values are service transactions (`{"service": ..., "ops": [...]}`);
  every quorum member applies committed transactions to its store and
  refreshes the service's in-memory state — so all mons expose
  identical maps at identical versions;
- **PaxosService** pattern: message/command handlers stage changes on
  the LEADER's pending transaction; `propose_pending` pushes one round
  through Paxos; non-leader mons forward mutating commands to the
  leader (the reference routes via forward/route_message — here the
  client resends; see MonClient);
- clients subscribe (`MMonSubscribe`) and get map pushes; commands
  (`MMonCommand`) are the `ceph ...` CLI's transport.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field

from ..core.auth import CryptoKey, KeyRing
from ..core.threading_utils import SafeTimer
from ..crush.compiler import crushmap_from_dict
from ..mds.fsmap import (FSMap, Filesystem, MDSInfo, STATE_ACTIVE,
                         STATE_STANDBY)
from ..msg import Dispatcher, EntityAddr, Messenger
from ..osd.osdmap import (CLUSTER_FLAGS, EXISTS, OSDMap, PGid,
                          TYPE_ERASURE, TYPE_REPLICATED, UP)
from ..tools.osdmaptool import osdmap_from_dict, osdmap_to_dict
from . import messages as M
from .health import PG_STALE_GRACE, HealthMonitor, PGMap  # noqa: F401
from .paxos import Elector, Paxos, VICTORY
from .service import PaxosService
from .store import MonitorDBStore, StoreTransaction


# pool pg_num ceiling (reference mon_max_pool_pg_num default): a fat-
# fingered `pool set pg_num` must not be able to fan a billion-child
# split out to every OSD
MAX_POOL_PG_NUM = 65536


def _parse_pgid(s) -> PGid | None:
    try:
        return PGid.parse(s)
    except (ValueError, AttributeError, TypeError):
        return None


@dataclass
class MonMap:
    """monmap: rank → address (reference ``src/mon/MonMap.h``).

    Stretch clusters add site placement: ``sites`` maps rank → site
    name (reference CRUSH location of the mon) and ``tiebreaker`` names
    the rank that arbitrates between sites — it votes but never leads
    (reference MonMap::tiebreaker_mon / disallowed_leaders)."""
    epoch: int = 1
    mons: dict[int, EntityAddr] = field(default_factory=dict)
    sites: dict[int, str] = field(default_factory=dict)
    tiebreaker: int = -1       # rank; -1 = no stretch tiebreaker

    def ranks(self) -> list[int]:
        return sorted(self.mons)

    def to_dict(self) -> dict:
        return {"epoch": self.epoch,
                "mons": {str(r): [a.host, a.port]
                         for r, a in self.mons.items()},
                "sites": {str(r): s for r, s in self.sites.items()},
                "tiebreaker": self.tiebreaker}

    @classmethod
    def from_dict(cls, d: dict) -> "MonMap":
        return cls(epoch=d["epoch"],
                   mons={int(r): EntityAddr(a[0], a[1])
                         for r, a in d["mons"].items()},
                   sites={int(r): s
                          for r, s in (d.get("sites") or {}).items()},
                   tiebreaker=int(d.get("tiebreaker", -1)))


class OSDMonitor(PaxosService):
    NAME = "osdmap"

    def __init__(self, mon):
        super().__init__(mon)
        self.osdmap = OSDMap()
        # the initial map always carries the default replicated(0)/
        # erasure(1) rules, so `osd pool create` on a fresh quorum —
        # before any OSD has booted — succeeds exactly as the
        # reference's pool create against the initial crush map does
        # (`src/mon/OSDMonitor.cc` create_initial)
        self.osdmap.crush = self._seed_crush(0)
        self.failure_reports: dict[int, set[int]] = {}
        # staged-but-uncommitted map: a second mutation arriving before
        # the first commits must build on IT, not on the committed map,
        # or the first proposal's changes are silently lost
        self.pending_map: OSDMap | None = None

    def create_initial(self):
        self.osdmap.epoch = 1
        if len(self.osdmap.crush.buckets) == 0:
            self.osdmap.crush = self._seed_crush(0)
        self.stage("put", 1, json.dumps(osdmap_to_dict(self.osdmap)))
        self.stage("put", "last_epoch", "1")

    @staticmethod
    def _seed_crush(n_osds: int):
        """Default CRUSH tree: flat straw2 root + replicated(0)/
        erasure(1) rules (what `vstart` clusters get upstream)."""
        from ..crush.map import Rule, Step, build_flat_map
        crush = build_flat_map(n_osds)
        crush.rules.append(Rule(
            id=1, name="erasure_rule", type="erasure",
            steps=[Step("take", -1), Step("choose_indep", 0, 0),
                   Step("emit")]))
        return crush

    def on_election_start(self):
        super().on_election_start()
        self.pending_map = None

    def update_from_store(self):
        epoch = self.mon.store.get_int(self.prefix, "last_epoch")
        if epoch > self.osdmap.epoch or self.osdmap.max_osd == 0:
            blob = self.mon.store.get_str(self.prefix, epoch)
            if blob:
                self.osdmap = osdmap_from_dict(json.loads(blob))
                self.mon.push_map("osdmap", epoch,
                                  json.loads(blob))
        if self.pending_map is not None and \
                self.osdmap.epoch >= self.pending_map.epoch:
            self.pending_map = None

    # -- staging helpers (leader only) ------------------------------------
    def _stage_map(self, m: OSDMap):
        m.epoch += 1
        self.stage("put", m.epoch, json.dumps(osdmap_to_dict(m)))
        self.stage("put", "last_epoch", str(m.epoch))
        self.pending_map = m

    def _working(self) -> OSDMap:
        """Copy of the newest staged (or committed) map to mutate."""
        base = self.pending_map if self.pending_map is not None \
            else self.osdmap
        return osdmap_from_dict(osdmap_to_dict(base))

    @staticmethod
    def _pool_set_efficiency(pool, var: str, val):
        """Validate + apply one storage-efficiency pool option; None
        on success, an (rc, msg, data) error triple otherwise."""
        if var == "compression_mode":
            mode = str(val or "").lower()
            if mode not in ("none", "passive", "aggressive", "force"):
                return -22, f"invalid compression_mode {val!r} " \
                    "(none|passive|aggressive|force)", None
            pool.compression_mode = mode
            if mode != "none" and not pool.compression_algorithm:
                pool.compression_algorithm = "rle"
            return None
        if var == "compression_algorithm":
            from ..compress.registry import list_codecs
            algo = str(val or "")
            if algo and algo not in list_codecs():
                return -22, f"unknown compression_algorithm " \
                    f"{algo!r} (available: {list_codecs()})", None
            pool.compression_algorithm = algo
            return None
        # dedup_enable
        sval = str(val).lower()
        if sval in ("true", "1", "yes", "on"):
            enable = True
        elif sval in ("false", "0", "no", "off"):
            enable = False
        else:
            return -22, f"invalid dedup_enable {val!r} " \
                "(true|false)", None
        if enable and pool.is_erasure():
            # an EC manifest would need a separately-coded chunk pool
            # (the reference's dedup-tier architecture) — replicated
            # chunks ride the ordinary replica txn instead
            return -95, "dedup is not supported on erasure-coded " \
                "pools", None
        if enable and pool.snaps:
            return -22, "dedup cannot be enabled on a pool with " \
                "snapshots", None
        pool.dedup_enable = enable
        return None

    # seconds without ANY report (stats tick ≈1s) before the mon
    # itself marks an OSD down — the failure-report path needs live
    # PEERS, so a whole-cluster outage would otherwise never be
    # noticed (reference mon_osd_report_timeout, scaled to this
    # suite's clock)
    REPORT_TIMEOUT = 30.0
    # seconds an OSD stays down before the mon marks it OUT so CRUSH
    # re-places its data (reference mon_osd_down_out_interval, 600s —
    # kept at the reference scale so kill/revive tests never trip it;
    # the targeted test shortens it)
    DOWN_OUT_INTERVAL = 600.0

    def note_osd_report(self, osd: int):
        t = getattr(self, "_last_report", None)
        if t is None:
            t = self._last_report = {}
        t[osd] = time.monotonic()

    def tick(self):
        if not self.mon.is_leader:
            return
        t = getattr(self, "_last_report", None)
        if t is None:
            t = self._last_report = {}
        now = time.monotonic()
        # stall guard: everything here shares one process (and the
        # GIL) with JAX compiles that can freeze ALL threads for tens
        # of seconds — the OSDs' report timers stalled exactly as long
        # as we did, so a big gap since OUR last tick must not be
        # counted against them
        last_tick = getattr(self, "_last_live_tick", now)
        self._last_live_tick = now
        gap = now - last_tick
        if gap > 5.0:
            for o in list(t):
                t[o] += gap
        cur = self.pending_map or self.osdmap
        # every up OSD gets a grace window from when this leader first
        # saw it up — an OSD that dies before its first stats report
        # (or a whole-cluster outage with no surviving peers to report
        # failures) must still be noticed
        for o in range(cur.max_osd):
            if cur.is_up(o):
                t.setdefault(o, now)
        if cur.flags & CLUSTER_FLAGS["nodown"]:
            dead = []
            # refresh windows so lifting nodown doesn't mass-expire
            for o in list(t):
                t[o] = now
        else:
            dead = [o for o, ts in t.items()
                    if now - ts > self.REPORT_TIMEOUT
                    and o < cur.max_osd and cur.is_up(o)]
        quota_flips = self._check_quotas(cur)
        # auto-out: down long enough ⇒ weight 0, CRUSH re-places and
        # backfill restores redundancy elsewhere (reference
        # OSDMonitor::tick down-out handling); noout suppresses
        down_t = getattr(self, "_down_since", None)
        if down_t is None:
            down_t = self._down_since = {}
        outs = []
        if not (cur.flags & CLUSTER_FLAGS["noout"]):
            for o in range(cur.max_osd):
                if cur.exists(o) and not cur.is_up(o):
                    down_t.setdefault(o, now)
                    if not cur.is_out(o) and \
                            now - down_t[o] > self.DOWN_OUT_INTERVAL:
                        outs.append(o)
                else:
                    down_t.pop(o, None)
        if not dead and not quota_flips and not outs \
                and not cur.stretch_mode_enabled:
            return
        m = self._working()
        for o in dead:
            m.mark_down(o)
            self.failure_reports.pop(o, None)
        # report entries are NOT popped: if this proposal loses a race
        # the next tick re-marks (idempotent); once the map shows the
        # OSD down the is_up filter skips it, and a revive refreshes
        # the timestamp via note_osd_report
        for pid, full in quota_flips:
            if pid in m.pools:
                m.pools[pid].full = full
                m.pools[pid].last_change = m.epoch + 1
        for o in outs:
            m.mark_out(o)
        changed = bool(dead or quota_flips or outs)
        # stretch transitions are evaluated on the mutated map so a
        # site whose last OSD we just marked down degrades in the SAME
        # epoch the down-marking commits
        if self._apply_stretch(m):
            changed = True
        if not changed:
            return
        self._stage_map(m)
        self.mon.propose()

    def _apply_stretch(self, m: OSDMap) -> bool:
        """Stretch-mode state machine (reference OSDMonitor
        trigger_degraded_stretch_mode / trigger_healthy_stretch_mode):
        site loss drops stretch pools to min_size 1 and raises
        DEGRADED_STRETCH_MODE; once every site has OSDs up again the
        healthy min_size is restored (recovering), and the degraded
        state only clears after recovery completes."""
        if not m.stretch_mode_enabled:
            return False
        down = m.stretch_down_sites()
        if not m.degraded_stretch_mode:
            if down and len(down) < len(m.stretch_sites):
                m.degraded_stretch_mode = True
                m.recovering_stretch_mode = False
                m.stretch_degraded_site = down[0]
                for pool in m.pools.values():
                    if pool.is_stretch:
                        if not pool.stretch_min_size:
                            pool.stretch_min_size = pool.min_size
                        pool.min_size = 1
                        pool.last_change = m.epoch + 1
                return True
            return False
        if down:
            if m.recovering_stretch_mode:
                # relapse mid-recovery: back to degraded operation
                m.recovering_stretch_mode = False
                m.stretch_degraded_site = down[0]
                for pool in m.pools.values():
                    if pool.is_stretch:
                        pool.min_size = 1
                        pool.last_change = m.epoch + 1
                return True
            return False
        if not m.recovering_stretch_mode:
            # every site is back: restore full replication and wait
            # for recovery before clearing the health state
            m.recovering_stretch_mode = True
            for pool in m.pools.values():
                if pool.is_stretch:
                    pool.min_size = pool.stretch_min_size or \
                        (pool.size - pool.size // 2)
                    pool.last_change = m.epoch + 1
            return True
        if self._stretch_recovery_done(m):
            m.degraded_stretch_mode = False
            m.recovering_stretch_mode = False
            m.stretch_degraded_site = ""
            return True
        return False

    def _stretch_recovery_done(self, m: OSDMap) -> bool:
        """Every PG of every stretch pool reports active+clean (one
        masked reduction per pool on the array PGMap)."""
        pgm = self.mon.pgmap
        for pool in m.pools.values():
            if not pool.is_stretch:
                continue
            if pgm.pool_clean_count(pool.id, pool.pg_num) \
                    != pool.pg_num:
                return False
        return True

    def _check_quotas(self, cur) -> list:
        """Pools whose FULL flag must flip, from PGMap usage vs quota
        (reference OSDMonitor pool-quota check → FLAG_FULL_QUOTA)."""
        if not any(p.quota_max_objects or p.quota_max_bytes
                   for p in cur.pools.values()):
            return []    # common case: no quotas — skip aggregation
        usage = self.mon.pgmap.pool_usage(set(cur.pools))
        flips = []
        for pid, pool in cur.pools.items():
            if not (pool.quota_max_objects or pool.quota_max_bytes):
                continue
            if pid not in usage:
                # zero reported stats ≠ empty: a freshly-elected
                # leader's in-memory PGMap starts blank — never lift
                # a FULL flag on missing data
                continue
            # quotas bill LOGICAL bytes (what clients wrote) —
            # compression shrinking the physical footprint must not
            # raise a pool's effective quota (reference: num_bytes is
            # pre-compression)
            objs, _stored, nbytes = usage[pid]
            over = (pool.quota_max_objects and
                    objs >= pool.quota_max_objects) or \
                (pool.quota_max_bytes and
                 nbytes >= pool.quota_max_bytes)
            if bool(over) != pool.full:
                flips.append((pid, bool(over)))
        return flips

    def _osd_send(self, osd: int, msg):
        """Cached per-OSD connection (the _peer_send pattern): a lazy
        connection per command would grow mon.msgr.connections without
        bound under periodic scrub scripting."""
        cons = getattr(self, "_osd_cons", None)
        if cons is None:
            cons = self._osd_cons = {}
        addr_s = self.osdmap.osd_addrs.get(osd)
        cached = cons.get(osd)
        if cached is not None:
            cached_addr, con = cached
            if cached_addr == addr_s and not con._closed:
                con.send_message(msg)
                return
            con.mark_down()
        host, _, port = addr_s.rpartition(":")
        con = self.mon.msgr.connect_to_lazy(
            EntityAddr(host, int(port)))
        cons[osd] = (addr_s, con)
        con.send_message(msg)

    # -- daemon messages ---------------------------------------------------
    def handle_boot(self, osd: int, addr: str):
        # already up at this address ⇒ duplicate boot (the OSD resends
        # while waiting for its subscription push) — do not mint a new
        # epoch for it (reference OSDMonitor::preprocess_boot)
        cur = self.pending_map or self.osdmap
        if osd < cur.max_osd and cur.is_up(osd) \
                and cur.osd_addrs.get(osd) == addr:
            return
        m = self._working()
        if osd >= m.max_osd:
            grow = osd + 1 - m.max_osd
            m.max_osd = osd + 1
            m.osd_state += [0] * grow
            m.osd_weight += [0x10000] * grow
            m.osd_up_thru += [0] * grow
        # keep the CRUSH tree covering every known device (the
        # reference's `osd crush add` that deploy tooling issues on
        # boot).  An EMPTY map is seeded flat with replicated(0)/
        # erasure(1) rules; an existing map — possibly an admin's
        # custom hierarchy via `osd setcrushmap` — is only EXTENDED
        # (new device into the root bucket), never replaced.
        if len(m.crush.buckets) == 0:
            m.crush = self._seed_crush(m.max_osd)
        elif m.stretch_mode_enabled:
            # a stretch hierarchy is site-placed by the operator; auto-
            # appending an unplaced device to the root would let the
            # stretch rule pick it as a "datacenter"
            pass
        elif m.crush.max_devices < m.max_osd:
            # resolve the actual root: prefer rule 0's take target,
            # fall back to bucket id -1 (maps without either get no
            # auto-extend; an admin owns such a hierarchy)
            root = None
            try:
                rule0 = m.crush.rule_by_id(0)
                for st in rule0.steps:
                    if st.op == "take":
                        # a class-filtered take walks a shadow bucket
                        # (st.arg1); the REAL root is st.orig
                        root = m.crush.bucket(
                            st.orig if st.orig is not None else st.arg1)
                        break
            except KeyError:
                pass
            if root is None:
                try:
                    root = m.crush.bucket(-1)
                except (KeyError, IndexError):
                    root = None
            for dev in range(m.crush.max_devices, m.max_osd):
                if root is not None and dev not in root.items:
                    root.items.append(dev)
                    root.weights.append(0x10000)
                m.crush.names.setdefault(dev, f"osd.{dev}")
            m.crush.max_devices = m.max_osd
        m.osd_state[osd] |= EXISTS | UP
        # fresh grace window: the stale pre-outage report timestamp
        # must not trip the report timeout before the revived OSD's
        # first stats report (~1s) arrives
        self.note_osd_report(osd)
        if addr:
            m.osd_addrs[osd] = addr
        if m.is_out(osd):
            m.osd_weight[osd] = 0x10000
        self._stage_map(m)
        self.mon.propose()

    def handle_alive(self, osd: int, want: int):
        """Bump up_thru so the requesting primary's interval counts as
        maybe-went-rw (reference OSDMonitor::prepare_alive)."""
        if not (0 <= osd < self.osdmap.max_osd) or want is None:
            return
        cur = (self.pending_map or self.osdmap).osd_up_thru
        if cur[osd] >= want or not self.osdmap.is_up(osd):
            return
        m = self._working()
        m.osd_up_thru[osd] = want
        self._stage_map(m)
        self.mon.propose()

    def handle_failure(self, target: int, reporter: int):
        cur = self.pending_map or self.osdmap
        if cur.flags & CLUSTER_FLAGS["nodown"]:
            return      # operator suppressed down-marking
        self.failure_reports.setdefault(target, set()).add(reporter)
        # mark down on a single report when the cluster is tiny, else 2
        need = 1 if self.osdmap.num_up_osds() <= 2 else 2
        if len(self.failure_reports[target]) >= need and \
                self.osdmap.is_up(target):
            m = self._working()
            m.mark_down(target)
            self._stage_map(m)
            self.failure_reports.pop(target, None)
            self.mon.propose()

    # -- commands ----------------------------------------------------------
    def dispatch_command(self, cmd):
        prefix = cmd.get("prefix", "")
        if prefix == "osd dump":
            return 0, "", osdmap_to_dict(self.osdmap)
        if prefix == "osd getmap":
            epoch = cmd.get("epoch") or \
                self.mon.store.get_int(self.prefix, "last_epoch")
            blob = self.mon.store.get_str(self.prefix, epoch)
            if blob is None:
                return -2, f"no epoch {epoch}", None
            return 0, "", json.loads(blob)
        if prefix == "osd tree":
            return 0, "", self._tree()
        if prefix == "osd stat":
            m = self.osdmap
            return 0, "", {"epoch": m.epoch, "num_osds": m.max_osd,
                           "num_up_osds": m.num_up_osds(),
                           "num_in_osds": m.num_in_osds()}
        if prefix == "osd pool create":
            name = cmd["pool"]
            if name in self.osdmap.pool_name:
                return 0, f"pool '{name}' already exists", None
            m = self._working()
            ptype = TYPE_ERASURE if cmd.get("pool_type") == "erasure" \
                else TYPE_REPLICATED
            profile_name = cmd.get("erasure_code_profile", "")
            size = int(cmd.get("size",
                               3 if ptype == TYPE_REPLICATED else 0))
            min_size = None
            if ptype == TYPE_ERASURE:
                prof = m.erasure_code_profiles.get(
                    profile_name or "default",
                    {"k": "2", "m": "2"})
                k = int(prof.get("k", 2))
                size = k + int(prof.get("m", 2))
                # the reference's EC default: min_size = k + 1 (survive
                # writes with up to m-1 shards down, never go below k)
                min_size = min(k + 1, size)
            if cmd.get("min_size") is not None:
                min_size = int(cmd["min_size"])
            default_rule = 1 if ptype == TYPE_ERASURE else 0
            rule_id = int(cmd.get("rule", default_rule))
            try:
                m.crush.rule_by_id(rule_id)
            except KeyError:
                return -22, f"crush rule {rule_id} does not exist", None
            pool = m.create_pool(name, pg_num=int(cmd.get("pg_num", 32)),
                                 size=size, min_size=min_size,
                                 type=ptype, crush_rule=rule_id,
                                 erasure_code_profile=profile_name)
            for var in ("compression_mode", "compression_algorithm",
                        "dedup_enable"):
                if cmd.get(var) is not None:
                    err = self._pool_set_efficiency(pool, var,
                                                    cmd[var])
                    if err is not None:
                        return err
            if m.stretch_mode_enabled and ptype == TYPE_REPLICATED \
                    and rule_id == 0:
                # pools born into a stretch cluster span the sites
                pool.is_stretch = True
                pool.size = 4
                pool.min_size = 1 if m.degraded_stretch_mode else 2
                pool.stretch_min_size = 2
            self._stage_map(m)
            self.mon.propose()
            return 0, f"pool '{name}' created", None
        if prefix == "osd pool mksnap":
            # pool snapshots (reference OSDMonitor pool mksnap):
            # bump snap_seq, record the name; clients pick the new
            # SnapContext up from the map and OSDs clone-on-write
            name = cmd["pool"]
            if name not in self.osdmap.pool_name:
                return -2, f"pool '{name}' does not exist", None
            m = self._working()
            pool = m.pools[m.pool_name[name]]
            if pool.is_erasure():
                # the EC backend has no clone-on-write path (the
                # reference gates EC pool snaps behind overwrite
                # support similarly)
                return -95, "pool snapshots are not supported on " \
                    "erasure-coded pools", None
            if pool.dedup_enable:
                # a clone would need its own manifest references; the
                # refcount layer deliberately keeps one manifest per
                # head object (see compress/dedup.py)
                return -95, "pool snapshots are not supported on " \
                    "dedup-enabled pools", None
            if cmd["snap"] in pool.snaps.values():
                return -17, f"snapshot {cmd['snap']!r} exists", None
            pool.snap_seq += 1
            pool.snaps[pool.snap_seq] = cmd["snap"]
            pool.last_change = m.epoch + 1
            self._stage_map(m)
            self.mon.propose()
            return 0, f"created pool {name} snap {cmd['snap']}", None
        if prefix == "osd pool rmsnap":
            name = cmd["pool"]
            if name not in self.osdmap.pool_name:
                return -2, f"pool '{name}' does not exist", None
            m = self._working()
            pool = m.pools[m.pool_name[name]]
            sid = next((i for i, n in pool.snaps.items()
                        if n == cmd["snap"]), None)
            if sid is None:
                return -2, f"no snapshot {cmd['snap']!r}", None
            del pool.snaps[sid]
            pool.last_change = m.epoch + 1
            self._stage_map(m)
            self.mon.propose()
            return 0, f"removed pool {name} snap {cmd['snap']}", None
        if prefix == "osd pool set":
            name = cmd["pool"]
            if name not in self.osdmap.pool_name:
                return -2, f"pool '{name}' does not exist", None
            var = cmd.get("var", "")
            int_vars = ("pg_num", "pgp_num", "size", "min_size")
            eff_vars = ("compression_mode", "compression_algorithm",
                        "dedup_enable")
            if var not in int_vars + eff_vars:
                return -22, f"unsupported pool var {var!r}", None
            if var in eff_vars:
                m = self._working()
                pool = m.pools[m.pool_name[name]]
                err = self._pool_set_efficiency(pool, var,
                                                cmd.get("val"))
                if err is not None:
                    return err
                pool.last_change = m.epoch + 1
                self._stage_map(m)
                self.mon.propose()
                return 0, f"set pool {name} {var} to " \
                    f"{cmd.get('val')}", None
            try:
                val = int(cmd["val"])
            except (KeyError, ValueError, TypeError):
                return -22, f"invalid value {cmd.get('val')!r} for " \
                    f"{var!r} (integer required)", None
            m = self._working()
            pool = m.pools[m.pool_name[name]]
            if var == "pg_num":
                new = val
                if new > MAX_POOL_PG_NUM:
                    return -34, f"pg_num {new} exceeds the " \
                        f"{MAX_POOL_PG_NUM} cap (reference " \
                        "mon_max_pool_pg_num)", None
                if new < pool.pg_num:
                    return -22, "pg_num cannot shrink (merge is not " \
                        "supported)", None
                if new == pool.pg_num:
                    return 0, f"pg_num is already {new}", None
                # OSDs split on this epoch (OSD::split_pgs).  pgp_num
                # deliberately does NOT follow: children keep the
                # parent's placement seed, so every split shard stays
                # on the OSD that already holds its chunk (EC shard
                # identity is positional).  Raising pgp_num afterwards
                # re-places children as ordinary recovery/backfill —
                # the reference's two-step split-then-rebalance
                pool.pg_num = new
            elif var == "pgp_num":
                new = val
                if not 1 <= new <= pool.pg_num:
                    return -22, "pgp_num must be in " \
                        f"[1, {pool.pg_num}]", None
                pool.pgp_num = new
            elif var == "size":
                if pool.is_erasure():
                    # EC width IS k+m from the profile; resizing would
                    # desync shard count from the code (the reference
                    # rejects it the same way)
                    return -95, "cannot change size of an " \
                        "erasure-coded pool", None
                if not 1 <= val <= 10:
                    return -22, "size must be in [1, 10]", None
                pool.size = val
                pool.min_size = min(pool.min_size, val)
            elif var == "min_size":
                new = val
                if not 1 <= new <= pool.size:
                    return -22, f"min_size must be in [1, " \
                        f"{pool.size}]", None
                pool.min_size = new
            pool.last_change = m.epoch + 1
            self._stage_map(m)
            self.mon.propose()
            return 0, f"set pool {name} {var} to {val}", None
        if prefix == "osd pool get":
            name = cmd["pool"]
            if name not in self.osdmap.pool_name:
                return -2, f"pool '{name}' does not exist", None
            pool = self.osdmap.pools[self.osdmap.pool_name[name]]
            gettable = {
                "pg_num": pool.pg_num, "pgp_num": pool.pgp_num,
                "size": pool.size, "min_size": pool.min_size,
                "crush_rule": pool.crush_rule,
                "compression_mode": pool.compression_mode,
                "compression_algorithm": pool.compression_algorithm,
                "dedup_enable": pool.dedup_enable,
            }
            var = cmd.get("var", "")
            if var == "all" or not var:
                return 0, "\n".join(f"{k}: {v}" for k, v in
                                    gettable.items()), gettable
            if var not in gettable:
                return -22, f"unsupported pool var {var!r}", None
            return 0, f"{var}: {gettable[var]}", {var: gettable[var]}
        if prefix == "osd tier add":
            # reference OSDMonitor tier commands: attach `tierpool`
            # as a cache tier of `pool`
            base, tier = cmd.get("pool"), cmd.get("tierpool")
            for n in (base, tier):
                if n not in self.osdmap.pool_name:
                    return -2, f"pool '{n}' does not exist", None
            if base == tier:
                return -22, "a pool cannot tier itself", None
            m = self._working()
            bp = m.pools[m.pool_name[base]]
            tp = m.pools[m.pool_name[tier]]
            if tp.tier_of >= 0:
                return -22, f"'{tier}' is already a tier", None
            if bp.tier_of >= 0 or tp.tiers:
                return -22, "nested tiering is not supported", None
            tp.tier_of = bp.id
            bp.tiers = sorted(set(bp.tiers) | {tp.id})
            bp.last_change = tp.last_change = m.epoch + 1
            self._stage_map(m)
            self.mon.propose()
            return 0, f"pool '{tier}' is now a tier of '{base}'", None
        if prefix == "osd tier remove":
            base, tier = cmd.get("pool"), cmd.get("tierpool")
            for n in (base, tier):
                if n not in self.osdmap.pool_name:
                    return -2, f"pool '{n}' does not exist", None
            m = self._working()
            bp = m.pools[m.pool_name[base]]
            tp = m.pools[m.pool_name[tier]]
            if tp.tier_of != bp.id:
                return -22, f"'{tier}' is not a tier of '{base}'", None
            if bp.read_tier == tp.id or bp.write_tier == tp.id:
                return -16, "remove the overlay first", None
            tp.tier_of = -1
            tp.cache_mode = "none"
            bp.tiers = [t for t in bp.tiers if t != tp.id]
            bp.last_change = tp.last_change = m.epoch + 1
            self._stage_map(m)
            self.mon.propose()
            return 0, f"pool '{tier}' removed as tier of '{base}'", \
                None
        if prefix == "osd tier cache-mode":
            name, mode = cmd.get("pool"), cmd.get("mode")
            if name not in self.osdmap.pool_name:
                return -2, f"pool '{name}' does not exist", None
            if mode not in ("none", "writeback"):
                return -22, f"unsupported cache mode {mode!r}", None
            m = self._working()
            pool = m.pools[m.pool_name[name]]
            if pool.tier_of < 0:
                return -22, f"'{name}' is not a tier", None
            pool.cache_mode = mode
            pool.last_change = m.epoch + 1
            self._stage_map(m)
            self.mon.propose()
            return 0, f"set cache-mode of '{name}' to {mode}", None
        if prefix == "osd tier set-overlay":
            base, overlay = cmd.get("pool"), cmd.get("overlaypool")
            for n in (base, overlay):
                if n not in self.osdmap.pool_name:
                    return -2, f"pool '{n}' does not exist", None
            m = self._working()
            bp = m.pools[m.pool_name[base]]
            op_ = m.pools[m.pool_name[overlay]]
            if op_.tier_of != bp.id:
                return -22, f"'{overlay}' is not a tier of " \
                            f"'{base}'", None
            if op_.cache_mode == "none":
                return -22, "set a cache-mode first", None
            bp.read_tier = bp.write_tier = op_.id
            bp.last_change = m.epoch + 1
            self._stage_map(m)
            self.mon.propose()
            return 0, f"overlay for '{base}' is now '{overlay}'", None
        if prefix == "osd tier remove-overlay":
            name = cmd.get("pool")
            if name not in self.osdmap.pool_name:
                return -2, f"pool '{name}' does not exist", None
            m = self._working()
            pool = m.pools[m.pool_name[name]]
            pool.read_tier = pool.write_tier = -1
            pool.last_change = m.epoch + 1
            self._stage_map(m)
            self.mon.propose()
            return 0, f"overlay for '{name}' removed", None
        if prefix == "osd pool delete":
            name = cmd["pool"]
            if name not in self.osdmap.pool_name:
                return -2, f"pool '{name}' does not exist", None
            cand = self.osdmap.pools[self.osdmap.pool_name[name]]
            if cand.tier_of >= 0 or cand.tiers:
                # unflushed writeback data / dangling tier refs
                # (reference: EBUSY until tiers are torn down)
                return -16, f"pool '{name}' participates in a tier " \
                            "relationship; remove the tier first", None
            m = self._working()
            pid = m.pool_name.pop(name)
            m.pools.pop(pid)
            self._stage_map(m)
            self.mon.propose()
            return 0, f"pool '{name}' removed", None
        if prefix in ("osd set", "osd unset"):
            flag = cmd.get("key")
            if flag not in CLUSTER_FLAGS:
                return -22, f"unknown flag {flag!r} (know: " \
                    f"{sorted(CLUSTER_FLAGS)})", None
            m = self._working()
            if prefix == "osd set":
                m.flags |= CLUSTER_FLAGS[flag]
            else:
                m.flags &= ~CLUSTER_FLAGS[flag]
            self._stage_map(m)
            self.mon.propose()
            return 0, f"{flag} is {'set' if prefix == 'osd set' else 'unset'}", None
        if prefix == "osd pool set-quota":
            name = cmd.get("pool")
            if name not in self.osdmap.pool_name:
                return -2, f"pool {name!r} does not exist", None
            field = cmd.get("field")
            if field not in ("max_objects", "max_bytes"):
                return -22, "field must be max_objects|max_bytes", None
            try:
                val = int(cmd["val"])
            except (KeyError, ValueError, TypeError):
                return -22, "quota wants an integer (0 clears)", None
            if val < 0:
                return -22, "quota must be >= 0", None
            m = self._working()
            pool = m.pools[m.pool_name[name]]
            setattr(pool, f"quota_{field}", val)
            if val == 0 and not (pool.quota_max_objects or
                                 pool.quota_max_bytes):
                pool.full = False
            pool.last_change = m.epoch + 1
            self._stage_map(m)
            self.mon.propose()
            return 0, f"set-quota {field}={val} on pool {name}", None
        if prefix in ("pg scrub", "pg deep-scrub", "pg repair"):
            pgid = _parse_pgid(cmd.get("pgid"))
            if pgid is None:
                return -22, f"invalid pgid {cmd.get('pgid')!r}", None
            m = self.osdmap
            if pgid.pool not in m.pools or \
                    pgid.seed >= m.pools[pgid.pool].pg_num:
                return -2, f"pg {pgid} does not exist", None
            _up, _upp, _acting, primary = m.pg_to_up_acting_osds(pgid)
            if primary < 0 or not m.is_up(primary):
                # NOT -11: that errno is the not-leader referral the
                # client retries on — the operator needs this message
                return -16, f"pg {pgid} has no live primary", None
            addr_s = m.osd_addrs.get(primary)
            if not addr_s:
                return -16, f"osd.{primary} has no address", None
            from ..osd import messages as OM
            # "pg scrub" is the shallow pass (reference semantics);
            # deep-scrub reads + digests; repair implies deep
            self._osd_send(primary, OM.MOSDScrubCommand(
                pgid=str(pgid), epoch=m.epoch,
                repair=(prefix == "pg repair"),
                deep=(prefix != "pg scrub")))
            return 0, f"instructing pg {pgid} on osd.{primary} to " \
                f"{prefix.split()[1]}", None
        if prefix == "osd pool ls":
            return 0, "", sorted(self.osdmap.pool_name)
        if prefix == "osd erasure-code-profile set":
            name = cmd["name"]
            prof = {}
            for item in cmd.get("profile", []):
                k, _, v = item.partition("=")
                prof[k] = v
            m = self._working()
            m.erasure_code_profiles[name] = prof
            self._stage_map(m)
            self.mon.propose()
            return 0, "", None
        if prefix == "osd erasure-code-profile get":
            prof = self.osdmap.erasure_code_profiles.get(cmd["name"])
            if prof is None:
                return -2, f"unknown profile {cmd['name']!r}", None
            return 0, "", prof
        if prefix == "osd erasure-code-profile ls":
            return 0, "", sorted(self.osdmap.erasure_code_profiles)
        if prefix == "osd reweight":
            # fractional override weight (reference `ceph osd
            # reweight`): 0.0..1.0 scales CRUSH acceptance without
            # touching the map hierarchy
            osd = int(cmd["id"])
            w = float(cmd["weight"])
            if not (0 <= osd < self.osdmap.max_osd):
                return -2, f"osd.{osd} does not exist", None
            if not 0.0 <= w <= 1.0:
                return -22, "weight must be in [0, 1]", None
            m = self._working()
            m.osd_weight[osd] = int(round(w * 0x10000))
            self._stage_map(m)
            self.mon.propose()
            return 0, f"reweighted osd.{osd} to {w}", None
        if prefix in ("osd out", "osd in", "osd down"):
            osd = int(cmd["ids"][0] if isinstance(cmd.get("ids"), list)
                      else cmd["ids"])
            if not (0 <= osd < self.osdmap.max_osd):
                return -2, f"osd.{osd} does not exist", None
            m = self._working()
            if prefix == "osd out":
                m.mark_out(osd)
            elif prefix == "osd in":
                m.osd_weight[osd] = 0x10000
            else:
                m.mark_down(osd)
            self._stage_map(m)
            self.mon.propose()
            return 0, f"marked {prefix.split()[1]} osd.{osd}", None
        if prefix == "osd pg-upmap-items":
            # the balancer's apply path (reference OSDMonitor command
            # of the same name): pairwise from→to placement exceptions
            pgid = _parse_pgid(cmd["pgid"])
            if pgid is None or pgid.pool not in self.osdmap.pools:
                return -2, f"invalid pgid {cmd.get('pgid')!r}", None
            pairs = [(int(a), int(b)) for a, b in cmd["mappings"]]
            for a, b in pairs:
                if not (0 <= b < self.osdmap.max_osd):
                    return -22, f"osd.{b} does not exist", None
            m = self._working()
            if pairs:
                m.pg_upmap_items[pgid] = pairs
            else:
                m.pg_upmap_items.pop(pgid, None)
            self._stage_map(m)
            self.mon.propose()
            return 0, f"set {cmd['pgid']} pg_upmap_items", None
        if prefix == "osd rm-pg-upmap-items":
            pgid = _parse_pgid(cmd["pgid"])
            m = self._working()
            if pgid is None or m.pg_upmap_items.pop(pgid, None) is None:
                return -2, f"no upmap items for {cmd.get('pgid')!r}", None
            self._stage_map(m)
            self.mon.propose()
            return 0, f"cleared {cmd['pgid']} pg_upmap_items", None
        if prefix == "osd setcrushmap":
            m = self._working()
            m.crush = crushmap_from_dict(cmd["crushmap"])
            self._stage_map(m)
            self.mon.propose()
            return 0, "set crush map", None
        if prefix == "osd enable-stretch-mode":
            # reference `ceph mon enable_stretch_mode` + the crush/pool
            # surgery deploy tooling does around it, in one command:
            # build the two-datacenter hierarchy + stretch rule, flag
            # every replicated pool is_stretch at size 4 / min_size 2
            from ..crush.map import (DATACENTER_TYPE, Rule, Step,
                                     build_stretch_map)
            sites = {s: [int(o) for o in osds]
                     for s, osds in (cmd.get("sites") or {}).items()}
            if len(sites) != 2:
                return -22, "stretch mode wants exactly 2 sites", None
            if any(len(osds) < 2 for osds in sites.values()):
                return -22, "each site needs >= 2 OSDs", None
            known = sorted(o for osds in sites.values() for o in osds)
            if len(set(known)) != len(known):
                return -22, "an OSD appears in both sites", None
            m = self._working()
            if known and known[-1] >= m.max_osd:
                return -2, f"osd.{known[-1]} does not exist", None
            m.crush = build_stretch_map(sites)
            m.crush.max_devices = m.max_osd
            # EC pools keep a usable rule id 1 (hosts within the tree)
            m.crush.rules.append(Rule(
                id=1, name="erasure_rule", type="erasure",
                steps=[Step("take", -1),
                       Step("set_chooseleaf_tries", 5),
                       Step("chooseleaf_indep", 0, 1), Step("emit")]))
            m.stretch_mode_enabled = True
            m.stretch_bucket_type = DATACENTER_TYPE
            m.stretch_sites = sites
            m.stretch_tiebreaker = str(cmd.get("tiebreaker", ""))
            for pool in m.pools.values():
                if pool.type == TYPE_REPLICATED:
                    pool.is_stretch = True
                    pool.size = 4
                    pool.min_size = 2
                    pool.stretch_min_size = 2
                    pool.crush_rule = 0
                    pool.last_change = m.epoch + 1
            self._stage_map(m)
            self.mon.propose()
            return 0, "stretch mode enabled across " \
                + "/".join(sorted(sites)), None
        if prefix == "osd stretch status":
            m = self.osdmap
            return 0, "", {
                "enabled": m.stretch_mode_enabled,
                "sites": {s: {"osds": list(o),
                              "up": m.stretch_site_up(s)}
                          for s, o in m.stretch_sites.items()},
                "tiebreaker": m.stretch_tiebreaker,
                "degraded": m.degraded_stretch_mode,
                "recovering": m.recovering_stretch_mode,
                "degraded_site": m.stretch_degraded_site}
        return None

    def _tree(self) -> dict:
        m = self.osdmap
        nodes = []
        for b in m.crush.buckets:
            if b is None:
                continue
            nodes.append({
                "id": b.id, "name": m.crush.names.get(b.id, str(b.id)),
                "type": m.crush.types.get(b.type, str(b.type)),
                "children": list(b.items)})
        for o in range(m.max_osd):
            nodes.append({
                "id": o, "name": f"osd.{o}", "type": "osd",
                "status": "up" if m.is_up(o) else "down",
                "reweight": m.osd_weight[o] / 0x10000})
        return {"nodes": nodes}


class MDSMonitor(PaxosService):
    """FSMap service: fs create/remove, MDS beacons, rank assignment,
    beacon-timeout failover (reference ``src/mon/MDSMonitor.cc``)."""

    NAME = "fsmap"
    # seconds without a beacon → MDS failed.  Not too tight: every
    # daemon in the suite shares one process and one GIL, and a long
    # JAX compile elsewhere stalls beacon threads — a 3s grace caused
    # spurious failovers (and downstream test flakes) under load
    BEACON_GRACE = 6.0

    def __init__(self, mon):
        super().__init__(mon)
        self.fsmap = FSMap()
        self.pending_fsmap: FSMap | None = None
        self.last_beacon: dict[str, float] = {}   # in-memory, leader

    def create_initial(self):
        self.fsmap.epoch = 1
        self.stage("put", 1, json.dumps(self.fsmap.to_dict()))
        self.stage("put", "last_epoch", "1")

    def on_election_start(self):
        super().on_election_start()
        self.pending_fsmap = None

    def update_from_store(self):
        epoch = self.mon.store.get_int(self.prefix, "last_epoch")
        if epoch > self.fsmap.epoch:
            blob = self.mon.store.get_str(self.prefix, epoch)
            if blob:
                d = json.loads(blob)
                self.fsmap = FSMap.from_dict(d)
                self.mon.push_map("fsmap", epoch, d)
        if self.pending_fsmap is not None and \
                self.fsmap.epoch >= self.pending_fsmap.epoch:
            self.pending_fsmap = None

    # -- staging -----------------------------------------------------------
    def _working(self) -> FSMap:
        base = self.pending_fsmap if self.pending_fsmap is not None \
            else self.fsmap
        return FSMap.from_dict(base.to_dict())

    def _stage_map(self, m: FSMap):
        m.epoch += 1
        self.stage("put", m.epoch, json.dumps(m.to_dict()))
        self.stage("put", "last_epoch", str(m.epoch))
        self.pending_fsmap = m

    @staticmethod
    def _assign_ranks(m: FSMap) -> bool:
        """Promote standbys into every unfilled rank < max_mds of
        every filesystem (the takeover path of reference
        MDSMonitor::maybe_promote_standby, multi-rank)."""
        changed = False
        for fs in m.filesystems.values():
            held = m.actives_for(fs.fscid)
            for rank in range(fs.max_mds):
                if rank in held:
                    continue
                sbs = sorted(m.standbys(), key=lambda i: i.name)
                if not sbs:
                    break
                sb = sbs[0]
                sb.state = STATE_ACTIVE
                sb.rank = rank
                sb.fscid = fs.fscid
                held[rank] = sb
                changed = True
        return changed

    # -- beacons (leader) --------------------------------------------------
    def handle_beacon(self, name: str, addr, state: str, seq):
        self.last_beacon[name] = time.monotonic()
        cur = self.pending_fsmap if self.pending_fsmap is not None \
            else self.fsmap
        known = cur.mds_info.get(name)
        if known is not None and known.addr == list(addr or []):
            return                       # steady-state heartbeat
        m = self._working()
        m.mds_info[name] = MDSInfo(name=name, addr=list(addr or []))
        self._assign_ranks(m)
        self._stage_map(m)
        self.mon.propose()

    def tick(self):
        now = time.monotonic()
        cur = self.pending_fsmap if self.pending_fsmap is not None \
            else self.fsmap
        stale = []
        for name in cur.mds_info:
            # unseen-by-this-leader entries get a fresh grace window
            self.last_beacon.setdefault(name, now)
            if now - self.last_beacon[name] > self.BEACON_GRACE:
                stale.append(name)
        # read-only probe first: copying the map 4×/sec in steady
        # state is pointless work
        needs_promotion = any(
            len(cur.actives_for(fs.fscid)) < fs.max_mds
            for fs in cur.filesystems.values()) and cur.standbys()
        if not stale and not needs_promotion:
            return
        m = self._working()
        for name in stale:
            m.mds_info.pop(name, None)
            self.last_beacon.pop(name, None)
        changed = bool(stale)
        if self._assign_ranks(m):
            changed = True
        if changed:
            self._stage_map(m)
            self.mon.propose()

    # -- commands ----------------------------------------------------------
    def dispatch_command(self, cmd):
        prefix = cmd.get("prefix", "")
        if prefix == "fs new":
            name = cmd["fs_name"]
            if self.fsmap.fs_by_name(name) is not None:
                return -17, f"filesystem {name!r} already exists", None
            osdmap = self.mon.services["osdmap"].osdmap
            pools = []
            for key in ("metadata", "data"):
                pname = cmd[key]
                if pname not in osdmap.pool_name:
                    return -2, f"pool {pname!r} does not exist", None
                pools.append(osdmap.pool_name[pname])
            m = self._working()
            fs = Filesystem(fscid=m.next_fscid, name=name,
                            metadata_pool=pools[0], data_pool=pools[1])
            m.next_fscid += 1
            m.filesystems[fs.fscid] = fs
            self._assign_ranks(m)
            self._stage_map(m)
            self.mon.propose()
            return 0, f"new fs with metadata pool {pools[0]} and " \
                      f"data pool {pools[1]}", None
        if prefix == "fs rm":
            fs = self.fsmap.fs_by_name(cmd["fs_name"])
            if fs is None:
                return -2, f"no filesystem {cmd['fs_name']!r}", None
            m = self._working()
            for info in m.mds_info.values():
                if info.fscid == fs.fscid:
                    info.state = STATE_STANDBY
                    info.rank = -1
                    info.fscid = -1
            m.filesystems.pop(fs.fscid, None)
            self._stage_map(m)
            self.mon.propose()
            return 0, f"removed filesystem {cmd['fs_name']!r}", None
        if prefix == "fs set":
            fs = self.fsmap.fs_by_name(cmd["fs_name"])
            if fs is None:
                return -2, f"no filesystem {cmd['fs_name']!r}", None
            if cmd.get("var") != "max_mds":
                return -22, f"unsupported fs var {cmd.get('var')!r}", \
                    None
            try:
                n = int(cmd["val"])
            except (KeyError, ValueError, TypeError):
                return -22, "max_mds wants an integer", None
            if not 1 <= n <= 16:
                return -22, "max_mds must be in [1, 16]", None
            m = self._working()
            m.filesystems[fs.fscid].max_mds = n
            # shrink: ranks >= n drop back to standby (the reference
            # stops+deactivates them; clients stop routing there)
            for info in m.mds_info.values():
                if info.fscid == fs.fscid and info.rank >= n:
                    info.state = STATE_STANDBY
                    info.rank = -1
                    info.fscid = -1
            self._assign_ranks(m)
            self._stage_map(m)
            self.mon.propose()
            return 0, f"max_mds = {n}", None
        if prefix == "fs ls":
            osdmap = self.mon.services["osdmap"].osdmap
            pname = {v: k for k, v in osdmap.pool_name.items()}
            return 0, "", [
                {"name": fs.name,
                 "metadata_pool": pname.get(fs.metadata_pool,
                                            fs.metadata_pool),
                 "data_pools": [pname.get(fs.data_pool, fs.data_pool)]}
                for fs in self.fsmap.filesystems.values()]
        if prefix == "fs dump":
            return 0, "", self.fsmap.to_dict()
        if prefix == "mds stat":
            # keys carry the fs name (reference "cephfs:0" style) so
            # two filesystems' rank-0 actives can't collide
            fsname = {c: fs.name
                      for c, fs in self.fsmap.filesystems.items()}
            up = {f"{fsname.get(i.fscid, i.fscid)}:mds.{i.rank}": n
                  for n, i in self.fsmap.mds_info.items()
                  if i.state == STATE_ACTIVE}
            return 0, "", {
                "epoch": self.fsmap.epoch, "up": up,
                "standby_count": len(self.fsmap.standbys())}
        return None


class MgrMonitor(PaxosService):
    """MgrMap service: mgr beacons, active/standby election, beacon-
    timeout failover (reference ``src/mon/MgrMonitor.cc``).  The map
    is a flat dict: {epoch, active_name, active_addr, standbys}."""

    NAME = "mgrmap"
    BEACON_GRACE = 6.0   # see MDSMonitor: GIL stalls must not flap

    def __init__(self, mon):
        super().__init__(mon)
        self.mgrmap: dict = {"epoch": 0, "active_name": "",
                             "active_addr": None, "standbys": []}
        self.pending_mgrmap: dict | None = None
        self.last_beacon: dict[str, float] = {}
        self._addrs: dict[str, list] = {}

    def create_initial(self):
        self.mgrmap["epoch"] = 1
        self.stage("put", 1, json.dumps(self.mgrmap))
        self.stage("put", "last_epoch", "1")

    def on_election_start(self):
        super().on_election_start()
        self.pending_mgrmap = None

    def update_from_store(self):
        epoch = self.mon.store.get_int(self.prefix, "last_epoch")
        if epoch > self.mgrmap["epoch"]:
            blob = self.mon.store.get_str(self.prefix, epoch)
            if blob:
                self.mgrmap = json.loads(blob)
                self.mon.push_map("mgrmap", epoch, self.mgrmap)
        if self.pending_mgrmap is not None and \
                self.mgrmap["epoch"] >= self.pending_mgrmap["epoch"]:
            self.pending_mgrmap = None

    def _cur(self) -> dict:
        return self.pending_mgrmap if self.pending_mgrmap is not None \
            else self.mgrmap

    def _stage_map(self, m: dict):
        m["epoch"] += 1
        self.stage("put", m["epoch"], json.dumps(m))
        self.stage("put", "last_epoch", str(m["epoch"]))
        self.pending_mgrmap = m

    def handle_beacon(self, name: str, addr, seq):
        self.last_beacon[name] = time.monotonic()
        self._addrs[name] = list(addr or [])
        cur = self._cur()
        if cur["active_name"] == name:
            # a restarted active mgr re-binds: keep its command-server
            # address current or `ceph orch` connects into the void
            if addr and list(addr) != (cur["active_addr"] or []):
                m = dict(cur, standbys=list(cur["standbys"]),
                         active_addr=list(addr))
                self._stage_map(m)
                self.mon.propose()
            return
        if name in cur["standbys"]:
            return
        m = dict(cur, standbys=list(cur["standbys"]))
        if not m["active_name"]:
            m["active_name"] = name
            m["active_addr"] = list(addr or [])
        else:
            m["standbys"].append(name)
        self._stage_map(m)
        self.mon.propose()

    def tick(self):
        now = time.monotonic()
        cur = self._cur()
        names = ([cur["active_name"]] if cur["active_name"] else []) \
            + list(cur["standbys"])
        stale = []
        for n in names:
            self.last_beacon.setdefault(n, now)
            if now - self.last_beacon[n] > self.BEACON_GRACE:
                stale.append(n)
        if not stale:
            return
        m = dict(cur, standbys=[n for n in cur["standbys"]
                                if n not in stale])
        for n in stale:
            self.last_beacon.pop(n, None)
        if m["active_name"] in stale:
            m["active_name"] = ""
            m["active_addr"] = None
        if not m["active_name"] and m["standbys"]:
            promoted = m["standbys"].pop(0)
            m["active_name"] = promoted
            m["active_addr"] = self._addrs.get(promoted)
        self._stage_map(m)
        self.mon.propose()

    def dispatch_command(self, cmd):
        prefix = cmd.get("prefix", "")
        if prefix == "mgr dump":
            return 0, "", dict(self.mgrmap)
        if prefix == "mgr stat":
            return 0, "", {"epoch": self.mgrmap["epoch"],
                           "active_name": self.mgrmap["active_name"],
                           "available": bool(self.mgrmap["active_name"]),
                           "num_standbys": len(self.mgrmap["standbys"])}
        if prefix == "mgr fail":
            cur = self._cur()
            who = cmd.get("who") or cur["active_name"]
            if who != cur["active_name"]:
                return -2, f"mgr {who!r} is not active", None
            m = dict(cur, standbys=list(cur["standbys"]),
                     active_name="", active_addr=None)
            self.last_beacon.pop(who, None)
            if m["standbys"]:
                promoted = m["standbys"].pop(0)
                m["active_name"] = promoted
                m["active_addr"] = self._addrs.get(promoted)
            self._stage_map(m)
            self.mon.propose()
            return 0, f"failed mgr {who}", None
        return None


class AuthMonitor(PaxosService):
    NAME = "auth"

    def __init__(self, mon):
        super().__init__(mon)
        self.keyring = KeyRing()

    def create_initial(self):
        key = CryptoKey()
        kr = KeyRing()
        kr.add("client.admin", key,
               caps={"mon": "allow *", "osd": "allow *"})
        self.stage("put", "keyring", kr.dump())

    def on_election_start(self):
        # the in-memory keyring may hold entities whose staged round
        # just died with the queue — an unrevertable rc=0 key nobody
        # committed.  Reload from the committed store (or start empty).
        super().on_election_start()
        self.keyring = KeyRing()
        self.update_from_store()

    def update_from_store(self):
        blob = self.mon.store.get_str(self.prefix, "keyring")
        if blob:
            self.keyring = KeyRing.load(blob)

    def dispatch_command(self, cmd):
        prefix = cmd.get("prefix", "")
        if prefix == "auth get-or-create":
            entity = cmd["entity"]
            if entity not in self.keyring:
                caps = {}
                for item in cmd.get("caps", []):
                    svc, _, cap = item.partition("=")
                    caps[svc] = cap.strip('"')
                self.keyring.add(entity, caps=caps)
                self.stage("put", "keyring", self.keyring.dump())
                self.mon.propose()
            ea = self.keyring.get(entity)
            return 0, "", {"entity": entity, "key": ea.key.to_str(),
                           "caps": ea.caps}
        if prefix == "auth get":
            entity = cmd["entity"]
            if entity not in self.keyring:
                return -2, f"no such entity {entity!r}", None
            ea = self.keyring.get(entity)
            return 0, "", {"entity": entity, "key": ea.key.to_str(),
                           "caps": ea.caps}
        if prefix == "auth ls":
            return 0, "", self.keyring.entities()
        return None


class ConfigMonitor(PaxosService):
    NAME = "config"

    def update_from_store(self):
        pass  # read-through service; nothing cached

    def dispatch_command(self, cmd):
        prefix = cmd.get("prefix", "")
        if prefix == "config-key put":
            self.stage("put", cmd["key"], str(cmd.get("val", "")))
            self.mon.propose()
            return 0, f"set {cmd['key']}", None
        if prefix == "config-key get":
            val = self.mon.store.get_str(self.prefix, cmd["key"])
            if val is None:
                return -2, f"no such key {cmd['key']!r}", None
            return 0, "", val
        if prefix == "config-key del":
            self.stage("erase", cmd["key"])
            self.mon.propose()
            return 0, f"deleted {cmd['key']}", None
        if prefix == "config-key ls":
            return 0, "", self.mon.store.keys(self.prefix)
        return None


class LogMonitor(PaxosService):
    """Paxos-backed cluster log, one ring per channel (reference
    ``LogMonitor.cc`` log channels): ``cluster`` keeps the legacy
    bare-``seq`` store keys, every other channel (``audit``) gets its
    own ``<channel>_seq`` / ``<channel>_<n>`` keyspace.  Committed
    entries are also fanned to event-stream subscribers (``ceph -w``)
    from every quorum member."""

    NAME = "log"
    CHANNELS = ("cluster", "audit")

    def __init__(self, mon):
        super().__init__(mon)
        self._staged_seq: dict[str, int] = {}  # beyond committed seq
        self._pushed_seq: dict[str, int] = {}  # last seq fanned out

    def _seq_key(self, channel: str) -> str:
        return "seq" if channel == "cluster" else f"{channel}_seq"

    def _entry_key(self, channel: str, seq: int) -> str:
        return str(seq) if channel == "cluster" else f"{channel}_{seq}"

    def on_election_start(self):
        # staged entries died with the queue; keeping their seqs would
        # commit the next entry past a permanent hole in the log
        super().on_election_start()
        self._staged_seq = {}

    def update_from_store(self):
        for channel in self.CHANNELS:
            committed = self.mon.store.get_int(
                self.prefix, self._seq_key(channel))
            if committed >= self._staged_seq.get(channel, 0):
                self._staged_seq.pop(channel, None)
            last = self._pushed_seq.get(channel)
            if last is None:
                # boot-time replay: start the live feed here, don't
                # spray the whole committed history at subscribers
                self._pushed_seq[channel] = committed
                continue
            if committed > last:
                for s in range(last + 1, committed + 1):
                    blob = self.mon.store.get_str(
                        self.prefix, self._entry_key(channel, s))
                    if blob:
                        self.mon.push_event("clog", json.loads(blob))
                self._pushed_seq[channel] = committed

    def _stage_entries(self, entries: list[dict]):
        """Append a batch at per-channel monotonic seqs, propose once."""
        by_chan: dict[str, list] = {}
        for e in entries:
            chan = e.get("channel") or "cluster"
            if chan not in self.CHANNELS:
                chan = "cluster"
            by_chan.setdefault(chan, []).append(e)
        for channel, batch in by_chan.items():
            seq = max(self.mon.store.get_int(self.prefix,
                                             self._seq_key(channel)),
                      self._staged_seq.get(channel, 0))
            for entry in batch:
                seq += 1
                self.stage("put", self._entry_key(channel, seq),
                           json.dumps(entry))
            self._staged_seq[channel] = seq
            self.stage("put", self._seq_key(channel), str(seq))
        self.mon.propose()

    def handle_log(self, entries) -> int:
        """Leader-side MLog ingest: daemon clog batches land in the
        paxos-backed ring (reference LogMonitor::preprocess_log)."""
        clean = []
        for e in entries or []:
            if not isinstance(e, dict):
                continue
            clean.append({"stamp": float(e.get("stamp") or time.time()),
                          "name": str(e.get("name") or "?"),
                          "channel": str(e.get("channel") or "cluster"),
                          "prio": str(e.get("prio") or "info"),
                          "text": str(e.get("text") or "")})
        if clean:
            self._stage_entries(clean)
        return len(clean)

    def dispatch_command(self, cmd):
        prefix = cmd.get("prefix", "")
        if prefix == "log":
            self._stage_entries([{
                "stamp": time.time(), "name": "mon",
                "channel": "cluster", "prio": "info",
                "text": cmd.get("logtext", "")}])
            return 0, "logged", None
        if prefix == "log last":
            channel = str(cmd.get("channel") or "cluster")
            if channel not in self.CHANNELS:
                return -22, f"unknown log channel {channel!r}", None
            return 0, "", self.last(int(cmd.get("num", 20)),
                                    channel=channel)
        return None

    def last(self, n: int = 20,
             channel: str = "cluster") -> list[dict]:
        """Tail of one channel's committed ring, oldest first."""
        seq = self.mon.store.get_int(self.prefix,
                                     self._seq_key(channel))
        out = []
        for s in range(max(1, seq - n + 1), seq + 1):
            blob = self.mon.store.get_str(self.prefix,
                                          self._entry_key(channel, s))
            if blob:
                out.append(json.loads(blob))
        return out


class Monitor(Dispatcher):
    def __init__(self, rank: int, monmap: MonMap,
                 store: MonitorDBStore | None = None,
                 tick_interval: float = 0.25, auth=None,
                 admin_socket_path: str | None = None):
        self.rank = rank
        self.name = f"mon.{rank}"
        self.monmap = monmap
        self.store = store if store is not None else MonitorDBStore()
        self.lock = threading.RLock()
        self.msgr = Messenger(
            self.name,
            **(auth.msgr_kwargs(self.name) if auth else {}))
        self.msgr.add_dispatcher(self)
        self.elector = Elector(
            rank, monmap.ranks(),
            tiebreaker=(monmap.tiebreaker
                        if monmap.tiebreaker >= 0 else None))
        self.paxos = Paxos(self.store, rank)
        self.paxos.on_commit = self._on_paxos_commit
        self.paxos.on_active = self._on_paxos_active
        self.services: dict[str, PaxosService] = {}
        for svc_cls in (OSDMonitor, MDSMonitor, MgrMonitor,
                        AuthMonitor, ConfigMonitor, LogMonitor,
                        HealthMonitor):
            self.services[svc_cls.NAME] = svc_cls(self)
        self._peer_cons: dict[int, object] = {}
        self.pgmap = PGMap()
        self._subs: dict[object, dict] = {}   # connection → {what: since}
        self._proposal_queue: list[bytes] = []
        # (paxos version, fn) fired once last_committed reaches version —
        # the reference's wait_for_finished_proposal: a mutating command
        # must not be answered before its round commits
        self._commit_waiters: list[tuple[int, object]] = []
        self._election_started = 0.0
        self._initial_created = False
        # observability (reference: every daemon has PerfCounters and
        # an AdminSocket — `ceph daemon mon.X perf dump`)
        from ..core.admin_socket import AdminSocket, default_path
        from ..core.perf_counters import PerfCountersBuilder
        pb = PerfCountersBuilder(self.name)
        pb.add_u64_counter("paxos_commits", "committed paxos values")
        pb.add_u64_counter("elections", "election rounds entered")
        pb.add_u64_counter("commands", "client commands dispatched")
        self.perf = pb.create_perf_counters()
        self.admin_socket = AdminSocket(
            admin_socket_path or default_path(self.name))
        self.admin_socket.register(
            "perf dump", lambda c: self.perf.dump(),
            "dump perf counters")
        self.admin_socket.register(
            "perf schema", lambda c: self.perf.schema(),
            "perf counter schema")
        self.admin_socket.register(
            "quorum_status", lambda c: {
                "quorum": self.quorum, "leader": self.elector.leader,
                "rank": self.rank, "state": self.elector.state},
            "election/quorum state")
        self.admin_socket.register(
            "mon_status", lambda c: {
                "rank": self.rank, "epoch": self.elector.epoch,
                "paxos_version": self.paxos.last_committed},
            "daemon status")
        self.timer = SafeTimer(f"{self.name}-tick")
        self._tick_interval = tick_interval
        self._tick_token = None
        self.running = False

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        addr = self.monmap.mons[self.rank]
        self.msgr.bind(addr.host, addr.port)
        self.admin_socket.start()
        self.running = True
        with self.lock:
            for svc in self.services.values():
                svc.update_from_store()
            self._start_election()
        self._tick_token = self.timer.add_event_after(
            self._tick_interval, self._tick)

    def shutdown(self):
        self.running = False
        self.timer.shutdown()
        self.admin_socket.shutdown()
        self.msgr.shutdown()
        self.store.close()

    @property
    def is_leader(self) -> bool:
        return self.elector.state == "leader"

    @property
    def quorum(self) -> list[int]:
        return self.elector.quorum

    # -- peer plumbing -----------------------------------------------------
    def _peer_send(self, rank: int, msg):
        if rank == self.rank:
            return
        con = self._peer_cons.get(rank)
        if con is None or con._closed:
            # lazy connect: we are often ON the messenger loop thread
            # (dispatch path) — a blocking connect would deadlock it
            con = self.msgr.connect_to_lazy(self.monmap.mons[rank])
            self._peer_cons[rank] = con
        try:
            con.send_message(msg)
        except ConnectionError:
            self._peer_cons.pop(rank, None)

    def _drain_outboxes(self):
        for to, payload in self.elector.outbox:
            self._peer_send(to, M.MMonElection(
                payload=json.dumps(payload)))
        self.elector.outbox = []
        for to, payload in self.paxos.outbox:
            self._peer_send(to, M.MMonPaxos(payload=json.dumps(payload)))
        self.paxos.outbox = []

    # -- election / paxos --------------------------------------------------
    def _drop_leader_state(self):
        """Leadership is in doubt or lost: every leader-side artifact
        is now invalid.  Any not-yet-committed round may be dropped (or
        superseded at the SAME version by the next leader's history), so
        a success reply would lie — fail waiters with -11 and let
        MonClient retry (services are idempotent-enough: a re-run sees
        the committed state).  Paxos leaves active/updating too: a late
        ACCEPT landing on a demoted leader whose round is still open
        must not fire a commit the new quorum never agreed to."""
        waiters, self._commit_waiters = self._commit_waiters, []
        for _v, fn in waiters:
            fn(rc=-11, outs="leadership changed, retry", outb=None)
        self._proposal_queue.clear()
        self.paxos.abort_round()
        # any staged-but-uncommitted create_initial round died with the
        # queue; let the next activation re-run it
        self._initial_created = False
        for svc in self.services.values():
            svc.on_election_start()

    def _start_election(self):
        self.perf.inc("elections")
        self._election_started = time.monotonic()
        was_leader = self.elector.state == "leader"
        self._drop_leader_state()
        self.elector.start()
        if self.elector.state == "leader" and not was_leader:
            self.paxos.leader_collect(self.elector.quorum)
        self._drain_outboxes()

    def _on_paxos_active(self):
        # fresh cluster: create initial service state the moment paxos
        # first goes active, not on the next tick — a command arriving
        # in the window between election and first tick must already
        # see the seeded maps/keyring.  A flag (reset per election)
        # rather than a queue-empty guard: an early mutating request
        # queued before activation must not starve create_initial
        if self.is_leader and self.paxos.last_committed == 0 \
                and not self._initial_created:
            self._initial_created = True
            for svc in self.services.values():
                svc.create_initial()
            self.propose()
            return
        # drain queued proposals one at a time
        if self._proposal_queue and self.is_leader:
            value = self._proposal_queue.pop(0)
            self.paxos.propose(value)
        self._drain_outboxes()

    def _on_paxos_commit(self, version: int, value: bytes):
        self.perf.inc("paxos_commits")
        rec = json.loads(value.decode())
        t = StoreTransaction()
        for kind, prefix, key, val in rec["ops"]:
            if kind == "put":
                t.put(prefix, key, val if val is not None else "")
            else:
                t.erase(prefix, key)
        if not t.empty():
            self.store.apply_transaction(t)
        svc = self.services.get(rec.get("service", ""))
        if svc:
            svc.update_from_store()
        matured = [fn for v, fn in self._commit_waiters if v <= version]
        self._commit_waiters = [(v, fn) for v, fn in self._commit_waiters
                                if v > version]
        for fn in matured:
            fn()

    def propose(self):
        """Bundle every service's pending ops into one paxos value and
        queue it (leader only; callers already hold the mon lock)."""
        for name, svc in self.services.items():
            if not svc.have_pending():
                continue
            value = json.dumps({
                "service": name,
                "ops": svc.take_pending()}).encode()
            self._proposal_queue.append(value)
        if self.paxos.is_active() and self._proposal_queue \
                and self.is_leader:
            self.paxos.propose(self._proposal_queue.pop(0))
        self._drain_outboxes()

    # -- subscriptions -----------------------------------------------------
    _MAP_MSG = {
        "osdmap": lambda epoch, p: M.MOSDMapMsg(epoch=epoch, osdmap=p),
        "fsmap": lambda epoch, p: M.MFSMapMsg(epoch=epoch, fsmap=p),
        "mgrmap": lambda epoch, p: M.MMgrMapMsg(epoch=epoch, mgrmap=p),
    }

    def push_map(self, what: str, epoch: int, payload: dict):
        """Called by services after a commit: feed subscribers."""
        make = self._MAP_MSG.get(what)
        if make is None:
            return
        dead = []
        for con, subs in self._subs.items():
            if what in subs:
                try:
                    con.send_message(make(epoch, payload))
                except ConnectionError:
                    dead.append(con)
        for con in dead:
            self._subs.pop(con, None)

    def push_event(self, kind: str, data: dict):
        """Fan one event-stream record (health transition, clog entry,
        progress update) to THIS mon's "events" subscribers — the
        `ceph -w` feed.  Paxos-backed events reach every mon through
        update_from_store; non-paxos ones ride broadcast_event."""
        dead = []
        for con, subs in self._subs.items():
            if "events" in subs:
                try:
                    con.send_message(M.MMonEvent(
                        kind=kind, data=data, stamp=time.time()))
                except ConnectionError:
                    dead.append(con)
        for con in dead:
            self._subs.pop(con, None)

    def broadcast_event(self, kind: str, data: dict):
        """Leader-side: push locally AND forward one hop to every
        quorum peer so their subscribers see it too (progress events
        don't ride paxos — same fan-out idiom as MPGStats)."""
        self.push_event(kind, data)
        for r in (self.elector.quorum or []):
            if r != self.rank:
                self._peer_send(r, M.MMonEvent(kind=kind, data=data,
                                               stamp=time.time(),
                                               fwd=1))

    # -- dispatch ----------------------------------------------------------
    def ms_dispatch(self, msg) -> bool:
        with self.lock:
            return self._dispatch_locked(msg)

    def _dispatch_locked(self, msg) -> bool:
        if isinstance(msg, M.MMonElection):
            payload = json.loads(msg.payload)
            was_leader = self.elector.state == "leader"
            was_state = self.elector.state
            was_epoch = self.elector.epoch
            self.elector.handle(payload)
            if self.elector.state == "electing" and (
                    was_state != "electing"
                    or self.elector.epoch != was_epoch):
                # joined/entered a round via dispatch: restart the
                # gather clock, or a stale _election_started makes the
                # tick's 2s restart fire immediately (same-epoch
                # re-campaign after a deferral = possible double vote)
                self._election_started = time.monotonic()
            if was_leader and self.elector.state != "leader":
                # demoted WITHOUT going through _start_election (we
                # learned of another's VICTORY, or deferred to a better
                # candidate inside elector.handle): the cleanup there
                # must still happen, or our commit waiters survive into
                # the new term and mature on the new leader's commits —
                # answering rc=0 for rounds that died with our queue
                self._drop_leader_state()
            if self.elector.state == "leader" and not was_leader:
                self.paxos.leader_collect(self.elector.quorum)
            elif self.elector.state == "peon" and was_state != "peon":
                # grace before judging the new leader's leases; an
                # out-of-quorum peon never gets one and rejoins via a
                # fresh election when this runs out
                self.paxos.lease_until = time.monotonic() + 3.0
            self._drain_outboxes()
            return True
        if isinstance(msg, M.MMonPaxos):
            self.paxos.handle(json.loads(msg.payload))
            self._drain_outboxes()
            return True
        if isinstance(msg, M.MMonCommand):
            self._handle_command(msg)
            return True
        if isinstance(msg, M.MMonPing):
            # session keepalive: echo the tid and report quorum
            # membership so pinned clients abandon an isolated mon
            in_q = self.elector.state in ("leader", "peon") and \
                self.rank in (self.elector.quorum or [])
            try:
                msg.connection.send_message(M.MMonPing(
                    tid=msg.tid, ack=1, quorum=in_q))
            except ConnectionError:
                pass
            return True
        if isinstance(msg, M.MMonSubscribe):
            subs = (json.loads(msg.what) if isinstance(msg.what, str)
                    else msg.what)
            self._subs.setdefault(msg.connection, {}).update(subs)
            # immediate catch-up push; a start epoch > 0 asks for the
            # full history range (OSDs need every interval transition
            # to build past_intervals — reference OSDs likewise fetch
            # the map range they missed before processing), start == 0
            # means "just the latest" (clients)
            osdsvc: OSDMonitor = self.services["osdmap"]
            cur = osdsvc.osdmap.epoch
            if cur >= 1:
                start = subs.get("osdmap") or 0
                try:
                    if 0 < start <= cur:
                        for e in range(start, cur):
                            blob = self.store.get_str(osdsvc.prefix, e)
                            if blob:
                                msg.connection.send_message(M.MOSDMapMsg(
                                    epoch=e, osdmap=json.loads(blob),
                                    newest=cur))
                    msg.connection.send_message(M.MOSDMapMsg(
                        epoch=cur, osdmap=osdmap_to_dict(osdsvc.osdmap),
                        newest=cur))
                except ConnectionError:
                    self._subs.pop(msg.connection, None)
            fssvc: MDSMonitor = self.services["fsmap"]
            if "fsmap" in subs and fssvc.fsmap.epoch >= 1:
                try:
                    msg.connection.send_message(M.MFSMapMsg(
                        epoch=fssvc.fsmap.epoch,
                        fsmap=fssvc.fsmap.to_dict()))
                except ConnectionError:
                    self._subs.pop(msg.connection, None)
            mgrsvc: MgrMonitor = self.services["mgrmap"]
            if "mgrmap" in subs and mgrsvc.mgrmap["epoch"] >= 1:
                try:
                    msg.connection.send_message(M.MMgrMapMsg(
                        epoch=mgrsvc.mgrmap["epoch"],
                        mgrmap=dict(mgrsvc.mgrmap)))
                except ConnectionError:
                    self._subs.pop(msg.connection, None)
            in_q = self.elector.state in ("leader", "peon") and \
                self.rank in (self.elector.quorum or [])
            if "events" in subs and in_q:
                # catch-up snapshot so a watcher joining a quiet
                # cluster knows the current rollup immediately
                # (wait_for_health_ok must not hang on HEALTH_OK).
                # Evaluated live on the leader (only it holds the
                # PGMap), not from the committed report: the commit
                # path trails the tick, and a stale HEALTH_OK here
                # would release waiters on a cluster that just went
                # unhealthy.  A live/committed mismatch also stages a
                # catch-up evaluation so the transition events the
                # watcher will block on are actually emitted.
                # Out-of-quorum mons send NO snapshot: their committed
                # report may predate the very transition the watcher
                # wants, and the keepalive will re-home the client to
                # a quorum mon that snapshots fresh.
                hsvc = self.services["health"]
                report = hsvc.report or {}
                if self.is_leader:
                    try:
                        report = hsvc._live_report()
                        if report != (hsvc.report or {}):
                            hsvc._evaluate_and_stage(time.time())
                    except Exception:   # noqa: BLE001 — mid-election
                        report = hsvc.report or {}
                data = {"state": "snapshot",
                        "status": report.get("status"),
                        "checks": [c["code"] for c in
                                   report.get("checks") or []],
                        "muted": [c["code"] for c in
                                  report.get("muted") or []]}
                try:
                    msg.connection.send_message(M.MMonEvent(
                        kind="health", data=data, stamp=time.time()))
                except ConnectionError:
                    self._subs.pop(msg.connection, None)
            return True
        if isinstance(msg, M.MMonEvent):
            # leader → peer fan-out of non-paxos events (progress):
            # re-push to OUR subscribers, never forward again
            if msg.fwd:
                self.push_event(msg.kind, msg.data)
            return True
        if isinstance(msg, M.MMgrBeacon):
            if self.is_leader:
                self.services["mgrmap"].handle_beacon(
                    msg.name, msg.addr, msg.seq)
            elif self.elector.leader is not None and not msg.fwd:
                self._peer_send(self.elector.leader, M.MMgrBeacon(
                    name=msg.name, addr=msg.addr, seq=msg.seq, fwd=1))
            return True
        if isinstance(msg, M.MMDSBeacon):
            if self.is_leader:
                self.services["fsmap"].handle_beacon(
                    msg.name, msg.addr, msg.state, msg.seq)
            elif self.elector.leader is not None and not msg.fwd:
                self._peer_send(self.elector.leader, M.MMDSBeacon(
                    name=msg.name, addr=msg.addr, state=msg.state,
                    seq=msg.seq, fwd=1))
            return True
        if isinstance(msg, M.MOSDBoot):
            # forward at most ONE hop (reference
            # Monitor::forward_request_leader): during an election two
            # non-leaders may each point at the other, and unbounded
            # forwarding would ping-pong daemon messages forever
            if self.is_leader:
                self.services["osdmap"].handle_boot(msg.osd, msg.addr)
            elif self.elector.leader is not None and not msg.fwd:
                self._peer_send(self.elector.leader,
                                M.MOSDBoot(osd=msg.osd, addr=msg.addr,
                                           fwd=1))
            return True
        if isinstance(msg, M.MOSDFailure):
            if self.is_leader:
                self.services["osdmap"].handle_failure(msg.target,
                                                       msg.reporter)
            elif self.elector.leader is not None and not msg.fwd:
                self._peer_send(self.elector.leader,
                                M.MOSDFailure(target=msg.target,
                                              reporter=msg.reporter,
                                              fwd=1))
            return True
        if isinstance(msg, M.MOSDAlive):
            if self.is_leader:
                self.services["osdmap"].handle_alive(msg.osd, msg.want)
            elif self.elector.leader is not None and not msg.fwd:
                self._peer_send(self.elector.leader,
                                M.MOSDAlive(osd=msg.osd, want=msg.want,
                                            fwd=1))
            return True
        if isinstance(msg, M.MLog):
            # batched daemon clog entries; same one-hop leader
            # forwarding as the daemon reports above
            if self.is_leader:
                self.services["log"].handle_log(msg.entries)
            elif self.elector.leader is not None and not msg.fwd:
                self._peer_send(self.elector.leader,
                                M.MLog(entries=msg.entries, fwd=1))
            return True
        if isinstance(msg, M.MPGStats):
            # every mon keeps a PGMap copy (reports fan out through
            # the leader in the reference; applying locally on any
            # receiving mon keeps `status` answerable everywhere)
            self.pgmap.apply_report(msg.osd, msg.pg_stats,
                                    msg.osd_stats)
            self.services["osdmap"].note_osd_report(msg.osd)
            if not self.is_leader and self.elector.leader is not None \
                    and not msg.fwd:
                self._peer_send(self.elector.leader, M.MPGStats(
                    osd=msg.osd, epoch=msg.epoch,
                    pg_stats=msg.pg_stats, osd_stats=msg.osd_stats,
                    fwd=1))
            return True
        return False

    def _handle_command(self, msg: M.MMonCommand):
        self.perf.inc("commands")
        cmd = msg.cmd if isinstance(msg.cmd, dict) else json.loads(msg.cmd)
        rc, outs, outb = -22, f"unknown command {cmd.get('prefix')!r}", None
        if not self.is_leader and _is_mutating(cmd):
            reply = M.MMonCommandReply(
                tid=msg.tid, rc=-11, outs="not leader",
                outb={"leader": self.elector.leader})
            msg.connection.send_message(reply)
            return
        if _is_mutating(cmd) and not self.paxos.is_writeable():
            # not writeable yet (mid-collect, or before create_initial
            # seeded the first maps): staging now would build on
            # pre-seed state — create_initial's round, staged at the
            # same epoch, would then commit right after and stomp the
            # command's ops (reference: PaxosService::dispatch waits
            # for is_writeable()).  Tell the client to retry instead.
            reply = M.MMonCommandReply(
                tid=msg.tid, rc=-11, outs="paxos recovering, retry",
                outb={"leader": self.elector.leader})
            msg.connection.send_message(reply)
            return
        if cmd.get("prefix") == "mon dump":
            rc, outs, outb = 0, "", self.monmap.to_dict()
        elif cmd.get("prefix") == "quorum_status":
            rc, outs, outb = 0, "", {
                "quorum": self.quorum, "leader": self.elector.leader,
                "rank": self.rank, "state": self.elector.state}
        elif cmd.get("prefix") == "progress publish":
            # active mgr's progress module → every mon's `ceph -w`
            # subscribers (mutating-routed here, so we ARE the leader)
            n = 0
            for ev in (cmd.get("events") or []):
                if isinstance(ev, dict):
                    self.broadcast_event("progress", ev)
                    n += 1
            rc, outs, outb = 0, f"published {n} events", None
        else:
            # a malformed command (missing key, bad type) must produce
            # a -22 reply, not an unhandled exception: the messenger
            # swallows dispatcher exceptions, so raising here would
            # leave the client waiting out its full timeout
            qlen_before = len(self._proposal_queue)
            was_updating = self.paxos.state == "updating"
            committed_before = self.paxos.last_committed
            try:
                for svc in self.services.values():
                    res = svc.dispatch_command(cmd)
                    if res is not None:
                        rc, outs, outb = res
                        break
            except (KeyError, ValueError, TypeError) as e:
                rc, outs, outb = -22, f"malformed command: {e!r}", None
            except Exception as e:   # noqa: BLE001 — other handler
                # failures are TRANSIENT states (mid-election staging,
                # half-refreshed service) or internal bugs: reply
                # EAGAIN so the client retries instead of waiting out
                # its timeout on silence or failing fast on a blip
                rc, outs, outb = -11, f"internal: {e!r}", None
            if rc == 0 and (len(self._proposal_queue) > qlen_before
                            or (not was_updating
                                and self.paxos.state == "updating")
                            or self.paxos.last_committed > committed_before
                            or any(svc.have_pending()
                                   for svc in self.services.values())):
                # the dispatch queued a paxos round ⇒ the command
                # actually mutated state (read-only commands that are
                # merely leader-routed never trip this) → audit trail.
                # On a single mon propose() commits synchronously under
                # the mon lock — the queue is drained and paxos is back
                # to "active" by the time dispatch returns — so a
                # last_committed advance (or ops still staged for the
                # next round) is equally valid mutation evidence.
                # (reference: mon audit log channel)
                self.services["log"]._stage_entries([{
                    "stamp": time.time(), "name": self.name,
                    "channel": "audit", "prio": "info",
                    "text": "from='client' cmd="
                            + json.dumps(cmd, default=str)
                            + ": dispatch"}])

        def reply(rc=rc, outs=outs, outb=outb):
            try:
                msg.connection.send_message(M.MMonCommandReply(
                    tid=msg.tid, rc=rc, outs=outs, outb=outb))
            except ConnectionError:
                pass

        outstanding = len(self._proposal_queue) + (
            1 if self.paxos.state == "updating" else 0)
        if rc == 0 and outstanding:
            # answer only once every round this command queued commits
            self._commit_waiters.append(
                (self.paxos.last_committed + outstanding, reply))
        else:
            reply()

    def ms_handle_reset(self, con):
        with self.lock:
            self._subs.pop(con, None)

    # -- tick --------------------------------------------------------------
    def _tick(self):
        if not self.running:
            return
        with self.lock:
            st = self.elector.state
            if st == "electing":
                elapsed = time.monotonic() - self._election_started
                if elapsed > 0.75:
                    # ack-gather window over: take the quorum we have
                    self.elector.finalize()
                    if self.elector.state == "leader":
                        self.paxos.leader_collect(self.elector.quorum)
                    self._drain_outboxes()
                if self.elector.state == "electing" and elapsed > 2.0:
                    self._start_election()
            elif st == "leader":
                if self.paxos.accept_timed_out():
                    # a quorum member stopped accepting: re-elect so the
                    # quorum shrinks to the live set (reference
                    # Paxos::accept_timeout → bootstrap)
                    self._start_election()
                elif self.paxos.peon_ack_stale():
                    # a quorum peon stopped acking leases: re-elect so
                    # the quorum shrinks to the live set and health
                    # reports MON_DOWN (reference lease-ack timeout)
                    self._start_election()
                elif self.paxos.is_active():
                    self.paxos.extend_lease()
                    # fallback seeding path (normally _on_paxos_active
                    # already did this); same guard so it never re-runs
                    if self.paxos.last_committed == 0 and \
                            not self._initial_created:
                        self._initial_created = True
                        for svc in self.services.values():
                            svc.create_initial()
                        self.propose()
                    elif self.paxos.last_committed > 0:
                        for svc in self.services.values():
                            svc.tick()
                self._drain_outboxes()
            elif st == "peon":
                if self.paxos.lease_expired():
                    self._start_election()
        if self.running:
            self._tick_token = self.timer.add_event_after(
                self._tick_interval, self._tick)


def _is_mutating(cmd: dict) -> bool:
    prefix = cmd.get("prefix", "")
    # NB: "status"/"health"/"pg *" are reads but deliberately NOT
    # listed — PG stats aggregate on the leader (OSD reports are
    # forwarded there), so those commands redirect to it for an
    # authoritative answer
    read_only = ("osd dump", "osd getmap", "osd tree", "osd stat",
                 "osd pool ls", "osd pool get",
                 "osd erasure-code-profile get",
                 "osd erasure-code-profile ls", "auth get", "auth ls",
                 "config-key get", "config-key ls", "log last",
                 "mon dump", "quorum_status", "fs ls", "fs dump",
                 "mds stat", "mgr dump", "mgr stat",
                 "osd stretch status")
    return prefix not in read_only
