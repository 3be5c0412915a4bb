"""OSD types: eversion, pg_info, pg_log, missing set.

The port's copy of ``ceph_tpu.osd.types``.

Reference behavior re-created (``src/osd/osd_types.{h,cc}``,
``src/osd/PGLog.{h,cc}``; SURVEY.md §3.5):

- ``eversion_t`` — (epoch, version) totally ordered pairs stamping
  every PG mutation;
- ``pg_log_entry_t`` — MODIFY/DELETE/ERROR entries keyed by object,
  carrying the request id for duplicate-op detection;
- ``PGLog`` — the bounded per-PG op journal; divergence between a
  peer's ``last_update`` and the authoritative log yields that peer's
  **missing set** (object → newest version needed), which drives
  log-based recovery instead of full backfill;
- ``pg_info_t`` — the summary peers exchange during peering.

All types are dict-round-trippable: they ride in MOSDPGNotify/Log
messages and persist in the PG's meta object, the same dual life the
reference's encode/decode gives them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# log entry ops (reference pg_log_entry_t::{MODIFY,DELETE,ERROR})
MODIFY = "modify"
DELETE = "delete"
ERROR = "error"

ZERO = (0, 0)    # eversion_t() — "nothing"


def ver_str(v: tuple[int, int]) -> str:
    return f"{v[0]}'{v[1]}"


@dataclass
class LogEntry:
    op: str                     # MODIFY | DELETE | ERROR
    oid: str
    version: tuple[int, int]    # eversion: (epoch, v)
    prior_version: tuple[int, int] = ZERO
    reqid: str = ""             # "client:tid" for dup detection
    mtime: float = 0.0

    def to_dict(self) -> dict:
        return {"op": self.op, "oid": self.oid,
                "version": list(self.version),
                "prior_version": list(self.prior_version),
                "reqid": self.reqid, "mtime": self.mtime}

    @classmethod
    def from_dict(cls, d: dict) -> "LogEntry":
        return cls(op=d["op"], oid=d["oid"],
                   version=tuple(d["version"]),
                   prior_version=tuple(d.get("prior_version", ZERO)),
                   reqid=d.get("reqid", ""), mtime=d.get("mtime", 0.0))


@dataclass
class PGInfo:
    pgid: str
    last_update: tuple[int, int] = ZERO
    last_complete: tuple[int, int] = ZERO
    log_tail: tuple[int, int] = ZERO
    same_interval_since: int = 0
    epoch_created: int = 0
    # epoch at which this PG last activated (reference
    # pg_history_t::last_epoch_started) — the cutoff for which past
    # intervals peering must still account for
    last_epoch_started: int = 0
    # EC only: which shard collections this member actually holds DATA
    # for.  After a split or pgp_num re-placement the assigned shard
    # can differ from the held one (chunk identity is positional); the
    # primary reads this to re-home reconstruction sources and to mark
    # mismatched members missing (reference: per-shard pg_info_t —
    # EC PGs are addressed as pgid.shard upstream).
    shards_held: list | None = None

    def to_dict(self) -> dict:
        return {"pgid": self.pgid,
                "last_update": list(self.last_update),
                "last_complete": list(self.last_complete),
                "log_tail": list(self.log_tail),
                "same_interval_since": self.same_interval_since,
                "epoch_created": self.epoch_created,
                "last_epoch_started": self.last_epoch_started,
                "shards_held": self.shards_held}

    @classmethod
    def from_dict(cls, d: dict) -> "PGInfo":
        return cls(pgid=d["pgid"],
                   last_update=tuple(d["last_update"]),
                   last_complete=tuple(d["last_complete"]),
                   log_tail=tuple(d.get("log_tail", ZERO)),
                   same_interval_since=d.get("same_interval_since", 0),
                   epoch_created=d.get("epoch_created", 0),
                   last_epoch_started=d.get("last_epoch_started", 0),
                   shards_held=d.get("shards_held"))


MAX_DUPS = 3000     # reference osd_pg_log_dups_tracked (default 3000)


@dataclass
class PGLog:
    """The per-PG op journal (reference ``PGLog``/``pg_log_t``)."""

    entries: list[LogEntry] = field(default_factory=list)
    tail: tuple[int, int] = ZERO      # versions ≤ tail are trimmed away
    # reqids of trimmed entries (reference pg_log_dup_t): trimming must
    # not forget which client ops already applied, or a late resend
    # re-applies them
    dups: list[tuple[str, tuple[int, int]]] = field(default_factory=list)

    @property
    def head(self) -> tuple[int, int]:
        return self.entries[-1].version if self.entries else self.tail

    def add(self, e: LogEntry):
        self.entries.append(e)

    def trim(self, to: tuple[int, int]):
        """Drop entries ≤ `to`, keeping their reqids in the bounded
        dup list (reference PGLog::trim + pg_log_dup_t).  Entries are
        version-ordered, so the cut point is a bisect, not a scan —
        trim runs on every write once the log is at its cap."""
        import bisect
        idx = bisect.bisect_right(self.entries, to,
                                  key=lambda e: e.version)
        if idx:
            for e in self.entries[:idx]:
                if e.reqid:
                    self.dups.append((e.reqid, e.version))
            if len(self.dups) > MAX_DUPS:
                del self.dups[: len(self.dups) - MAX_DUPS]
            del self.entries[:idx]
        if to > self.tail:
            self.tail = to

    def find_reqid(self, reqid: str) -> LogEntry | None:
        """Duplicate-op check (reference pg_log dup detection), also
        consulting the trimmed-dup history."""
        for e in reversed(self.entries):
            if e.reqid == reqid:
                return e
        for rid, ver in reversed(self.dups):
            if rid == reqid:
                return LogEntry(op=MODIFY, oid="", version=ver,
                                reqid=rid)
        return None

    def entries_after(self, since: tuple[int, int]) -> list[LogEntry]:
        return [e for e in self.entries if e.version > since]

    def missing_for(self, peer_last_update: tuple[int, int],
                    ) -> dict[str, tuple[int, int] | None]:
        """Objects a peer at `peer_last_update` lacks, per this
        (authoritative) log: object → newest needed version, or None
        when the newest entry is a delete (reference
        PGLog::merge_log building pg_missing_t).

        Requires ``peer_last_update >= tail`` — otherwise the journal
        no longer covers the peer's gap and backfill (full resync) is
        needed; the caller checks that."""
        missing: dict[str, tuple[int, int] | None] = {}
        for e in self.entries:
            if e.version <= peer_last_update:
                continue
            if e.op == MODIFY:
                missing[e.oid] = e.version
            elif e.op == DELETE:
                missing[e.oid] = None
        return missing

    def to_dict(self) -> dict:
        return {"tail": list(self.tail),
                "entries": [e.to_dict() for e in self.entries],
                "dups": [[r, list(v)] for r, v in self.dups]}

    @classmethod
    def from_dict(cls, d: dict) -> "PGLog":
        return cls(entries=[LogEntry.from_dict(e)
                            for e in d.get("entries", [])],
                   tail=tuple(d.get("tail", ZERO)),
                   dups=[(r, tuple(v))
                         for r, v in d.get("dups", [])])
