"""FSMap — filesystem + MDS cluster state held by the monitors.

The port's copy of ``ceph_tpu.mds.fsmap``.

Reference behavior re-created (``src/mds/FSMap.h``, ``MDSMap.h``;
SURVEY.md §3.4/§3.9): an epoch-versioned map of filesystems (each
binding a metadata pool and a data pool) and of MDS daemons with their
rank/state (``up:active`` / ``up:standby``).  The mon's MDSMonitor
mutates it through Paxos; MDS daemons and clients subscribe to it the
way they subscribe to the OSDMap — clients find the active MDS's
address here, and a beacon timeout triggers the standby promotion that
drives failover.

Multi-rank (``max_mds`` > 1): the namespace is partitioned by
TOP-LEVEL directory — rank = crc32(top-level name) % max_mds, rank 0
owning the root itself (a static form of the reference's subtree
delegation, ``src/mds/Migrator.cc``; dynamic load-driven migration is
out of scope).  Clients route each metadata op to its subtree's rank;
each rank journals its own subtree (per-rank journal/inotable
objects) and allocates inodes from a rank-disjoint number space.
"""

from __future__ import annotations

from dataclasses import dataclass, field

STATE_STANDBY = "up:standby"
STATE_ACTIVE = "up:active"


@dataclass
class MDSInfo:
    """One registered MDS daemon (reference ``MDSMap::mds_info_t``)."""
    name: str
    addr: list          # [host, port] of its client-facing messenger
    state: str = STATE_STANDBY
    rank: int = -1      # -1 = no rank (standby)
    fscid: int = -1     # filesystem it is active for (-1 = none)

    def to_dict(self) -> dict:
        return {"name": self.name, "addr": list(self.addr),
                "state": self.state, "rank": self.rank,
                "fscid": self.fscid}

    @classmethod
    def from_dict(cls, d: dict) -> "MDSInfo":
        return cls(name=d["name"], addr=list(d["addr"]),
                   state=d["state"], rank=d["rank"], fscid=d["fscid"])


@dataclass
class Filesystem:
    """One filesystem (reference ``Filesystem`` in FSMap.h)."""
    fscid: int
    name: str
    metadata_pool: int
    data_pool: int
    max_mds: int = 1

    def to_dict(self) -> dict:
        return {"fscid": self.fscid, "name": self.name,
                "metadata_pool": self.metadata_pool,
                "data_pool": self.data_pool, "max_mds": self.max_mds}

    @classmethod
    def from_dict(cls, d: dict) -> "Filesystem":
        return cls(fscid=d["fscid"], name=d["name"],
                   metadata_pool=d["metadata_pool"],
                   data_pool=d["data_pool"],
                   max_mds=d.get("max_mds", 1))


@dataclass
class FSMap:
    epoch: int = 0
    next_fscid: int = 1
    filesystems: dict[int, Filesystem] = field(default_factory=dict)
    mds_info: dict[str, MDSInfo] = field(default_factory=dict)

    # -- queries -----------------------------------------------------------
    def fs_by_name(self, name: str) -> Filesystem | None:
        for fs in self.filesystems.values():
            if fs.name == name:
                return fs
        return None

    def active_for(self, fscid: int, rank: int = 0) -> MDSInfo | None:
        """The active MDS holding `rank` of a filesystem, if any."""
        for info in self.mds_info.values():
            if info.fscid == fscid and info.rank == rank \
                    and info.state == STATE_ACTIVE:
                return info
        return None

    def actives_for(self, fscid: int) -> dict[int, MDSInfo]:
        """rank → active MDS for a filesystem."""
        return {i.rank: i for i in self.mds_info.values()
                if i.fscid == fscid and i.state == STATE_ACTIVE}

    def standbys(self) -> list[MDSInfo]:
        return [i for i in self.mds_info.values()
                if i.state == STATE_STANDBY]

    # -- codec -------------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "epoch": self.epoch,
            "next_fscid": self.next_fscid,
            "filesystems": {str(c): fs.to_dict()
                            for c, fs in self.filesystems.items()},
            "mds_info": {n: i.to_dict()
                         for n, i in self.mds_info.items()},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FSMap":
        return cls(
            epoch=d["epoch"],
            next_fscid=d.get("next_fscid", 1),
            filesystems={int(c): Filesystem.from_dict(fd)
                         for c, fd in d.get("filesystems", {}).items()},
            mds_info={n: MDSInfo.from_dict(i)
                      for n, i in d.get("mds_info", {}).items()},
        )
