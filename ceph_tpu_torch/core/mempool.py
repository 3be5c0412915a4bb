"""mempool — per-pool live allocation accounting.

The port's copy of ``ceph_tpu.core.mempool``.

Reference behavior re-created (``src/include/mempool.h``; SURVEY.md
§6.1): named pools track live bytes and item counts so a daemon's
memory footprint decomposes by subsystem (``ceph daemon <x>
dump_mempools``).  Pools here are plain atomic-ish counters (GIL
single-op updates) fed by the choke points that own bulk memory —
the object stores' data bytes being the dominant one at this scale.
"""

from __future__ import annotations

import threading


class Pool:
    __slots__ = ("name", "bytes", "items")

    def __init__(self, name: str):
        self.name = name
        self.bytes = 0
        self.items = 0

    def adjust(self, dbytes: int = 0, ditems: int = 0):
        self.bytes += dbytes
        self.items += ditems

    def dump(self) -> dict:
        return {"bytes": self.bytes, "items": self.items}


_lock = threading.Lock()
_pools: dict[str, Pool] = {}


def pool(name: str) -> Pool:
    p = _pools.get(name)
    if p is None:
        with _lock:
            p = _pools.setdefault(name, Pool(name))
    return p


def dump_mempools() -> dict:
    """All pools (reference `dump_mempools` admin command)."""
    return {n: p.dump() for n, p in sorted(_pools.items())}
