"""Local object store layer — port of ``ceph_tpu.os_store`` (reference
``src/os/``).

``ObjectStore`` is the transactional API every OSD writes through;
``Transaction`` is the opcode stream; ``MemStore`` is the in-RAM
implementation; ``WALStore`` adds the write-ahead log that makes it
durable, where the reference uses BlueStore.  The WAL files are byte
for byte those of ``ceph_tpu``: either package mounts the other's.
"""

from .objectstore import Collection, ObjectStore, StoreError, Transaction
from .memstore import MemStore
from .kvstore import WALStore
from .crash import CRASH_POINTS, CrashInjector, SimulatedPowerLoss

__all__ = ["Collection", "ObjectStore", "StoreError", "Transaction",
           "MemStore", "WALStore", "CRASH_POINTS", "CrashInjector",
           "SimulatedPowerLoss"]
