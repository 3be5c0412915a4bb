"""Diagnostic run of ``chip_smoke.cephfs_phase``, the port's file system.

    python3 cephfs_diag.py DEVICE [OBJ N_DIRS N_FILES N_WHOLE BIG_OBJS
                                   N_WRITES WRITE N_ACKED]

Runs the smoke's ``cephfs`` phase alone: on the card (DEVICE ``cuda``)
it first builds the kernels and prints the card's name and power limit;
DEVICE ``cpu`` runs the kernels' plain versions (use small sizes there,
e.g. ``65536 2 8 2 4 4 4096 4``, ~60 s).  Without sizes it takes the
smoke's: objects of ``CLUSTER_OBJ``, ``FS_DIRS`` x ``FS_FILES`` empty
files, ``FS_WHOLE`` files of one object and one of ``FS_BIG_OBJS``,
``FS_WRITES`` partial writes of ``FS_WRITE``, ``FS_ACKED`` files before
the MDS failover.  Besides the phase's own ``[cephfs]`` lines it prints
one ``RESULT`` JSON line: each step's wall and launches, the phase's
wall, the engines' sums and the failover.
"""

import json
import subprocess
import sys
import time

import torch

import chip_smoke as S
from ceph_tpu_torch.kernels import build

dev = torch.device(sys.argv[1])
sizes = ([int(x) for x in sys.argv[2:10]] if len(sys.argv) > 2 else
         [S.CLUSTER_OBJ, S.FS_DIRS, S.FS_FILES, S.FS_WHOLE, S.FS_BIG_OBJS,
          S.FS_WRITES, S.FS_WRITE, S.FS_ACKED])
if dev.type == "cuda":
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    build.build()
    build.library()
build.reset_counts()
t0 = time.perf_counter()
out = S.cephfs_phase(dev, S.CLUSTER_MONS, S.CLUSTER_OSDS, S.CLUSTER_PG_NUM,
                     S.FS_META_PG, *sizes)
wall = time.perf_counter() - t0
print("RESULT " + json.dumps({
    "device": str(dev), "sizes": sizes, "wall_s": wall,
    "steps": {k: {"s": v["s"], "launches": v["launches"]}
              for k, v in out["steps"].items()},
    "launches": build.counts(), "engine": out["engine"],
    "failover_s": out["failover_s"], "unflushed": out["unflushed"],
    "spurious": out["spurious"], "objects": out["objects"]}), flush=True)
