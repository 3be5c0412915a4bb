"""Diagnostic run of ``chip_smoke.rbd_phase``, the port's block images.

    python3 rbd_diag.py DEVICE [SIZE ORDER N_WRITES WRITE M_SIZE M_WRITES
                                M_WRITE]

Runs the smoke's ``rbd`` phase alone: on the card (DEVICE ``cuda``) it
first builds the kernels and prints the card's name and power limit;
DEVICE ``cpu`` runs the kernels' plain versions (use small sizes there,
e.g. ``1048576 16 8 4096 262144 8 4096``, ~60 s).  Without sizes it
takes the smoke's: images of ``RBD_SIZE`` at ``RBD_ORDER``,
``RBD_WRITES`` partial writes of ``RBD_WRITE``, mirror images of
``MIRROR_SIZE`` with ``MIRROR_WRITES`` writes of ``MIRROR_WRITE``.
Besides the phase's own ``[rbd]`` lines it prints one ``RESULT`` JSON
line: each step's wall and launches, the phase's wall, the engines'
sums and the mirror lag.
"""

import json
import subprocess
import sys
import time

import torch

import chip_smoke as S
from ceph_tpu_torch.kernels import build

dev = torch.device(sys.argv[1])
sizes = ([int(x) for x in sys.argv[2:9]] if len(sys.argv) > 2 else
         [S.RBD_SIZE, S.RBD_ORDER, S.RBD_WRITES, S.RBD_WRITE,
          S.MIRROR_SIZE, S.MIRROR_WRITES, S.MIRROR_WRITE])
if dev.type == "cuda":
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    build.build()
    build.library()
build.reset_counts()
t0 = time.perf_counter()
out = S.rbd_phase(dev, S.CLUSTER_MONS, S.CLUSTER_OSDS, S.CLUSTER_PG_NUM,
                  *sizes)
wall = time.perf_counter() - t0
print("RESULT " + json.dumps({
    "device": str(dev), "sizes": sizes, "wall_s": wall,
    "steps": {k: {"s": v["s"], "launches": v["launches"]}
              for k, v in out["steps"].items()},
    "launches": build.counts(), "engine": out["engine"],
    "lag_s": out["lag_s"], "objects": out["objects"]}), flush=True)
