"""Erasure-code subsystem of the port (counterpart of ``ceph_tpu.ec``).

- `interface`     — the plugin contract (a copy of ceph_tpu's);
- `registry`      — named plugin factory (jerasure, isa, lrc, shec,
  clay, torch_cuda);
- `jerasure`      — the jerasure plugin: GF(2^8) and bitmatrix techniques;
- `isa`           — ISA-L-equivalent plugin;
- `lrc`, `shec`   — locally-repairable and shingled codes;
- `clay`          — the coupled-layer MSR code (host numpy);
- `bitmatrix`     — liberation / liber8tion / blaum_roth on the
  ``gf2_packets`` kernel;
- `torch_backend` — the CUDA engine all matrix codes execute on.
"""

from .interface import ECError, ECProfile, ErasureCodeInterface  # noqa: F401
from .registry import create_erasure_code, list_plugins  # noqa: F401
