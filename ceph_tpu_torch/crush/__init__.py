"""CRUSH placement, the port of ``ceph_tpu.crush``.

- ``mapper`` — the scalar oracle (``do_rule``), copied from ceph_tpu;
  it defines the semantics;
- ``torch_mapper.BatchMapper`` — the batched mapper, one K7 straw2 launch
  per descent level on the card (``straw2.py``,
  ``csrc/crush_straw2.cu``), bit-identical to the oracle;
- ``hash``, ``ln``, ``map``, ``compiler`` — copies of ceph_tpu's
  rjenkins hashes, fixed-point log, map model and text compiler.
"""

from .hash import (
    ceph_str_hash_rjenkins,
    crush_hash32,
    crush_hash32_2,
    crush_hash32_3,
    crush_hash32_4,
)
from .ln import crush_ln
from .map import (
    Bucket,
    CrushMap,
    Rule,
    Step,
    Tunables,
    build_flat_map,
    build_hierarchy,
)
from .mapper import do_rule
from .torch_mapper import BatchMapper

__all__ = [
    "crush_hash32", "crush_hash32_2", "crush_hash32_3", "crush_hash32_4",
    "ceph_str_hash_rjenkins", "crush_ln",
    "Bucket", "CrushMap", "Rule", "Step", "Tunables",
    "build_flat_map", "build_hierarchy",
    "do_rule", "BatchMapper",
]
