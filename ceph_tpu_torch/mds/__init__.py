"""CephFS metadata layer (reference ``src/mds/`` — SURVEY.md §3.9):
the MDS daemon serves a POSIX namespace whose metadata lives in RADOS
omap dirfrags with a write-ahead journal, while file DATA flows
client→OSD directly through the striper — the MDS is never on the
data path, exactly the reference's split.

The port's copy of ``ceph_tpu.mds``."""

from .fsmap import FSMap, MDSInfo  # noqa: F401
