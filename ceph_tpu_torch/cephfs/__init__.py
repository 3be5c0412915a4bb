"""CephFS client (reference ``src/client/`` + ``libcephfs.h`` —
SURVEY.md §3.9): POSIX-ish namespace ops against the active MDS, file
data striped client-side over the data pool.

The port's copy of ``ceph_tpu.cephfs``."""

from .client import CephFS  # noqa: F401
