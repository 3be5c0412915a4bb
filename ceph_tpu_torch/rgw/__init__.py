"""RGW — S3-subset object gateway over librados (SURVEY.md §3.9).

The port's copy of ``ceph_tpu.rgw`` (single zone; ``sync.py`` waits).
"""

from .gateway import RGWService, S3Client  # noqa: F401
