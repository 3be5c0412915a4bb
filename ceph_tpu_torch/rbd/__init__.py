"""RBD — block images striped over RADOS objects (SURVEY.md §3.9).

The port's copy of ``ceph_tpu.rbd``: images and ``rbd-mirror``.
"""

from .image import Image, RBD, ImageNotFound  # noqa: F401
