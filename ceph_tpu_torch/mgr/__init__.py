"""Management plane (reference ``src/mgr`` + ``src/pybind/mgr`` —
SURVEY.md §3.10).

The port's copy of ``ceph_tpu.mgr``, so far only the upmap balancer;
the mgr daemon and the exporter are not ported yet."""

from .balancer import UpmapBalancer  # noqa: F401
