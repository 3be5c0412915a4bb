"""Client object layer (reference ``src/osdc/`` + ``src/librados/``;
SURVEY.md §3.8): the Objecter op engine and the librados-style API.

The port's copy of ``ceph_tpu.osdc``."""

from .objecter import Objecter
from .librados import Rados, IoCtx, Completion

__all__ = ["Objecter", "Rados", "IoCtx", "Completion"]
