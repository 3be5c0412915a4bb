"""CephFS metadata pieces of the port: so far only ``FSMap``, the map
the monitor's ``MDSMonitor`` holds (the MDS daemon is not ported)."""

from .fsmap import FSMap, MDSInfo  # noqa: F401
