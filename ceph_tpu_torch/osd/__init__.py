"""OSD side of the port: the daemon, its PGs, the batch engine, the
OSDMap, the PG types and the op schedulers."""

from .osdmap import OSDMap, PGPool, PGid, ceph_stable_mod  # noqa: F401


def __getattr__(name):
    # the daemon imports the mon client, the messenger and the tools,
    # which import this package: resolve it on first use
    if name == "OSDaemon":
        from .daemon import OSDaemon
        return OSDaemon
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
