"""OSD side of the port: the batch engine, the OSDMap, the PG types
and the op schedulers."""
