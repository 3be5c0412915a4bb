"""Core services of the port: config and options, perf counters, the
tracer, the device profiler, the flight recorder, the threading
primitives, the bufferlist, the wire encoding, auth, the admin socket,
the cluster-log client, the subsystem log, the formatters, lockdep, the
top-K sketches, the op tracker and ``CephContext``."""
