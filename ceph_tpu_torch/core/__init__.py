"""Core services of the port: config and options, perf counters, the
tracer, the device profiler, the flight recorder and the threading
primitives."""
