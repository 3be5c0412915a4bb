"""Core services of the port: the device profiler and its histogram."""
