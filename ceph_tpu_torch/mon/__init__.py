"""Monitor pieces of the port: so far only ``MonitorDBStore``, the KV
store that ``tools.kvstore_tool`` opens."""
