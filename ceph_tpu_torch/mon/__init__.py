"""Monitor cluster of the port — consensus and authoritative cluster
maps: ``Monitor`` with its Paxos services, ``MonClient``, and
``MonitorDBStore``, the KV store that ``tools.kvstore_tool`` opens too.

Reference: ``src/mon/`` (SURVEY.md §3.4): a small Paxos quorum holds
every authoritative map (OSDMap, monmap, auth, config); daemons and
clients subscribe for updates and send commands.
"""

from .client import MonClient  # noqa: F401
from .monitor import Monitor, MonMap  # noqa: F401
from .store import MonitorDBStore  # noqa: F401
