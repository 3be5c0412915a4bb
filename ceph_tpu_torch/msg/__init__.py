"""Messenger — the distributed communication backend (L2).

The port's copy of ``ceph_tpu.msg``.

Reference: ``src/msg/``, ``src/msg/async/`` (SURVEY.md §3.2).  The
reference's AsyncMessenger is N epoll worker threads; here one asyncio
event loop per Messenger carries all connections (the GIL makes extra
loops pure overhead), with the same externally visible contract:
per-connection ordered delivery, typed messages, authenticated and
CRC-protected frames, reconnect with session resume, fault injection.

The DATA plane does NOT ride this messenger: bulk chunks move as
tensors through the batch engine's lanes on the card.  This messenger
is the control plane (maps, peering, heartbeats, client ops).
"""

from .fault import FaultInjector, FaultRule  # noqa: F401
from .message import (MSG_REGISTRY, Message, MGenericPing,  # noqa: F401
                      MGenericReply, register_message)
from .messenger import (Connection, Dispatcher, EntityAddr,  # noqa: F401
                        Messenger)
