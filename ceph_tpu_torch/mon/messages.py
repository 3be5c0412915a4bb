"""Monitor message types (reference ``src/messages/MMon*.h``,
``MOSDBoot/MOSDFailure/MOSDMap`` — SURVEY.md §3.2/§3.4).  Payloads are
JSON-in-frame: the control plane optimizes for evolvability, not bytes.

The port's copy of ``ceph_tpu.mon.messages``.
"""

from __future__ import annotations

import json

from ..msg.message import Message, register_message


class _JsonMessage(Message):
    """Base: one JSON object as payload."""

    FIELDS: tuple = ()

    def __init__(self, **kw):
        super().__init__()
        for f in self.FIELDS:
            setattr(self, f, kw.get(f))

    def encode_payload(self, enc):
        enc.string(json.dumps({f: getattr(self, f) for f in self.FIELDS}))

    def decode_payload(self, dec, version):
        data = json.loads(dec.string())
        for f in self.FIELDS:
            setattr(self, f, data.get(f))


@register_message
class MMonElection(_JsonMessage):
    TYPE = 16
    FIELDS = ("payload",)


@register_message
class MMonPaxos(_JsonMessage):
    TYPE = 17
    FIELDS = ("payload",)


@register_message
class MMonCommand(_JsonMessage):
    TYPE = 18
    FIELDS = ("tid", "cmd")       # cmd: dict with "prefix" etc.


@register_message
class MMonCommandReply(_JsonMessage):
    TYPE = 19
    FIELDS = ("tid", "rc", "outs", "outb")  # status str, output obj


@register_message
class MMonSubscribe(_JsonMessage):
    TYPE = 20
    FIELDS = ("what",)            # {"osdmap": start_epoch, ...}


@register_message
class MMonMap(_JsonMessage):
    TYPE = 21
    FIELDS = ("monmap",)


@register_message
class MOSDMapMsg(_JsonMessage):
    TYPE = 22
    # full map dict (epoch-stamped); `newest` is the mon's current
    # epoch so a subscriber replaying history (start>0 subscriptions
    # get the whole range) can tell catch-up maps from live ones
    FIELDS = ("epoch", "osdmap", "newest")


@register_message
class MOSDBoot(_JsonMessage):
    TYPE = 23
    FIELDS = ("osd", "addr", "fwd")


@register_message
class MOSDFailure(_JsonMessage):
    TYPE = 24
    FIELDS = ("target", "reporter", "fwd")


@register_message
class MOSDAlive(_JsonMessage):
    """A would-be primary asks the mon to record up_thru = want
    before it activates (reference ``src/messages/MOSDAlive.h``)."""
    TYPE = 25
    FIELDS = ("osd", "want", "fwd")


@register_message
class MMDSBeacon(_JsonMessage):
    """MDS → mon: liveness + desired state (reference
    ``src/messages/MMDSBeacon.h``).  addr is [host, port] of the MDS's
    client-facing messenger."""
    TYPE = 27
    FIELDS = ("name", "addr", "state", "seq", "fwd")


@register_message
class MFSMapMsg(_JsonMessage):
    """Mon → subscriber: full FSMap push (reference MFSMap)."""
    TYPE = 28
    FIELDS = ("epoch", "fsmap")


@register_message
class MMgrBeacon(_JsonMessage):
    """mgr → mon: liveness + address (reference
    ``src/messages/MMgrBeacon.h``)."""
    TYPE = 29
    FIELDS = ("name", "addr", "seq", "fwd")


@register_message
class MMgrMapMsg(_JsonMessage):
    """Mon → subscriber: full MgrMap push (reference MMgrMap)."""
    TYPE = 30
    FIELDS = ("epoch", "mgrmap")


@register_message
class MLog(_JsonMessage):
    """Daemon → mon: batched cluster-log entries (reference
    ``src/messages/MLog.h``).  entries: [{"stamp", "name", "channel",
    "prio", "text"}] — LogClient ships the unsent tail, LogMonitor
    commits through paxos and serves ``ceph log last``."""
    TYPE = 31
    FIELDS = ("entries", "fwd")


@register_message
class MMonEvent(_JsonMessage):
    """Mon → "events" subscriber: one live event-stream record (the
    `ceph -w` feed — reference MLog/MMonHealth pushes folded into one
    frame).  kind: "health" | "clog" | "progress"; data: the record;
    fwd set on leader→peer fan-out of non-paxos events (progress)."""
    TYPE = 32
    FIELDS = ("kind", "data", "stamp", "fwd")


@register_message
class MMonPing(_JsonMessage):
    """MonClient ↔ mon session keepalive (reference MonClient::tick
    keepalive + hunt).  Client sends ``tid``; the mon echoes it with
    ``ack=1`` and whether it currently sits in quorum — a silent or
    out-of-quorum session makes the client hunt a different mon, which
    is what lets subscribers survive a blacked-out site whose TCP
    links never reset."""
    TYPE = 33
    FIELDS = ("tid", "ack", "quorum")


@register_message
class MPGStats(_JsonMessage):
    """Primary OSD → mon: per-PG state/object counts (reference
    MPGStats → PGMap aggregation, ``src/mon/PGMap.cc``).  pg_stats:
    {pgid: {"state", "num_objects", "log_size", "last_scrub",
    "scrub_errors"}}."""
    TYPE = 26
    FIELDS = ("osd", "epoch", "pg_stats", "osd_stats", "fwd")
