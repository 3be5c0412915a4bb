"""OSD data-plane message types.

The port's copy of ``ceph_tpu.osd.messages``.

Reference: ``src/messages/MOSDOp.h``, ``MOSDOpReply.h``, ``MOSDRepOp.h``,
``MOSDRepOpReply.h``, ``MOSDPGQuery/Notify/Log.h``, ``MOSDECSubOpWrite/
Read.h`` (ECMsgTypes), ``MOSDPing.h``, push/pull recovery messages
(SURVEY.md §3.2/§3.5).  Like the mon plane, payloads are JSON-in-frame:
the framed messenger carries them; bulk chunk bytes ride hex-encoded —
the data plane moves real bulk as tensors on the card, not through
this control messenger, so wire-byte thrift here buys nothing.

Field conventions:
- ``reqid``: "client_name:tid" — the reference's osd_reqid_t, used for
  dup-op detection via the PG log.
- ``version``: [epoch, v] pairs — eversion_t.
- ``txn``: an ``os_store.Transaction.to_dict()`` opcode stream.
"""

from __future__ import annotations

from ..mon.messages import _JsonMessage
from ..msg.message import register_message


@register_message
class MOSDOp(_JsonMessage):
    """Client → primary: one object op batch (reference MOSDOp).
    ``snapc``: the writer's SnapContext {"seq", "snaps"} from the pool
    (reference SnapContext riding every write); read ops may carry a
    per-op "snapid" for snapshot reads.  ``dmc``: distributed-dmclock
    feedback {"delta", "rho"} — how many of this client's requests
    completed anywhere (delta) / under reservation (rho) since its
    last request to THIS osd (reference src/dmclock ReqParams).
    ``qos_client``: optional tenant/uid QoS tag (reference the rgw
    user riding req_state) — when set, the mClock scheduler keys its
    per-client streams by tenant instead of the wire entity, so
    noisy-neighbor isolation is per-tenant, not per-connection."""
    TYPE = 40
    FIELDS = ("tid", "client", "pgid", "oid", "epoch", "ops", "flags",
              "snapc", "dmc", "trace", "qos_client")


@register_message
class MOSDOpReply(_JsonMessage):
    """``dmc_phase``: which dmclock phase served the op —
    "reservation" or "priority" (reference PhaseType riding the
    reply) — the client's tracker feeds it back as rho.
    ``trace``: the OSD-side span ctx (``{"t","s"}``) echoed back so
    the client's wire_recv span nests under the server's trace."""
    TYPE = 41
    FIELDS = ("tid", "rc", "outs", "results", "version", "epoch",
              "dmc_phase", "trace")


@register_message
class MOSDRepOp(_JsonMessage):
    """Primary → replica: apply this transaction (ReplicatedBackend)."""
    TYPE = 42
    FIELDS = ("reqid", "pgid", "epoch", "txn", "version", "log_entries",
              "pg_info", "trace")


@register_message
class MOSDRepOpReply(_JsonMessage):
    TYPE = 43
    FIELDS = ("reqid", "pgid", "epoch", "rc", "from_osd")


@register_message
class MOSDPGQuery(_JsonMessage):
    """Primary → peer: send me your info/log (reference MOSDPGQuery;
    kind: "info" | "log"; since: eversion for log requests)."""
    TYPE = 44
    FIELDS = ("pgid", "epoch", "kind", "since", "from_osd")


@register_message
class MOSDPGNotify(_JsonMessage):
    """Peer → primary: my pg_info + my missing set (reference
    MOSDPGNotify; pg_missing_t travels with peering info)."""
    TYPE = 45
    FIELDS = ("pgid", "epoch", "info", "from_osd", "missing")


@register_message
class MOSDPGLog(_JsonMessage):
    """Log share / activation (reference MOSDPGLog): when ``activate``
    is set the receiver adopts the authoritative info+log and goes
    active.  ``missing``: the sender's own missing set (peering)."""
    TYPE = 46
    FIELDS = ("pgid", "epoch", "info", "entries", "activate",
              "from_osd", "missing")


@register_message
class MOSDECSubOpWrite(_JsonMessage):
    """Primary → shard k: write your chunk (reference MOSDECSubOpWrite)."""
    TYPE = 47
    FIELDS = ("reqid", "pgid", "shard", "epoch", "txn", "version",
              "log_entries", "pg_info", "trace")


@register_message
class MOSDECSubOpWriteReply(_JsonMessage):
    TYPE = 48
    FIELDS = ("reqid", "pgid", "shard", "epoch", "rc", "from_osd")


@register_message
class MOSDECSubOpRead(_JsonMessage):
    """Primary → shard: read chunk extents (reference MOSDECSubOpRead)."""
    TYPE = 49
    FIELDS = ("tid", "pgid", "shard", "epoch", "oid", "attrs")


@register_message
class MOSDECSubOpReadReply(_JsonMessage):
    TYPE = 50
    FIELDS = ("tid", "pgid", "shard", "epoch", "rc", "data", "attrs",
              "from_osd")


@register_message
class MOSDPing(_JsonMessage):
    """OSD↔OSD heartbeat (reference MOSDPing; kind: "ping" |
    "ping_reply")."""
    TYPE = 51
    FIELDS = ("from_osd", "epoch", "kind", "stamp")


@register_message
class MOSDPGPush(_JsonMessage):
    """Recovery push: full object (or shard chunk) state (reference
    MOSDPGPush carrying PushOp).  `clones`/`snapmap` carry the head's
    snap clones and their SnapMapper index rows — the reference's
    SnapSet-aware push (a recovered head without its clones would
    silently lose snapshot history).  `dedup`: {fp: chunk frame hex}
    for a dedup-manifested head — chunk payloads travel with the
    manifest so the target can ingest them into its own refcount
    index (decodes to None on pushes from older senders)."""
    TYPE = 52
    FIELDS = ("pgid", "epoch", "oid", "data", "attrs", "omap", "version",
              "from_osd", "pull_tid", "clones", "snapmap", "dedup")


@register_message
class MOSDPGPushReply(_JsonMessage):
    TYPE = 53
    FIELDS = ("pgid", "epoch", "oid", "from_osd")


@register_message
class MOSDPGPull(_JsonMessage):
    """Primary-missing recovery: ask a peer holding the object to push
    it back (reference MOSDPGPull carrying PullOp)."""
    TYPE = 54
    FIELDS = ("pgid", "epoch", "oid", "from_osd", "pull_tid")


@register_message
class MOSDScrubCommand(_JsonMessage):
    """Mon → primary OSD: operator-requested scrub/repair of one PG
    (reference MOSDScrub, the `ceph pg scrub|deep-scrub|repair` path;
    our scrub repairs inconsistencies it finds, so repair implies
    deep).  ``deep``: read data and verify digests/parity; a shallow
    scrub (deep falsy) compares metadata only."""
    TYPE = 70
    FIELDS = ("pgid", "epoch", "repair", "deep")


@register_message
class MOSDRepScrub(_JsonMessage):
    """Primary → acting member: build and return your scrub map for
    this PG (reference MOSDRepScrub → replica ScrubMap build).
    ``deep``: read payloads and digest them (deep scrub); shallow
    maps carry sizes/versions only.  ``trace``: the primary's scrub
    span ctx so replica map-build spans link to the sweep."""
    TYPE = 55
    FIELDS = ("pgid", "epoch", "scrub_tid", "from_osd", "deep",
              "trace")


@register_message
class MOSDRepScrubMap(_JsonMessage):
    """Acting member → primary: my scrub map (reference
    MOSDRepScrubMap).  objects: {oid: {"size", "crc", "version",
    "valid"}} — for EC shards "crc" is the chunk CRC-32C and "valid"
    is the self-check against the stored hinfo; deep EC maps also
    carry "data" (hex chunk payload) so the primary can re-run the
    erasure code across shards (parity recheck)."""
    TYPE = 56
    FIELDS = ("pgid", "epoch", "scrub_tid", "shard", "objects",
              "from_osd")


@register_message
class MWatchNotify(_JsonMessage):
    """Primary → watching client: a notify fired on an object you
    watch (reference ``src/messages/MWatchNotify.h``)."""
    TYPE = 57
    FIELDS = ("oid", "pgid", "notify_id", "watch_id", "data")


@register_message
class MWatchNotifyAck(_JsonMessage):
    """Watching client → primary: notify delivered+handled."""
    TYPE = 58
    FIELDS = ("oid", "pgid", "notify_id", "watch_id", "reply")


@register_message
class MOSDBackoff(_JsonMessage):
    """Primary → client: RADOS backoff (reference
    ``src/messages/MOSDBackoff.h``).  ``op`` is "block" or "unblock";
    a blocked client parks every op targeting (this OSD, this PG) and
    neither resends nor submits new ones until the matching unblock
    (or a map advance re-targets the PG).  Sent instead of silently
    queueing when the PG cannot serve (not active / below min_size) —
    the server-directed alternative to a client resend storm."""
    TYPE = 71
    FIELDS = ("pgid", "id", "op", "epoch")


@register_message
class MOSDPGBackfillPrune(_JsonMessage):
    """Primary → backfill target: the authoritative object list; the
    target removes anything extraneous (reference backfill's
    remove-extraneous pass during the scan)."""
    TYPE = 59
    FIELDS = ("pgid", "epoch", "keep", "from_osd")
