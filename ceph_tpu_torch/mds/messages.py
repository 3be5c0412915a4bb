"""Client ↔ MDS message types (reference ``src/messages/
MClientRequest.h`` / ``MClientReply.h`` / ``MClientSession.h`` —
SURVEY.md §3.2/§3.9).  JSON-in-frame like the mon plane: metadata RPC
is evolvability-bound, not byte-bound; the data plane never touches
the MDS.

The port's copy of ``ceph_tpu.mds.messages``; its type ids 60-62 are
free among the port's registered messages."""

from __future__ import annotations

import json

from ..msg.message import Message, register_message


class _JsonMessage(Message):
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
class MClientSession(_JsonMessage):
    """Session open/close handshake (reference MClientSession).
    op: "request_open" / "request_close" from the client,
    "open" / "close" from the MDS."""
    TYPE = 60
    FIELDS = ("op", "client", "seq")


@register_message
class MClientRequest(_JsonMessage):
    """One metadata op.  `op` names the call (mkdir/create/lookup/
    readdir/unlink/rmdir/rename/setattr/getattr), `args` its operands
    (parent ino + dentry name addressing, like the reference's
    filepath-relative ops)."""
    TYPE = 61
    FIELDS = ("tid", "client", "op", "args")


@register_message
class MClientReply(_JsonMessage):
    TYPE = 62
    FIELDS = ("tid", "rc", "outs", "result")
