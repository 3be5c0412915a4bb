"""Typed messages — the `Message` hierarchy and registry.

The port's copy of ``ceph_tpu.msg.message``.

Reference: ``src/msg/Message.{h,cc}`` + the ~150 ``src/messages/*.h``
classes (SURVEY.md §3.2).  Each RPC is a class with a numeric TYPE;
encode/decode run through the versioned codec so message evolution
follows the same compat rules as the reference.
"""

from __future__ import annotations

from ..core.encoding import Decoder, Encoder

MSG_REGISTRY: dict[int, type["Message"]] = {}


def register_message(cls: type["Message"]) -> type["Message"]:
    if cls.TYPE in MSG_REGISTRY and MSG_REGISTRY[cls.TYPE] is not cls:
        raise ValueError(
            f"message type {cls.TYPE} already taken by "
            f"{MSG_REGISTRY[cls.TYPE].__name__}")
    MSG_REGISTRY[cls.TYPE] = cls
    return cls


class Message:
    """Base message: subclasses set TYPE and implement
    encode_payload/decode_payload; header bookkeeping (seq, priority)
    is filled by the connection."""

    TYPE = 0
    VERSION = 1
    COMPAT = 1
    PRIORITY_DEFAULT = 127
    PRIORITY_HIGH = 196

    def __init__(self):
        self.seq = 0
        self.priority = self.PRIORITY_DEFAULT
        #: set on received messages: the Connection it arrived on
        self.connection = None

    # subclass hooks ------------------------------------------------------
    def encode_payload(self, enc: Encoder):
        pass

    def decode_payload(self, dec: Decoder, version: int):
        pass

    # framing -------------------------------------------------------------
    def encode(self) -> bytes:
        enc = Encoder()
        enc.u16(self.TYPE)
        enc.u64(self.seq)
        enc.u8(self.priority)
        with enc.struct_block(self.VERSION, self.COMPAT):
            self.encode_payload(enc)
        return bytes(enc)

    @staticmethod
    def decode(data) -> "Message":
        dec = Decoder(data)
        mtype = dec.u16()
        cls = MSG_REGISTRY.get(mtype)
        if cls is None:
            raise ValueError(f"unknown message type {mtype}")
        msg = cls.__new__(cls)
        Message.__init__(msg)
        msg.seq = dec.u64()
        msg.priority = dec.u8()
        with dec.struct_block(cls.VERSION) as blk:
            msg.decode_payload(blk.dec, blk.version)
        return msg

    def __repr__(self):
        return f"{type(self).__name__}(seq={self.seq})"


@register_message
class MGenericPing(Message):
    """Generic liveness probe (the MPing shape)."""

    TYPE = 1

    def __init__(self, stamp: float = 0.0):
        super().__init__()
        self.stamp = stamp

    def encode_payload(self, enc):
        enc.f64(self.stamp)

    def decode_payload(self, dec, version):
        self.stamp = dec.f64()


@register_message
class MGenericReply(Message):
    """Generic ack carrying a JSON-ish string result (test scaffolding
    and simple control RPCs)."""

    TYPE = 2

    def __init__(self, what: str = "", result: int = 0):
        super().__init__()
        self.what = what
        self.result = result

    def encode_payload(self, enc):
        enc.string(self.what)
        enc.s32(self.result)

    def decode_payload(self, dec, version):
        self.what = dec.string()
        self.result = dec.s32()
