"""Versioned binary encoding — the wire/disk codec.

The port's copy of ``ceph_tpu.core.encoding``.

Reference behavior re-created: ``src/include/encoding.h``'s
``ENCODE_START(v, compat, bl)`` / ``DECODE_START`` / ``DECODE_FINISH``
discipline (SURVEY.md §3.1):

- every struct encodes ``(version u8, compat u8, length u32)`` then its
  payload; decoders of an older vintage skip trailing bytes of newer
  encodings, and refuse when ``compat`` exceeds what they understand —
  this is how rolling upgrades interoperate;
- little-endian fixed-width ints, length-prefixed strings/blobs,
  count-prefixed containers — matching the reference's conventions so
  struct layouts translate mechanically.

`Encoder`/`Decoder` wrap a `BufferList`; ``struct_block`` is the
ENCODE_START/FINISH pair as a context manager.
"""

from __future__ import annotations

import contextlib
import struct

from .buffer import BufferList


class DecodeError(Exception):
    pass


class Encoder:
    def __init__(self):
        self._out = bytearray()

    # -- scalars (little-endian, fixed width) ------------------------------
    def u8(self, v: int):
        self._out.append(v & 0xFF)

    def u16(self, v: int):
        self._out += struct.pack("<H", v & 0xFFFF)

    def u32(self, v: int):
        self._out += struct.pack("<I", v & 0xFFFFFFFF)

    def u64(self, v: int):
        self._out += struct.pack("<Q", v & 0xFFFFFFFFFFFFFFFF)

    def s32(self, v: int):
        self._out += struct.pack("<i", v)

    def s64(self, v: int):
        self._out += struct.pack("<q", v)

    def f64(self, v: float):
        self._out += struct.pack("<d", v)

    def boolean(self, v: bool):
        self.u8(1 if v else 0)

    # -- blobs / strings ---------------------------------------------------
    def blob(self, data):
        b = bytes(data)
        self.u32(len(b))
        self._out += b

    def string(self, s: str):
        self.blob(s.encode("utf-8"))

    def raw(self, data):
        self._out += bytes(data)

    # -- containers --------------------------------------------------------
    def list_of(self, items, enc_item):
        self.u32(len(items))
        for it in items:
            enc_item(self, it)

    def map_of(self, mapping, enc_key, enc_val):
        self.u32(len(mapping))
        for key, val in mapping.items():
            enc_key(self, key)
            enc_val(self, val)

    # -- ENCODE_START/FINISH ----------------------------------------------
    @contextlib.contextmanager
    def struct_block(self, version: int, compat: int):
        self.u8(version)
        self.u8(compat)
        len_pos = len(self._out)
        self.u32(0)  # placeholder
        yield self
        payload = len(self._out) - len_pos - 4
        self._out[len_pos:len_pos + 4] = struct.pack("<I", payload)

    # -- output ------------------------------------------------------------
    def bl(self) -> BufferList:
        return BufferList(bytes(self._out))

    def __bytes__(self) -> bytes:
        return bytes(self._out)


class Decoder:
    def __init__(self, data):
        if isinstance(data, BufferList) and data.num_buffers == 1:
            self._mv = data._ptrs[0].view()  # zero-copy single segment
        else:
            self._mv = memoryview(bytes(data))
        self._pos = 0

    def _take(self, n: int) -> memoryview:
        if self._pos + n > len(self._mv):
            raise DecodeError(
                f"buffer exhausted: need {n} at {self._pos}, "
                f"have {len(self._mv)}")
        mv = self._mv[self._pos:self._pos + n]
        self._pos += n
        return mv

    def remaining(self) -> int:
        return len(self._mv) - self._pos

    # -- scalars -----------------------------------------------------------
    def u8(self) -> int:
        return self._take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self._take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def s32(self) -> int:
        return struct.unpack("<i", self._take(4))[0]

    def s64(self) -> int:
        return struct.unpack("<q", self._take(8))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self._take(8))[0]

    def boolean(self) -> bool:
        return self.u8() != 0

    # -- blobs / strings ---------------------------------------------------
    def blob(self) -> bytes:
        n = self.u32()
        return bytes(self._take(n))

    def string(self) -> str:
        return self.blob().decode("utf-8")

    def raw(self, n: int) -> bytes:
        return bytes(self._take(n))

    # -- containers --------------------------------------------------------
    def list_of(self, dec_item) -> list:
        return [dec_item(self) for _ in range(self.u32())]

    def map_of(self, dec_key, dec_val) -> dict:
        return {dec_key(self): dec_val(self)
                for _ in range(self.u32())}

    # -- DECODE_START/FINISH ----------------------------------------------
    @contextlib.contextmanager
    def struct_block(self, understood_version: int):
        """DECODE_START(understood, bl) ... DECODE_FINISH: refuses if the
        encoder's compat exceeds what we understand; skips trailing bytes
        a newer encoder appended."""
        version = self.u8()
        compat = self.u8()
        length = self.u32()
        if compat > understood_version:
            raise DecodeError(
                f"struct compat {compat} > understood "
                f"{understood_version}")
        end = self._pos + length
        if end > len(self._mv):
            raise DecodeError("struct length overruns buffer")
        block = _Block(self, version, end)
        yield block
        if self._pos > end:
            raise DecodeError("struct overread")
        self._pos = end  # skip newer fields


class _Block:
    """Handle yielded inside a struct_block: exposes the encoded version
    (so decoders can gate per-field reads) and bounds."""

    def __init__(self, dec: Decoder, version: int, end: int):
        self.dec = dec
        self.version = version
        self._end = end

    def has_more(self) -> bool:
        return self.dec._pos < self._end
