"""bufferlist — the zero-copy byte-chain data currency.

The port's copy of ``ceph_tpu.core.buffer``.

Reference behavior re-created: ``buffer::list`` / ``buffer::ptr``
(``src/include/buffer.h``, ``src/common/buffer.cc``; SURVEY.md §3.1):
refcounted segments chained without copying; append/claim/substr share
the underlying raw buffers; ``crc32c`` over the chain; page-aligned
rebuilds for direct I/O.

Segments are ``memoryview``s over ``bytes`` or NumPy arrays, so a
chunk copied back from the card (``tensor.cpu().numpy()``) enters the
chain with no further copy, and ``to_numpy()`` hands a chain to the
device path with at most one flatten.
"""

from __future__ import annotations

import numpy as np


class BufferPtr:
    """A view into a raw buffer (buffer::ptr): (raw, offset, length)."""

    __slots__ = ("_mv",)

    def __init__(self, data, offset: int = 0, length: int | None = None):
        if isinstance(data, BufferPtr):
            mv = data._mv
        elif isinstance(data, memoryview):
            mv = data
        elif isinstance(data, np.ndarray):
            mv = memoryview(np.ascontiguousarray(data).view(np.uint8)
                            .reshape(-1))
        else:
            mv = memoryview(bytes(data) if not isinstance(
                data, (bytes, bytearray)) else data)
        mv = mv.cast("B") if mv.format != "B" else mv
        end = len(mv) if length is None else offset + length
        self._mv = mv[offset:end]

    def __len__(self) -> int:
        return len(self._mv)

    def __bytes__(self) -> bytes:
        return bytes(self._mv)

    def view(self) -> memoryview:
        return self._mv

    def substr(self, offset: int, length: int) -> "BufferPtr":
        return BufferPtr(self._mv, offset, length)


class BufferList:
    """buffer::list — an ordered chain of BufferPtr segments."""

    def __init__(self, data=None):
        self._ptrs: list[BufferPtr] = []
        self._len = 0
        if data is not None:
            self.append(data)

    # -- building ----------------------------------------------------------
    def append(self, data) -> "BufferList":
        if isinstance(data, BufferList):
            self._ptrs.extend(data._ptrs)
            self._len += data._len
        else:
            ptr = data if isinstance(data, BufferPtr) else BufferPtr(data)
            if len(ptr):
                self._ptrs.append(ptr)
                self._len += len(ptr)
        return self

    def append_zero(self, n: int):
        self.append(bytes(n))

    def claim_append(self, other: "BufferList"):
        """Move other's segments onto this chain (other emptied) —
        the no-copy handoff the OSD write path uses."""
        self._ptrs.extend(other._ptrs)
        self._len += other._len
        other._ptrs = []
        other._len = 0

    # -- inspecting --------------------------------------------------------
    def __len__(self) -> int:
        return self._len

    @property
    def num_buffers(self) -> int:
        return len(self._ptrs)

    def __bytes__(self) -> bytes:
        if len(self._ptrs) == 1:
            return bytes(self._ptrs[0])
        return b"".join(bytes(p) for p in self._ptrs)

    def __eq__(self, other) -> bool:
        if isinstance(other, (bytes, bytearray)):
            return bytes(self) == bytes(other)
        if isinstance(other, BufferList):
            return len(self) == len(other) and bytes(self) == bytes(other)
        return NotImplemented

    def to_numpy(self) -> np.ndarray:
        """Flatten to a uint8 array (one copy at most; zero-copy for a
        single-segment chain over an array)."""
        if len(self._ptrs) == 1:
            return np.frombuffer(self._ptrs[0].view(), dtype=np.uint8)
        return np.frombuffer(bytes(self), dtype=np.uint8)

    def substr_of(self, src: "BufferList", offset: int,
                  length: int) -> "BufferList":
        """Make this list a no-copy view of src[offset:offset+length]."""
        if offset + length > len(src):
            raise IndexError("substr_of out of range")
        self._ptrs = []
        self._len = 0
        pos = 0
        for ptr in src._ptrs:
            if length <= 0:
                break
            seg_end = pos + len(ptr)
            if seg_end <= offset:
                pos = seg_end
                continue
            start = max(offset - pos, 0)
            take = min(len(ptr) - start, length)
            self.append(ptr.substr(start, take))
            length -= take
            pos = seg_end
        return self

    def rebuild(self):
        """Coalesce to a single segment (buffer::list::rebuild)."""
        if len(self._ptrs) > 1:
            flat = BufferPtr(bytes(self))
            self._ptrs = [flat]

    def crc32c(self, seed: int = 0) -> int:
        """Chain checksum: true CRC-32C (Castagnoli), matching the
        reference's ``ceph_crc32c`` — RFC 3720 polynomial, chained
        across segments like a buffer::list crc."""
        from ..scrub.crc32c import crc32c      # host table walk
        crc = seed
        for ptr in self._ptrs:
            crc = crc32c(ptr.view(), crc)
        return crc & 0xFFFFFFFF

    def hexdump(self, limit: int = 256) -> str:
        data = bytes(self)[:limit]
        lines = []
        for off in range(0, len(data), 16):
            row = data[off:off + 16]
            hexs = " ".join(f"{b:02x}" for b in row)
            text = "".join(chr(b) if 32 <= b < 127 else "." for b in row)
            lines.append(f"{off:08x}  {hexs:<47}  |{text}|")
        return "\n".join(lines)
