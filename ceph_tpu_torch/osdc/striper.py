"""Striper — file/image byte ranges ⇄ RADOS object extents.

The port's copy of ``ceph_tpu.osdc.striper``.

Reference behavior re-created (``src/osdc/Striper.cc`` +
``file_layout_t`` in ``src/include/fs_types.h``; SURVEY.md §6.7): a
logical byte stream is chopped into stripe units, dealt round-robin
over ``stripe_count`` objects, with each object holding
``object_size / stripe_unit`` units per object set — the layout RBD
images and CephFS files share.

The math is pure and stateless; RBD's default (stripe_count=1,
stripe_unit=object_size) degenerates to simple object chunking.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FileLayout:
    """stripe_unit/stripe_count/object_size (reference file_layout_t)."""
    stripe_unit: int = 1 << 22
    stripe_count: int = 1
    object_size: int = 1 << 22

    def validate(self):
        if self.stripe_unit <= 0 or self.stripe_count <= 0 \
                or self.object_size <= 0:
            raise ValueError("layout fields must be positive")
        if self.object_size % self.stripe_unit:
            raise ValueError("object_size must be a multiple of "
                             "stripe_unit")


@dataclass(frozen=True)
class ObjectExtent:
    """One object's slice of a logical range (reference ObjectExtent)."""
    object_no: int
    offset: int          # within the object
    length: int
    logical_offset: int  # where this slice sits in the byte stream


def file_to_extents(layout: FileLayout, offset: int,
                    length: int) -> list[ObjectExtent]:
    """Map a logical [offset, offset+length) range to object extents
    (reference ``Striper::file_to_extents``), ordered by logical
    offset."""
    layout.validate()
    su = layout.stripe_unit
    sc = layout.stripe_count
    su_per_object = layout.object_size // su
    out: list[ObjectExtent] = []
    pos = offset
    end = offset + length
    while pos < end:
        blockno = pos // su
        stripeno = blockno // sc
        stripepos = blockno % sc
        objectsetno = stripeno // su_per_object
        objectno = objectsetno * sc + stripepos
        block_off = pos % su
        obj_off = (stripeno % su_per_object) * su + block_off
        n = min(su - block_off, end - pos)
        out.append(ObjectExtent(object_no=objectno, offset=obj_off,
                                length=n, logical_offset=pos))
        pos += n
    return out
