"""Striper: RAID-0 byte-extent -> object mapping (osdc/Striper.h:28-66).

The layout model mirrors file_layout_t (src/include/fs_types.h:134):
a file is cut into ``stripe_unit``-byte blocks dealt round-robin across
``stripe_count`` objects; after ``object_size/stripe_unit`` stripes the
set advances to the next group of objects. This is the framework's
sequence-parallel analog (SURVEY.md §2.5): a long byte range becomes a
batch of independent (object, offset, length) work items that fan out in
one dispatch.

TPU-first: ``file_to_extents_bulk`` is fully vectorized — the block
decomposition for millions of stripe units is a handful of numpy array
ops (and is jax-compatible: pure integer arithmetic, no data-dependent
control flow), so striping cost is O(1) python overhead per call rather
than per block. The scalar path reuses it.

ceph_tpu_torch's own copy of ``ceph_tpu/osdc/striper.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class FileLayout:
    """file_layout_t role: su/sc/os with the reference's validity rules
    (stripe_unit divides object_size; all positive)."""

    stripe_unit: int = 1 << 22
    stripe_count: int = 1
    object_size: int = 1 << 22

    def __post_init__(self):
        if self.stripe_unit <= 0 or self.stripe_count <= 0 \
                or self.object_size <= 0:
            raise ValueError("layout fields must be positive")
        if self.object_size % self.stripe_unit:
            raise ValueError(
                f"object_size {self.object_size} not a multiple of "
                f"stripe_unit {self.stripe_unit}"
            )

    @property
    def stripes_per_object(self) -> int:
        return self.object_size // self.stripe_unit

    @property
    def stripe_width(self) -> int:
        return self.stripe_unit * self.stripe_count


@dataclass
class ObjectExtent:
    """One contiguous byte range in one object, plus the buffer extents
    (offset-in-caller-buffer, length) it serves — the ObjectExtent role
    (osdc/Striper.h / include/types ObjectExtent)."""

    oid: bytes
    objectno: int
    offset: int
    length: int
    buffer_extents: list[tuple[int, int]] = field(default_factory=list)


def _block_table(layout: FileLayout, offset: int, length: int):
    """Vectorized block decomposition: for every stripe-unit-aligned
    block the range [offset, offset+len) touches, compute
    (objectno, in-object offset, in-block length, buffer offset)."""
    su = layout.stripe_unit
    sc = layout.stripe_count
    spo = layout.stripes_per_object
    end = offset + length
    first_block = offset // su
    last_block = (end - 1) // su if length else first_block
    blocknos = np.arange(first_block, last_block + 1, dtype=np.uint64)

    stripeno = blocknos // sc
    stripepos = blocknos % sc
    objectsetno = stripeno // spo
    objectno = objectsetno * sc + stripepos
    block_start = (stripeno % spo) * su

    # clip each block to the requested range
    blk_lo = blocknos * su
    lo = np.maximum(blk_lo, offset)
    hi = np.minimum(blk_lo + su, end)
    obj_off = block_start + (lo - blk_lo)
    lengths = hi - lo
    buf_off = lo - offset
    return objectno, obj_off, lengths, buf_off


def file_to_extents_bulk(layout: FileLayout, offset: int, length: int):
    """Raw arrays (objectno, object_offset, length, buffer_offset), one
    row per touched stripe-unit block, fully vectorized."""
    if length == 0:
        z = np.zeros(0, dtype=np.uint64)
        return z, z, z, z
    return _block_table(layout, offset, length)


def file_to_extents(
    layout: FileLayout,
    offset: int,
    length: int,
    object_format: str = "obj.{objectno:08x}",
) -> list[ObjectExtent]:
    """Striper::file_to_extents (Striper.cc file_to_extents role):
    coalesce the block table into per-object extents, merging adjacent
    in-object blocks the way the reference folds blocks whose object
    offset continues the previous extent."""
    objectno, obj_off, lengths, buf_off = file_to_extents_bulk(
        layout, offset, length
    )
    out: dict[int, list[ObjectExtent]] = {}
    for i in range(objectno.size):
        on = int(objectno[i])
        oo, ln, bo = int(obj_off[i]), int(lengths[i]), int(buf_off[i])
        exts = out.setdefault(on, [])
        if exts and exts[-1].offset + exts[-1].length == oo:
            exts[-1].length += ln
            exts[-1].buffer_extents.append((bo, ln))
        else:
            exts.append(
                ObjectExtent(
                    oid=object_format.format(objectno=on).encode(),
                    objectno=on,
                    offset=oo,
                    length=ln,
                    buffer_extents=[(bo, ln)],
                )
            )
    result: list[ObjectExtent] = []
    for on in sorted(out):
        result.extend(out[on])
    return result


def extent_to_file(
    layout: FileLayout, objectno: int, off: int, length: int
) -> list[tuple[int, int]]:
    """Reverse map: object byte range -> file (offset, length) runs
    (Striper::extent_to_file role)."""
    su = layout.stripe_unit
    sc = layout.stripe_count
    spo = layout.stripes_per_object
    out: list[tuple[int, int]] = []
    objectsetno = objectno // sc
    stripepos = objectno % sc
    while length > 0:
        stripe_in_obj = off // su
        block_off = off % su
        stripeno = objectsetno * spo + stripe_in_obj
        blockno = stripeno * sc + stripepos
        file_off = blockno * su + block_off
        n = min(length, su - block_off)
        if out and out[-1][0] + out[-1][1] == file_off:
            out[-1] = (out[-1][0], out[-1][1] + n)
        else:
            out.append((file_off, n))
        off += n
        length -= n
    return out


def get_num_objects(layout: FileLayout, size: int) -> int:
    """Number of objects a file of ``size`` bytes occupies
    (Striper::get_num_objects role)."""
    if size == 0:
        return 0
    sw = layout.stripe_width
    full_sets = size // (layout.object_size * layout.stripe_count)
    rest = size - full_sets * layout.object_size * layout.stripe_count
    if rest == 0:
        partial = 0
    else:
        # objects touched inside the final (possibly partial) object set
        last_stripe_units = -(-rest // layout.stripe_unit)
        partial = min(layout.stripe_count, last_stripe_units)
        # a rest larger than one stripe width touches all sc objects
        if rest > sw:
            partial = layout.stripe_count
    return int(full_sets * layout.stripe_count + partial)


class StripedReadResult:
    """Assemble per-object partial reads back into one flat buffer
    (Striper::StripedReadResult role): short object reads zero-fill
    their buffer extents, trailing zeros are trimmed by intended
    length accounting."""

    def __init__(self, total_length: int):
        self.buf = bytearray(total_length)
        self.received = 0  # bytes of real (non-hole) payload seen

    def add_partial_result(
        self, data: bytes, buffer_extents: list[tuple[int, int]]
    ) -> None:
        pos = 0
        for bo, ln in buffer_extents:
            piece = data[pos : pos + ln]
            self.buf[bo : bo + len(piece)] = piece
            self.received += len(piece)
            pos += ln

    def assemble(self) -> bytes:
        return bytes(self.buf)
