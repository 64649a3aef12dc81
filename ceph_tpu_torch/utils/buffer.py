"""BufferList: zero-copy scatter/gather buffers (the bufferlist role).

The reference's universal data primitive is ``bufferlist``
(src/include/buffer.h): every layer passes refcounted scatter/gather
views, never flat byte strings, and contiguity is materialized exactly
once — at the kernel, socket, or disk boundary. This module is that
role for the host side of the framework: a ``BufferList`` is an ordered
list of read-only ``memoryview`` segments over whatever storage the
producer already holds (``bytes``, a contiguous ``ndarray``, another
BufferList's segments). Python refcounting plays the part of
``buffer::raw``'s refcount — a view pins its underlying storage alive,
so slices alias safely with zero copies.

Design stance, mirrored from the reference:

- **Views in, views out.** ``append``/``substr``/``splice`` never copy
  payload bytes; they move ``memoryview`` references. An appended
  ``bytearray`` is the one exception — mutable storage is snapshotted,
  because a view over it could change under the reader.
- **Lazy flatten, counted.** ``tobytes()``/``__bytes__``/``flatten()``
  materialize contiguity on demand and cache the result (idempotent —
  flattening twice pays once). Every materializing flatten bumps the
  module :data:`STATS` (``bl_flattens`` / ``bl_bytes_flattened``), so
  the bench can report exactly how many bytes still cross a copy
  boundary and where the copy discipline leaks.
- **Bytes-compatible cold path.** ``len``/equality/``tobytes`` let cold
  paths treat a BufferList like bytes; hot paths iterate
  ``segments()`` and never join.

ceph_tpu_torch's own copy of ``ceph_tpu/utils/buffer.py``.
"""
from __future__ import annotations

from typing import Iterable, Iterator

__all__ = ["BufferList", "BufferStats", "STATS", "as_segments",
           "as_view"]


class BufferStats:
    """Copy-boundary accounting for the buffer plane. One module-level
    instance (:data:`STATS`) is shared by every BufferList so the bench
    can report ``bl_*`` evidence with one snapshot/reset pair."""

    __slots__ = ("flattens", "bytes_flattened")

    def __init__(self) -> None:
        self.flattens = 0        # materializing flatten calls paid
        self.bytes_flattened = 0  # payload bytes those copies moved

    def reset(self) -> None:
        self.flattens = 0
        self.bytes_flattened = 0

    def dump(self) -> dict:
        return {"bl_flattens": self.flattens,
                "bl_bytes_flattened": self.bytes_flattened}


STATS = BufferStats()


def as_view(data) -> memoryview:
    """One read-only flat byte view over ``data``, zero-copy for
    immutable/array storage; a ``bytearray`` is snapshotted (its owner
    may mutate it after handing it over)."""
    if isinstance(data, bytearray):
        data = bytes(data)
    mv = memoryview(data)
    if not mv.contiguous:
        # non-contiguous storage (a step-sliced view, a strided
        # ndarray) has no linear byte form to view: reject HERE, at
        # the producer, not at some distant flatten/join boundary
        raise ValueError(
            "BufferList needs contiguous storage (got a strided "
            "view; materialize it explicitly if a copy is intended)")
    if mv.ndim != 1 or mv.itemsize != 1:
        # contiguous ndarray (any shape/dtype) -> flat byte view
        mv = mv.cast("B")
    return mv.toreadonly()


def as_segments(data) -> list[memoryview]:
    """``data`` as a segment list without copying: a BufferList shares
    its segments, anything else becomes one view."""
    if isinstance(data, BufferList):
        return list(data._segs)
    v = as_view(data)
    return [v] if len(v) else []


class BufferList:
    """Ordered zero-copy segment list (the bufferlist role)."""

    __slots__ = ("_segs", "_len", "_flat")

    def __init__(self, data=None) -> None:
        self._segs: list[memoryview] = []
        self._len = 0
        self._flat: bytes | None = None  # cached flatten result
        if data is not None:
            self.append(data)

    # ----------------------------------------------------------- build

    def append(self, data) -> "BufferList":
        """Append ``data`` (bytes / memoryview / contiguous ndarray /
        BufferList / bytearray) as views — no payload copy except the
        bytearray snapshot documented in :func:`_as_view`."""
        segs = as_segments(data)
        if segs:
            self._segs.extend(segs)
            self._len += sum(len(s) for s in segs)
            self._flat = None
        return self

    def extend(self, items: Iterable) -> "BufferList":
        for it in items:
            self.append(it)
        return self

    # ---------------------------------------------------------- views

    def __len__(self) -> int:
        return self._len

    @property
    def num_segments(self) -> int:
        return len(self._segs)

    def segments(self) -> Iterator[memoryview]:
        """The zero-copy read API: iterate contiguous views in order."""
        return iter(self._segs)

    def snapshot(self) -> "BufferList":
        """An independent BufferList sharing this one's storage: later
        ``append``/``splice`` on either side never shows through (the
        segments themselves are read-only)."""
        out = BufferList()
        out._segs = list(self._segs)
        out._len = self._len
        out._flat = self._flat
        return out

    def substr(self, off: int, length: int) -> "BufferList":
        """Zero-copy sub-range view [off, off+length)."""
        if off < 0 or length < 0 or off + length > self._len:
            raise ValueError(
                f"substr [{off}, {off + length}) outside 0..{self._len}")
        out = BufferList()
        need = length
        for seg in self._segs:
            if need == 0:
                break
            n = len(seg)
            if off >= n:
                off -= n
                continue
            take = min(n - off, need)
            out._segs.append(seg[off : off + take])
            out._len += take
            need -= take
            off = 0
        return out

    def splice(self, off: int, length: int) -> "BufferList":
        """Remove [off, off+length) from this list and return it as its
        own BufferList — segment boundaries split as needed, payload
        bytes never move."""
        removed = self.substr(off, length)  # also validates the range
        tail = self.substr(off + length, self._len - off - length)
        head = self.substr(0, off)
        self._segs = head._segs + tail._segs
        self._len = head._len + tail._len
        self._flat = None
        return removed

    # -------------------------------------------------------- flatten

    def flatten(self) -> bytes:
        """Materialize contiguity (the kernel/socket/disk boundary op).
        Cached: a second flatten of an unchanged list is free, and a
        single-segment list that already IS bytes-backed never copies."""
        if self._flat is not None:
            return self._flat
        if not self._segs:
            self._flat = b""
            return self._flat
        if len(self._segs) == 1:
            seg = self._segs[0]
            base = seg.obj
            if type(base) is bytes and len(base) == len(seg):
                # the view covers one whole bytes object: no copy at all
                self._flat = base
                return self._flat
            STATS.flattens += 1
            STATS.bytes_flattened += len(seg)
            self._flat = bytes(seg)
            return self._flat
        STATS.flattens += 1
        STATS.bytes_flattened += self._len
        self._flat = b"".join(self._segs)
        return self._flat

    def tobytes(self) -> bytes:
        return self.flatten()

    def __bytes__(self) -> bytes:
        return self.flatten()

    # ----------------------------------------------------- conveniences

    def __eq__(self, other) -> bool:
        if isinstance(other, BufferList):
            if self._len != other._len:
                return False
            return self.flatten() == other.flatten()
        if isinstance(other, (bytes, bytearray, memoryview)):
            if self._len != len(memoryview(other).cast("B")):
                return False
            return self.flatten() == bytes(other)
        return NotImplemented

    def __repr__(self) -> str:
        return (f"BufferList(len={self._len}, "
                f"segments={len(self._segs)})")
