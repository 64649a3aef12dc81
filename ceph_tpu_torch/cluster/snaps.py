"""Snapshot model: SnapSet, clone bookkeeping, removed-snap intervals.

The SnapContext / SnapSet / SnapMapper data model of the reference
(src/osd/osd_types.h SnapSet, src/osd/SnapMapper.h, src/common/
interval_set.h), reduced to what the lite data path needs:

- A write carries a SnapContext ``(seq, snaps)``: ``seq`` is the most
  recent snapshot id the writer has seen, ``snaps`` the existing snap
  ids in descending order (librados::IoCtx::selfmanaged_snap_set_write_ctx
  role).
- Each head object has a SnapSet: the seq at its last clone and the
  list of clones. A clone is made lazily on the first write after a new
  snap (PrimaryLogPG::make_writeable role); ``snaps`` records exactly
  which snap ids the clone preserves.
- Pool-level removed snaps are an interval set of half-open ``[lo, hi)``
  ranges (pg_pool_t::removed_snaps); snap trimming subtracts them from
  clone snap lists and deletes clones left covering nothing.

Snap id space: 1.. ; NOSNAP (reads of the head) is 2**64 - 2, matching
CEPH_NOSNAP's "biggest ordinary value" role.

ceph_tpu_torch's own copy of ``ceph_tpu/cluster/snaps.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..utils import denc

NOSNAP = 2**64 - 2


@dataclass
class Clone:
    cloneid: int                      # newest snap preserved (names the clone)
    snaps: list[int] = field(default_factory=list)  # descending, exact set
    size: int = 0                     # head size at clone time


@dataclass
class SnapSet:
    seq: int = 0                      # snap seq at the last clone
    clones: list[Clone] = field(default_factory=list)  # ascending cloneid

    def encode(self) -> bytes:
        return denc.enc_u64(self.seq) + denc.enc_list(
            self.clones,
            lambda c: (denc.enc_u64(c.cloneid)
                       + denc.enc_list(c.snaps, denc.enc_u64)
                       + denc.enc_u64(c.size)),
        )

    @classmethod
    def decode(cls, buf: bytes, off: int = 0) -> tuple["SnapSet", int]:
        seq, off = denc.dec_u64(buf, off)

        def one(b, o):
            cid, o = denc.dec_u64(b, o)
            snaps, o = denc.dec_list(b, o, denc.dec_u64)
            size, o = denc.dec_u64(b, o)
            return Clone(cid, snaps, size), o

        clones, off = denc.dec_list(buf, off, one)
        return cls(seq, clones), off

    def resolve(self, snapid: int) -> int | None:
        """Which clone serves a read at ``snapid``? Returns the cloneid,
        or NOSNAP when the head covers it (snapid newer than seq), or
        None when no copy covers that snap (the object was created
        after it, or the snap was trimmed from every clone).

        The find-first-clone->=snap walk of
        PrimaryLogPG::find_object_context, including its membership
        check: the snap must be in the clone's exact preserved set —
        reads at snaps predating the object, or trimmed out of the
        covering clone, report does-not-exist."""
        if snapid == NOSNAP:
            return NOSNAP
        for c in self.clones:
            if c.cloneid >= snapid:
                return c.cloneid if snapid in c.snaps else None
        # newer than all clones: the head serves it only if it is also
        # newer than the last clone point; otherwise that history is gone
        return NOSNAP if snapid > self.seq else None


# ----------------------------------------------------------- clone oids

#: reserved oid prefix for clone objects (the hobject_t snap-field role:
#: clones live beside the head in the same collection, under a prefix no
#: client-facing listing returns). Single-sourced from the store layer,
#: which needs it to keep clones with their heads on collection split.
from ..store.base import CLONE_PREFIX  # noqa: E402


def clone_oid(oid: bytes, cloneid: int) -> bytes:
    return CLONE_PREFIX + cloneid.to_bytes(8, "big") + b"\x00" + oid


def is_clone_oid(oid: bytes) -> bool:
    return oid.startswith(CLONE_PREFIX)


def parse_clone_oid(coid: bytes) -> tuple[bytes, int]:
    """-> (head oid, cloneid)."""
    cloneid = int.from_bytes(coid[2:10], "big")
    return coid[11:], cloneid


# ------------------------------------------------------- interval sets


def interval_insert(ivals: list[tuple[int, int]], lo: int,
                    hi: int) -> list[tuple[int, int]]:
    """Union [lo, hi) into a sorted disjoint interval list."""
    out: list[tuple[int, int]] = []
    placed = False
    for a, b in ivals:
        if b < lo or a > hi:          # disjoint (touching merges)
            if a > hi and not placed:
                out.append((lo, hi))
                placed = True
            out.append((a, b))
        else:                         # overlap/adjacent: absorb
            lo, hi = min(lo, a), max(hi, b)
    if not placed:
        out.append((lo, hi))
    out.sort()
    return out


def interval_contains(ivals: list[tuple[int, int]], x: int) -> bool:
    for a, b in ivals:
        if a <= x < b:
            return True
        if a > x:
            break
    return False


def interval_diff_ids(new: list[tuple[int, int]],
                      old: list[tuple[int, int]]) -> list[int]:
    """Snap ids in ``new`` but not in ``old`` (drives trimming after a
    map change). Interval widths here are tiny (one id per removal)."""
    out = []
    for a, b in new:
        for x in range(a, b):
            if not interval_contains(old, x):
                out.append(x)
    return out
