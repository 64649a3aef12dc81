"""Per-PG op log, info, and missing-set calculus (src/osd/PGLog.cc role).

Versions are eversions: (epoch, seq) tuples ordered lexicographically —
the primary stamps each op with its map epoch and a per-PG monotone seq,
so log order is total. The log keeps `entries` newer than `tail`; an OSD
whose last_update predates a peer's tail cannot delta-recover and needs
backfill (the same tail test PGLog::proc_replica_log does).

Simplification vs the reference, by design: writes complete only after
every live member acks (no per-op rollback/divergent-branch merge), so
authoritative-log selection reduces to "max last_update wins" and peer
logs are always prefixes of the authoritative log when tails allow delta
recovery. The reference's divergent-entry machinery (PGLog.cc
_merge_divergent_entries) guards asynchronous ack modes we do not have.

The prefix-shape invariant, precisely (round-4, tested by
test_cluster.py::test_primary_crash_mid_fanout_survivors_converge):

1. Entries a primary fanned out but never all-acked (a crash mid
   fan-out leaves them on a strict subset of members) are UNACKED —
   the client never saw success, so either surviving outcome is legal,
   but all survivors must converge to ONE of them.
2. Convergence holds because authoritative selection takes the max
   last_update among the NEW interval's members: a survivor holding
   the unacked entry becomes (or feeds) the authority and the entry
   completes everywhere; if no survivor holds it, it never existed.
3. Members never append over a gap of ALL-ACKED history: sub-ops carry
   the primary's acked head and are fenced below it (pg.py
   _subop_fenced), so a revived stale member cannot fake currency —
   it must recover through peering. Same-interval unacked gaps are
   absorbed by design (the client retry re-applies the content under
   a fresh version).

ceph_tpu_torch's own copy of ``ceph_tpu/cluster/pglog.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..utils import denc
from ..utils.buffer import BufferList

ZERO = (0, 0)

OP_MODIFY = "modify"
OP_DELETE = "delete"


@dataclass
class Entry:
    op: str  # modify | delete
    oid: bytes
    version: tuple[int, int]
    prior_version: tuple[int, int] = ZERO
    #: originating client request (entity name, tid) — rides the log so
    #: write dedup survives a primary change: the new primary rebuilds
    #: its reply cache from the log at activation (the reference keeps
    #: osd_reqid_t in pg_log_entry_t for exactly this, PGLog.cc role).
    #: ("", 0) for internal entries (clones, recovery markers).
    reqid: tuple[str, int] = ("", 0)
    #: memoized wire form — an entry is logically immutable once
    #: stamped, but every sub-op used to re-encode the WHOLE log tail
    #: through it (the round-6 profile's _persist_log seam); excluded
    #: from equality/repr
    _enc: bytes | None = field(default=None, compare=False, repr=False)

    def encode(self) -> bytes:
        if self._enc is None:
            self._enc = b"".join(
                (
                    denc.enc_str(self.op),
                    denc.enc_bytes(self.oid),
                    denc.enc_u32(self.version[0]),
                    denc.enc_u64(self.version[1]),
                    denc.enc_u32(self.prior_version[0]),
                    denc.enc_u64(self.prior_version[1]),
                    denc.enc_str(self.reqid[0]),
                    denc.enc_u64(self.reqid[1]),
                )
            )
        return self._enc

    @classmethod
    def decode(cls, buf: bytes, off: int = 0) -> tuple["Entry", int]:
        op, off = denc.dec_str(buf, off)
        oid, off = denc.dec_bytes(buf, off)
        ve, off = denc.dec_u32(buf, off)
        vs, off = denc.dec_u64(buf, off)
        pe, off = denc.dec_u32(buf, off)
        ps, off = denc.dec_u64(buf, off)
        rname, off = denc.dec_str(buf, off)
        rtid, off = denc.dec_u64(buf, off)
        return cls(op, oid, (ve, vs), (pe, ps), (rname, rtid)), off


@dataclass
class PGLog:
    tail: tuple[int, int] = ZERO  # everything <= tail is trimmed away
    entries: list[Entry] = field(default_factory=list)

    @property
    def head(self) -> tuple[int, int]:
        return self.entries[-1].version if self.entries else self.tail

    def append(self, entry: Entry) -> None:
        if entry.version <= self.head:
            raise ValueError(
                f"log entry {entry.version} not newer than head {self.head}"
            )
        self.entries.append(entry)

    def trim(self, keep: int) -> None:
        """Drop the oldest entries beyond `keep`, advancing tail."""
        drop = len(self.entries) - keep
        if drop > 0:
            self.tail = self.entries[drop - 1].version
            del self.entries[:drop]

    def entries_after(self, v: tuple[int, int]) -> list[Entry] | None:
        """Entries strictly newer than v, or None if v < tail (the peer
        is too far behind for delta recovery -> backfill)."""
        if v < self.tail:
            return None
        return [e for e in self.entries if e.version > v]

    def missing_after(self, v: tuple[int, int]) -> dict[bytes, Entry] | None:
        """Final per-object state a peer at last_update v lacks: oid ->
        newest entry. None -> backfill required."""
        delta = self.entries_after(v)
        if delta is None:
            return None
        final: dict[bytes, Entry] = {}
        for e in delta:
            final[e.oid] = e
        return final

    def encode_bl(self) -> BufferList:
        """Wire/disk form as views over the memoized entry encodings:
        persisting the log after an append costs one small header build
        plus len(entries) reference appends — not a re-encode of every
        entry per sub-op (the _persist_log seam)."""
        out = BufferList(b"".join((
            denc.enc_u32(self.tail[0]),
            denc.enc_u64(self.tail[1]),
            denc.enc_u32(len(self.entries)),
        )))
        for e in self.entries:
            out.append(e.encode())
        return out

    def encode(self) -> bytes:
        return bytes(self.encode_bl())

    @classmethod
    def decode(cls, buf: bytes, off: int = 0) -> tuple["PGLog", int]:
        te, off = denc.dec_u32(buf, off)
        ts, off = denc.dec_u64(buf, off)
        entries, off = denc.dec_list(buf, off, Entry.decode)
        return cls((te, ts), entries), off


def enc_missing(d: dict[bytes, tuple[int, int]]) -> bytes:
    """Encode a missing-set: oid -> newest version whose CONTENT this
    member lacks even though its log/head claims it (pg_missing_t
    role)."""
    out = [denc.enc_u32(len(d))]
    for oid, (e, s) in sorted(d.items()):
        out.append(denc.enc_bytes(oid))
        out.append(denc.enc_u32(e))
        out.append(denc.enc_u64(s))
    return b"".join(out)


def dec_missing(buf: bytes, off: int = 0
                ) -> tuple[dict[bytes, tuple[int, int]], int]:
    n, off = denc.dec_u32(buf, off)
    d: dict[bytes, tuple[int, int]] = {}
    for _ in range(n):
        oid, off = denc.dec_bytes(buf, off)
        e, off = denc.dec_u32(buf, off)
        s, off = denc.dec_u64(buf, off)
        d[oid] = (e, s)
    return d, off


@dataclass
class PGInfo:
    """What peering exchanges (pg_info_t role): where a member's copy
    stands, plus its log for authoritative selection and its missing
    set — objects whose content never landed despite the log position
    (head convergence over skipped unfound pushes, adopted logs whose
    reconstruct failed). The missing set is what keeps the reply-cache
    rebuild honest: a converged HEAD is not evidence of CONTENT."""

    last_update: tuple[int, int] = ZERO
    log: PGLog = field(default_factory=PGLog)
    missing: dict[bytes, tuple[int, int]] = field(default_factory=dict)

    def encode(self) -> bytes:
        return (
            denc.enc_u32(self.last_update[0])
            + denc.enc_u64(self.last_update[1])
            + self.log.encode()
            + enc_missing(self.missing)
        )

    @classmethod
    def decode(cls, buf: bytes, off: int = 0) -> tuple["PGInfo", int]:
        e, off = denc.dec_u32(buf, off)
        s, off = denc.dec_u64(buf, off)
        log, off = PGLog.decode(buf, off)
        missing, off = dec_missing(buf, off)
        return cls((e, s), log, missing), off
