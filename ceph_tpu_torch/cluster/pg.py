"""PG: per-placement-group op execution, backends, peering, recovery.

The PrimaryLogPG + PGBackend role (src/osd/PrimaryLogPG.cc:1987 do_op,
ReplicatedBackend.cc:465, ECBackend.cc:1539), futurized on one asyncio
reactor (the Crimson stance) instead of sharded op queues + locks.

Roles: every member OSD of a PG holds a PG instance. `shard` is -1 for
replicated members, the positional chunk index for EC members (CRUSH
indep keeps positions stable). The primary (first live member) executes
client ops, stamps log versions, fans sub-ops out, and drives peering +
recovery; replicas/shards apply sub-ops and answer info/pull requests.

TPU-first data path: EC encode goes through the owning OSD's ECBatcher —
stripes submitted in the same reactor tick are encoded as ONE batched
device dispatch (ceph_tpu_torch.ec encode_batch), the host<->device
amortization the reference cannot express (its jerasure calls are
per-stripe, ErasureCodeJerasure.cc:105). Degraded reads reconstruct via
minimum_to_decode + decode (ECBackend.cc:2405 objects_read_and_
reconstruct role); per-chunk CRC32C hinfo attrs mirror ECUtil's
hash_info and are verified on every sub-read.

Writes complete only after every live member commits (primary-copy,
all-ack), which is what keeps the PGLog calculus prefix-shaped — see
pglog.py for the consequences for peering.

ceph_tpu_torch's own copy of ``ceph_tpu/cluster/pg.py``.
"""
from __future__ import annotations

import asyncio
import os as _os
import time
from collections import OrderedDict
from typing import TYPE_CHECKING

import numpy as np

from .. import native
from ..store import NotFound
from ..store import transaction as tx
from ..store.base import PGMETA_OID
from ..utils import denc
from ..utils import trace as tr
from . import messages as M
from . import snaps as sn
from . import stripe as st
from .hedge import hedged_fanout
from .pglog import (OP_DELETE, OP_MODIFY, ZERO, Entry, PGInfo, PGLog,
                    dec_missing, enc_missing)


def _trace_ctx() -> tuple[int, int]:
    """Ambient span ctx for outgoing sub-ops (pg_trace threading,
    ECBackend.cc:831-858 role)."""
    return tr.current.get()

if TYPE_CHECKING:
    from .osd import OSDLite

NONE = 0x7FFFFFFF  # placement ITEM_NONE
META_OID = PGMETA_OID  # the per-PG metadata object (store/base.py)
#: MPushOp.expect sentinel: no compare-and-swap, install unconditionally
UNCOND = (0xFFFFFFFF, 0xFFFFFFFFFFFFFFFF)

#: seconds a missing object must stay unreconstructable across peering
#: rounds before it is classified unfound and the peer's log converges
#: over the gap. Must outlast a daemon flap (kill -> revive -> osdmap):
#: a too-eager skip on several members drops an acked generation below
#: k and scrub rolls it back as orphan debris (acked-write loss).
UNFOUND_GRACE = 8.0

ATTR_V = "v"
ATTR_SIZE = "size"
ATTR_HINFO = "hinfo"
#: pgmeta attr holding the persisted missing-set (pg_missing_t role)
ATTR_PGMISS = "pgmissing"
ATTR_SS = "ss"  # head SnapSet (the SS_ATTR role)
ATTR_WHITEOUT = "wh"  # deleted head kept for its clones (snapdir role)
USER_ATTR = "u:"  # user xattr namespace within store attrs


def _is_recovery_attr(k: str) -> bool:
    """Attrs a shard read/reconstruction must carry besides the data:
    user xattrs plus the shard-invariant head metadata. A shard
    recovered without its SnapSet would later, as primary, read a
    stale snapset and mis-file clone history (an EC thrash bug)."""
    return k.startswith(USER_ATTR) or k in (ATTR_SS, ATTR_WHITEOUT)
OMAP_HDR = "_oh"


def _pad_to(arr: np.ndarray, n: int) -> np.ndarray:
    """Zero-extend a 1-D uint8 array to ``n`` bytes (view passthrough
    when already full — the view-friendly replacement for the old
    bytes.ljust copies on the staging/decode paths)."""
    if arr.size >= n:
        return arr
    out = np.zeros(n, dtype=np.uint8)
    out[: arr.size] = arr
    return out


def _pack_subruns(runs: list[tuple[int, int]]) -> bytes:
    """[(sub_chunk_offset, count)] -> packed LE u32 pairs (the
    MECSubRead.subruns wire form; a few pairs of control ints)."""
    return b"".join(o.to_bytes(4, "little") + c.to_bytes(4, "little")
                    for o, c in runs)


def _unpack_subruns(raw: bytes) -> list[tuple[int, int]]:
    a = np.frombuffer(raw, dtype="<u4").reshape(-1, 2)
    return [(int(o), int(c)) for o, c in a]


def _slice_subruns(chunk: bytes, su: int, subruns: bytes,
                   codec) -> memoryview:
    """Per-cell sub-chunk selection: for every su-cell of ``chunk``,
    keep the (offset, count) sub-chunk runs and concatenate — the
    shard-side half of the regenerating-code repair plan (the full
    cells were already hinfo-verified by the caller). Returns a view
    over the gathered storage: the reply body and the repair staging
    both consume it un-copied (buffer plane)."""
    runs = _unpack_subruns(subruns)
    subs = codec.get_sub_chunk_count()
    sc = su // subs
    arr = np.frombuffer(chunk, dtype=np.uint8)
    if arr.size % su:
        raise IOError(
            f"shard length {arr.size} not cell-aligned for sub-chunk "
            "repair")
    cells = arr.reshape(-1, su)
    parts = [cells[:, off * sc : (off + cnt) * sc] for off, cnt in runs]
    return memoryview(
        np.ascontiguousarray(np.concatenate(parts, axis=1))
        .reshape(-1)).toreadonly()


def enc_entries(entries: list[Entry]) -> bytes:
    return denc.enc_list(entries, lambda e: e.encode())


def dec_entries(buf: bytes) -> list[Entry]:
    out, _ = denc.dec_list(buf, 0, Entry.decode)
    return out

#: op-vector verbs that mutate (the CEPH_OSD_OP write-class role)
WRITE_OPS = frozenset((
    "writefull", "write", "append", "zero", "truncate", "delete",
    "create", "setxattr", "rmxattr", "omap_setkeys", "omap_rmkeys",
    "omap_setheader", "omap_clear",
))
EOPNOTSUPP = -95
EEXIST = -17
ENODATA = -61  # missing xattr (the reference's getxattr errno)


class OpError(Exception):
    """Aborts the whole op vector with an errno-style code (a failing
    op fails the transaction, PrimaryLogPG::do_osd_ops contract)."""

    def __init__(self, code: int, what: str = ""):
        super().__init__(what or str(code))
        self.code = code


class HinfoError(IOError):
    """A chunk failed its stored per-cell hinfo CRC (bit rot) — kept
    distinct from plain EIO so the read path can count it
    (ec_read_crc_err) and kick a repair."""


def _best_version_group(pool: dict, vers: dict, k: int) -> dict | None:
    """Newest version group with >= k members among fetched shards.

    The fallback when completing the newest generation to k members is
    impossible: an interrupted write fan-out leaves a minority of
    shards one version ahead — that generation was never ack-able (the
    client never saw it commit), so the newest generation that CAN
    decode (>= k same-version members) is the correct, consistent
    read; the client's retry re-applies the interrupted write. None
    when no generation has k members (genuinely unreconstructable)."""
    groups: dict[tuple, list] = {}
    for j in pool:
        groups.setdefault(vers.get(j, ZERO), []).append(j)
    ok = [v for v, members in groups.items() if len(members) >= k]
    if not ok:
        return None
    v = max(ok)
    return {j: pool[j] for j in groups[v]}


def _assemble_generation(copies: list, k: int):
    """Newest generation with >= k distinct shard positions across a
    MULTI-SOURCE candidate pool — current holders plus prior-interval
    strays, so one position may appear at several versions (unlike
    _best_version_group's one-copy-per-position dict). ``copies`` is
    [(ver, pos, chunk, size_attr or None, attrs dict)]. Returns the
    rebuilt (chunks, vers, size_attrs, attrs_by) dicts for that
    generation, or None when no generation reaches k positions."""
    groups: dict[tuple, dict[int, tuple]] = {}
    for ver, pos, chunk, size_attr, attrs in copies:
        ver = tuple(ver)
        if ver == ZERO:
            continue
        groups.setdefault(ver, {}).setdefault(
            pos, (chunk, size_attr, attrs))
    ok = [v for v, members in groups.items() if len(members) >= k]
    if not ok:
        return None
    v = max(ok)
    chunks: dict[int, bytes] = {}
    vers: dict[int, tuple[int, int]] = {}
    size_attrs: dict[int, bytes] = {}
    attrs_by: dict[int, dict] = {}
    for pos, (chunk, size_attr, attrs) in groups[v].items():
        chunks[pos] = chunk
        vers[pos] = v
        if size_attr is not None:
            size_attrs[pos] = size_attr
        attrs_by[pos] = attrs
    return chunks, vers, size_attrs, attrs_by


def enc_ver(v: tuple[int, int]) -> bytes:
    return denc.enc_u32(v[0]) + denc.enc_u64(v[1])


def dec_ver(b: bytes) -> tuple[int, int]:
    e, off = denc.dec_u32(b, 0)
    s, _ = denc.dec_u64(b, off)
    return (e, s)


class _OpState:
    """Lazy working state of one op vector (the ObjectContext role).

    Data mutations accumulate in a stripe.Overlay instead of a
    materialized copy, so a plain write never reads the object — the
    backends turn the overlay into op-granular transactions (the
    reference ships the transaction, not the object:
    ReplicatedBackend.cc:465, ECBackend.cc:1898).  Old facets (data,
    xattrs, omap) load on demand only when an op actually reads them;
    a cls call materializes everything and flips ``full_replace``.
    """

    def __init__(self, pg: "PG", oid: bytes):
        self.pg = pg
        self.oid = oid
        self.exists0 = False
        self.size0 = 0
        self.ov: st.Overlay | None = None
        self._xattrs: dict[str, bytes] | None = None
        self.xattr_muts: list[tuple] = []  # ("set", k, v) | ("rm", k)
        self._omap: dict[bytes, bytes] | None = None
        self._omap_header: bytes | None = None
        self.omap_muts: list[tuple] = []
        self._data: bytearray | None = None
        self.full_replace = False
        self.mutated = False
        self.deleted = False
        #: system-attr updates (SnapSet, whiteout) keyed by attr name
        self.sys_attrs: dict[str, bytes] = {}
        #: pending lazy clone: (clone oid, clone version)
        self.clone_req: tuple[bytes, tuple[int, int]] | None = None
        self.whiteout_delete = False
        self.was_whiteout = False

    async def init(self) -> None:
        pg, oid = self.pg, self.oid
        store = pg.osd.store
        if pg.is_ec:
            try:
                raw = store.getattr(pg.cid, oid, ATTR_SIZE)
                self.exists0 = True
                self.size0 = denc.dec_u64(raw, 0)[0]
            except Exception:
                meta = await pg._ec_remote_meta(oid)
                if meta is not None:
                    self.exists0 = True
                    self.size0, attrs = meta
                    self._xattrs = {
                        k[len(USER_ATTR):]: v for k, v in attrs.items()
                        if k.startswith(USER_ATTR)
                    }
        else:
            try:
                self.size0 = store.stat(pg.cid, oid)
                self.exists0 = True
            except NotFound:
                pass
        if self.exists0:
            try:
                store.getattr(pg.cid, oid, ATTR_WHITEOUT)
                # a deleted head kept only for its clones: invisible to
                # the op vector (reads ENOENT, writes re-create)
                self.exists0 = False
                self.size0 = 0
                self.was_whiteout = True
            except Exception:
                pass
        self.ov = st.Overlay(self.size0 if self.exists0 else 0)

    # ------------------------------------------------------- data facet

    @property
    def size(self) -> int:
        return self.ov.size

    async def materialize(self) -> bytearray:
        """Old data + overlay, loaded once; later data ops keep it in
        sync so intra-vector reads see earlier writes."""
        if self._data is None:
            if self.exists0:
                if self.pg.is_ec:
                    old, _ = await self.pg._read_ec(self.oid, 0,
                                                    self.size0)
                else:
                    old = self.pg.osd.store.read(self.pg.cid, self.oid)
            else:
                old = b""
            self._data = self.ov.apply(old)
        return self._data

    async def read_range(self, offset: int, length: int) -> bytes:
        """[offset, offset+length) (length<0 = to end). When nothing is
        materialized and no data mutation is pending, this is a ranged
        fetch — an EC object read moves O(range), not O(object)."""
        if self._data is None and self.ov.empty:
            if not self.exists0:
                return b""
            if self.pg.is_ec:
                # range clamping is _read_ec's job: our size0 came from
                # the primary's own shard attr, which may be the stale
                # one (revived primary) — _read_ec resolves the
                # authoritative size across the fetched quorum
                data, _sz = await self.pg._read_ec(self.oid, offset,
                                                   length)
                return data
            end = self.size if length < 0 else min(offset + length,
                                                   self.size)
            if end <= offset:
                return b""
            return bytes(self.pg.osd.store.read(self.pg.cid, self.oid,
                                                offset, end - offset))
        data = await self.materialize()
        if length < 0:
            return bytes(data[offset:])
        return bytes(data[offset : offset + length])

    def write(self, offset: int, payload: bytes) -> None:
        self.ov.write(offset, payload)
        if self._data is not None:
            end = offset + len(payload)
            if len(self._data) < end:
                self._data.extend(b"\0" * (end - len(self._data)))
            self._data[offset:end] = payload

    def zero(self, offset: int, length: int) -> None:
        self.ov.zero(offset, length)
        if self._data is not None:
            end = offset + length
            if len(self._data) < end:
                self._data.extend(b"\0" * (end - len(self._data)))
            self._data[offset:end] = b"\0" * length

    def truncate(self, size: int) -> None:
        self.ov.truncate(size)
        if self._data is not None:
            if size < len(self._data):
                del self._data[size:]
            else:
                self._data.extend(b"\0" * (size - len(self._data)))

    # ------------------------------------------------------ attr facets

    def xattrs(self) -> dict[str, bytes]:
        """Loaded on first READ only (blind updates just record muts);
        pending muts replay on top of the stored set."""
        if self._xattrs is None:
            pg = self.pg
            try:
                attrs = pg.osd.store.getattrs(pg.cid, self.oid)
                self._xattrs = {
                    k[len(USER_ATTR):]: v for k, v in attrs.items()
                    if k.startswith(USER_ATTR)
                }
            except NotFound:
                self._xattrs = {}
            for m_ in self.xattr_muts:
                if m_[0] == "set":
                    self._xattrs[m_[1]] = m_[2]
                else:
                    self._xattrs.pop(m_[1], None)
        return self._xattrs

    def setxattr(self, k: str, v: bytes) -> None:
        if self._xattrs is not None:
            self._xattrs[k] = v
        self.xattr_muts.append(("set", k, v))

    def rmxattr(self, k: str) -> None:
        if self._xattrs is not None:
            self._xattrs.pop(k, None)
        self.xattr_muts.append(("rm", k))

    def omap(self) -> dict[bytes, bytes]:
        if self._omap is None:
            pg = self.pg
            try:
                self._omap = pg.osd.store.omap_get(pg.cid, self.oid)
            except NotFound:
                self._omap = {}
            for kind, arg in self.omap_muts:
                if kind == "setkeys":
                    self._omap.update(arg)
                elif kind == "rmkeys":
                    for k in arg:
                        self._omap.pop(k, None)
                elif kind == "clear":
                    self._omap.clear()
        return self._omap

    def omap_header(self) -> bytes:
        if self._omap_header is None:
            pg = self.pg
            try:
                hdr = pg.osd.store.omap_get_header(pg.cid, self.oid)
            except NotFound:
                hdr = b""
            for kind, arg in self.omap_muts:
                if kind == "setheader":
                    hdr = arg
                elif kind == "clear":
                    hdr = b""
            self._omap_header = hdr
        return self._omap_header

    def omap_setkeys(self, kv: dict) -> None:
        if self._omap is not None:
            self._omap.update(kv)
        self.omap_muts.append(("setkeys", dict(kv)))

    def omap_rmkeys(self, keys) -> None:
        if self._omap is not None:
            for k in keys:
                self._omap.pop(k, None)
        self.omap_muts.append(("rmkeys", list(keys)))

    def omap_set_header(self, header: bytes) -> None:
        self._omap_header = header
        self.omap_muts.append(("setheader", header))

    def omap_clear(self) -> None:
        self._omap = {}
        self._omap_header = b""
        self.omap_muts.append(("clear", None))

    # ---------------------------------------------------- cls interface

    async def state_dict(self) -> dict:
        """Materialized full state for a cls method (objclass role)."""
        data = await self.materialize()
        return {
            "data": data,
            "xattrs": self.xattrs(),
            "omap": self.omap() if not self.pg.is_ec else {},
            "omap_header": (self.omap_header()
                            if not self.pg.is_ec else b""),
        }


class PG:
    #: EC reads cross-check ATTR_V across fetched shards and exclude
    #: version-lagging ones (the ROADMAP stale-shard fix). Class-level
    #: so the regression test can flip it off to demonstrate the seed
    #: read path serving mixed-generation cells.
    _ec_version_check = True

    def __init__(self, osd: "OSDLite", pgid: tuple[int, int], shard: int):
        self.osd = osd
        self.pgid = pgid
        self.shard = shard  # -1 replicated, else EC chunk position
        self.cid = (
            f"{pgid[0]}.{pgid[1]}"
            if shard < 0
            else f"{pgid[0]}.{pgid[1]}s{shard}"
        )
        self.log = PGLog()
        self.acting: list[int] = []
        self.primary: int = -1
        #: oid -> {(entity, cookie)} — watch state lives with the
        #: primary (the reference persists it on the object + session;
        #: lite keeps it in-memory, so clients re-watch after failover)
        self.watchers: dict[bytes, set[tuple[str, int]]] = {}
        self._notify_id = 0
        self.state = "peering"
        self.waiting: list[tuple[str, M.MOSDOp]] = []
        #: write-op dedup (the reference's reqid reply cache on the PG
        #: log, PGLog.cc / PrimaryLogPG::check_in_progress_op role): the
        #: client tick-resends in-flight ops (a write into a half-dead
        #: TCP connection is lost silently), so a duplicate (src, tid)
        #: must NOT re-execute a non-idempotent verb (append, cls index
        #: mutations) or reinstall stale content over a newer write —
        #: completed writes answer from the cache, in-flight/parked ones
        #: swallow the duplicate (the original execution will reply)
        self._req_replies: "OrderedDict[tuple, M.MOSDOpReply]" = \
            OrderedDict()
        self._req_inflight: set[tuple] = set()
        self.lock = asyncio.Lock()
        self._peer_task: asyncio.Task | None = None
        #: pg_temp migration state (acting != up): objects whose full
        #: state is KNOWN to be on every incoming up member (base push
        #: acked by all extras with no write racing it, or created
        #: fresh after the extras appeared) — writes to these dual-
        #: commit op-granular deltas on both sets so no update is lost
        #: at handoff. Deltas are only safe on top of a complete base:
        #: an oid enters this set strictly after its push round.
        self.migrated: set[bytes] = set()
        #: oids written while NOT in ``migrated`` during a migration —
        #: the write went to acting only, so the push loop must (re)push
        #: full state before the oid may enter ``migrated``
        self.mig_dirty: set[bytes] = set()
        #: oids created fresh under the extras (the create delta IS the
        #: full state) whose fan-out is still in flight: they graduate
        #: to ``migrated`` only when every member ACKS, else they fall
        #: back to ``mig_dirty`` for the push loop
        self.mig_fresh: set[bytes] = set()
        #: extras membership the ``migrated`` set was earned against —
        #: any change invalidates it (a new extra has no bases)
        self._mig_extras: frozenset = frozenset()
        self._migrate_task: asyncio.Task | None = None
        #: newest log entry EVERY acting member acked (primary-only
        #: state): fan-outs quote it as prev_head so sub-op receivers
        #: can tell a revived-stale-member gap (reject: must recover)
        #: from a failed-op gap (absorb: client retries re-apply it).
        #: Re-seeded from the log head at activation — peering has just
        #: converged every member to our log by then.
        self.acked_head: tuple[int, int] = ZERO
        #: (oid, shard) repairs currently in flight — a burst of reads
        #: hitting one rotten shard must queue ONE repair, not a storm
        self._repairing: set[tuple[bytes, int]] = set()
        #: reqids of our own unacked in-flight log tail, detected at
        #: activation: the reply-cache rebuild must never fabricate an
        #: OK for them (phantom ack); a real re-execution clears them.
        #: dict-as-ordered-set so the size cap evicts the OLDEST entry
        #: (an arbitrary eviction could drop a reqid still guarding)
        self._phantom_reqids: dict[tuple, None] = {}
        #: oid -> (loop time, recovery-progress reading) of the FIRST
        #: of an unbroken run of failed reconstructs in peering's
        #: peer-recovery push WITH no recovery progress since; entries
        #: gate the unfound classification behind UNFOUND_GRACE, and
        #: the grace RE-ANCHORS whenever any recovery work succeeded
        #: after the mark — a merely SLOW recovery (cold jit compiles,
        #: saturated device link, 80 ms reconstructs) keeps advancing
        #: the counter and never exhausts the grace, while genuine
        #: bounced-write debris stalls alone once everything else
        #: recovered and still escapes the wedge (ROADMAP item d: the
        #: wall clock alone lost acked generations ~1-in-3 under a
        #: slowed reconstruct at seed 20260803)
        self._unfound_since: dict[bytes, tuple[float, int]] = {}
        #: monotone count of recovery work that SUCCEEDED on this
        #: primary (pushes acked, self-recoveries, own-chunk rebuilds)
        #: — the progress reading the unfound grace anchors against
        self._recovery_progress = 0
        #: oid -> newest version whose CONTENT this member lacks even
        #: though its log position claims it (pg_missing_t role):
        #: populated when a head converges over a skipped unfound push
        #: or an adopted log's reconstruct failed, cleared when content
        #: actually lands (push install, successful reconstruct, a full
        #: rewrite, a delete). PERSISTED next to the log — it must
        #: survive daemon restarts and primary changes, because the
        #: activation reply-cache rebuild trusts peer heads: without
        #: this set, a flapped-in primary would fabricate an OK for a
        #: write whose cells never reached k shards (converged heads
        #: are log position, not content — thrash-found acked-write
        #: loss: the client stops resending and the generation can
        #: never decode)
        self.missing: dict[bytes, tuple[int, int]] = {}
        #: oid -> our own shard's ATTR_V at which a quorum probe last
        #: confirmed the local size attr is authoritative. A past-EOF
        #: read that finds the entry matching the CURRENT local version
        #: skips the probe: the stale-size hazard needs a revived-stale
        #: primary, and revival starts with this (in-memory) cache cold
        #: while any local write bumps ATTR_V past the cached value.
        #: Capped (oldest-out) so a long-lived primary's memory stays
        #: bounded by the hot set, not the object population.
        self._size_probe_ok: dict[bytes, tuple[int, int]] = {}
        self._load()

    # ----------------------------------------------------------- identity

    @property
    def pool(self):
        return self.osd.osdmap.pools[self.pgid[0]]

    @property
    def is_ec(self) -> bool:
        return self.shard >= 0

    def is_primary(self) -> bool:
        return self.primary == self.osd.id

    def live_members(self) -> list[tuple[int, int]]:
        """[(osd, shard)] of acting members per the CURRENT map, holes
        skipped. Computed from the osdmap (not the cached acting set) so
        the data path never acts on a stale membership snapshot."""
        up, _ = self.osd.placement.up_acting(self.osd.osdmap,
                                             self.pgid)
        out = []
        for pos, o in enumerate(up):
            if o != NONE:
                out.append((o, pos if self.is_ec else -1))
        return out

    def up_extras(self) -> list[tuple[int, int]]:
        """[(osd, pos)] of UP members not in the acting set — the
        incoming members of a pg_temp-pinned migration (acting keeps
        serving while data flows to up; empty when acting == up)."""
        up, _upp, acting, _ap = self.osd.placement.full(
            self.osd.osdmap, self.pgid)
        if up == acting:
            return []
        out = []
        for pos, o in enumerate(up):
            if o == NONE:
                continue
            if self.is_ec:
                if pos >= len(acting) or acting[pos] != o:
                    out.append((o, pos))
            elif o not in acting:
                out.append((o, -1))
        return out

    # -------------------------------------------------------- persistence

    def _load(self) -> None:
        store = self.osd.store
        if self.cid in store.list_collections():
            try:
                raw = store.read(self.cid, META_OID)
            except Exception:
                return
            if raw:
                self.log, _ = PGLog.decode(raw)
            try:
                self.missing, _ = dec_missing(
                    store.getattr(self.cid, META_OID, ATTR_PGMISS))
            except Exception:
                self.missing = {}

    def _ensure_coll(self, t: tx.Transaction) -> None:
        if self.cid not in self.osd.store.list_collections():
            t.create_collection(self.cid)

    def _persist_missing(self, t: tx.Transaction,
                         cid: str | None = None) -> None:
        """Persist the missing-set as a pgmeta attr in the same
        transaction as whatever state change created/cleared it."""
        t.setattr(self.cid if cid is None else cid, META_OID,
                  ATTR_PGMISS, enc_missing(self.missing))

    def _persist_log(self, t: tx.Transaction,
                     cid: str | None = None) -> None:
        """Persist the PG log into `cid` (default: our own collection).
        EC sub-writes applied on behalf of a co-located second shard
        must land the log in THAT shard's collection, or it looks
        empty/behind after a restart and recovers needlessly."""
        # pre-encoded entry VIEWS, not a tail re-encode per sub-op: the
        # BufferList shares each entry's memoized wire form and the
        # store lands the segments at the commit boundary
        cid = self.cid if cid is None else cid
        t.truncate(cid, META_OID, 0)
        t.write(cid, META_OID, 0, self.log.encode_bl())

    def _append_and_persist(self, entries: list[Entry],
                            t: tx.Transaction) -> None:
        for entry in entries:
            self.log.append(entry)
        self.log.trim(self.osd.log_keep)
        self._persist_log(t)

    def next_version(self) -> tuple[int, int]:
        return (self.osd.osdmap.epoch, self.log.head[1] + 1)

    # ------------------------------------------------------- map handling

    def on_map(self, acting: list[int], primary: int) -> None:
        """Called on every map change affecting this PG."""
        membership_changed = (acting != self.acting or
                              primary != self.primary)
        self.acting = list(acting)
        self.primary = primary
        if self.is_ec and not (self.shard < len(acting)
                               and acting[self.shard] == self.osd.id):
            # this instance's shard position moved to another OSD (a
            # pgp re-placement): it is a stray now — serve sub-ops,
            # never drive peering (the serving instance is the one
            # whose key matches the acting position)
            self.state = "active"
            self._flush_waiting_stale()
            return
        if not membership_changed and self.state == "active":
            self.kick_migration()  # a pgp change pins pg_temp without
            return                 # touching the acting set
        if self.is_primary():
            if membership_changed or self.state != "active":
                self.state = "peering"
                if self._peer_task is None or self._peer_task.done():
                    self._peer_task = asyncio.get_running_loop().create_task(
                        self._peer_and_recover()
                    )
        else:
            # replicas serve sub-ops in any state; mark active
            self.state = "active"
            self._flush_waiting_stale()

    def _flush_waiting_stale(self) -> None:
        """Lost primaryship: bounce queued clients so they re-target."""
        waiting, self.waiting = self.waiting, []
        for src, m in waiting:
            # ESTALE is a bounce, not a completion: drop the in-flight
            # marker so the client's retry (same tid) is accepted if
            # this PG becomes primary again
            self._req_inflight.discard((src, m.tid))
            self.osd.spawn(
                self.osd.send(
                    src,
                    M.MOSDOpReply(
                        tid=m.tid, result=M.ESTALE, data=b"", size=0,
                        outs=[], epoch=self.osd.osdmap.epoch,
                    ),
                )
            )

    # ====================================================== client ops ==

    async def do_op(self, src: str, m: M.MOSDOp,
                    requeued: bool = False) -> None:
        # NOTE: the ESTALE bounces below drop the dedup marker ONLY for
        # requeued originals (drained from `waiting`, marker set, not
        # executing). A fresh op bounced here was never marked; a
        # DUPLICATE must leave the original's marker alone (the
        # original may be executing or parked — discarding would
        # re-open the double-execute window). Parked originals are
        # cleaned by _flush_waiting_stale, executing by _do_op_traced.
        if not self.is_primary():
            if requeued:
                self._req_inflight.discard((src, m.tid))
            await self.osd.send(
                src,
                M.MOSDOpReply(tid=m.tid, result=M.ESTALE, data=b"", size=0,
                              outs=[], epoch=self.osd.osdmap.epoch),
            )
            return
        if m.oid and self.osd.osdmap.object_to_pg(
                self.pgid[0], m.oid) != self.pgid:
            # the object maps elsewhere under OUR map (e.g. a pg_num
            # split moved it to a child while the client targeted the
            # parent): bounce so the client re-hashes on a fresh map —
            # accepting it would strand the object in the wrong PG
            if requeued:
                self._req_inflight.discard((src, m.tid))
            await self.osd.send(
                src,
                M.MOSDOpReply(tid=m.tid, result=M.ESTALE, data=b"", size=0,
                              outs=[], epoch=self.osd.osdmap.epoch),
            )
            return
        # -- write-op dedup (reqid reply-cache role). Replicated reads
        # are idempotent single-store hits and skip it; `requeued`
        # re-entries are the PG's own park-queue drain, not network
        # duplicates.
        is_write = any(o[0] in WRITE_OPS or o[0] == "call" for o in m.ops)
        if is_write:
            key = (src, m.tid)
            cached = self._req_replies.get(key)
            if cached is not None:
                await self.osd.send(src, cached)
                return
            if not requeued:
                if key in self._req_inflight:
                    return  # duplicate of a parked/executing op
                self._req_inflight.add(key)
        elif self.is_ec and m.ops and not (
                len(m.ops) == 1 and m.ops[0][0] == "pgls"):
            # hedge/resend seam (the PR-3 incarnation-nonce discipline
            # extended to hedge tasks): an EC read executes as a hedged
            # fan-out holding live subtid reply expectations. A client
            # tick-resend of the SAME (src, tid) arriving mid-hedge
            # must NOT launch a second concurrent fan-out — the
            # executing one's reply already carries this tid and serves
            # both, while a doubled fan-out would double-count hedges
            # and race two decodes of one op. Reads keep NO reply
            # cache: the marker drops the moment the reply is sent, so
            # a LOST reply simply re-executes on the next resend.
            if not requeued:
                key = (src, m.tid)
                if key in self._req_inflight:
                    return  # duplicate of an executing hedged fan-out
                self._req_inflight.add(key)
        if self.state != "active":
            self.waiting.append((src, m))
            return
        perf = self.osd.perf
        perf.inc("op")
        verb = m.ops[0][0] if m.ops else "noop"
        span = self.osd.tracer.start_span(
            f"pg.do_op {verb}", parent=m.trace
        ).tag("pgid", self.pgid).tag("oid",
                                     m.oid[:64].decode(errors="replace"))
        ctx_token = tr.current.set(span.ctx)
        try:
            await self._do_op_traced(src, m, perf)
        finally:
            tr.current.reset(ctx_token)
            span.finish()

    async def _do_op_traced(self, src: str, m: M.MOSDOp, perf) -> None:
        if len(m.ops) == 1 and m.ops[0][0] == "pgls":
            # PG-level object listing (the CEPH_OSD_OP_PGLS role): not
            # an object op — answer from the collection directly
            perf.inc("op_r")
            try:
                objs = self.osd.store.list_objects(self.cid)
            except NotFound:  # no write ever landed: empty PG
                objs = []
            oids = sorted(
                o for o in objs
                if o != META_OID and not sn.is_clone_oid(o)
                and not self._is_whiteout(o)
                # stray shield: objects left behind by a missed split
                # (e.g. a member revived mid-transition) map elsewhere
                # under the current pg_num and must not be listed here
                and self.osd.osdmap.object_to_pg(self.pgid[0], o)
                == self.pgid
            )
            out = denc.enc_list(oids, denc.enc_bytes)
            await self.osd.send(
                src,
                M.MOSDOpReply(tid=m.tid, result=M.OK, data=out, size=0,
                              outs=[(0, out)],
                              epoch=self.osd.osdmap.epoch),
            )
            return
        # cls calls may mutate: treat them as write-class for locking
        write_class = any(o[0] in WRITE_OPS or o[0] == "call"
                          for o in m.ops)
        perf.inc("op_w" if write_class else "op_r")
        t0 = time.perf_counter()
        snapc = (m.snap_seq, list(m.snaps))
        try:
            if write_class or self.is_ec:
                # writes serialize per-PG; EC READS do too — an EC read
                # gathers cells across SEVERAL shard stores, and a
                # concurrent write's multi-shard fanout is not atomic
                # across them, so an unlocked read racing a write could
                # mix old and new cells (torn read / spurious hinfo
                # failures) now that the op worker dispatches ops
                # concurrently. The reference takes per-object rw locks
                # (obc); the lite PG serializes on the PG lock.
                # Replicated reads hit ONE store (each write lands
                # there as one atomic transaction) and skip the lock.
                # The waiter count feeds the ECBatcher's mClock-aware
                # fast-flush: an op parked here cannot contribute
                # stripes until the lock holder's batch flushes, so the
                # batcher must not hold a batch open waiting for it.
                self.osd.op_lock_waiters += 1
                try:
                    await self.lock.acquire()
                finally:
                    self.osd.op_lock_waiters -= 1
                try:
                    outs, size = await self._execute_ops(
                        m.oid, m.ops, src=src, snapc=snapc,
                        snapid=m.snapid,
                        reqid=(src, m.tid) if write_class else ("", 0))
                finally:
                    self.lock.release()
            else:
                outs, size = await self._execute_ops(
                    m.oid, m.ops, src=src, snapc=snapc, snapid=m.snapid)
            first = next((d for r, d in outs if d), b"")
            reply = M.MOSDOpReply(tid=m.tid, result=M.OK, data=first,
                                  size=size, outs=outs,
                                  epoch=self.osd.osdmap.epoch)
        except OpError as e:
            reply = M.MOSDOpReply(tid=m.tid, result=e.code, data=b"",
                                  size=0, outs=[],
                                  epoch=self.osd.osdmap.epoch)
        except (KeyError, NotFound):
            reply = M.MOSDOpReply(tid=m.tid, result=M.ENOENT, data=b"",
                                  size=0, outs=[],
                                  epoch=self.osd.osdmap.epoch)
        except Exception:
            self.osd.log_exc(f"pg {self.pgid} op vector")
            reply = M.MOSDOpReply(tid=m.tid, result=M.EAGAIN, data=b"",
                                  size=0, outs=[],
                                  epoch=self.osd.osdmap.epoch)
        perf.tinc("op_latency", time.perf_counter() - t0)
        if write_class:
            key = (src, m.tid)
            self._req_inflight.discard(key)
            if reply.result != M.EAGAIN:
                # EAGAIN asks the client to retry the SAME tid — caching
                # it would freeze the failure; cache only final results.
                # A real execution also clears any phantom blacklisting
                # of this reqid (see the peering-time cache rebuild).
                self._phantom_reqids.pop(key, None)
                self._req_replies[key] = reply
                while len(self._req_replies) > 512:
                    self._req_replies.popitem(last=False)
        elif self.is_ec:
            # EC-read marker (hedge/resend seam in do_op): dropped as
            # the reply goes out — no reply cache for reads, so a lost
            # reply re-executes on the client's next resend instead of
            # serving a stale cached payload
            self._req_inflight.discard((src, m.tid))
        await self.osd.send(src, reply)

    # ------------------------------------------------- op-vector engine

    async def _execute_ops(self, oid: bytes, ops, src: str = "",
                           snapc=(0, ()), snapid=sn.NOSNAP,
                           reqid: tuple[str, int] = ("", 0),
                           ) -> tuple[list, int]:
        """Apply the op vector against a lazy working state of the
        object (do_osd_ops role): reads inside the vector see earlier
        writes, mutations commit atomically at the end, any failure
        aborts the whole vector. Data mutations accumulate as an
        overlay so the backends ship deltas, not the object.

        ``snapc`` (seq, snaps) triggers lazy clone-on-write
        (make_writeable role, PrimaryLogPG.cc:8526); ``snapid`` != NOSNAP
        resolves reads against the head's SnapSet
        (find_object_context role). Returns ([(result, data)], size)."""
        if snapid != sn.NOSNAP:
            if any(o[0] in WRITE_OPS or o[0] == "call" for o in ops):
                raise OpError(-22, "write to a snap")  # EINVAL
            ss = self._load_snapset(oid) or sn.SnapSet()
            which = ss.resolve(snapid)
            if which is None:
                raise OpError(M.ENOENT)
            if which != sn.NOSNAP:
                oid = sn.clone_oid(oid, which)
        st8 = _OpState(self, oid)
        await st8.init()
        outs: list[tuple[int, bytes]] = []
        for (op, offset, length, key, payload, kv, keys) in ops:
            out = b""
            if op in WRITE_OPS:
                st8.mutated = True
            if op == "read":
                if not st8.exists0 and not st8.mutated:
                    raise OpError(M.ENOENT)
                out = await st8.read_range(offset, length)
            elif op == "stat":
                if not st8.exists0 and not st8.mutated:
                    raise OpError(M.ENOENT)
                out = denc.enc_u64(st8.size)
            elif op == "getxattr":
                self._check_exists(st8.exists0, st8.mutated)
                k = key.decode()
                if k not in st8.xattrs():
                    raise OpError(ENODATA, f"xattr {k}")
                out = st8.xattrs()[k]
            elif op == "getxattrs":
                self._check_exists(st8.exists0, st8.mutated)
                out = denc.enc_map(st8.xattrs(), denc.enc_str,
                                   denc.enc_bytes)
            elif op == "omap_get":
                self._check_omap()
                self._check_exists(st8.exists0, st8.mutated)
                out = denc.enc_map(st8.omap(), denc.enc_bytes,
                                   denc.enc_bytes)
            elif op == "omap_getheader":
                self._check_omap()
                self._check_exists(st8.exists0, st8.mutated)
                out = st8.omap_header()
            elif op == "omap_getkeys":
                self._check_omap()
                self._check_exists(st8.exists0, st8.mutated)
                out = denc.enc_list(sorted(st8.omap()), denc.enc_bytes)
            elif op == "writefull":
                st8.truncate(0)
                st8.write(0, payload)
                st8.deleted = False
            elif op == "write":
                st8.write(offset, payload)
            elif op == "append":
                st8.write(st8.size, payload)
            elif op == "zero":
                st8.zero(offset, length)
            elif op == "truncate":
                st8.truncate(offset)
            elif op == "create":
                if st8.exists0 and length == 0:  # length 0 = exclusive
                    raise OpError(EEXIST)
            elif op == "delete":
                if not st8.exists0 and not st8.mutated:
                    raise OpError(M.ENOENT)
                st8.deleted = True
            elif op == "setxattr":
                st8.setxattr(key.decode(), payload)
            elif op == "rmxattr":
                st8.rmxattr(key.decode())
            elif op == "omap_setkeys":
                self._check_omap()
                st8.omap_setkeys(kv)
            elif op == "omap_rmkeys":
                self._check_omap()
                st8.omap_rmkeys(keys)
            elif op == "omap_setheader":
                self._check_omap()
                st8.omap_set_header(payload)
            elif op == "omap_clear":
                self._check_omap()
                st8.omap_clear()
            elif op == "watch":
                # register/unregister src as a watcher (librados watch
                # role; offset carries the cookie, length 0 = unwatch)
                self._check_exists(st8.exists0, st8.mutated)
                ws = self.watchers.setdefault(oid, set())
                if length == 0:
                    ws.discard((src, offset))
                else:
                    ws.add((src, offset))
            elif op == "notify":
                self._check_exists(st8.exists0, st8.mutated)
                self._notify_id += 1
                nid = self._notify_id
                for entity, cookie in self.watchers.get(oid, set()):
                    self.osd.spawn(self.osd.send(
                        entity,
                        M.MNotifyEvent(oid=oid, notify_id=nid,
                                       cookie=cookie, payload=payload),
                    ))
                out = denc.enc_u64(nid)
            elif op == "call":
                # server-side object class method (objclass exec role)
                from . import cls as cls_mod

                try:
                    clsname, method = key.decode().split(".", 1)
                except ValueError:
                    raise OpError(EOPNOTSUPP, f"bad call {key!r}") \
                        from None
                entry = cls_mod.lookup(clsname, method)
                if entry is None:
                    raise OpError(
                        EOPNOTSUPP, f"no class method {key.decode()!r}"
                    )
                fn, _flags = entry
                ctx = cls_mod.ClsContext(
                    await st8.state_dict(), st8.exists0 or st8.mutated
                )
                try:
                    out = fn(ctx, payload)
                except cls_mod.ClsError as e:
                    raise OpError(e.code, str(e)) from None
                if ctx.mutated:
                    # the class mutated arbitrary facets outside the
                    # overlay: commit as a full-state replace. data/
                    # xattrs/omap are mutated in place (shared with
                    # st8); the header is rebound in the state dict,
                    # so copy it back explicitly.
                    st8.mutated = True
                    st8.full_replace = True
                    st8.ov.size = len(st8._data)
                    st8._omap_header = ctx._state["omap_header"]
                if ctx.removed:
                    st8.deleted = True
            else:
                raise OpError(EOPNOTSUPP, f"op {op!r}")
            outs.append((M.OK, out))
        if st8.mutated:
            entries = self._prepare_snap_clone(oid, st8, snapc)
            epoch = self.osd.osdmap.epoch
            seq = self.log.head[1] + 1 + len(entries)
            prior = self._object_version(oid)
            # a whiteout delete leaves a head SHELL (SnapSet carrier):
            # recovery must install it like any object, not remove it —
            # a DELETE entry would strip replicas of the SnapSet
            op_kind = (OP_DELETE
                       if st8.deleted and not st8.whiteout_delete
                       else OP_MODIFY)
            entries.append(Entry(op_kind, oid, (epoch, seq), prior,
                                 reqid=reqid))
            if self.is_ec:
                await self._write_ec_rmw(oid, st8, entries)
            else:
                await self._write_replicated(oid, st8, entries)
        return outs, st8.size if not st8.deleted else 0

    def _prepare_snap_clone(self, oid: bytes, st8: _OpState,
                            snapc) -> list[Entry]:
        """make_writeable role (PrimaryLogPG.cc:8526): when the write's
        SnapContext is newer than the head's SnapSet, preserve the
        pre-write head as a clone object (store-level COW) and record
        which snap ids it serves. Also resolves delete-vs-clones into a
        whiteout. Returns log entries for any clone created."""
        snap_seq, snap_ids = snapc
        # filter the writer's SnapContext through the pool's removed
        # snaps (PrimaryLogPG filter_snapc role): a stale client must
        # not resurrect clones for snaps already deleted
        removed = self.pool.removed_snaps
        if removed:
            snap_ids = [s for s in snap_ids
                        if not sn.interval_contains(removed, s)]
        ss = self._load_snapset(oid)
        entries: list[Entry] = []
        epoch = self.osd.osdmap.epoch
        if snap_seq:
            cur_seq = ss.seq if ss else 0
            if snap_seq > cur_seq:
                new_snaps = sorted(
                    (s for s in snap_ids if s > cur_seq), reverse=True
                )
                if ss is None:
                    ss = sn.SnapSet()
                if st8.exists0 and new_snaps:
                    coid = sn.clone_oid(oid, snap_seq)
                    ss.clones.append(
                        sn.Clone(snap_seq, new_snaps, st8.size0)
                    )
                    cv = (epoch, self.log.head[1] + 1)
                    st8.clone_req = (coid, cv)
                    entries.append(Entry(OP_MODIFY, coid, cv, ZERO))
                ss.seq = snap_seq
                st8.sys_attrs[ATTR_SS] = ss.encode()
        if st8.deleted and ss is not None and ss.clones:
            # head has live clones: keep it as a whiteout (snapdir role)
            st8.whiteout_delete = True
            st8.sys_attrs[ATTR_SS] = ss.encode()
        return entries

    def _load_snapset(self, oid: bytes) -> "sn.SnapSet | None":
        try:
            raw = self.osd.store.getattr(self.cid, oid, ATTR_SS)
            return sn.SnapSet.decode(raw)[0]
        except Exception:
            return None

    def _is_whiteout(self, oid: bytes) -> bool:
        try:
            self.osd.store.getattr(self.cid, oid, ATTR_WHITEOUT)
            return True
        except Exception:
            return False

    @staticmethod
    def _check_exists(exists0: bool, mutated: bool) -> None:
        if not exists0 and not mutated:
            raise OpError(M.ENOENT)

    def _check_omap(self) -> None:
        if self.is_ec:
            # EC pools do not support omap (the reference restriction)
            raise OpError(EOPNOTSUPP, "omap on EC pool")

    def _object_version(self, oid: bytes) -> tuple[int, int]:
        return self._shard_obj_version(self.cid, oid)

    def _shard_obj_version(self, cid: str, oid: bytes) -> tuple[int, int]:
        try:
            return dec_ver(self.osd.store.getattr(cid, oid, ATTR_V))
        except Exception:
            return ZERO

    # ------------------------------------------------ replicated backend

    def _rep_mutation_txn(self, cid: str, oid: bytes, st8: _OpState,
                          version) -> tx.Transaction:
        """Op-granular mutation transaction — what ships to replicas
        (the ReplicatedBackend.cc:465 role: the transaction, never the
        object). The primary applies the identical ops locally."""
        t = tx.Transaction()
        if st8.clone_req is not None:
            # lazy clone of the pre-write head (make_writeable role):
            # store-level COW before any mutation lands
            coid, cv = st8.clone_req
            t.clone(cid, oid, coid)
            t.setattr(cid, coid, ATTR_V, enc_ver(cv))
        if st8.deleted:
            if st8.whiteout_delete:
                t.truncate(cid, oid, 0)
                t.rmattrs(cid, oid)
                t.omap_clear(cid, oid)
                t.omap_setheader(cid, oid, b"")
                t.setattr(cid, oid, ATTR_WHITEOUT, b"1")
                for name, val in st8.sys_attrs.items():
                    t.setattr(cid, oid, name, val)
                t.setattr(cid, oid, ATTR_V, enc_ver(version))
            else:
                t.remove(cid, oid)
            return t
        if st8.full_replace:
            # a cls method rebuilt arbitrary facets: replace everything
            # (t.write snapshots the mutable bytearray itself)
            t.truncate(cid, oid, 0)
            t.write(cid, oid, 0, st8._data)
            t.rmattrs(cid, oid)
            attrs = {ATTR_V: enc_ver(version), **st8.sys_attrs}
            for k, v in st8.xattrs().items():
                attrs[USER_ATTR + k] = v
            t.setattrs(cid, oid, attrs)
            t.omap_clear(cid, oid)
            if st8._omap:
                t.omap_setkeys(cid, oid, st8._omap)
            t.omap_setheader(cid, oid, st8._omap_header or b"")
            return t
        ov = st8.ov
        if not st8.exists0:
            t.touch(cid, oid)
        if ov.size < st8.size0:
            t.truncate(cid, oid, ov.size)
        for off, p in ov.extents():
            if off >= ov.size:
                continue
            ln = p if isinstance(p, int) else len(p)
            ln = min(ln, ov.size - off)
            if isinstance(p, int):
                t.zero(cid, oid, off, ln)
            else:
                t.write(cid, oid, off, p[:ln])
        for m_ in st8.xattr_muts:
            if m_[0] == "set":
                t.setattr(cid, oid, USER_ATTR + m_[1], m_[2])
            else:
                t.rmattr(cid, oid, USER_ATTR + m_[1])
        for kind, arg in st8.omap_muts:
            if kind == "setkeys":
                t.omap_setkeys(cid, oid, arg)
            elif kind == "rmkeys":
                t.omap_rmkeys(cid, oid, arg)
            elif kind == "setheader":
                t.omap_setheader(cid, oid, arg)
            elif kind == "clear":
                t.omap_clear(cid, oid)
                t.omap_setheader(cid, oid, b"")
        if st8.was_whiteout:
            t.rmattr(cid, oid, ATTR_WHITEOUT)
        for name, val in st8.sys_attrs.items():
            t.setattr(cid, oid, name, val)
        t.setattr(cid, oid, ATTR_V, enc_ver(version))
        return t

    def _dual_write_extras(self, oid: bytes,
                           st8: "_OpState | None") -> list[tuple[int, int]]:
        """Incoming up members that must also receive this write: those
        already holding the object (migrated, so the delta applies to a
        complete copy) or seeing it created fresh. Not-yet-migrated
        objects skip the extras AND mark the oid dirty — a delta must
        never land on an extra whose base push hasn't been acked (it
        would materialize a partial object stamped with the new version,
        which the push path's version guard then refuses to repair).
        The push loop re-pushes dirty oids."""
        extras = self.up_extras()
        if not extras:
            return []
        if oid in self.migrated:
            return extras
        if st8 is not None and not st8.exists0:
            # created fresh under the extras' noses: the delta IS the
            # full state, so every extra may take it (a stale in-flight
            # push of a prior incarnation loses to the version guard).
            # PROVISIONAL until the fan-out all-acks — a fenced/timed-
            # out extra means the base is NOT there (the fan-out's
            # completion hooks graduate or demote the oid)
            self.mig_fresh.add(oid)
            return extras
        self.mig_dirty.add(oid)
        return []

    def _mig_fanout_done(self, oid: bytes, ok: bool) -> None:
        """Graduate (all-acked) or demote (failed) a provisional
        fresh-create during pg_temp migration."""
        if oid in self.mig_fresh:
            self.mig_fresh.discard(oid)
            if ok:
                self.migrated.add(oid)
            else:
                self.mig_dirty.add(oid)

    async def _write_replicated(self, oid: bytes, st8: _OpState,
                                entries: list[Entry]) -> None:
        version = entries[-1].version
        mut = self._rep_mutation_txn(self.cid, oid, st8, version)
        await self._rep_fanout(mut, entries,
                               extras=self._dual_write_extras(oid, st8))

    async def _rep_fanout(self, mut: tx.Transaction,
                          entries: list[Entry], extras=()) -> None:
        """Apply a mutation transaction locally (primary orders), fan it
        out to replicas (plus any incoming pg_temp-migration members),
        ack on all-commit."""
        peers = [(o, s) for o, s in self.live_members()
                 if o != self.osd.id]
        extra_peers = [(o, s) for o, s in extras if o != self.osd.id]
        local = tx.Transaction()
        self._ensure_coll(local)
        local.ops.extend(self._filter_remote_ops(mut))
        self._append_and_persist(entries, local)
        local_barrier = self.osd.queue_txn(local)
        # live objects: LocalBus delivers by reference; wire
        # messengers marshal via the LAZY_TXN/LAZY_ENTRIES codecs

        async def _ship(o: int):
            subtid = self.osd.new_subtid()
            fut = self.osd.expect_reply(subtid)
            try:
                await self.osd.send(
                    f"osd.{o}",
                    M.MOSDRepOp(tid=subtid, pgid=self.pgid, txn=mut,
                                entry=entries,
                                epoch=self.osd.osdmap.epoch,
                                prev_head=self.acked_head,
                                trace=_trace_ctx()),
                )
            except BaseException:
                self.osd.drop_reply(subtid)
                raise
            return (o, subtid, fut)

        # ship concurrently: the corked messenger coalesces the whole
        # fan-out into one burst per peer connection. Send failures
        # are classified per target: an acting send failure fails the
        # op through the SAME cleanup path as a failed ack (demote +
        # re-peer, pending futures dropped); extras stay best-effort.
        n_act = len(peers)
        shipped = await asyncio.gather(
            *(_ship(o) for o, _s in peers),
            *(_ship(o) for o, _s in extra_peers),
            return_exceptions=True)
        waits, extra_waits = [], []
        extras_ok, acting_exc = True, None
        for i, res in enumerate(shipped):
            if isinstance(res, BaseException):
                if i < n_act:
                    acting_exc = acting_exc or res
                else:
                    extras_ok = False
            elif i < n_act:
                waits.append(res)
            else:
                extra_waits.append(res)
        try:
            if acting_exc is not None:
                raise acting_exc
            await self.osd.gather(waits)
            # primary's own apply joins the all-acked barrier (group-
            # commit stores defer the flush past queue_transaction)
            await self.osd.txn_durable(local_barrier)
        except BaseException:
            for _o, subtid, _f in waits + extra_waits:
                self.osd.drop_reply(subtid)
            self._mig_fanout_done(entries[-1].oid, ok=False)
            self._repeer_on_subop_failure()
            raise
        # ACTING all-acked: the op succeeds and the fence head advances
        # regardless of the extras — migration targets are best-effort
        # (the reference's backfill targets never fail client IO); a
        # bounced/lost extra delta just demotes the oid for re-push
        if entries[-1].version > self.acked_head:
            self.acked_head = entries[-1].version
        await self._gather_extras(entries[-1].oid, extra_waits,
                                  ok=extras_ok)

    async def _gather_extras(self, oid: bytes, extra_waits,
                             ok: bool = True) -> None:
        for o, subtid, fut in extra_waits:
            try:
                reply = await asyncio.wait_for(fut,
                                               self.osd.subop_timeout)
                ok &= (reply.result == M.OK)
            except (asyncio.TimeoutError, Exception):
                self.osd.drop_reply(subtid)
                ok = False
        self._mig_fanout_done(oid, ok=ok)
        if not ok and oid in self.migrated:
            # a failed delta left some extra behind: its base is stale
            self.migrated.discard(oid)
            self.mig_dirty.add(oid)

    # -------------------------------------------------------- EC backend

    def _shard_cid(self, pos: int) -> str:
        return f"{self.pgid[0]}.{self.pgid[1]}s{pos}"

    async def _write_ec_rmw(self, oid: bytes, st8: _OpState,
                            entries: list[Entry]) -> None:
        """EC delta write (ECBackend.cc:1898 start_rmw role): read the
        touched stripes' old data, re-encode ONLY those stripes (one
        batched device dispatch), ship per-cell deltas + CRC patches to
        each shard. A whole-object write is the degenerate case where
        every stripe is touched; a 4 KiB write into a 4 MiB object
        moves O(stripe) bytes end-to-end."""
        osd = self.osd
        codec = osd.codec_for(self.pool)
        si = osd.sinfo_for(self.pool)
        k, n = codec.k, codec.get_chunk_count()
        live = {s: o for o, s in self.live_members()}
        if len(live) < k:
            # degraded below k: the write CANNOT be made durable right
            # now. A clean retryable error (not a raw exception) so the
            # client refreshes its map and retries — the PG usually
            # heals within a few epochs (min_size gate role)
            raise OpError(M.EAGAIN,
                          f"pg {self.pgid}: {len(live)} < k={k} shards")

        if st8.deleted and not st8.whiteout_delete:
            shard_txns = {}
            for g in range(n):
                pos = codec.chunk_index(g)
                t = tx.Transaction()
                self._ec_clone_ops(t, pos, oid, st8)
                t.remove(self._shard_cid(pos), oid)
                shard_txns[pos] = t
            await self._ec_fanout(oid, entries, shard_txns, hpatch=b"",
                                  ncells=0, size=0, live=live,
                                  extras=self._dual_write_extras(oid, st8))
            return
        if st8.deleted:  # whiteout: keep head shell for its clones
            shard_txns = {}
            for g in range(n):
                pos = codec.chunk_index(g)
                cid = self._shard_cid(pos)
                t = tx.Transaction()
                self._ec_clone_ops(t, pos, oid, st8)
                t.truncate(cid, oid, 0)
                t.rmattrs(cid, oid)
                t.setattr(cid, oid, ATTR_WHITEOUT, b"1")
                for name, val in st8.sys_attrs.items():
                    t.setattr(cid, oid, name, val)
                shard_txns[pos] = t
            await self._ec_fanout(oid, entries, shard_txns, hpatch=b"",
                                  ncells=0, size=0, live=live,
                                  extras=self._dual_write_extras(oid, st8))
            return

        if st8.full_replace:
            # cls rebuilt the object: degenerate overlay = full rewrite
            ov = st.Overlay(st8.size0 if st8.exists0 else 0)
            ov.truncate(0)
            if st8._data:
                ov.write(0, st8._data)  # Overlay snapshots bytearrays
        else:
            ov = st8.ov
        old_size = st8.size0 if st8.exists0 else 0
        new_size = ov.size
        old_nst = si.nstripes(old_size)
        new_nst = si.nstripes(new_size)

        touched: set[int] = set()
        for off, ln in ov.written_ranges():
            s0, s1 = si.stripe_span(off, ln)
            touched.update(range(s0, min(s1, new_nst)))
        if new_size < old_size and new_size % si.width and new_nst:
            # the cut stripe's pad tail must re-encode as zeros
            touched.add(new_nst - 1)

        # old stripe data needed where the overlay doesn't fully cover
        need_old = sorted(
            s for s in touched
            if s * si.width < old_size and not ov.covers(
                s * si.width,
                min((s + 1) * si.width, new_size) - s * si.width,
            )
        )
        old_runs: list[tuple[int, bytes]] = []
        run_start = None
        runs: list[tuple[int, int]] = []
        for s in need_old:
            if run_start is None:
                run_start, prev = s, s
            elif s == prev + 1:
                prev = s
            else:
                runs.append((run_start, prev + 1))
                run_start, prev = s, s
        if run_start is not None:
            runs.append((run_start, prev + 1))
        for a, b in runs:
            start = a * si.width
            end = min(b * si.width, old_size)
            data, _sz = await self._read_ec(oid, start, end - start)
            old_runs.append((a, data))

        tlist = sorted(touched)
        # Shard-major device STAGING buffer (the bufferlist seam of the
        # RMW path): rows are shard files — (k+m, T, su), data rows
        # first. The batcher consumes the data rows' (T, k, su)
        # transpose VIEW, whose shard-major flatten inside the host
        # engine reads this same contiguous buffer back — so the old
        # ascontiguousarray transposes and the per-run tobytes copies
        # are gone: each shard's write runs below slice contiguous
        # (run, su) views straight out of staging into the shard
        # transactions, and the store lands them at its own commit
        # boundary. A zero cell's CRC equals zero_cell_crc, so no
        # special-casing.
        staging = np.zeros((n, len(tlist), si.su), dtype=np.uint8)
        data_sh = staging[:k]                      # (k, T, su)
        par_sh = staging[k:]                       # (m, T, su)
        if tlist:
            # vectorized overlay: ONE materialization of the whole
            # op's extents straight into the staging rows (old stripe
            # data laid first, extents shadow it) — the per-stripe
            # apply_range bytearray round-trip is gone, and the
            # ov_apply_calls counter proves it stays one per op
            n_ext, n_cols = ov.scatter(data_sh, tlist, si, old_runs)
            osd.perf.inc("ov_apply_calls")
            osd.perf.inc("ov_apply_extents", n_ext)
            osd.perf.inc("ov_apply_stripes", n_cols)
            parity, fused = await osd.ec_batcher.encode_cells(
                codec, data_sh.transpose(1, 0, 2))
            par_sh[:] = parity.transpose(1, 0, 2)
            if fused is not None:
                # device engine: the per-cell hash_info CRCs came back
                # from the SAME fused dispatch as the parity — no
                # second pass over the encoded cells on the host
                crc_d = np.ascontiguousarray(fused[:, :k].T)   # (k, T)
                crc_p = np.ascontiguousarray(fused[:, k:].T)   # (m, T)
            else:
                # host engine: ONE multithreaded native CRC batch over
                # the whole shard-major staging (same bytes the old
                # two-call shape hashed, same engine economics)
                nthr = _os.cpu_count() or 1
                crcs = native.crc32c_batch(
                    staging.reshape(-1, si.su), threads=nthr
                ).reshape(n, len(tlist))
                crc_d, crc_p = crcs[:k], crcs[k:]
            nz = staging.any(axis=2)               # (k+m, T)
            nz_d, nz_p = nz[:k], nz[k:]
        shard_txns: dict[int, tx.Transaction] = {}
        hpatches: dict[int, bytes] = {}
        for g in range(n):
            pos = codec.chunk_index(g)
            cid = self._shard_cid(pos)
            t = tx.Transaction()
            self._ec_clone_ops(t, pos, oid, st8)
            if st8.full_replace and st8.exists0:
                t.rmattrs(cid, oid)
            if not st8.exists0:
                t.touch(cid, oid)
            if new_nst != old_nst:
                # shrink drops cells; grow zero-fills (parity of zero
                # data is zero for these linear codes, so zero cells
                # are already consistent codewords)
                t.truncate(cid, oid, new_nst * si.su)
            patch = np.zeros((len(tlist), 2), dtype="<u4")
            if tlist:
                rows = staging[g]  # (T, su) contiguous shard rows
                crc_g = crc_d[g] if g < k else crc_p[g - k]
                nz_g = nz_d[g] if g < k else nz_p[g - k]
            run_i = run_s = prev_s = -1
            for i, s in enumerate(tlist):
                # zero cell: covered by truncate zero-fill when the
                # file grew past it; otherwise must be written
                skip = (not nz_g[i]) and s >= old_nst
                patch[i] = (s, crc_g[i])
                if skip or (run_i >= 0 and s != prev_s + 1):
                    if run_i >= 0:
                        # contiguous staging view, not a tobytes copy
                        t.write(cid, oid, run_s * si.su,
                                rows[run_i:i])
                        run_i = -1
                if not skip:
                    if run_i < 0:
                        run_i, run_s = i, s
                    prev_s = s
            if run_i >= 0:
                t.write(cid, oid, run_s * si.su,
                        rows[run_i:len(tlist)])
            for m_ in st8.xattr_muts:
                if m_[0] == "set":
                    t.setattr(cid, oid, USER_ATTR + m_[1], m_[2])
                else:
                    t.rmattr(cid, oid, USER_ATTR + m_[1])
            if st8.full_replace:
                for xk, xv in st8.xattrs().items():
                    t.setattr(cid, oid, USER_ATTR + xk, xv)
            if st8.was_whiteout:
                t.rmattr(cid, oid, ATTR_WHITEOUT)
            for name, val in st8.sys_attrs.items():
                t.setattr(cid, oid, name, val)
            shard_txns[pos] = t
            # a view over the (T, 2) patch table, not a tobytes copy:
            # the wire codec flattens at ITS boundary, local fan-out
            # consumes it via np.frombuffer either way (buffer plane).
            # T=0 (xattr-only mutation) stays b"" — memoryview.cast
            # rejects zero-sized shapes, and "no patch" is the wire
            # contract for untouched data anyway
            hpatches[pos] = (memoryview(patch).toreadonly().cast("B")
                             if patch.size else b"")
        await self._ec_fanout(oid, entries, shard_txns, hpatch=hpatches,
                              ncells=new_nst, size=new_size, live=live,
                              extras=self._dual_write_extras(oid, st8))

    def _ec_clone_ops(self, t: tx.Transaction, pos: int, oid: bytes,
                      st8: _OpState) -> None:
        """Per-shard lazy clone (make_writeable role): clone the shard
        file — data, hinfo, size, user attrs ride along."""
        if st8.clone_req is None:
            return
        cid = self._shard_cid(pos)
        coid, cv = st8.clone_req
        t.clone(cid, oid, coid)
        t.setattr(cid, coid, ATTR_V, enc_ver(cv))

    async def _ec_fanout(self, oid: bytes, entries: list[Entry],
                         shard_txns: dict[int, tx.Transaction],
                         hpatch, ncells: int, size: int,
                         live: dict[int, int], extras=()) -> None:
        """Apply the local shard's transaction and fan sub-writes out to
        the other shards (plus any incoming pg_temp-migration members);
        ack when every live shard commits."""
        osd = self.osd
        version = entries[-1].version
        # the primary's own shard honors the SAME missing-base bounce
        # handle_ec_write gives peers: a delta over a base we never
        # recovered (head converged over a skipped unfound push) would
        # stamp the new version + copied hinfo over absent cells —
        # zeros that HASH as zero cells, corruption neither the CRC nor
        # the ATTR_V cross-check can convict. Bounce before anything is
        # sent; re-peering recovers (or honestly re-records) the base
        # and the client's retry lands on a whole object.
        if oid in self.missing:
            for pos, t in shard_txns.items():
                if live.get(pos) != osd.id:
                    continue
                hp = hpatch[pos] if isinstance(hpatch, dict) else hpatch
                if not self._write_covers_base(t, oid, hp, ncells):
                    self._mig_fanout_done(oid, ok=False)
                    self._repeer_on_subop_failure()
                    raise RuntimeError(
                        f"own shard {pos} of {oid!r} misses its base: "
                        "delta write bounced pending recovery")
        waits = []
        extra_waits = []
        sends = []
        local_barriers = []
        for pos, t in shard_txns.items():
            targets = []
            if live.get(pos) is not None:
                targets.append((live[pos], False))
            targets += [(o, True) for o, p in extras if p == pos]
            if not targets:
                continue  # degraded write: the hole recovers via peering
            hp = hpatch[pos] if isinstance(hpatch, dict) else hpatch
            for target, is_extra in targets:
                if target == osd.id:
                    local_barriers.append(self._apply_shard_write(
                        self._shard_cid(pos), t, entries, hp, ncells,
                        size, version))
                    continue
                subtid = osd.new_subtid()
                fut = osd.expect_reply(subtid)
                wait = (target, subtid, fut)
                (extra_waits if is_extra else waits).append(wait)
                sends.append((is_extra, wait, osd.send(
                    f"osd.{target}",
                    M.MECSubWrite(tid=subtid, pgid=self.pgid, shard=pos,
                                  txn=t,
                                  entry=entries,
                                  epoch=osd.osdmap.epoch, hpatch=hp,
                                  ncells=ncells, size=size,
                                  prev_head=self.acked_head,
                                  trace=_trace_ctx()),
                )))
        extras_ok, acting_exc = True, None
        if sends:
            # one concurrent burst, not k+m serialized awaits: a corked
            # wire messenger turns the whole fan-out into one write +
            # one drain per peer connection. Failures classify per
            # target: acting sends fail the op via the cleanup path
            # below; extra (migration) sends stay best-effort — but a
            # failed extra's wait is dropped NOW, or _gather_extras
            # would stall a whole subop_timeout on a reply that can
            # never come
            results = await asyncio.gather(*(s for *_x, s in sends),
                                           return_exceptions=True)
            for (is_extra, wait, _s), res in zip(sends, results):
                if isinstance(res, BaseException):
                    if is_extra:
                        extras_ok = False
                        extra_waits.remove(wait)
                        osd.drop_reply(wait[1])
                    elif acting_exc is None:
                        acting_exc = res
        try:
            if acting_exc is not None:
                raise acting_exc
            await osd.gather(waits)
            # the primary's OWN shard must be as durable as the acks it
            # just gathered before the client sees success
            for barrier in local_barriers:
                await osd.txn_durable(barrier)
        except BaseException:
            for _t, subtid, _f in waits + extra_waits:
                osd.drop_reply(subtid)
            self._mig_fanout_done(oid, ok=False)
            self._repeer_on_subop_failure()
            raise
        # see _rep_fanout: acting all-acked; extras are best-effort
        if version > self.acked_head:
            self.acked_head = version
        await self._gather_extras(oid, extra_waits, ok=extras_ok)

    def _repeer_on_subop_failure(self) -> None:
        """An acting member failed/bounced a sub-write: something is
        inconsistent (a fenced stale log, a member that lost its base,
        a vanished peer). Re-run peering — the reference primary
        restarts its PeeringMachine when a repop errors the same way;
        the failed op EAGAINs to the client and retries after the
        round repaired (or consciously skipped) the member."""
        if self.is_primary() and self.state == "active":
            self.state = "peering"
            if self._peer_task is None or self._peer_task.done():
                self._peer_task = (
                    asyncio.get_running_loop().create_task(
                        self._peer_and_recover()))

    @staticmethod
    def _write_covers_base(t: tx.Transaction, oid: bytes,
                           hpatch: bytes, ncells: int) -> bool:
        """True when an EC sub-write needs no pre-existing base: it
        removes the object, or its CRC patch covers EVERY cell (a full
        rewrite replaces the whole shard file)."""
        if any(op.code == tx.OP_REMOVE and op.oid == oid
               for op in t.ops):
            return True
        if not hpatch or not ncells:
            return False
        cols = np.frombuffer(hpatch, dtype="<u4").reshape(-1, 2)[:, 0]
        return len(np.unique(cols[cols < ncells])) >= ncells

    def _apply_shard_write(self, cid: str, t: tx.Transaction,
                           entries: list[Entry], hpatch: bytes,
                           ncells: int, size: int, version) -> None:
        """Shard-side apply of one EC sub-write (primary's own shard and
        handle_ec_write share it): run the mutation ops, patch the
        per-cell CRC attr (hash_info role) and size/version attrs —
        targeting the LAST entry's object, the mutated head — and
        persist the log, one atomic transaction."""
        osd = self.osd
        full = tx.Transaction()
        if cid not in osd.store.list_collections():
            full.create_collection(cid)
        full.ops.extend(self._filter_remote_ops(t))
        oid = entries[-1].oid
        removing = any(op.code == tx.OP_REMOVE and op.oid == oid
                       for op in t.ops)
        if not removing:
            si = osd.sinfo_for(self.pool)
            try:
                old = st.dec_hinfo(osd.store.getattr(cid, oid,
                                                     ATTR_HINFO))
            except Exception:
                old = np.zeros(0, dtype="<u4")
            arr = np.full(ncells, st.zero_cell_crc(si.su), dtype="<u4")
            ncopy = min(len(old), ncells)
            arr[:ncopy] = old[:ncopy]
            if hpatch:
                pairs = np.frombuffer(hpatch, dtype="<u4").reshape(-1, 2)
                in_range = pairs[:, 0] < ncells
                arr[pairs[in_range, 0]] = pairs[in_range, 1]
            full.setattrs(cid, oid, {
                ATTR_HINFO: st.enc_hinfo(arr),
                ATTR_SIZE: denc.enc_u64(size),
                ATTR_V: enc_ver(version),
            })
        if oid in self.missing and self._write_covers_base(
                t, oid, hpatch, ncells):
            # delete, or full rewrite of every cell: the base content
            # we were missing no longer matters. (Partial deltas were
            # already bounced in handle_ec_write and stay missing.)
            self.missing.pop(oid, None)
            self._persist_missing(full, cid)
        for entry in entries:
            if entry.version > self.log.head:
                self.log.append(entry)
        self.log.trim(osd.log_keep)
        self._persist_log(full, cid)
        if osd.fault.hit("torn_write", oid=oid):
            # torn write: only a prefix of the shard transaction
            # reaches disk (pulled-plug shape) — the data lands without
            # its CRC/size/version attrs or log suffix, and scrub /
            # peering must detect and repair the divergence
            full.ops = full.ops[: max(1, len(full.ops) // 2)]
        # the returned barrier (group-commit stores only) must be
        # awaited before ANY ack built on this write leaves the daemon
        return osd.queue_txn(full)

    async def _ec_remote_meta(self, oid: bytes):
        """(size, user-attrs) of an EC object from any peer shard, or
        None when absent everywhere (metadata-only sub-reads, length=0,
        issued concurrently). Used when the primary's own shard lacks
        the object (hole being backfilled)."""
        waits = []
        sends = []
        for pos, target in sorted(
            (s, o) for o, s in self.live_members() if o != self.osd.id
        ):
            subtid = self.osd.new_subtid()
            fut = self.osd.expect_reply(subtid)
            waits.append((target, subtid, fut))
            sends.append(self.osd.send(
                f"osd.{target}",
                M.MECSubRead(tid=subtid, pgid=self.pgid, shard=pos,
                             oid=oid, offset=0, length=0,
                             trace=_trace_ctx()),
            ))
        if sends:
            try:
                await asyncio.gather(*sends)
            except BaseException:
                for _t, subtid, _f in waits:
                    self.osd.drop_reply(subtid)
                raise
        found = None
        for target, subtid, fut in waits:
            reply = await self.osd.await_reply(subtid, fut, target)
            if reply.result == M.OK and found is None:
                found = (reply.size, reply.attrs)
        return found

    def _hedge_extra(self) -> int:
        """Hedge width: extra candidates a fan-out may launch beyond
        the minimal plan (0 when hedging is off — plan-exact)."""
        if not self.osd.hedge_enabled():
            return 0
        try:
            return int(self.osd.conf["osd_hedge_max_extra"])
        except Exception:
            return 2

    def _mk_subread(self, j: int, target: int, oid: bytes,
                    coff: int, clen: int):
        """Candidate factory for one remote EC sub-read: expects the
        reply under a fresh sub-tid and cleans the expectation up on
        ANY exit — cancellation included, so a hedged loser leaves no
        pending future behind (a late reply to a dropped key is a
        no-op in OSD._resolve)."""
        osd = self.osd

        async def _one():
            subtid = osd.new_subtid()
            fut = osd.expect_reply(subtid)
            try:
                await osd.send(
                    f"osd.{target}",
                    M.MECSubRead(tid=subtid, pgid=self.pgid, shard=j,
                                 oid=oid, offset=coff, length=clen,
                                 trace=_trace_ctx()),
                )
                return await osd.await_reply(subtid, fut, target)
            except BaseException:
                osd.drop_reply(subtid)
                raise

        return _one

    async def _read_ec(self, oid: bytes, offset: int = 0,
                       length: int = -1) -> tuple[bytes, int]:
        """Bytes of [offset, offset+length) (clamped to the object) and
        the object size — fetching only the cells of the touched
        stripes from k shards.

        The objects_read_and_reconstruct role (ECBackend.cc:2405):
        minimum_to_decode picks the fetch set from available shards,
        sub-reads verify per-cell hinfo CRCs, decode rebuilds missing
        data cells. A failed sub-read (EIO, hinfo mismatch, lost chunk)
        excludes that shard and re-plans the fetch set from survivors —
        the reconstruct-on-read arc of test-erasure-eio.sh.

        Version hardening (the ROADMAP stale-shard fix): fetched shards
        also cross-check ATTR_V — a revived stale shard is self-
        consistent against its own stale hinfo, so version lag is the
        ONLY signal that excludes it; laggards are demoted exactly like
        hinfo failures and the read decodes from the surviving quorum.
        When the newest generation cannot reach k members (a write
        fan-out died mid-flight), the read falls back to the newest
        generation that can — see _best_version_group. The
        authoritative size is the served generation's, and a fetch
        planned on a stale local size attr is re-planned. Shards left
        behind the served generation get an async repair kicked."""
        osd = self.osd
        codec = osd.codec_for(self.pool)
        si = osd.sinfo_for(self.pool)
        k = codec.k
        live = {s: o for o, s in self.live_members()}
        verify = bool(osd.conf["osd_ec_verify_on_read"])
        want = [codec.chunk_index(i) for i in range(k)]
        size = None
        try:
            size = denc.dec_u64(
                osd.store.getattr(self.cid, oid, ATTR_SIZE), 0
            )[0]
        except Exception:
            pass
        chunks: dict[int, bytes] = {}
        #: version-demoted shards: excluded from the fetch plan but
        #: their data is KEPT for the group fallback
        demoted: dict[int, bytes] = {}
        vers: dict[int, tuple[int, int]] = {}
        sizes: dict[int, int] = {}
        failed: set[int] = set()
        #: hedge results from shards OUTSIDE the minimal plan —
        #: (data, ver, size) kept aside so the next re-plan consumes
        #: them for free instead of re-fetching (chunks itself stays
        #: plan-members-only: all-row codecs decode exactly the plan)
        spare: dict[int, tuple] = {}
        #: shards whose fetch a hedge out-raced (cancelled losers):
        #: slow-not-dead — deprioritized from later plans, never
        #: excluded outright (planning relaxes when it would starve)
        slow: set[int] = set()
        enoent = 0
        for _replan in range(4):
            if size is not None:
                end = size if length < 0 else min(offset + length, size)
                if end <= offset:
                    if not (self._ec_version_check and live):
                        return b"", size
                    myver = self._object_version(oid)
                    if (myver != ZERO
                            and self._size_probe_ok.get(oid) == myver):
                        return b"", size
                    # the local size attr may itself be the stale one
                    # (this primary can be the revived shard): probe
                    # one cell of offset's stripe — even an empty-range
                    # reply carries the shard's true size and version —
                    # before declaring the range past EOF. The post-
                    # fetch authoritative size settles it either way.
                    s0, s1 = si.stripe_span(offset, 1)
                    coff, clen = s0 * si.su, (s1 - s0) * si.su
                else:
                    s0, s1 = si.stripe_span(offset, end - offset)
                    coff, clen = s0 * si.su, (s1 - s0) * si.su
            else:
                # size unknown (no local shard): fetch whole shard files
                s0, s1 = 0, 0
                coff, clen = 0, -1
            while True:
                usable = [s for s in sorted(live)
                          if s not in failed
                          and (s not in slow or s in chunks
                               or s in spare)]
                try:
                    need = codec.minimum_to_decode(want, usable)
                except Exception:
                    if slow and not all(
                            s in chunks or s in spare for s in slow):
                        # deprioritizing the hedge-cancelled
                        # stragglers starved the plan: rejoin them
                        # (the fan-out below awaits them in full)
                        slow.clear()
                        continue
                    # not enough non-demoted shards left: fall back to
                    # the newest generation with >= k fetched members
                    fb = _best_version_group({**demoted, **chunks},
                                             vers, k)
                    if fb is not None:
                        chunks = fb
                        break
                    if enoent and not chunks and not demoted:
                        raise KeyError(oid)  # object genuinely absent
                    raise IOError(
                        f"cannot reconstruct {oid!r}: shards "
                        f"{sorted(failed)} unreadable"
                    )
                primary = []
                for j in sorted(need):
                    if j in chunks:
                        continue
                    if j in spare:
                        # a hedge already fetched this shard: consume
                        data, ver, sz = spare.pop(j)
                        chunks[j] = data
                        vers[j] = ver
                        sizes[j] = sz
                        if size is None:
                            size = sz
                        continue
                    target = live[j]
                    if target == self.osd.id:
                        cid = self._shard_cid(j)
                        try:
                            if osd.fault.hit("ec_local_read", oid=oid,
                                             shard=j):
                                raise IOError("injected local EIO")
                            chunk = bytes(osd.store.read(cid, oid, coff,
                                                         clen))
                            chunk = self._maybe_bitflip(chunk, oid, j)
                            # whole-shard reads always verify, knob or
                            # not — symmetric with handle_ec_read's
                            # remote length==-1 stance (rotted cells
                            # must never feed a rebuild)
                            if verify or clen == -1:
                                self._verify_hinfo(cid, oid, chunk,
                                                   first_cell=s0)
                            chunks[j] = chunk
                            vers[j] = self._shard_obj_version(cid, oid)
                            try:
                                sizes[j] = denc.dec_u64(
                                    osd.store.getattr(cid, oid,
                                                      ATTR_SIZE), 0)[0]
                            except Exception:
                                pass
                            if size is None:
                                size = sizes.get(j)
                        except NotFound:
                            enoent += 1
                            failed.add(j)
                        except HinfoError:
                            osd.perf.inc("ec_read_crc_err")
                            failed.add(j)
                            self._kick_read_repair(
                                oid, j, live,
                                self._shard_obj_version(cid, oid))
                        except IOError:
                            failed.add(j)
                        continue
                    primary.append((j, target,
                                    self._mk_subread(j, target, oid,
                                                     coff, clen)))
                # hedge candidates: usable shards OUTSIDE the plan
                # (d > k fan-out), fastest EWMA peers first — launched
                # by hedged_fanout only if the plan drags past the
                # per-peer hedge delay
                extras = []
                if primary:
                    cand = sorted(
                        (s for s in usable
                         if s not in need and s not in chunks
                         and s not in spare
                         and live[s] != self.osd.id),
                        key=lambda s: (osd.peer_ewma.latency(live[s]),
                                       s))
                    extras = [
                        (s, live[s],
                         self._mk_subread(s, live[s], oid, coff, clen))
                        for s in cand[: self._hedge_extra()]]

                def _suff(out: dict) -> bool:
                    # first decodable subset: what we hold + what the
                    # fan-out returned OK plans a decode for `want`
                    have = set(chunks) | set(spare) | {
                        j for j, r in out.items()
                        if not isinstance(r, BaseException)
                        and r.result == M.OK}
                    try:
                        plan = codec.minimum_to_decode(want,
                                                       sorted(have))
                    except Exception:
                        return False
                    return all(p in have for p in plan)

                def _nbytes(r) -> int:
                    return (len(r.data)
                            if not isinstance(r, BaseException)
                            and r.result == M.OK and r.data else 0)

                out = {}
                if primary:
                    out = await hedged_fanout(osd, primary, extras,
                                              _suff, nbytes=_nbytes)
                exc = None
                for j in sorted(out):
                    r = out[j]
                    if isinstance(r, BaseException):
                        # transport failure: transient, triaged below
                        exc = exc if exc is not None else r
                        continue
                    if r.result == M.OK:
                        if j in need and j not in chunks:
                            chunks[j] = r.data
                            vers[j] = tuple(r.ver)
                            sizes[j] = r.size
                        else:
                            spare[j] = (r.data, tuple(r.ver), r.size)
                        if size is None:
                            size = r.size
                    else:
                        if r.result == M.ENOENT:
                            enoent += 1
                        elif r.result == M.EIO:
                            # shard-side hinfo/IO failure: repair it
                            self._kick_read_repair(oid, j, live)
                        failed.add(j)
                if not all(j in chunks for j in need):
                    # plan members absent from the outcome map were
                    # hedge-cancelled losers: slow, not dead
                    slow.update(j for j in need
                                if j not in chunks and j not in failed
                                and j not in out)
                    if exc is not None and not _suff(out):
                        # a transport failure AND no decodable subset:
                        # keep the legacy transient-abort contract
                        raise exc
                    continue
                if self._demote_version_laggards(chunks, vers, demoted,
                                                 failed):
                    continue  # re-plan from the surviving quorum
                break
            self._count_stale_demotions(chunks, vers, demoted,
                                        oid=oid, live=live)
            # authoritative size: the served generation's size attr
            # (the primary's own attr may be the stale one)
            if vers and chunks:
                best = max(chunks, key=lambda j: vers.get(j, ZERO))
                bsize = sizes.get(best)
                if bsize is not None and vers.get(best, ZERO) != ZERO:
                    size = bsize
            if size is None:
                raise KeyError(oid)
            end = size if length < 0 else min(offset + length, size)
            if end <= offset:
                # the quorum confirmed our local attrs are current:
                # later past-EOF reads of this oid can skip the probe
                # until a local write bumps our shard's ATTR_V
                myver = self._object_version(oid)
                if myver != ZERO and chunks and myver == max(
                        vers.get(j, ZERO) for j in chunks):
                    self._size_probe_ok.pop(oid, None)
                    self._size_probe_ok[oid] = myver
                    while len(self._size_probe_ok) > 4096:
                        del self._size_probe_ok[
                            next(iter(self._size_probe_ok))]
                return b"", size
            if clen != -1 and end > s1 * si.width:
                # the fetch was planned on a stale (smaller) size: the
                # range misses stripes of the authoritative object —
                # refetch wider. Shards that failed for real (EIO,
                # hinfo, ENOENT) stay excluded, but version-demoted
                # ones must rejoin the plan: when the group fallback
                # just chose THEIR generation, leaving them in
                # ``failed`` would strand the only decodable copy
                chunks.clear()
                spare.clear()  # fetched at the stale (narrower) range
                failed.difference_update(demoted)
                demoted.clear()
                vers.clear()
                sizes.clear()
                continue
            break
        else:
            raise IOError(f"cannot plan a stable read of {oid!r}")
        # equalize lengths defensively (lagging shards), then decode
        want_missing = [p for p in want if p not in chunks]
        if want_missing:
            # batched rebuild of ONLY the missing rows: the touched
            # stripes become a (ncells, k, su) batch through the
            # ECBatcher's bucket/pow2 machinery, merging with every
            # other degraded read / recovery decode in flight instead
            # of one codec.decode dispatch per object; already-fetched
            # shards pass through untouched
            maxlen = max(len(c) for c in chunks.values())
            missing_g = tuple(codec._position_to_generator(p)
                              for p in want_missing)
            rebuilt = await self._decode_cells_batched(
                codec, si, chunks, maxlen, want_generators=missing_g)
            decoded = {
                p: rebuilt[:, i, :].reshape(-1)
                for i, p in enumerate(want_missing)
            }
            for p in want:
                if p in chunks:
                    decoded[p] = np.frombuffer(chunks[p],
                                               dtype=np.uint8)
        else:
            decoded = {
                p: np.frombuffer(chunks[p], dtype=np.uint8)
                for p in want
            }
        # cells -> logical bytes: (ncells, k, su), stripe-major
        ncells_r = max(len(decoded[p]) for p in want) // si.su
        stack = np.zeros((k, ncells_r * si.su), dtype=np.uint8)
        for i in range(k):
            d = decoded[codec.chunk_index(i)]
            stack[i, : d.size] = d
        logical = np.ascontiguousarray(
            stack.reshape(k, ncells_r, si.su).transpose(1, 0, 2)
        ).reshape(-1)
        lo = offset - s0 * si.width
        return bytes(logical[lo : lo + (end - offset)]), size

    async def _decode_cells_batched(self, codec, si, chunks: dict,
                                    maxlen: int,
                                    want_generators: tuple) -> np.ndarray:
        """Rebuild ``want_generators`` rows from the survivor chunks via
        the ECBatcher decode side: chunk byte-ranges become a
        (ncells, k, su) cell batch (short chunks zero-extended to
        ``maxlen``), so concurrent degraded reads, recovery pulls and
        scrub repairs merge into one stacked-matrix device dispatch.
        Codecs without the batched bytewise API (bitmatrix, CLAY, ...)
        fall back to one scalar ``codec.decode`` here, so every caller
        shares ONE eligibility rule. Returns (ncells, len(want), su)
        uint8."""
        ncells = -(-maxlen // si.su)
        if ncells == 0:  # nothing fetched anywhere: nothing to rebuild
            return np.zeros((0, len(want_generators), si.su),
                            dtype=np.uint8)
        if ((getattr(codec, "bytewise_linear", False)
                or getattr(codec, "cellwise_codeword", False))
                and hasattr(codec, "decode_batch")):
            order = sorted(chunks)
            if not getattr(codec, "decode_uses_all_rows", False):
                # any k rows decode (MDS); LRC/CLAY instead consume
                # every fetched row (locality plans fetch fewer than
                # k, Clay's erasure set is the complement)
                order = order[: codec.k]
            present = tuple(codec._position_to_generator(p)
                            for p in order)
            surv = np.zeros((len(order), ncells * si.su), dtype=np.uint8)
            for row, p in enumerate(order):
                c = np.frombuffer(chunks[p], dtype=np.uint8)
                surv[row, : c.size] = c
            surv = np.ascontiguousarray(
                surv.reshape(len(order), ncells, si.su).transpose(1, 0, 2))
            return await self.osd.ec_batcher.decode_cells(
                codec, present, want_generators, surv)
        # chunk-codeword codecs without a batched API: one scalar
        # codec.decode over whole (padded) chunks
        arrs = {
            p: _pad_to(np.frombuffer(c, dtype=np.uint8), maxlen)
            for p, c in chunks.items()
        }
        positions = [codec.chunk_index(g) for g in want_generators]
        decoded = codec.decode(positions, arrs)
        out = np.zeros((ncells, len(positions), si.su), dtype=np.uint8)
        for i, p in enumerate(positions):
            row = np.zeros(ncells * si.su, dtype=np.uint8)
            row[: decoded[p].size] = decoded[p]
            out[:, i, :] = row.reshape(ncells, si.su)
        return out

    def _demote_version_laggards(self, chunks: dict, vers: dict,
                                 demoted: dict,
                                 failed: set) -> bool:
        """ATTR_V cross-check shared by _read_ec and
        _reconstruct_chunk (the stale-shard hardening, shared by
        both): every fetched shard lagging the max
        fetched version is demoted exactly like a hinfo-CRC failure —
        excluded from the plan, its data KEPT for the group fallback —
        and the caller re-plans from survivors when this returns
        True. A revived stale shard is self-consistent against its own
        stale hinfo, so version lag is the ONLY signal that catches
        it."""
        if not (self._ec_version_check and vers and chunks):
            return False
        vmax = max(vers.get(j, ZERO) for j in chunks)
        stale = [j for j in chunks if vers.get(j, ZERO) < vmax]
        for j in stale:
            demoted[j] = chunks.pop(j)
            failed.add(j)
        return bool(stale)

    def _count_stale_demotions(self, chunks: dict, vers: dict,
                               demoted: dict, oid: bytes | None = None,
                               live: dict | None = None) -> None:
        """True laggards — behind the generation actually SERVED — are
        counted (ec_read_stale_shard); shards a group fallback judged
        ahead of the served generation are not stale. With ``live``
        set, each counted laggard also gets an async repair kicked
        (the read path does; a reconstruct's caller reinstalls the
        rebuilt shard itself)."""
        sel_ver = max((vers.get(j, ZERO) for j in chunks), default=ZERO)
        for j in demoted:
            if j not in chunks and vers.get(j, ZERO) < sel_ver:
                self.osd.perf.inc("ec_read_stale_shard")
                if live is not None:
                    self._kick_read_repair(oid, j, live, vers.get(j))

    def _maybe_bitflip(self, chunk: bytes, oid: bytes,
                       shard: int) -> bytes:
        """``ec_read_bitflip`` fault site for local shard reads: rot
        must land BEFORE hinfo verification so the CRC check is what
        catches it."""
        if self.osd.fault.hit("ec_read_bitflip", oid=oid, shard=shard):
            from .faults import flip_bit

            chunk = flip_bit(chunk)
        return chunk

    def _verify_hinfo(self, cid: str, oid: bytes, chunk: bytes,
                      first_cell: int = 0) -> None:
        """Per-cell CRC verification of a shard-file range starting at
        cell ``first_cell`` (hash_info role, per-cell so partial
        overwrites never re-hash the whole shard)."""
        if not chunk:
            return
        si = self.osd.sinfo_for(self.pool)
        stored = st.dec_hinfo(
            self.osd.store.getattr(cid, oid, ATTR_HINFO)
        )
        cells = np.frombuffer(chunk, dtype=np.uint8).reshape(-1, si.su)
        for idx in range(len(cells)):
            actual = native.crc32c(np.ascontiguousarray(cells[idx]))
            if stored[first_cell + idx] != actual:
                raise HinfoError(
                    f"hinfo mismatch on {cid}/{oid!r} cell "
                    f"{first_cell + idx}: {stored[first_cell + idx]:#x}"
                    f" != {actual:#x}"
                )

    def _kick_read_repair(self, oid: bytes, shard: int,
                          live: dict[int, int],
                          observed: "tuple | None" = None) -> None:
        """A read unmasked a bad shard copy (bit rot failing hinfo, or
        a version-lagging revived shard): queue ONE asynchronous
        reconstruct+reinstall instead of serving degraded until the
        next scrub (the read-triggered repair arc of
        test-erasure-eio.sh). Never blocks the read. ``observed`` is
        the bad copy's version when known — the repair push CAS-es on
        it so a racing write always wins."""
        if not self.is_primary() or self.state != "active":
            return
        target = live.get(shard)
        if target is None or (oid, shard) in self._repairing:
            return
        self._repairing.add((oid, shard))
        self.osd.spawn(self._repair_shard(oid, shard, target, observed))

    async def _repair_shard(self, oid: bytes, shard: int, target: int,
                            observed: "tuple | None" = None) -> None:
        """Rebuild shard ``shard`` from the surviving quorum and
        reinstall it on its holder (self or peer). The reconstruct's
        own version cross-check guarantees generation-consistent cells;
        its attrs carry the version the rebuild represents."""
        try:
            async with self.lock:
                chunk, attrs = await self._reconstruct_chunk(oid, shard)
            version = (dec_ver(attrs[ATTR_V]) if ATTR_V in attrs
                       else self._object_version(oid))
            # CAS anchor: replace the version the read observed (rot
            # keeps the version, so the rebuild's own label is the
            # right anchor when the observation carried none)
            expect = observed if observed is not None else version
            if target == self.osd.id:
                cid = self._shard_cid(shard)
                t = tx.Transaction()
                if cid not in self.osd.store.list_collections():
                    t.create_collection(cid)
                t.truncate(cid, oid, 0)
                t.write(cid, oid, 0, chunk)
                t.rmattrs(cid, oid)
                t.setattrs(cid, oid,
                           {**attrs, ATTR_V: enc_ver(version)})
                self.osd.store.queue_transaction(t)
            else:
                tid = self.osd.new_subtid()
                key = ("pushr", self.pgid, shard, oid, target, tid)
                fut = self.osd.expect_reply(key)
                await self.osd.send(
                    f"osd.{target}",
                    M.MPushOp(pgid=self.pgid, shard=shard, oid=oid,
                              version=version, data=chunk, attrs=attrs,
                              epoch=self.osd.epoch, force=1,
                              last_update=self.log.head, tid=tid,
                              expect=expect),
                )
                try:
                    await asyncio.wait_for(fut, self.osd.subop_timeout)
                except asyncio.TimeoutError:
                    self.osd.drop_reply(key)
                    return
            self.osd.perf.inc("ec_read_repairs")
        except asyncio.CancelledError:
            raise
        except Exception:
            pass  # unreconstructable right now: scrub/peering retries
        finally:
            self._repairing.discard((oid, shard))

    # ================================================== sub-op handlers ==

    def _subop_misdirected(self, oid: bytes) -> bool:
        """A sub-op for an object that maps to a different PG under OUR
        map (a pg_num split raced the primary's fan-out): applying it
        would strand the object in a post-split parent collection —
        reject so the primary fails the op and the client re-targets."""
        head = sn.parse_clone_oid(oid)[0] if sn.is_clone_oid(oid) else oid
        try:
            return self.osd.osdmap.object_to_pg(
                self.pgid[0], head) != self.pgid
        except Exception:
            return False

    def _subop_fenced(self, src: str, prev_head) -> bool:
        """Prefix-log + interval fence for incoming sub-writes.

        (a) ``src`` must be OUR current primary: a demoted primary
        finishing an in-flight fan-out after a map flip must not plant
        entries on members of the new interval (its op fails; the
        client re-targets).
        (b) Our log head must cover the sender's ALL-ACKED head
        (``prev_head`` = newest entry every acting member acked, NOT
        the sender's raw log head). Every live member has acked — and
        therefore holds — everything up to that point, so head <
        prev_head identifies exactly one situation: a revived stale
        member that missed all-committed updates. Appending over that
        gap would hand it the authoritative head version WITHOUT the
        intervening mutations, the next peering round would skip its
        recovery, and it would serve resurrected data (the divergent-
        log hazard the reference's PGLog merge_log guards). Fencing on
        the raw log head instead would livelock: a partially failed
        fan-out (e.g. a split misdirect bounced one shard) leaves the
        primary's log permanently ahead of members that bounced,
        while the client's retry re-applies the content under a fresh
        version — such unacked entries are absorbed-by-gap by design."""
        if src != f"osd.{self.primary}":
            return True
        return self.log.head < tuple(prev_head)

    async def handle_rep_op(self, src: str, m: M.MOSDRepOp) -> None:
        t = (m.txn if isinstance(m.txn, tx.Transaction)
             else tx.Transaction.decode(m.txn)[0])
        entries = (m.entry if isinstance(m.entry, list)
                   else dec_entries(m.entry))
        if (self._subop_fenced(src, m.prev_head)
                or self._subop_misdirected(entries[-1].oid)):
            await self.osd.send(
                src,
                M.MOSDRepOpReply(tid=m.tid, pgid=self.pgid,
                                 result=M.ESTALE, osd=self.osd.id),
            )
            return
        full = tx.Transaction()
        if self.cid not in self.osd.store.list_collections():
            full.create_collection(self.cid)
        full.ops.extend(self._filter_remote_ops(t))
        for entry in entries:
            if entry.version > self.log.head:
                self.log.append(entry)
        self.log.trim(self.osd.log_keep)
        self._persist_log(full)
        await self.osd.txn_durable(self.osd.queue_txn(full))
        self.osd.perf.inc("subop_w")
        await self.osd.send(
            src,
            M.MOSDRepOpReply(tid=m.tid, pgid=self.pgid, result=M.OK,
                             osd=self.osd.id),
        )

    async def handle_ec_write(self, src: str, m: M.MECSubWrite) -> None:
        t = (m.txn if isinstance(m.txn, tx.Transaction)
             else tx.Transaction.decode(m.txn)[0])
        entries = (m.entry if isinstance(m.entry, list)
                   else dec_entries(m.entry))
        oid = entries[-1].oid
        if oid in self.missing and not self._write_covers_base(
                t, oid, m.hpatch, m.ncells):
            # a DELTA patches cells of a base we do not hold (head
            # converged over a skipped unfound push): applying it
            # would stamp current attrs over zero-filled content that
            # even hinfo cannot convict (absent cells hash as zero
            # cells). Bounce so the primary re-peers and recovers (or
            # keeps us honestly missing); a full rewrite passes.
            await self.osd.send(
                src,
                M.MECSubWriteReply(tid=m.tid, pgid=self.pgid,
                                   shard=m.shard, result=M.ESTALE),
            )
            return
        if (self._subop_fenced(src, m.prev_head)
                or self._subop_misdirected(oid)):
            await self.osd.send(
                src,
                M.MECSubWriteReply(tid=m.tid, pgid=self.pgid,
                                   shard=m.shard, result=M.ESTALE),
            )
            return
        barrier = self._apply_shard_write(self.cid, t, entries, m.hpatch,
                                          m.ncells, m.size,
                                          entries[-1].version)
        # group-commit store: the OK below feeds the primary's all-ack
        # and ultimately the client's — it must not outrun the flush
        await self.osd.txn_durable(barrier)
        self.osd.perf.inc("subop_w")
        await self.osd.send(
            src,
            M.MECSubWriteReply(tid=m.tid, pgid=self.pgid, shard=m.shard,
                               result=M.OK),
        )

    def _filter_remote_ops(self, t: tx.Transaction) -> list:
        """Drop ops that cannot apply on a diverged member: removes of
        objects we do not hold, and clones whose source is missing (a
        revived replica pending recovery must still ack the txn; the
        skipped objects converge via recovery/scrub). Ops targeting a
        skipped clone are dropped with it so no empty shell appears."""
        ops = []
        skipped_dests: set[tuple[str, bytes]] = set()
        for op in t.ops:
            if op.code == tx.OP_REMOVE and not self.osd.store.exists(
                op.cid, op.oid
            ):
                continue
            if op.code == tx.OP_CLONE and not self.osd.store.exists(
                op.cid, op.oid
            ):
                skipped_dests.add((op.cid, op.args["dest"]))
                continue
            if (op.cid, op.oid) in skipped_dests:
                continue
            ops.append(op)
        return ops

    async def handle_ec_read(self, src: str, m: M.MECSubRead) -> None:
        """Serve a (ranged) shard read: length=-1 is the whole shard
        file, length=0 is metadata only, else a cell-aligned byte range
        of the shard file; covered cells verify against hinfo. With
        ``subruns`` set (regenerating-code repair), the FULL cells are
        read and hinfo-verified locally — rot must never ride a repair
        — but only the selected sub-chunk slices of each cell go on
        the wire (the repair-traffic reduction the sub-chunk plan
        exists for)."""
        # slow-OSD arm (FaultPlane.slow_osd): lognormal service-time
        # inflation on the shard-serving path — the straggler the
        # hedged read fan-outs route around. No PG lock is held here
        # (shard-side serving), so the stall slows this sub-read only.
        await self.osd.fault.pause("straggle", osd=self.osd.id,
                                   shard=m.shard)
        try:
            if self.osd.fault.hit("ec_sub_read", oid=m.oid,
                                  osd=self.osd.id, shard=m.shard):
                raise IOError("injected EIO")
            if m.length == 0:
                if not self.osd.store.exists(self.cid, m.oid):
                    raise NotFound(repr(m.oid))
                chunk = b""
            else:
                chunk = bytes(self.osd.store.read(self.cid, m.oid,
                                                  m.offset, m.length))
                chunk = self._maybe_bitflip(chunk, m.oid, m.shard)
                si = self.osd.sinfo_for(self.pool)
                # recovery reads (whole-file) always verify — a rotted
                # cell must never be rebuilt into another shard; the
                # knob only relaxes the normal client-read path
                if (self.osd.conf["osd_ec_verify_on_read"]
                        or m.length == -1 or m.subruns):
                    self._verify_hinfo(self.cid, m.oid, chunk,
                                       first_cell=m.offset // si.su)
                if m.subruns:
                    chunk = _slice_subruns(
                        chunk, si.su, m.subruns,
                        self.osd.codec_for(self.pool))
            digest = native.crc32c(np.frombuffer(chunk, np.uint8)) \
                if chunk else 0
            size = denc.dec_u64(
                self.osd.store.getattr(self.cid, m.oid, ATTR_SIZE), 0
            )[0]
            uattrs = {
                k: v
                for k, v in self.osd.store.getattrs(
                    self.cid, m.oid
                ).items()
                if _is_recovery_attr(k)
            }
            reply = M.MECSubReadReply(tid=m.tid, pgid=self.pgid,
                                      shard=m.shard, result=M.OK,
                                      data=chunk, digest=digest, size=size,
                                      attrs=uattrs,
                                      ver=self._object_version(m.oid))
        except HinfoError:
            self.osd.perf.inc("ec_read_crc_err")
            reply = M.MECSubReadReply(tid=m.tid, pgid=self.pgid,
                                      shard=m.shard, result=M.EIO,
                                      data=b"", digest=0, size=0, attrs={})
        except (NotFound, KeyError):
            reply = M.MECSubReadReply(tid=m.tid, pgid=self.pgid,
                                      shard=m.shard, result=M.ENOENT,
                                      data=b"", digest=0, size=0, attrs={})
        except Exception:
            # EIO/corruption: distinct from "never had it" so the
            # primary can count true absence (handle_sub_read's EIO arc)
            reply = M.MECSubReadReply(tid=m.tid, pgid=self.pgid,
                                      shard=m.shard, result=M.EIO,
                                      data=b"", digest=0, size=0, attrs={})
        await self.osd.send(src, reply)

    # ======================================================== peering ==

    async def _peer_and_recover(self) -> None:
        """Run peering rounds until one completes under a stable epoch
        (a mid-round map change invalidates the round — the reference
        restarts its PeeringMachine on AdvMap the same way). Transient
        errors (peer vanished mid-round, send failure) retry the round;
        only cancellation stops the loop."""
        while self.is_primary() and self.state != "active":
            try:
                if await self._do_peering():
                    break
            except asyncio.CancelledError:
                raise
            except Exception:
                self.osd.log_exc(f"pg {self.pgid} peering")
            await asyncio.sleep(0.02)

    async def _do_peering(self) -> bool:
        """GetInfo -> choose authoritative -> recover self -> recover
        peers -> active (the PeeringState GetInfo/GetLog/GetMissing/
        Activate arc, PeeringState.h:268, compressed for all-ack logs)."""
        osd = self.osd
        epoch = osd.osdmap.epoch
        peers = [(o, s) for o, s in self.live_members() if o != osd.id]
        infos: dict[tuple[int, int], PGInfo] = {
            (osd.id, self.shard): PGInfo(self.log.head, self.log,
                                         dict(self.missing))
        }
        waits = []
        for o, s in peers:
            fut = osd.expect_reply(("info", self.pgid, o, s))
            waits.append((o, s, fut))
            await osd.send(
                f"osd.{o}",
                M.MPGInfoReq(pgid=self.pgid, epoch=epoch, shard=s),
            )
        complete = True
        for o, s, fut in waits:
            try:
                reply = await asyncio.wait_for(fut, osd.subop_timeout)
            except asyncio.TimeoutError:
                osd.drop_reply(("info", self.pgid, o, s))
                # an UP member that won't answer blocks peering: going
                # active without its info would skip its recovery. Either
                # it answers on retry (boot race) or the mon marks it
                # down and it leaves live_members (reference PGs stay in
                # Peering/GetInfo until the prior set resolves the same
                # way).
                complete = False
                continue
            info, _ = PGInfo.decode(reply.info)
            infos[(o, s)] = info
        if not complete:
            return False

        if osd.osdmap.epoch != epoch:
            return False  # superseded; caller retries under the new map

        best_key = max(infos, key=lambda k: infos[k].last_update)
        best = infos[best_key]

        # which members actually need recovery work? slot-free fast
        # path when everyone already agrees (the common map-churn case)
        target_head = best.last_update
        lagging = [(o, s) for (o, s), i in infos.items()
                   if i.last_update != target_head]
        reserved_remote: list[int] = []
        held_local = False
        try:
            if lagging:
                # LOCAL backfill slot (AsyncReserver role): bounds how
                # many of this OSD's PGs recover at once so a mass
                # remap cannot stampede. The timeout breaks reservation
                # deadlock cycles — the round just retries.
                try:
                    await asyncio.wait_for(
                        osd.local_reserver.request(("pg", self.pgid)),
                        osd.subop_timeout * 8)
                except asyncio.TimeoutError:
                    osd.local_reserver.release(("pg", self.pgid))
                    return False
                held_local = True
                if osd.osdmap.epoch != epoch:
                    return False

            # -- recover self to authoritative
            if best.last_update > self.log.head:
                await self._recover_self(best_key, best)
            # retry OUR OWN recorded content gaps (objects behind the
            # converged head that never landed): members revived or
            # strays reachable under the current map may make the
            # reconstruct succeed now; a still-unfound object stays on
            # record and never wedges the round
            for moid, mver in list(self.missing.items()):
                if self._subop_misdirected(moid):
                    continue
                try:
                    await self._recover_own_chunk(moid, tuple(mver))
                except RuntimeError:
                    pass

            # -- recover peers (delta or backfill), a REMOTE slot on
            # each target bounding its inbound backfills
            for (o, s), info in infos.items():
                if o == osd.id:
                    continue
                if info.last_update == self.log.head:
                    # heads agree, but content gaps recorded behind
                    # the peer's converged head still want push
                    # retries (same best-effort contract as above) —
                    # under the SAME remote slot that bounds every
                    # other inbound push: after a mass remap many
                    # heads-agree primaries retry the same revived
                    # peer's gaps at once, and each retry is a full
                    # reconstruct + push. No slot, no retry this
                    # round; the gap stays safely on record.
                    if info.missing:
                        if not await self._reserve_remote(o):
                            continue  # saturated: retry next round
                        reserved_remote.append(o)
                        await self._retry_peer_missing(o, s, info)
                    continue
                if not await self._reserve_remote(o):
                    return False  # target saturated: retry the round
                reserved_remote.append(o)
                missing = self.log.missing_after(info.last_update)
                #: content pushes this round legitimately skipped as
                #: unfound — shipped with the head push so the peer
                #: RECORDS the gap its converged head papers over
                skipped: dict[bytes, tuple[int, int]] = {}
                if missing is None:
                    skipped = await self._backfill_peer(o, s)
                else:
                    all_acked = True
                    for oid, e in missing.items():
                        if self._subop_misdirected(oid):
                            continue  # split stray: child PG owns it
                        try:
                            if not await self._push_object(o, s, oid, e):
                                # ack TIMEOUT: the peer may not hold the
                                # content — converging its log head over
                                # the gap would report it clean while
                                # silently stale; retry the whole
                                # round instead
                                all_acked = False
                        except RuntimeError:
                            # unreconstructable RIGHT NOW — usually a
                            # transient (surviving-quorum members down
                            # mid-flap), so retry the round within a
                            # time budget: converging the peer's log
                            # head over a gap a revived member could
                            # still fill drops an ACKED generation
                            # below k, and scrub then rolls it back as
                            # orphan debris (acked-write loss, thrash-
                            # found). Only an object that stays
                            # unreconstructable across the budget —
                            # the debris of a bounced degraded write
                            # the client saw fail — is skipped, so
                            # peering cannot wedge forever on it
                            # (unfound-object role).
                            if not self._unfound_grace_spent(oid):
                                all_acked = False
                                continue
                            self._unfound_since.pop(oid, None)
                            if e.op != OP_DELETE:
                                skipped[oid] = e.version
                            osd.perf.inc("recovery_unfound")
                            osd.log_exc(
                                f"pg {self.pgid} unfound {oid!r}")
                        else:
                            self._unfound_since.pop(oid, None)
                    if not all_acked:
                        return False
                # converge the peer's LOG POSITION when every CONTENT
                # push either landed or was legitimately skipped (split
                # strays, unfound debris — no message carried our
                # last_update, and a peer left behind would fence every
                # subsequent sub-write against the activation-seeded
                # acked_head, a permanent livelock, found on EC
                # splits). Push timeouts return above and retry.
                # Skipped-unfound oids ride along: a head converged
                # over a content gap must leave the gap ON RECORD at
                # the peer, or a later primary's reply-cache rebuild
                # reads the converged head as content-coverage and
                # fabricates an ack for an undecodable write.
                await self._push_log_head(o, s, skipped)
                await self._retry_peer_missing(o, s, info, skipped)
        finally:
            if held_local:
                osd.local_reserver.release(("pg", self.pgid))
            for o in reserved_remote:
                try:
                    await osd.send(
                        f"osd.{o}",
                        M.MBackfillReserve(pgid=self.pgid, op="release",
                                           osd=osd.id))
                except Exception:
                    pass

        if osd.osdmap.epoch != epoch:
            return False
        self.state = "active"
        self._unfound_since.clear()
        # peering just converged every member to our log: everything in
        # it counts as acked for the prefix fence
        self.acked_head = self.log.head
        # rebuild the write-dedup reply cache from the log's reqids: a
        # client whose reply was lost to the OLD primary's crash will
        # tick-resend the same tid HERE, and re-executing it would
        # double-apply (the reference rebuilds its reqid cache from
        # pg_log_entry_t the same way). Only the newest 512 entries
        # matter (cache cap), and a GENUINE cached reply — which may
        # carry a cls call's payload the log cannot reconstruct — must
        # never be overwritten by a fabricated bare-OK one.
        #
        # NEVER fabricate an OK for an entry this acting set cannot
        # produce content for (thrash-found phantom ack): a primary
        # appends locally BEFORE its fan-out gathers acks, so a failed
        # fan-out leaves an entry whose cells may live on OUR shard
        # alone — unrecoverable, and "acking" it from this cache loses
        # the write silently. Prefix-shaped logs make coverage cheap:
        # a member whose PRE-RECOVERY head >= version holds the entry,
        # and an EC stripe needs k such members to decode (replicated
        # needs one — us). The check uses the round's own `infos`
        # (gathered before any push converged heads); once blacklisted
        # a reqid stays phantom until a real re-execution clears it,
        # because later rounds' heads are convergence, not content.
        # A head alone is NOT coverage: convergence moves heads over
        # skipped-unfound gaps, and those gaps survive flaps in each
        # member's persistent missing set — a member missing the
        # entry's object holds its log position, not its cells, and
        # counting it would fabricate an ack for a write that can
        # never decode (thrash-found acked-write loss surviving the
        # in-memory phantom blacklist via a primary change).
        cover = [(i.last_update, i.missing) for i in infos.values()]
        kneed = osd.codec_for(self.pool).k if self.is_ec else 1
        for e in self.log.entries[-512:]:
            if not e.reqid[0]:
                continue
            key = (e.reqid[0], e.reqid[1])
            if sum(1 for h, miss in cover
                   if h >= e.version and e.oid not in miss) < kneed:
                # re-insert at the tail: a round that still can't cover
                # the entry refreshes its recency against the cap
                self._phantom_reqids.pop(key, None)
                self._phantom_reqids[key] = None
                continue
            if key in self._phantom_reqids:
                continue
            self._req_replies.setdefault(
                key,
                M.MOSDOpReply(tid=e.reqid[1], result=M.OK, data=b"",
                              size=0, outs=[(0, b"")],
                              epoch=osd.osdmap.epoch))
        while len(self._phantom_reqids) > 1024:
            del self._phantom_reqids[next(iter(self._phantom_reqids))]
        while len(self._req_replies) > 512:
            self._req_replies.popitem(last=False)
        osd.kick_pg_snap_trim(self)  # new primary: catch up on removals
        self.kick_migration()
        waiting, self.waiting = self.waiting, []
        for src, m in waiting:
            osd.spawn(self.do_op(src, m, requeued=True))
        return True

    # ================================================ pg_temp migration ==

    def kick_migration(self) -> None:
        """Start (or restart) pushing this PG's data to the incoming up
        members when acting is pg_temp-pinned (the backfill-to-up arc
        behind a pgp_num change)."""
        if not self.is_primary() or self.state != "active":
            return
        extras = frozenset(self.up_extras())
        if not extras:
            self.migrated.clear()
            self.mig_dirty.clear()
            self.mig_fresh.clear()
            self._mig_extras = frozenset()
            if tuple(self.pgid) in self.osd.osdmap.pg_temp:
                # pinned to a set IDENTICAL to up (re-placement landed
                # on the same members): nothing to move, but the pin
                # must still drop or the pool never reads as clean
                self.osd.spawn(
                    self.osd.mon_send(M.MPGTempClear(pgid=self.pgid)))
            return
        if extras != self._mig_extras:
            # membership changed: `migrated` was earned against the OLD
            # extras; a new extra has no bases, so deltas must not flow
            # to it until the push loop re-establishes full state
            self.migrated.clear()
            self._mig_extras = extras
        if self._migrate_task is None or self._migrate_task.done():
            self._migrate_task = asyncio.get_running_loop().create_task(
                self._migrate_to_up())

    async def _migrate_to_up(self) -> None:
        """Push every object's full state to the incoming up members.

        Protocol invariant: an oid enters
        ``self.migrated`` — and thereby starts receiving op-granular
        write deltas on the extras — only after one push round in which
        (a) every extra ACKED the full-state push and (b) no client
        write raced the round (``mig_dirty`` stayed clear). The
        dirty-check + ``migrated.add`` happen with no await between
        them, so in the single-reactor model no write can slip into the
        gap: any write either lands before the check (round retries) or
        after the add (it dual-commits the delta to now-complete
        bases). MPGTempClear is only sent once every oid converged."""
        osd = self.osd
        try:
            # migration pushes are backfill-class work: take a LOCAL
            # slot so a pgp change remapping many PGs migrates at most
            # osd_max_backfills of them at once (client IO on the
            # still-pinned acting sets keeps flowing meanwhile)
            await osd.local_reserver.request(("mig", self.pgid))
            spins = 0
            last_extras: frozenset = frozenset()
            #: oids this run decided not to migrate (split strays,
            #: unfound) — excluded from re-listing or they spin the loop
            skipped: set[bytes] = set()
            #: per-oid reconstruction-failure budget: transient survivor
            #: outages heal within it (mark-down changes the extras and
            #: restarts bookkeeping anyway); what remains is the debris
            #: of never-acked partial writes, which must not block the
            #: handoff forever (unfound role)
            fail_budget: dict[bytes, int] = {}
            while True:
                if not self.is_primary() or self.state != "active":
                    return  # superseded; the next primary restarts
                # re-read the extras every round: an unresponsive extra
                # is eventually marked down and leaves the up set — the
                # loop must converge on the survivors, not spin forever
                # pushing to a ghost. A CHANGED set invalidates the
                # migrated bookkeeping (new extras have no bases).
                extras = frozenset(self.up_extras())
                if not extras:
                    return  # pin dropped / up set collapsed into acting
                if extras != last_extras:
                    if last_extras:
                        self.migrated.clear()
                    self._mig_extras = extras
                    last_extras = extras
                # re-list every round: objects created (and possibly
                # failed mid-fan-out) after an earlier snapshot must
                # still be pushed before the pin may drop. Union in the
                # dirty set: an object DELETED after a partial push is
                # gone from the listing but its delete must still be
                # propagated to the extras, or it resurrects at handoff
                try:
                    oids = [o for o in osd.store.list_objects(self.cid)
                            if o != META_OID]
                except NotFound:
                    oids = []
                seen = set(oids)
                oids += [o for o in self.mig_dirty if o not in seen]
                pending = [o for o in oids
                           if o not in self.migrated
                           and o not in self.mig_fresh
                           and o not in skipped]
                if not pending and not self.mig_fresh:
                    break
                if not pending:  # only in-flight fresh creates remain
                    await asyncio.sleep(0.02)
                    continue
                retry: list[bytes] = []
                for oid in pending:
                    if not self.is_primary() or self.state != "active":
                        return
                    if oid in self.migrated:
                        continue
                    if self._subop_misdirected(oid):
                        skipped.add(oid)
                        continue  # split stray: child PG owns it now
                    self.mig_dirty.discard(oid)
                    v = self._object_version(oid)
                    try:
                        if v == ZERO and not self.osd.store.exists(
                                self.cid, oid):
                            # absent locally: propagate a delete ONLY
                            # with log evidence. "I don't hold it" is
                            # NOT "it was deleted" — a flap-back remap
                            # can make the pinned primary's own shard a
                            # hole awaiting recovery while the extras
                            # still hold the only live chunks, and an
                            # unfounded OP_DELETE push would destroy
                            # them (thrash-found data loss). A deleted
                            # object whose entry outlived the log trim
                            # still propagates; older ambiguity is left
                            # to scrub rather than resolved by erasure.
                            ent = next(
                                (e for e in reversed(self.log.entries)
                                 if e.oid == oid), None)
                            if ent is None or ent.op != OP_DELETE:
                                skipped.add(oid)
                                continue
                            ok = True
                            for o, s in extras:
                                ok &= await self._push_object(
                                    o, s, oid, Entry(OP_DELETE, oid, v))
                        else:
                            ok = True
                            for o, s in extras:
                                # non-forced: a newer incarnation dual-
                                # committed fresh on the extra wins
                                ok &= await self._push_object(
                                    o, s, oid, Entry(OP_MODIFY, oid, v),
                                    force=False)
                    except RuntimeError:
                        # push/reconstruction failure. Usually transient
                        # (a survivor shard briefly unreachable): RETRY
                        # while holding the pin — but only within a
                        # budget: an object that NEVER reconstructs is
                        # the debris of an unacked partial write (the
                        # client saw a failure), and it must not block
                        # the handoff forever.
                        osd.perf.inc("recovery_unfound")
                        left = fail_budget.get(oid, 15) - 1
                        fail_budget[oid] = left
                        if left <= 0:
                            osd.log_exc(
                                f"pg {self.pgid} unfound {oid!r}")
                            skipped.add(oid)
                        else:
                            retry.append(oid)
                        continue
                    # atomic wrt the reactor: no await between the
                    # dirty/version check and migrated.add
                    if (ok and oid not in self.mig_dirty
                            and self._object_version(oid) == v):
                        self.migrated.add(oid)
                    else:
                        retry.append(oid)
                pending = retry
                if pending:
                    # writes (or push timeouts) raced this round; yield
                    # so the op stream makes progress, then re-push
                    spins += 1
                    await asyncio.sleep(min(0.05 * spins, 0.5))
            # all data on the up set (including dual-committed writes):
            # ask the mon to drop the pin; the up set takes over on the
            # next epoch
            await osd.mon_send(M.MPGTempClear(pgid=self.pgid))
        except asyncio.CancelledError:
            raise
        except Exception:
            osd.log_exc(f"pg {self.pgid} up-migration")
        finally:
            osd.local_reserver.release(("mig", self.pgid))

    async def _reserve_remote(self, o: int) -> bool:
        """Ask recovery target osd.o for an inbound backfill slot
        (MBackfillReserve request/grant); False on timeout — the
        peering round retries, and the bounded wait breaks reservation
        deadlock cycles between mutually-backfilling OSDs."""
        osd = self.osd
        key = ("bfgrant", self.pgid, o)
        fut = osd.expect_reply(key)
        try:
            await osd.send(
                f"osd.{o}",
                M.MBackfillReserve(pgid=self.pgid, op="request",
                                   osd=osd.id))
            await asyncio.wait_for(fut, osd.subop_timeout * 4)
            return True
        except (asyncio.TimeoutError, Exception):
            osd.drop_reply(key)
            try:  # cancel the queued request on the target
                await osd.send(
                    f"osd.{o}",
                    M.MBackfillReserve(pgid=self.pgid, op="release",
                                       osd=osd.id))
            except Exception:
                pass
            return False

    def _note_recovery_progress(self) -> None:
        """Record that some recovery work SUCCEEDED on this primary
        (push acked, own chunk rebuilt, pull landed). The unfound
        grace anchors against this reading: while it keeps moving,
        recovery is merely slow — not wedged — and no acked object
        may be written off (ROADMAP item d)."""
        self._recovery_progress += 1

    def _unfound_grace_spent(self, oid: bytes) -> bool:
        """True only when UNFOUND_GRACE elapsed for ``oid`` with ZERO
        recovery progress anywhere in this PG — the rollback gate
        keyed on recovery progress, not wall clock alone. Any progress
        since the mark re-anchors the grace (and the mark), so a slow
        grind (delayed reconstructs, cold compiles) never classifies a
        recoverable acked object unfound, while genuine bounced-write
        debris — which stalls alone once everything else recovered —
        still escapes the wedge within one grace period."""
        now = asyncio.get_running_loop().time()
        mark = self._unfound_since.get(oid)
        if mark is None or mark[1] != self._recovery_progress:
            self._unfound_since[oid] = (now, self._recovery_progress)
            return False
        return now - mark[0] >= UNFOUND_GRACE

    async def _recover_self(self, best_key, best: PGInfo) -> None:
        """Repair our own copy, THEN adopt the authoritative log: pull
        whole objects from the authoritative peer (replicated) or
        reconstruct our shard's chunks from k survivors (EC — a peer's
        chunk is shard-specific and useless to us).

        Ordering is load-bearing: if the log were adopted first and a
        pull then failed, the retried peering round would see an
        up-to-date log, skip recovery, and go active with stale
        objects — the missing-set must stay derivable from our
        persisted log until every object actually landed (the
        reference's pg_missing_t tracks exactly this)."""
        osd = self.osd
        missing = best.log.missing_after(self.log.head)
        o, s = best_key
        if missing is None:
            # too far behind: full backfill; any member's object list is
            # the authoritative enumeration
            fut = osd.expect_reply(("scan", self.pgid, o, s))
            await osd.send(
                f"osd.{o}",
                M.MPGScan(pgid=self.pgid, shard=s, epoch=osd.osdmap.epoch),
            )
            reply = await asyncio.wait_for(fut, osd.subop_timeout)
            todo = dict(reply.objects)
        else:
            todo = {
                oid: e.version
                for oid, e in missing.items()
                if e.op != OP_DELETE
            }
            for oid, e in missing.items():
                if e.op == OP_DELETE:
                    self.missing.pop(oid, None)
                    if osd.store.exists(self.cid, oid):
                        t2 = tx.Transaction()
                        t2.remove(self.cid, oid)
                        osd.store.queue_transaction(t2)
        for oid, version in todo.items():
            if self._object_version(oid) == version:
                self.missing.pop(oid, None)
                continue
            if self._subop_misdirected(oid):
                continue  # split stray: belongs to a child PG now
            if self.is_ec:
                try:
                    await self._recover_own_chunk(oid, version)
                except RuntimeError:
                    # unreconstructable (bounced degraded write that
                    # never reached k shards): skip, don't wedge
                    # peering (unfound-object role) — but RECORD the
                    # gap: we are about to adopt a log that claims
                    # this version, and our info must not later count
                    # as content-coverage for it (fabricated-ack
                    # guard)
                    self.missing[oid] = version
                    osd.perf.inc("recovery_unfound")
                    osd.log_exc(f"pg {self.pgid} unfound {oid!r}")
            else:
                fut = osd.expect_reply(("push", self.pgid, self.shard, oid))
                await osd.send(
                    f"osd.{o}",
                    M.MPull(pgid=self.pgid, shard=s, oid=oid,
                            epoch=osd.osdmap.epoch),
                )
                await asyncio.wait_for(fut, osd.subop_timeout)
                self._note_recovery_progress()
        # every object landed (or was recorded missing): NOW the
        # authoritative log is ours
        self.log = best.log
        t = tx.Transaction()
        self._ensure_coll(t)
        self._persist_log(t)
        self._persist_missing(t)
        osd.store.queue_transaction(t)

    async def _recover_own_chunk(self, oid: bytes,
                                 version: tuple[int, int]) -> None:
        # under the PG lock: a reconstruct racing a concurrent client
        # write's multi-shard fanout (scrub repair runs while active)
        # would decode a mix of old and new cells and PERSIST it under
        # freshly computed — self-consistent — hinfo CRCs
        async with self.lock:
            chunk, attrs = await self._reconstruct_chunk(oid, self.shard)
            t = tx.Transaction()
            self._ensure_coll(t)
            t.truncate(self.cid, oid, 0)
            t.write(self.cid, oid, 0, chunk)
            # wipe first: attrs the survivors DON'T have (stale ss / wh
            # from our pre-crash copy) must not outlive recovery. The
            # reconstruct's own ATTR_V wins over the caller's target —
            # a group-fallback rebuild one generation behind the log
            # must be LABELED behind, or reads would mix generations
            t.rmattrs(self.cid, oid)
            t.setattrs(self.cid, oid, {ATTR_V: enc_ver(version), **attrs})
            mver = self.missing.get(oid)
            if mver is not None:
                got = (dec_ver(attrs[ATTR_V]) if ATTR_V in attrs
                       else tuple(version))
                if got >= tuple(mver):
                    # the rebuild actually covers the recorded gap (a
                    # group-fallback one generation BEHIND it does not)
                    self.missing.pop(oid, None)
                    self._persist_missing(t)
            self.osd.store.queue_transaction(t)
            self._note_recovery_progress()

    async def _retry_peer_missing(self, o: int, s: int, info: PGInfo,
                                  exclude: dict | None = None) -> None:
        """Push-retry the content gaps a peer has on record — objects
        BEHIND its converged head, invisible to missing_after — in
        case strays or revived members make the reconstruct succeed
        now. A still-unfound object just stays on the peer's record
        (where it keeps blocking ack fabrication); nothing here wedges
        the peering round."""
        for moid, mver in info.missing.items():
            if exclude and moid in exclude:
                continue  # skipped this very round: would fail again
            if self._subop_misdirected(moid):
                continue
            try:
                await self._push_object(
                    o, s, moid, Entry(OP_MODIFY, moid, tuple(mver)))
            except RuntimeError:
                continue

    async def _backfill_peer(self, o: int, s: int
                             ) -> dict[bytes, tuple[int, int]]:
        """Push every object to a peer whose log diverged past our tail
        (recover_backfill role — full rescan instead of log delta).
        Returns the oids skipped as unfound (the caller ships them with
        the head push — see _do_peering)."""
        skipped: dict[bytes, tuple[int, int]] = {}
        for oid in self.osd.store.list_objects(self.cid):
            if oid == META_OID or self._subop_misdirected(oid):
                continue
            v = self._object_version(oid)
            try:
                await self._push_object(o, s, oid,
                                        Entry(OP_MODIFY, oid, v))
            except RuntimeError:
                skipped[oid] = v
                self.osd.perf.inc("recovery_unfound")
                self.osd.log_exc(f"pg {self.pgid} unfound {oid!r}")
        return skipped

    async def _push_log_head(self, o: int, s: int,
                             skipped: dict | None = None) -> None:
        """Ship ONLY our log position to a peer (a content-free delete
        push of an empty oid): handle_push adopts last_update, so the
        peer's head converges even when every object push was skipped.
        ``skipped`` (oid -> version) names the content gaps this
        convergence papers over; the peer persists them in its missing
        set so its info never claims content-coverage for them."""
        attrs = {"_missing": enc_missing(skipped)} if skipped else {}
        try:
            await self._push_object(o, s, b"",
                                    Entry(OP_DELETE, b"", self.log.head),
                                    extra_attrs=attrs)
        except Exception:
            pass  # best-effort; the next round retries

    async def _push_object(self, o: int, s: int, oid: bytes,
                           e: Entry, force: bool = True,
                           expect: tuple = UNCOND,
                           extra_attrs: dict | None = None) -> bool:
        """Push one object (or its EC chunk) to member (o, shard s).
        Returns True iff the peer acked — callers that gate delta
        dual-writes on a complete base (pg_temp migration) must treat
        a timeout as not-pushed. ``expect`` (repair pushes) installs
        only while the receiver's copy is still at that version — see
        MPushOp.expect. ``extra_attrs`` ride the message for control
        payloads (the head push's ``_missing`` set)."""
        osd = self.osd
        if e.op == OP_DELETE:
            data, attrs = None, {}
        elif self.is_ec:
            # under the PG lock: reconstructing while a client write's
            # fanout is mid-flight (pg_temp migration and scrub repair
            # push while active) must not mix generations — the pushed
            # chunk would carry fresh self-consistent hinfo over torn
            # data. The send/ack below stays OUTSIDE the lock; a write
            # landing after reconstruct bumps the version and the
            # callers' version re-check / push version guard handle it.
            async with self.lock:
                data, attrs = await self._reconstruct_chunk(oid, s)
        else:
            try:
                data = bytes(osd.store.read(self.cid, oid))
                attrs = osd.store.getattrs(self.cid, oid)
            except Exception:
                if not osd.store.exists(self.cid, oid):
                    return True  # deleted meanwhile
                # a real local read failure must NOT count as pushed —
                # callers gate `migrated` on the return value; surface
                # it as the unfound class the callers already handle
                raise RuntimeError(
                    f"unreadable local copy of {oid!r}") from None
        osd.perf.inc("recovery_pushes")
        version = e.version
        if data is not None and ATTR_V in attrs:
            # label the push with the generation the content actually
            # is: a group-fallback reconstruct may rebuild one behind
            # the log head, and a lying label would let later reads
            # mix generations (the client's retry catches content up)
            version = dec_ver(attrs[ATTR_V])
        tid = osd.new_subtid()
        key = ("pushr", self.pgid, s, oid, o, tid)
        fut = osd.expect_reply(key)
        await osd.send(
            f"osd.{o}",
            M.MPushOp(pgid=self.pgid, shard=s, oid=oid,
                      version=version, data=data or b"",
                      attrs={**(attrs if data is not None else
                                {"_deleted": b"1"}),
                             **(extra_attrs or {})},
                      epoch=osd.osdmap.epoch, force=int(force),
                      last_update=self.log.head, tid=tid,
                      expect=expect),
        )
        try:
            await asyncio.wait_for(fut, osd.subop_timeout)
            if oid:  # content progress (the head push is log position)
                self._note_recovery_progress()
            return True
        except asyncio.TimeoutError:
            osd.drop_reply(key)
            return False

    async def _repair_chunk_subchunks(self, oid: bytes, shard: int):
        """Bandwidth-optimal single-shard rebuild for regenerating
        codecs (repair_one_lost_chunk over the wire): d helpers each
        ship only their repair-plane SUB-CHUNKS (1/q of every cell,
        MECSubRead.subruns) and the batched repair dispatch rebuilds
        the full shard — repair traffic d/q cell-volumes instead of
        the k whole chunks an MDS rebuild reads. Returns None whenever
        the optimal path does not strictly apply (plan not partial,
        helper failure, version disagreement) so the caller's hardened
        full reconstruct takes over."""
        codec = self.osd.codec_for(self.pool)
        si = self.osd.sinfo_for(self.pool)
        live = {s: o for o, s in self.live_members()}
        usable = [s for s in sorted(live) if s != shard]
        if not codec.is_repair({shard}, set(usable)):
            return None
        need = codec.minimum_to_decode([shard], usable)
        if shard in need or len(need) < codec.d:
            return None
        runs = next(iter(need.values()))
        subs = codec.get_sub_chunk_count()
        fetched = sum(c for _, c in runs)
        if fetched >= subs or any(r != runs for r in need.values()):
            return None  # not actually a partial single-loss plan
        packed = _pack_subruns(runs)
        vers: dict[int, tuple[int, int]] = {}
        size_attrs: dict[int, bytes] = {}
        attrs_by: dict[int, dict[str, bytes]] = {}
        chunks: dict[int, bytes] = {}

        def _mk(j: int):
            return lambda: self._fetch_shard_copy(
                oid, j, live, vers, size_attrs, attrs_by,
                subruns=packed)

        d = len(need)
        helpers = sorted(need)
        # hedge candidates: helpers beyond the d-of-n plan ship the
        # SAME repair-plane sub-runs; the first d consistent arrivals
        # rebuild the shard and the stragglers are cancelled
        cand = sorted((s for s in usable
                       if s not in need and s != shard),
                      key=lambda s: (
                          self.osd.peer_ewma.latency(live[s])
                          if live.get(s) != self.osd.id else -1.0, s))
        extras = [(s, live[s], _mk(s))
                  for s in cand[: self._hedge_extra()]]

        def _suff(out: dict) -> bool:
            return sum(1 for r in out.values()
                       if r is not None
                       and not isinstance(r, BaseException)) >= d

        out = await hedged_fanout(
            self.osd, [(j, live[j], _mk(j)) for j in helpers],
            extras, _suff,
            nbytes=lambda r: (len(r) if isinstance(
                r, (bytes, bytearray, memoryview)) else 0))
        ok = sorted(j for j, r in out.items()
                    if r is not None
                    and not isinstance(r, BaseException))
        if len(ok) < d:
            # helper failure/transient either way: the full path
            # re-plans with its own retry/fallback machinery
            return None
        chosen = ok[:d]
        if chosen != helpers:
            # hedge substitution: re-derive the repair plan over the
            # ACTUAL helper set and demand the same sub-run layout —
            # any disagreement (helper-set-dependent planes) falls
            # back to the hardened full path
            try:
                need2 = codec.minimum_to_decode([shard], chosen)
            except Exception:
                return None
            if (shard in need2 or sorted(need2) != chosen
                    or any(r != runs for r in need2.values())):
                return None
        for j in chosen:
            chunks[j] = out[j]
        # one consistent generation or bust: the full path owns every
        # version-skew story (fallback groups, strays, demotions)
        gens = {vers.get(j, ZERO) for j in chunks}
        if len(gens) != 1:
            return None
        lens = {len(c) for c in chunks.values()}
        if len(lens) != 1:
            return None
        slice_bytes = si.su * fetched // subs
        total = lens.pop()
        if slice_bytes == 0 or total == 0 or total % slice_bytes:
            return None
        ncells = total // slice_bytes
        order = sorted(chunks)
        surv = np.stack([
            np.frombuffer(chunks[j], dtype=np.uint8)
            .reshape(ncells, slice_bytes) for j in order
        ], axis=1)  # (ncells, d, su/q)
        present_g = tuple(codec._position_to_generator(p)
                          for p in order)
        want_g = (codec._position_to_generator(shard),)
        rebuilt = await self.osd.ec_batcher.repair_cells(
            codec, present_g, want_g, surv)
        chunk_arr = np.ascontiguousarray(
            rebuilt[:, 0, :]).reshape(-1)
        self.osd.perf.inc("ec_repair_subchunk")
        self.osd.perf.inc("ec_repair_bytes_fetched",
                          sum(len(c) for c in chunks.values()))
        self.osd.perf.inc("ec_repair_bytes_rebuilt", chunk_arr.size)
        best = max(chunks, key=lambda j: vers.get(j, ZERO))
        user_attrs: dict[str, bytes] = {}
        for j in sorted(chunks, key=lambda j: vers.get(j, ZERO)):
            user_attrs.update(attrs_by.get(j, {}))
        out_attrs = {
            **user_attrs,
            ATTR_SIZE: size_attrs.get(best, denc.enc_u64(0)),
            ATTR_HINFO: st.enc_hinfo(
                st.StripeInfo.cell_crcs(chunk_arr, si.su)),
        }
        vbest = vers.get(best, ZERO)
        if vbest != ZERO:
            out_attrs[ATTR_V] = enc_ver(vbest)
        return memoryview(chunk_arr).toreadonly(), out_attrs

    async def _fetch_shard_copy(self, oid: bytes, j: int,
                                live: dict[int, int], vers: dict,
                                size_attrs: dict, attrs_by: dict,
                                subruns: bytes = b""):
        """Whole-file, hinfo-verified fetch of shard position ``j``
        from its live holder; records version/size/recovery-attrs and
        returns the chunk bytes, or None when unreadable/absent.
        Local reads pass through the ``ec_read_bitflip`` fault site,
        and a failed hinfo check counts as ``ec_read_crc_err``. With
        ``subruns`` (regenerating-code repair) only the selected
        sub-chunk slices of each cell come back — the holder still
        verifies its full cells."""
        target = live.get(j)
        if target is None:
            return None
        cidj = self._shard_cid(j)
        if target == self.osd.id:
            try:
                chunk = bytes(self.osd.store.read(cidj, oid))
                chunk = self._maybe_bitflip(chunk, oid, j)
                self._verify_hinfo(cidj, oid, chunk)
                vers[j] = self._shard_obj_version(cidj, oid)
                size_attrs[j] = self.osd.store.getattr(cidj, oid,
                                                       ATTR_SIZE)
                attrs_by[j] = {
                    k: v
                    for k, v in self.osd.store.getattrs(cidj,
                                                        oid).items()
                    if _is_recovery_attr(k)
                }
                if subruns:
                    si = self.osd.sinfo_for(self.pool)
                    chunk = _slice_subruns(
                        chunk, si.su, subruns,
                        self.osd.codec_for(self.pool))
                return chunk
            except HinfoError:
                self.osd.perf.inc("ec_read_crc_err")
                return None
            except Exception:
                return None
        subtid = self.osd.new_subtid()
        fut = self.osd.expect_reply(subtid)
        try:
            await self.osd.send(
                f"osd.{target}",
                M.MECSubRead(tid=subtid, pgid=self.pgid, shard=j,
                             oid=oid, offset=0, length=-1,
                             subruns=subruns, trace=_trace_ctx()),
            )
            reply = await self.osd.await_reply(subtid, fut, target)
        except BaseException:
            # transport failure (peer flapping, send raced a kill) is
            # TRANSIENT: re-raise after cleanup so callers retry the
            # round — swallowing it here would make the shard look
            # unreadable and let recovery misclassify a reachable
            # object as unfound debris (and converge log heads over
            # the gap: acked-write loss). BaseException, not
            # Exception: a hedged fan-out cancels losers, and a
            # CancelledError slipping past would leak the pending
            # reply expectation.
            self.osd.drop_reply(subtid)
            raise
        if reply.result != M.OK:
            return None
        vers[j] = tuple(reply.ver)
        size_attrs[j] = denc.enc_u64(reply.size)
        attrs_by[j] = dict(reply.attrs)
        return reply.data

    async def _collect_stray_copies(self, oid: bytes,
                                    live: dict[int, int]) -> list:
        """Probe every up OSD for stray shard copies of ``oid`` left by
        prior-interval placements (might_have_unfound role). Current
        holders are skipped (the caller already fetched them). Returns
        [(ver, pos, chunk, size_attr, attrs)] hinfo-verified; probing
        an OSD that never held the shard is cheap (ENOENT)."""
        codec = self.osd.codec_for(self.pool)
        osdmap = self.osd.osdmap

        async def _probe(pos: int, o: int):
            tmp_v: dict = {}
            tmp_s: dict = {}
            tmp_a: dict = {}
            try:
                got = await self._fetch_shard_copy(
                    oid, pos, {pos: o}, tmp_v, tmp_s, tmp_a)
            except Exception:
                got = None  # transient peer failure: best-effort
            if got is None or tmp_v.get(pos, ZERO) == ZERO:
                return None
            return (tmp_v[pos], pos, got, tmp_s.get(pos),
                    tmp_a.get(pos, {}))

        # all probes fly CONCURRENTLY: callers hold the PG lock across
        # the sweep, and chunk_count x n_osds serial round-trips (each
        # up to a subop timeout when a peer dies mid-probe) would stall
        # every client op on the PG; one concurrent round bounds the
        # sweep at a single round-trip/timeout. Result order stays the
        # deterministic (pos, osd) iteration order.
        probes = [_probe(pos, o)
                  for pos in range(codec.get_chunk_count())
                  for o in range(osdmap.n_osds)
                  if osdmap.is_up(o) and o != live.get(pos)]
        found = await asyncio.gather(*probes)
        out = [f for f in found if f is not None]
        if out:
            self.osd.perf.inc("ec_stray_reads", len(out))
        return out

    async def _reconstruct_chunk(self, oid: bytes, shard: int):
        """Rebuild shard `shard`'s chunk from k survivors (the recovery
        read-reconstruct path, ECBackend continue_recovery_op role).
        Unreadable survivors (EIO, bit rot failing their hinfo) are
        excluded and the fetch set re-planned, like _read_ec — and so
        are version-lagging survivors (ATTR_V cross-check): a rebuild
        mixing a revived stale shard's cells with current ones would
        PERSIST wrong bytes under fresh self-consistent CRCs. The
        returned attrs carry the size/recovery attrs AND the ATTR_V of
        the (max-version) generation the rebuild represents.

        Regenerating codecs (Clay) first try the bandwidth-optimal
        SUB-CHUNK repair: d helpers ship 1/q of their cells instead of
        k shipping whole chunks (_repair_chunk_subchunks). Any wrinkle
        — helper failure, version disagreement, a plan that is not
        actually partial — falls back to this hardened full path."""
        codec = self.osd.codec_for(self.pool)
        if hasattr(codec, "repair_batch"):
            try:
                out = await self._repair_chunk_subchunks(oid, shard)
            except Exception:
                out = None  # full path below re-plans from scratch
            if out is not None:
                return out
        live = {s: o for o, s in self.live_members()}
        chunks: dict[int, bytes] = {}
        demoted: dict[int, bytes] = {}  # kept for the group fallback
        vers: dict[int, tuple[int, int]] = {}
        size_attrs: dict[int, bytes] = {}
        attrs_by: dict[int, dict[str, bytes]] = {}
        failed: set[int] = {shard}
        #: hedge results from shards outside the plan (see _read_ec)
        spare: dict[int, bytes] = {}
        slow: set[int] = set()
        tried_self = False
        tried_strays = False
        while True:
            usable = [s for s in sorted(live)
                      if s not in failed
                      and (s not in slow or s in chunks or s in spare)]
            try:
                need = codec.minimum_to_decode([shard], usable)
            except Exception:
                if slow and not all(
                        s in chunks or s in spare for s in slow):
                    slow.clear()  # stragglers rejoin: see _read_ec
                    continue
                # newest generation can't reach k members (interrupted
                # fan-out): rebuild the newest generation that can —
                # see _best_version_group; the retry re-applies the
                # unacked write on top. The TARGET's own stored copy
                # (hinfo-verified) joins the candidate pool here: when
                # the target already holds the authoritative older
                # generation, it completes that group (the scrub-
                # rollback arc needs exactly this).
                if not tried_self:
                    tried_self = True
                    try:
                        got = await self._fetch_shard_copy(
                            oid, shard, live, vers, size_attrs,
                            attrs_by)
                    except Exception:
                        got = None  # best-effort last-ditch candidate
                    if got is not None:
                        demoted[shard] = got
                if not tried_strays:
                    # prior-interval STRAY copies (might_have_unfound
                    # role): shard positions remapped during flaps
                    # leave acked chunks in old holders' stores, so
                    # the current up set alone can hold an acked
                    # generation below k — and scrub would roll it
                    # back as orphan debris (acked-write loss). Probe
                    # every up OSD's store before giving that
                    # generation up.
                    tried_strays = True
                    stray = await self._collect_stray_copies(oid, live)
                    if stray:
                        pool = [(vers.get(p, ZERO), p, c,
                                 size_attrs.get(p), attrs_by.get(p, {}))
                                for p, c in {**demoted,
                                             **chunks}.items()]
                        gen = _assemble_generation(pool + stray,
                                                   codec.k)
                        if gen is not None:
                            chunks, vers, size_attrs, attrs_by = gen
                            break
                fb = _best_version_group({**demoted, **chunks},
                                         vers, codec.k)
                if fb is not None:
                    chunks = fb
                    break
                raise RuntimeError(
                    f"cannot reconstruct shard {shard} of {oid!r}: "
                    f"unreadable {sorted(failed - {shard})}"
                )
            def _mk(j: int):
                return lambda: self._fetch_shard_copy(
                    oid, j, live, vers, size_attrs, attrs_by)

            primary = []
            for j in sorted(need):
                if j in chunks:
                    continue
                if j in spare:
                    chunks[j] = spare.pop(j)
                    continue
                primary.append((j, live[j], _mk(j)))
            extras = []
            if primary:
                cand = sorted(
                    (s for s in usable
                     if s not in need and s not in chunks
                     and s not in spare),
                    key=lambda s: (
                        self.osd.peer_ewma.latency(live[s]), s))
                extras = [(s, live[s], _mk(s))
                          for s in cand[: self._hedge_extra()]]

            def _suff(out: dict) -> bool:
                have = set(chunks) | set(spare) | {
                    j for j, r in out.items()
                    if r is not None
                    and not isinstance(r, BaseException)}
                try:
                    plan = codec.minimum_to_decode([shard],
                                                   sorted(have))
                except Exception:
                    return False
                return all(p in have for p in plan)

            out = {}
            if primary:
                out = await hedged_fanout(
                    self.osd, primary, extras, _suff,
                    nbytes=lambda r: (len(r) if isinstance(
                        r, (bytes, bytearray, memoryview)) else 0))
            exc = None
            for j in sorted(out):
                r = out[j]
                if isinstance(r, BaseException):
                    exc = exc if exc is not None else r
                elif r is None:
                    failed.add(j)
                elif j in need and j not in chunks:
                    chunks[j] = r
                else:
                    spare[j] = r
            if not all(j in chunks for j in need):
                # absent-from-outcomes plan members were hedge-
                # cancelled losers (slow, not dead); a transport
                # failure with NO decodable subset keeps the legacy
                # transient contract — re-raise so the caller retries
                slow.update(j for j in need
                            if j not in chunks and j not in failed
                            and j not in out)
                if exc is not None and not _suff(out):
                    raise exc
                continue  # re-plan with the enlarged failed set
            if self._demote_version_laggards(chunks, vers, demoted,
                                             failed):
                continue
            break
        self._count_stale_demotions(chunks, vers, demoted)
        # size/attrs must come from the generation being rebuilt: the
        # max-version contributor (union keeps shard-invariant extras,
        # the best shard's values win conflicts)
        best = max(chunks, key=lambda j: vers.get(j, ZERO)) \
            if chunks else None
        size_attr = size_attrs.get(best)
        if size_attr is None:
            size_attr = next(iter(size_attrs.values()),
                             denc.enc_u64(0))
        user_attrs: dict[str, bytes] = {}
        for j in sorted((j for j in attrs_by if j in chunks),
                        key=lambda j: vers.get(j, ZERO)):
            user_attrs.update(attrs_by[j])
        vbest = vers.get(best, ZERO) if best is not None else ZERO
        maxlen = max(len(c) for c in chunks.values()) if chunks else 0
        si = self.osd.sinfo_for(self.pool)
        # repair economics ledger: survivor bytes fetched per shard
        # bytes rebuilt (k-to-1 here; the sub-chunk path does better)
        self.osd.perf.inc("ec_repair_bytes_fetched",
                          sum(len(c) for c in chunks.values()))
        self.osd.perf.inc("ec_repair_bytes_rebuilt", maxlen)
        # batched rebuild through the ECBatcher (one stacked-matrix
        # dispatch shared with every other decode in flight); a wanted
        # PARITY shard folds into the recovery matrix, so it is still
        # a single matmul, not decode-then-re-encode
        g = codec._position_to_generator(shard)
        rebuilt = await self._decode_cells_batched(
            codec, si, chunks, maxlen, want_generators=(g,))
        # the rebuilt chunk stays an array view end-to-end: the hinfo
        # CRC pass reads it in place, and both consumers — the push
        # message body and the store transaction — take views, so the
        # old whole-chunk .tobytes() copy is gone (buffer plane)
        chunk_arr = np.ascontiguousarray(
            rebuilt[:, 0, :]).reshape(-1)[:maxlen]
        out_attrs = {
            **user_attrs,
            ATTR_SIZE: size_attr,
            ATTR_HINFO: st.enc_hinfo(
                st.StripeInfo.cell_crcs(chunk_arr, si.su)),
        }
        if vbest != ZERO:
            # the generation this rebuild represents; callers that know
            # a newer authoritative version override it
            out_attrs[ATTR_V] = enc_ver(vbest)
        return memoryview(chunk_arr).toreadonly(), out_attrs

    # ---------------------------------------------- peering-side handlers

    async def handle_info_req(self, src: str, m: M.MPGInfoReq) -> None:
        info = PGInfo(self.log.head, self.log, dict(self.missing))
        await self.osd.send(
            src,
            M.MPGInfoReply(pgid=self.pgid, epoch=self.osd.epoch,
                           shard=m.shard, info=info.encode()),
        )

    async def handle_scan(self, src: str, m: M.MPGScan) -> None:
        objects = {}
        if self.cid in self.osd.store.list_collections():
            for oid in self.osd.store.list_objects(self.cid):
                if oid != META_OID:
                    objects[oid] = self._object_version(oid)
        await self.osd.send(
            src,
            M.MPGScanReply(pgid=self.pgid, shard=m.shard, objects=objects),
        )

    async def handle_pull(self, src: str, m: M.MPull) -> None:
        try:
            data = bytes(self.osd.store.read(self.cid, m.oid))
            attrs = self.osd.store.getattrs(self.cid, m.oid)
            v = self._object_version(m.oid)
        except Exception:
            data, attrs, v = b"", {"_deleted": b"1"}, ZERO
        await self.osd.send(
            src,
            M.MPushOp(pgid=self.pgid, shard=m.shard, oid=m.oid, version=v,
                      data=data, attrs=attrs, epoch=self.osd.epoch,
                      last_update=self.log.head),
        )

    # ========================================================== scrub ==

    def _local_scrub_map(self):
        """ScrubMap of this PG instance: batched digests + versions;
        EC shards self-verify chunk bytes against stored hinfo."""
        from .scrub import digest_map

        objects = {}
        errors: list[bytes] = []
        if self.cid not in self.osd.store.list_collections():
            return objects, errors
        digests = digest_map(self.osd.store, self.cid, skip=(META_OID,),
                             torch_device=self.osd.device)
        for oid, (size, crc) in digests.items():
            objects[oid] = (self._object_version(oid), (size, crc))
            if self.is_ec:
                # self-verify every cell against the stored per-cell
                # hinfo (bit-rot detection)
                try:
                    self._verify_hinfo(
                        self.cid, oid,
                        bytes(self.osd.store.read(self.cid, oid)),
                    )
                except IOError:
                    errors.append(oid)
                except Exception:
                    pass  # no hinfo attr (e.g. meta-only objects)
        return objects, errors

    async def handle_scrub(self, src: str, m: M.MScrub) -> None:
        objects, errors = self._local_scrub_map()
        await self.osd.send(
            src,
            M.MScrubReply(pgid=self.pgid, shard=m.shard, tid=m.tid,
                          objects=objects, errors=errors),
        )

    async def scrub(self) -> dict:
        """Primary-driven scrub round: gather ScrubMaps from every live
        member, compare, repair divergent/corrupt copies via the
        recovery push machinery. Returns a report (the scrubber's
        inconsistent-objects output)."""
        osd = self.osd
        if not self.is_primary() or self.state != "active":
            raise RuntimeError("scrub requires an active primary")
        osd.perf.inc("scrubs")
        peers = [(o, s) for o, s in self.live_members() if o != osd.id]
        maps: dict[tuple[int, int], dict] = {}
        bad: dict[tuple[int, int], set[bytes]] = {}
        objs, errs = self._local_scrub_map()
        me = (osd.id, self.shard)
        maps[me] = objs
        bad[me] = set(errs)
        waits = []
        for o, s in peers:
            subtid = osd.new_subtid()
            fut = osd.expect_reply(subtid)
            waits.append((o, s, subtid, fut))
            await osd.send(
                f"osd.{o}",
                M.MScrub(pgid=self.pgid, shard=s, epoch=osd.epoch,
                         tid=subtid),
            )
        for o, s, subtid, fut in waits:
            reply = await osd.await_reply(subtid, fut, o)
            maps[(o, s)] = reply.objects
            bad[(o, s)] = set(reply.errors)

        report = {"inconsistent": [], "repaired": [], "clean": 0}
        all_oids = sorted({oid for m_ in maps.values() for oid in m_})
        for oid in all_oids:
            if self.is_ec:
                ok = await self._scrub_repair_ec(oid, maps, bad)
            else:
                ok = await self._scrub_repair_replicated(oid, maps)
            if ok is None:
                report["clean"] += 1
            else:
                report["inconsistent"].append(oid)
                report["repaired"].extend(ok)
        return report

    async def _scrub_repair_replicated(self, oid, maps):
        """Compare whole-object digests across replicas; push the
        authoritative copy over divergent/missing ones. Returns None if
        clean, else the list of repaired member keys."""
        from .scrub import pick_authoritative

        copies = {key: m_[oid] for key, m_ in maps.items() if oid in m_}
        auth_key, auth = pick_authoritative(copies)
        divergent = [
            key for key in maps
            if maps[key].get(oid) != (auth[0], auth[1])
        ]
        if not divergent:
            return None
        me = (self.osd.id, self.shard)
        if me in divergent:
            # repair self first: pull from the authoritative holder
            o, s = auth_key
            fut = self.osd.expect_reply(("push", self.pgid, self.shard,
                                         oid))
            await self.osd.send(
                f"osd.{o}",
                M.MPull(pgid=self.pgid, shard=s, oid=oid,
                        epoch=self.osd.epoch),
            )
            await asyncio.wait_for(fut, self.osd.subop_timeout)
        for o, s in divergent:
            if (o, s) == me:
                continue
            await self._push_object(
                o, s, oid, Entry(OP_MODIFY, oid, auth[0])
            )
        return divergent

    async def _scrub_repair_ec(self, oid, maps, bad):
        """EC scrub: a member is divergent when its version lags, its
        chunk fails its own hinfo (bit rot), or the chunk is missing;
        repair = reconstruct that shard from survivors and push.

        The reconstruct may legitimately come back BEHIND ``newest``
        (group fallback): a write fan-out that died mid-flight leaves
        a < k minority one generation ahead — never ack-able, so the
        decodable generation is authoritative and the orphans ROLL
        BACK to it (the divergent-entry rollback of the reference's
        merge_log). The push's expect-CAS makes that rollback land
        only on the exact orphan version scrub observed — a racing
        client write wins. Unreconstructable objects are counted
        unfound and skipped, never allowed to wedge the scrub."""
        copies = {key: m_[oid] for key, m_ in maps.items() if oid in m_}
        newest = max(v for v, _ in copies.values())
        # authoritative generation = the newest one that can DECODE
        # (>= k healthy members); a < k orphan generation was never
        # ack-able and rolls back rather than dragging the PG after it
        k = self.osd.codec_for(self.pool).k
        vcount: dict = {}
        for key, (v, _dig) in copies.items():
            if oid not in bad[key]:
                vcount[v] = vcount.get(v, 0) + 1
        decodable = [v for v, n in vcount.items() if n >= k]
        target = max(decodable) if decodable else newest
        divergent = []
        for key, m_ in maps.items():
            ent = m_.get(oid)
            if ent is None or ent[0] != target or oid in bad[key]:
                divergent.append(key)
        if not divergent:
            return None
        me = (self.osd.id, self.shard)
        repaired = []
        for o, s in divergent:
            ent = maps[(o, s)].get(oid)
            expect = ent[0] if ent is not None else ZERO
            try:
                if (o, s) == me:
                    await self._recover_own_chunk(oid, target)
                else:
                    await self._push_object(
                        o, s, oid, Entry(OP_MODIFY, oid, target),
                        expect=expect,
                    )
            except RuntimeError:
                self.osd.perf.inc("recovery_unfound")
                continue
            repaired.append((o, s))
        return repaired

    # ===================================================== snap trimming ==

    async def trim_snaps(self, snapids: list[int]) -> int:
        """Remove trimmed snap ids from every clone's preserved set and
        delete clones (and whiteout heads) left covering nothing — the
        SnapTrimmer role, driven by pool removed_snaps deltas. Primary
        only; mutations replicate through the normal write fanout so
        every member trims in lockstep. Returns objects touched."""
        if not self.is_primary() or self.state != "active" or not snapids:
            return 0
        store = self.osd.store
        if self.cid not in store.list_collections():
            return 0
        touched = 0
        for oid in list(store.list_objects(self.cid)):
            if oid == META_OID or sn.is_clone_oid(oid):
                continue
            async with self.lock:
                # SnapSet must load under the PG lock: a racing client
                # write can add a clone between load and commit
                ss = self._load_snapset(oid)
                if ss is None or not ss.clones:
                    continue
                removed_clones: list[int] = []
                changed = False
                for c in list(ss.clones):
                    kept = [s for s in c.snaps if s not in snapids]
                    if len(kept) != len(c.snaps):
                        changed = True
                        c.snaps = kept
                        if not kept:
                            ss.clones.remove(c)
                            removed_clones.append(c.cloneid)
                if not changed:
                    continue
                await self._commit_trim(oid, ss, removed_clones)
            touched += 1
        return touched

    async def _commit_trim(self, oid: bytes, ss: "sn.SnapSet",
                           removed_clones: list[int]) -> None:
        osd = self.osd
        epoch = osd.osdmap.epoch
        kill_head = self._is_whiteout(oid) and not ss.clones
        entries: list[Entry] = []
        seq = self.log.head[1]
        for cloneid in removed_clones:
            seq += 1
            entries.append(Entry(OP_DELETE, sn.clone_oid(oid, cloneid),
                                 (epoch, seq), ZERO))
        seq += 1
        entries.append(Entry(
            OP_DELETE if kill_head else OP_MODIFY, oid, (epoch, seq),
            self._object_version(oid),
        ))
        version = entries[-1].version
        if not self.is_ec:
            t = tx.Transaction()
            for cloneid in removed_clones:
                t.remove(self.cid, sn.clone_oid(oid, cloneid))
            if kill_head:
                t.remove(self.cid, oid)
            else:
                t.setattr(self.cid, oid, ATTR_SS, ss.encode())
                t.setattr(self.cid, oid, ATTR_V, enc_ver(version))
            await self._rep_fanout(t, entries)
            return
        codec = osd.codec_for(self.pool)
        si = osd.sinfo_for(self.pool)
        live = {s: o for o, s in self.live_members()}
        try:
            size = denc.dec_u64(
                osd.store.getattr(self.cid, oid, ATTR_SIZE), 0)[0]
        except Exception:
            size = 0
        shard_txns: dict[int, tx.Transaction] = {}
        for g in range(codec.get_chunk_count()):
            pos = codec.chunk_index(g)
            cid = self._shard_cid(pos)
            t = tx.Transaction()
            for cloneid in removed_clones:
                t.remove(cid, sn.clone_oid(oid, cloneid))
            if kill_head:
                t.remove(cid, oid)
            else:
                t.setattr(cid, oid, ATTR_SS, ss.encode())
            shard_txns[pos] = t
        await self._ec_fanout(oid, entries, shard_txns, hpatch=b"",
                              ncells=si.nstripes(size), size=size,
                              live=live)

    # ---------------------------------------------- peering-side handlers

    async def handle_push(self, src: str, m: M.MPushOp) -> None:
        """Receive a recovery push: install object + attrs, ack. A push
        older than our local copy is skipped — during a pg_temp
        migration a dual-committed write may land before the migration
        push of the same object, and the stale push must not win."""
        cur = (self._object_version(m.oid)
               if self.osd.store.exists(self.cid, m.oid) else ZERO)
        if (not m.force
                and not m.attrs.get("_deleted")
                and cur != ZERO
                and cur >= m.version):
            mver = self.missing.get(m.oid)
            if mver is not None and cur >= mver:
                # our copy already covers the recorded gap (a full
                # rewrite landed between the mark and this push)
                self.missing.pop(m.oid)
                t0 = tx.Transaction()
                self._persist_missing(t0)
                await self.osd.txn_durable(self.osd.queue_txn(t0))
            await self.osd.send(
                src,
                M.MPushReply(pgid=self.pgid, shard=m.shard, oid=m.oid,
                             result=M.OK, tid=m.tid),
            )
            return
        if (m.force
                and tuple(m.expect) != UNCOND
                and not m.attrs.get("_deleted")
                and cur != tuple(m.expect)):
            # repair CAS miss: the repairer reconstructed against a
            # copy at m.expect, but the copy moved while the push was
            # in flight (its send happens outside the PG lock — a
            # racing client write must win). Covers every direction:
            # a stale repair never regresses a newer write, a
            # deliberate rollback of unacked-fanout debris only lands
            # on the exact orphan version it targeted, and a copy
            # deleted mid-flight (cur == ZERO, expect != ZERO) stays
            # deleted instead of being resurrected as orphan debris.
            await self.osd.send(
                src,
                M.MPushReply(pgid=self.pgid, shard=m.shard, oid=m.oid,
                             result=M.OK, tid=m.tid),
            )
            return
        t = tx.Transaction()
        self._ensure_coll(t)
        miss_dirty = False
        if m.attrs.get("_deleted"):
            if self.osd.store.exists(self.cid, m.oid):
                t.remove(self.cid, m.oid)
            # a deleted object has no content to be missing; a HEAD
            # push (empty oid) instead carries the pusher's skipped-
            # unfound set — the gaps its head convergence papers over.
            # They go in OUR missing set so this member's info never
            # claims content-coverage it does not have.
            miss_dirty = self.missing.pop(m.oid, None) is not None
            raw_missing = m.attrs.get("_missing")
            if m.oid == b"" and raw_missing:
                gaps, _ = dec_missing(raw_missing)
                for goid, gver in gaps.items():
                    gver = tuple(gver)
                    have = (self._object_version(goid)
                            if self.osd.store.exists(self.cid, goid)
                            else ZERO)
                    # only ever RAISE the recorded gap: an older
                    # pusher's smaller gver must not demote a newer
                    # recorded gap, or a mid-version push would clear
                    # it and this member's info would claim content-
                    # coverage for the newest gap again
                    if (have < gver
                            and gver > tuple(self.missing.get(goid,
                                                              ZERO))):
                        self.missing[goid] = gver
                        miss_dirty = True
        else:
            t.truncate(self.cid, m.oid, 0)
            t.write(self.cid, m.oid, 0, m.data)
            # wipe first: attrs the pusher DOESN'T have (a stale wh /
            # ss on our pre-crash copy) must not outlive the install —
            # the pushed attr set is the complete authoritative state
            t.rmattrs(self.cid, m.oid)
            t.setattrs(self.cid, m.oid,
                       {**m.attrs, ATTR_V: enc_ver(m.version)})
            # content landed: the gap is filled IF the push actually
            # covers it (a fallback-labeled push one generation behind
            # the recorded gap leaves it on record)
            mver = self.missing.get(m.oid)
            if mver is not None and tuple(m.version) >= tuple(mver):
                self.missing.pop(m.oid)
                miss_dirty = True
        if m.last_update > self.log.head:
            # pushes carry the pusher's log point; adopting it keeps a
            # revived replica's next peering round delta-shaped
            self.log.tail = m.last_update
            self.log.entries = []
        self._persist_log(t)
        if miss_dirty:
            self._persist_missing(t)
        # the ack tells the pusher recovery of this object is DONE
        # (peer_missing pops on it): under a group-commit store it
        # must not outrun the flush that makes the install durable
        await self.osd.txn_durable(self.osd.queue_txn(t))
        await self.osd.send(
            src,
            M.MPushReply(pgid=self.pgid, shard=m.shard, oid=m.oid,
                         result=M.OK, tid=m.tid),
        )
