"""Concrete cluster messages (the src/messages/ role).

Field kinds are declarative (msg/messages.py); every message round-trips
through denc and rides a CRC32C frame. pgid is (pool i32, ps u32);
eversion is (epoch u32, seq u64) — ordering matches the reference's
eversion_t (version_t dominates within an epoch).

ceph_tpu_torch's own copy of ``ceph_tpu/cluster/messages.py``.
"""
from __future__ import annotations

from ..msg.messages import Message, register_message
from ..utils.buffer import BufferList
from .snaps import NOSNAP

PGID = "pair:i32:u32"
EVERSION = "pair:u32:u64"


def _lazy_txn_bl(v) -> BufferList:
    """A store Transaction field that may still be the OBJECT as wire
    segments: in-process (LocalBus zero-copy) it is delivered as-is and
    never encoded; only a wire messenger pays the marshalling cost
    here — and a Transaction carrying BufferList/view write payloads
    marshals those as views too (encode_bl)."""
    if isinstance(v, BufferList):
        return v
    if isinstance(v, (bytes, bytearray, memoryview)):
        return BufferList(v)
    return v.encode_bl()


def _enc_lazy_txn(v) -> bytes:
    from ..utils import denc

    return denc.enc_bytes(bytes(_lazy_txn_bl(v)))


def _enc_lazy_txn_bl(v, bl: BufferList) -> None:
    from ..msg.messages import _enc_bytes_bl

    _enc_bytes_bl(_lazy_txn_bl(v), bl)


def _lazy_entries_bl(v) -> BufferList:
    """Same stance for a log-entry list field (entry encodings are
    memoized on the Entry, so a wire marshal reuses what the PG log
    already produced for persistence)."""
    from ..utils import denc

    if isinstance(v, BufferList):
        return v
    if isinstance(v, (bytes, bytearray, memoryview)):
        return BufferList(v)
    out = BufferList(denc.enc_u32(len(v)))
    for e in v:
        out.append(e.encode())
    return out


def _enc_lazy_entries(v) -> bytes:
    from ..utils import denc

    return denc.enc_bytes(bytes(_lazy_entries_bl(v)))


def _enc_lazy_entries_bl(v, bl: BufferList) -> None:
    from ..msg.messages import _enc_bytes_bl

    _enc_bytes_bl(_lazy_entries_bl(v), bl)


def _dec_field_bytes(buf, off):
    # view decode: the receiver's Transaction/Entry decode walks the
    # view in place (receivers branch on type, so the view is consumed
    # immediately — it never outlives the frame buffer usefully)
    from ..utils import denc

    return denc.dec_bytes_view(buf, off)


#: field kinds for sub-op payloads: senders may pass the live object
#: (Transaction / list[Entry]); wire encode marshals, local delivery
#: ships the object. Receivers branch on type.
LAZY_TXN = (_enc_lazy_txn, _dec_field_bytes, _enc_lazy_txn_bl)
LAZY_ENTRIES = (_enc_lazy_entries, _dec_field_bytes,
                _enc_lazy_entries_bl)

# op result codes (negated errno style, like the reference)
OK = 0
EPERM = -1
ENOENT = -2
EIO = -5
EAGAIN = -11
EEXIST = -17
EBLOCKLISTED = -108  # ESHUTDOWN, the reference's blocklist errno
ESTALE = -116
EDQUOT = -122  # pool quota reached (FLAG_FULL_QUOTA)


# ------------------------------------------------------------------- mon


@register_message
class MOSDBoot(Message):
    TYPE = 10
    FIELDS = (("osd", "u32"),)


@register_message
class MMonGetMap(Message):
    TYPE = 11
    FIELDS = (("have", "u32"),)  # epoch already held; 0 = send full


@register_message
class MOSDMapMsg(Message):
    TYPE = 12
    # full map bytes (empty if only incrementals), then incrementals in
    # epoch order; receiver applies what it can and re-requests on gaps
    FIELDS = (("full", "bytes"), ("incrementals", "list:bytes"),
              ("epoch", "u32"))


@register_message
class MPing(Message):
    TYPE = 13
    FIELDS = (("osd", "u32"), ("epoch", "u32"))


@register_message
class MMonSubscribe(Message):
    TYPE = 14
    FIELDS = (("what", "str"),)


@register_message
class MFailure(Message):
    TYPE = 15
    FIELDS = (("target", "u32"), ("reporter", "str"))


@register_message
class MPoolCreate(Message):
    TYPE = 16
    # pool spec shipped as an encoded Pool (placement/encoding._enc_pool)
    FIELDS = (("pool", "bytes"), ("tid", "u64"))
    DEFAULTS = {"tid": 0}


@register_message
class MPoolCreateReply(Message):
    TYPE = 17
    FIELDS = (("pool_id", "i32"), ("epoch", "u32"), ("tid", "u64"),
              ("result", "i32"))
    DEFAULTS = {"tid": 0, "result": 0}


@register_message
class MPoolSnapOp(Message):
    TYPE = 18
    # op: "create" allocates a new snap id (bumps pool snap_seq),
    # "remove" marks [snapid, snapid+1) removed (drives OSD trimming) —
    # the OSDMonitor selfmanaged-snap verbs
    FIELDS = (("pool_id", "i32"), ("op", "str"), ("snapid", "u64"),
              ("tid", "u64"))
    DEFAULTS = {"snapid": 0, "tid": 0}


@register_message
class MPoolSnapReply(Message):
    TYPE = 19
    FIELDS = (("pool_id", "i32"), ("snapid", "u64"), ("result", "i32"),
              ("epoch", "u32"), ("tid", "u64"))
    DEFAULTS = {"tid": 0}


@register_message
class MPoolSet(Message):
    TYPE = 79
    # live pool parameter change (the `ceph osd pool set` role);
    # key: "pg_num" (split) or "pgp_num" (re-place children)
    FIELDS = (("pool_id", "i32"), ("key", "str"), ("value", "u64"),
              ("tid", "u64"))
    DEFAULTS = {"tid": 0}


@register_message
class MPoolSetReply(Message):
    TYPE = 80
    FIELDS = (("pool_id", "i32"), ("result", "i32"), ("epoch", "u32"),
              ("tid", "u64"))
    DEFAULTS = {"tid": 0}


@register_message
class MBlocklist(Message):
    TYPE = 86
    # fence (op="add") / unfence (op="rm") a client entity (the
    # `ceph osd blocklist` role): OSDs reject a fenced entity's ops on
    # the committed epoch, making exclusive-lock steals safe
    FIELDS = (("entity", "str"), ("op", "str"), ("tid", "u64"))
    DEFAULTS = {"op": "add", "tid": 0}


@register_message
class MBlocklistReply(Message):
    TYPE = 87
    FIELDS = (("result", "i32"), ("epoch", "u32"), ("tid", "u64"))
    DEFAULTS = {"tid": 0}


@register_message
class MPGTempClear(Message):
    TYPE = 81
    # acting primary -> mon: migration to the up set is complete, drop
    # the pg_temp pin (the empty-MOSDPGTemp role)
    FIELDS = (("pgid", PGID),)


# ------------------------------------------------------------ client <-> mds


@register_message
class MClientRequest(Message):
    TYPE = 82
    # CephFS metadata request (MClientRequest role): every metadata
    # mutation goes through the MDS daemon; args are verb-specific
    FIELDS = (("tid", "u64"), ("verb", "str"), ("args", "map:str:bytes"))


@register_message
class MClientReply(Message):
    TYPE = 83
    FIELDS = (("tid", "u64"), ("result", "i32"),
              ("out", "map:str:bytes"))


@register_message
class MCapRevoke(Message):
    TYPE = 84
    # MDS -> client: give back your capability on ino (Locker.h:41
    # revoke role); the client flushes buffered state and releases
    FIELDS = (("ino", "u64"), ("tid", "u64"))


@register_message
class MCapRelease(Message):
    TYPE = 85
    # client -> MDS: cap released; size carries the flushed file size
    # (u64 max = nothing buffered)
    FIELDS = (("ino", "u64"), ("tid", "u64"), ("size", "u64"))


# ---------------------------------------------------------- client <-> osd


def _enc_osd_op(e):
    """One op of the vector (the reference's OSDOp / ceph_osd_op role):
    (op name, offset, length, key, data, kv-map, key-list). Built with
    one join, not a ``+`` chain: the chain re-copies ``data`` (a 4 MiB
    write payload) at every subsequent ``+`` — three extra full-size
    memcpys per client op on the single-core write path."""
    from ..utils import denc

    op, offset, length, key, data, kv, keys = e
    # coerce BEFORE measuring: len(memoryview-of-u32) counts elements,
    # not bytes — the prefix must describe the emitted byte string
    d = data if isinstance(data, bytes) else bytes(data)
    return b"".join((
        denc.enc_str(op), denc.enc_u64(offset),
        denc.enc_i64(length), denc.enc_bytes(key),
        denc.enc_u32(len(d)), d,
        denc.enc_map(kv, denc.enc_bytes, denc.enc_bytes),
        denc.enc_list(keys, denc.enc_bytes)))


def _enc_osd_op_bl(e, bl: BufferList) -> None:
    """BufferList form of :func:`_enc_osd_op`: the op's ``data`` body
    (the 4 MiB write payload) rides as a VIEW between two marshalled
    segments instead of being copied into the op encoding."""
    from ..utils import denc

    op, offset, length, key, data, kv, keys = e
    n = (len(data) if isinstance(data, (bytes, BufferList))
         else len(memoryview(data).cast("B")))
    bl.append(b"".join((
        denc.enc_str(op), denc.enc_u64(offset),
        denc.enc_i64(length), denc.enc_bytes(key),
        denc.enc_u32(n))))
    if n:
        bl.append(data)
    bl.append(denc.enc_map(kv, denc.enc_bytes, denc.enc_bytes)
              + denc.enc_list(keys, denc.enc_bytes))


def _dec_osd_op(buf, off):
    from ..utils import denc

    op, off = denc.dec_str(buf, off)
    offset, off = denc.dec_u64(buf, off)
    length, off = denc.dec_i64(buf, off)
    key, off = denc.dec_bytes(buf, off)
    # the data body decodes as a view over the frame buffer (the
    # bufferlist stance); key/kv/keys stay bytes — they are compared
    # and used as dict keys downstream
    data, off = denc.dec_bytes_view(buf, off)
    kv, off = denc.dec_map(buf, off, denc.dec_bytes, denc.dec_bytes)
    keys, off = denc.dec_list(buf, off, denc.dec_bytes)
    return (op, offset, length, key, data, kv, keys), off


def _enc_osd_ops(v):
    from ..utils import denc

    return denc.enc_list(v, _enc_osd_op)


def _enc_osd_ops_bl(v, bl: BufferList) -> None:
    from ..utils import denc

    bl.append(denc.enc_u32(len(v)))
    for e in v:
        _enc_osd_op_bl(e, bl)


def _dec_osd_ops(buf, off):
    from ..utils import denc

    return denc.dec_list(buf, off, _dec_osd_op)


def osd_op(op: str, offset: int = 0, length: int = -1, key: bytes = b"",
           data: bytes = b"", kv: dict | None = None,
           keys: list | None = None) -> tuple:
    # data stays a view when the caller already holds one (bytes pass
    # through un-copied; bytes(bytes) is the identity)
    if not isinstance(data, (bytes, memoryview, BufferList)):
        data = bytes(data)
    return (op, offset, length, bytes(key), data,
            dict(kv or {}), list(keys or []))


def _enc_outs(v):
    """Per-op results: (result i32, data bytes)."""
    from ..utils import denc

    return denc.enc_list(
        v, lambda e: denc.enc_i32(e[0]) + denc.enc_bytes(e[1])
    )


def _enc_outs_bl(v, bl: BufferList) -> None:
    from ..msg.messages import _enc_bytes_bl
    from ..utils import denc

    bl.append(denc.enc_u32(len(v)))
    for r, d in v:
        bl.append(denc.enc_i32(r))
        _enc_bytes_bl(d, bl)


def _dec_outs(buf, off):
    from ..utils import denc

    def one(b, o):
        r, o = denc.dec_i32(b, o)
        # read payloads decode as views (the client materializes at
        # its own API boundary if the caller needs bytes semantics)
        d, o = denc.dec_bytes_view(b, o)
        return (r, d), o

    return denc.dec_list(buf, off, one)


@register_message
class MOSDOp(Message):
    TYPE = 20
    # ops: the op vector (MOSDOp.h vector<OSDOp> role) applied
    # atomically to one object; reads inside the vector observe the
    # effects of earlier ops in the same vector
    FIELDS = (
        ("tid", "u64"),
        ("pgid", PGID),
        ("oid", "bytes"),
        ("ops", (_enc_osd_ops, _dec_osd_ops, _enc_osd_ops_bl)),
        ("epoch", "u32"),  # client's map epoch at send time
        # SnapContext for writes (seq + existing snap ids, descending;
        # the selfmanaged_snap_set_write_ctx role) and the snap id reads
        # resolve at (CEPH_NOSNAP = head)
        ("snap_seq", "u64"),
        ("snaps", "list:u64"),
        ("snapid", "u64"),
        ("trace", "pair:u64:u64"),  # span ctx (utils/trace; 0,0 = off)
    )
    DEFAULTS = {"trace": (0, 0), "snap_seq": 0, "snaps": [],
                "snapid": NOSNAP}


@register_message
class MOSDOpReply(Message):
    TYPE = 21
    # data/size mirror the first read-class op's output (fast path);
    # outs carries every op's (result, data)
    FIELDS = (
        ("tid", "u64"),
        ("result", "i32"),
        ("data", "body"),
        ("size", "u64"),
        ("outs", (_enc_outs, _dec_outs, _enc_outs_bl)),
        ("epoch", "u32"),  # responder's epoch (client refreshes on ESTALE)
    )


# ------------------------------------------------------------- osd <-> osd


@register_message
class MOSDRepOp(Message):
    TYPE = 30
    FIELDS = (
        ("tid", "u64"),
        ("pgid", PGID),
        ("txn", LAZY_TXN),  # store Transaction (object locally)
        ("entry", LAZY_ENTRIES),  # PGLog entries (list locally)
        ("epoch", "u32"),
        # primary's log head BEFORE appending `entry`: the replica
        # refuses to append over a gap (prefix-log invariant — a
        # revived stale member must recover, not silently adopt the
        # head version and dodge peering's authority check)
        ("prev_head", "pair:u32:u64"),
        ("trace", "pair:u64:u64"),  # span ctx (utils/trace; 0,0 = off)
    )
    DEFAULTS = {"trace": (0, 0), "prev_head": (0, 0)}


@register_message
class MOSDRepOpReply(Message):
    TYPE = 31
    FIELDS = (("tid", "u64"), ("pgid", PGID), ("result", "i32"),
              ("osd", "u32"))


@register_message
class MECSubWrite(Message):
    TYPE = 32
    FIELDS = (
        ("tid", "u64"),
        ("pgid", PGID),
        ("shard", "u32"),
        ("txn", LAZY_TXN),
        ("entry", LAZY_ENTRIES),
        ("epoch", "u32"),
        # RMW metadata (ECUtil hash_info role): per-cell CRC patches as
        # concat LE (u32 cell, u32 crc) pairs, the shard file's new cell
        # count, and the logical object size. Empty hpatch + ncells=0 =
        # the txn carries full attrs itself (delete / recovery install).
        ("hpatch", "bytes"),
        ("ncells", "u64"),
        ("size", "u64"),
        ("prev_head", "pair:u32:u64"),  # see MOSDRepOp.prev_head
        ("trace", "pair:u64:u64"),  # span ctx (utils/trace; 0,0 = off)
    )
    DEFAULTS = {"trace": (0, 0), "hpatch": b"", "ncells": 0, "size": 0,
                "prev_head": (0, 0)}


@register_message
class MECSubWriteReply(Message):
    TYPE = 33
    FIELDS = (("tid", "u64"), ("pgid", PGID), ("shard", "u32"),
              ("result", "i32"))


@register_message
class MECSubRead(Message):
    TYPE = 34
    FIELDS = (
        ("tid", "u64"),
        ("pgid", PGID),
        ("shard", "u32"),
        ("oid", "bytes"),
        ("offset", "u64"),
        ("length", "i64"),
        ("trace", "pair:u64:u64"),  # span ctx (utils/trace; 0,0 = off)
        # sub-chunk repair runs (regenerating codes): packed LE u32
        # (offset, count) pairs in SUB-CHUNK units, applied within
        # every cell of the requested range — the shard reads and
        # hinfo-verifies its full cells locally but replies with only
        # the selected sub-chunk slices (repair-traffic reduction
        # without giving up verify-on-read). Empty = whole cells.
        ("subruns", "bytes"),
    )
    DEFAULTS = {"trace": (0, 0), "subruns": b""}


@register_message
class MECSubReadReply(Message):
    TYPE = 35
    FIELDS = (
        ("tid", "u64"),
        ("pgid", PGID),
        ("shard", "u32"),
        ("result", "i32"),
        ("data", "body"),
        ("digest", "u32"),  # stored hinfo crc for the returned chunk
        ("size", "u64"),  # stored whole-object size attr
        ("attrs", "map:str:bytes"),  # user xattrs (mirrored per shard)
        # the shard's stored ATTR_V: the primary cross-checks versions
        # across fetched shards and excludes laggards — a revived stale
        # shard is self-consistent against its own stale hinfo, so only
        # the version can unmask it (the ROADMAP stale-shard gap)
        ("ver", EVERSION),
    )
    DEFAULTS = {"ver": (0, 0)}


# ---------------------------------------------------------------- peering


@register_message
class MPGInfoReq(Message):
    TYPE = 40
    FIELDS = (("pgid", PGID), ("epoch", "u32"), ("shard", "i32"))


@register_message
class MPGInfoReply(Message):
    TYPE = 41
    FIELDS = (("pgid", PGID), ("epoch", "u32"), ("shard", "i32"),
              ("info", "bytes"))  # encoded PGInfo (pglog.py)


@register_message
class MPushOp(Message):
    # force=0 (migration pushes): receiver keeps a same-or-newer local
    # copy — a dual-committed write must not be overwritten by a stale
    # push. force=1 (recovery/scrub repair): always install — the push
    # exists to replace bytes the receiver holds wrongly (bit rot).
    TYPE = 42
    FIELDS = (
        ("pgid", PGID),
        ("shard", "i32"),
        ("oid", "bytes"),
        ("version", EVERSION),
        ("data", "body"),
        ("attrs", "map:str:bytes"),
        ("epoch", "u32"),
        ("force", "u8"),
        ("last_update", EVERSION),  # pushes end with the log point covered
        # push-round id echoed in MPushReply: a recovery push and a
        # read-triggered repair of the SAME (pg, shard, oid) can be in
        # flight together, and their ack waiters must not collide
        ("tid", "u64"),
        # compare-and-swap guard for repair pushes (sent OUTSIDE the
        # PG lock): install only while the receiver's copy is still at
        # this version — a racing client write that moved it past must
        # win, and a deliberate rollback of unacked-fanout debris
        # names exactly the orphan version it replaces. The all-ones
        # sentinel (default) means unconditional (recovery/backfill).
        ("expect", EVERSION),
    )
    DEFAULTS = {"force": 1, "tid": 0,
                "expect": (0xFFFFFFFF, 0xFFFFFFFFFFFFFFFF)}


@register_message
class MPushReply(Message):
    TYPE = 43
    FIELDS = (("pgid", PGID), ("shard", "i32"), ("oid", "bytes"),
              ("result", "i32"), ("tid", "u64"))  # echoes MPushOp.tid
    DEFAULTS = {"tid": 0}


@register_message
class MPull(Message):
    TYPE = 44
    # "send me your copy of oid" — the puller recovers itself (the
    # reference's PullOp role); answered with MPushOp
    FIELDS = (("pgid", PGID), ("shard", "i32"), ("oid", "bytes"),
              ("epoch", "u32"))


@register_message
class MPGScan(Message):
    TYPE = 45
    # backfill enumeration: "list your objects + versions"
    FIELDS = (("pgid", PGID), ("shard", "i32"), ("epoch", "u32"))


@register_message
class MPGScanReply(Message):
    TYPE = 46
    FIELDS = (("pgid", PGID), ("shard", "i32"),
              ("objects", "map:bytes:" + EVERSION))


@register_message
class MNotifyEvent(Message):
    TYPE = 56
    # delivered to each watcher of oid (MWatchNotify role)
    FIELDS = (("oid", "bytes"), ("notify_id", "u64"), ("cookie", "u64"),
              ("payload", "bytes"))


# ------------------------------------------------------------ mon <-> mon


@register_message
class MMonElect(Message):
    TYPE = 70
    # propose myself (rank) for election epoch (Elector propose role)
    FIELDS = (("epoch", "u32"), ("rank", "u32"))


@register_message
class MMonElectAck(Message):
    TYPE = 71
    FIELDS = (("epoch", "u32"), ("rank", "u32"))  # rank = supporter


@register_message
class MMonVictory(Message):
    TYPE = 72
    FIELDS = (("epoch", "u32"), ("leader", "u32"),
              ("quorum", "list:u32"))


@register_message
class MMonLease(Message):
    TYPE = 73
    # leader heartbeat extending its authority (Paxos lease role)
    FIELDS = (("epoch", "u32"), ("leader", "u32"),
              ("last_committed", "u32"))


@register_message
class MPaxosCollect(Message):
    TYPE = 74
    # new leader recovering state (Paxos::collect role); last_committed
    # lets an AHEAD peon back-fill a revived-behind collector before it
    # proposes anything (it would otherwise re-propose committed epochs)
    FIELDS = (("pn", "u64"), ("epoch", "u32"), ("last_committed", "u32"))
    DEFAULTS = {"last_committed": 0}


@register_message
class MPaxosLast(Message):
    TYPE = 75
    # promised_pn tells a collector whose pn is below the peon's promise
    # the floor it must exceed (Paxos OP_LAST pn-bump role) — without it
    # a re-elected leader's begins are dropped silently forever
    FIELDS = (("pn", "u64"), ("rank", "u32"), ("last_committed", "u32"),
              ("uncommitted_pn", "u64"), ("uncommitted_ver", "u32"),
              ("uncommitted_value", "bytes"), ("promised_pn", "u64"))
    DEFAULTS = {"promised_pn": 0}


@register_message
class MPaxosBegin(Message):
    TYPE = 76
    # value = encoded Incremental for version (Paxos::begin role)
    FIELDS = (("pn", "u64"), ("version", "u32"), ("value", "bytes"))


@register_message
class MPaxosAccept(Message):
    TYPE = 77
    FIELDS = (("pn", "u64"), ("version", "u32"), ("rank", "u32"))


@register_message
class MPaxosCommit(Message):
    TYPE = 78
    FIELDS = (("version", "u32"), ("value", "bytes"))


# -------------------------------------------------------------------- mgr


@register_message
class MMgrReport(Message):
    TYPE = 55
    # perf: JSON-encoded perf-dump (control plane; schema-free like the
    # reference's MMgrReport counter payloads), pgs: state -> count,
    # pools: JSON {pool_id: [stored_bytes, primary_objects]} sampled
    # from the OSD's local collections (pg stat_sum role)
    FIELDS = (("osd", "u32"), ("epoch", "u32"), ("perf", "bytes"),
              ("pgs", "map:str:u32"), ("pools", "bytes"))
    DEFAULTS = {"pools": b"{}"}


@register_message
class MMgrDigest(Message):
    """Mgr -> mon stats digest (the MMonMgrReport/MgrStatMonitor role):
    the mon serves `status` / `df` / `pg stat` MonCommands from the
    last digest instead of holding per-OSD reports itself."""
    TYPE = 92
    FIELDS = (("digest", "bytes"),)  # JSON: pg_states, pools, ops


@register_message
class MMonCommand(Message):
    """CLI -> mon command (MMonCommand + MonCommands.h role): cmd is
    the JSON argument object, {"prefix": "osd tree", ...args}."""
    TYPE = 93
    FIELDS = (("tid", "u64"), ("cmd", "str"))


@register_message
class MMonCommandReply(Message):
    """Reply: result (negated errno), outs (human status line), outb
    (JSON payload for structured output)."""
    TYPE = 94
    FIELDS = (("tid", "u64"), ("result", "i32"), ("outs", "str"),
              ("outb", "bytes"), ("epoch", "u32"))


# ------------------------------------------------------------------ scrub


@register_message
class MScrub(Message):
    TYPE = 50
    # "digest every object you hold for pgid" (scrub_machine replica
    # map request role)
    FIELDS = (("pgid", PGID), ("shard", "i32"), ("epoch", "u32"),
              ("tid", "u64"))


def _enc_scrub_entry(e):
    from ..utils import denc

    (epoch, seq), (size, crc) = e
    return (denc.enc_u32(epoch) + denc.enc_u64(seq)
            + denc.enc_u64(size) + denc.enc_u32(crc))


def _dec_scrub_entry(buf, off):
    from ..utils import denc

    epoch, off = denc.dec_u32(buf, off)
    seq, off = denc.dec_u64(buf, off)
    size, off = denc.dec_u64(buf, off)
    crc, off = denc.dec_u32(buf, off)
    return ((epoch, seq), (size, crc)), off


def _enc_scrub_map(d):
    from ..utils import denc

    return denc.enc_map(d, denc.enc_bytes, _enc_scrub_entry)


def _dec_scrub_map(buf, off):
    from ..utils import denc

    return denc.dec_map(buf, off, denc.dec_bytes, _dec_scrub_entry)


@register_message
class MScrubReply(Message):
    TYPE = 51
    # oid -> ((epoch, seq), (size, data crc32c)) — the ScrubMap role.
    # errors: oids whose chunk bytes fail the member's own stored-hinfo
    # check (EC deep-scrub self-verification)
    FIELDS = (("pgid", PGID), ("shard", "i32"), ("tid", "u64"),
              ("objects", (_enc_scrub_map, _dec_scrub_map)),
              ("errors", "list:bytes"))


# ----------------------------------------------------- config / balancer


def _enc_cfg_entries(v):
    from ..utils import denc

    return denc.enc_list(
        v, lambda e: (denc.enc_str(e[0]) + denc.enc_str(e[1])
                      + denc.enc_str(e[2])))


def _dec_cfg_entries(buf, off):
    from ..utils import denc

    def one(b, o):
        who, o = denc.dec_str(b, o)
        key, o = denc.dec_str(b, o)
        val, o = denc.dec_str(b, o)
        return (who, key, val), o

    return denc.dec_list(buf, off, one)


@register_message
class MConfigSet(Message):
    """`ceph config set <who> <key> <value>` (ConfigMonitor role);
    who is "global", a daemon class ("osd"), or an instance ("osd.3")."""
    TYPE = 60
    FIELDS = (("who", "str"), ("key", "str"), ("value", "str"))


@register_message
class MConfig(Message):
    """Central config DB pushed to subscribers (MConfig role); daemons
    apply the sections that match them, most specific last."""
    TYPE = 61
    FIELDS = (("entries", (_enc_cfg_entries, _dec_cfg_entries)),)


def _enc_upmap_plan(v):
    from ..utils import denc

    def one(e):
        pgid, pairs = e
        return (denc.enc_i32(pgid[0]) + denc.enc_u32(pgid[1])
                + denc.enc_list(
                    pairs,
                    lambda p: denc.enc_i32(p[0]) + denc.enc_i32(p[1])))

    return denc.enc_list(v, one)


def _dec_upmap_plan(buf, off):
    from ..utils import denc

    def pair(b, o):
        a, o = denc.dec_i32(b, o)
        c, o = denc.dec_i32(b, o)
        return (a, c), o

    def one(b, o):
        pool, o = denc.dec_i32(b, o)
        ps, o = denc.dec_u32(b, o)
        pairs, o = denc.dec_list(b, o, pair)
        return ((pool, ps), pairs), o

    return denc.dec_list(buf, off, one)


@register_message
class MUpmapItems(Message):
    """`ceph osd pg-upmap-items` (OSDMonitor role): a PLAN of per-PG
    [(from, to)] replacement pairs, committed as ONE map epoch (an
    empty pair list clears that PG's entry)."""
    TYPE = 62
    FIELDS = (("entries", (_enc_upmap_plan, _dec_upmap_plan)),)


@register_message
class MEnvelope(Message):
    """Process-to-process routing wrapper for the multi-process NetBus
    (msg/netbus.py): one TCP listener per OS process carries traffic
    for every entity the process hosts, so the entity-level source and
    destination ride inside the frame (the reference's entity_addr_t +
    entity_name_t header fields, msg/Message.h role)."""
    TYPE = 90
    FIELDS = (
        ("src", "str"),
        ("dst", "str"),
        ("mtype", "u32"),
        ("payload", "body"),
        # per-ENTITY origin signature (CephxProtocol authorizer role):
        # HMAC(src entity's key, src|dst|mtype|payload), verified by
        # the receiving NetBus — the node-level connection handshake
        # authenticates the PROCESS, this binds the claimed src entity
        # to a key only that entity holds. Empty when auth is off.
        ("sig", "bytes"),
    )
    DEFAULTS = {"sig": b""}


@register_message
class MBackfillReserve(Message):
    """Remote backfill-slot protocol (MBackfillReserve role): a primary
    asks a recovery TARGET for an inbound slot before pushing; the
    target grants when its remote reserver has room and the primary
    releases when the pushes land. op: request | grant | release."""
    TYPE = 91
    FIELDS = (
        ("pgid", PGID),
        ("op", "str"),
        ("osd", "u32"),  # sender's osd id
        ("prio", "i32"),
    )
    DEFAULTS = {"prio": 0}
