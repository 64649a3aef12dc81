"""ObjectStore interface + shared transaction application logic.

The contract of src/os/ObjectStore.h:63: collections of objects, each
object a (data, xattrs, omap) triple; reads are synchronous; writes are
queued transactions with an on_commit callback fired once durable.
Stores that keep state in memory can implement `_obj`/`_coll` accessors
and inherit the op interpreter, the way MemStore does in the reference
(src/os/memstore/MemStore.cc do_transaction).

ceph_tpu_torch's own copy of ``ceph_tpu/store/base.py``.
"""
from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Callable, Iterable

from ..utils.buffer import BufferList
from . import transaction as tx


def write_payload(dst: bytearray, off: int, data) -> None:
    """Land a write payload (bytes / memoryview / BufferList) into the
    store's bytearray at ``off``: BufferList segments write directly at
    their offsets — the store boundary never joins them first."""
    if isinstance(data, BufferList):
        for seg in data.segments():
            n = len(seg)
            dst[off : off + n] = seg
            off += n
    else:
        dst[off : off + len(data)] = data


def payload_bytearray(data) -> bytearray:
    """A fresh bytearray holding the payload (the replacement-object
    fast path): one allocation, segments written in place."""
    if isinstance(data, BufferList):
        out = bytearray(len(data))
        write_payload(out, 0, data)
        return out
    return bytearray(data)


#: reserved oid prefix for snapshot clone objects (single source of
#: truth — cluster/snaps.py builds clone oids from this): CLONE_PREFIX +
#: 8-byte BE cloneid + NUL + head oid
CLONE_PREFIX = b"\x00s"

#: the per-PG metadata object (cluster/pg.py META_OID single source)
PGMETA_OID = b"_pgmeta"


def split_hash_oid(oid: bytes) -> bytes | None:
    """The oid a collection split hashes to decide placement, or None
    for objects pinned to their collection (per-PG metadata only — an
    exact match, so client oids that merely share the prefix still
    migrate). Snapshot clones hash by their embedded HEAD oid so they
    always migrate with their head (the reference's hobject hash is
    head-based)."""
    if oid == PGMETA_OID:
        return None
    if oid.startswith(CLONE_PREFIX):
        return oid[11:]
    return oid


class CommitStats:
    """Per-store group-commit accounting: every durable store bumps
    these at each commit boundary so the bench can report how well
    transactions amortize the flush (commits_grouped / txns_per_commit
    / commit_flush_us — the store-side occupancy counters next to the
    EC batcher's stripes_per_batch)."""

    __slots__ = ("commits", "commits_grouped", "txns", "flush_us_sum")

    def __init__(self) -> None:
        self.commits = 0          # flush boundaries paid
        self.commits_grouped = 0  # boundaries that covered > 1 txn
        self.txns = 0             # transactions committed
        self.flush_us_sum = 0.0   # total time inside the flush fn

    def observe(self, ntxns: int, flush_s: float) -> None:
        self.commits += 1
        if ntxns > 1:
            self.commits_grouped += 1
        self.txns += ntxns
        self.flush_us_sum += flush_s * 1e6

    def dump(self) -> dict:
        return {
            "commits": self.commits,
            "commits_grouped": self.commits_grouped,
            "txns": self.txns,
            "txns_per_commit": (self.txns / self.commits
                                if self.commits else 0.0),
            "commit_flush_us": (self.flush_us_sum / self.commits
                                if self.commits else 0.0),
        }


class GroupCommitter:
    """Window/size-bounded commit grouping (the BlueStore kv-sync
    thread role): transactions arriving within ``window_s`` share ONE
    durability flush (``flush_fn``), then their ``on_commit`` callbacks
    fire together; a group reaching ``max_txns`` flushes ahead of the
    deadline. ``window_s <= 0`` disables grouping — ``add`` flushes
    inline, reproducing per-transaction durability exactly.

    Locking contract: ``add``/``flush_now`` are called WITHOUT the
    store lock held for the flush part; ``flush_fn`` takes the store
    lock itself. The flusher thread never holds the group condition
    while flushing, so store-lock holders can always enqueue."""

    def __init__(self, flush_fn: Callable[[], None],
                 stats: CommitStats | None = None,
                 window_s: float = 0.0, max_txns: int = 64):
        self.flush_fn = flush_fn
        self.stats = stats
        self.window_s = float(window_s)
        self.max_txns = max(1, int(max_txns))
        self._cond = threading.Condition()
        self._cbs: list[Callable[[], None]] = []
        self._ntxns = 0
        self._deadline: float | None = None
        self._thread: threading.Thread | None = None
        self._stop = False

    # ------------------------------------------------------------- entry

    def add(self, on_commit: Callable[[], None] | None) -> None:
        """One committed-to-memory transaction wants durability. In
        grouped mode its flush (and callback) ride the group; inline
        mode flushes now — on_commit exceptions then propagate to the
        caller like the pre-group-commit path did."""
        if self.window_s <= 0:
            t0 = time.perf_counter()
            self.flush_fn()
            if self.stats is not None:
                self.stats.observe(1, time.perf_counter() - t0)
            if on_commit:
                on_commit()
            return
        with self._cond:
            self._ntxns += 1
            if on_commit:
                self._cbs.append(on_commit)
            now = time.monotonic()
            if self._deadline is None:
                self._deadline = now + self.window_s
            if self._ntxns >= self.max_txns:
                self._deadline = now  # size trigger: flush ahead of it
            self._ensure_thread()
            self._cond.notify()

    def _ensure_thread(self) -> None:  # _cond held
        if self._thread is None or not self._thread.is_alive():
            self._stop = False  # a closed committer revives on re-use
            self._thread = threading.Thread(target=self._loop,
                                            daemon=True)
            self._thread.start()

    # ------------------------------------------------------------- flush

    def _steal(self) -> tuple[int, list]:  # _cond held
        cbs, self._cbs = self._cbs, []
        n, self._ntxns = self._ntxns, 0
        self._deadline = None
        return n, cbs

    def _do_flush(self, n: int, cbs: list) -> None:
        t0 = time.perf_counter()
        try:
            self.flush_fn()
        except Exception:
            # a failed flush must neither fire the callbacks (they
            # mean DURABLE) nor drop them (their waiters would hang
            # forever) nor kill the flusher: re-queue the group at the
            # front, re-arm a retry deadline, and report. A transient
            # error (EINTR, pressure) clears on the retry; a dead disk
            # keeps the callbacks honestly un-fired.
            print("group-commit flush failed (group re-queued):",
                  file=sys.stderr)
            traceback.print_exc()
            with self._cond:
                if self._stop:
                    return  # closing: nothing will retry — drop, the
                    #         callbacks were never durability-promised
                self._cbs[:0] = cbs
                self._ntxns += n
                if self._deadline is None:
                    self._deadline = (time.monotonic()
                                      + max(self.window_s, 0.05))
                self._ensure_thread()
                self._cond.notify()
            return
        if self.stats is not None:
            self.stats.observe(n, time.perf_counter() - t0)
        for cb in cbs:
            try:
                cb()
            except Exception:
                # a grouped callback has no caller stack to fail into;
                # its batch-mates' callbacks must still fire
                print("group-commit on_commit callback failed:",
                      file=sys.stderr)
                traceback.print_exc()

    def flush_now(self) -> None:
        """Explicit barrier (umount, checkpoint, tests): flush whatever
        is pending and fire its callbacks before returning."""
        with self._cond:
            n, cbs = self._steal()
        if n:
            self._do_flush(n, cbs)

    def close(self) -> None:
        self.flush_now()
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._stop and self._ntxns == 0:
                    self._cond.wait()
                if self._stop and self._ntxns == 0:
                    return
                now = time.monotonic()
                while (not self._stop and self._deadline is not None
                       and now < self._deadline
                       and self._ntxns < self.max_txns):
                    self._cond.wait(self._deadline - now)
                    now = time.monotonic()
                n, cbs = self._steal()
            if n:
                self._do_flush(n, cbs)


class StoreError(Exception):
    pass


class NotFound(StoreError):
    pass


class Collection:
    """One collection (= one PG's objects). In-memory representation."""

    def __init__(self, cid: str):
        self.cid = cid
        self.objects: dict[bytes, Obj] = {}


class Obj:
    __slots__ = ("data", "xattrs", "omap", "omap_header")

    def __init__(self):
        self.data = bytearray()
        self.xattrs: dict[str, bytes] = {}
        self.omap: dict[bytes, bytes] = {}
        self.omap_header = b""

    def clone(self) -> "Obj":
        o = Obj()
        o.data = bytearray(self.data)
        o.xattrs = dict(self.xattrs)
        o.omap = dict(self.omap)
        o.omap_header = self.omap_header
        return o


class ObjectStore:
    """Abstract store; subclasses provide durability."""

    def __init__(self) -> None:
        #: group-commit occupancy counters (CommitStats): every store
        #: kind reports the same shape, so `txns_per_commit` means the
        #: same thing whether the flush is a WAL fsync or a kv batch
        self.commit_stats = CommitStats()

    def mount(self) -> None: ...

    def umount(self) -> None: ...

    # ------------------------------------------------------------- writes

    def queue_transaction(
        self, t: tx.Transaction, on_commit: Callable[[], None] | None = None
    ) -> None:
        raise NotImplementedError

    def commits_deferred(self) -> bool:
        """True when queue_transaction may RETURN before the
        transaction is durable (a group-commit window is armed): an
        ack that implies durability must then ride on_commit instead
        of the call's return (cluster/osd.py queue_txn)."""
        return False

    def apply_transaction(self, t: tx.Transaction) -> None:
        """Synchronous convenience: queue + wait."""
        done = threading.Event()
        self.queue_transaction(t, done.set)
        done.wait()

    # -------------------------------------------------------------- reads

    def read(self, cid: str, oid: bytes, offset: int = 0, length: int = -1) -> bytes:
        raise NotImplementedError

    def stat(self, cid: str, oid: bytes) -> int:
        """Object size in bytes (raises NotFound)."""
        raise NotImplementedError

    def exists(self, cid: str, oid: bytes) -> bool:
        try:
            self.stat(cid, oid)
            return True
        except NotFound:
            return False

    def getattr(self, cid: str, oid: bytes, name: str) -> bytes:
        raise NotImplementedError

    def getattrs(self, cid: str, oid: bytes) -> dict[str, bytes]:
        raise NotImplementedError

    def omap_get(self, cid: str, oid: bytes) -> dict[bytes, bytes]:
        raise NotImplementedError

    def omap_get_header(self, cid: str, oid: bytes) -> bytes:
        raise NotImplementedError

    def list_collections(self) -> list[str]:
        raise NotImplementedError

    def list_objects(self, cid: str) -> list[bytes]:
        raise NotImplementedError

    # --------------------------------------------- shared op interpreter

    def _get_coll(self, cid: str) -> Collection:
        raise NotImplementedError

    def _do_op(self, colls: dict[str, Collection], op: tx.Op) -> None:
        """Interpret one op against in-memory collections (the MemStore
        do_transaction role; FileStoreLite replays the same ops)."""
        if op.code == tx.OP_MKCOLL:
            if op.cid in colls:
                raise StoreError(f"collection {op.cid} exists")
            colls[op.cid] = Collection(op.cid)
            return
        if op.code == tx.OP_RMCOLL:
            c = colls.get(op.cid)
            if c is None:
                raise NotFound(op.cid)
            if c.objects:
                raise StoreError(f"collection {op.cid} not empty")
            del colls[op.cid]
            return
        if op.code == tx.OP_SPLIT_COLL:
            src = colls.get(op.cid)
            if src is None:
                raise NotFound(op.cid)
            dest = colls.get(op.args["dest_cid"])
            if dest is None:
                raise NotFound(op.args["dest_cid"])
            mask = (1 << op.args["bits"]) - 1
            from ..placement.osdmap import ceph_str_hash_rjenkins

            moving = []
            for oid in src.objects:
                key = split_hash_oid(oid)
                if key is not None and \
                        ceph_str_hash_rjenkins(key) & mask == op.args["rem"]:
                    moving.append(oid)
            for oid in moving:
                dest.objects[oid] = src.objects.pop(oid)
            return
        if op.code == tx.OP_MERGE_COLL:
            src = colls.get(op.cid)
            if src is None:
                raise NotFound(op.cid)
            dest = colls.get(op.args["dest_cid"])
            if dest is None:
                raise NotFound(op.args["dest_cid"])
            dest.objects.update(src.objects)
            del colls[op.cid]
            return
        c = colls.get(op.cid)
        if c is None:
            raise NotFound(f"collection {op.cid}")
        a = op.args
        # read-only lookups: peek avoids dragging untouched objects
        # through a staged overlay's copy-on-touch (plain dicts: get)
        peek = getattr(c.objects, "peek", c.objects.get)
        if op.code == tx.OP_WRITE and a["offset"] == 0:
            old = peek(op.oid)
            if old is not None and len(a["data"]) >= len(old.data):
                # full overwrite: build the replacement object from the
                # new bytes directly instead of copy-on-touch cloning
                # (and then fully overwriting) the old data — the EC
                # shard-rewrite shape pays this per sub-op, and the
                # clone was the write path's dominant memcpy
                o = Obj()
                o.data = payload_bytearray(a["data"])
                o.xattrs = dict(old.xattrs)
                o.omap = dict(old.omap)
                o.omap_header = old.omap_header
                c.objects[op.oid] = o
                return
        if op.code == tx.OP_TOUCH:
            if peek(op.oid) is None:
                c.objects[op.oid] = Obj()
            return
        if op.code == tx.OP_REMOVE:
            if op.oid not in c.objects:
                raise NotFound(repr(op.oid))
            del c.objects[op.oid]
            return
        if op.code == tx.OP_CLONE:
            src = peek(op.oid)
            if src is None:
                raise NotFound(repr(op.oid))
            c.objects[a["dest"]] = src.clone()
            return
        if op.code == tx.OP_CLONERANGE:
            src = peek(op.oid)
            if src is None:
                raise NotFound(repr(op.oid))
            dst = c.objects.setdefault(a["dest"], Obj())
            data = bytes(src.data[a["src_off"] : a["src_off"] + a["length"]])
            end = a["dst_off"] + len(data)
            if len(dst.data) < end:
                dst.data.extend(b"\0" * (end - len(dst.data)))
            dst.data[a["dst_off"] : end] = data
            return
        o = c.objects.get(op.oid)
        if o is None:
            # write-type ops create; read-modify ops demand existence
            if op.code in (
                tx.OP_WRITE, tx.OP_ZERO, tx.OP_TRUNCATE, tx.OP_SETATTR,
                tx.OP_SETATTRS, tx.OP_OMAP_SETKEYS, tx.OP_OMAP_SETHEADER,
                tx.OP_SETALLOCHINT,
            ):
                o = c.objects.setdefault(op.oid, Obj())
            else:
                raise NotFound(repr(op.oid))
        if op.code == tx.OP_WRITE:
            off = a["offset"]
            end = off + len(a["data"])
            if off >= len(o.data):
                # append shape (incl. a fresh object's first write):
                # no zero-fill of bytes the data is about to cover
                if off > len(o.data):
                    o.data.extend(b"\0" * (off - len(o.data)))
                if isinstance(a["data"], BufferList):
                    for seg in a["data"].segments():
                        o.data += seg
                else:
                    o.data += a["data"]
            else:
                if len(o.data) < end:
                    o.data.extend(b"\0" * (end - len(o.data)))
                write_payload(o.data, off, a["data"])
        elif op.code == tx.OP_ZERO:
            end = a["offset"] + a["length"]
            if len(o.data) < end:
                o.data.extend(b"\0" * (end - len(o.data)))
            o.data[a["offset"] : end] = b"\0" * a["length"]
        elif op.code == tx.OP_TRUNCATE:
            size = a["size"]
            if size < len(o.data):
                del o.data[size:]
            else:
                o.data.extend(b"\0" * (size - len(o.data)))
        elif op.code == tx.OP_SETATTR:
            o.xattrs[a["name"]] = a["value"]
        elif op.code == tx.OP_SETATTRS:
            o.xattrs.update(a["attrs"])
        elif op.code == tx.OP_RMATTR:
            o.xattrs.pop(a["name"], None)
        elif op.code == tx.OP_RMATTRS:
            o.xattrs.clear()
        elif op.code == tx.OP_OMAP_CLEAR:
            o.omap.clear()
        elif op.code == tx.OP_OMAP_SETKEYS:
            o.omap.update(a["kv"])
        elif op.code == tx.OP_OMAP_RMKEYS:
            for k in a["keys"]:
                o.omap.pop(k, None)
        elif op.code == tx.OP_OMAP_RMKEYRANGE:
            for k in [k for k in o.omap if a["first"] <= k < a["last"]]:
                del o.omap[k]
        elif op.code == tx.OP_OMAP_SETHEADER:
            o.omap_header = a["header"]
        elif op.code == tx.OP_SETALLOCHINT:
            # advisory: recorded for allocator-aware stores
            o.xattrs["_alloc_hint"] = (
                a["expected_object_size"].to_bytes(8, "little")
                + a["expected_write_size"].to_bytes(8, "little")
                + a["flags"].to_bytes(4, "little")
            )
        else:
            raise StoreError(f"unknown op {op.code}")
