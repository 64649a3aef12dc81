"""BlueStoreLite: block-device ObjectStore with KV metadata (the
BlueStore role proper, src/os/bluestore/BlueStore.cc).

Layout, mirroring the reference's split of labor:
- object DATA lives on a raw block device (``native.rt``
  BlockDevice — the src/blk KernelDevice role) in 4 KiB blocks handed
  out by a native bitmap allocator (fastbmap_allocator_impl role);
- all METADATA (onodes: size + block map + per-block crc32c + xattrs;
  omap key/values; collection markers) lives in the native embedded KV
  (RocksDB's job), under BlueStore-style escaped composite keys.

Transaction lifecycle is the txc state machine
(BlueStore.cc:12636 _txc_state_proc) in miniature:
  PREPARE    ops interpreted against shadow onodes; every data write is
             COW — fresh blocks from the allocator, old blocks kept;
  AIO_WAIT   staged blocks go to the device through the IO thread pool,
             then a drain (+fdatasync when fsync=True) barrier;
  KV_SUBMIT  ONE atomic kv batch commits every metadata mutation — this
             batch is the commit point;
  FINISH     shadow swapped in, superseded blocks released, on_commit.
A crash at any point leaves the previous committed state intact: data
blocks written before the kv commit are unreferenced garbage that the
mount-time allocator rebuild (from committed block maps) reclaims.

Checksums follow bluestore_blob_t::calc_csum/verify_csum
(bluestore_types.cc:737,763): staged blocks are checksummed in ONE
batched Checksummer call per transaction (device_csum=True routes it
through the crc32c kernel on ``device``, the card unless the caller
names another), and every read verifies its blocks in one batched call
(_verify_csum role, BlueStore.cc:11277).

ceph_tpu_torch's own copy of ``ceph_tpu/store/bluestore.py``; the KV
keys, onode encoding and block layout are the JAX package's, byte for
byte.
"""
from __future__ import annotations

import threading
import time
from typing import Callable

import numpy as np
import torch

from ..checksum import Checksummer
from ..native import rt
from ..utils import compress as comp_mod
from ..utils import denc
from . import transaction as tx
from .base import GroupCommitter, NotFound, ObjectStore, StoreError

BLOCK = 4096
HOLE = 0xFFFFFFFF  # block-map entry for an unallocated (all-zero) block
CBLOB = 0xFFFFFFFE  # block-map entry: block lives inside a compressed blob
SEP = b"\x00\x00"
#: writes at or below this total length defer partial-block updates
#: through the kv WAL instead of COW (bluestore_prefer_deferred_size)
DEFER_MAX_BYTES = 64 * 1024
#: inline blob compression bounds (bluestore_compression_min/max_blob_size
#: roles): only aligned spans of >= MIN full blocks are candidates, cut
#: into blobs of <= MAX blocks each
COMPRESS_MIN_BLOCKS = 4    # 16 KiB
COMPRESS_MAX_BLOCKS = 16   # 64 KiB

K_COLL = b"C"
K_ONODE = b"O"
K_OMAP = b"M"
K_HEAD = b"H"
K_DEFER = b"D"  # pending in-place block patch: D + u64 phys -> bytes

_ZERO_BLOCK = bytes(BLOCK)


def _esc(b: bytes) -> bytes:
    """NUL-escape so SEP (double NUL) can't occur inside a component —
    the same trick BlueStore's key encoding uses."""
    return b.replace(b"\x00", b"\x00\x01")


def _okey(cid: str, oid: bytes) -> bytes:
    return _esc(cid.encode()) + SEP + _esc(oid)


class CBlob:
    """One compressed blob (bluestore_blob_t FLAG_COMPRESSED role): a
    run of ``nblocks`` logical blocks stored as ``len(phys)`` physical
    blocks of compressed bytes (``clen`` real bytes, zero-padded to the
    block grid). ``csums`` are per PHYSICAL block, over the compressed
    bytes — verified before decompression, like the reference checksums
    compressed extents."""

    __slots__ = ("nblocks", "phys", "clen", "alg", "csums")

    def __init__(self, nblocks: int, phys: list[int], clen: int,
                 alg: str, csums: list[int]):
        self.nblocks = nblocks
        self.phys = phys
        self.clen = clen
        self.alg = alg
        self.csums = csums

    def copy(self) -> "CBlob":
        return CBlob(self.nblocks, list(self.phys), self.clen,
                     self.alg, list(self.csums))


class Onode:
    """Per-object metadata: size, 4K block map, per-block crc32c,
    compressed blobs, xattrs, omap (omap is authoritative in kv;
    cached here)."""

    __slots__ = ("size", "blocks", "csums", "xattrs", "omap",
                 "omap_header", "cblobs")

    def __init__(self):
        self.size = 0
        self.blocks: list[int] = []
        self.csums: list[int] = []
        self.xattrs: dict[str, bytes] = {}
        self.omap: dict[bytes, bytes] = {}
        self.omap_header = b""
        self.cblobs: dict[int, CBlob] = {}  # start block index -> blob

    def clone_meta(self) -> "Onode":
        o = Onode()
        o.size = self.size
        o.blocks = list(self.blocks)
        o.csums = list(self.csums)
        o.xattrs = dict(self.xattrs)
        o.omap = dict(self.omap)
        o.omap_header = self.omap_header
        o.cblobs = {s: cb.copy() for s, cb in self.cblobs.items()}
        return o

    def find_cblob(self, bi: int) -> tuple[int, CBlob] | None:
        for start, cb in self.cblobs.items():
            if start <= bi < start + cb.nblocks:
                return start, cb
        return None

    def encode(self) -> bytes:
        parts = [
            denc.enc_u64(self.size),
            denc.enc_list(self.blocks, denc.enc_u32),
            denc.enc_list(self.csums, denc.enc_u32),
            denc.enc_map(self.xattrs, denc.enc_str, denc.enc_bytes),
            denc.enc_u32(len(self.cblobs)),
        ]
        for start in sorted(self.cblobs):
            cb = self.cblobs[start]
            parts += [
                denc.enc_u32(start), denc.enc_u32(cb.nblocks),
                denc.enc_list(cb.phys, denc.enc_u32),
                denc.enc_u32(cb.clen), denc.enc_str(cb.alg),
                denc.enc_list(cb.csums, denc.enc_u32),
            ]
        return b"".join(parts)

    @classmethod
    def decode(cls, buf: bytes) -> "Onode":
        o = cls()
        o.size, off = denc.dec_u64(buf, 0)
        o.blocks, off = denc.dec_list(buf, off, denc.dec_u32)
        o.csums, off = denc.dec_list(buf, off, denc.dec_u32)
        o.xattrs, off = denc.dec_map(buf, off, denc.dec_str, denc.dec_bytes)
        if off < len(buf):  # v1 records (pre-compression) simply end here
            n, off = denc.dec_u32(buf, off)
            for _ in range(n):
                start, off = denc.dec_u32(buf, off)
                nblocks, off = denc.dec_u32(buf, off)
                phys, off = denc.dec_list(buf, off, denc.dec_u32)
                clen, off = denc.dec_u32(buf, off)
                alg, off = denc.dec_str(buf, off)
                csums, off = denc.dec_list(buf, off, denc.dec_u32)
                o.cblobs[start] = CBlob(nblocks, phys, clen, alg, csums)
        return o


class _CollView:
    """Dict-like overlay over one committed collection: reads fall
    through to the committed dict, writes stay in the overlay until
    commit (None = deleted). Keeps staging O(ops touched), not
    O(objects in the PG)."""

    def __init__(self, committed: dict[bytes, Onode] | None):
        self.committed = committed if committed is not None else {}
        self.overlay: dict[bytes, Onode | None] = {}

    def get(self, oid: bytes) -> Onode | None:
        if oid in self.overlay:
            return self.overlay[oid]
        return self.committed.get(oid)

    def __contains__(self, oid: bytes) -> bool:
        return self.get(oid) is not None

    def __getitem__(self, oid: bytes) -> Onode:
        o = self.get(oid)
        if o is None:
            raise KeyError(oid)
        return o

    def __setitem__(self, oid: bytes, o: Onode) -> None:
        self.overlay[oid] = o

    def pop(self, oid: bytes) -> Onode:
        o = self[oid]
        self.overlay[oid] = None
        return o

    def __iter__(self):
        for oid in self.committed:
            if self.overlay.get(oid, ...) is not None:
                yield oid
        for oid, o in self.overlay.items():
            if o is not None and oid not in self.committed:
                yield oid

    def empty(self) -> bool:
        return next(iter(self), None) is None


class _Txc:
    """Staging state of one transaction (the txc)."""

    def __init__(self, store: "BlueStoreLite"):
        self.store = store
        self.views: dict[str, _CollView] = {}  # touched collections
        self.staged: dict[int, bytes] = {}  # new phys block -> contents
        #: deferred small overwrites (BlueStore.cc:14768 _do_write_small
        #: role): existing phys block -> merged contents. The delta
        #: commits through the kv WAL batch (the commit point) and the
        #: block is patched IN PLACE afterwards — no COW allocation, no
        #: old-block free. Crash recovery replays defer records at
        #: mount, so the in-place write is repeatable.
        self.deferred: dict[int, bytes] = {}
        self.new_blocks: list[int] = []     # rollback set
        self.freed: list[int] = []          # release after commit
        self.dirty: set[tuple[str, bytes]] = set()
        self.coll_added: set[str] = set()
        self.coll_removed: set[str] = set()
        # ids of onodes created or cloned by THIS txn — safe to mutate.
        # (An identity check against the committed dict is not enough:
        # split/merge move committed Onode objects between collections.)
        self.private: set[int] = set()
        # decompressed-blob cache for this txc: (id(onode), start) -> raw
        self._blob_raw_cache: dict[tuple[int, int], bytes] = {}

    # ------------------------------------------------------------ helpers

    def coll(self, cid: str) -> _CollView:
        v = self.views.get(cid)
        if v is not None:
            return v
        if cid in self.coll_removed or cid not in self.store.colls:
            raise NotFound(f"collection {cid}")
        v = _CollView(self.store.colls[cid])
        self.views[cid] = v
        return v

    def onode(self, cid: str, oid: bytes, create: bool) -> Onode:
        c = self.coll(cid)
        o = c.get(oid)
        if o is None:
            if not create:
                raise NotFound(repr(oid))
            o = Onode()
            self.private.add(id(o))
            c[oid] = o
        elif id(o) not in self.private:
            o = o.clone_meta()  # copy-on-first-mutation
            self.private.add(id(o))
            c[oid] = o
        self.dirty.add((cid, oid))
        return o

    def alloc_block(self, data: bytes) -> int:
        try:
            phys = self.store.alloc.alloc(1)
        except MemoryError as e:
            raise StoreError(f"ENOSPC: {e}") from e
        self.new_blocks.append(phys)
        self.staged[phys] = data
        return phys

    def block_bytes(self, onode: Onode, bi: int) -> bytes:
        """Current contents of logical block bi (staged, deferred,
        device, hole, or inside a compressed blob)."""
        if bi >= len(onode.blocks) or onode.blocks[bi] == HOLE:
            return _ZERO_BLOCK
        phys = onode.blocks[bi]
        if phys == CBLOB:
            hit = onode.find_cblob(bi)
            assert hit is not None, f"dangling CBLOB entry at block {bi}"
            start, cb = hit
            raw = self.blob_raw(onode, start, cb)
            return raw[(bi - start) * BLOCK:(bi - start + 1) * BLOCK]
        if phys in self.staged:
            return self.staged[phys]
        if phys in self.deferred:
            return self.deferred[phys]
        return self.store._pread_block(phys)

    def _free_phys(self, p: int) -> None:
        """Free one physical block: staged-by-this-txc blocks roll back
        immediately; committed blocks release after the kv commit."""
        if p in self.staged:
            del self.staged[p]
            self.new_blocks.remove(p)
            self.store.alloc.release(p, 1)
        else:
            self.freed.append(p)

    def free_onode_blocks(self, o: Onode) -> None:
        for b in o.blocks:
            if b not in (HOLE, CBLOB):
                self._free_phys(b)
        for start, cb in o.cblobs.items():
            for p in cb.phys:
                self._free_phys(p)
            # the onode may be garbage after this; a recycled id()
            # must not resurrect its decompressed bytes
            self._blob_raw_cache.pop((id(o), start), None)

    def blob_raw(self, onode: Onode, start: int, cb: CBlob) -> bytes:
        """Decompressed contents of one blob (staged or on-device)."""
        key = (id(onode), start)
        raw = self._blob_raw_cache.get(key)
        if raw is None:
            comp = b"".join(
                self.staged.get(p) or self.store._pread_block(p)
                for p in cb.phys)
            raw = self.store.compressor(cb.alg).decompress(comp[:cb.clen])
            self._blob_raw_cache[key] = raw
        return raw

    def plainify(self, onode: Onode, lo: int, hi: int,
                 full_lo: int = 0, full_hi: int = 0) -> None:
        """Dissolve any compressed blob overlapping logical blocks
        [lo, hi): blocks about to be FULLY overwritten ([full_lo,
        full_hi)) become holes (no decompress needed for them); the
        rest rematerialize as plain COW blocks. The reference
        garbage-collects overwritten compressed extents the same way
        (BlueStore.cc _do_write / gc). Blob physical blocks are freed."""
        for start in [s for s, cb in onode.cblobs.items()
                      if s < hi and s + cb.nblocks > lo]:
            cb = onode.cblobs[start]
            keep = [bi for bi in range(start, start + cb.nblocks)
                    if not full_lo <= bi < full_hi]
            raw = self.blob_raw(onode, start, cb) if keep else b""
            for bi in range(start, start + cb.nblocks):
                onode.blocks[bi] = HOLE  # reassign must not free CBLOB
                onode.csums[bi] = 0
            for bi in keep:
                piece = raw[(bi - start) * BLOCK:(bi - start + 1) * BLOCK]
                if piece != _ZERO_BLOCK:
                    self.reassign(onode, bi, piece)
            for p in cb.phys:
                self._free_phys(p)
            del onode.cblobs[start]
            self._blob_raw_cache.pop((id(onode), start), None)

    def try_compress(self, onode: Onode, offset: int,
                     data: bytes) -> tuple[int, int]:
        """Compress the aligned full-block prefix of this write into
        blobs (_do_write_compressed role). Returns (consumed_lo_byte,
        consumed_hi_byte) of the span now owned by blobs; the caller
        writes the rest plain. Only spans of >= COMPRESS_MIN_BLOCKS
        aligned blocks are candidates; each blob covers <=
        COMPRESS_MAX_BLOCKS and must save at least one physical block
        (required-ratio role) or that chunk stays plain."""
        store = self.store
        if store._comp is None or offset % BLOCK:
            return offset, offset
        hint = comp_mod.HINT_NONE
        h = onode.xattrs.get("_alloc_hint")
        if h is not None and len(h) >= 20:
            flags = int.from_bytes(h[16:20], "little")
            if flags & 1:
                hint = comp_mod.HINT_COMPRESSIBLE
            elif flags & 2:
                hint = comp_mod.HINT_INCOMPRESSIBLE
        if not comp_mod.should_compress(store.compression_mode, hint):
            return offset, offset
        nfull = len(data) // BLOCK
        if nfull < COMPRESS_MIN_BLOCKS:
            return offset, offset
        pos = 0
        while nfull - pos >= COMPRESS_MIN_BLOCKS:
            nb = min(COMPRESS_MAX_BLOCKS, nfull - pos)
            chunk = data[pos * BLOCK:(pos + nb) * BLOCK]
            out = comp_mod.compress_blob(
                store._comp, chunk, store.compression_required_ratio)
            need = -(-len(out) // BLOCK) if out is not None else nb
            start = offset // BLOCK + pos
            if out is None or need >= nb:
                # incompressible chunk: leave it (and everything after
                # — same data character) to the plain path
                break
            for bi in range(start, start + nb):
                self.punch(onode, bi)  # free old plain phys (blobs were
                #                        dissolved by plainify already)
            padded = out + b"\x00" * (need * BLOCK - len(out))
            phys = [self.alloc_block(padded[i * BLOCK:(i + 1) * BLOCK])
                    for i in range(need)]
            for bi in range(start, start + nb):
                onode.blocks[bi] = CBLOB
            onode.cblobs[start] = CBlob(
                nb, phys, len(out), store._comp.name, [0] * need)
            self._blob_raw_cache[(id(onode), start)] = chunk
            pos += nb
        return offset, offset + pos * BLOCK

    def defer_patch(self, onode: Onode, bi: int, data: bytes) -> None:
        """In-place small overwrite of an existing block: no new
        allocation; the merged contents ride the kv commit as a defer
        record and hit the device after the commit point."""
        self.deferred[onode.blocks[bi]] = data
        onode.csums[bi] = 0  # filled from the batched csum at commit

    def reassign(self, onode: Onode, bi: int, data: bytes) -> None:
        old = onode.blocks[bi]
        if old != HOLE:
            self.freed.append(old)
        onode.blocks[bi] = self.alloc_block(data)
        onode.csums[bi] = 0  # filled from the batched csum at commit

    def punch(self, onode: Onode, bi: int) -> None:
        old = onode.blocks[bi]
        if old != HOLE:
            self.freed.append(old)
        onode.blocks[bi] = HOLE
        onode.csums[bi] = 0

    def grow(self, onode: Onode, size: int) -> None:
        nb = -(-size // BLOCK)
        while len(onode.blocks) < nb:
            onode.blocks.append(HOLE)
            onode.csums.append(0)

    # ----------------------------------------------------------- data ops

    def write_range(self, onode: Onode, offset: int, data: bytes) -> None:
        if not isinstance(data, bytes):
            # view/BufferList payloads materialize HERE: the blob layer
            # slices, compresses and checksums per block, which is this
            # store's kv/COW boundary — the one flatten the buffer
            # plane budgets for
            data = bytes(data)
        if not data:
            onode.size = max(onode.size, offset)
            self.grow(onode, onode.size)
            return
        end = offset + len(data)
        small = len(data) <= DEFER_MAX_BYTES
        self.grow(onode, max(end, onode.size))
        # dissolve compressed blobs under the write; fully-covered
        # blocks need no rematerialization
        full_lo, full_hi = -(-offset // BLOCK), end // BLOCK
        self.plainify(onode, offset // BLOCK, -(-end // BLOCK),
                      full_lo, max(full_lo, full_hi))
        # compress the aligned full-block prefix into blobs
        clo, chi = self.try_compress(onode, offset, data)
        if chi > clo:
            onode.size = max(onode.size, chi)
            data = data[chi - offset:]
            offset = chi
            if not data:
                return
            end = offset + len(data)
        for bi in range(offset // BLOCK, -(-end // BLOCK)):
            b0 = bi * BLOCK
            lo, hi = max(offset, b0), min(end, b0 + BLOCK)
            piece = data[lo - offset:hi - offset]
            if hi - lo == BLOCK:
                self.reassign(onode, bi, piece)
                continue
            old = self.block_bytes(onode, bi)
            nd = old[:lo - b0] + piece + old[hi - b0:]
            phys = onode.blocks[bi]
            if (small and phys != HOLE and phys not in self.staged):
                # partial overwrite of a committed block: defer (WAL)
                # instead of COW — kills the 4 KiB write amplification
                # of every small update (_do_write_small role)
                self.defer_patch(onode, bi, nd)
            else:
                self.reassign(onode, bi, nd)
        onode.size = max(onode.size, end)

    def zero_range(self, onode: Onode, offset: int, length: int) -> None:
        end = offset + length
        small = length <= DEFER_MAX_BYTES
        self.grow(onode, max(end, onode.size))
        full_lo, full_hi = -(-offset // BLOCK), end // BLOCK
        self.plainify(onode, offset // BLOCK, -(-end // BLOCK),
                      full_lo, max(full_lo, full_hi))
        for bi in range(offset // BLOCK, -(-end // BLOCK)):
            b0 = bi * BLOCK
            lo, hi = max(offset, b0), min(end, b0 + BLOCK)
            if hi - lo == BLOCK:
                self.punch(onode, bi)
                continue
            old = self.block_bytes(onode, bi)
            nd = old[:lo - b0] + b"\x00" * (hi - lo) + old[hi - b0:]
            phys = onode.blocks[bi]
            if small and phys != HOLE and phys not in self.staged:
                self.defer_patch(onode, bi, nd)
            else:
                self.reassign(onode, bi, nd)
        onode.size = max(onode.size, end)

    def truncate(self, onode: Onode, size: int) -> None:
        if size < onode.size:
            nb = -(-size // BLOCK)
            # blobs straddling the BYTE cut: rematerialize the kept
            # prefix (incl. a partial tail block, which must become a
            # plain block so the tail-zeroing below can patch it);
            # blobs fully past it: free wholesale
            boundary = nb - 1 if size % BLOCK else nb
            for start in [s for s, cb in onode.cblobs.items()
                          if s + cb.nblocks > boundary]:
                cb = onode.cblobs[start]
                if start >= nb:
                    for p in cb.phys:
                        self._free_phys(p)
                    for bi in range(start, start + cb.nblocks):
                        onode.blocks[bi] = HOLE
                    del onode.cblobs[start]
                    self._blob_raw_cache.pop((id(onode), start), None)
                else:
                    self.plainify(onode, start, start + cb.nblocks,
                                  nb, start + cb.nblocks)
            for bi in range(nb, len(onode.blocks)):
                if onode.blocks[bi] != HOLE:
                    self.freed.append(onode.blocks[bi])
            del onode.blocks[nb:]
            del onode.csums[nb:]
            tail = size % BLOCK
            if tail and nb and onode.blocks[nb - 1] != HOLE:
                # stale bytes past size must read zero if re-extended
                old = self.block_bytes(onode, nb - 1)
                self.reassign(onode, nb - 1, old[:tail] + b"\x00" * (BLOCK - tail))
        onode.size = size
        self.grow(onode, size)

    def read_range(self, onode: Onode, offset: int, length: int) -> bytes:
        end = min(onode.size, offset + length)
        if offset >= end:
            return b""
        parts = []
        for bi in range(offset // BLOCK, -(-end // BLOCK)):
            b0 = bi * BLOCK
            parts.append(self.block_bytes(onode, bi)[
                max(offset, b0) - b0:min(end, b0 + BLOCK) - b0])
        return b"".join(parts)

    # ------------------------------------------------------ op interpreter

    def _coll_exists(self, cid: str) -> bool:
        if cid in self.views:
            return True
        return cid not in self.coll_removed and cid in self.store.colls

    def _drop_coll(self, cid: str) -> None:
        self.views.pop(cid, None)
        self.coll_removed.add(cid)
        self.coll_added.discard(cid)

    def apply(self, op: tx.Op) -> None:
        code, cid, oid, a = op.code, op.cid, op.oid, op.args
        if code == tx.OP_MKCOLL:
            if self._coll_exists(cid):
                raise StoreError(f"collection {cid} exists")
            self.views[cid] = _CollView(None)
            self.coll_added.add(cid)
            return
        if code == tx.OP_RMCOLL:
            c = self.coll(cid)
            if not c.empty():
                raise StoreError(f"collection {cid} not empty")
            self._drop_coll(cid)
            return
        if code == tx.OP_SPLIT_COLL:
            src, dest = self.coll(cid), self.coll(a["dest_cid"])
            mask = (1 << a["bits"]) - 1
            from ..placement.osdmap import ceph_str_hash_rjenkins
            from .base import split_hash_oid

            moving = [o for o in src
                      if split_hash_oid(o) is not None
                      and ceph_str_hash_rjenkins(split_hash_oid(o))
                      & mask == a["rem"]]
            for o in moving:
                dest[o] = src.pop(o)
                self.dirty.add((cid, o))
                self.dirty.add((a["dest_cid"], o))
            return
        if code == tx.OP_MERGE_COLL:
            src, dest = self.coll(cid), self.coll(a["dest_cid"])
            for o in list(src):
                dest[o] = src.pop(o)
                self.dirty.add((cid, o))
                self.dirty.add((a["dest_cid"], o))
            self._drop_coll(cid)
            return
        if code == tx.OP_TOUCH:
            self.onode(cid, oid, create=True)
            return
        if code == tx.OP_REMOVE:
            c = self.coll(cid)
            if oid not in c:
                raise NotFound(repr(oid))
            o = c.pop(oid)
            self.free_onode_blocks(o)
            self.dirty.add((cid, oid))
            return
        if code == tx.OP_CLONE:
            c = self.coll(cid)
            if oid not in c:
                raise NotFound(repr(oid))
            src = c[oid]
            if a["dest"] in c:  # clobbered clone target: free old blocks
                self.free_onode_blocks(c[a["dest"]])
            dst = Onode()
            dst.size = src.size
            dst.xattrs = dict(src.xattrs)
            dst.omap = dict(src.omap)
            dst.omap_header = src.omap_header
            for bi, phys in enumerate(src.blocks):
                if phys in (HOLE, CBLOB):
                    dst.blocks.append(phys)
                    dst.csums.append(0)
                else:  # eager copy (block sharing + refcounts: future)
                    dst.blocks.append(self.alloc_block(
                        self.block_bytes(src, bi)))
                    dst.csums.append(0)
            for start, cb in src.cblobs.items():
                # copy the COMPRESSED bytes verbatim — no decompression
                new_phys = [
                    self.alloc_block(
                        self.staged.get(p) or self.store._pread_block(p))
                    for p in cb.phys]
                dst.cblobs[start] = CBlob(cb.nblocks, new_phys, cb.clen,
                                          cb.alg, list(cb.csums))
            c[a["dest"]] = dst
            self.dirty.add((cid, a["dest"]))
            return
        if code == tx.OP_CLONERANGE:
            c = self.coll(cid)
            if oid not in c:
                raise NotFound(repr(oid))
            data = self.read_range(c[oid], a["src_off"], a["length"])
            dst = self.onode(cid, a["dest"], create=True)
            self.write_range(dst, a["dst_off"], data)
            return

        create = code in (
            tx.OP_WRITE, tx.OP_ZERO, tx.OP_TRUNCATE, tx.OP_SETATTR,
            tx.OP_SETATTRS, tx.OP_OMAP_SETKEYS, tx.OP_OMAP_SETHEADER,
            tx.OP_SETALLOCHINT,
        )
        o = self.onode(cid, oid, create=create)
        if code == tx.OP_WRITE:
            self.write_range(o, a["offset"], a["data"])
        elif code == tx.OP_ZERO:
            self.zero_range(o, a["offset"], a["length"])
        elif code == tx.OP_TRUNCATE:
            self.truncate(o, a["size"])
        elif code == tx.OP_SETATTR:
            o.xattrs[a["name"]] = a["value"]
        elif code == tx.OP_SETATTRS:
            o.xattrs.update(a["attrs"])
        elif code == tx.OP_RMATTR:
            o.xattrs.pop(a["name"], None)
        elif code == tx.OP_RMATTRS:
            o.xattrs.clear()
        elif code == tx.OP_OMAP_CLEAR:
            o.omap.clear()
        elif code == tx.OP_OMAP_SETKEYS:
            o.omap.update(a["kv"])
        elif code == tx.OP_OMAP_RMKEYS:
            for k in a["keys"]:
                o.omap.pop(k, None)
        elif code == tx.OP_OMAP_RMKEYRANGE:
            for k in [k for k in o.omap if a["first"] <= k < a["last"]]:
                del o.omap[k]
        elif code == tx.OP_OMAP_SETHEADER:
            o.omap_header = a["header"]
        elif code == tx.OP_SETALLOCHINT:
            o.xattrs["_alloc_hint"] = (
                a["expected_object_size"].to_bytes(8, "little")
                + a["expected_write_size"].to_bytes(8, "little")
                + a["flags"].to_bytes(4, "little"))
        else:
            raise StoreError(f"unknown op {code}")


class BlueStoreLite(ObjectStore):
    def __init__(self, path: str, size: int = 1 << 30, fsync: bool = False,
                 device_csum: bool = False, io_threads: int = 4,
                 kv_compact_bytes: int = 64 << 20,
                 compression: str | None = None,
                 compression_mode: str = "aggressive",
                 compression_required_ratio: float = 0.875,
                 commit_window_ms: float = 0.0,
                 commit_max_txns: int = 64,
                 device: torch.device | str | None = None):
        super().__init__()
        self.path = str(path)
        self.dev_size = size
        self.fsync = fsync
        self.device_csum = device_csum
        self.io_threads = io_threads
        self.kv_compact_bytes = kv_compact_bytes
        # inline blob compression (bluestore_compression_algorithm/mode
        # roles; default off, like the reference)
        self._comp = comp_mod.create(compression) if compression else None
        self.compression_mode = (compression_mode if compression
                                 else comp_mod.MODE_NONE)
        self.compression_required_ratio = compression_required_ratio
        self._decomps: dict[str, comp_mod.Compressor] = {}
        self.kv: rt.NativeKV | None = None
        self.dev: rt.BlockDevice | None = None
        self.alloc: rt.BitmapAllocator | None = None
        self.colls: dict[str, dict[bytes, Onode]] = {}
        self.lock = threading.RLock()
        self._csum = Checksummer(alg="crc32c", csum_block_size=BLOCK,
                                 device=device)
        self._mounted = False
        # group commit: with a window, each txc still checksums and
        # lands its COW data blocks (drained) itself, but the kv batch
        # — the commit point — the deferred in-place patches and the
        # freed-block release accumulate and are paid ONCE per group
        # (_flush_group). Pending deferred patch bytes stay readable
        # through the _pending_defer overlay until they hit the device.
        self._grouped = commit_window_ms > 0
        self._pending_kv: list[tuple] = []
        self._pending_defer: dict[int, bytes] = {}
        self._pending_freed: list[int] = []
        self._committer = GroupCommitter(
            self._flush_group, stats=self.commit_stats,
            window_s=commit_window_ms / 1e3, max_txns=commit_max_txns)

    def compressor(self, alg: str) -> comp_mod.Compressor:
        """Decompressor lookup by the algorithm recorded in the blob —
        a store reopened with a different (or no) write-side algorithm
        must still read existing blobs."""
        c = self._decomps.get(alg)
        if c is None:
            c = self._decomps[alg] = comp_mod.create(alg)
        return c

    # ---------------------------------------------------------- lifecycle

    def mount(self) -> None:
        import os

        os.makedirs(self.path, exist_ok=True)
        self.kv = rt.NativeKV(os.path.join(self.path, "kv"),
                              fsync=self.fsync)
        self.dev = rt.BlockDevice(os.path.join(self.path, "block"),
                                  self.dev_size, self.io_threads)
        self.alloc = rt.BitmapAllocator(self.dev.size // BLOCK)
        self.colls = {}
        # replay pending deferred patches (crash between kv commit and
        # the in-place write): the records carry the full block bytes
        pending = list(self.kv.scan_prefix(K_DEFER))
        if pending:
            for k, v in pending:
                phys = denc.dec_u64(k[1:], 0)[0]
                self.dev.pwrite(phys * BLOCK, v)
            self.dev.flush()
            self.kv.batch([("del", k, None) for k, _ in pending])
        for k, _ in self.kv.scan_prefix(K_COLL):
            cid = k[1:].replace(b"\x00\x01", b"\x00").decode()
            self.colls[cid] = {}
        for k, v in self.kv.scan_prefix(K_ONODE):
            cid, oid = self._split_okey(k[1:])
            o = Onode.decode(v)
            self.colls.setdefault(cid, {})[oid] = o
            for phys in o.blocks:  # allocator rebuild reclaims orphans
                if phys not in (HOLE, CBLOB):
                    self.alloc.mark_used(phys, 1)
            for cb in o.cblobs.values():
                for phys in cb.phys:
                    self.alloc.mark_used(phys, 1)
        for k, v in self.kv.scan_prefix(K_HEAD):
            cid, oid = self._split_okey(k[1:])
            if cid in self.colls and oid in self.colls[cid]:
                self.colls[cid][oid].omap_header = v
        for k, v in self.kv.scan_prefix(K_OMAP):
            cid, oid, okey = self._split_omap_key(k[1:])
            if cid in self.colls and oid in self.colls[cid]:
                self.colls[cid][oid].omap[okey] = v
        self._mounted = True

    @staticmethod
    def _split_okey(rest: bytes) -> tuple[str, bytes]:
        cid_e, oid_e = rest.split(SEP, 1)
        return (cid_e.replace(b"\x00\x01", b"\x00").decode(),
                oid_e.replace(b"\x00\x01", b"\x00"))

    @staticmethod
    def _split_omap_key(rest: bytes) -> tuple[str, bytes, bytes]:
        cid_e, r = rest.split(SEP, 1)
        oid_e, okey = r.split(SEP, 1)
        return (cid_e.replace(b"\x00\x01", b"\x00").decode(),
                oid_e.replace(b"\x00\x01", b"\x00"), okey)

    def umount(self) -> None:
        if not self._mounted:
            return
        self._committer.close()
        self.kv.compact()
        self.kv.close()
        self.dev.close()
        self.alloc.close()
        self._mounted = False

    # ------------------------------------------------------------- writes

    def commits_deferred(self) -> bool:
        return self._committer.window_s > 0

    def _pread_block(self, phys: int) -> bytes:
        """One committed block's CURRENT bytes: a deferred in-place
        patch still waiting for its group flush shadows the device
        (readers must see the committed-to-memory state, not the block
        the patch has yet to overwrite)."""
        pend = self._pending_defer.get(phys)
        if pend is not None:
            return pend
        return self.dev.pread(phys * BLOCK, BLOCK)

    def queue_transaction(
        self, t: tx.Transaction, on_commit: Callable[[], None] | None = None
    ) -> None:
        if not self._mounted:
            raise StoreError("not mounted")
        with self.lock:
            txc = _Txc(self)
            try:
                for op in t.ops:  # PREPARE
                    txc.apply(op)
            except BaseException:
                for phys in txc.new_blocks:
                    self.alloc.release(phys, 1)
                raise
            self._commit(txc)
            if not self._grouped:
                # legacy per-txn shape: the kv commit point lands
                # under the SAME lock hold that folded the overlay —
                # no reader can serve state whose batch hasn't run
                t0 = time.perf_counter()
                self._flush_group()
                self.commit_stats.observe(1, time.perf_counter() - t0)
        if self._grouped:
            # grouped: the committer pays the kv batch + deferred
            # patches + freed-block release once per window, then
            # fires on_commit; inside the window visibility precedes
            # durability by design (acks ride osd.queue_txn barriers)
            self._committer.add(on_commit)
        elif on_commit:
            on_commit()

    def _commit(self, txc: _Txc) -> None:
        # batched checksums of every staged + deferred block (calc_csum
        # role; one call covers both write classes)
        phys_list = sorted(txc.staged)
        defer_list = sorted(txc.deferred)
        all_blocks = ([(p, txc.staged[p]) for p in phys_list]
                      + [(p, txc.deferred[p]) for p in defer_list])
        if all_blocks:
            blocks = np.frombuffer(
                b"".join(d for _, d in all_blocks), np.uint8
            ).reshape(len(all_blocks), BLOCK)
            crcs = self._csum.calculate(blocks, device=self.device_csum)
            crc_of = {p: int(c) for (p, _), c in zip(all_blocks, crcs)}
            for cid, oid in txc.dirty:
                v = txc.views.get(cid)
                o = v.get(oid) if v is not None else None
                if o is None:
                    continue
                for bi, phys in enumerate(o.blocks):
                    if phys in crc_of:
                        o.csums[bi] = crc_of[phys]
                for cb in o.cblobs.values():
                    for i, phys in enumerate(cb.phys):
                        if phys in crc_of:
                            cb.csums[i] = crc_of[phys]
            # AIO_WAIT: COW data must be on the device before the kv
            # commit (deferred blocks wait until AFTER it — the defer
            # record in the batch is their durability)
            for p in phys_list:
                self.dev.submit_write(p * BLOCK, txc.staged[p])
            if phys_list:
                if self.fsync:
                    self.dev.flush()
                else:
                    self.dev.drain()

        # KV_SUBMIT: one atomic batch = the commit point
        ops: list[tuple[str, bytes, bytes | None]] = []
        for cid in txc.coll_removed:
            ops.append(("del", K_COLL + _esc(cid.encode()), None))
        for cid in txc.coll_added:
            ops.append(("put", K_COLL + _esc(cid.encode()), b""))
        for cid, oid in sorted(txc.dirty):
            key = _okey(cid, oid)
            old = (self.colls.get(cid) or {}).get(oid)
            v = txc.views.get(cid)
            new = v.get(oid) if v is not None else None
            if new is None:
                if old is not None:
                    ops.append(("del", K_ONODE + key, None))
                    if old.omap_header:
                        ops.append(("del", K_HEAD + key, None))
                    for k in old.omap:
                        ops.append(("del", K_OMAP + key + SEP + k, None))
                continue
            ops.append(("put", K_ONODE + key, new.encode()))
            old_hdr = old.omap_header if old is not None else b""
            if new.omap_header != old_hdr:
                if new.omap_header:
                    ops.append(("put", K_HEAD + key, new.omap_header))
                elif old_hdr:
                    ops.append(("del", K_HEAD + key, None))
            old_omap = old.omap if old is not None else {}
            if new.omap is not old_omap:
                for k in old_omap:
                    if k not in new.omap:
                        ops.append(("del", K_OMAP + key + SEP + k, None))
                for k, v in new.omap.items():
                    if old_omap.get(k) != v:
                        ops.append(("put", K_OMAP + key + SEP + k, v))
        for p in defer_list:
            ops.append(("put", K_DEFER + denc.enc_u64(p),
                        txc.deferred[p]))
        if not ops and (txc.dirty or txc.coll_added or txc.coll_removed):
            ops = [("put", b"\x00noop", b"")]
        # KV_SUBMIT is the committer's job now: the ops accumulate and
        # the whole group commits as ONE atomic kv batch (inline mode
        # flushes right after this txc — same prefix durability, the
        # flush amortized over however many txns share the window).
        # Deferred in-place patches stay readable via _pending_defer
        # until they land; freed blocks release only after the group's
        # commit point (re-allocating one earlier would let a crash
        # before the batch corrupt metadata that still references it).
        self._pending_kv.extend(ops)
        self._pending_defer.update(txc.deferred)
        self._pending_freed.extend(txc.freed)

        # FINISH: fold the overlay into the live maps — O(ops), not
        # O(objects in the PG)
        for cid in txc.coll_removed:
            self.colls.pop(cid, None)
        for cid in txc.coll_added:
            self.colls[cid] = {}
        for cid, v in txc.views.items():
            tgt = self.colls.get(cid)
            if tgt is None:
                continue
            for oid, o in v.overlay.items():
                if o is None:
                    tgt.pop(oid, None)
                else:
                    tgt[oid] = o

    def _flush_group(self) -> None:
        """The group's commit point (txc KV_SUBMIT + deferred_cleanup,
        amortized): one atomic kv batch covers every pending txn, then
        the deferred in-place patches hit the device and their records
        drop, then superseded blocks release. Serialized against all
        reads/writes by the store lock, so a reader can never observe
        the instant a patch moves from the overlay to the device."""
        with self.lock:
            ops, self._pending_kv = self._pending_kv, []
            defers, self._pending_defer = self._pending_defer, {}
            freed, self._pending_freed = self._pending_freed, []
            if not (ops or defers or freed):
                return
            if ops:
                self.kv.batch(ops)
            # DEFERRED: patch committed blocks in place, then drop the
            # records (deferred_cleanup role). A crash in between
            # replays them from the kv at mount — the pwrite is
            # idempotent.
            if defers and not getattr(self, "_crash_before_deferred",
                                      False):
                for p in sorted(defers):
                    self.dev.submit_write(p * BLOCK, defers[p])
                if self.fsync:
                    self.dev.flush()
                else:
                    self.dev.drain()
                self.kv.batch([("del", K_DEFER + denc.enc_u64(p), None)
                               for p in sorted(defers)])
            for phys in freed:
                self.alloc.release(phys, 1)
            if self.kv.wal_size() >= self.kv_compact_bytes:
                self.kv.compact()

    # -------------------------------------------------------------- reads

    def _onode(self, cid: str, oid: bytes) -> Onode:
        c = self.colls.get(cid)
        if c is None:
            raise NotFound(f"collection {cid}")
        o = c.get(oid)
        if o is None:
            raise NotFound(repr(oid))
        return o

    def read(self, cid: str, oid: bytes, offset: int = 0,
             length: int = -1) -> bytes:
        with self.lock:
            o = self._onode(cid, oid)
            end = o.size if length < 0 else min(o.size, offset + length)
            if offset >= end:
                return b""
            lo_b, hi_b = offset // BLOCK, -(-end // BLOCK)
            idx = [bi for bi in range(lo_b, hi_b)
                   if bi < len(o.blocks)
                   and o.blocks[bi] not in (HOLE, CBLOB)]
            datas = {bi: self._pread_block(o.blocks[bi])
                     for bi in idx}
            # compressed blobs touched by the range: read their
            # physical blocks; verification joins the one batched call
            blobs: dict[int, CBlob] = {
                s: cb for s, cb in o.cblobs.items()
                if s < hi_b and s + cb.nblocks > lo_b}
            blob_comp = {s: [self._pread_block(p) for p in cb.phys]
                         for s, cb in blobs.items()}
            rows = [datas[bi] for bi in idx]
            want_l = [o.csums[bi] for bi in idx]
            where = [f"block {bi}" for bi in idx]
            for s, cb in blobs.items():
                rows.extend(blob_comp[s])
                want_l.extend(cb.csums)
                where.extend(f"cblob@{s} phys[{i}]"
                             for i in range(len(cb.phys)))
            if rows:  # batched verify_csum (BlueStore.cc:11277 role)
                arr = np.frombuffer(b"".join(rows), np.uint8
                                    ).reshape(len(rows), BLOCK)
                got = self._csum.calculate(arr, device=self.device_csum)
                want = np.array(want_l, np.uint32)
                bad = np.nonzero(got != want)[0]
                if bad.size:
                    j = int(bad[0])
                    raise StoreError(
                        f"csum mismatch on {cid}/{oid!r} {where[j]}: "
                        f"stored {want_l[j]:#x} != actual "
                        f"{int(got[j]):#x}")
            raw = {s: self.compressor(cb.alg).decompress(
                       b"".join(blob_comp[s])[:cb.clen])
                   for s, cb in blobs.items()}
            parts = []
            for bi in range(lo_b, hi_b):
                b0 = bi * BLOCK
                if bi in datas:
                    blkdata = datas[bi]
                elif (bi < len(o.blocks) and o.blocks[bi] == CBLOB):
                    hit = o.find_cblob(bi)
                    assert hit is not None
                    s = hit[0]
                    blkdata = raw[s][(bi - s) * BLOCK:
                                     (bi - s + 1) * BLOCK]
                else:
                    blkdata = _ZERO_BLOCK
                parts.append(blkdata[max(offset, b0) - b0:
                                     min(end, b0 + BLOCK) - b0])
            return b"".join(parts)

    def stat(self, cid: str, oid: bytes) -> int:
        with self.lock:
            return self._onode(cid, oid).size

    def getattr(self, cid: str, oid: bytes, name: str) -> bytes:
        with self.lock:
            attrs = self._onode(cid, oid).xattrs
            if name not in attrs:
                raise NotFound(name)
            return attrs[name]

    def getattrs(self, cid: str, oid: bytes) -> dict[str, bytes]:
        with self.lock:
            return dict(self._onode(cid, oid).xattrs)

    def omap_get(self, cid: str, oid: bytes) -> dict[bytes, bytes]:
        with self.lock:
            return dict(self._onode(cid, oid).omap)

    def omap_get_header(self, cid: str, oid: bytes) -> bytes:
        with self.lock:
            return self._onode(cid, oid).omap_header

    def list_collections(self) -> list[str]:
        with self.lock:
            return sorted(self.colls)

    def list_objects(self, cid: str) -> list[bytes]:
        with self.lock:
            c = self.colls.get(cid)
            if c is None:
                raise NotFound(f"collection {cid}")
            return sorted(c)
