"""WalStore: durable file-backed ObjectStore (the BlueStore role).

Durability model mirrors the reference's txc lifecycle
(src/os/bluestore/BlueStore.cc:12636 _txc_state_proc): a transaction is
PREPAREd (encoded via Transaction.encode — the denc wire form doubles as
the WAL redo record), KV_SUBMITTED (appended to the write-ahead log with
length + CRC32C framing, optionally fsynced), then FINISHed (applied to
the in-memory state, on_commit fired). Crash recovery = replay: mount()
loads the last checkpoint snapshot then re-applies every intact WAL
record; a torn tail (short record or CRC mismatch on the final record)
is discarded, exactly the contract a kill -9 mid-append requires.

Blob checksums follow bluestore_blob_t::calc_csum/verify_csum
(src/os/bluestore/bluestore_types.cc:737,763): every object's data is
checksummed per csum block at checkpoint time through the batched
Checksummer (the C++ core by default; with device_csum=True the crc32c
kernel on ``device``, the card unless the caller names another), and
verified on mount (_verify_csum role, BlueStore.cc:11277) so on-disk
corruption is detected before the data is served.

The store is the host side of the framework — its job is to feed
device-sized batches, so checkpoint checksumming is expressed as ONE
batched call over all blocks of all objects rather than a per-object
loop.

ceph_tpu_torch's own copy of ``ceph_tpu/store/walstore.py``; the WAL,
snapshot and checksum formats are the JAX package's, byte for byte.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable

import numpy as np
import torch

from .. import native
from ..checksum import Checksummer
from ..utils import denc
from . import transaction as tx
from .base import (Collection, GroupCommitter, NotFound, Obj, ObjectStore,
                   StoreError)
from .memstore import MemStore

WAL_NAME = "wal.log"
SNAP_NAME = "snap"
SNAP_MAGIC = 0x53_50_55_54  # "TUPS" — snapshot header magic
SNAP_VERSION = 2  # v2: per-object compression flag byte
CSUM_BLOCK = 4096
MIN_COMPRESS_BLOB = 4096  # bluestore_compression_min_blob_size role


class WalStore(MemStore):
    """MemStore semantics + WAL durability + checkpoint snapshots."""

    def __init__(self, path: str, fsync: bool = False,
                 device_csum: bool = False,
                 wal_compact_bytes: int = 64 << 20,
                 compression: str | None = "zlib",
                 commit_window_ms: float = 0.0,
                 commit_max_txns: int = 64,
                 device: torch.device | str | None = None):
        super().__init__()
        self.path = path
        self.fsync = fsync
        self.device_csum = device_csum
        self.wal_compact_bytes = wal_compact_bytes
        # group commit (store_commit_window_ms/store_commit_max_txns
        # role): transactions arriving within the window append to the
        # WAL individually but pay ONE flush (+fsync) at the group
        # boundary, when their on_commit callbacks fire. 0 = flush per
        # transaction (the legacy durability shape).
        self._committer = GroupCommitter(
            self._flush_wal, stats=self.commit_stats,
            window_s=commit_window_ms / 1e3, max_txns=commit_max_txns)
        # checkpoint blob compression (bluestore_compression_algorithm
        # role); checksums stay over the RAW bytes so rot is attributed
        # to data, not codec framing
        self._comp = None
        if compression:
            from ..utils import compress as comp_mod

            self._comp = comp_mod.create(compression)
        self._wal = None
        self._wal_size = 0
        self._seq = 0  # last applied transaction sequence number
        self._csum = Checksummer(alg="crc32c", csum_block_size=CSUM_BLOCK,
                                 device=device)
        self._mounted = False
        self._compactor: threading.Thread | None = None

    # ---------------------------------------------------------- lifecycle

    def mount(self) -> None:
        os.makedirs(self.path, exist_ok=True)
        snap = os.path.join(self.path, SNAP_NAME)
        if os.path.exists(snap):
            with open(snap, "rb") as f:
                self._load_snapshot(f.read())
        wal_path = os.path.join(self.path, WAL_NAME)
        valid_end = 0
        if os.path.exists(wal_path):
            with open(wal_path, "rb") as f:
                valid_end = self._replay_wal(f.read())
        # discard any torn tail NOW: appending after garbage would make
        # every later record unreachable to the next replay
        self._wal = open(wal_path, "ab")
        if self._wal.tell() != valid_end:
            self._wal.truncate(valid_end)
            self._wal.seek(valid_end)
            if self.fsync:
                os.fsync(self._wal.fileno())
        self._wal_size = valid_end
        self._mounted = True

    def umount(self) -> None:
        if not self._mounted:
            return
        self._committer.close()
        if self._compactor is not None:
            self._compactor.join()
        self.compact()
        self._wal.close()
        self._wal = None
        self._mounted = False

    # ------------------------------------------------------------- writes

    def commits_deferred(self) -> bool:
        return self._committer.window_s > 0

    def _flush_wal(self) -> None:
        """The group's ONE durability barrier: flush the buffered WAL
        records of every transaction in the group, fsync once."""
        with self.lock:
            if self._wal is None:
                return
            self._wal.flush()
            if self.fsync:
                os.fsync(self._wal.fileno())

    def queue_transaction(
        self, t: tx.Transaction, on_commit: Callable[[], None] | None = None
    ) -> None:
        if not self._mounted:
            raise StoreError("not mounted")
        with self.lock:
            # PREPARE: validate + stage copy-on-touch (all-or-nothing);
            # a rejected transaction must never reach the log
            staging = self._stage(t)
            seq = self._seq + 1
            body = denc.enc_u64(seq) + t.encode()
            rec = (
                denc.enc_u32(len(body))
                + denc.enc_u32(native.crc32c(np.frombuffer(body, np.uint8)))
                + body
            )
            # KV_SUBMITTED: the record hits the log BEFORE the visible
            # state flips, so a failed append (ENOSPC…) leaves memory and
            # log consistent; durable once the group's flush ran, only
            # then on_commit (a crash in between replays the flushed
            # prefix and discards the torn tail — exactly the per-txn
            # contract, amortized)
            self._wal.write(rec)
            grouped = self._committer.window_s > 0
            if not grouped:
                # legacy per-txn shape: the flush lands under the SAME
                # lock hold that makes the state visible — no reader
                # can ever serve bytes whose record is still buffered
                t0 = time.perf_counter()
                self._flush_wal()
                self.commit_stats.observe(
                    1, time.perf_counter() - t0)
            self._wal_size += len(rec)
            self._commit_stage(staging)
            self._seq = seq
        if grouped:
            # grouped: visibility precedes durability inside the
            # window by design — acks that promise durability ride the
            # on_commit barrier (cluster/osd.py queue_txn)
            self._committer.add(on_commit)
        elif on_commit:
            on_commit()
        if (self._wal_size >= self.wal_compact_bytes
                and (self._compactor is None
                     or not self._compactor.is_alive())):
            # checkpointing serializes the whole store: run it off the
            # caller's (reactor) thread; compact() takes self.lock
            self._compactor = threading.Thread(
                target=self.compact, daemon=True
            )
            self._compactor.start()

    # --------------------------------------------------------- checkpoint

    def compact(self) -> None:
        """Write a full snapshot, then truncate the WAL (the kv-compaction
        role; atomic via write-to-temp + rename)."""
        # settle the pending group first: its transactions are already
        # in the in-memory state the snapshot captures, so the snapshot
        # IS their durability — but their callbacks must fire before
        # the records that carried them vanish
        self._committer.flush_now()
        with self.lock:
            blob = self._encode_snapshot()
            snap = os.path.join(self.path, SNAP_NAME)
            # unique temp name: a lingering compactor of a crashed-and-
            # reopened instance must not clobber ours mid-publish
            tmp = f"{snap}.tmp.{os.getpid()}.{id(self):x}"
            with open(tmp, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, snap)
            self._wal.truncate(0)
            self._wal.seek(0)
            if self.fsync:
                os.fsync(self._wal.fileno())
            self._wal_size = 0

    # ------------------------------------------------------ wal replay

    def _replay_wal(self, buf: bytes) -> int:
        """Re-apply intact records with seq beyond the snapshot watermark
        (records at or below it are pre-checkpoint history left behind by
        a crash inside compact(), between snapshot publish and WAL
        truncate — skipping by seq makes replay idempotent). Returns the
        byte offset one past the last intact record."""
        off = 0
        n = len(buf)
        while off + 8 <= n:
            length, o2 = denc.dec_u32(buf, off)
            want_crc, o3 = denc.dec_u32(buf, o2)
            if o3 + length > n:
                break  # torn tail: record was mid-append at crash
            body = buf[o3 : o3 + length]
            got = native.crc32c(np.frombuffer(body, np.uint8))
            if got != want_crc:
                break  # torn/corrupt tail record; discard from here on
            seq, boff = denc.dec_u64(body, 0)
            if seq > self._seq:
                t, _ = tx.Transaction.decode(body, boff)
                super().queue_transaction(t)
                self._seq = seq
            off = o3 + length
        return off

    # ------------------------------------------------------ snapshot denc

    def _encode_snapshot(self) -> bytes:
        parts = [
            denc.enc_u32(SNAP_MAGIC),
            denc.enc_u32(SNAP_VERSION),
            denc.enc_u64(self._seq),  # watermark: WAL records <= are stale
            denc.enc_u32(len(self.colls)),
        ]
        # one batched checksum dispatch over every csum block of every
        # object (bluestore_blob_t::calc_csum, batched)
        blocks = []
        spans = []  # (#blocks, raw length) per object, in emission order
        for cid in sorted(self.colls):
            c = self.colls[cid]
            for oid in sorted(c.objects):
                data = bytes(c.objects[oid].data)
                nb = -(-len(data) // CSUM_BLOCK) if data else 0
                padded = data + b"\0" * (nb * CSUM_BLOCK - len(data))
                if nb:
                    blocks.append(
                        np.frombuffer(padded, np.uint8).reshape(nb, CSUM_BLOCK)
                    )
                spans.append((nb, len(data)))
        if blocks:
            all_blocks = np.concatenate(blocks, axis=0)
            crcs = self._csum.calculate(all_blocks, device=self.device_csum)
        else:
            crcs = np.zeros(0, np.uint32)
        bi = 0
        si = 0
        for cid in sorted(self.colls):
            c = self.colls[cid]
            parts.append(denc.enc_str(cid))
            parts.append(denc.enc_u32(len(c.objects)))
            for oid in sorted(c.objects):
                o = c.objects[oid]
                nb, raw_len = spans[si]
                si += 1
                obj_crcs = crcs[bi : bi + nb]
                bi += nb
                parts.append(denc.enc_bytes(oid))
                raw = bytes(o.data)
                stored, flag = raw, 0
                if self._comp is not None and len(raw) >= MIN_COMPRESS_BLOB:
                    from ..utils.compress import compress_blob

                    packed = compress_blob(self._comp, raw)
                    if packed is not None:
                        stored, flag = packed, 1
                parts.append(denc.enc_u8(flag))
                parts.append(denc.enc_bytes(stored))
                parts.append(
                    denc.enc_list(
                        [int(v) for v in obj_crcs],
                        lambda v: denc.enc_u32(v),
                    )
                )
                parts.append(
                    denc.enc_map(o.xattrs, denc.enc_str, denc.enc_bytes)
                )
                parts.append(
                    denc.enc_map(o.omap, denc.enc_bytes, denc.enc_bytes)
                )
                parts.append(denc.enc_bytes(o.omap_header))
        return b"".join(parts)

    def _load_snapshot(self, buf: bytes) -> None:
        magic, off = denc.dec_u32(buf, 0)
        if magic != SNAP_MAGIC:
            raise StoreError("bad snapshot magic")
        version, off = denc.dec_u32(buf, off)
        if version != SNAP_VERSION:
            raise StoreError(f"unsupported snapshot version {version}")
        self._seq, off = denc.dec_u64(buf, off)
        ncoll, off = denc.dec_u32(buf, off)
        colls: dict[str, Collection] = {}
        # gather everything first so verification is one batched dispatch
        pending = []  # (data, crc list)
        for _ in range(ncoll):
            cid, off = denc.dec_str(buf, off)
            nobj, off = denc.dec_u32(buf, off)
            c = Collection(cid)
            for _ in range(nobj):
                oid, off = denc.dec_bytes(buf, off)
                flag, off = denc.dec_u8(buf, off)
                data, off = denc.dec_bytes(buf, off)
                if flag:
                    if self._comp is None:
                        raise StoreError(
                            "snapshot is compressed but store opened "
                            "without compression"
                        )
                    data = self._comp.decompress(data)
                crc_list, off = denc.dec_list(buf, off, denc.dec_u32)
                xattrs, off = denc.dec_map(
                    buf, off, denc.dec_str, denc.dec_bytes
                )
                omap, off = denc.dec_map(
                    buf, off, denc.dec_bytes, denc.dec_bytes
                )
                header, off = denc.dec_bytes(buf, off)
                o = Obj()
                o.data = bytearray(data)
                o.xattrs = xattrs
                o.omap = omap
                o.omap_header = header
                c.objects[oid] = o
                pending.append((cid, oid, data, crc_list))
            colls[cid] = c
        self._verify_snapshot_csums(pending)
        self.colls = colls

    def _verify_snapshot_csums(self, pending) -> None:
        """_verify_csum role (BlueStore.cc:11277): recompute every blob
        checksum in one batch and fail the mount on any mismatch."""
        blocks = []
        index = []  # (cid, oid, block#, want)
        for cid, oid, data, crc_list in pending:
            nb = -(-len(data) // CSUM_BLOCK) if data else 0
            if nb != len(crc_list):
                raise StoreError(
                    f"snapshot csum count mismatch on {cid}/{oid!r}"
                )
            if not nb:
                continue
            padded = data + b"\0" * (nb * CSUM_BLOCK - len(data))
            blocks.append(
                np.frombuffer(padded, np.uint8).reshape(nb, CSUM_BLOCK)
            )
            for b, want in enumerate(crc_list):
                index.append((cid, oid, b, want))
        if not blocks:
            return
        got = self._csum.calculate(
            np.concatenate(blocks, axis=0), device=self.device_csum
        )
        want = np.array([w for (_, _, _, w) in index], dtype=np.uint32)
        bad = np.nonzero(got != want)[0]
        if bad.size:
            cid, oid, b, w = index[int(bad[0])]
            raise StoreError(
                f"snapshot csum mismatch on {cid}/{oid!r} block {b}: "
                f"stored {w:#x} != actual {int(got[int(bad[0])]):#x}"
            )
