"""rbd-mirror-lite: journal-based async image replication between two
clusters (the src/journal Journaler + src/tools/rbd_mirror roles).

Model, mirroring the reference's journaling mode:
- A journaled image appends every mutation (write/discard/resize/
  snap_create) to a per-image journal object BEFORE applying it —
  write-ahead, so the journal is always a superset of the applied
  state (librbd journaling's consistency stance).
- The journal object (``rbd_journal.<name>``) is append-only with
  self-delimiting CRC-framed records addressed by LOGICAL byte
  offsets; a `base` xattr maps logical offsets to physical ones so
  trimming (dropping replayed history) never invalidates positions —
  the Journaler's commit-position/trim arc.
- The MirrorDaemon on the secondary site polls the primary's journal
  from its committed position (persisted on the SECONDARY image header,
  like rbd-mirror's client registration in the journal), replays
  entries through the normal Image API, then advances the position.
  Promote/demote is an xattr flag: replay refuses to touch a promoted
  (primary) secondary — the split-brain guard.

ceph_tpu_torch's own copy of ``ceph_tpu/services/mirror.py``.
"""
from __future__ import annotations

import asyncio

import numpy as np

from .. import native
from ..utils import denc
from .rbd import RBD, Image, ImageNotFound, _header

ATTR_JBASE = "journal.base"  # logical offset of the object's first byte
ATTR_MPOS = "mirror.pos"  # secondary: committed logical offset
ATTR_PRIMARY = "mirror.primary"  # b"1" on the writable site

E_WRITE, E_DISCARD, E_RESIZE, E_SNAP = "write", "discard", "resize", "snap"


def _journal_oid(name: str) -> bytes:
    return f"rbd_journal.{name}".encode()


def _enc_entry(kind: str, offset: int, length: int, data: bytes,
               snap: str) -> bytes:
    body = (denc.enc_str(kind) + denc.enc_u64(offset)
            + denc.enc_i64(length) + denc.enc_bytes(data)
            + denc.enc_str(snap))
    crc = native.crc32c(np.frombuffer(body, np.uint8))
    return denc.enc_u32(len(body)) + denc.enc_u32(crc) + body


def _dec_entries(buf: bytes, start: int):
    """Yield (next_logical_off_delta_consumed_to, entry) tuples."""
    off = start
    n = len(buf)
    while off + 8 <= n:
        length, o2 = denc.dec_u32(buf, off)
        want, o3 = denc.dec_u32(buf, o2)
        if o3 + length > n:
            break
        body = buf[o3:o3 + length]
        if native.crc32c(np.frombuffer(body, np.uint8)) != want:
            raise IOError(f"journal record crc mismatch at {off}")
        kind, bo = denc.dec_str(body, 0)
        offset, bo = denc.dec_u64(body, bo)
        length_, bo = denc.dec_i64(body, bo)
        data, bo = denc.dec_bytes(body, bo)
        snap, bo = denc.dec_str(body, bo)
        off = o3 + length
        yield off, (kind, offset, length_, data, snap)


class JournaledImage(Image):
    """Image whose mutations are journaled write-ahead (the librbd
    `journaling` feature). Open via `await journaled(client, pool,
    name)`."""

    async def _append_journal(self, kind: str, offset: int = 0,
                              length: int = -1, data: bytes = b"",
                              snap: str = "") -> None:
        await self.client.append(
            self.pool_id, _journal_oid(self.name),
            _enc_entry(kind, offset, length, data, snap))

    async def write(self, offset: int, data: bytes) -> None:
        # validate BEFORE journaling (same predicate super().write
        # enforces): a rejected write must not leave a journal entry
        # that would replay as a phantom mutation on the secondary
        self._writable()
        if offset + len(data) > self.size:
            raise IOError(
                f"write past end of image ({offset + len(data)} > "
                f"{self.size})")
        await self._append_journal(E_WRITE, offset, len(data), bytes(data))
        await super().write(offset, data)

    async def discard(self, offset: int, length: int) -> None:
        self._writable()
        await self._append_journal(E_DISCARD, offset, length)
        await super().discard(offset, length)

    async def resize(self, new_size: int) -> None:
        await self._append_journal(E_RESIZE, new_size)
        await super().resize(new_size)

    async def snap_create(self, snap: str) -> None:
        await self._append_journal(E_SNAP, snap=snap)
        await super().snap_create(snap)

    # ------------------------------------------------------ journal mgmt

    async def journal_base(self) -> int:
        try:
            raw = await self.client.getxattr(
                self.pool_id, _journal_oid(self.name), ATTR_JBASE)
            return denc.dec_u64(raw, 0)[0]
        except (KeyError, OSError):  # absent object or ENODATA xattr
            return 0

    async def journal_tail(self) -> int:
        """Logical offset one past the last appended byte."""
        try:
            phys = await self.client.stat(self.pool_id,
                                          _journal_oid(self.name))
        except KeyError:
            return 0
        return await self.journal_base() + phys

    async def journal_read(self, logical_from: int):
        """[(next_logical_off, entry)] from a logical offset."""
        base = await self.journal_base()
        try:
            buf = await self.client.read(self.pool_id,
                                         _journal_oid(self.name))
        except KeyError:
            return []
        out = []
        for rel_next, entry in _dec_entries(
                buf, max(0, logical_from - base)):
            out.append((base + rel_next, entry))
        return out

    async def journal_trim(self, upto_logical: int) -> None:
        """Drop history before a logical offset (Journaler trim role).
        Runs as the server-side `journal.trim` object class so the
        read-modify-write cannot race a concurrent append (a client-side
        readback + write_full would silently destroy records landed in
        between)."""
        await self.client.execute(
            self.pool_id, _journal_oid(self.name), "journal", "trim",
            denc.enc_u64(upto_logical))


async def journaled(client, pool_id: int, name: str) -> JournaledImage:
    img = JournaledImage(client, pool_id, name)
    await img.refresh()
    return img


class MirrorDaemon:
    """One-direction replayer: primary (cluster A, pool) -> secondary
    (cluster B, pool). `sync_image` replays one image to its committed
    position; `run` polls every mirrored image until stopped."""

    def __init__(self, primary_client, primary_pool: int,
                 secondary_client, secondary_pool: int,
                 poll_interval: float = 0.1):
        self.pc, self.ppool = primary_client, primary_pool
        self.sc, self.spool = secondary_client, secondary_pool
        self.poll_interval = poll_interval
        self._task: asyncio.Task | None = None
        self._stop = asyncio.Event()

    # ------------------------------------------------------------ state

    async def _position(self, name: str) -> int:
        try:
            raw = await self.sc.getxattr(self.spool, _header(name),
                                         ATTR_MPOS)
            return denc.dec_u64(raw, 0)[0]
        except (KeyError, OSError):  # absent image or ENODATA xattr
            return 0

    async def _set_position(self, name: str, pos: int) -> None:
        await self.sc.setxattr(self.spool, _header(name), ATTR_MPOS,
                               denc.enc_u64(pos))

    async def _secondary_is_primary(self, name: str) -> bool:
        try:
            raw = await self.sc.getxattr(self.spool, _header(name),
                                         ATTR_PRIMARY)
            return raw == b"1"
        except (KeyError, OSError):  # absent image or ENODATA xattr
            return False

    # -------------------------------------------------------- bootstrap

    async def _bootstrap(self, src: JournaledImage, srbd: RBD,
                         name: str) -> Image:
        """Initial sync of an absent secondary (rbd-mirror bootstrap):
        replicate snapshot HISTORY oldest-first (write each snap's
        content, snapshot it), then the current head, then set the
        committed position to the journal tail read BEFORE the copy —
        entries after it replay on top (idempotent full-state writes);
        entries before it (including old snap_creates) are already
        reflected in the copied history and must NOT replay, or a
        replayed snap_create would capture post-snapshot data."""
        tail = await src.journal_tail()
        await srbd.create(name, src.size, layout=src.layout)
        dst = await srbd.open(name)

        sem = asyncio.Semaphore(8)

        async def copy_view(view: Image, size: int, fresh: bool) -> None:
            chunk = src.layout.object_size

            async def one(off: int) -> None:
                async with sem:
                    data = await view.read(off, min(chunk, size - off))
                    if data.strip(b"\x00"):
                        await dst.write(off, data)
                    elif not fresh:
                        # a chunk that went zero since the previous
                        # pass must be cleared, not skipped
                        await dst.discard(off, min(chunk, size - off))

            await asyncio.gather(*(one(off)
                                   for off in range(0, size, chunk)))

        first = True
        for snap in src.snaps:  # listed oldest-first (append order)
            view = await RBD(self.pc, self.ppool).open(name, snap=snap)
            if view.size != dst.size:
                await dst.resize(view.size)
            await copy_view(view, view.size, first)
            await dst.snap_create(snap)
            first = False
        if dst.size != src.size:
            await dst.resize(src.size)
        await copy_view(src, src.size, first)
        await self._set_position(name, tail)
        return dst

    # ----------------------------------------------------------- replay

    async def sync_image(self, name: str, trim: bool = True) -> int:
        """Replay outstanding journal entries of one image; returns the
        number applied. Bootstraps the secondary image if absent."""
        src = JournaledImage(self.pc, self.ppool, name)
        await src.refresh()
        srbd = RBD(self.sc, self.spool)
        try:
            dst = await srbd.open(name)
        except ImageNotFound:
            dst = await self._bootstrap(src, srbd, name)
        if await self._secondary_is_primary(name):
            raise IOError(
                f"secondary image {name} is promoted (primary); refusing "
                "to replay onto it")
        pos = await self._position(name)
        applied = 0
        for next_pos, (kind, offset, length, data, snap) in (
                await src.journal_read(pos)):
            if kind == E_WRITE:
                if offset + len(data) > dst.size:
                    await dst.resize(offset + len(data))
                await dst.write(offset, data)
            elif kind == E_DISCARD:
                await dst.discard(offset, length)
            elif kind == E_RESIZE:
                await dst.resize(offset)
            elif kind == E_SNAP:
                if snap not in (await dst.snap_list()):
                    await dst.snap_create(snap)
            await self._set_position(name, next_pos)
            pos = next_pos
            applied += 1
        if trim and applied:
            await src.journal_trim(pos)
        return applied

    async def sync_all(self) -> dict[str, int]:
        rbd = RBD(self.pc, self.ppool)
        out = {}
        for name in await rbd.list():
            out[name] = await self.sync_image(name)
        return out

    # ------------------------------------------------------------- loop

    async def start(self) -> None:
        self._stop.clear()
        self._task = asyncio.get_running_loop().create_task(self._run())

    async def _run(self) -> None:
        while not self._stop.is_set():
            try:
                await self.sync_all()
            except Exception:
                pass  # transient (peer down, image mid-create): retry
            try:
                await asyncio.wait_for(self._stop.wait(),
                                       self.poll_interval)
            except asyncio.TimeoutError:
                pass

    async def stop(self) -> None:
        self._stop.set()
        if self._task is not None:
            await self._task
            self._task = None


async def promote(client, pool_id: int, name: str) -> None:
    """Make an image writable on this site (rbd mirror image promote)."""
    await client.setxattr(pool_id, _header(name), ATTR_PRIMARY, b"1")


async def demote(client, pool_id: int, name: str) -> None:
    await client.setxattr(pool_id, _header(name), ATTR_PRIMARY, b"0")
