"""Shared-memory ring messenger: the third backend behind the
LocalBus/Tcp seam, for same-host daemon pairs.

Ceph treats transport as a pluggable ``NetworkStack`` (posix / RDMA /
DPDK); this is the repo's intra-host stack. A TCP send of a 4 MiB EC
fan-out pays flatten + kernel copy-in + kernel copy-out per hop; the
shm path gathers the sender's ``BufferList`` segments ONCE into a
shared arena and hands the receiver a descriptor — the zero-copy plane
built in PR 6 no longer ends at the kernel socket write.

Layout — one ``ShmRing`` per (sender process -> receiver process)
direction, an SPSC ring in one mmap'd shared file:

    header   tail u64 (producer-owned) | head u64 (consumer-owned)
    slots    N descriptors x 32 B:
                 state u32   FREE / READY / RELEASED
                 epoch u32   reuse generation (ABA/zombie guard)
                 off   u64   payload offset into the arena
                 len   u64   payload byte count
                 mtype u32   message type id
    arena    payload bytes, producer-allocated (first-fit free list)

Ownership discipline (what makes the lock-free part honest):
- ``tail`` and every descriptor's off/len/mtype/epoch are written only
  by the producer; ``head`` only by the consumer. Aligned 8-byte
  writes are atomic on every platform jax runs on.
- The consumer's ONLY write into a slot is state -> RELEASED (guarded
  by the epoch it was handed). The producer reclaims RELEASED slots'
  arena blocks onto its local free list and bumps the epoch; a zombie
  consumer's late release of a reused slot is ignored by the guard.
- Peer death: the producer calls ``reclaim_dead()`` (doorbell EOF) —
  every outstanding descriptor is force-freed and epoch-bumped, so the
  ring survives a kill -9'd receiver without leaking arena space.

Doorbells ride a unix-domain stream socket (the portable stand-in for
an eventfd): the producer writes one byte per publish burst; the
consumer drains the ring when the byte arrives. The doorbell carries
no payload, so the socket write is a constant-size wakeup, not a copy
of the data.

``ShmMessenger`` wraps rings + doorbells behind the exact
``TcpMessenger`` send/dispatch contract, including the fault plane:
every send consults ``NetFaultPolicy.plan()`` with the same
(src, dst, rng-draw) sequence as LocalBus and TCP, so a seeded thrash
schedule replays identically over shm (the PR 3 guardrail).

ceph_tpu_torch's own copy of ``ceph_tpu/msg/shmring.py``.
"""
from __future__ import annotations

import asyncio
import json
import mmap
import os
import struct
import time
from typing import Awaitable, Callable

from ..utils import denc
from ..utils.buffer import BufferList
from .messages import Message, decode_message
from .messenger import SendError

Dispatcher = Callable[[str, Message], Awaitable[None]]

#: descriptor states (u32 in the slot)
FREE, READY, RELEASED = 0, 1, 2

_HDR = struct.Struct("<QQ")          # tail, head
_SLOT = struct.Struct("<IIQQI4x")    # state, epoch, off, len, mtype
HDR_BYTES = 64                       # header padded to its own cache line
SLOT_BYTES = _SLOT.size

#: defaults (overridable per-ring and via CEPH_TPU_SHM_* env)
DEFAULT_SLOTS = 256
DEFAULT_ARENA = 8 << 20


def _shm_dir(hint: str) -> str:
    """Ring files live on tmpfs when the host has one: a disk-backed
    mmap works but invites writeback I/O under the data plane."""
    d = os.environ.get("CEPH_TPU_SHM_DIR")
    if d:
        return d
    if os.path.isdir("/dev/shm"):
        return "/dev/shm"
    return hint


class ShmRingError(Exception):
    pass


class ShmMessage:
    """One received descriptor: a zero-copy view into the peer's arena
    plus the release obligation. EVERY consume path must call
    ``release()`` (the JAX package's lint checks it) — an unreleased
    descriptor pins its arena block until the producer declares the
    consumer dead."""

    __slots__ = ("view", "mtype", "_ring", "_slot", "_epoch", "_done")

    def __init__(self, view: memoryview, mtype: int, ring: "ShmRing",
                 slot: int, epoch: int):
        self.view = view
        self.mtype = mtype
        self._ring = ring
        self._slot = slot
        self._epoch = epoch
        self._done = False

    def release(self) -> None:
        if self._done:
            return
        self._done = True
        self.view = memoryview(b"")
        self._ring._release_slot(self._slot, self._epoch)


class ShmRing:
    """Single-producer single-consumer descriptor ring over one shared
    mmap. The creating side is the PRODUCER and owns the file; the
    attaching side is the CONSUMER."""

    def __init__(self, path: str, slots: int = DEFAULT_SLOTS,
                 arena_bytes: int = DEFAULT_ARENA, create: bool = True):
        self.path = path
        self.slots = slots
        self.arena_bytes = arena_bytes
        self.is_producer = create
        self._arena_off = HDR_BYTES + slots * SLOT_BYTES
        size = self._arena_off + arena_bytes
        if create:
            fd = os.open(path, os.O_CREAT | os.O_RDWR | os.O_EXCL,
                         0o600)
            try:
                os.ftruncate(fd, size)
                self._mm = mmap.mmap(fd, size)
            finally:
                os.close(fd)
            self._mm[:HDR_BYTES] = b"\0" * HDR_BYTES
            # producer-local allocator state: free arena extents and
            # the epoch/extent of every outstanding descriptor
            self._free: list[tuple[int, int]] = [(0, arena_bytes)]
            self._outstanding: dict[int, tuple[int, int, int]] = {}
            self._epochs = [0] * slots
        else:
            fd = os.open(path, os.O_RDWR)
            try:
                self._mm = mmap.mmap(fd, size)
            finally:
                os.close(fd)
        self._view = memoryview(self._mm)
        # ledger (producer side): gathers/bytes through the arena,
        # sends refused by backpressure, reclaims after peer death
        self.sends = 0
        self.bytes_sent = 0
        self.backpressure_hits = 0
        self.reclaimed_dead = 0

    # ------------------------------------------------------ header access

    @property
    def tail(self) -> int:
        return _HDR.unpack_from(self._mm, 0)[0]

    @tail.setter
    def tail(self, v: int) -> None:
        struct.pack_into("<Q", self._mm, 0, v)

    @property
    def head(self) -> int:
        return _HDR.unpack_from(self._mm, 0)[1]

    @head.setter
    def head(self, v: int) -> None:
        struct.pack_into("<Q", self._mm, 8, v)

    def _slot_at(self, idx: int) -> tuple[int, int, int, int, int]:
        return _SLOT.unpack_from(self._mm, HDR_BYTES + idx * SLOT_BYTES)

    def _set_slot(self, idx: int, state: int, epoch: int, off: int,
                  length: int, mtype: int) -> None:
        _SLOT.pack_into(self._mm, HDR_BYTES + idx * SLOT_BYTES,
                        state, epoch, off, length, mtype)

    def _set_state(self, idx: int, state: int) -> None:
        struct.pack_into("<I", self._mm, HDR_BYTES + idx * SLOT_BYTES,
                         state)

    # -------------------------------------------------------- producer

    def _reclaim_released(self) -> None:
        """Fold consumer-released descriptors back into the free list
        (the producer-owned half of the epoch-tagged free list: the
        consumer only flips state; all allocator mutation stays on this
        side of the ring)."""
        for idx in [i for i in self._outstanding]:
            state, epoch, *_rest = self._slot_at(idx)
            off, length, want_epoch = self._outstanding[idx]
            if state == RELEASED and epoch == want_epoch:
                del self._outstanding[idx]
                self._free_extent(off, length)
                self._epochs[idx] = (epoch + 1) & 0xFFFFFFFF
                self._set_slot(idx, FREE, self._epochs[idx], 0, 0, 0)

    def _free_extent(self, off: int, length: int) -> None:
        # first-fit free list with adjacent-extent coalescing: arena
        # fragmentation would otherwise defeat the ring under mixed
        # 4 KiB / 4 MiB payload populations
        self._free.append((off, length))
        self._free.sort()
        merged: list[tuple[int, int]] = []
        for o, ln in self._free:
            if merged and merged[-1][0] + merged[-1][1] == o:
                merged[-1] = (merged[-1][0], merged[-1][1] + ln)
            else:
                merged.append((o, ln))
        self._free = merged

    def _alloc(self, length: int) -> int | None:
        for i, (off, ln) in enumerate(self._free):
            if ln >= length:
                if ln == length:
                    del self._free[i]
                else:
                    self._free[i] = (off + length, ln - length)
                return off
        return None

    def try_send(self, segments, mtype: int) -> bool:
        """Gather ``segments`` (memoryview/bytes iterables — a
        BufferList's ``segments()``) into the arena and publish one
        descriptor. False = ring full or arena exhausted
        (backpressure; the caller retries after the consumer releases).
        """
        assert self.is_producer
        self._reclaim_released()
        tail, head = self.tail, self.head
        if tail - head >= self.slots:
            self.backpressure_hits += 1
            return False
        idx = tail % self.slots
        state, *_rest = self._slot_at(idx)
        if idx in self._outstanding:
            # consumed long ago but never released (slow consumer or a
            # leak on their side): the slot is not reusable yet
            self.backpressure_hits += 1
            return False
        segs = list(segments)
        total = sum(len(s) for s in segs)
        off = self._alloc(total)
        if off is None:
            self.backpressure_hits += 1
            return False
        pos = self._arena_off + off
        for s in segs:
            n = len(s)
            # the gather: each BufferList segment lands in the arena
            # exactly once, with no intermediate flatten
            self._mm[pos:pos + n] = s
            pos += n
        epoch = self._epochs[idx]
        self._set_slot(idx, READY, epoch, off, total, mtype)
        self._outstanding[idx] = (off, total, epoch)
        self.tail = tail + 1
        self.sends += 1
        self.bytes_sent += total
        return True

    def reclaim_dead(self) -> int:
        """Peer-death reclamation: force-free every outstanding
        descriptor and bump its epoch, so a zombie's late release is a
        no-op and the arena is whole again."""
        n = 0
        for idx, (off, length, epoch) in list(self._outstanding.items()):
            del self._outstanding[idx]
            self._free_extent(off, length)
            self._epochs[idx] = (epoch + 1) & 0xFFFFFFFF
            self._set_slot(idx, FREE, self._epochs[idx], 0, 0, 0)
            n += 1
        self.reclaimed_dead += n
        # the consumer is gone: rewind unconsumed publishes too
        self.head = self.tail
        return n

    # -------------------------------------------------------- consumer

    def recv_all(self) -> list[ShmMessage]:
        """Drain every published descriptor (consumer side). Each
        returned message MUST be released."""
        out: list[ShmMessage] = []
        head, tail = self.head, self.tail
        while head < tail:
            idx = head % self.slots
            state, epoch, off, length, mtype = self._slot_at(idx)
            if state != READY:
                break  # producer mid-publish; the next doorbell retries
            a = self._arena_off + off
            out.append(ShmMessage(self._view[a:a + length].toreadonly(),
                                  mtype, self, idx, epoch))
            head += 1
        self.head = head
        return out

    def _release_slot(self, idx: int, epoch: int) -> None:
        state, cur_epoch, *_rest = self._slot_at(idx)
        if cur_epoch != epoch:
            return  # zombie release of a reclaimed/reused slot
        self._set_state(idx, RELEASED)

    # ------------------------------------------------------- lifecycle

    def close(self, unlink: bool = False) -> None:
        try:
            self._view.release()
            self._mm.close()
        except BufferError:
            # an unreleased ShmMessage still exports a view (a leaky
            # consumer mid-crash): leave the mapping to the GC rather
            # than tearing pages out from under the view
            pass
        if unlink:
            try:
                os.unlink(self.path)
            except OSError:
                pass


class ShmMessenger:
    """Same-host messenger over ShmRings (the TcpMessenger contract:
    ``listen()`` / ``send(dst_addr, msg)`` / ``close()``, dispatcher
    callback, optional NetFaultPolicy consulted per send).

    Addressing: peers are unix-socket paths (the doorbell listener).
    Dialing a peer creates OUR producer ring (a fresh shared file next
    to the socket), hands its geometry to the peer over the doorbell
    socket, then every send gathers payload segments into the arena
    and writes one doorbell byte. The reverse direction is the peer's
    own dial back to our socket — one ring per direction, each with
    exactly one producer and one consumer.
    """

    def __init__(self, name: str, dispatcher: Dispatcher, faults=None,
                 slots: int | None = None,
                 arena_bytes: int | None = None):
        self.name = name
        self.dispatcher = dispatcher
        #: optional NetFaultPolicy — consulted exactly like LocalBus /
        #: TcpMessenger so seeded schedules replay identically here
        self.faults = faults
        self.slots = slots or int(os.environ.get(
            "CEPH_TPU_SHM_RING_SLOTS", DEFAULT_SLOTS))
        self.arena_bytes = arena_bytes or int(os.environ.get(
            "CEPH_TPU_SHM_ARENA_BYTES", DEFAULT_ARENA))
        self.sock_path: str | None = None
        self._server: asyncio.AbstractServer | None = None
        # dst sock path -> (ring, writer)
        self._out: dict[str, tuple[ShmRing, asyncio.StreamWriter]] = {}
        self._readers: set[asyncio.Task] = set()
        self._bg: set[asyncio.Task] = set()
        self._send_locks: dict[str, asyncio.Lock] = {}
        self._ring_seq = 0
        #: corked doorbells: publishes since the last wakeup share one
        #: doorbell byte (the LocalBus/Tcp cork idiom — the consumer
        #: drains the whole ring per byte anyway)
        self._bell_pending: set[str] = set()
        #: ledger: zero-copy gathers through arenas + doorbell bytes
        self.doorbells = 0
        self.zero_copy_gathers = 0

    # ------------------------------------------------------- lifecycle

    async def listen(self, sock_path: str) -> str:
        if os.path.exists(sock_path):
            os.unlink(sock_path)
        self._server = await asyncio.start_unix_server(
            self._accept, path=sock_path)
        self.sock_path = sock_path
        return sock_path

    async def close(self) -> None:
        if self._server:
            self._server.close()
        for t in list(self._bg):
            t.cancel()
        for ring, writer in self._out.values():
            writer.close()
            ring.close(unlink=True)
        self._out.clear()
        readers = list(self._readers)
        for t in readers:
            t.cancel()
        if readers:
            await asyncio.gather(*readers, return_exceptions=True)
        if self._server:
            await self._server.wait_closed()
        if self.sock_path and os.path.exists(self.sock_path):
            try:
                os.unlink(self.sock_path)
            except OSError:
                pass

    # --------------------------------------------------------- receive

    async def _accept(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._readers.add(task)
        ring: ShmRing | None = None
        try:
            line = await reader.readline()
            if not line:
                return
            hello = json.loads(line)
            ring = ShmRing(hello["ring"], slots=hello["slots"],
                           arena_bytes=hello["arena"], create=False)
            while True:
                beat = await reader.read(4096)
                if not beat:
                    return  # producer went away; it owns the file
                await self._drain_ring(ring)
        except (asyncio.CancelledError, ConnectionError, OSError,
                json.JSONDecodeError, KeyError):
            pass
        finally:
            self._readers.discard(task)
            if ring is not None:
                ring.close()
            writer.close()

    async def _drain_ring(self, ring: ShmRing) -> None:
        for msg in ring.recv_all():
            # materialize BEFORE release: decoded messages may retain
            # views of their payload (the zero-copy decode contract),
            # and the arena block is reusable the moment we release.
            # This one copy replaces the kernel's two on the TCP path.
            try:
                payload = bytes(msg.view)
                mtype = msg.mtype
            finally:
                msg.release()
            sender, off = denc.dec_str(payload, 0)
            decoded = decode_message(mtype, payload[off:])
            # scheduled, never inline (LocalBus re-entrancy stance)
            task = asyncio.get_running_loop().create_task(
                self.dispatcher(sender, decoded))
            self._bg.add(task)
            task.add_done_callback(self._bg.discard)

    # ------------------------------------------------------------ send

    async def _connect(self, dst: str) -> tuple[ShmRing,
                                                asyncio.StreamWriter]:
        try:
            reader, writer = await asyncio.open_unix_connection(dst)
        except OSError as e:
            raise SendError(f"shm connect to {dst} failed: {e}") from e
        self._ring_seq += 1
        # name must be unique per MESSENGER, not per process: one
        # process can host several messengers (tests, the bench's
        # in-one-loop pairs), and a collision would let a peer attach
        # to its own producer ring
        ring_path = os.path.join(
            _shm_dir(os.path.dirname(dst)),
            f"ctpu-ring.{os.getpid()}.{id(self) & 0xFFFFFF:x}"
            f".{self._ring_seq}")
        ring = ShmRing(ring_path, slots=self.slots,
                       arena_bytes=self.arena_bytes, create=True)
        writer.write(json.dumps({
            "ring": ring_path, "slots": self.slots,
            "arena": self.arena_bytes, "peer": self.name,
        }).encode() + b"\n")
        try:
            await writer.drain()
        except (ConnectionError, OSError) as e:
            ring.close(unlink=True)
            raise SendError(f"shm hello to {dst} failed: {e}") from e
        # watch for peer death: EOF on the doorbell socket triggers
        # epoch-bumped reclamation of every outstanding descriptor
        task = asyncio.get_running_loop().create_task(
            self._watch_peer(dst, reader))
        self._bg.add(task)
        task.add_done_callback(self._bg.discard)
        return ring, writer

    async def _watch_peer(self, dst: str, reader) -> None:
        try:
            while await reader.read(4096):
                pass
        except (ConnectionError, OSError, asyncio.CancelledError):
            pass
        finally:
            conn = self._out.pop(dst, None)
            if conn is not None:
                ring, writer = conn
                ring.reclaim_dead()
                ring.close(unlink=True)
                writer.close()

    async def send(self, dst: str, msg: Message,
                   timeout: float = 10.0) -> None:
        copies = 1
        if self.faults is not None:
            plan = self.faults.plan(self.name, dst)
            if plan is None:
                return  # dropped on the (shared-memory) wire
            delay = max(plan)
            copies = len(plan)
            if delay > 0:
                snap = msg.snapshot()
                task = asyncio.get_running_loop().create_task(
                    self._send_delayed(dst, snap, delay, copies))
                self._bg.add(task)
                task.add_done_callback(self._bg.discard)
                return
        await self._send_now(dst, msg, copies, timeout)

    async def _send_delayed(self, dst: str, msg: Message, delay: float,
                            copies: int) -> None:
        await asyncio.sleep(delay)
        try:
            await self._send_now(dst, msg, copies, 10.0)
        except SendError:
            pass  # the link was faulted anyway; nobody to tell

    async def _send_now(self, dst: str, msg: Message, copies: int,
                        timeout: float) -> None:
        lock = self._send_locks.setdefault(dst, asyncio.Lock())
        async with lock:  # SPSC: one producer means one writer at a time
            conn = self._out.get(dst)
            if conn is None:
                conn = await self._connect(dst)
                self._out[dst] = conn
            ring, writer = conn
            payload = msg.encode_bl(BufferList(denc.enc_str(self.name)))
            segs = list(payload.segments())
            deadline = time.monotonic() + timeout
            for _copy in range(copies):
                while not ring.try_send(segs, msg.TYPE):
                    # full ring / exhausted arena: real backpressure.
                    # Yield until the consumer releases; the deadline
                    # turns a dead consumer into a SendError.
                    if time.monotonic() > deadline:
                        raise SendError(
                            f"shm ring to {dst} full past deadline")
                    await asyncio.sleep(0.0005)
            self.zero_copy_gathers += copies
        if dst not in self._bell_pending:
            self._bell_pending.add(dst)
            asyncio.get_running_loop().call_soon(self._ring_bell, dst)

    def _ring_bell(self, dst: str) -> None:
        """One doorbell byte for every publish since the last bell.
        A dead peer is detected by _watch_peer's EOF (reclaim +
        teardown); the next send then redials and surfaces
        SendError like a TCP reconnect would."""
        self._bell_pending.discard(dst)
        conn = self._out.get(dst)
        if conn is None:
            return
        _ring, writer = conn
        try:
            writer.write(b"\x01")
            self.doorbells += 1
        except (ConnectionError, OSError):
            pass  # _watch_peer tears the connection down
