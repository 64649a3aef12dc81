"""Messengers: in-process LocalBus, asyncio TcpMessenger, and (in
shmring.py, behind the same seam) the shared-memory ring backend.

All three speak the same CRC-framed wire format (frames.py) and the same
envelope: payload = enc_str(src_entity) + msg bytes, frame.type = message
type. Entities are reference-style names ("mon", "osd.3", "client.7").
NetBus (netbus.py) picks the transport per peer pair — the reference's
pluggable NetworkStack stance (posix/RDMA/DPDK): backend selection is a
deployment knob, never a protocol change, and every backend consults the
same seeded NetFaultPolicy ``plan()`` stream sender-side so thrash
schedules replay identically across transports.

Design stance (vs src/msg/async/AsyncMessenger.h:74): one asyncio reactor
per process instead of N event-loop threads + a lock hierarchy — the
Crimson shared-nothing position (src/crimson/). Delivery per peer pair is
in-order; the bus/TCP stream guarantees it the same way a lossless
msgr2 connection does (the shm ring is SPSC, so slot order is delivery
order). Failed sends surface to the caller — like the reference's lossy
client policy, retry/resend is an upper-layer concern (Objecter resends
on map change; mon marks unreachable OSDs down).

ceph_tpu_torch's own copy of ``ceph_tpu/msg/messenger.py``.
"""
from __future__ import annotations

import asyncio
import os
from typing import Awaitable, Callable

from ..utils import denc
from ..utils.buffer import BufferList
from .auth import AuthError
from .frames import (Frame, FrameError, IncompleteFrame, decode_frame,
                     encode_frame, encode_frame_bl)
from .messages import Message, decode_message

Dispatcher = Callable[[str, Message], Awaitable[None]]


class SendError(Exception):
    pass


#: message types LocalBus delivers by reference (see LocalBus
#: docstring): internal sub-op traffic, constructed fresh at every send
#: site and read-only on both sides. Resolved lazily to avoid an import
#: cycle with cluster.messages.
_ZERO_COPY_NAMES = (
    "MOSDRepOp", "MOSDRepOpReply", "MECSubWrite", "MECSubWriteReply",
    "MECSubRead", "MECSubReadReply", "MPushOp", "MPushReply", "MPull",
)
ZERO_COPY_TYPES: set[int] = set()


def _init_zero_copy() -> None:
    from ..cluster import messages as cm

    for name in _ZERO_COPY_NAMES:
        ZERO_COPY_TYPES.add(getattr(cm, name).TYPE)


class LocalBus:
    """In-process router for cluster-free tests (direct_messenger role).

    Client-facing messages are delivered as SNAPSHOT VIEWS
    (Message.snapshot): an isolated structural copy that shares payload
    storage — receivers never share mutable state with senders (the
    client RETAINS and mutates its MOSDOp for resends; the snapshot
    carries send-time field values), but a 4 MiB write body is passed
    by reference instead of paying an encode+decode per hop (the
    round-6 profile's top seam). Codec symmetry — every message class
    still round-tripping through its wire form — is no longer
    exercised for free on each send, so it became an OPT-IN check:
    arming ``verify_codec_symmetry`` re-encodes every snapshot
    delivery and fails the send on any encode/decode/snapshot
    disagreement; the thrasher arms it for the whole thrash
    (cluster/faults.py), so the stance change stays validated under
    faults. ``CEPH_TPU_BUS_SNAPSHOT=0`` restores the legacy
    marshal-per-hop path (the bench A/B lever).

    The frame layer (length prefix + CRC) is skipped for all local
    sends: framing guards a byte STREAM, which does not exist
    in-process. Internal sub-op traffic (EC shard writes/reads,
    replication sub-ops, recovery pushes — ZERO_COPY_TYPES) is
    delivered BY REFERENCE: those messages are constructed at the send
    site, never retained or mutated by either side, and carry the data
    path's big payloads — marshalling them in-process burned ~1/3 of
    the single-core write path in round-5 profiles (the Crimson
    pass-the-object-not-the-bytes position; src/crimson/ shared-nothing
    futures hand objects between stages the same way). The wire tiers
    (TcpMessenger, NetBus) marshal everything, always.
    """

    #: drop-record retention: under a long thrash a partition drops
    #: thousands of messages (each holding live payload objects) — the
    #: record is a debugging aid, not a ledger, so it stays bounded
    MAX_DROPPED = 512

    def __init__(self, faults=None) -> None:
        self.entities: dict[str, Dispatcher] = {}
        self.dropped: list[tuple[str, str, Message]] = []
        # the fault policy (cluster/faults.NetFaultPolicy): every send
        # consults it for drop/partition/delay/duplicate. The old
        # ad-hoc blackhole set lives INSIDE the policy now; the
        # `blackholes` property below keeps the historical test verb
        # (blackhole_kill_osd analog, qa/tasks/ceph_manager.py:537).
        if faults is None:
            from ..cluster.faults import NetFaultPolicy

            faults = NetFaultPolicy()
        self.faults = faults
        self._tasks: set[asyncio.Task] = set()
        # corked delivery: sends enqueue per-destination and ONE drain
        # callback per burst hands every queued message to its handler
        # (task creation batched per burst, per-pair FIFO preserved).
        # The counters are the in-process analog of the wire tier's
        # frames-per-drain occupancy.
        self._sendq: dict[str, list] = {}
        self._drain_scheduled: set[str] = set()
        self.frames_delivered = 0
        self.delivery_bursts = 0
        # buffer-plane delivery mode: snapshot views by default, the
        # legacy encode+decode per hop behind the env lever (bench A/B)
        self.snapshot_delivery = (
            os.environ.get("CEPH_TPU_BUS_SNAPSHOT", "1") != "0")
        #: opt-in codec-symmetry re-encode check (armed by the
        #: thrasher): every snapshot delivery also round-trips through
        #: the wire codec and must agree with itself and the snapshot
        self.verify_codec_symmetry = False
        self.zero_copy_sends = 0      # snapshot deliveries (no marshal)
        self.codec_symmetry_checks = 0

    def _snapshot_delivery(self, msg: Message) -> Message:
        """One client-facing delivery copy: a snapshot view, with the
        opt-in re-encode check when armed."""
        if not self.snapshot_delivery:
            return decode_message(msg.TYPE, msg.encode())
        snap = msg.snapshot()
        self.zero_copy_sends += 1
        if self.verify_codec_symmetry:
            self.codec_symmetry_checks += 1
            enc = msg.encode()
            if bytes(msg.encode_bl()) != enc:
                raise FrameError(
                    f"{type(msg).__name__}: encode_bl() disagrees "
                    "with encode()")
            dec = decode_message(msg.TYPE, enc)
            if dec != snap:
                raise FrameError(
                    f"{type(msg).__name__}: wire round-trip disagrees "
                    "with snapshot view")
            if dec.encode() != enc:
                raise FrameError(
                    f"{type(msg).__name__}: re-encode of decoded "
                    "message is not byte-identical")
        return snap

    @property
    def frames_per_drain(self) -> float:
        """Mean messages handed over per delivery burst."""
        if not self.delivery_bursts:
            return 0.0
        return self.frames_delivered / self.delivery_bursts

    @property
    def blackholes(self) -> set[str]:
        return self.faults.blackholes

    def register(self, name: str, dispatcher: Dispatcher) -> None:
        self.entities[name] = dispatcher

    def unregister(self, name: str) -> None:
        self.entities.pop(name, None)
        self.faults.blackholes.discard(name)

    async def send(self, src: str, dst: str, msg: Message) -> None:
        if not ZERO_COPY_TYPES:
            _init_zero_copy()
        if msg.TYPE in ZERO_COPY_TYPES:
            decoded = msg
        else:
            decoded = self._snapshot_delivery(msg)
        sender = src
        plan = self.faults.plan(src, dst)
        if plan is None:
            self.dropped.append((src, dst, decoded))
            if len(self.dropped) > self.MAX_DROPPED:
                del self.dropped[: -self.MAX_DROPPED]
            return
        handler = self.entities.get(dst)
        if handler is None:
            raise SendError(f"no such entity {dst!r}")
        # deliver via the per-destination cork, never inline: senders
        # never re-enter their own state under a peer's stack frame
        # (the reference's fast_dispatch re-entrancy rules exist to
        # manage exactly that)
        for i, delay in enumerate(plan):
            if i and msg.TYPE not in ZERO_COPY_TYPES:
                # duplicates get their own snapshot: two deliveries
                # must never share one mutable message object
                decoded = self._snapshot_delivery(msg)
            if delay > 0:
                # injected latency/reorder bypasses the cork: per-pair
                # FIFO is intentionally broken — that is the fault
                task = asyncio.get_running_loop().create_task(
                    self._deliver_later(delay, handler, sender, decoded))
                self._tasks.add(task)
                task.add_done_callback(self._tasks.discard)
                continue
            self._sendq.setdefault(dst, []).append(
                (handler, sender, decoded))
            if dst not in self._drain_scheduled:
                self._drain_scheduled.add(dst)
                asyncio.get_running_loop().call_soon(
                    self._drain_dst, dst)

    def _drain_dst(self, dst: str) -> None:
        """One delivery burst: every message queued for ``dst`` since
        the last burst gets its handler task, in enqueue order."""
        self._drain_scheduled.discard(dst)
        items = self._sendq.pop(dst, None)
        if not items:
            return
        self.delivery_bursts += 1
        self.frames_delivered += len(items)
        loop = asyncio.get_running_loop()
        for handler, sender, decoded in items:
            task = loop.create_task(handler(sender, decoded))
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)

    @staticmethod
    async def _deliver_later(delay: float, handler: Dispatcher,
                             sender: str, decoded: Message) -> None:
        # injected latency/reorder: per-pair FIFO is intentionally
        # broken here — that is the fault being modeled
        await asyncio.sleep(delay)
        await handler(sender, decoded)

    async def drain(self) -> None:
        """Wait until every in-flight delivery (and what it spawned) ran."""
        while self._tasks or self._sendq:
            if self._tasks:
                await asyncio.gather(*list(self._tasks),
                                     return_exceptions=False)
            # yield so a scheduled _drain_dst can hand queued messages
            # to their handler tasks before the next sweep
            await asyncio.sleep(0)


class TcpMessenger:
    """Asyncio TCP messenger (PosixStack role), one per entity.

    Peers are located through an address book {entity: (host, port)} —
    the role the reference's maps' addrvecs play. Outgoing connections
    are cached and re-dialed on failure.

    With ``keys`` set (a KeyServer holding this entity's secret and the
    peers'), connections run the cephx-role handshake (msg/auth.py) and
    every subsequent frame carries an HMAC tag (msgr2 signed mode);
    with ``secure=True`` frames are instead AES-GCM encrypted under the
    session key with counter nonces (msgr2 secure mode / crypto_onwire
    role — an acceptor configured secure rejects plain-signed peers).
    Unauthenticated peers and tampered/replayed frames are rejected.

    ``compress_threshold`` enables on-wire compression
    (compression_onwire role): payloads at or above the threshold are
    zlib-deflated when that actually shrinks them, flagged per frame.
    """

    AUTH_HELLO = 0xFF01
    AUTH_CHALLENGE = 0xFF02
    AUTH_PROOF = 0xFF03
    AUTH_OK = 0xFF04
    FLAG_COMPRESSED = 0x1

    def __init__(self, name: str, dispatcher: Dispatcher, keys=None,
                 secure: bool = False,
                 compress_threshold: int | None = None, faults=None):
        self.name = name
        self.dispatcher = dispatcher
        #: optional NetFaultPolicy (cluster/faults.py): outgoing sends
        #: honor drop/partition/delay/duplicate exactly like LocalBus —
        #: the same policy object drives both tiers, so a thrash
        #: scenario scripted against the in-process bus replays
        #: unchanged over real sockets
        self.faults = faults
        self.keys = keys  # KeyServer | None
        self.secure = secure
        if secure and keys is None:
            raise ValueError("secure mode needs a KeyServer")
        self.compress_threshold = compress_threshold
        self.addrbook: dict[str, tuple[str, int]] = {}
        self._conns: dict[str, tuple] = {}  # dst -> (writer, auth, sess)
        self._server: asyncio.AbstractServer | None = None
        self._readers: set[asyncio.Task] = set()
        self._bg: set[asyncio.Task] = set()  # delayed fault deliveries
        # corked send path: per-destination frame queue + one writer
        # task that coalesces every queued frame into a single
        # write/drain burst (see _writer_loop)
        self._sendq: dict[str, list] = {}
        self._q_event: dict[str, asyncio.Event] = {}
        self._writers: dict[str, asyncio.Task] = {}
        #: cork occupancy: total frames written / drain barriers paid —
        #: the frames_per_drain evidence bench and tests read
        self.frames_sent = 0
        self.drains = 0

    @property
    def frames_per_drain(self) -> float:
        """Mean frames flushed per writer.drain() barrier."""
        if not self.drains:
            return 0.0
        return self.frames_sent / self.drains

    async def listen(self, host: str = "127.0.0.1", port: int = 0) -> tuple[str, int]:
        self._server = await asyncio.start_server(self._accept, host, port)
        addr = self._server.sockets[0].getsockname()[:2]
        return addr

    async def close(self) -> None:
        # order matters on py3.12+: Server.wait_closed() waits for the
        # active connection handlers, so readers must be cancelled and
        # drained FIRST or close deadlocks on any open connection
        if self._server:
            self._server.close()
        for t in list(self._bg):
            t.cancel()
        for t in self._writers.values():
            t.cancel()
        self._writers.clear()
        for items in self._sendq.values():
            for *_frame, fut in items:
                if not fut.done():
                    fut.set_exception(SendError("messenger closed"))
        self._sendq.clear()
        for w, *_rest in self._conns.values():
            w.close()
        self._conns.clear()
        readers = list(self._readers)
        for t in readers:
            t.cancel()
        if readers:
            await asyncio.gather(*readers, return_exceptions=True)
        if self._server:
            await self._server.wait_closed()

    async def _accept(self, reader, writer) -> None:
        task = asyncio.current_task()
        self._readers.add(task)
        try:
            auth, sess = None, None
            if self.keys is not None:
                auth, sess = await self._accept_handshake(reader, writer)
            if sess is not None:
                await self._read_loop_secure(reader, sess)
            else:
                await self._read_loop(reader, auth)
        except (asyncio.IncompleteReadError, ConnectionError,
                AuthError):
            pass
        finally:
            self._readers.discard(task)
            writer.close()

    async def _accept_handshake(self, reader, writer):
        """Acceptor side of the cephx-role handshake."""
        from .auth import Authenticator, SecureSession, handshake_accept

        hello = await self._read_one_frame(reader)
        if hello is None or hello.type != self.AUTH_HELLO:
            raise AuthError("expected AUTH_HELLO")
        challenge = Authenticator.make_challenge()
        writer.write(encode_frame(
            Frame(self.AUTH_CHALLENGE, challenge)
        ))
        await writer.drain()
        proof = await self._read_one_frame(reader)
        if proof is None or proof.type != self.AUTH_PROOF:
            raise AuthError("expected AUTH_PROOF")
        session = handshake_accept(self.keys, hello.payload, challenge,
                                   proof.payload)
        entity, _nonce, mode = Authenticator.parse_hello(hello.payload)
        if self.secure and mode != "secure":
            # policy: a secure acceptor refuses plain-signed peers
            raise AuthError(f"{entity!r} did not offer secure mode")
        auth = Authenticator(entity, b"")
        auth.session_key = session
        writer.write(encode_frame(Frame(self.AUTH_OK, b"")))
        await writer.drain()
        sess = (SecureSession(session, "acceptor")
                if mode == "secure" else None)
        return auth, sess

    @staticmethod
    async def _read_one_frame(reader) -> Frame | None:
        buf = b""
        while True:
            try:
                frame, used = decode_frame(buf)
                return frame
            except IncompleteFrame as need:
                chunk = await reader.read(
                    max(need.needed - len(buf), 4096)
                )
                if not chunk:
                    return None
                buf += chunk

    async def _read_loop(self, reader: asyncio.StreamReader,
                         auth=None) -> None:
        buf = b""
        while True:
            try:
                frame, used = decode_frame(buf)
            except IncompleteFrame as need:
                want = need.needed + (16 if auth else 0)
                chunk = await reader.read(max(want - len(buf), 4096))
                if not chunk:
                    return
                buf += chunk
                continue
            except FrameError:
                raise ConnectionError("corrupt frame")
            if auth is not None:
                # signed mode: 16-byte HMAC trails every frame
                while len(buf) < used + 16:
                    chunk = await reader.read(4096)
                    if not chunk:
                        return
                    buf += chunk
                auth.check(bytes(buf[:used]), bytes(buf[used:used + 16]))
                used += 16
            buf = buf[used:]
            await self._dispatch_frame(frame)

    async def _read_loop_secure(self, reader: asyncio.StreamReader,
                                sess) -> None:
        """Secure mode: u32-length-prefixed AES-GCM records, each
        holding one ordinary CRC frame."""
        import struct

        while True:
            try:
                hdr = await reader.readexactly(4)
                (ln,) = struct.unpack("<I", hdr)
                ct = await reader.readexactly(ln)
            except asyncio.IncompleteReadError:
                return  # clean EOF mid-record: peer went away
            record = sess.decrypt(ct)  # AuthError on tamper/replay
            try:
                frame, _used = decode_frame(record)
            except FrameError:
                raise ConnectionError("corrupt frame inside record")
            await self._dispatch_frame(frame)

    #: inflate cap: no hostile frame may expand past this, however well
    #: it deflates (decompression-bomb guard)
    MAX_INFLATE = 64 << 20

    async def _dispatch_frame(self, frame: Frame) -> None:
        payload = frame.payload
        if frame.flags & self.FLAG_COMPRESSED:
            import zlib

            try:
                d = zlib.decompressobj()
                payload = d.decompress(payload, self.MAX_INFLATE)
                if d.unconsumed_tail:
                    raise ConnectionError("compressed frame exceeds "
                                          "inflate cap")
            except zlib.error:
                raise ConnectionError("corrupt compressed frame")
        sender, off = denc.dec_str(payload, 0)
        msg = decode_message(frame.type, payload[off:])
        await self.dispatcher(sender, msg)

    async def _connect(self, dst: str):
        if dst not in self.addrbook:
            raise SendError(f"no address for {dst!r}")
        host, port = self.addrbook[dst]
        try:
            reader, writer = await asyncio.open_connection(host, port)
        except OSError as e:
            raise SendError(f"connect to {dst} failed: {e}") from e
        auth, sess = None, None
        if self.keys is not None:
            from .auth import Authenticator, SecureSession

            secret = self.keys.get(self.name)
            if secret is None:
                raise SendError(f"no secret for {self.name!r}")
            auth = Authenticator(self.name, secret)
            mode = "secure" if self.secure else "sign"
            hello, nonce = auth.make_hello(mode)
            writer.write(encode_frame(Frame(self.AUTH_HELLO, hello)))
            await writer.drain()
            challenge = await self._read_one_frame(reader)
            if challenge is None or challenge.type != self.AUTH_CHALLENGE:
                writer.close()
                raise SendError("auth: no challenge")
            writer.write(encode_frame(
                Frame(self.AUTH_PROOF,
                      auth.prove(challenge.payload, nonce))
            ))
            await writer.drain()
            ok = await self._read_one_frame(reader)
            if ok is None or ok.type != self.AUTH_OK:
                writer.close()
                raise SendError("auth rejected")
            auth.derive_session(secret, challenge.payload, nonce)
            if self.secure:
                sess = SecureSession(auth.session_key, "connector")
        return writer, auth, sess

    async def send(self, dst: str, msg: Message) -> None:
        copies = 1
        if self.faults is not None:
            plan = self.faults.plan(self.name, dst)
            if plan is None:
                return  # dropped on the wire: writes into the void
            # wire tier applies injected latency sender-side (one
            # stream, in-order per pair), but NEVER by stalling the
            # caller — a delay fault models the link, not the sender's
            # whole pipeline. Delayed deliveries ride a background
            # task (send errors there have no caller to surface to).
            delay = max(plan)
            copies = len(plan)
            if delay > 0:
                # snapshot NOW: the sender may retain and mutate the
                # message (the client's MOSDOp resend path) — the
                # delayed copy must carry send-time state, like
                # LocalBus's snapshot-at-send does
                snap = msg.snapshot()
                task = asyncio.get_running_loop().create_task(
                    self._send_delayed(dst, snap, delay, copies))
                self._bg.add(task)
                task.add_done_callback(self._bg.discard)
                return
        await self._send_now(dst, msg, copies)

    async def _send_delayed(self, dst: str, msg: Message, delay: float,
                            copies: int) -> None:
        await asyncio.sleep(delay)
        try:
            await self._send_now(dst, msg, copies)
        except SendError:
            pass  # the link was faulted anyway; nobody to tell

    async def _send_now(self, dst: str, msg: Message,
                        copies: int = 1) -> None:
        """Enqueue one logical message on the destination's corked
        send queue and await its flush. The payload SNAPSHOTS here
        (the caller may retain and mutate the message — the client's
        MOSDOp resend path); signing/encryption happen in the writer
        task, in queue order, because both are stateful per
        connection. A connect/write failure of the burst carrying this
        message surfaces as SendError to exactly this caller."""
        payload = msg.encode_bl(BufferList(denc.enc_str(self.name)))
        flags = 0
        if (self.compress_threshold is not None
                and len(payload) >= self.compress_threshold):
            import zlib

            packed = zlib.compress(bytes(payload), 1)
            if len(packed) < len(payload):
                payload, flags = BufferList(packed), self.FLAG_COMPRESSED
        fut = asyncio.get_running_loop().create_future()
        self._sendq.setdefault(dst, []).append(
            (msg.TYPE, payload, flags, copies, fut))
        self._kick_writer(dst)
        await fut

    def _kick_writer(self, dst: str) -> None:
        evt = self._q_event.get(dst)
        if evt is None:
            evt = self._q_event[dst] = asyncio.Event()
        evt.set()
        task = self._writers.get(dst)
        if task is None or task.done():
            self._writers[dst] = asyncio.get_running_loop().create_task(
                self._writer_loop(dst))

    @staticmethod
    def _fail_burst(items: list, exc: Exception) -> None:
        for *_frame, fut in items:
            if not fut.done():
                fut.set_exception(exc)

    async def _writer_loop(self, dst: str) -> None:
        """Per-connection corked writer (the tcp_cork/MSG_MORE role):
        every frame queued since the last burst is encoded, signed or
        encrypted in order, written as ONE buffer and drained ONCE —
        a k+m fan-out that used to pay 11 serialized drains pays one.
        While the drain barrier of one burst is in flight, the next
        burst accumulates (the group-commit dynamic: load deepens
        batches by itself)."""
        evt = self._q_event[dst]
        items: list = []
        try:
            await self._writer_bursts(dst, evt, items)
        finally:
            # cancellation (close, daemon stop) mid-burst: the popped
            # items' senders must not hang on futures nobody resolves
            self._fail_burst(items, SendError("messenger closed"))

    async def _writer_bursts(self, dst: str, evt: asyncio.Event,
                             items: list) -> None:
        while True:
            del items[:]
            if not self._sendq.get(dst):
                evt.clear()
                await evt.wait()
            items.extend(self._sendq.pop(dst, ()) or ())
            if not items:
                continue
            conn = self._conns.get(dst)
            if conn is None or conn[0].is_closing():
                try:
                    conn = await self._connect(dst)
                except asyncio.CancelledError:
                    raise  # _writer_loop's finally fails the burst
                except Exception as e:
                    # every message that queued up behind the dead
                    # address fails like its own connect attempt did
                    # (auth rejections included — the old per-send path
                    # surfaced those to the caller the same way)
                    self._fail_burst(
                        items, e if isinstance(e, SendError)
                        else SendError(f"connect to {dst} failed: {e}"))
                    continue
                self._conns[dst] = conn
            writer, auth, sess = conn
            parts: list = []
            nframes = 0
            for mtype, payload, flags, copies, _fut in items:
                # one frame build per logical message: payload segments
                # ride as views from enqueue to here, and the plain
                # path hands them to the socket join directly — the
                # ONLY whole-payload copy left is the kernel write.
                # Signed/secure modes need the flat frame (HMAC/GCM
                # consume one buffer); that flatten is their boundary.
                wire_bl = encode_frame_bl(Frame(mtype, payload, flags))
                nframes += copies
                for _copy in range(copies):
                    if sess is not None:
                        # secure mode: GCM supersedes HMAC; each copy
                        # gets its own counter nonce (a byte-identical
                        # replayed record would be rejected, rightly)
                        parts.append(sess.encrypt(bytes(wire_bl)))
                    elif auth is not None:
                        wire = bytes(wire_bl)
                        parts.append(wire)
                        parts.append(auth.sign(wire))
                    else:
                        parts.extend(wire_bl.segments())
            try:
                writer.write(b"".join(parts))
                await writer.drain()
            except (ConnectionError, OSError) as e:
                self._conns.pop(dst, None)
                self._fail_burst(items,
                                 SendError(f"send to {dst} failed: {e}"))
                continue
            self.frames_sent += nframes
            self.drains += 1
            for *_frame, fut in items:
                if not fut.done():
                    fut.set_result(None)
