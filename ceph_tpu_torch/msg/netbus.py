"""NetBus: the LocalBus contract over real TCP sockets, for daemons
running as separate OS processes (the AsyncMessenger + entity-addressing
role, src/msg/async/AsyncMessenger.h:74 + src/msg/Messenger.h).

One NetBus per process. It owns ONE TcpMessenger (one listening socket);
every entity the process hosts (``register``) is published in a shared
file-based **address book** directory — one file per entity name holding
``host port`` (the monmap/osdmap addrvec role: how peers find each
other). Cross-process sends wrap the message in an MEnvelope carrying
the entity-level src/dst and ride the messenger's CRC-framed (and, with
``keys``, cephx-authenticated / AES-GCM secure) connections.

Contract parity with LocalBus (msg/messenger.py):
- ``register(name, dispatcher)`` / ``unregister(name)`` — entities come
  and go at runtime; the public ``"mon"`` alias moves between paxos
  leaders by exactly this mechanism, so book entries are written and
  removed ownership-checked.
- ``await send(src, dst, msg)`` — raises SendError when the destination
  is not in the book or its process is unreachable (the caller-retry
  stance: MonClient hunting and Objecter resend handle it).
- ``entities`` — the local handler table (paxos' alias-ownership check
  reads it).

kill -9 of a process leaves its book entries behind; senders then get
connection-refused -> SendError, indistinguishable from a LocalBus
send to a dead entity — which is the behavior the cluster layer is
built against.

``backend="shm"`` swaps same-host transport for the shared-memory
ring messenger (msg/shmring.py): payload segments are gathered once
into a shared arena instead of flattening into a kernel socket, with
a unix-socket doorbell per burst. The book entry then reads
``shm <sock> <host> <port>`` so tcp-backend peers still interoperate
via the host/port half. Entity-envelope signatures (_env_sig) are
backend-independent.

ceph_tpu_torch's own copy of ``ceph_tpu/msg/netbus.py``, with one
repair: every send reads its destination's book entry. The reference
cached an address until a send to it failed, but a send to a process
that has since dropped the ``mon`` alias succeeds and is discarded
there, so a client whose cache went stale in an election sent every
mon op to a peon until it timed out (ROADMAP §3).
"""
from __future__ import annotations

import asyncio
import os
from typing import Awaitable, Callable

from ..cluster.messages import MEnvelope
from .auth import _mac
from .messages import decode_message
from .messenger import SendError, TcpMessenger

Dispatcher = Callable[[str, object], Awaitable[None]]


def _env_sig(key: bytes, src: str, dst: str, mtype: int,
             payload: bytes) -> bytes:
    """Entity-origin envelope signature (truncated HMAC-SHA256). Binds
    the claimed src ENTITY to its keyring secret over the full routed
    content; replay is the message layer's concern (tids/epochs — and
    secure mode's per-record nonces on the wire)."""
    return _mac(key, src.encode(), dst.encode(),
                mtype.to_bytes(4, "little"), payload)[:16]


class NetBus:
    def __init__(self, book_dir: str, keys=None, secure: bool = False,
                 host: str = "127.0.0.1", backend: str = "tcp"):
        if backend not in ("tcp", "shm"):
            raise ValueError(f"unknown NetBus backend {backend!r}")
        self.book_dir = book_dir
        os.makedirs(book_dir, exist_ok=True)
        self.host = host
        self.backend = backend
        self.entities: dict[str, Dispatcher] = {}
        #: LocalBus test-hook parity; process-level tests use signals
        #: instead, so this only gates outgoing sends
        self.blackholes: set[str] = set()
        # one shared node identity: the cephx handshake authenticates
        # the PROCESS link; entity-level identity rides the envelope
        # and is SIGNED per entity (see _env_sig) — a process that
        # only holds the node key cannot claim to be "mon" or osd.N.
        # A fixed name lets every node share one keyring entry.
        self._node = "node"
        self._keys = keys
        self._tcp = TcpMessenger(self._node, self._dispatch, keys=keys,
                                 secure=secure)
        # backend="shm": same-host peers ride the shared-memory ring
        # messenger (msg/shmring.py); TCP stays up as the interop
        # fallback (a tcp-backend peer resolves our book entry to its
        # host/port half), and the per-entity envelope signatures keep
        # working unchanged — shm skips only the LINK-level cephx
        # handshake, which guards a byte stream that no longer exists.
        self._shm = None
        if backend == "shm":
            from .shmring import ShmMessenger

            self._shm = ShmMessenger(self._node, self._dispatch)
        self._addr: tuple[str, int] | None = None
        self._shm_path: str | None = None
        self._tasks: set[asyncio.Task] = set()
        #: entity -> (book entry, its parsed address): the parse is
        #: reused while the entry reads the same. The entry itself is
        #: read on every send: peers re-listen on new ports/sockets
        #: after restart, and the "mon" alias moves between LIVE
        #: processes, where a send to the old holder succeeds and is
        #: dropped, so no send failure would ever refresh it
        self._cache: dict[str, tuple] = {}

    # ----------------------------------------------------------- lifecycle

    async def start(self) -> None:
        if self._addr is None:
            self._addr = await self._tcp.listen(self.host, 0)
        if self._shm is not None and self._shm_path is None:
            # short path outside the book dir: AF_UNIX paths cap at
            # ~108 bytes and pytest tmp book dirs routinely blow that
            self._shm_path = await self._shm.listen(
                f"/tmp/ctpu-shm-{os.getpid()}-{id(self) & 0xFFFFFF:x}"
                ".sock")

    async def close(self) -> None:
        for name in list(self.entities):
            self.unregister(name)
        await self._tcp.close()
        if self._shm is not None:
            await self._shm.close()
        for t in list(self._tasks):
            t.cancel()

    # ----------------------------------------------------- entity registry

    def _book_path(self, name: str) -> str:
        # entity names are shell-safe ("osd.3", "client.0", "mon")
        return os.path.join(self.book_dir, name)

    def _book_entry(self) -> str:
        """This bus's published address line. TCP backend: ``host
        port`` (the historical form). shm backend: ``shm <sock> <host>
        <port>`` — shm-capable peers dial the doorbell socket, plain
        TCP peers use the host/port half (mixed-backend interop)."""
        assert self._addr is not None, "NetBus.start() first"
        if self._shm_path is not None:
            return (f"shm {self._shm_path} "
                    f"{self._addr[0]} {self._addr[1]}")
        return f"{self._addr[0]} {self._addr[1]}"

    def _publish(self, name: str) -> None:
        tmp = self._book_path(name) + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(self._book_entry() + "\n")
        os.replace(tmp, self._book_path(name))  # atomic vs readers

    def register(self, name: str, dispatcher: Dispatcher) -> None:
        self.entities[name] = dispatcher
        self._publish(name)

    def unregister(self, name: str) -> None:
        self.entities.pop(name, None)
        self.blackholes.discard(name)
        # Ownership-checked removal must be ATOMIC across processes: a
        # read-then-unlink lets a deposed mon leader read its own stale
        # entry, lose the race to the new leader's republish, and unlink
        # the NEW leader's entry. Claim the entry with an atomic rename
        # first; only the process that won the rename inspects it, and a
        # claim that turns out to be someone else's is restored verbatim
        # (same name, same content — republishing is idempotent).
        path = self._book_path(name)
        claim = path + f".retire.{os.getpid()}"
        try:
            os.rename(path, claim)
        except OSError:
            return  # already removed (or never published)
        try:
            with open(claim) as f:
                ours = f.read().strip() == self._book_entry()
        except (OSError, ValueError):
            ours = False
        if ours:
            try:
                os.unlink(claim)
            except OSError:
                pass
        else:
            # we yanked a newer owner's entry: put it back — via link,
            # which creates ONLY if nobody republished during the claim
            # window (os.replace would clobber an even-newer owner's
            # fresh entry with the stale one we hold). A crash between
            # rename and this restore loses the entry briefly; senders
            # self-heal through the ranked mon.N hunt.
            try:
                os.link(claim, path)
            except OSError:
                pass  # FileExistsError: a fresh entry won; keep it
            try:
                os.unlink(claim)
            except OSError:
                pass

    def _resolve(self, name: str) -> tuple:
        """-> (host, port): the TCP half of the book entry. Every
        backend publishes one (the shm form carries host/port after
        the doorbell socket), so this contract survives backend
        selection — callers that dial raw TCP keep working."""
        ep = self._resolve_ep(name)
        return ep[-2], ep[-1]

    def _resolve_ep(self, name: str) -> tuple:
        """-> ("tcp", host, port) or ("shm", sock_path, host, port)."""
        try:
            with open(self._book_path(name)) as f:
                entry = f.read()
        except OSError:
            raise SendError(f"no such entity {name!r}") from None
        cached = self._cache.get(name)
        if cached is not None and cached[0] == entry:
            return cached[1]
        try:
            tok = entry.split()
            if tok and tok[0] == "shm":
                addr = ("shm", tok[1], tok[2], int(tok[3]))
            else:
                host, port = tok
                addr = ("tcp", host, int(port))
        except (OSError, ValueError, IndexError):
            raise SendError(f"no such entity {name!r}") from None
        self._cache[name] = (entry, addr)
        return addr

    # ------------------------------------------------------------ transport

    async def send(self, src: str, dst: str, msg) -> None:
        if dst in self.blackholes or src in self.blackholes:
            return
        payload = msg.encode()
        sig = b""
        if self._keys is not None:
            key = self._keys.get(src)
            if key is None:
                raise SendError(
                    f"no key for entity {src!r}: cannot sign envelope")
            sig = _env_sig(key, src, dst, msg.TYPE, payload)
        env = MEnvelope(src=src, dst=dst, mtype=msg.TYPE,
                        payload=payload, sig=sig)
        local = self.entities.get(dst)
        if local is not None:
            # same-process delivery: scheduled, never inline (the
            # LocalBus re-entrancy stance)
            task = asyncio.get_running_loop().create_task(
                local(src, decode_message(msg.TYPE, env.payload)))
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)
            return
        addr = self._resolve_ep(dst)
        try:
            await self._send_addr(addr, env)
        except SendError:
            self._cache.pop(dst, None)  # stale book/port: re-resolve once
            addr = self._resolve_ep(dst)
            try:
                await self._send_addr(addr, env)
            except SendError:
                self._cache.pop(dst, None)
                raise

    async def _send_addr(self, addr: tuple, env) -> None:
        """Route one envelope by parsed book address: the shm doorbell
        socket when BOTH sides speak shm, the TCP half otherwise."""
        if addr[0] == "shm" and self._shm is not None:
            await self._shm.send(addr[1], env)
            return
        host, port = addr[-2:]
        node = f"@{host}:{port}"
        self._tcp.addrbook[node] = (host, port)
        await self._tcp.send(node, env)

    async def _dispatch(self, _node_src: str, env) -> None:
        if not isinstance(env, MEnvelope):
            return  # stray non-envelope frame: drop
        if self._keys is not None:
            # per-entity origin check (CephxProtocol authorizer role):
            # the connection is node-authenticated, but the src ENTITY
            # must prove itself with its own key — otherwise any
            # process on the node keyring could impersonate the mon
            import hmac as _hmac

            key = self._keys.get(env.src)
            if key is None or not _hmac.compare_digest(
                env.sig,
                _env_sig(key, env.src, env.dst, env.mtype, env.payload),
            ):
                return  # unsigned/forged origin: drop
        handler = self.entities.get(env.dst)
        if handler is None:
            return  # entity moved/died after the sender resolved it
        msg = decode_message(env.mtype, env.payload)
        # scheduled, NEVER inline (the LocalBus re-entrancy stance,
        # same as local delivery above): an inline await would run the
        # handler inside this connection's read loop — a handler that
        # awaits a reply from the same peer (cap recall inside a
        # rename, MDS peer requests) then deadlocks against its own
        # unread inbound frames until its timeout fires
        task = asyncio.get_running_loop().create_task(
            handler(env.src, msg))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)

    async def drain(self) -> None:
        """Local-delivery drain (LocalBus parity; cross-process traffic
        cannot be awaited from here)."""
        while self._tasks:
            await asyncio.gather(*list(self._tasks),
                                 return_exceptions=True)
            await asyncio.sleep(0)
