"""MDSLite: the CephFS metadata DAEMON (src/mds role).

The library `services/fs.py` is client-driven — two
clients get no coherence and it has no crash story for multi-object
metadata ops. This module promotes it to the reference's shape:

- **One metadata authority.** ``mds.0`` owns every metadata mutation
  (the Server.cc request path): clients send MClientRequest over the
  bus; the daemon executes against the metadata pool through its own
  RADOS client. Single-daemon serialization is what makes two clients'
  mkdir/rename/create race-free.
- **Metadata journal (MDLog role).** Multi-object mutations (rename
  touches two dirfrag omaps; create touches the ino counter and a
  dirfrag; rmdir a dirfrag and its parent) journal an intent record to
  a RADOS journal object BEFORE mutating, and advance the expire
  pointer after. A restarted MDS replays unexpired entries
  idempotently, so a crash between the two halves of a rename
  completes instead of losing the file (MDLog + EMetaBlob replay arc).
- **Capabilities (Locker.h:41 role).** File write caps are exclusive:
  a client holding ``w`` on an ino may buffer its file size locally
  and write data objects directly (data path stays client->OSD, like
  CephFS). Any other client's stat/open of that ino makes the MDS
  revoke the cap (MCapRevoke); the holder flushes its buffered size in
  the release and drops to uncached. Unresponsive holders are evicted
  after a timeout (session-eviction role) so one dead client cannot
  wedge the namespace.

File DATA is striped client-side exactly as before (fsdata.<ino> via
the osdc striper); only metadata flows through the daemon.

**Multi-MDS.** Several ranks (``mds.0``, ``mds.1``, …)
partition the namespace by SUBTREE (the MDSMap subtree + MDBalancer
role): a durable RADOS table maps directory prefixes to ranks; each
rank serves only paths it owns and redirects the rest (ESTALE +
subtree map, the Server.cc forward role). Because dirfrags live in
shared RADOS omaps rather than per-MDS caches, exporting a subtree is
an authority HANDOVER — recall caps, flip one omap row — not the
reference's two-phase cache migration. Cross-subtree renames route
their link half through the destination authority as a peer request
(the slave-request role), and ``MDBalancer`` moves hot top-level
directories between ranks on decaying load counters.

ceph_tpu_torch's own copy of ``ceph_tpu/services/mds.py``. It takes no
device: the ``RadosClient`` it is given has resolved one.
"""
from __future__ import annotations

import asyncio
import time

from ..cluster import messages as M
from ..utils import denc
from . import fs as fslib

NOSIZE = 2**64 - 1

EXPIRE_KEY = b"expired_upto"
#: seq high-water persisted at trim time: once the journal body is
#: emptied, surviving entries can no longer tell a restarted MDS what
#: the last allocated seq was — without this header a restart would
#: reset _seq to 0 and journal new intents at seq <= expired_upto,
#: which a later crash replay silently skips
SEQ_BASE_KEY = b"seq_base"
JOURNAL_OID = b"mdslog"
JOURNAL_TRIM_BYTES = 1 << 20
SNAP_TABLE_OID = b"fsmeta.snaps"  # SnapServer table role
#: durable subtree-authority table (the MDSMap subtree/export_pin
#: role): omap path -> u32 rank. Rank 0 owns "/" implicitly. Because
#: every dirfrag lives in shared RADOS omaps — not in per-MDS caches —
#: "exporting" a subtree is an AUTHORITY handover (flip the row, recall
#: caps), not the reference's two-phase metadata migration
#: (src/mds/Migrator.cc): the heavyweight state transfer is designed
#: out by the storage model.
SUBTREE_OID = b"fsmeta.subtrees"


def _norm(path: str) -> str:
    return "/" + "/".join(x for x in path.split("/") if x)


def _deepest_rank(submap: dict[str, int], path: str) -> int:
    """Deepest subtree prefix owning ``path`` (MDSMap subtree
    resolution role) — shared by daemon and client."""
    p = _norm(path)
    best, rank = -1, 0
    for sub, r in submap.items():
        if _under(p, sub) and len(sub) > best:
            best, rank = len(sub), r
    return rank


def _snap_dir_oid(snapid: int, ino: int) -> bytes:
    """Snapshot copy of a dirfrag (past-parent dentries role): the
    subtree's metadata is frozen object-by-object at mksnap time; file
    DATA stays lazy-COW through the data pool's SnapContext."""
    return b"fssnap.%x.dir.%x" % (snapid, ino)


def _under(p: str, dir_path: str) -> bool:
    """Is path ``p`` inside directory ``dir_path``?"""
    dp = "/" + "/".join(x for x in dir_path.split("/") if x)
    pp = "/" + "/".join(x for x in p.split("/") if x)
    return dp == "/" or pp == dp or pp.startswith(dp + "/")


def _enc_entry(seq: int, verb: str, args: dict[str, bytes]) -> bytes:
    return (denc.enc_u64(seq) + denc.enc_str(verb)
            + denc.enc_map(args, denc.enc_str, denc.enc_bytes))


def _dec_entries(buf: bytes) -> list[tuple[int, str, dict]]:
    out = []
    off = 0
    while off < len(buf):
        seq, off = denc.dec_u64(buf, off)
        verb, off = denc.dec_str(buf, off)
        args, off = denc.dec_map(buf, off, denc.dec_str, denc.dec_bytes)
        out.append((seq, verb, args))
    return out


class MDSLite:
    """The metadata daemon (rank 0; ``name`` is its bus address)."""

    def __init__(self, bus, client, pool_id: int,
                 name: str = "mds.0", revoke_timeout: float = 2.0,
                 data_pool: int | None = None):
        self.bus = bus
        self.name = name
        try:
            self.rank = int(name.rsplit(".", 1)[1])
        except (IndexError, ValueError):
            self.rank = 0
        #: path -> owning rank; "/" is rank 0 unless exported
        self.subtrees: dict[str, int] = {"/": 0}
        #: subtrees a CLIENT pinned (ceph.dir.pin role): sticky — the
        #: balancer never moves them
        self.pins: set[str] = set()
        #: decaying per-top-level-dir request counters (MDBalancer
        #: load model role)
        self.load: dict[str, float] = {}
        self._peer_tid = 0
        self._peer_futs: dict[int, asyncio.Future] = {}
        self.fs = fslib.FSLite(client, pool_id, data_pool=data_pool)
        self.fs.snapc_cb = self._snapc
        self.client = client
        self.meta_pool = pool_id
        #: per-rank journal: ranks journal independently (one MDLog
        #: per rank, like the reference's per-rank journals)
        self.journal_oid = (JOURNAL_OID if self.rank == 0
                            else b"%s.%d" % (JOURNAL_OID, self.rank))
        #: where file DATA lives (snap ids are allocated against it)
        self.data_pool = pool_id if data_pool is None else data_pool
        self.revoke_timeout = revoke_timeout
        #: (dir ino, snap name) -> snap id (SnapServer table, loaded
        #: from SNAP_TABLE_OID at start)
        self.snaps: dict[tuple[int, str], int] = {}
        #: ino -> {client_name: "r" | "w"} (the Locker cap table)
        self.caps: dict[int, dict[str, str]] = {}
        self._revokes: dict[tuple[int, int], asyncio.Future] = {}
        self._tid = 0
        self._seq = 0
        self._jbytes = 0
        self._lock = asyncio.Lock()  # serializes journaled mutations
        #: quota caches (see _quota_check_files): parent dir ->
        #: (expiry, nearest realm), realm -> (expiry, entry count)
        self._realm_cache: dict[str, tuple[float, object]] = {}
        self._realm_count_cache: dict[str, tuple[float, int]] = {}
        #: ino -> path recorded at open/create (cap flush needs the
        #: dentry location)
        self._open_paths: dict[int, str] = {}
        #: test hook: crash (raise) after the first half of a rename
        self._crash_mid_rename = False

    # ---------------------------------------------------------- lifecycle

    async def start(self) -> None:
        self.bus.register(self.name, self.handle)
        await self._load_snap_table()
        await self._load_subtrees()
        await self._replay_journal()

    # --------------------------------------------------- subtree authority

    async def _load_subtrees(self) -> None:
        subtrees = {"/": 0}
        pins: set[str] = set()
        try:
            omap = await self.client.omap_get(self.meta_pool,
                                              SUBTREE_OID)
        except KeyError:
            omap = {}
        for k, v in omap.items():
            rank, off = denc.dec_u32(v, 0)
            subtrees[k.decode()] = rank
            if off < len(v) and denc.dec_u8(v, off)[0]:
                pins.add(k.decode())
        self.subtrees = subtrees
        self.pins = pins

    def auth_rank(self, path: str) -> int:
        return _deepest_rank(self.subtrees, path)

    def _enc_submap(self) -> bytes:
        return denc.enc_map(
            {k.encode(): denc.enc_u32(v)
             for k, v in self.subtrees.items()},
            denc.enc_bytes, denc.enc_bytes)

    #: wire value for "remove the pin/export row" (ceph.dir.pin -1)
    UNPIN = 0xFFFFFFFF

    async def export_dir(self, path: str, target: int,
                         pinned: bool = False) -> None:
        """Hand authority for directory ``path`` to ``target`` rank
        (the Migrator::export_dir role, reduced to cap recall + a
        durable map flip — see SUBTREE_OID note)."""
        async with self._lock:
            await self._export_locked(path, target, pinned)

    async def _export_locked(self, path: str, target: int,
                             pinned: bool = False) -> None:
        p = _norm(path)
        if p == "/":
            raise fslib.FSError("cannot export the root")
        if self.auth_rank(p) != self.rank:
            raise fslib.FSError(f"{p} not ours to export")
        ent = await self.fs.stat(p)
        if ent["type"] != fslib.T_DIR:
            raise fslib.FSError(f"{p} is not a directory")
        if target != self.rank and target != self.UNPIN:
            # the target rank must be ALIVE before the durable flip:
            # an export to a nonexistent rank blackholes the subtree
            # (every later op — the corrective re-pin included —
            # routes to nobody). peer_recall with a match-nothing
            # path doubles as the liveness ping.
            try:
                await self._peer_req(target, "peer_recall",
                                     {"path": b"/\x00none"})
            except Exception:
                # SendError (no such entity), timeout, anything: the
                # rank is not answering — refuse the flip
                raise fslib.FSError(
                    f"mds rank {target} unreachable: not exporting") \
                    from None
        # recall every write cap under the subtree (all ranks):
        # buffered sizes must land in dentries the new authority
        # will read
        await self._recall_subtree(p)
        args = {"path": p.encode(), "rank": denc.enc_u32(target)}
        if pinned:
            args["pin"] = denc.enc_u8(1)
        seq = await self._journal("export", args)
        await self._apply_export(p, target, pinned)
        await self._expire(seq)

    async def _apply_export(self, path: str, target: int,
                            pinned: bool = False) -> None:
        if target == self.UNPIN:
            # revert to the parent subtree's authority
            await self.client.omap_rm(self.meta_pool, SUBTREE_OID,
                                      [path.encode()])
            self.subtrees.pop(path, None)
            self.pins.discard(path)
            return
        await self.client.omap_set(
            self.meta_pool, SUBTREE_OID,
            {path.encode(): denc.enc_u32(target)
             + denc.enc_u8(1 if pinned else 0)})
        self.subtrees[path] = target
        if pinned:
            self.pins.add(path)
        else:
            self.pins.discard(path)

    # ------------------------------------------------------- peer requests

    async def _peer_req(self, rank: int, verb: str,
                        args: dict[str, bytes]) -> dict[str, bytes]:
        """Ask another rank to mutate a dirfrag IT owns (the
        Server.cc peer/slave-request role): the remote executes under
        its own mutation lock, so cross-subtree renames serialize
        against the destination authority's local ops."""
        self._peer_tid += 1
        tid = self._peer_tid
        fut = asyncio.get_running_loop().create_future()
        self._peer_futs[tid] = fut
        base = self.name.rsplit(".", 1)[0]
        try:
            await self.bus.send(
                self.name, f"{base}.{rank}",
                M.MClientRequest(tid=tid, verb=verb, args=args))
            try:
                reply = await asyncio.wait_for(fut,
                                               self.revoke_timeout * 4)
            except asyncio.TimeoutError:
                raise fslib.FSError(f"peer {verb} timeout") from None
        finally:
            self._peer_futs.pop(tid, None)
        if reply.result != 0:
            if reply.result == -17:
                raise fslib.Exists(verb)
            raise fslib.FSError(f"peer {verb} failed: {reply.result}")
        return reply.out

    async def _load_snap_table(self) -> None:
        try:
            omap = await self.client.omap_get(self.meta_pool,
                                              SNAP_TABLE_OID)
        except KeyError:
            return
        for k, v in omap.items():
            ino_hex, _, name = k.decode().partition("/")
            ino, off = denc.dec_u64(v, 0)
            sid, _ = denc.dec_u64(v, off)
            self.snaps[(ino, name)] = sid

    def _snapc(self) -> tuple[int, list[int]]:
        """The data pool's current write SnapContext: every snap id
        ever taken, newest first (filters through the pool's removed
        set OSD-side)."""
        ids = sorted(self.snaps.values(), reverse=True)
        return (ids[0] if ids else 0, ids)

    async def stop(self) -> None:
        self.bus.unregister(self.name)

    # ------------------------------------------------------------ journal

    async def _journal(self, verb: str, args: dict[str, bytes]) -> int:
        """Append an intent record (EMetaBlob role) BEFORE mutating."""
        self._seq += 1
        rec = _enc_entry(self._seq, verb, args)
        await self.client.append(self.meta_pool, self.journal_oid, rec)
        self._jbytes += len(rec)
        return self._seq

    async def _expire(self, seq: int) -> None:
        """All entries <= seq are fully applied (MDLog expire role)."""
        await self.client.omap_set(
            self.meta_pool, self.journal_oid,
            {EXPIRE_KEY: denc.enc_u64(seq)})
        if self._jbytes > JOURNAL_TRIM_BYTES:
            # opportunistic trim: everything up to self._seq is expired
            # (mutations are single-flight under _lock)
            await self._trim()

    async def _trim(self) -> None:
        """Empty the journal body (MDLog trim role), preserving the seq
        high-water in the omap header FIRST — so a crash on either side
        of the truncation leaves a journal whose replay allocates fresh
        seqs strictly above expired_upto."""
        await self.client.omap_set(
            self.meta_pool, self.journal_oid,
            {SEQ_BASE_KEY: denc.enc_u64(self._seq)})
        await self.client.write_full(self.meta_pool, self.journal_oid, b"")
        self._jbytes = 0

    async def _replay_journal(self) -> None:
        """Crash recovery: re-execute unexpired intents idempotently."""
        try:
            raw = await self.client.read(self.meta_pool, self.journal_oid)
        except KeyError:
            return
        try:
            omap = await self.client.omap_get(self.meta_pool, self.journal_oid)
            expired = denc.dec_u64(omap.get(EXPIRE_KEY,
                                            denc.enc_u64(0)), 0)[0]
            self._seq = denc.dec_u64(omap.get(SEQ_BASE_KEY,
                                              denc.enc_u64(0)), 0)[0]
        except KeyError:
            expired = 0
        self._jbytes = len(raw)
        entries = _dec_entries(raw)
        for seq, verb, args in entries:
            self._seq = max(self._seq, seq)
            if seq <= expired:
                continue
            try:
                await self._apply(verb, args)
            except fslib.FSError:
                pass  # already applied before the crash: idempotent
            await self._expire(seq)
        if len(raw) > JOURNAL_TRIM_BYTES:  # trim: journal fully expired
            await self._trim()

    # --------------------------------------------------------------- caps

    async def _revoke_conflicting(self, ino: int, requester: str,
                                  want: str) -> None:
        """Locker revoke arc: writes are exclusive; any access recalls
        other holders' write caps (their buffered size flushes here)."""
        holders = self.caps.get(ino, {})
        for holder, mode in list(holders.items()):
            if holder == requester:
                continue
            if mode != "w" and want != "w":
                continue  # shared reads coexist
            self._tid += 1
            tid = self._tid
            fut = asyncio.get_running_loop().create_future()
            self._revokes[(ino, tid)] = fut
            try:
                await self.bus.send(self.name, holder,
                                    M.MCapRevoke(ino=ino, tid=tid))
                rel = await asyncio.wait_for(fut, self.revoke_timeout)
                if rel.size != NOSIZE:
                    await self._apply_flushed_size(ino, rel.size)
            except asyncio.TimeoutError:
                pass  # eviction: drop the cap without a flush
            except Exception:
                import traceback

                traceback.print_exc()  # a real failure, not an eviction
            finally:
                self._revokes.pop((ino, tid), None)
                holders.pop(holder, None)

    async def _apply_flushed_size(self, ino: int, size: int) -> None:
        # locate the dentry by the path recorded at open/create time
        path = self._open_paths.get(ino)
        if path is None:
            return
        try:
            parent, name = await self.fs._resolve(path)
            cur = await self.fs._dentry(parent, name)
            if cur["ino"] != ino:
                return  # renamed-over; stale flush
            import time as _t

            await self.client.omap_set(
                self.meta_pool, fslib._dir_oid(parent),
                {name.encode(): fslib._enc_inode(
                    ino, fslib.T_FILE, size, _t.time())},
            )
        except fslib.FSError:
            pass

    # ------------------------------------------------------------ dispatch

    async def handle(self, src: str, msg) -> None:
        if isinstance(msg, M.MCapRelease):
            fut = self._revokes.get((msg.ino, msg.tid))
            if fut is not None and not fut.done():
                fut.set_result(msg)
            return
        if isinstance(msg, M.MClientReply):
            # a peer rank answering one of OUR peer requests
            fut = self._peer_futs.get(msg.tid)
            if fut is not None and not fut.done():
                fut.set_result(msg)
            return
        if not isinstance(msg, M.MClientRequest):
            return
        try:
            out = await self._serve(src, msg.verb, msg.args)
            # every reply carries the data pool's CURRENT SnapContext:
            # clients cache it for their direct data writes, so a
            # foreign mksnap propagates on the next metadata round trip
            # (cap recall at mksnap covers writers that never return)
            seq, ids = self._snapc()
            out["__snapc"] = denc.enc_u64(seq) + denc.enc_list(
                ids, denc.enc_u64)
            reply = M.MClientReply(tid=msg.tid, result=0, out=out)
        except _Redirect as r:
            # not our subtree: tell the client who owns it (the
            # forward/ESTALE dance of Server.cc handle_client_request)
            reply = M.MClientReply(
                tid=msg.tid, result=M.ESTALE,
                out={"submap": self._enc_submap(),
                     "rank": denc.enc_u32(r.rank)})
        except fslib.NoEnt:
            reply = M.MClientReply(tid=msg.tid, result=M.ENOENT, out={})
        except fslib.Exists:
            reply = M.MClientReply(tid=msg.tid, result=-17, out={})
        except fslib.NotEmpty:
            reply = M.MClientReply(tid=msg.tid, result=-39, out={})
        except fslib.QuotaExceeded:
            reply = M.MClientReply(tid=msg.tid, result=-122, out={})
        except fslib.FSError:
            reply = M.MClientReply(tid=msg.tid, result=-22, out={})
        except Exception:
            import traceback

            traceback.print_exc()
            reply = M.MClientReply(tid=msg.tid, result=M.EAGAIN, out={})
        await self.bus.send(self.name, src, reply)

    async def _serve(self, src: str, verb: str,
                     args: dict[str, bytes]) -> dict[str, bytes]:
        path = args.get("path", b"").decode()
        if verb == "getsubmap":
            await self._load_subtrees()
            return {"submap": self._enc_submap()}
        if verb in ("peer_link", "peer_unlink", "peer_recall"):
            base = self.name.rsplit(".", 1)[0] + "."
            if not src.startswith(base):
                raise fslib.FSError(f"peer op from non-MDS {src!r}")
            if verb == "peer_recall":
                # lock-FREE on purpose: the requester may hold its own
                # mutation lock (mksnap/rename recall) — taking ours
                # here would recreate the ABBA cycle
                p = args["path"].decode()
                for ino, op in list(self._open_paths.items()):
                    if _under(op, p):
                        await self._revoke_conflicting(ino, "__peer",
                                                       "w")
                return {}
            async with self._lock:
                return await self._serve_peer(verb, args)
        if "path" in args:
            # subtree authority gate: serve only what we own; refresh
            # once on a miss (a just-imported subtree reaches us before
            # any map push), then redirect the client
            r = self.auth_rank(path)
            if r != self.rank:
                await self._load_subtrees()
                r = self.auth_rank(path)
            if r != self.rank:
                raise _Redirect(r)
            parts = [x for x in path.split("/") if x]
            if parts:  # decaying per-top-dir load (MDBalancer model)
                top = "/" + parts[0]
                self.load[top] = self.load.get(top, 0.0) + 1.0
        if verb in ("stat", "lookup"):
            ent = await self.fs.stat(path)
            if ent["type"] == fslib.T_FILE:
                await self._revoke_conflicting(ent["ino"], src, "r")
                ent = await self.fs.stat(path)  # size after flush
            return _enc_ent(ent)
        if verb == "listdir":
            names = await self.fs.listdir(path)
            return {"names": denc.enc_list(
                [n.encode() for n in names], denc.enc_bytes)}
        if verb == "open":
            # under the mutation lock: a cap grant + SnapContext issued
            # mid-mksnap (whose recall loop awaits releases while
            # holding the lock) would let the opener write head objects
            # with a PRE-snap snapc — no clone, corrupt snapshot
            async with self._lock:
                mode = args["mode"].decode()
                ent = await self.fs.stat(path)
                if ent["type"] != fslib.T_FILE:
                    raise fslib.FSError(path)
                ino = ent["ino"]
                await self._revoke_conflicting(ino, src, mode)
                # re-stat AFTER the revoke: the previous holder's
                # flushed size must seed the opener's cap
                ent = await self.fs.stat(path)
                self.caps.setdefault(ino, {})[src] = mode
                self._open_paths[ino] = path
                return _enc_ent(ent)
        if verb == "close":
            ino = denc.dec_u64(args["ino"], 0)[0]
            size = denc.dec_u64(args.get("size",
                                         denc.enc_u64(NOSIZE)), 0)[0]
            if size != NOSIZE:
                await self._apply_flushed_size(ino, size)
            self.caps.get(ino, {}).pop(src, None)
            return {}
        if verb == "setsize":
            ino = denc.dec_u64(args["ino"], 0)[0]
            size = denc.dec_u64(args["size"], 0)[0]
            await self._apply_flushed_size(ino, size)
            return {}
        if verb == "lssnap":
            ino = await self.fs._walk(self.fs._split(path))
            names = sorted(n for (i, n) in self.snaps if i == ino)
            return {"names": denc.enc_list(
                [n.encode() for n in names], denc.enc_bytes)}
        if verb in ("snapstat", "snaplist"):
            return await self._serve_snap_read(verb, args, path)
        if verb == "getquota":
            # nearest quota realm + its current usage (the client
            # enforces max_bytes on its own writes with this — the
            # Client::check_quota_condition role)
            realm = await self.fs.nearest_quota(path)
            if realm is None:
                return {"realm": b""}
            rpath, q = realm
            rb, rf, rd = await self.fs.subtree_stats(rpath)
            return {"realm": rpath.encode(),
                    "max_bytes": denc.enc_u64(q.get("max_bytes") or 0),
                    "max_files": denc.enc_u64(q.get("max_files") or 0),
                    "rbytes": denc.enc_u64(rb),
                    "rfiles": denc.enc_u64(rf + rd)}
        if verb == "dirstat":
            # recursive stats (ceph.dir.rbytes/rfiles/rsubdirs vxattrs)
            rb, rf, rd = await self.fs.subtree_stats(path)
            return {"rbytes": denc.enc_u64(rb),
                    "rfiles": denc.enc_u64(rf),
                    "rsubdirs": denc.enc_u64(rd)}
        # -------- journaled mutations (single-flight via the lock)
        try:
            async with self._lock:
                return await self._serve_mutation(src, verb, args,
                                                  path)
        except _CrossRename as xr:
            # executed OUTSIDE our mutation lock: awaiting the peer
            # while holding it would ABBA-deadlock with a simultaneous
            # opposite-direction rename
            return await self._cross_rename(xr, args, path)

    async def _serve_snap_read(self, verb, args, path):
        """Resolve ``rel`` inside snapshot ``snap`` of dir ``path``
        (the /dir/.snap/name/rel addressing, SnapServer + snaprealm
        resolution role) against the FROZEN dirfrag copies."""
        snap = args["snap"].decode()
        rel = args.get("rel", b"").decode()
        dir_ino = await self.fs._walk(self.fs._split(path))
        sid = self.snaps.get((dir_ino, snap))
        if sid is None:
            raise fslib.NoEnt(f"{path}/.snap/{snap}")
        ino = dir_ino
        parts = [p for p in rel.split("/") if p]
        ent = {"ino": ino, "type": fslib.T_DIR, "size": 0, "mtime": 0}
        for i, name in enumerate(parts):
            try:
                omap = await self.client.omap_get(
                    self.meta_pool, _snap_dir_oid(sid, ino))
            except KeyError:
                raise fslib.NoEnt(rel) from None
            raw = omap.get(name.encode())
            if raw is None:
                raise fslib.NoEnt(name)
            ent = fslib._dec_inode(raw)
            if i < len(parts) - 1 and ent["type"] != fslib.T_DIR:
                raise fslib.NotADir(rel)
            ino = ent["ino"]
        if verb == "snaplist":
            if ent["type"] != fslib.T_DIR:
                raise fslib.NotADir(rel)
            try:
                omap = await self.client.omap_get(
                    self.meta_pool, _snap_dir_oid(sid, ino))
            except KeyError:
                omap = {}
            return {"names": denc.enc_list(
                sorted(omap), denc.enc_bytes)}
        out = _enc_ent(ent)
        out["snapid"] = denc.enc_u64(sid)
        return out

    async def _serve_peer(self, verb, args):
        """Execute a dirfrag mutation on behalf of another rank, under
        OUR mutation lock — cross-subtree renames serialize against
        this authority's local ops (Server.cc peer-request role)."""
        dir_ino = denc.dec_u64(args["dir"], 0)[0]
        name = args["name"].decode()
        if verb == "peer_link":
            if await self.fs._exists(dir_ino, name):
                raise fslib.Exists(name)
            await self.client.omap_set(
                self.meta_pool, fslib._dir_oid(dir_ino),
                {name.encode(): args["ent"]})
            return {}
        # peer_unlink: remove only if the dentry still points at the
        # expected ino — an undo must never take out a dentry someone
        # else linked meanwhile
        want = denc.dec_u64(args["ino"], 0)[0] if "ino" in args else None
        if want is not None:
            try:
                cur = await self.fs._dentry(dir_ino, name)
            except fslib.NoEnt:
                return {}
            if cur["ino"] != want:
                return {}
        await self.client.omap_rm(
            self.meta_pool, fslib._dir_oid(dir_ino), [name.encode()])
        return {}

    async def _rename_recall(self, path: str, ent: dict) -> None:
        """Rename flushes sizes and (for directories) drops every cap
        under the moving subtree: descendant paths change, and after a
        cross-subtree move a DIFFERENT rank answers for them — a
        surviving cap would let two clients hold exclusive writes."""
        if ent["type"] == fslib.T_FILE:
            await self._revoke_conflicting(ent["ino"], "__rename", "w")
            return
        await self._recall_subtree(path)

    async def _recall_subtree(self, path: str) -> None:
        """Recall every write cap under ``path`` on EVERY rank: nested
        exports mean other ranks may have granted caps inside our
        subtree. Peer recalls are served
        lock-free on the remote, so a simultaneous opposite-direction
        recall cannot deadlock."""
        for ino, p in list(self._open_paths.items()):
            if _under(p, path):
                await self._revoke_conflicting(ino, "__recall", "w")
        for r in {r for r in self.subtrees.values() if r != self.rank}:
            try:
                await self._peer_req(r, "peer_recall",
                                     {"path": _norm(path).encode()})
            except fslib.FSError:
                pass  # peer down: its caps die with it (eviction role)

    def _rename_open_paths(self, path: str, dst: str) -> None:
        """Rewrite recorded open paths (exact match AND descendants)
        so later cap flushes find the moved dentries."""
        np, nd = _norm(path), _norm(dst)
        for ino, p in list(self._open_paths.items()):
            pp = _norm(p)
            if pp == np:
                self._open_paths[ino] = nd
            elif _under(pp, np):
                self._open_paths[ino] = nd + pp[len(np):]

    async def _cross_rename(self, xr: "_CrossRename", args, path):
        """Cross-subtree rename (Server.cc master/peer arc): journal
        under our lock, ship the LINK half to the destination authority
        with our lock RELEASED, then unlink the source under our lock.
        On a peer failure the link is undone (ino-guarded) or, if the
        peer is unreachable for the undo too, completed directly — the
        journal entry never stays half-applied behind the expire
        watermark."""
        import time as _t

        dst = args["dst"].decode()
        async with self._lock:
            # REVALIDATE under the re-acquired lock: a concurrent
            # unlink/rename may have won it since _serve_mutation's
            # checks — journaling a stale intent would resurrect a
            # deleted file at the destination
            try:
                cur = await self.fs._dentry(xr.sp, xr.sn)
            except fslib.NoEnt:
                raise fslib.NoEnt(path) from None
            if cur["ino"] != xr.ent["ino"]:
                raise fslib.NoEnt(path)
            xr.ent = cur  # freshest size rides the link
            seq = await self._journal("rename", args)
        enc_ent = fslib._enc_inode(xr.ent["ino"], xr.ent["type"],
                                   xr.ent["size"], _t.time())
        link = {"dir": denc.enc_u64(xr.dp), "name": xr.dn.encode(),
                "ent": enc_ent}
        try:
            await self._peer_req(xr.rank, "peer_link", link)
        except fslib.Exists:
            async with self._lock:
                await self._expire(seq)
            raise
        except fslib.FSError:
            # undo (the reply may merely have been lost); if even the
            # undo fails, complete directly — the peer is presumed
            # down and replay would do the same (rejoin case)
            try:
                await self._peer_req(
                    xr.rank, "peer_unlink",
                    {"dir": denc.enc_u64(xr.dp),
                     "name": xr.dn.encode(),
                     "ino": denc.enc_u64(xr.ent["ino"])})
            except fslib.FSError:
                async with self._lock:
                    await self._apply_rename(path, dst)
                    self._quota_recount_move(path, dst)
                    await self._expire(seq)
                    self._rename_open_paths(path, dst)
                return {}
            async with self._lock:
                await self._expire(seq)
            raise fslib.FSError(f"peer rename {path} -> {dst} failed")
        async with self._lock:
            await self.client.omap_rm(
                self.meta_pool, fslib._dir_oid(xr.sp),
                [xr.sn.encode()])
            # the destination realm lives on the peer rank (its own
            # cache); invalidate our source-side counts (pop, not
            # decrement: the moved entry may be a whole subtree)
            self._quota_recount_move(path, dst)
            await self._expire(seq)
            self._rename_open_paths(path, dst)
        return {}

    async def _serve_mutation(self, src, verb, args, path):
        if verb == "setpin":
            # the ceph.dir.pin xattr role: a CLIENT pins a subtree to
            # a rank (sticky: the balancer skips it; UNPIN removes the
            # row); the current authority (requests route here by
            # path) exports it — how multi-MDS is driven over the
            # wire, no in-process handle on the daemon needed
            await self._export_locked(
                path, denc.dec_u32(args["rank"], 0)[0], pinned=True)
            return {}
        if verb == "setquota":
            # dir must exist (walk raises); both-zero clears the realm
            await self.fs.set_quota(
                path,
                max_bytes=denc.dec_u64(args["max_bytes"], 0)[0],
                max_files=denc.dec_u64(args["max_files"], 0)[0])
            self._realm_cache.clear()
            self._realm_count_cache.clear()
            return {}
        if verb == "create":
            ent = None
            try:
                ent = await self.fs.stat(path)
            except fslib.FSError:
                pass
            if ent is not None:
                raise fslib.Exists(path)
            await self._quota_check_files(path)
            seq = await self._journal(verb, args)
            ino = await self.fs.create(path)
            await self._expire(seq)
            self.caps.setdefault(ino, {})[src] = "w"
            self._open_paths[ino] = path
            return {"ino": denc.enc_u64(ino)}
        if verb == "rename":
            dst = args["dst"].decode()
            # validate first so the journal holds only viable intents
            sp, sn = await self.fs._resolve(path)
            dp, dn = await self.fs._resolve(dst)
            ent = await self.fs._dentry(sp, sn)
            await self._rename_recall(path, ent)
            ent = await self.fs._dentry(sp, sn)  # size after flush
            if await self.fs._exists(dp, dn):
                raise fslib.Exists(dst)
            dst_parent = _norm(dst).rsplit("/", 1)[0] or "/"
            dr = self.auth_rank(dst_parent)
            if dr != self.rank:
                raise _CrossRename(dr, sp, sn, dp, dn, ent)
            seq = await self._journal(verb, args)
            await self._apply_rename(path, dst,
                                     crash=self._crash_mid_rename)
            self._quota_recount_move(path, dst)
            await self._expire(seq)
            self._rename_open_paths(path, dst)
            return {}
        if verb == "mksnap":
            name = args["name"].decode()
            dir_ino = await self.fs._walk(self.fs._split(path))
            if (dir_ino, name) in self.snaps:
                raise fslib.Exists(f"{path}/.snap/{name}")
            # recall every write cap under the subtree FIRST — on every
            # rank, nested exports included: buffered sizes must be in
            # the dentries the snapshot freezes (the reference recalls
            # caps when a snaprealm changes)
            await self._recall_subtree(path)
            sid = await self.client.selfmanaged_snap_create(
                self.data_pool)
            args = dict(args)
            args["sid"] = denc.enc_u64(sid)
            args["root"] = denc.enc_u64(dir_ino)
            seq = await self._journal(verb, args)
            await self._apply_mksnap(dir_ino, name, sid)
            await self._expire(seq)
            return {"snapid": denc.enc_u64(sid)}
        if verb == "rmsnap":
            name = args["name"].decode()
            dir_ino = await self.fs._walk(self.fs._split(path))
            sid = self.snaps.get((dir_ino, name))
            if sid is None:
                raise fslib.NoEnt(name)
            args = dict(args)
            args["sid"] = denc.enc_u64(sid)
            args["root"] = denc.enc_u64(dir_ino)
            seq = await self._journal(verb, args)
            await self._apply_rmsnap(dir_ino, name, sid)
            await self._expire(seq)
            return {}
        if verb == "truncate":
            ent = await self.fs.stat(path)
            if ent["type"] == fslib.T_FILE:
                # truncate is a write: recall EVERY other cap FIRST so
                # cached readers drop the doomed bytes and buffered
                # writers flush before (not after) the cut. Recalled
                # here, not in _apply — replay has no clients to call.
                await self._revoke_conflicting(ent["ino"], src, "w")
        if verb == "mkdir":
            await self._quota_check_files(path)
        seq = await self._journal(verb, args)
        out = await self._apply(verb, args)
        await self._expire(seq)
        return out

    async def _quota_check_files(self, path: str) -> None:
        """EDQUOT when creating one more entry would pass the nearest
        realm's max_files (MDS-side file-count enforcement; byte
        quotas are enforced client-side like the reference, since data
        writes never pass through the MDS).

        Both the realm lookup (per-ancestor getxattr) and the subtree
        entry count (full BFS) are cached briefly and self-advanced on
        each accepted create — without this, filling a realm is
        O(N^2) in omap round trips and even quota-free trees pay a
        per-create ancestor walk. setquota clears both caches."""
        parent = _norm(path).rsplit("/", 1)[0] or "/"
        now = time.monotonic()
        hit = self._realm_cache.get(parent)
        if hit is not None and now < hit[0]:
            realm = hit[1]
        else:
            realm = await self.fs.nearest_quota(parent)
            self._realm_cache[parent] = (now + 2.0, realm)
            if len(self._realm_cache) > 4096:
                self._realm_cache.clear()
        if realm is None:
            return
        rpath, q = realm
        if not q.get("max_files"):
            return
        sh = self._realm_count_cache.get(rpath)
        if sh is not None and now < sh[0]:
            count = sh[1]
        else:
            _rb, rf, rd = await self.fs.subtree_stats(rpath)
            count = rf + rd
        if count >= q["max_files"]:
            raise fslib.QuotaExceeded(
                f"{rpath}: {count} >= max_files {q['max_files']}")
        # account the entry this check just admitted
        self._realm_count_cache[rpath] = (now + 2.0, count + 1)

    def _quota_uncount(self, path: str) -> None:
        """Inverse of the self-advance above: unlink/rmdir must
        decrement every cached realm count covering ``path``, or a
        sustained create burst keeps the inflated count alive (each
        accepted create re-extends the TTL) and deletes never free
        quota — spurious EDQUOT long after space was reclaimed.
        Adjust-by-1 is exact here: unlink takes one file, rmdir one
        EMPTY directory (non-empty raises NotEmpty); renames go
        through _quota_recount_move instead."""
        p = _norm(path)
        for rpath, (exp, count) in list(
                self._realm_count_cache.items()):
            if _under(p, rpath):
                self._realm_count_cache[rpath] = (exp,
                                                  max(0, count - 1))

    def _quota_recount_move(self, src: str, dst: str) -> None:
        """Rename moved an entry between realms: INVALIDATE every
        cached count covering exactly one side. Adjusting by 1 would
        be wrong for a non-empty directory (the cache holds recursive
        rf+rd subtree counts); a pop re-syncs from subtree_stats on
        the next create, correct for any subtree size. Realms covering
        both sides are unchanged and keep their entry."""
        s, d = _norm(src), _norm(dst)
        for rpath in list(self._realm_count_cache):
            if _under(s, rpath) != _under(d, rpath):
                self._realm_count_cache.pop(rpath, None)

    async def _apply_mksnap(self, dir_ino: int, name: str,
                            sid: int) -> None:
        """Freeze the subtree's dirfrags under snapshot oids (BFS; the
        copy is idempotent, so journal replay just re-copies), then
        commit the table row — the snapshot exists once the row does."""
        todo = [dir_ino]
        while todo:
            ino = todo.pop()
            try:
                omap = await self.client.omap_get(self.meta_pool,
                                                  fslib._dir_oid(ino))
            except KeyError:
                continue
            await self.client.write_full(self.meta_pool,
                                         _snap_dir_oid(sid, ino), b"")
            if omap:
                await self.client.omap_set(
                    self.meta_pool, _snap_dir_oid(sid, ino), omap)
            for raw in omap.values():
                ent = fslib._dec_inode(raw)
                if ent["type"] == fslib.T_DIR:
                    todo.append(ent["ino"])
        await self.client.omap_set(
            self.meta_pool, SNAP_TABLE_OID,
            # row key carries the dir ino: same-named snapshots of
            # DIFFERENT directories are distinct rows
            {f"{dir_ino:x}/{name}".encode():
             denc.enc_u64(dir_ino) + denc.enc_u64(sid)})
        self.snaps[(dir_ino, name)] = sid

    async def _apply_rmsnap(self, dir_ino: int, name: str,
                            sid: int) -> None:
        # post-order: a dir's frozen frag is deleted only AFTER its
        # children's — a crash mid-removal leaves the root reachable,
        # so journal replay re-walks and finishes instead of orphaning
        # descendant objects behind a deleted root
        async def scrub(ino: int) -> None:
            try:
                omap = await self.client.omap_get(
                    self.meta_pool, _snap_dir_oid(sid, ino))
            except KeyError:
                return
            for raw in omap.values():
                ent = fslib._dec_inode(raw)
                if ent["type"] == fslib.T_DIR:
                    await scrub(ent["ino"])
            try:
                await self.client.delete(self.meta_pool,
                                         _snap_dir_oid(sid, ino))
            except KeyError:
                pass

        await scrub(dir_ino)
        await self.client.omap_rm(
            self.meta_pool, SNAP_TABLE_OID,
            [f"{dir_ino:x}/{name}".encode()])
        self.snaps.pop((dir_ino, name), None)
        # hand data reclamation to the RADOS snap trimmer
        await self.client.selfmanaged_snap_remove(self.data_pool, sid)

    # ------------------------------------------------------- op execution

    async def _apply(self, verb: str, args: dict[str, bytes]) -> dict:
        path = args.get("path", b"").decode()
        if verb == "mkdir":
            await self.fs.mkdir(path)
            return {}
        if verb == "rmdir":
            try:
                ino = await self.fs._walk(self.fs._split(path))
            except fslib.FSError:
                ino = None
            if ino is not None and any(
                    i == ino for (i, _n) in self.snaps):
                # a removed dir's snapshots would be unreachable AND
                # their sid pinned in every future SnapContext forever
                # (CephFS forbids this for the same reason)
                raise fslib.NotEmpty(f"{path} has snapshots")
            await self.fs.rmdir(path)
            self._quota_uncount(path)
            return {}
        if verb == "unlink":
            await self.fs.unlink(path)
            self._quota_uncount(path)
            return {}
        if verb == "truncate":
            size = denc.dec_u64(args["size"], 0)[0]
            await self.fs.truncate(path, size)
            return {}
        if verb == "create":
            ino = await self.fs.create(path)
            return {"ino": denc.enc_u64(ino)}
        if verb == "rename":
            dst = args["dst"].decode()
            await self._apply_rename(path, dst)
            self._quota_recount_move(path, dst)
            return {}
        if verb == "mksnap":
            sid = denc.dec_u64(args["sid"], 0)[0]
            root = denc.dec_u64(args["root"], 0)[0]
            await self._apply_mksnap(root, args["name"].decode(), sid)
            return {}
        if verb == "rmsnap":
            sid = denc.dec_u64(args["sid"], 0)[0]
            root = denc.dec_u64(args["root"], 0)[0]
            await self._apply_rmsnap(root, args["name"].decode(), sid)
            return {}
        if verb == "export":
            await self._apply_export(
                args["path"].decode(),
                denc.dec_u32(args["rank"], 0)[0],
                pinned=bool(args.get("pin", b"\x00")[0]))
            return {}
        raise fslib.FSError(f"verb {verb!r}")

    async def _apply_rename(self, src_path: str, dst_path: str,
                            crash: bool = False) -> None:
        """The two-dirfrag mutation the journal exists for: link at the
        destination, crash window, unlink at the source. Replay after a
        crash finds the destination present and finishes the unlink."""
        import time as _t

        sp, sn = await self.fs._resolve(src_path)
        dp, dn = await self.fs._resolve(dst_path)
        try:
            ent = await self.fs._dentry(sp, sn)
        except fslib.NoEnt:
            return  # replay: rename already completed
        try:
            dent = await self.fs._dentry(dp, dn)
            if dent["ino"] == ent["ino"]:
                # replay: destination linked, source not yet unlinked
                await self.client.omap_rm(
                    self.meta_pool, fslib._dir_oid(sp), [sn.encode()])
                return
            raise fslib.Exists(dst_path)
        except fslib.NoEnt:
            pass
        await self.client.omap_set(
            self.meta_pool, fslib._dir_oid(dp),
            {dn.encode(): fslib._enc_inode(
                ent["ino"], ent["type"], ent["size"], _t.time())},
        )
        if crash:
            raise _MDSCrash("crash hook: mid-rename")
        await self.client.omap_rm(
            self.meta_pool, fslib._dir_oid(sp), [sn.encode()])


class _MDSCrash(Exception):
    pass


class _Redirect(Exception):
    """Raised by _serve when the path belongs to another rank."""

    def __init__(self, rank: int):
        super().__init__(f"rank {rank}")
        self.rank = rank


class _CrossRename(Exception):
    """Control-flow carrier: a validated rename whose destination
    dirfrag another rank owns; completed by _cross_rename OUTSIDE the
    mutation lock (see the deadlock note there)."""

    def __init__(self, rank: int, sp: int, sn: str, dp: int, dn: str,
                 ent: dict):
        super().__init__(f"cross-rename to rank {rank}")
        self.rank, self.sp, self.sn = rank, sp, sn
        self.dp, self.dn, self.ent = dp, dn, ent


class MDBalancer:
    """The MDBalancer.cc role over MDSLite ranks: compare decaying
    per-rank request loads each tick; when one rank is ``ratio``x
    hotter than the coolest, export its hottest owned top-level
    directory there. Works on authority handover (export_dir), so a
    "migration" costs one omap row + cap recalls, not a cache
    transfer."""

    def __init__(self, mdss, ratio: float = 2.0,
                 min_load: float = 8.0):
        self.mdss = {m.rank: m for m in mdss}
        self.ratio = ratio
        self.min_load = min_load

    async def tick(self) -> list[tuple[str, int, int]]:
        """Returns the moves performed: (path, from_rank, to_rank)."""
        totals = {r: sum(m.load.values())
                  for r, m in self.mdss.items()}
        busy = max(totals, key=lambda r: totals[r])
        idle = min(totals, key=lambda r: totals[r])
        moves: list[tuple[str, int, int]] = []
        if (busy != idle and totals[busy] >= self.min_load
                and totals[busy] > self.ratio * max(totals[idle], 1.0)):
            m = self.mdss[busy]
            for _l, d in sorted(
                    ((l, d) for d, l in m.load.items()
                     if d != "/" and m.auth_rank(d) == m.rank
                     and d not in m.pins),  # pins are sticky
                    reverse=True):
                try:
                    ent = await m.fs.stat(d)
                except fslib.FSError:
                    continue
                if ent["type"] != fslib.T_DIR:
                    continue
                await m.export_dir(d, idle)
                m.load.pop(d, None)
                moves.append((d, busy, idle))
                break
        for m in self.mdss.values():
            # half-life decay (the reference's DecayCounter)
            m.load = {d: l / 2 for d, l in m.load.items() if l > 0.5}
        return moves


def _dec_submap(raw: bytes) -> dict[str, int]:
    m, _ = denc.dec_map(raw, 0, denc.dec_bytes, denc.dec_bytes)
    return {k.decode(): denc.dec_u32(v, 0)[0] for k, v in m.items()}


def _enc_ent(ent: dict) -> dict[str, bytes]:
    return {
        "ino": denc.enc_u64(ent["ino"]),
        "type": denc.enc_u8(ent["type"]),
        "size": denc.enc_u64(ent["size"]),
    }


class FSClient:
    """The libcephfs-role client: metadata via the MDS, file data
    striped directly to the OSDs, write caps buffering file size."""

    def __init__(self, bus, client, data_pool: int,
                 name: str = "fsclient.0", mds: str = "mds.0",
                 timeout: float = 10.0, cache: bool = False):
        from ..osdc.striped_client import RadosStriper

        self.bus = bus
        self.name = name
        self.mds = mds
        self._mds_base = mds.rsplit(".", 1)[0]
        #: cached subtree-authority map (MDSMap role): path -> rank,
        #: refreshed from every ESTALE redirect
        self.submap: dict[str, int] = {"/": 0}
        #: ino -> rank that granted our cap (close/setsize route there)
        self._ino_rank: dict[int, int] = {}
        self.timeout = timeout
        #: optional write-back/read-ahead data cache (ObjectCacher
        #: role, cap-fenced: flushed+invalidated on revoke/close). The
        #: striper sees the cache as its client for data objects.
        self._cacher = None
        data_io = client
        if cache:
            from ..osdc.object_cacher import CacheIo, ObjectCacher

            self._cacher = ObjectCacher(client, data_pool)
            data_io = CacheIo(client, self._cacher)
        self.striper = RadosStriper(data_io, data_pool)
        self._tid = 0
        self._last_rank = 0
        self._futs: dict[int, asyncio.Future] = {}
        #: ino -> buffered size under a held write cap
        self.wcaps: dict[int, int] = {}
        self._paths: dict[str, int] = {}
        #: cached data-pool SnapContext (refreshed from every MDS
        #: reply); direct data writes carry it so snapshots COW
        self._snapc: tuple[int, list[int]] = (0, [])
        #: realm path -> (expiry, quota dict) — see _quota_check_bytes
        self._quota_cache: dict[str, tuple[float, dict | None]] = {}

    async def connect(self) -> None:
        self.bus.register(self.name, self._handle)

    async def close(self) -> None:
        if self._cacher is not None:
            await self._cacher.flush()
        for ino in list(self.wcaps):
            await self._flush(ino)
        self.bus.unregister(self.name)

    async def _handle(self, src: str, msg) -> None:
        if isinstance(msg, M.MClientReply):
            fut = self._futs.get(msg.tid)
            if fut is not None and not fut.done():
                fut.set_result(msg)
        elif isinstance(msg, M.MCapRevoke):
            if self._cacher is not None:
                # the cap fence: buffered data lands before the cap
                # (and with it our write authority) is handed back,
                # then nothing cached may be trusted
                await self._cacher.flush()
                self._cacher.invalidate()
            size = self.wcaps.pop(msg.ino, NOSIZE)
            await self.bus.send(
                self.name, src,
                M.MCapRelease(ino=msg.ino, tid=msg.tid, size=size))

    def _rank_for(self, path: str) -> int:
        return _deepest_rank(self.submap, path)

    def _route(self, verb: str, args: dict) -> int:
        if verb in ("close", "setsize"):
            # the cap lives at the rank that granted it
            return self._ino_rank.get(args.get("ino"), 0)
        p = args.get("path")
        return self._rank_for(p) if isinstance(p, str) else 0

    async def _send_once(self, rank: int, verb: str,
                         enc: dict[str, bytes]):
        self._tid += 1
        tid = self._tid
        fut = asyncio.get_running_loop().create_future()
        self._futs[tid] = fut
        try:
            await self.bus.send(self.name, f"{self._mds_base}.{rank}",
                                M.MClientRequest(tid=tid, verb=verb,
                                                 args=enc))
            return await asyncio.wait_for(fut, self.timeout)
        finally:
            self._futs.pop(tid, None)

    async def _req(self, verb: str, **args) -> dict[str, bytes]:
        enc = {}
        for k, v in args.items():
            enc[k] = v.encode() if isinstance(v, str) else (
                denc.enc_u64(v) if isinstance(v, int) else v)
        rank = self._route(verb, args)
        for _attempt in range(4):
            reply = await self._send_once(rank, verb, enc)
            if reply.result == M.ESTALE and "submap" in reply.out:
                # wrong rank: adopt the responder's subtree map and
                # follow the redirect (MDSMap refresh role)
                self.submap = _dec_submap(reply.out["submap"])
                rank = denc.dec_u32(reply.out["rank"], 0)[0]
                continue
            break
        self._last_rank = rank
        if reply.result != 0:
            if reply.result == M.ENOENT:
                raise fslib.NoEnt(args.get("path", ""))
            if reply.result == -17:
                raise fslib.Exists(args.get("path", ""))
            if reply.result == -39:
                raise fslib.NotEmpty(args.get("path", ""))
            if reply.result == -122:
                raise fslib.QuotaExceeded(args.get("path", ""))
            raise fslib.FSError(f"{verb} failed: {reply.result}")
        snapc_raw = reply.out.pop("__snapc", None)
        if snapc_raw is not None:
            seq, off = denc.dec_u64(snapc_raw, 0)
            ids, _ = denc.dec_list(snapc_raw, off, denc.dec_u64)
            # MERGE, don't replace: each rank's reply carries only the
            # snaps it knows; a reply from rank A must never downgrade
            # ids learned from rank B or a snapshot there loses its COW
            merged = sorted(set(ids) | set(self._snapc[1]),
                            reverse=True)
            self._snapc = (max(seq, self._snapc[0]), merged)
        return reply.out

    async def _flush(self, ino: int) -> None:
        if self._cacher is not None:
            # data lands before the size that describes it
            await self._cacher.flush()
        size = self.wcaps.pop(ino, NOSIZE)
        if size != NOSIZE:
            await self._req("setsize", ino=ino, size=size)

    # ------------------------------------------------------------ surface

    async def mkdir(self, path: str) -> None:
        await self._req("mkdir", path=path)

    async def set_subtree_pin(self, path: str, rank: int) -> None:
        """Pin directory ``path``'s subtree to an MDS rank (the
        ceph.dir.pin export-pin role, sticky vs the balancer); the
        owning rank exports it. ``rank=-1`` removes the pin (the
        subtree reverts to its parent's authority)."""
        await self._req("setpin", path=path,
                        rank=denc.enc_u32(rank & 0xFFFFFFFF))
        # our map is stale the moment the export lands
        if rank < 0:
            self.submap.pop(_norm(path), None)
        else:
            self.submap[_norm(path)] = rank

    async def rmdir(self, path: str) -> None:
        await self._req("rmdir", path=path)

    # ------------------------------------------------------------ quotas

    async def set_quota(self, path: str, max_bytes: int = 0,
                        max_files: int = 0) -> None:
        """ceph.quota.max_bytes / max_files vxattr role (0 = off)."""
        await self._req("setquota", path=path,
                        max_bytes=denc.enc_u64(max_bytes),
                        max_files=denc.enc_u64(max_files))
        self._quota_cache.clear()

    async def get_quota(self, path: str) -> dict | None:
        """Nearest quota realm covering ``path`` with current usage:
        {realm, max_bytes, max_files, rbytes, rfiles}; None = no
        realm."""
        out = await self._req("getquota", path=path)
        realm = out["realm"].decode()
        if not realm:
            return None
        return {"realm": realm,
                "max_bytes": denc.dec_u64(out["max_bytes"], 0)[0],
                "max_files": denc.dec_u64(out["max_files"], 0)[0],
                "rbytes": denc.dec_u64(out["rbytes"], 0)[0],
                "rfiles": denc.dec_u64(out["rfiles"], 0)[0]}

    async def dir_stat(self, path: str) -> dict:
        """Recursive dir stats (ceph.dir.rbytes/rfiles/rsubdirs)."""
        out = await self._req("dirstat", path=path)
        return {k: denc.dec_u64(out[k], 0)[0]
                for k in ("rbytes", "rfiles", "rsubdirs")}

    async def _quota_check_bytes(self, path: str, grow: int) -> None:
        """Client-side max_bytes enforcement before a growing write
        (Client::check_quota_condition role — data never passes
        through the MDS, so the writer itself must check). The realm
        lookup is cached briefly PER PARENT DIR (a realm-keyed cache
        would let a cached outer realm shadow a deeper, tighter one),
        caches negative results too, and advances the cached usage by
        our own accepted writes so a burst inside one TTL window
        cannot blow past the limit unchecked. Cross-client lag stays
        bounded by the TTL, like the reference's cap-propagated
        realms."""
        if grow <= 0:
            return
        parent = _norm(path).rsplit("/", 1)[0] or "/"
        now = time.monotonic()
        hit = self._quota_cache.get(parent)
        if hit is not None and now < hit[0]:
            q = hit[1]
        else:
            q = await self.get_quota(path)
            self._quota_cache[parent] = (now + 2.0, q)
        if q and q["max_bytes"] \
                and q["rbytes"] + grow > q["max_bytes"]:
            raise fslib.QuotaExceeded(
                f"{q['realm']}: {q['rbytes']} + {grow} > "
                f"max_bytes {q['max_bytes']}")
        if q:
            q["rbytes"] += grow

    async def listdir(self, path: str = "/") -> list[str]:
        out = await self._req("listdir", path=path)
        names, _ = denc.dec_list(out["names"], 0, denc.dec_bytes)
        return [n.decode() for n in names]

    async def stat(self, path: str) -> dict:
        ino = self._paths.get(path)
        if ino is not None and ino in self.wcaps:
            # we hold the write cap: our buffered size is authoritative
            return {"ino": ino, "type": fslib.T_FILE,
                    "size": self.wcaps[ino]}
        out = await self._req("stat", path=path)
        return {"ino": denc.dec_u64(out["ino"], 0)[0],
                "type": denc.dec_u8(out["type"], 0)[0],
                "size": denc.dec_u64(out["size"], 0)[0]}

    async def rename(self, src: str, dst: str) -> None:
        await self._req("rename", path=src, dst=dst)

    async def unlink(self, path: str) -> None:
        ino = self._paths.pop(path, None)
        if ino is not None:
            self.wcaps.pop(ino, None)
            self._ino_rank.pop(ino, None)
        await self._req("unlink", path=path)

    async def create(self, path: str) -> int:
        out = await self._req("create", path=path)
        ino = denc.dec_u64(out["ino"], 0)[0]
        self.wcaps[ino] = 0  # create grants the write cap
        self._paths[path] = ino
        self._ino_rank[ino] = self._last_rank
        return ino

    async def open(self, path: str, mode: str = "r") -> int:
        out = await self._req("open", path=path, mode=mode)
        ino = denc.dec_u64(out["ino"], 0)[0]
        self._paths[path] = ino
        if len(self._ino_rank) > 8192:
            # routing hints, not state: shed capless entries so a
            # file-churning client doesn't grow without bound. Inos
            # with a LIVE write cap are kept — their close/setsize
            # must still reach the granting rank.
            for k in list(self._ino_rank):
                if k not in self.wcaps:
                    del self._ino_rank[k]
                    if len(self._ino_rank) <= 4096:
                        break
        self._ino_rank[ino] = self._last_rank
        if mode == "w":
            self.wcaps[ino] = denc.dec_u64(out["size"], 0)[0]
        return ino

    async def write(self, path: str, data: bytes,
                    offset: int = 0) -> None:
        ino = self._paths.get(path)
        if ino is None or ino not in self.wcaps:
            try:
                ino = await self.open(path, "w")
            except fslib.NoEnt:
                ino = await self.create(path)
        # open("w")/create always seeded wcaps with the server size,
        # so prev is the authoritative pre-write size
        prev = self.wcaps[ino]
        await self._quota_check_bytes(
            path, offset + len(data) - prev)
        await self.striper.write(fslib._data_name(ino), data, offset,
                                 snapc=self._snapc)
        self.wcaps[ino] = max(prev, offset + len(data))

    @staticmethod
    def _clamp(ent: dict, what: str, offset: int,
               length: int) -> int:
        if ent["type"] != fslib.T_FILE:
            raise fslib.FSError(f"{what} is a directory")
        if length < 0:
            length = max(0, ent["size"] - offset)
        return min(length, max(0, ent["size"] - offset))

    async def read(self, path: str, offset: int = 0,
                   length: int = -1) -> bytes:
        if self._cacher is not None and path not in self._paths:
            # register an "r" cap (Locker role): a later writer's open
            # revokes it, which is what flushes+invalidates our cache —
            # without the cap, cached clean bytes would go stale the
            # moment another client writes
            try:
                await self.open(path, "r")
            except fslib.FSError:
                pass  # directories etc.: stat below raises properly
        ent = await self.stat(path)
        length = self._clamp(ent, path, offset, length)
        return await self.striper.read(fslib._data_name(ent["ino"]),
                                       offset, length)

    async def truncate(self, path: str, size: int) -> None:
        ino = self._paths.get(path)
        if ino is not None:
            # full fence FIRST: buffered data and the authoritative
            # size reach the MDS before it decides grow-vs-shrink and
            # cuts the data objects (flushing after would resurrect
            # truncated-away bytes)
            await self._flush(ino)
        if self._cacher is not None:
            # flush even when the file was never opened here — the
            # wholesale invalidate below must not discard OTHER files'
            # buffered dirty writes
            await self._cacher.flush()
        await self._req("truncate", path=path, size=size)
        if self._cacher is not None:
            # drop CLEAN cached content AFTER the MDS applied the cut:
            # invalidating before it leaves a window where a concurrent
            # read re-caches pre-truncate bytes, and a full invalidate
            # here would discard other files' writes buffered during
            # the RPC await
            self._cacher.invalidate_clean()

    # ---------------------------------------------------------- snapshots
    #
    # The .snap addressing (SnapServer + snaprealm roles): mksnap
    # freezes a directory subtree's metadata and pins its files' data
    # via a RADOS selfmanaged snap; reads address
    # <dir>/.snap/<name>/<rel>.

    async def mksnap(self, dirpath: str, name: str) -> int:
        out = await self._req("mksnap", path=dirpath, name=name)
        return denc.dec_u64(out["snapid"], 0)[0]

    async def rmsnap(self, dirpath: str, name: str) -> None:
        await self._req("rmsnap", path=dirpath, name=name)

    async def lssnap(self, dirpath: str) -> list[str]:
        out = await self._req("lssnap", path=dirpath)
        names, _ = denc.dec_list(out["names"], 0, denc.dec_bytes)
        return [n.decode() for n in names]

    async def snap_stat(self, dirpath: str, snap: str,
                        rel: str) -> dict:
        out = await self._req("snapstat", path=dirpath, snap=snap,
                              rel=rel)
        return {"ino": denc.dec_u64(out["ino"], 0)[0],
                "type": denc.dec_u8(out["type"], 0)[0],
                "size": denc.dec_u64(out["size"], 0)[0],
                "snapid": denc.dec_u64(out["snapid"], 0)[0]}

    async def snap_listdir(self, dirpath: str, snap: str,
                           rel: str = "") -> list[str]:
        out = await self._req("snaplist", path=dirpath, snap=snap,
                              rel=rel)
        names, _ = denc.dec_list(out["names"], 0, denc.dec_bytes)
        return [n.decode() for n in names]

    async def snap_read(self, dirpath: str, snap: str, rel: str,
                        offset: int = 0, length: int = -1) -> bytes:
        ent = await self.snap_stat(dirpath, snap, rel)
        length = self._clamp(ent, rel, offset, length)
        return await self.striper.read(
            fslib._data_name(ent["ino"]), offset, length,
            snapid=ent["snapid"])
