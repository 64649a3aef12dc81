"""RadosClient: librados-role API over an Objecter-role engine.

calc_target maps object -> PG -> primary through the client's own OSDMap
copy (Objecter::_calc_target, src/osdc/Objecter.cc:2776); ops are
tracked in-flight and resent when the map changes their target or when
the primary answers ESTALE (the resend-on-epoch-change contract,
Objecter.cc:2384). Public surface mirrors IoCtx basics: create_pool,
write_full, read, stat, delete (src/librados/IoCtxImpl.cc:589-668).

ceph_tpu_torch's own copy of ``ceph_tpu/cluster/client.py``. ``device``
(new, last) is where the client's placement resolver runs its batches.
"""
from __future__ import annotations

import asyncio
import functools
import random
from dataclasses import dataclass, field

from ..device import resolve
from ..placement import encoding as menc
from ..placement.osdmap import Pool
from ..placement.resolver import PlacementResolver
from ..utils import config as cfg
from ..utils import denc, trace
from . import messages as M


#: op verbs gated by the pool FULL flag (mirror of pg.WRITE_OPS, kept
#: local to avoid importing the PG module into every client). "call"
#: is included like the PG's own write-class test: object-class
#: methods may mutate, so they must not bypass quota enforcement.
_WRITE_VERBS = frozenset((
    "writefull", "write", "append", "zero", "truncate", "delete",
    "create", "setxattr", "rmxattr", "omap_setkeys", "omap_rmkeys",
    "omap_setheader", "omap_clear", "call",
))

#: write verbs still admitted to a quota-FULL pool (the librados
#: LIBRADOS_OPERATION_FULL_TRY stance): space-reclaiming ops must pass
#: or usage can never drop and the FULL flag never self-clears — the
#: only exit would be raising the quota. truncate is NOT here: it can
#: extend an object, which is exactly the growth the gate must stop.
_FULL_OK_VERBS = frozenset((
    "delete", "rmxattr", "omap_rmkeys", "omap_clear",
))


class RadosError(IOError):
    """Op-vector failure with its errno-style code attached (librados
    negative-errno contract); str() keeps the legacy message shape."""

    ENODATA = -61

    def __init__(self, code: int, what: str = ""):
        super().__init__(what or f"op vector failed: {code}")
        self.code = code


def absent_attr(e: BaseException) -> bool:
    """True only when an xattr/object read failed because the thing
    genuinely is not there: missing object (ENOENT -> KeyError) or
    missing xattr (ENODATA). Everything else — transient op failures,
    EBLOCKLISTED — is a real error the caller must not fold into
    "absent" (shared by rbd_crypto keyslot probes and rgw_notify
    config reads, where that misreading destroys data or drops
    events)."""
    if isinstance(e, KeyError):
        return True
    return isinstance(e, RadosError) and e.code == RadosError.ENODATA


class Completion:
    """Handle of one aio op (librados AioCompletion role): ``await
    wait()`` for the reply — raising exactly what the synchronous call
    would — or poll ``done()``. Completions of ops on the SAME object
    resolve in submission order (the Objecter's per-object ordering
    contract); ops on different objects complete independently."""

    __slots__ = ("_fut",)

    def __init__(self, fut: asyncio.Future):
        self._fut = fut

    def done(self) -> bool:
        return self._fut.done()

    def add_done_callback(self, fn) -> None:
        """fn(completion) once the op resolves, success or failure —
        the latency-sampling hook the bench/swarm harnesses use
        (librados aio set_complete_callback role)."""
        self._fut.add_done_callback(lambda _f: fn(self))

    async def wait(self):
        """Block until the op completed; returns the MOSDOpReply (outs
        carry per-op outputs) or raises the op's failure."""
        return await asyncio.shield(self._fut)

    def result(self):
        return self._fut.result()


@dataclass
class _InFlight:
    msg: M.MOSDOp
    fut: asyncio.Future
    target: int = -1
    attempts: int = 0
    #: last retryable result seen (ESTALE/EAGAIN) — surfaced if the op
    #: deadline expires so a persistent server-side failure reads as an
    #: error, not as a silent timeout
    last_result: int = 0


class RadosClient:
    def __init__(self, bus, name: str = "client.0",
                 op_timeout: float = 10.0,
                 conf: cfg.ConfigProxy | None = None,
                 placement_batch: bool | None = None,
                 device=None):
        self.bus = bus
        #: where the placement resolver's batches run (the CUDA card
        #: unless the caller names another; raises with none and no card)
        self.device = resolve(device)
        self.name = name
        self.osdmap = None
        self.op_timeout = op_timeout
        self.conf = conf if conf is not None else cfg.proxy()
        #: total resend decisions (ESTALE/EAGAIN bounces + tick
        #: resends) — the client_op_retries counter thrash verdicts and
        #: bench config 6 report
        self.op_retries = 0
        self._backoff_rng = random.Random()
        # tid doubles as the reqid the OSD's write dedup is keyed on
        # (src, tid); the reference scopes reqids by an entity NONCE so
        # a restarted client can never collide with its predecessor's
        # cached replies — fold that nonce into the tid's high bits
        import secrets

        self._tid = secrets.randbits(31) << 32
        self._ops: dict[int, _InFlight] = {}
        self._map_waiters: list[asyncio.Future] = []
        self._snap_ops: dict[int, asyncio.Future] = {}
        self._watches: dict[tuple[bytes, int], object] = {}
        #: the batched placement service (placement/resolver.py):
        #: epoch-keyed memo, misses coalesced into device bulk-CRUSH
        #: dispatches on the async path, host fallback always;
        #: ``placement_batch`` None honors the CEPH_TPU_PLACEMENT_BATCH
        #: A/B lever, True/False pins it (the swarm harness's arms)
        self._placement = PlacementResolver(conf=self.conf,
                                            batch=placement_batch,
                                            device=self.device)
        self._next_cookie = 0
        self._tracer = trace.get_tracer(name)
        # ---- aio op window (Objecter in-flight budget role): aio
        # submissions block once client_max_inflight ops are in flight,
        # which is what lets ONE task drive a deep pipeline with
        # bounded memory instead of N tasks x blocking awaits
        self._aio_inflight = 0
        self._aio_waiters: list[asyncio.Future] = []
        self._aio_idle: list[asyncio.Future] = []
        self._aio_tasks: set[asyncio.Task] = set()
        #: per-object completion chain: (pool, oid) -> the future of the
        #: newest aio op on that object (next op executes after it)
        self._obj_tail: dict[tuple[int, bytes], asyncio.Future] = {}
        #: window occupancy at each aio submission (sum/count/max) —
        #: the inflight_window_occupancy numbers bench config 6 reports
        self.window_stats = {"sum": 0, "count": 0, "max": 0}

    # ---------------------------------------------------------- lifecycle

    async def connect(self) -> None:
        """Register + subscribe, RE-SENDING the subscription until the
        first map lands. A one-shot subscribe is lossy across a
        crash-restart that reuses our entity name: the mon still holds
        a connection to the dead predecessor, and TCP silently buffers
        the first write to a dead peer — the reply vanishes, no error
        anywhere. Resending (MonClient hunt role) rides a fresh
        connection once the stale one RSTs."""
        self.bus.register(self.name, self.handle)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.op_timeout
        while self.osdmap is None:
            left = deadline - loop.time()
            if left <= 0:
                raise TimeoutError(f"{self.name}: no osdmap from mon")
            try:
                await self._mon_send(M.MMonSubscribe(what="osdmap"),
                                     deadline_s=min(2.0, left))
            except IOError:
                continue  # mon mid-failover: hunt again until timeout
            fut = loop.create_future()
            self._map_waiters.append(fut)
            try:
                await asyncio.wait_for(fut, min(1.0, left))
            except asyncio.TimeoutError:
                if fut in self._map_waiters:
                    self._map_waiters.remove(fut)

    async def _mon_send(self, msg, deadline_s: float | None = None
                        ) -> None:
        """Hunting mon send (see cluster/monclient.py)."""
        from .monclient import mon_send

        await mon_send(self.bus, self.name, msg,
                       self.op_timeout if deadline_s is None
                       else deadline_s)

    async def close(self) -> None:
        self._placement.close()
        self.bus.unregister(self.name)

    # ------------------------------------------------------------ dispatch

    async def handle(self, src: str, msg) -> None:
        if isinstance(msg, M.MOSDMapMsg):
            self._apply_map(msg)
        elif isinstance(msg, M.MNotifyEvent):
            cb = self._watches.get((msg.oid, msg.cookie))
            if cb is not None:
                cb(msg.oid, msg.notify_id, msg.payload)
        elif isinstance(msg, M.MOSDOpReply):
            await self._handle_reply(msg)
        elif isinstance(msg, M.MPoolCreateReply):
            fut = self._snap_ops.get(msg.tid)
            if fut is not None and not fut.done():
                fut.set_result(msg)
        elif isinstance(msg, (M.MPoolSnapReply, M.MPoolSetReply,
                              M.MBlocklistReply, M.MMonCommandReply)):
            fut = self._snap_ops.get(msg.tid)
            if fut is not None and not fut.done():
                fut.set_result(msg)

    def _apply_map(self, msg: M.MOSDMapMsg) -> None:
        if msg.full:
            full, _ = menc.decode_osdmap(msg.full)
            if self.osdmap is None or full.epoch >= self.osdmap.epoch:
                self.osdmap = full  # never regress to an older map
        gapped = False
        for raw in msg.incrementals:
            inc, _ = menc.decode_incremental(raw)
            if self.osdmap is None:
                return
            if inc.epoch == self.osdmap.epoch + 1:
                self.osdmap.apply_incremental(inc)
            elif inc.epoch > self.osdmap.epoch + 1:
                gapped = True
        if gapped:
            # missed epochs (e.g. a mon failover moved the subscriber
            # set): ask for a fill
            asyncio.get_running_loop().create_task(
                self._mon_send(M.MMonGetMap(have=self.osdmap.epoch),
                               deadline_s=2.0)
            )
        for fut in self._map_waiters:
            if not fut.done():
                fut.set_result(None)
        self._map_waiters = [f for f in self._map_waiters if not f.done()]
        # resend ops whose target moved (Objecter resend-on-map-change)
        for op in list(self._ops.values()):
            if op.msg.oid and op.msg.pgid[0] in self.osdmap.pools:
                op.msg.pgid = self.osdmap.object_to_pg(
                    op.msg.pgid[0], op.msg.oid)
            new_target = self._calc_target(op.msg.pgid)
            if new_target != op.target and new_target >= 0:
                op.target = new_target
                op.msg.epoch = self.osdmap.epoch
                asyncio.get_running_loop().create_task(
                    self._send_op(op)
                )

    def _backoff(self, attempts: int) -> float:
        """Bounded exponential backoff with jitter for the resend
        loops (the reference osd_backoff / Objecter retry discipline):
        base * 2^attempts capped at the max, scaled by uniform
        [0.5, 1.0) so a thundering herd of bounced clients de-phases."""
        base = float(self.conf["client_backoff_base"])
        cap = float(self.conf["client_backoff_max"])
        d = min(cap, base * (1 << min(max(attempts, 0), 16)))
        return d * (0.5 + 0.5 * self._backoff_rng.random())

    async def _handle_reply(self, msg: M.MOSDOpReply) -> None:
        op = self._ops.get(msg.tid)
        if op is None:
            return
        if msg.result == M.ESTALE or msg.result == M.EAGAIN:
            # refresh the map, recalc, resend (with a retry cap)
            op.last_result = msg.result
            op.attempts += 1
            self.op_retries += 1
            if op.attempts > 20:
                del self._ops[msg.tid]
                if not op.fut.done():
                    op.fut.set_exception(
                        IOError(f"op {msg.tid} failed after retries")
                    )
                return
            try:
                await self._mon_send(
                    M.MMonGetMap(
                        have=self.osdmap.epoch if self.osdmap else 0),
                    deadline_s=1.0,
                )
            except Exception:
                pass  # keep resending on whatever map we have
            await asyncio.sleep(self._backoff(op.attempts - 1))
            if op.msg.oid:
                # re-hash: a pg_num change may have moved the object
                # to a different (split child) PG
                op.msg.pgid = self.osdmap.object_to_pg(
                    op.msg.pgid[0], op.msg.oid)
            # a remap storm bounces MANY ops at once — their re-lookups
            # coalesce on the resolver window like fresh submissions
            op.target = await self._acalc_target(op.msg.pgid)
            if op.target >= 0:
                op.msg.epoch = self.osdmap.epoch
                await self._send_op(op)
            return
        del self._ops[msg.tid]
        if not op.fut.done():
            op.fut.set_result(msg)

    # ------------------------------------------------------------- engine

    def _calc_target(self, pgid) -> int:
        """Sync target calc (map-change resend sweeps): memo hit or an
        immediate host resolve — never blocks on the batch window."""
        _up, primary = self._placement.up_acting(self.osdmap, pgid)
        return primary

    async def _acalc_target(self, pgid) -> int:
        """Async target calc for the op path: cache misses park on the
        resolver's coalescing window so a swarm of concurrent ops (or
        a remap storm's resends) resolves placement as ONE device
        bulk-CRUSH dispatch instead of per-op host straw2."""
        _up, primary = await self._placement.aup_acting(self.osdmap,
                                                        pgid)
        return primary

    def placement_stats(self) -> dict[str, int]:
        """The resolver's counter block (bench/swarm evidence)."""
        return self._placement.stats.dump()

    async def resolve_targets(self, pool_id: int, names) -> list[int]:
        """Batch-resolve the primaries for many object names in ONE
        coalesced placement lookup (the osdc striped fan-out prefetch:
        a striped op touching N objects warms all N targets with one
        device dispatch before the sub-ops go out). Names are raw oids
        — namespace-folding callers fold before calling."""
        if self.osdmap is None or pool_id not in self.osdmap.pools:
            await self._wait_pool(pool_id)
        pgids = [self.osdmap.object_to_pg(
            pool_id, n.encode() if isinstance(n, str) else bytes(n))
            for n in names]
        outs = await asyncio.gather(*(
            self._placement.aup_acting(self.osdmap, pg)
            for pg in pgids))
        return [primary for _up, primary in outs]

    async def _send_op(self, op: _InFlight) -> None:
        try:
            await self.bus.send(self.name, f"osd.{op.target}", op.msg)
        except Exception:
            pass  # wait for a map change to resend

    async def _wait_pool(self, pool_id: int) -> None:
        """The map may lag (a mon failover moves the subscriber set):
        fetch until the pool appears — the Objecter's maps-on-demand
        stance — rather than failing on a stale map."""
        deadline = asyncio.get_running_loop().time() + self.op_timeout
        while (self.osdmap is None
               or pool_id not in self.osdmap.pools):
            if asyncio.get_running_loop().time() > deadline:
                raise KeyError(f"pool {pool_id} not in map")
            try:
                await self._mon_send(
                    M.MMonGetMap(
                        have=self.osdmap.epoch if self.osdmap else 0
                    ),
                    deadline_s=0.01,
                )
            except Exception:
                pass
            await asyncio.sleep(0.05)

    async def _submit_pg(self, pgid, oid: bytes, ops: list[tuple],
                         snapc=None, snapid=None) -> M.MOSDOpReply:
        """Track + send one op vector to a PG's primary and await the
        reply (shared by object ops and PG-level ops like pgls).
        ``snapc`` is a write SnapContext (seq, [snaps desc]); ``snapid``
        the snap a read resolves at (None = head)."""
        from .snaps import NOSNAP

        self._tid += 1
        tid = self._tid
        verb = ops[0][0] if ops else "noop"
        seq, snap_list = snapc if snapc else (0, [])
        with self._tracer.start_span(verb) as span:
            span.tag("pgid", pgid).tag("oid",
                                       oid[:64].decode(errors="replace"))
            # placement FIRST (batched: concurrent ops' misses share
            # one device dispatch), then stamp the epoch — the window
            # may have spanned a map change and the op must carry the
            # epoch its target was computed on
            target = await self._acalc_target(pgid)
            msg = M.MOSDOp(tid=tid, pgid=pgid, oid=oid, ops=ops,
                           epoch=self.osdmap.epoch, trace=span.ctx,
                           snap_seq=seq, snaps=list(snap_list),
                           snapid=NOSNAP if snapid is None else snapid)
            op = _InFlight(msg=msg, fut=asyncio.get_running_loop()
                           .create_future())
            self._ops[tid] = op
            op.target = target
            span.tag("target", op.target)
            if op.target >= 0:
                await self._send_op(op)
            # tick-resend while waiting (Objecter op-tracking role): a
            # message written into a half-dead TCP connection (peer
            # kill -9, RST not yet seen) is lost silently — the resend
            # re-dials a fresh connection to the revived daemon. The
            # tick grows exponentially with jitter (bounded by
            # client_backoff_max): under a partition every waiting
            # client would otherwise hammer the dead primary in phase.
            loop = asyncio.get_running_loop()
            deadline = loop.time() + self.op_timeout
            # first tick stays lazy (a healthy op slower than the tick
            # would be re-sent for nothing — dedup'd, but only after a
            # full re-delivery); later ticks grow toward the cap. The
            # configured ceiling really is the hard cap: op_timeout
            # scales the lazy floor only BELOW it, so a long-deadline
            # client (the thrasher sets op_timeout to the whole
            # thrash+settle horizon) still re-probes a healed partition
            # within client_backoff_max, not op_timeout/8
            cap = float(self.conf["client_backoff_max"])
            floor = max(0.5, min(self.op_timeout / 8, cap))
            ceil = max(cap, floor)
            resends = 0
            while True:
                left = deadline - loop.time()
                if left <= 0:
                    self._ops.pop(tid, None)
                    if op.last_result:
                        # the op DID execute and kept failing: that is
                        # an IO error, not a lost message
                        raise IOError(
                            f"op {tid} ({verb}) failed after "
                            f"{op.attempts} retries (last result "
                            f"{op.last_result})")
                    raise asyncio.TimeoutError(
                        f"op {tid} ({verb}) timed out")
                # upward jitter de-phases the herd without dipping
                # below the lazy floor; the configured ceiling is a
                # hard cap, jitter included
                tick = min(ceil, floor * (1 << min(resends, 16))
                           * (1.0 + 0.5 * self._backoff_rng.random()))
                try:
                    # shield: a tick timeout must NOT cancel the
                    # pending future (the reply may still arrive)
                    reply = await asyncio.wait_for(
                        asyncio.shield(op.fut), min(tick, left))
                    break
                except asyncio.TimeoutError:
                    resends += 1
                    self.op_retries += 1
                    op.target = self._calc_target(op.msg.pgid)
                    if op.target >= 0:
                        op.msg.epoch = self.osdmap.epoch
                        await self._send_op(op)
            span.tag("result", reply.result)
        return reply

    async def _submit(self, pool_id: int, name: str | bytes,
                      ops: list[tuple], snapc=None,
                      snapid=None) -> M.MOSDOpReply:
        if self.osdmap is None or pool_id not in self.osdmap.pools:
            await self._wait_pool(pool_id)
        pool = self.osdmap.pools[pool_id]
        if pool.full and any(o[0] in _WRITE_VERBS
                             and o[0] not in _FULL_OK_VERBS
                             for o in ops):
            # pool quota reached (FLAG_FULL_QUOTA): fail writes with
            # EDQUOT; reclaiming verbs ride through (FULL_TRY)
            raise RadosError(M.EDQUOT,
                             f"pool '{pool.name}' quota reached")
        oid = name.encode() if isinstance(name, str) else bytes(name)
        pgid = self.osdmap.object_to_pg(pool_id, oid)
        reply = await self._submit_pg(pgid, oid, ops, snapc=snapc,
                                      snapid=snapid)
        if reply.result != M.OK:
            if reply.result == M.ENOENT:
                raise KeyError(name)
            if reply.result == M.EBLOCKLISTED:
                # this client entity is fenced (its exclusive lock was
                # stolen after it went unresponsive): fail everything
                # loudly, never retry (librados EBLOCKLISTED contract)
                raise ConnectionAbortedError(
                    f"client {self.name} is blocklisted")
            raise RadosError(reply.result)
        return reply

    async def operate(self, pool_id: int, name,
                      op: "ObjectOperation") -> list[bytes]:
        """Execute a compound ObjectOperation atomically on one object
        (IoCtxImpl::operate role); returns each op's output bytes."""
        reply = await self._submit(pool_id, name, op.ops)
        return [bytes(d) for _r, d in reply.outs]

    # ------------------------------------------------------ aio window

    def _window_budget(self) -> int:
        return max(1, int(self.conf["client_max_inflight"]))

    async def writes_begin(self) -> None:
        """Claim one window slot, blocking while client_max_inflight
        ops are already in flight (Objecter::_take_op_budget role).
        The blocking IS the backpressure: a submitter pushing faster
        than the cluster drains parks here, never grows unbounded."""
        loop = asyncio.get_running_loop()
        while self._aio_inflight >= self._window_budget():
            fut = loop.create_future()
            self._aio_waiters.append(fut)
            try:
                await fut
            except asyncio.CancelledError:
                if fut.done() and not fut.cancelled():
                    # this waiter consumed a slot wakeup it will never
                    # use: hand it to the next parked submitter or the
                    # free slot is lost and the window wedges (the
                    # asyncio.Semaphore lost-wakeup hazard)
                    for w in self._aio_waiters:
                        if w is not fut and not w.done():
                            w.set_result(None)
                            break
                raise
            finally:
                if fut in self._aio_waiters:
                    self._aio_waiters.remove(fut)
        self._aio_inflight += 1
        s = self.window_stats
        s["sum"] += self._aio_inflight
        s["count"] += 1
        if self._aio_inflight > s["max"]:
            s["max"] = self._aio_inflight

    def _writes_end(self) -> None:
        self._aio_inflight -= 1
        for fut in self._aio_waiters:
            if not fut.done():
                fut.set_result(None)
                break  # one freed slot wakes one submitter
        if self._aio_inflight == 0:
            for fut in self._aio_idle:
                if not fut.done():
                    fut.set_result(None)
            self._aio_idle.clear()

    async def writes_wait(self) -> None:
        """Drain the window: return once every aio op submitted so far
        has completed (librados aio_flush role). Individual failures
        stay on their completions — a barrier must not eat them."""
        if self._aio_inflight == 0:
            return
        fut = asyncio.get_running_loop().create_future()
        self._aio_idle.append(fut)
        await fut

    async def aio_submit(self, pool_id: int, name, ops: list[tuple],
                         snapc=None, snapid=None) -> Completion:
        """Submit one op vector into the in-flight window and return a
        Completion instead of awaiting the reply. The full per-op
        machinery — target calc, tick-resend, ESTALE/EAGAIN backoff —
        runs unchanged inside the window (each op rides _submit); ops
        on the same object are chained so they execute, and complete,
        in submission order."""
        await self.writes_begin()
        oid = name.encode() if isinstance(name, str) else bytes(name)
        key = (pool_id, oid)
        prev = self._obj_tail.get(key)
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        # completions dropped without a wait() must not spam the loop's
        # "exception never retrieved" warning — the op's failure is
        # still observable via wait()/result()
        fut.add_done_callback(
            lambda f: f.exception() if not f.cancelled() else None)
        self._obj_tail[key] = fut
        task = loop.create_task(
            self._aio_drive(pool_id, name, ops, snapc, snapid, prev,
                            fut, key))
        self._aio_tasks.add(task)
        task.add_done_callback(self._aio_tasks.discard)
        return Completion(fut)

    async def _aio_drive(self, pool_id: int, name, ops, snapc, snapid,
                         prev: asyncio.Future | None,
                         fut: asyncio.Future, key) -> None:
        try:
            if prev is not None and not prev.done():
                # per-object order: the previous op on this object must
                # finish (its failure is its own — this op still runs)
                try:
                    await asyncio.shield(prev)
                except Exception:
                    pass
            reply = await self._submit(pool_id, name, ops, snapc=snapc,
                                       snapid=snapid)
        except asyncio.CancelledError:
            if not fut.done():
                fut.cancel()
            raise
        except BaseException as e:
            if not fut.done():
                fut.set_exception(e)
        else:
            if not fut.done():
                fut.set_result(reply)
        finally:
            if self._obj_tail.get(key) is fut:
                del self._obj_tail[key]
            self._writes_end()

    async def aio_write_full(self, pool_id: int, name, data: bytes,
                             snapc=None) -> Completion:
        return await self.aio_submit(
            pool_id, name, [M.osd_op("writefull", data=data)],
            snapc=snapc)

    async def aio_write(self, pool_id: int, name, offset: int,
                        data: bytes, snapc=None) -> Completion:
        return await self.aio_submit(
            pool_id, name,
            [M.osd_op("write", offset=offset, data=data)],
            snapc=snapc)

    async def aio_append(self, pool_id: int, name, data: bytes,
                         snapc=None) -> Completion:
        return await self.aio_submit(
            pool_id, name, [M.osd_op("append", data=data)],
            snapc=snapc)

    async def aio_operate(self, pool_id: int, name,
                          op: "ObjectOperation") -> Completion:
        """Compound ObjectOperation through the window (the
        aio_operate role); wait() returns the reply whose outs carry
        each op's output bytes."""
        return await self.aio_submit(pool_id, name, op.ops)

    async def list_objects(self, pool_id: int) -> list[bytes]:
        """All object names in the pool via a concurrent PGLS sweep of
        every PG (the rados ls / librados NObjectIterator role)."""
        if self.osdmap is None or pool_id not in self.osdmap.pools:
            await self._wait_pool(pool_id)
        from ..utils import denc

        pool = self.osdmap.pools[pool_id]
        replies = await asyncio.gather(*(
            self._submit_pg((pool_id, ps), b"", [M.osd_op("pgls")])
            for ps in range(pool.pg_num)))
        names: list[bytes] = []
        for ps, reply in enumerate(replies):
            if reply.result != M.OK:
                raise IOError(f"pgls {(pool_id, ps)} failed: "
                              f"{reply.result}")
            oids, _ = denc.dec_list(reply.outs[0][1], 0, denc.dec_bytes)
            names.extend(oids)
        return sorted(names)

    # ------------------------------------------------------------ surface

    def ioctx(self, pool_id: int, nspace: str = "") -> "IoCtx":
        """Namespace-scoped view (rados_ioctx_set_namespace role)."""
        return IoCtx(self, pool_id, nspace)

    async def mon_command(self, cmd: dict | list,
                          ) -> tuple[int, str, bytes]:
        """Send one MonCommand (`ceph` CLI seam): cmd is the JSON
        object {"prefix": ..., args} or an argv list matched against
        the mon's descriptor table. Returns (rc, outs, outb)."""
        import json as _json

        if isinstance(cmd, list):
            from . import moncommands

            matched = moncommands.match_argv([str(w) for w in cmd])
            if matched is None:
                return (-22, f"no command matches {cmd!r}", b"")
            cmd = matched
        last_exc: Exception | None = None
        for _attempt in range(3):
            self._tid += 1
            tid = self._tid
            fut = asyncio.get_running_loop().create_future()
            self._snap_ops[tid] = fut
            try:
                await self._mon_send(
                    M.MMonCommand(tid=tid, cmd=_json.dumps(cmd)))
                reply = await asyncio.wait_for(fut, self.op_timeout)
                await self._await_epoch(reply.epoch)
                return reply.result, reply.outs, reply.outb
            except (asyncio.TimeoutError, IOError) as e:
                last_exc = e
            finally:
                self._snap_ops.pop(tid, None)
        raise IOError(f"mon command failed: {last_exc}")

    async def create_pool(self, pool: Pool) -> int:
        # retried whole: the mon's pool-create is idempotent by (id,
        # name), so a request or reply lost to a leader failover is
        # safely re-sent (MonClient resend-on-reconnect role). The
        # reply is awaited on a tid-keyed future — a generic map-update
        # future could be resolved by any unrelated commit and hand
        # back a stale pool id.
        last_exc: Exception | None = None
        for _attempt in range(3):
            self._tid += 1
            tid = self._tid
            fut = asyncio.get_running_loop().create_future()
            self._snap_ops[tid] = fut
            try:
                await self._mon_send(
                    M.MPoolCreate(pool=menc._enc_pool(pool), tid=tid))
                reply = await asyncio.wait_for(fut, self.op_timeout)
                if getattr(reply, "result", M.OK) != M.OK:
                    # a same-name pool exists with a DIFFERENT spec:
                    # not retryable, the caller's spec was not applied
                    raise FileExistsError(
                        f"pool {pool.name!r} exists with a different "
                        f"spec (result {reply.result})")
                await self._await_epoch(reply.epoch)
                return reply.pool_id
            except FileExistsError:
                raise  # spec conflict is final, never retried
            except (asyncio.TimeoutError, IOError) as e:
                last_exc = e
            finally:
                self._snap_ops.pop(tid, None)
        raise IOError(f"pool create failed: {last_exc}")

    async def write_full(self, pool_id: int, name, data: bytes,
                         snapc=None) -> None:
        await self._submit(pool_id, name,
                           [M.osd_op("writefull", data=data)],
                           snapc=snapc)

    async def write(self, pool_id: int, name, offset: int,
                    data: bytes, snapc=None) -> None:
        await self._submit(
            pool_id, name,
            [M.osd_op("write", offset=offset, data=data)],
            snapc=snapc,
        )

    async def append(self, pool_id: int, name, data: bytes,
                     snapc=None) -> None:
        await self._submit(pool_id, name,
                           [M.osd_op("append", data=data)],
                           snapc=snapc)

    async def truncate(self, pool_id: int, name, size: int,
                       snapc=None) -> None:
        await self._submit(pool_id, name,
                           [M.osd_op("truncate", offset=size)],
                           snapc=snapc)

    async def zero(self, pool_id: int, name, offset: int,
                   length: int, snapc=None) -> None:
        await self._submit(
            pool_id, name,
            [M.osd_op("zero", offset=offset, length=length)],
            snapc=snapc,
        )

    async def read(self, pool_id: int, name, offset: int = 0,
                   length: int = -1, snapid=None) -> bytes:
        reply = await self._submit(
            pool_id, name,
            [M.osd_op("read", offset=offset, length=length)],
            snapid=snapid,
        )
        # client API boundary: read payloads may arrive as views (wire
        # tier); bytes() is the identity on the LocalBus zero-copy path
        return bytes(reply.outs[0][1])

    async def stat(self, pool_id: int, name, snapid=None) -> int:
        reply = await self._submit(pool_id, name, [M.osd_op("stat")],
                                   snapid=snapid)
        from ..utils import denc

        return denc.dec_u64(reply.outs[0][1], 0)[0]

    async def delete(self, pool_id: int, name, snapc=None) -> None:
        await self._submit(pool_id, name, [M.osd_op("delete")],
                           snapc=snapc)

    # ------------------------------------------------- selfmanaged snaps

    async def selfmanaged_snap_create(self, pool_id: int) -> int:
        """Allocate a new snap id from the mon (bumps pool snap_seq;
        the librados selfmanaged_snap_create role). The caller owns the
        SnapContext it builds from returned ids."""
        reply = await self._pool_snap_op(pool_id, "create", 0)
        return reply.snapid

    async def selfmanaged_snap_remove(self, pool_id: int,
                                      snapid: int) -> None:
        """Mark a snap removed; OSDs trim clone data for it on the next
        map epoch (librados selfmanaged_snap_remove role)."""
        await self._pool_snap_op(pool_id, "remove", snapid)

    async def blocklist_add(self, entity: str) -> None:
        """Fence a client entity cluster-wide (`ceph osd blocklist add`
        role); waits for the committed epoch so the fence is live."""
        await self._mon_pool_op(
            lambda tid: M.MBlocklist(entity=entity, op="add", tid=tid),
            f"blocklist add {entity}")

    async def blocklist_rm(self, entity: str) -> None:
        await self._mon_pool_op(
            lambda tid: M.MBlocklist(entity=entity, op="rm", tid=tid),
            f"blocklist rm {entity}")

    async def set_pool_param(self, pool_id: int, key: str,
                             value: int) -> None:
        """Live pool change (`ceph osd pool set` role): key "pg_num"
        grows PG count (collection split on the OSDs, pow2 only);
        "pgp_num" re-places the children. Waits for the map epoch."""
        await self._mon_pool_op(
            lambda tid: M.MPoolSet(pool_id=pool_id, key=key,
                                   value=value, tid=tid),
            f"pool set {key}={value}",
        )

    async def _mon_pool_op(self, make_msg, what: str):
        """One tracked mon round-trip: send, await the tid-matched
        reply, raise on error, wait for the committed map epoch."""
        self._tid += 1
        tid = self._tid
        fut = asyncio.get_running_loop().create_future()
        self._snap_ops[tid] = fut
        try:
            await self._mon_send(make_msg(tid))
            reply = await asyncio.wait_for(fut, self.op_timeout)
        finally:
            self._snap_ops.pop(tid, None)
        if reply.result != M.OK:
            raise IOError(f"{what} failed: {reply.result}")
        await self._await_epoch(reply.epoch)
        return reply

    async def _await_epoch(self, epoch: int) -> None:
        deadline = asyncio.get_running_loop().time() + self.op_timeout
        while self.osdmap is None or self.osdmap.epoch < epoch:
            if asyncio.get_running_loop().time() > deadline:
                break
            try:
                await self._mon_send(
                    M.MMonGetMap(
                        have=self.osdmap.epoch if self.osdmap else 0),
                    deadline_s=0.01,
                )
            except Exception:
                pass
            await asyncio.sleep(0.02)

    async def _pool_snap_op(self, pool_id: int, op: str,
                            snapid: int) -> "M.MPoolSnapReply":
        # the epoch wait matters here: subsequent writes must carry a
        # SnapContext the OSDs consider current
        return await self._mon_pool_op(
            lambda tid: M.MPoolSnapOp(pool_id=pool_id, op=op,
                                      snapid=snapid, tid=tid),
            f"pool snap op {op}",
        )

    async def getxattr(self, pool_id: int, name, key: str) -> bytes:
        reply = await self._submit(
            pool_id, name, [M.osd_op("getxattr", key=key.encode())]
        )
        return bytes(reply.outs[0][1])

    async def setxattr(self, pool_id: int, name, key: str,
                       value: bytes) -> None:
        await self._submit(
            pool_id, name,
            [M.osd_op("setxattr", key=key.encode(), data=bytes(value))],
        )

    async def rmxattr(self, pool_id: int, name, key: str) -> None:
        await self._submit(pool_id, name,
                           [M.osd_op("rmxattr", key=key.encode())])

    async def getxattrs(self, pool_id: int, name) -> dict[str, bytes]:
        from ..utils import denc

        reply = await self._submit(pool_id, name,
                                   [M.osd_op("getxattrs")])
        return denc.dec_map(reply.outs[0][1], 0, denc.dec_str,
                            denc.dec_bytes)[0]

    async def omap_set(self, pool_id: int, name,
                       kv: dict[bytes, bytes]) -> None:
        await self._submit(pool_id, name,
                           [M.osd_op("omap_setkeys", kv=kv)])

    async def omap_get(self, pool_id: int, name) -> dict[bytes, bytes]:
        from ..utils import denc

        reply = await self._submit(pool_id, name, [M.osd_op("omap_get")])
        return denc.dec_map(reply.outs[0][1], 0, denc.dec_bytes,
                            denc.dec_bytes)[0]

    async def omap_rm(self, pool_id: int, name, keys) -> None:
        await self._submit(
            pool_id, name,
            [M.osd_op("omap_rmkeys", keys=[bytes(k) for k in keys])],
        )

    async def watch(self, pool_id: int, name, callback) -> int:
        """Register interest in an object (librados watch role):
        callback(oid, notify_id, payload) fires on every notify.
        Watch state lives with the primary; re-watch after a primary
        failover (the reference's client re-registers on timeout)."""
        self._next_cookie += 1
        cookie = self._next_cookie
        oid = name.encode() if isinstance(name, str) else bytes(name)
        await self._submit(
            pool_id, name,
            [M.osd_op("watch", offset=cookie, length=1)],
        )
        self._watches[(oid, cookie)] = callback
        return cookie

    async def unwatch(self, pool_id: int, name, cookie: int) -> None:
        oid = name.encode() if isinstance(name, str) else bytes(name)
        self._watches.pop((oid, cookie), None)
        await self._submit(
            pool_id, name,
            [M.osd_op("watch", offset=cookie, length=0)],
        )

    async def notify(self, pool_id: int, name,
                     payload: bytes = b"") -> int:
        """Fan a notification out to every watcher; returns the notify
        id (librados notify role, fire-and-forget acks)."""
        reply = await self._submit(
            pool_id, name,
            [M.osd_op("notify", data=payload)],
        )
        from ..utils import denc

        return denc.dec_u64(reply.outs[0][1], 0)[0]

    async def execute(self, pool_id: int, name, cls: str, method: str,
                      inp: bytes = b"") -> bytes:
        """Run a server-side object class method (rados_exec role)."""
        reply = await self._submit(
            pool_id, name,
            [M.osd_op("call", key=f"{cls}.{method}".encode(),
                      data=bytes(inp))],
        )
        return bytes(reply.outs[0][1])


class ObjectOperation:
    """Compound-op builder (ObjectWriteOperation/ObjectReadOperation
    role, src/include/rados/librados.hpp): chain ops, execute with
    RadosClient.operate — all-or-nothing on one object."""

    def __init__(self) -> None:
        self.ops: list[tuple] = []

    def _add(self, *a, **kw) -> "ObjectOperation":
        self.ops.append(M.osd_op(*a, **kw))
        return self

    def create(self, exclusive: bool = True):
        return self._add("create", length=0 if exclusive else 1)

    def write_full(self, data: bytes):
        return self._add("writefull", data=data)

    def write(self, offset: int, data: bytes):
        return self._add("write", offset=offset, data=data)

    def append(self, data: bytes):
        return self._add("append", data=data)

    def truncate(self, size: int):
        return self._add("truncate", offset=size)

    def zero(self, offset: int, length: int):
        return self._add("zero", offset=offset, length=length)

    def remove(self):
        return self._add("delete")

    def setxattr(self, key: str, value: bytes):
        return self._add("setxattr", key=key.encode(),
                         data=bytes(value))

    def rmxattr(self, key: str):
        return self._add("rmxattr", key=key.encode())

    def omap_set(self, kv: dict[bytes, bytes]):
        return self._add("omap_setkeys", kv=kv)

    def omap_rm_keys(self, keys):
        return self._add("omap_rmkeys", keys=[bytes(k) for k in keys])

    def omap_set_header(self, header: bytes):
        return self._add("omap_setheader", data=bytes(header))

    def omap_clear(self):
        return self._add("omap_clear")

    def read(self, offset: int = 0, length: int = -1):
        return self._add("read", offset=offset, length=length)

    def stat(self):
        return self._add("stat")

    def getxattr(self, key: str):
        return self._add("getxattr", key=key.encode())

    def getxattrs(self):
        return self._add("getxattrs")

    def omap_get(self):
        return self._add("omap_get")

    def omap_get_header(self):
        return self._add("omap_getheader")

    def omap_get_keys(self):
        return self._add("omap_getkeys")

    def call(self, cls: str, method: str, inp: bytes = b""):
        """Server-side class method inside the compound op
        (ObjectOperation::exec role)."""
        return self._add("call", key=f"{cls}.{method}".encode(),
                         data=bytes(inp))


# ------------------------------------------------------------ namespaces
#
# RADOS object namespaces (rados_ioctx_set_namespace role): an IoCtx
# scopes every object name to (pool, namespace). The reference carries
# the nspace as a separate hobject_t field end to end; here the
# namespace is folded into the oid with a length-prefixed header under
# one reserved lead byte, so the whole PG/store/recovery path stays
# untouched. The cost of that simplification: names in the DEFAULT
# namespace may not begin with the reserved byte (EINVAL, documented
# divergence — the reference allows any bytes anywhere).

NS_LEAD = b"\x1e"


def ns_oid(nspace: str, name: str | bytes) -> bytes:
    """Fold (namespace, name) into a wire/store oid."""
    raw = name.encode() if isinstance(name, str) else bytes(name)
    if not nspace:
        if raw.startswith(NS_LEAD):
            raise ValueError(
                "names in the default namespace must not start with "
                "0x1e (reserved for namespace-folded oids)")
        return raw
    return NS_LEAD + denc.enc_str(nspace) + raw


def split_ns(oid: bytes) -> tuple[str, bytes]:
    """Inverse of ns_oid: oid -> (namespace, bare name)."""
    if not oid.startswith(NS_LEAD):
        return "", oid
    ns, off = denc.dec_str(oid, 1)
    return ns, oid[off:]


#: RadosClient methods whose second positional argument is an object
#: name the IoCtx must scope
_NAME_METHODS = frozenset((
    "write_full", "write", "append", "truncate", "zero", "read",
    "stat", "delete", "operate", "getxattr", "setxattr", "rmxattr",
    "getxattrs", "omap_set", "omap_get", "omap_rm", "watch",
    "unwatch", "notify", "execute",
    "aio_submit", "aio_write_full", "aio_write", "aio_append",
    "aio_operate",
))


class IoCtx:
    """Namespace-scoped view of a RadosClient (librados IoCtx +
    set_namespace role). Mirrors the client surface; object names are
    folded into the namespace transparently, and listings are filtered
    to the namespace (LIBRADOS_ALL_NSPACES via ``all_nspaces=True``)."""

    def __init__(self, client: "RadosClient", pool_id: int,
                 nspace: str = ""):
        self._client = client
        self.pool_id = pool_id
        self.nspace = nspace

    def __getattr__(self, attr):
        fn = getattr(self._client, attr)
        if attr not in _NAME_METHODS:
            return fn
        ns = self.nspace

        @functools.wraps(fn)
        async def scoped(pool_id, name, *a, **kw):
            return await fn(pool_id, ns_oid(ns, name), *a, **kw)

        return scoped

    def ioctx(self, pool_id: int, nspace: str = "") -> "IoCtx":
        return IoCtx(self._client, pool_id, nspace)

    async def list_objects(self, pool_id: int,
                           all_nspaces: bool = False) -> list[bytes]:
        """Bare names in this IoCtx's namespace; ``all_nspaces``
        returns raw folded oids across every namespace."""
        raw = await self._client.list_objects(pool_id)
        if all_nspaces:
            return raw
        out = []
        for oid in raw:
            ns, bare = split_ns(oid)
            if ns == self.nspace:
                out.append(bare)
        return out

    async def list_namespaces(self, pool_id: int) -> list[str]:
        """Distinct namespaces with at least one object (the
        rados_nobjects_list ALL_NSPACES sweep)."""
        seen = {split_ns(o)[0]
                for o in await self._client.list_objects(pool_id)}
        return sorted(seen)
