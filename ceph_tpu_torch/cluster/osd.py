"""OSDLite: the data daemon (src/osd/OSD.cc role, asyncio single-reactor).

Boot -> mon admission -> map subscription -> PG instantiation from the
map (and from on-disk collections after restart) -> dispatch of client
ops / sub-ops / peering traffic to PGs. Heartbeats flow OSD->mon; send
failures to peers are reported as MFailure (the send_failures ->
prepare_failure arc, OSD.cc:7099, OSDMonitor.cc:3325).

The ECBatcher (cluster/ecbatch.py) is the TPU-native heart of the write
path: EC stripes submitted across reactor ticks coalesce into ONE
batched device dispatch per bucket (fused encode+CRC over (B, k, W)
uint32, size-target/deadline/fast-flush policy), which is how the
framework amortizes host<->device latency that a per-stripe codec call
(the reference's jerasure path) cannot. The op worker dispatches up to
osd_op_concurrency ops from the mClock queue concurrently so stripes
from different client ops can meet in the same batch.

ceph_tpu_torch's own copy of ``ceph_tpu/cluster/osd.py``. ``device``
(new, last) is where the OSD's EC codecs, its placement resolver and
scrub's device digests run: the CUDA card unless the caller names
another; with none named and no card, construction raises.
"""
from __future__ import annotations

import asyncio
import os
import sys
import time
import traceback

from ..device import resolve
from ..ec import load_codec
from ..placement import encoding as menc
from ..placement.resolver import PlacementResolver
from ..store import transaction as tx_mod
from ..store.memstore import MemStore
from ..utils import config as cfg
from ..utils.admin import AdminSocket
from ..utils import trace
from ..utils.fault import FaultInjector
from ..utils.perf import PerfCounters
from . import messages as M
from .ecbatch import ECBatcher  # noqa: F401  (re-export: the public seam)
from .optracker import OpTracker
from .pg import NONE, PG
from .scheduler import CLIENT, RECOVERY, SCRUB, MClockScheduler, Throttle


def _op_bytes(msg) -> int:
    """Payload bytes of an op vector (throttle accounting)."""
    return sum(len(o[4]) for o in msg.ops)


class OSDLite:
    def __init__(
        self,
        bus,
        osd_id: int,
        store=None,
        hb_interval: float | None = None,
        subop_timeout: float | None = None,
        log_keep: int | None = None,
        conf: cfg.ConfigProxy | None = None,
        device=None,
    ):
        self.bus = bus
        self.id = osd_id
        self.name = f"osd.{osd_id}"
        self.device = resolve(device)
        self.conf = conf if conf is not None else cfg.proxy()
        self.store = store if store is not None else MemStore()
        self.osdmap = None
        self.pgs: dict[tuple[int, int, int], PG] = {}  # (pool, ps, shard)
        # explicit args win over config (tests pass them directly); the
        # config path is what a deployed daemon uses
        self.hb_interval = (hb_interval if hb_interval is not None
                            else self.conf["osd_heartbeat_interval"])
        self.subop_timeout = (subop_timeout if subop_timeout is not None
                              else self.conf["osd_subop_timeout"])
        self.log_keep = (log_keep if log_keep is not None
                         else self.conf["osd_pg_log_keep"])
        self.conf.observe("osd_heartbeat_interval",
                          lambda _n, v: setattr(self, "hb_interval", v))
        self.conf.observe("osd_subop_timeout",
                          lambda _n, v: setattr(self, "subop_timeout", v))
        self.fault = FaultInjector()
        self.perf = PerfCounters(self.name)
        self._declare_counters()
        # every injection surfaces as a faults_injected_<site> counter
        # (declared lazily: sites are an open set)
        self.fault.on_fire = self._count_injection
        # recovery/backfill concurrency bounds (AsyncReserver role,
        # src/common/AsyncReserver.h + osd_max_backfills): LOCAL slots
        # gate this OSD's own recovery work as a primary; REMOTE slots
        # gate the inbound backfills it serves as a target
        from .reserver import AsyncReserver

        nbf = self.conf["osd_max_backfills"]
        self.local_reserver = AsyncReserver(nbf)
        self.remote_reserver = AsyncReserver(nbf)
        self.conf.observe(
            "osd_max_backfills",
            lambda _n, v: (self.local_reserver.set_max(v),
                           self.remote_reserver.set_max(v)))
        #: per-epoch placement cache (the daemon's map only moves by
        #: epochs, so memoizing pg->up/acting is safe here); the
        #: daemon uses the resolver's SYNC surface — hits are a dict
        #: read, misses resolve host-side inline — and shares the
        #: serving plane's counter block
        self.placement = PlacementResolver(conf=self.conf,
                                           device=self.device)
        self.admin: AdminSocket | None = None
        # QoS between client / recovery / scrub traffic (mClock role)
        self.op_scheduler = MClockScheduler()
        #: mClock tenant classes: client-name prefix -> scheduler
        #: class (the swarm harness's QoS isolation seam — a bulk
        #: tenant and a latency tenant land in different dmClock
        #: classes on the SAME daemon); unmatched entities ride CLIENT
        self.qos_tenants: dict[str, str] = {}
        #: client write ops currently waiting on a PG lock (see
        #: pg.do_op): they cannot contribute EC stripes until the
        #: holder's batch flushes, so the batcher's idle probe counts
        #: them as already-accounted-for rather than as "more coming"
        self.op_lock_waiters = 0
        # the coalescing EC dispatcher; the idle probe is what makes its
        # fast-flush mClock-aware — when the mClock queue is empty AND
        # every in-flight client op is either parked on a batcher
        # future or blocked behind one on a PG lock, nothing else can
        # contribute stripes, so waiting out the window would be pure
        # added latency for the parked ops
        self.ec_batcher = ECBatcher(
            self.perf, conf=self.conf,
            idle_probe=lambda: (
                len(self.op_scheduler) == 0
                and len(self.optracker.in_flight)
                <= self.ec_batcher.parked() + self.op_lock_waiters),
            fault=self.fault)
        self.throttle = Throttle(self.conf["osd_client_message_size_cap"])
        self.optracker = OpTracker()
        self.tracer = trace.get_tracer(self.name)
        self.pending: dict = {}  # key -> Future (sub-op replies)
        # sub-op tids carry an incarnation nonce in the high bits (the
        # same trick the client's reqid tids use): a revived OSD reuses
        # its entity NAME on the bus, so a late reply addressed to the
        # dead incarnation would otherwise resolve the new one's
        # counter-colliding wait — an all-ack spoofed by ghosts
        # (thrash-found: a write "acked" with zero remote applies)
        import secrets

        self._subtid = secrets.randbits(31) << 32
        # per-peer sub-op latency EWMA (cluster/hedge.py): observed on
        # every await_reply, it keys the hedge delay of the straggler-
        # proof EC read fan-outs
        from .hedge import PeerLatencyEWMA

        self.peer_ewma = PeerLatencyEWMA(conf=self.conf)
        self._codecs: dict[int, object] = {}
        self._sinfos: dict[int, object] = {}
        #: pool id -> removed_snaps intervals already trimmed by this OSD
        self._trimmed_snaps: dict[int, list[tuple[int, int]]] = {}
        #: pool id -> pg_num last seen (detects split transitions)
        self._pool_pg_num: dict[int, int] = {}
        self._hb_task: asyncio.Task | None = None
        self._worker_tasks: list[asyncio.Task] = []
        self._tasks: set[asyncio.Task] = set()
        self.stopped = False
        self._pool_stats_ts = 0.0
        self._pool_stats_cache: dict[str, list[int]] = {}

    def _declare_counters(self) -> None:
        """The l_osd_* counter set (src/osd/osd_perf_counters.cc role,
        trimmed to what the lite daemon does)."""
        p = self.perf
        p.add_u64_counter("op", "client ops dispatched")
        p.add_u64_counter("op_r", "client reads")
        p.add_u64_counter("op_w", "client writes")
        p.add_time_avg("op_latency", "client op latency")
        p.add_u64_counter("subop_w", "replica/shard sub-writes applied")
        ECBatcher.declare_counters(p)
        p.add_u64_counter("recovery_pushes", "objects pushed to peers")
        p.add_u64_counter("recovery_unfound",
                          "objects skipped as unrecoverable")
        p.add_u64_counter("ec_read_crc_err",
                          "EC read-path hinfo CRC mismatches (rot)")
        p.add_u64_counter("ec_read_stale_shard",
                          "version-lagging shards excluded from EC "
                          "reads/reconstructs (ATTR_V cross-check)")
        p.add_u64_counter("ec_read_repairs",
                          "read-triggered shard repair rounds completed"
                          " (a CAS-miss skip counts: the copy moved on,"
                          " which also ends the repair)")
        p.add_u64_counter("ec_stray_reads",
                          "reconstructs that widened the candidate pool"
                          " to prior-interval stray shard copies")
        # straggler-proof dispatch ledger (cluster/hedge.py): the
        # invariant canceled == fired - won is what the thrash verdict
        # asserts — every launched hedge either completes (won) or is
        # cancelled, so the fan-outs can never leak tasks
        p.add_u64_counter("ec_hedges_fired",
                          "hedge sub-reads launched beyond the minimal"
                          " decode plan (d > k fan-outs)")
        p.add_u64_counter("ec_hedges_won",
                          "fired hedges that completed before the "
                          "fan-out resolved")
        p.add_u64_counter("ec_hedges_canceled",
                          "fired hedges cancelled as losers "
                          "(== fired - won)")
        p.add_u64_counter("ec_hedges_wasted_bytes",
                          "payload bytes of surplus hedge replies the "
                          "winning subset did not need")
        # repair economics (the metric degraded EC lives on): bytes
        # FETCHED from surviving shards per bytes REBUILT — k for an
        # MDS full decode, d/q for a Clay sub-chunk repair, the local
        # group size for LRC; their ratio is the repair-traffic
        # amplification bench config 9 reports per codec
        p.add_u64_counter("ec_repair_bytes_fetched",
                          "survivor bytes fetched to rebuild shards")
        p.add_u64_counter("ec_repair_bytes_rebuilt",
                          "shard bytes rebuilt from survivors")
        p.add_u64_counter("ec_repair_subchunk",
                          "shard rebuilds served by the sub-chunk "
                          "(regenerating-code) repair path")
        # vectorized-overlay evidence (the serving-plane RMW seam):
        # ONE staging materialization per EC write op, however many
        # stripes/extents it touches — calls ~= write ops is the proof
        # the per-stripe apply_range round-trip is gone
        p.add_u64_counter("ov_apply_calls",
                          "overlay->staging materializations (one per "
                          "EC RMW op, not per stripe)")
        p.add_u64_counter("ov_apply_extents",
                          "op extents scattered into EC staging")
        p.add_u64_counter("ov_apply_stripes",
                          "stripe columns covered by overlay scatters")
        p.add_u64_counter("scrubs", "scrub rounds executed")
        p.add_u64_counter("snap_trims", "objects snap-trimmed")
        p.add_u64_counter("pg_splits", "child PGs split from parents")
        p.add_u64_counter("pg_merges", "child PGs merged into parents")
        p.add_u64_counter("map_epochs", "osdmap epochs consumed")

    def _count_injection(self, site: str) -> None:
        """FaultInjector.on_fire hook: faults_injected_<site> counters,
        declared on first fire (sites are an open set)."""
        key = f"faults_injected_{site}"
        try:
            self.perf.inc(key)
        except KeyError:
            self.perf.add_u64_counter(key, f"injected {site} faults")
            self.perf.inc(key)

    # ----------------------------------------------------------- plumbing

    def spawn(self, coro) -> asyncio.Task:
        task = asyncio.get_running_loop().create_task(coro)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return task

    def log_exc(self, what: str) -> None:
        print(f"[{self.name}] {what}:", file=sys.stderr)
        traceback.print_exc()

    async def send(self, dst: str, msg) -> None:
        try:
            await self.bus.send(self.name, dst, msg)
        except Exception:
            if dst.startswith("osd."):
                # fast failure path: tell the mon this peer is unreachable
                try:
                    await self.bus.send(
                        self.name, "mon",
                        M.MFailure(target=int(dst[4:]), reporter=self.name),
                    )
                except Exception:
                    pass
            raise

    @property
    def epoch(self) -> int:
        """Map epoch, 0 before the first map arrives (a revived OSD can
        see peering traffic before its MOSDBoot round-trip completes)."""
        return self.osdmap.epoch if self.osdmap is not None else 0

    def new_subtid(self) -> int:
        self._subtid += 1
        return self._subtid

    def queue_txn(self, t) -> "asyncio.Future | None":
        """queue_transaction with an awaitable durability barrier:
        returns None when the store flushes inline (legacy shape —
        the call's return IS the barrier), else a future resolving
        when the transaction's commit group flushed. Any ack that
        implies durability to a peer or client (sub-write replies,
        the primary's own fan-out apply) MUST await it — replying out
        of the group-commit window would ack writes a crash can still
        lose."""
        if not self.store.commits_deferred():
            self.store.queue_transaction(t)
            return None
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        # on_commit fires on the committer's flusher thread
        self.store.queue_transaction(
            t, lambda: loop.call_soon_threadsafe(
                lambda: fut.done() or fut.set_result(None)))
        return fut

    async def txn_durable(self, fut: "asyncio.Future | None") -> None:
        """Await a queue_txn barrier (bounded like any sub-op wait: a
        store whose flush is wedged must fail the op, not hang it)."""
        if fut is not None:
            await asyncio.wait_for(fut, self.subop_timeout)

    def expect_reply(self, key) -> asyncio.Future:
        fut = asyncio.get_running_loop().create_future()
        self.pending[key] = fut
        return fut

    def drop_reply(self, key) -> None:
        self.pending.pop(key, None)

    def _resolve(self, key, value) -> None:
        fut = self.pending.pop(key, None)
        if fut is not None and not fut.done():
            fut.set_result(value)

    def hedge_enabled(self) -> bool:
        """Straggler-proof read fan-outs armed? (knob AND the
        CEPH_TPU_HEDGE env A/B lever — see cluster/hedge.py)."""
        from .hedge import hedge_enabled

        return hedge_enabled(self.conf)

    def hedge_delay(self, peers) -> float:
        """Hedge trigger delay for a fan-out planned on ``peers``."""
        return self.peer_ewma.hedge_delay(peers)

    async def await_reply(self, key, fut, target_osd: int):
        t0 = asyncio.get_running_loop().time()
        try:
            reply = await asyncio.wait_for(fut, self.subop_timeout)
            # feed the hedge-delay EWMA from every sub-op round-trip
            # (reads AND writes: the straggler signal is the peer's
            # service time, whatever the verb)
            self.peer_ewma.observe(
                target_osd, asyncio.get_running_loop().time() - t0)
            return reply
        except asyncio.TimeoutError:
            self.drop_reply(key)
            try:
                await self.bus.send(
                    self.name, "mon",
                    M.MFailure(target=target_osd, reporter=self.name),
                )
            except Exception:
                pass
            raise

    async def gather(self, waits) -> None:
        """Await sub-op acks: waits = [(osd, subtid, fut)]."""
        for osd, subtid, fut in waits:
            reply = await self.await_reply(subtid, fut, osd)
            if reply.result != M.OK:
                raise RuntimeError(
                    f"sub-op {subtid} on osd.{osd}: {reply.result}"
                )

    def codec_for(self, pool):
        codec = self._codecs.get(pool.id)
        if codec is None:
            codec = load_codec(dict(pool.ec_profile), device=self.device)
            self._codecs[pool.id] = codec
        return codec

    def sinfo_for(self, pool):
        """StripeInfo of an EC pool (stripe_unit from the profile,
        rounded to the codec's cell alignment)."""
        si = self._sinfos.get(pool.id)
        if si is None:
            from . import stripe as st

            codec = self.codec_for(pool)
            if not (getattr(codec, "bytewise_linear", False)
                    or getattr(codec, "cellwise_codeword", False)):
                # the striped RMW data path slices chunks into cells,
                # which is a valid codeword transform for bytewise
                # GF-matrix codes (rs_plugin, lrc) and for CELLWISE
                # codecs that treat every stripe_unit cell as an
                # independent codeword (bitmatrix packet rows, CLAY
                # sub-chunks); anything else would decode garbage
                raise ValueError(
                    f"EC profile {pool.ec_profile.get('plugin')!r} does "
                    "not support the striped data path (pool "
                    f"{pool.name!r}); use a reed-solomon matrix profile"
                )
            req = int(pool.ec_profile.get("stripe_unit",
                                          st.DEFAULT_STRIPE_UNIT))
            su = st.effective_stripe_unit(codec, req)
            si = st.StripeInfo(codec.k, codec.m, su)
            self._sinfos[pool.id] = si
        return si

    # ---------------------------------------------------------- lifecycle

    async def mon_send(self, msg, deadline_s: float = 5.0) -> None:
        """Hunting mon send (see cluster/monclient.py)."""
        from .monclient import mon_send

        await mon_send(self.bus, self.name, msg, deadline_s)

    async def _catchup_to(self, epoch: int,
                          timeout: float = 5.0) -> None:
        """Fetch maps until we reach ``epoch`` (bounded): the op that
        quoted it proceeds only on a map at least that new."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while self.epoch < epoch and loop.time() < deadline:
            try:
                await self.mon_send(M.MMonGetMap(have=self.epoch),
                                    deadline_s=1.0)
            except Exception:
                pass
            if self.epoch >= epoch:
                return
            await asyncio.sleep(0.02)

    async def start(self) -> None:
        self.stopped = False
        self.bus.register(self.name, self.handle)
        await self.mon_send(M.MOSDBoot(osd=self.id))
        self._hb_task = asyncio.get_running_loop().create_task(
            self._hb_loop()
        )
        # a small worker POOL (the ShardedOpWQ shard role): admission
        # order still comes from one mClock queue, but up to
        # osd_op_concurrency ops execute concurrently — which is what
        # lets EC stripes from different ops meet in one device batch.
        # Ordering contract: writes (and EC reads) serialize per-PG on
        # the PG lock; ops a client submits SEQUENTIALLY (awaiting each
        # reply) stay ordered trivially. Ops a client deliberately
        # submits concurrently against one object have no submission-
        # order guarantee (a pre-lock await like map catch-up can
        # reorder them) — each applies atomically and the reply order
        # matches the apply order, so the later-acked write wins, the
        # same contract concurrent submissions get from librados.
        nworkers = max(1, int(self.conf["osd_op_concurrency"]))
        self._worker_tasks = [
            asyncio.get_running_loop().create_task(self._op_worker())
            for _ in range(nworkers)
        ]

    async def _op_worker(self) -> None:
        """Drain the mClock queue (the ShardedOpWQ::_process role,
        OSD.cc:10859): each worker takes one scheduling decision at a
        time; QoS between classes is decided at dequeue."""
        while True:
            fn = await self.op_scheduler.get()
            try:
                await fn()
            except asyncio.CancelledError:
                raise
            except Exception:
                self.log_exc("op worker")

    async def _bench(self, count: int, size: int) -> dict:
        """Raw local-store write throughput, bypassing the cluster
        data path (the `ceph tell osd.N bench` role): N objects of
        ``size`` bytes into a scratch collection, removed afterwards.
        Size is clamped like osd_bench_max_block_size — an admin typo
        must not OOM the daemon. The scratch cid is unique per
        invocation and torn down in ``finally``, so a mid-loop store
        error (or a concurrent bench) cannot leak it or wedge later
        runs."""
        import time as _time

        size = max(1, min(size, 4 << 20))
        count = max(1, min(count, 1024))
        cid = f"bench.{self.id}.{_time.monotonic_ns()}"
        blob = os.urandom(size)
        loop = asyncio.get_running_loop()
        t = tx_mod.Transaction()
        t.create_collection(cid)
        self.store.queue_transaction(t)
        written = 0
        try:
            t0 = _time.perf_counter()
            for i in range(count):
                t = tx_mod.Transaction()
                t.write(cid, b"bench.%d" % i, 0, blob)
                done = loop.create_future()
                self.store.queue_transaction(
                    t, lambda f=done: loop.call_soon_threadsafe(
                        lambda: f.done() or f.set_result(None)))
                await done
                written += 1
            dt = _time.perf_counter() - t0
        finally:
            t = tx_mod.Transaction()
            for i in range(written):
                t.remove(cid, b"bench.%d" % i)
            t.remove_collection(cid)
            self.store.queue_transaction(t)
        return {"bytes_written": count * size, "blocksize": size,
                "elapsed_sec": round(dt, 6),
                "bytes_per_sec": round(count * size / dt, 1),
                "iops": round(count / dt, 1)}

    async def start_admin(self, path: str) -> None:
        """Expose the daemon on an admin socket (`ceph daemon` role)."""
        sock = AdminSocket(path)
        sock.register("perf dump", lambda a: self.perf.dump(),
                      "runtime counters")
        sock.register("config show", lambda a: self.conf.show(),
                      "effective configuration")
        sock.register(
            "config set",
            lambda a: (self.conf.set(a["key"], a["value"]), "ok")[1],
            "set a runtime option: {key, value}",
        )
        sock.register(
            "dump_pgs",
            lambda a: {
                pg.cid: {"state": pg.state, "acting": pg.acting,
                         "primary": pg.primary,
                         "log_head": list(pg.log.head)}
                for pg in self.pgs.values()
            },
            "per-PG state",
        )
        sock.register(
            "status",
            lambda a: {"osd": self.id, "epoch": self.epoch,
                       "pgs": len(self.pgs), "stopped": self.stopped},
            "daemon status",
        )
        sock.register(
            "dump_ops_in_flight",
            lambda a: self.optracker.dump_ops_in_flight(),
            "in-flight client ops with event timelines",
        )
        sock.register(
            "dump_historic_ops",
            lambda a: self.optracker.dump_historic_ops(
                int(a.get("limit", 20))
            ),
            "recently completed ops with event timelines",
        )
        sock.register(
            "bench",
            lambda a: self._bench(int(a.get("count", 16)),
                                  int(a.get("size", 1 << 20))),
            "raw store write bench: {count, size<=4MiB} "
            "(`ceph tell osd.N bench` role, OSD.cc:3302)",
        )
        async def _scrub_all(a: dict) -> dict:
            # deep-scrub every PG this daemon is primary for (the
            # `ceph pg deep-scrub` surface over the asok — the
            # process-tier thrash verdict needs it without reaching
            # into daemon memory the way vstart.scrub_pg does)
            out: dict[str, dict] = {}
            for pg in list(self.pgs.values()):
                if not pg.is_primary() or pg.state != "active":
                    continue
                rep = await pg.scrub()
                out[pg.cid] = {
                    "clean": rep["clean"],
                    "inconsistent": [
                        o.hex() if isinstance(o, (bytes, bytearray))
                        else o for o in rep["inconsistent"]],
                    "repaired": len(rep["repaired"]),
                }
            return out

        sock.register(
            "scrub",
            _scrub_all,
            "deep-scrub all primary PGs; per-PG "
            "{clean, inconsistent, repaired}",
        )
        sock.register(
            "dump_tracing",
            lambda a: self.tracer.dump(
                trace_id=(int(a["trace_id"], 16)
                          if "trace_id" in a else None),
                limit=int(a.get("limit", 200)),
            ),
            "finished spans, zipkin JSON shape: {trace_id?, limit?}",
        )
        await sock.start()
        self.admin = sock

    async def stop(self) -> None:
        """Crash-stop: no goodbyes (kill_osd role, ceph_manager.py:336)."""
        self.stopped = True
        if self.admin is not None:
            await self.admin.stop()
            self.admin = None
        if self._hb_task:
            self._hb_task.cancel()
        for t in self._worker_tasks:
            t.cancel()
        self._worker_tasks = []
        self.ec_batcher.close()
        for t in list(self._tasks):
            t.cancel()
        self.bus.unregister(self.name)
        for pg in self.pgs.values():
            if pg._peer_task and not pg._peer_task.done():
                pg._peer_task.cancel()

    async def _hb_loop(self) -> None:
        import json

        while True:
            try:
                await self.bus.send(
                    self.name, "mon",
                    M.MPing(osd=self.id, epoch=self.epoch),
                )
            except Exception:
                pass
            try:
                pgs: dict[str, int] = {}
                for pg in self.pgs.values():
                    pgs[pg.state] = pgs.get(pg.state, 0) + 1
                await self.bus.send(
                    self.name, "mgr",
                    M.MMgrReport(
                        osd=self.id, epoch=self.epoch,
                        perf=json.dumps(self.perf.dump()).encode(),
                        pgs=pgs,
                        pools=json.dumps(self._pool_stats()).encode(),
                    ),
                )
            except Exception:
                pass  # no mgr registered: reports are best-effort
            await asyncio.sleep(self.hb_interval)

    def _pool_stats(self) -> dict[str, list[int]]:
        """Per-pool [local stored bytes, primary head-object count]
        (the pg stat_sum role, sampled from the store). Throttled: a
        full collection scan per heartbeat would tax the data path."""
        now = time.monotonic()
        if now - self._pool_stats_ts < 2.0:
            return self._pool_stats_cache
        from . import snaps as sn
        from .pg import META_OID

        stats: dict[str, list[int]] = {}
        for pg in self.pgs.values():
            try:
                oids = self.store.list_objects(pg.cid)
            except Exception:
                continue
            ent = stats.setdefault(str(pg.pgid[0]), [0, 0])
            for oid in oids:
                try:
                    ent[0] += self.store.stat(pg.cid, oid)
                except Exception:
                    continue
                if (pg.is_primary() and oid != META_OID
                        and not sn.is_clone_oid(oid)):
                    ent[1] += 1
        self._pool_stats_cache = stats
        self._pool_stats_ts = now
        return stats

    # ------------------------------------------------------------ dispatch

    async def handle(self, src: str, msg) -> None:
        if self.stopped:
            return
        try:
            await self._handle(src, msg)
        except Exception:
            self.log_exc(f"dispatch {type(msg).__name__} from {src}")

    async def _handle(self, src: str, msg) -> None:
        if isinstance(msg, M.MOSDMapMsg):
            await self._handle_map(msg)
        elif isinstance(msg, M.MOSDOp):
            # enqueue_op role: client ops take the mClock queue under
            # the ingest byte throttle; sub-ops and control traffic stay
            # fast-dispatch
            await self.throttle.acquire(_op_bytes(msg))
            tracked = self.optracker.create(
                f"osd_op tid={msg.tid} {msg.oid!r} "
                f"[{','.join(o[0] for o in msg.ops)}]"
            )
            self.op_scheduler.enqueue(
                self._qos_class(src),
                lambda src=src, msg=msg, tr=tracked:
                    self._client_op(src, msg, tr),
            )
        elif isinstance(msg, M.MPull):
            pg = self._ensure_pg(msg.pgid, msg.shard)
            self.op_scheduler.enqueue(
                RECOVERY, lambda: pg.handle_pull(src, msg)
            )
        elif isinstance(msg, M.MBackfillReserve):
            await self._handle_backfill_reserve(src, msg)
        elif isinstance(msg, M.MPGScan):
            pg = self._ensure_pg(msg.pgid, msg.shard)
            self.op_scheduler.enqueue(
                RECOVERY, lambda: pg.handle_scan(src, msg)
            )
        elif isinstance(msg, M.MConfig):
            # central config push (MConfig role): apply matching
            # sections, most specific last
            for who in ("global", "osd", f"osd.{self.id}"):
                for w, key, value in msg.entries:
                    if w != who:
                        continue
                    try:
                        self.conf.set(key, value)
                    except Exception as e:
                        print(f"[{self.name}] config push "
                              f"{key}={value!r} rejected: {e}",
                              file=sys.stderr)
        elif isinstance(msg, M.MScrub):
            pg = self._ensure_pg(msg.pgid, msg.shard)
            self.op_scheduler.enqueue(
                SCRUB, lambda: pg.handle_scrub(src, msg)
            )
        elif isinstance(msg, M.MOSDRepOp):
            pg = self._ensure_pg(msg.pgid, -1)
            with self.tracer.start_span("sub_write", parent=msg.trace):
                await pg.handle_rep_op(src, msg)
        elif isinstance(msg, M.MOSDRepOpReply):
            self._resolve(msg.tid, msg)
        elif isinstance(msg, M.MECSubWrite):
            pg = self._ensure_pg(msg.pgid, msg.shard)
            with self.tracer.start_span("ec_sub_write", parent=msg.trace):
                await pg.handle_ec_write(src, msg)
        elif isinstance(msg, M.MECSubWriteReply):
            self._resolve(msg.tid, msg)
        elif isinstance(msg, M.MECSubRead):
            pg = self._ensure_pg(msg.pgid, msg.shard)
            with self.tracer.start_span("ec_sub_read", parent=msg.trace):
                await pg.handle_ec_read(src, msg)
        elif isinstance(msg, M.MECSubReadReply):
            self._resolve(msg.tid, msg)
        elif isinstance(msg, M.MPGInfoReq):
            pg = self._ensure_pg(msg.pgid, msg.shard)
            await pg.handle_info_req(src, msg)
        elif isinstance(msg, M.MPGInfoReply):
            osd_id = int(src[4:])
            self._resolve(("info", msg.pgid, osd_id, msg.shard), msg)
        elif isinstance(msg, M.MPGScanReply):
            osd_id = int(src[4:])
            self._resolve(("scan", msg.pgid, osd_id, msg.shard), msg)
        elif isinstance(msg, M.MPushOp):
            # two roles: a primary pushing recovery to us, or the answer
            # to our own MPull (self-recovery) — resolve a pending pull
            # future if one matches, else install as a peer push INTO
            # THE SHARD THE MESSAGE NAMES (an OSD gaining a new position
            # via pg_temp migration may also hold an old-position
            # instance; "existing instance wins" would misroute the
            # incoming chunk there)
            key = ("push", msg.pgid, self._my_shard(msg.pgid, msg.shard),
                   msg.oid)
            if key in self.pending:
                pg = self._ensure_pg(msg.pgid,
                                     self._my_shard(msg.pgid, msg.shard))
                await pg.handle_push(src, msg)
                self._resolve(key, msg)
            else:
                pg = self._ensure_pg(msg.pgid, msg.shard)
                await pg.handle_push(src, msg)
        elif isinstance(msg, M.MPushReply):
            osd_id = int(src[4:])
            self._resolve(("pushr", msg.pgid, msg.shard, msg.oid, osd_id,
                           msg.tid), msg)
        elif isinstance(msg, M.MScrubReply):
            self._resolve(msg.tid, msg)

    def set_qos_tenant(self, prefix: str, name: str,
                       reservation: float, weight: float,
                       limit: float = 0.0) -> None:
        """Register an mClock tenant class: ops from client entities
        whose name starts with ``prefix`` are scheduled under a
        dedicated dmClock class with its own reservation/weight/limit
        tags (the osd_mclock_override per-client role). Re-registering
        a prefix retags future ops only."""
        self.op_scheduler.add_class(name, reservation, weight, limit)
        self.qos_tenants[prefix] = name

    def _qos_class(self, src: str) -> str:
        for prefix, klass in self.qos_tenants.items():
            if src.startswith(prefix):
                return klass
        return CLIENT

    async def _client_op(self, src: str, msg: M.MOSDOp,
                         tracked=None) -> None:
        if tracked is not None:
            tracked.mark("dequeued")
        # injected per-op stall (ms_inject_delay cousin). Deliberately
        # BEFORE any PG lock is taken: fault pauses under a PG lock
        # would stall the whole PG, which tpulint's lock-discipline
        # rule forbids.
        await self.fault.pause("op_dispatch_delay", tid=msg.tid)
        try:
            if msg.epoch > self.epoch:
                # the sender has a NEWER map (OSD::wait_for_new_map
                # role): catch up before serving — that newer epoch may
                # carry a blocklist entry this very op sequence relies
                # on (a stolen lock's fence), so executing on the stale
                # map would break the fence ordering
                await self._catchup_to(msg.epoch)
            if (self.osdmap is not None
                    and src in self.osdmap.blocklist):
                # fenced entity (OSDMap::is_blocklisted role): its ops
                # must never land — this is the guarantee that makes an
                # exclusive-lock steal from a dead client safe
                await self.send(
                    src,
                    M.MOSDOpReply(tid=msg.tid, result=M.EBLOCKLISTED,
                                  data=b"", size=0, outs=[],
                                  epoch=self.epoch),
                )
                return
            pg = self._pg_for_primary(msg.pgid)
            if pg is None:
                if tracked is not None:
                    tracked.mark("estale")
                await self.send(
                    src,
                    M.MOSDOpReply(tid=msg.tid, result=M.ESTALE, data=b"",
                                  size=0, outs=[], epoch=self.epoch),
                )
                return
            if tracked is not None:
                tracked.mark("reached_pg")
            await pg.do_op(src, msg)
        finally:
            if tracked is not None:
                self.optracker.finish(tracked)
            self.throttle.release(_op_bytes(msg))

    def _my_shard(self, pgid, msg_shard: int) -> int:
        """The shard *this* OSD holds for pgid (push messages carry the
        destination shard for peer pushes; for pull answers the shard is
        the source's — our own instance key wins)."""
        for (pool, ps, shard) in self.pgs:
            if (pool, ps) == pgid:
                return shard
        return msg_shard

    def _pg_for_primary(self, pgid) -> PG | None:
        """The instance that should serve client ops for pgid under the
        CURRENT map — never a stray from an older epoch."""
        if self.osdmap is None or pgid[0] not in self.osdmap.pools:
            return None
        pool = self.osdmap.pools[pgid[0]]
        up, primary = self.placement.up_acting(self.osdmap, pgid)
        if primary != self.id or self.id not in up:
            return None
        shard = up.index(self.id) if pool.type == "erasure" else -1
        pg = self._ensure_pg(pgid, shard)
        if not pg.acting:
            pg.on_map(up, primary)
        return pg

    def _ensure_pg(self, pgid, shard: int) -> PG:
        key = (pgid[0], pgid[1], shard)
        pg = self.pgs.get(key)
        if pg is None:
            self._maybe_split(pgid, shard)
            pg = PG(self, pgid, shard)
            pool = (self.osdmap.pools.get(pgid[0])
                    if self.osdmap is not None else None)
            if pool is not None:
                pg.acting, pg.primary = \
                    self.osdmap.pg_to_up_acting_osds(pgid)
            if pool is not None and pgid[1] >= pool.pg_num:
                # a stale in-flight message for a MERGED-away child:
                # hand back a transient instance so the handler can
                # bounce ESTALE, but never register it — a zombie in
                # self.pgs would sit in 'peering' forever and wedge
                # every wait-for-clean
                return pg
            self.pgs[key] = pg
            if pool is not None:
                # classify NOW, not at the next map change: a late or
                # duplicated sub-op (thrash remaps produce plenty) can
                # create this instance for a shard position the current
                # map gives someone else — without this, the shell
                # keeps the constructor's 'peering' until a map change
                # that may never come, wedging wait-for-clean exactly
                # like the merged-away zombie above (thrash-found)
                pg.on_map(pg.acting, pg.primary)
        return pg

    def _split_pool_children(self, pool, prev_pg_num: int) -> None:
        """Eager PG split on a pg_num transition (PG::split_into role,
        PG.cc:546): every child in [prev, new) splits from its TRUE
        parent (child & (prev-1)) if this OSD holds it — objects whose
        head-oid hash lands in the child under the new mask move over
        atomically, and the child's log anchors at the parent's head,
        so peering sees the child as current on exactly the members
        that held the parent. Children keep the parent's placement
        until pgp_num rises (the reference sequences pg_num before
        pgp_num the same way), so members split in lockstep."""
        from .pg import META_OID
        from .pglog import PGLog

        n = pool.pg_num
        if n & (n - 1) or prev_pg_num & (prev_pg_num - 1):
            return  # splits only defined between pow2 pg_num values
        nbits = n.bit_length() - 1
        colls = set(self.store.list_collections())
        prefix = f"{pool.id}."
        for c in range(prev_pg_num, n):
            p = c & (prev_pg_num - 1)
            for pcid in colls:
                if not pcid.startswith(prefix):
                    continue
                body = pcid[len(prefix):]
                ps_s, _, suffix = body.partition("s")
                if int(ps_s) != p:
                    continue
                cid = f"{prefix}{c}" + (f"s{suffix}" if suffix else "")
                if cid in colls:
                    continue
                t = tx_mod.Transaction()
                t.create_collection(cid)
                t.split_collection(pcid, nbits, c, cid)
                child_log = PGLog()
                try:
                    raw = self.store.read(pcid, META_OID)
                    if raw:
                        plog, _ = PGLog.decode(raw)
                        child_log.tail = plog.head
                except Exception:
                    pass
                t.write(cid, META_OID, 0, child_log.encode())
                self.store.queue_transaction(t)
                self.perf.inc("pg_splits")

    def _merge_pool_children(self, pool, prev_pg_num: int) -> None:
        """PG merge on a pg_num shrink (PG::merge_from role,
        src/osd/PG.cc:571): every child in [new, prev) folds back into
        its parent (child & (new-1)) wherever this OSD holds either
        side. The mon only shrinks pg_num after pgp_num collapsed, so
        parent and child are co-located and every member merges the
        same pair in lockstep at the same map transition.

        The merged PG restarts with a FRESH log anchored at
        (merge_epoch, 0) — identical on every member by construction —
        which forces the merged PG through a new interval the way the
        reference does; a member that missed the transition (revived
        later) anchors BELOW that tail and backfills from the merged
        survivors. Merge assumes clean PGs (the autoscaler, like the
        reference's pg_num_pending machinery, only shrinks healthy
        pools)."""
        from .pg import META_OID
        from .pglog import PGLog

        n = pool.pg_num
        if n & (n - 1) or prev_pg_num & (prev_pg_num - 1):
            return  # merges only defined between pow2 pg_num values
        epoch = self.osdmap.epoch
        colls = set(self.store.list_collections())
        prefix = f"{pool.id}."
        merged_parents: set[str] = set()
        for c in range(n, prev_pg_num):
            p = c & (n - 1)
            for ccid in sorted(colls):
                if not ccid.startswith(prefix):
                    continue
                body = ccid[len(prefix):]
                ps_s, _, suffix = body.partition("s")
                if int(ps_s) != c:
                    continue
                pcid = f"{prefix}{p}" + (f"s{suffix}" if suffix else "")
                t = tx_mod.Transaction()
                if pcid not in colls:
                    t.create_collection(pcid)
                    colls.add(pcid)
                # the child's log object must not clobber the parent's
                # (a stray child pushed object-by-object may lack one)
                if self.store.exists(ccid, META_OID):
                    t.remove(ccid, META_OID)
                t.merge_collection(ccid, pcid)
                merged = PGLog()
                merged.tail = (epoch, 0)
                t.truncate(pcid, META_OID, 0)
                t.write(pcid, META_OID, 0, merged.encode())
                self.store.queue_transaction(t)
                colls.discard(ccid)
                merged_parents.add(pcid)
                self.perf.inc("pg_merges")
        # drop in-memory instances: children are gone from the map, and
        # merged parents must reload their fresh on-disk log; peering
        # under the new map re-activates them
        for key in list(self.pgs):
            if key[0] != pool.id:
                continue
            suffix = f"s{key[2]}" if key[2] >= 0 else ""
            cid = f"{prefix}{key[1]}{suffix}"
            if key[1] >= n or cid in merged_parents:
                pg = self.pgs.pop(key)
                for task in (pg._peer_task, pg._migrate_task):
                    if task is not None:
                        task.cancel()

    def _maybe_split(self, pgid, shard: int) -> None:
        """Lazy split fallback for members that missed the pg_num
        transition (revived mid-history): move the child's objects out
        of ANY existing proper ancestor — each split filters with the
        full current mask, so non-containers contribute nothing. The
        child log stays at ZERO (no fabricated progress): a member
        whose data arrived this way recovers authoritatively from
        peers that anchored at the real parent's head."""
        if self.osdmap is None or pgid[0] not in self.osdmap.pools:
            return
        pool = self.osdmap.pools[pgid[0]]
        n = pool.pg_num
        if n & (n - 1):
            return
        c = pgid[1]
        suffix = f"s{shard}" if shard >= 0 else ""
        cid = f"{pgid[0]}.{c}{suffix}"
        colls = self.store.list_collections()
        if cid in colls:
            return
        nbits = n.bit_length() - 1
        ancestors = []
        seen = set()
        for b in range(nbits - 1, -1, -1):
            p = c & ((1 << b) - 1)
            if p == c or p in seen:
                continue
            seen.add(p)
            pcid = f"{pgid[0]}.{p}{suffix}"
            if pcid in colls:
                ancestors.append(pcid)
        if not ancestors:
            return
        t = tx_mod.Transaction()
        t.create_collection(cid)
        for pcid in ancestors:
            t.split_collection(pcid, nbits, c, cid)
        self.store.queue_transaction(t)
        self.perf.inc("pg_splits")

    # ----------------------------------------------------------- map flow

    async def _handle_backfill_reserve(self, src: str,
                                       msg: M.MBackfillReserve) -> None:
        """Target side of the remote backfill-slot protocol: grant when
        the remote reserver has room, release frees the slot. The
        grant may queue behind other inbound backfills — that queueing
        IS the bound (osd_max_backfills on the target)."""
        key = ("remote", tuple(msg.pgid), msg.osd)
        if msg.op == "request":
            async def _grant():
                await self.remote_reserver.request(key, msg.prio)
                try:
                    await self.send(
                        f"osd.{msg.osd}",
                        M.MBackfillReserve(pgid=msg.pgid, op="grant",
                                           osd=self.id))
                except Exception:
                    self.remote_reserver.release(key)
            self.spawn(_grant())
        elif msg.op == "release":
            self.remote_reserver.release(key)
        elif msg.op == "grant":
            # primary side: wake the reservation waiter
            self._resolve(("bfgrant", tuple(msg.pgid), msg.osd), msg)

    async def _handle_map(self, msg: M.MOSDMapMsg) -> None:
        if msg.full:
            m, _ = menc.decode_osdmap(msg.full)
            self.osdmap = m
        for raw in msg.incrementals:
            inc, _ = menc.decode_incremental(raw)
            if self.osdmap is None or inc.epoch != self.osdmap.epoch + 1:
                if self.osdmap is not None and inc.epoch <= self.osdmap.epoch:
                    continue
                try:
                    await self.mon_send(M.MMonGetMap(have=self.epoch),
                                        deadline_s=1.0)
                except IOError:
                    pass
                return
            self.osdmap.apply_incremental(inc)
            self.perf.inc("map_epochs")
        if not self.osdmap.osds[self.id].up:
            # wrongly marked down while alive: re-assert ourselves (the
            # reference OSD restarts its boot sequence on seeing itself
            # down in a new map)
            await self.mon_send(M.MOSDBoot(osd=self.id))
        for pool in self.osdmap.pools.values():
            prev = self._pool_pg_num.get(pool.id, pool.pg_num)
            if pool.pg_num > prev:
                self._split_pool_children(pool, prev)
            elif pool.pg_num < prev:
                self._merge_pool_children(pool, prev)
            self._pool_pg_num[pool.id] = pool.pg_num
        self._drop_deleted_pools()
        self._scan_pgs()
        self._kick_snap_trim()

    def _drop_deleted_pools(self) -> None:
        """Tear down PGs whose pool left the map (`osd pool rm` role):
        stop the PG, delete its objects, drop the collection."""
        from ..store import transaction as tx

        for key in [k for k in self.pgs
                    if k[0] not in self.osdmap.pools]:
            pg = self.pgs.pop(key)
            if pg._peer_task and not pg._peer_task.done():
                pg._peer_task.cancel()
            try:
                oids = self.store.list_objects(pg.cid)
            except Exception:
                continue  # collection never materialized: nothing to do
            t = tx.Transaction()
            for oid in oids:
                t.remove(pg.cid, oid)
            t.remove_collection(pg.cid)
            try:
                self.store.queue_transaction(t)
            except Exception:
                self.log_exc(f"pg {pg.pgid} pool-delete cleanup")
        for pid in [p for p in self._pool_pg_num
                    if p not in self.osdmap.pools]:
            self._pool_pg_num.pop(pid, None)
            self._trimmed_snaps.pop(pid, None)

    def _kick_snap_trim(self) -> None:
        """Launch trimming for snap ids newly marked removed in the map
        (the SnapTrimmer arc: pool removed_snaps delta -> per-PG trim).
        An interval is recorded as processed only after every local
        primary PG trims it successfully — a failed or pre-failover
        attempt retries on the next map change or PG activation."""
        from . import snaps as sn_mod

        if self.osdmap is None:
            return
        for pool in self.osdmap.pools.values():
            seen = self._trimmed_snaps.get(pool.id, [])
            new_ids = sn_mod.interval_diff_ids(pool.removed_snaps, seen)
            if not new_ids:
                continue
            prim = [pg for key, pg in list(self.pgs.items())
                    if key[0] == pool.id and pg.is_primary()]
            if not prim:
                continue  # not our PGs to trim; do NOT mark processed
            snapshot = [tuple(iv) for iv in pool.removed_snaps]
            self.spawn(self._trim_pool(pool.id, snapshot, prim, new_ids))

    async def _trim_pool(self, pool_id: int, intervals, pgs,
                         snapids: list[int]) -> None:
        ok = True
        for pg in pgs:
            if not await self._trim_pg(pg, snapids):
                ok = False
        if ok:
            self._trimmed_snaps[pool_id] = intervals

    async def _trim_pg(self, pg: PG, snapids: list[int]) -> bool:
        # wait for activity (a trim racing peering retries next tick)
        for _ in range(100):
            if pg.state == "active" or not pg.is_primary():
                break
            await asyncio.sleep(0.05)
        if not pg.is_primary():
            return True  # no longer our job; the new primary trims
        if pg.state != "active":
            return False
        try:
            n = await pg.trim_snaps(snapids)
            if n:
                self.perf.inc("snap_trims", n)
            return True
        except Exception:
            self.log_exc(f"pg {pg.pgid} snap trim")
            return False

    def kick_pg_snap_trim(self, pg: PG) -> None:
        """On PG activation (incl. primary failover): re-run trimming
        for every removed snap of its pool — idempotent, and the only
        way a NEW primary learns about removals it never processed."""
        from . import snaps as sn_mod

        if self.osdmap is None or pg.pgid[0] not in self.osdmap.pools:
            return
        pool = self.osdmap.pools[pg.pgid[0]]
        ids = sn_mod.interval_diff_ids(pool.removed_snaps, [])
        if ids:
            self.spawn(self._trim_pg(pg, ids))

    def _scan_pgs(self) -> None:
        """Instantiate/refresh PGs this OSD hosts under the current map
        (consume_map -> load PGs role, OSD.cc:3732)."""
        if self.osdmap is None:
            return
        for pool in self.osdmap.pools.values():
            ec = pool.type == "erasure"
            for ps in range(pool.pg_num):
                pgid = (pool.id, ps)
                up, primary = self.osdmap.pg_to_up_acting_osds(pgid)
                if self.id in up:
                    self._ensure_pg(pgid, up.index(self.id) if ec else -1)
                # every instance of this pgid (member or stray — strays
                # stay on disk like the reference's lazy removal) learns
                # the new acting set
                for key, pg in list(self.pgs.items()):
                    if (key[0], key[1]) == pgid:
                        pg.on_map(up, primary)
