"""MonLite: the cluster-map authority (src/mon role, single-node form).

Owns the OSDMap, admits OSDs (MOSDBoot — OSDMonitor::preprocess_boot
role), detects failures by heartbeat timeout plus peer failure reports
(OSDMonitor::prepare_failure, OSDMonitor.cc:3325), marks down OSDs out
after an interval (mon_osd_down_out_interval), creates pools, and
publishes epochs as incrementals to subscribers.

Single-authority by design for now: the reference replicates this state
machine over Paxos (src/mon/Paxos.cc:154-890) for mon fault tolerance;
the map-mutation protocol here is already incremental-epoch shaped, so a
consensus layer slots under commit() without touching callers. Tracked
as the consensus follow-up (SURVEY §2.5).

ceph_tpu_torch's own copy of ``ceph_tpu/cluster/mon.py``.
"""
from __future__ import annotations

import asyncio
import time

from ..placement import crushmap as cm
from ..placement import encoding as menc
from ..placement.osdmap import Incremental, OSDMap
from . import messages as M

#: hard cap on live pg_num growth (the mon_max_pool_pg_num role): the
#: single-reactor mon and OSDs walk range(pg_num) synchronously on a
#: pgp change, so an unbounded request would stall the control plane
MAX_POOL_PG_NUM = 4096


class MonLite:
    def __init__(
        self,
        bus,
        n_osds: int,
        crush: cm.CrushMap | None = None,
        hb_grace: float = 1.0,
        out_interval: float = 5.0,
        name: str = "mon",
        store=None,
    ):
        if crush is None:
            crush = cm.build_flat(n_osds)
            crush.add_rule(cm.flat_firstn_rule(0))
            crush.add_rule(cm.ec_rule(1, root=-1, failure_domain_type=0))
        self.bus = bus
        self.name = name
        self.osdmap = OSDMap(crush, n_osds)
        for st in self.osdmap.osds:
            st.up = False  # OSDs join via MOSDBoot
        self.hb_grace = hb_grace
        self.out_interval = out_interval
        self.last_ping: dict[int, float] = {}
        self.down_since: dict[int, float] = {}
        self.subscribers: set[str] = set()
        self.history: dict[int, bytes] = {}  # epoch -> encoded incremental
        #: central config DB (ConfigMonitor role): (who, key) -> value
        self.config_db: dict[tuple[str, str], str] = {}
        #: last stats digest from the mgr (MgrStatMonitor role) — feeds
        #: `status`/`df`/`pg stat` MonCommands and pool-quota checks
        self.mgr_digest: dict = {}
        #: pool id -> human reason, set while a quota is exceeded
        self.full_pools: dict[int, str] = {}
        self._watchdog: asyncio.Task | None = None
        self._next_pool_id = 1
        #: serializes read-modify-commit pool mutations (snap id
        #: allocation, pool create): each message runs in its own task,
        #: and a Paxos commit awaits a quorum round mid-mutation —
        #: without this two concurrent snap creates hand out one id
        self._pool_mut_lock = asyncio.Lock()
        #: MonitorDBStore role: when set, maps/config/paxos state
        #: persist to the native kv and restore on construction
        self.store = store
        if store is not None:
            self._restore_from_store()

    def _restore_from_store(self) -> None:
        """Cold boot from disk (MonitorDBStore recovery): the committed
        map, incremental history, pool-id counter, and config DB."""
        loaded = self.store.load_map()
        if loaded is not None:
            full, _last, history, npool = loaded
            self.osdmap, _ = menc.decode_osdmap(full)
            self.history = history
            self._next_pool_id = npool
            # daemons must re-announce themselves: mark everything down
            # until MOSDBoot (the reference mon's post-restart stance)
            for st in self.osdmap.osds:
                st.up = False
        self.config_db = self.store.load_config()

    def _persist_commit(self, inc_epoch: int,
                        inc_raw: bytes | None) -> None:
        # every replica tracks the pool-id watermark from applied
        # incrementals (or a full-map catch-up: inc_raw None), so a
        # failed-over leader never reuses an id
        for p in self.osdmap.pools.values():
            self._next_pool_id = max(self._next_pool_id, p.id + 1)
        if self.store is None:
            return
        self.store.save_map(menc.encode_osdmap(self.osdmap),
                            self.osdmap.epoch, inc_raw, inc_epoch,
                            next_pool_id=self._next_pool_id)

    # ---------------------------------------------------------- lifecycle

    async def start(self) -> None:
        self.bus.register(self.name, self.handle)
        self._watchdog = asyncio.get_running_loop().create_task(
            self._watch_loop()
        )

    async def stop(self) -> None:
        if self._watchdog:
            self._watchdog.cancel()
        self.bus.unregister(self.name)
        if self.store is not None:
            self.store.close()

    # ------------------------------------------------------------ mutation

    async def commit(self, inc: Incremental) -> None:
        """Apply one incremental and publish it (the Paxos-commit seam)."""
        self.history[inc.epoch] = menc.encode_incremental(inc)
        self.osdmap.apply_incremental(inc)
        self._persist_commit(inc.epoch, self.history[inc.epoch])
        msg = M.MOSDMapMsg(
            full=b"",
            incrementals=[self.history[inc.epoch]],
            epoch=self.osdmap.epoch,
        )
        for sub in list(self.subscribers):
            try:
                await self.bus.send(self.name, sub, msg)
            except Exception:
                self.subscribers.discard(sub)

    def _new_inc(self) -> Incremental:
        return Incremental(epoch=self.osdmap.epoch + 1)

    # ------------------------------------------------------------ dispatch

    async def handle(self, src: str, msg) -> None:
        if isinstance(msg, M.MOSDBoot):
            await self._handle_boot(src, msg)
        elif isinstance(msg, M.MPing):
            self.last_ping[msg.osd] = time.monotonic()
            if msg.epoch < self.osdmap.epoch:
                # stale pinger (e.g. an OSD whose subscription was on a
                # deposed leader): catch it up — a failover must not
                # strand daemons on the last pre-failover epoch
                self.subscribers.add(src)
                await self._send_map(src, msg.epoch)
        elif isinstance(msg, M.MMonGetMap):
            await self._send_map(src, msg.have)
        elif isinstance(msg, M.MMonSubscribe):
            self.subscribers.add(src)
            await self._send_map(src, 0)
            await self._push_config(src)
        elif isinstance(msg, M.MFailure):
            await self._handle_failure(msg)
        elif isinstance(msg, M.MPoolCreate):
            await self._handle_pool_create(src, msg)
        elif isinstance(msg, M.MPoolSnapOp):
            await self._handle_pool_snap(src, msg)
        elif isinstance(msg, M.MPoolSet):
            await self._handle_pool_set(src, msg)
        elif isinstance(msg, M.MPGTempClear):
            await self._handle_pg_temp_clear(msg)
        elif isinstance(msg, M.MBlocklist):
            await self._handle_blocklist(src, msg)
        elif isinstance(msg, M.MConfigSet):
            await self._handle_config_set(msg)
        elif isinstance(msg, M.MUpmapItems):
            await self._handle_upmap_items(msg)
        elif isinstance(msg, M.MMgrDigest):
            await self._handle_mgr_digest(msg)
        elif isinstance(msg, M.MMonCommand):
            await self._handle_command(src, msg)

    async def _handle_command(self, src: str, msg: M.MMonCommand) -> None:
        """`ceph` CLI entry (MMonCommand + MonCommands.h dispatch)."""
        import json

        from . import moncommands

        try:
            cmd = json.loads(msg.cmd)
            if not isinstance(cmd, dict):
                raise ValueError
        except ValueError:
            rc, outs, outb = -22, "command must be a JSON object", b""
        else:
            rc, outs, outb = await moncommands.dispatch(self, cmd)
        await self.bus.send(
            self.name, src,
            M.MMonCommandReply(tid=msg.tid, result=rc, outs=outs,
                               outb=outb, epoch=self.osdmap.epoch))

    async def _handle_mgr_digest(self, msg: M.MMgrDigest) -> None:
        import json

        try:
            self.mgr_digest = json.loads(msg.digest.decode() or "{}")
        except ValueError:
            return
        await self._check_quotas()

    async def _check_quotas(self) -> None:
        """Set/clear the pool FULL flag from digest usage vs quotas
        (OSDMonitor FLAG_FULL_QUOTA role). Digest bytes are RAW
        (summed over replicas/shards); quotas bound LOGICAL bytes, so
        raw is scaled down by the pool's redundancy factor."""
        usage = self.mgr_digest.get("pools", {})
        for pid, pool in list(self.osdmap.pools.items()):
            if not pool.quota_max_bytes and not pool.quota_max_objects:
                if pool.full:
                    await self._set_pool_full(pid, False, "")
                continue
            if str(pid) not in usage:
                # no stats for this pool yet (mgr/cluster restart):
                # "unknown" must not clear a persisted FULL flag —
                # that would re-open writes on an over-quota pool
                continue
            raw, objs = usage.get(str(pid), (0, 0))
            if pool.type == "erasure":
                k = int(pool.ec_profile.get("k", 2))
                factor = (k + int(pool.ec_profile.get("m", 1))) / k
            else:
                factor = pool.size
            stored = int(raw / max(1.0, factor))
            over = []
            if pool.quota_max_bytes and stored >= pool.quota_max_bytes:
                over.append(f"bytes {stored} >= {pool.quota_max_bytes}")
            if pool.quota_max_objects and objs >= pool.quota_max_objects:
                over.append(f"objects {objs} >= {pool.quota_max_objects}")
            if bool(over) != pool.full:
                await self._set_pool_full(
                    pid, bool(over),
                    f"pool '{pool.name}': " + "; ".join(over))

    async def _set_pool_full(self, pool_id: int, full: bool,
                             reason: str) -> None:
        import copy

        async with self._pool_mut_lock:
            pool = self.osdmap.pools.get(pool_id)
            if pool is None or pool.full == full:
                return
            pool = copy.deepcopy(pool)
            pool.full = full
            inc = self._new_inc()
            inc.new_pools.append(pool)
            await self.commit(inc)
        if full:
            self.full_pools[pool_id] = reason
        else:
            self.full_pools.pop(pool_id, None)

    async def _handle_boot(self, src: str, msg: M.MOSDBoot) -> None:
        osd = msg.osd
        self.subscribers.add(src)
        self.last_ping[osd] = time.monotonic()
        st = self.osdmap.osds[osd]
        inc = self._new_inc()
        changed = False
        if not st.up:
            inc.up.append(osd)
            changed = True
        if st.weight == 0:
            inc.weights[osd] = 0x10000  # boot brings a marked-out OSD in
            changed = True
        self.down_since.pop(osd, None)
        if changed:
            await self.commit(inc)
        else:
            await self._send_map(src, 0)
        # a (re)booting daemon starts with a fresh ConfigProxy: push the
        # central DB so late joiners converge (MConfig-on-boot role)
        await self._push_config(src)

    async def _handle_failure(self, msg: M.MFailure) -> None:
        """Peer-reported failure (send_failures -> prepare_failure role).
        A single report from a cluster member is trusted — the reference
        corroborates across reporters (mon_osd_min_down_reporters) to
        resist network partitions; with one mon the heartbeat watchdog
        provides the second signal."""
        osd = msg.target
        if 0 <= osd < self.osdmap.n_osds and self.osdmap.osds[osd].up:
            await self._mark_down(osd)

    async def _handle_pool_create(self, src: str, msg: M.MPoolCreate) -> None:
        pool, _ = menc._dec_pool(msg.pool, 0)
        rc, pool_id = await self.pool_create(pool)
        await self.bus.send(
            self.name, src,
            M.MPoolCreateReply(pool_id=pool_id, epoch=self.osdmap.epoch,
                               tid=msg.tid, result=rc),
        )

    async def pool_create(self, pool) -> tuple[int, int]:
        """Create (or idempotently re-ack) a pool; returns (rc, id).
        Shared by the message path and MonCommands."""
        async with self._pool_mut_lock:
            existing = next(
                (p for p in self.osdmap.pools.values()
                 if p.name == pool.name
                 and (pool.id < 0 or p.id == pool.id)), None)
            if existing is not None:
                # idempotent by (id, name) ONLY when the spec matches:
                # acking a same-name create with a DIFFERENT spec would
                # let the caller believe its size/profile was applied.
                # pg_num is excluded — the autoscaler mutates it live,
                # so a retried create must not fail against a split.
                same = all(
                    getattr(existing, f) == getattr(pool, f)
                    for f in ("size", "min_size", "crush_rule", "type",
                              "ec_profile"))
                return (M.OK if same else M.EEXIST), existing.id
            if pool.id < 0:
                pool.id = self._next_pool_id
            self._next_pool_id = max(self._next_pool_id, pool.id + 1)
            inc = self._new_inc()
            inc.new_pools.append(pool)
            await self.commit(inc)
        return M.OK, pool.id

    async def _handle_pool_snap(self, src: str, msg: M.MPoolSnapOp) -> None:
        """Selfmanaged snap allocation / removal (OSDMonitor snap verbs):
        'create' bumps pool snap_seq and returns the new id; 'remove'
        unions [snapid, snapid+1) into removed_snaps — OSDs trim on the
        resulting map epoch."""
        import copy

        from . import snaps as sn

        pool = self.osdmap.pools.get(msg.pool_id)
        if pool is None:
            await self.bus.send(
                self.name, src,
                M.MPoolSnapReply(pool_id=msg.pool_id, snapid=0,
                                 result=M.ENOENT,
                                 epoch=self.osdmap.epoch, tid=msg.tid),
            )
            return
        if msg.op not in ("create", "remove"):
            await self.bus.send(
                self.name, src,
                M.MPoolSnapReply(pool_id=msg.pool_id, snapid=0,
                                 result=-22, epoch=self.osdmap.epoch,
                                 tid=msg.tid),
            )
            return
        async with self._pool_mut_lock:
            # re-read under the lock: a concurrent snap op committed a
            # newer pool while we awaited the lock
            pool = copy.deepcopy(self.osdmap.pools[msg.pool_id])
            if msg.op == "create":
                pool.snap_seq += 1
                snapid = pool.snap_seq
            else:
                snapid = msg.snapid
                pool.removed_snaps = sn.interval_insert(
                    pool.removed_snaps, snapid, snapid + 1
                )
            inc = self._new_inc()
            inc.new_pools.append(pool)
            await self.commit(inc)
        await self.bus.send(
            self.name, src,
            M.MPoolSnapReply(pool_id=msg.pool_id, snapid=snapid,
                             result=M.OK, epoch=self.osdmap.epoch,
                             tid=msg.tid),
        )

    async def _handle_pool_set(self, src: str, msg: M.MPoolSet) -> None:
        """Live pool parameter changes (`ceph osd pool set` role).

        pg_num may only grow, and only between powers of two — the
        collection-split op is a hash-mask filter, so children must be
        mask-addressable (the reference's pg_num_pending machinery
        enforces pow2-aligned splits the same way). pgp_num trails
        pg_num: bumping it re-places children via normal peering.
        """
        rc = await self.pool_set(msg.pool_id, msg.key, msg.value)
        await self.bus.send(
            self.name, src,
            M.MPoolSetReply(pool_id=msg.pool_id, result=rc,
                            epoch=self.osdmap.epoch, tid=msg.tid),
        )

    async def pool_set(self, pool_id: int, key: str, value: str) -> int:
        """Apply one pool-parameter change; returns rc. Shared by the
        message path and MonCommands."""
        import copy

        pool0 = self.osdmap.pools.get(pool_id)
        if pool0 is None:
            return M.ENOENT
        try:
            val = int(value)
        except ValueError:
            return -22

        def _pow2(n: int) -> bool:
            return n > 0 and (n & (n - 1)) == 0

        async with self._pool_mut_lock:
            pool = copy.deepcopy(self.osdmap.pools[pool_id])
            if key == "pg_num":
                if (not _pow2(val) or not _pow2(pool.pg_num)
                        or val > MAX_POOL_PG_NUM):
                    return -22
                if val < pool.pg_num:
                    # merge preconditions (the pg_num_pending role):
                    # children must already be CO-LOCATED with their
                    # parents — pgp_num collapses first, placement
                    # converges (every pg_temp pin cleared, i.e. the
                    # data actually moved), then pg_num halves fold
                    # collections in lockstep
                    if val < pool.pgp_num or any(
                            pg[0] == pool.id for pg in self.osdmap.pg_temp):
                        return -11  # EAGAIN: not clean yet, retry
                pool.pg_num = val
            elif key == "pgp_num":
                if (val > pool.pg_num or val < 1
                        or (val < pool.pgp_num and not _pow2(val))):
                    return -22
                pool.pgp_num = val
            elif key in ("quota_max_bytes", "quota_max_objects"):
                if val < 0:
                    return -22
                setattr(pool, key, val)
            else:
                return -22
            inc = self._new_inc()
            inc.new_pools.append(pool)
            if key == "pgp_num":
                # pin every re-placed PG to its CURRENT acting set with
                # pg_temp (the choose_acting/pg_temp arc): the old
                # members keep serving IO and migrate data to the new
                # up set, then the primary clears the pin
                # (MPGTempClear). Without this an EC child whose new
                # set is disjoint from the old would have no shards.
                old_acting = {}
                for ps in range(pool.pg_num):
                    acting, _ = self.osdmap.pg_to_up_acting_osds(
                        (pool.id, ps))
                    old_acting[ps] = acting
                saved = self.osdmap.pools[pool_id]
                self.osdmap.pools[pool_id] = pool  # probe new map
                try:
                    for ps in range(pool.pg_num):
                        pgid = (pool.id, ps)
                        up, _upp, _a, _ap = \
                            self.osdmap.pg_to_up_acting_full(pgid)
                        if up != old_acting[ps]:
                            inc.new_pg_temp[pgid] = old_acting[ps]
                finally:
                    self.osdmap.pools[pool_id] = saved
            await self.commit(inc)
        return M.OK

    async def _handle_blocklist(self, src: str, msg: M.MBlocklist) -> None:
        """Fence/unfence a client entity via a committed map epoch (the
        OSDMonitor `osd blocklist` role): after the epoch propagates,
        every OSD rejects the entity's ops with EBLOCKLISTED."""
        already = msg.entity in self.osdmap.blocklist
        if (msg.op == "add") == already:
            # idempotent: already in the requested state
            await self.bus.send(
                self.name, src,
                M.MBlocklistReply(result=M.OK, epoch=self.osdmap.epoch,
                                  tid=msg.tid))
            return
        inc = self._new_inc()
        if msg.op == "add":
            inc.new_blocklist.append(msg.entity)
        else:
            inc.new_unblocklist.append(msg.entity)
        await self.commit(inc)
        await self.bus.send(
            self.name, src,
            M.MBlocklistReply(result=M.OK, epoch=self.osdmap.epoch,
                              tid=msg.tid))

    async def _handle_pg_temp_clear(self, msg: M.MPGTempClear) -> None:
        """Primary reports migration done: drop the pg_temp pin so the
        up set takes over (empty-MOSDPGTemp role)."""
        if msg.pgid not in self.osdmap.pg_temp:
            return
        inc = self._new_inc()
        inc.new_pg_temp[msg.pgid] = []
        await self.commit(inc)

    # -------------------------------------------------------------- config

    def _config_peers(self) -> list[str]:
        """Peer mons that must mirror the config DB (PaxosMon
        overrides; a single mon has none)."""
        return []

    async def _handle_config_set(self, msg: M.MConfigSet) -> None:
        """Central config DB (ConfigMonitor role): record, mirror to
        peer mons (so a failover keeps the DB — a peon down during the
        set misses it, the lite analog of a store-sync gap), and push
        to every subscriber as MConfig."""
        self.config_db[(msg.who, msg.key)] = msg.value
        if self.store is not None:
            self.store.save_config(msg.who, msg.key, msg.value)
        for dst in list(self.subscribers) + self._config_peers():
            await self._push_config(dst)

    async def _push_config(self, dst: str) -> None:
        if not self.config_db:
            return
        entries = [(w, k, v) for (w, k), v in sorted(
            self.config_db.items())]
        try:
            await self.bus.send(self.name, dst,
                                M.MConfig(entries=entries))
        except Exception:
            pass  # dead subscriber: dropped on next map churn

    async def _handle_upmap_items(self, msg: M.MUpmapItems) -> None:
        """pg-upmap-items verb (OSDMonitor role): commit the whole
        plan as ONE map epoch (one re-peering pass, not one per PG)."""
        inc = self._new_inc()
        for pgid, pairs in msg.entries:
            inc.new_pg_upmap_items[tuple(pgid)] = [
                tuple(p) for p in pairs]
        await self.commit(inc)

    # ---------------------------------------------------------------- maps

    async def _send_map(self, dst: str, have: int) -> None:
        if have and all(e in self.history for e in
                        range(have + 1, self.osdmap.epoch + 1)):
            incs = [self.history[e]
                    for e in range(have + 1, self.osdmap.epoch + 1)]
            msg = M.MOSDMapMsg(full=b"", incrementals=incs,
                               epoch=self.osdmap.epoch)
        else:
            msg = M.MOSDMapMsg(
                full=menc.encode_osdmap(self.osdmap), incrementals=[],
                epoch=self.osdmap.epoch,
            )
        await self.bus.send(self.name, dst, msg)

    # -------------------------------------------------------------- health

    def health(self) -> dict:
        """Compact cluster-health digest (the `ceph health` summary
        role): what a thrash verdict needs to judge convergence —
        everyone up and in, no pg_temp pins left, no FULL pools."""
        up = sum(1 for st in self.osdmap.osds if st.up)
        out = sum(1 for st in self.osdmap.osds if st.weight == 0)
        return {
            "epoch": self.osdmap.epoch,
            "n_osds": self.osdmap.n_osds,
            "osds_up": up,
            "osds_out": out,
            "pg_temp_pins": len(self.osdmap.pg_temp),
            "full_pools": dict(self.full_pools),
            "ok": (up == self.osdmap.n_osds and out == 0
                   and not self.osdmap.pg_temp
                   and not self.full_pools),
        }

    async def _mark_down(self, osd: int) -> None:
        inc = self._new_inc()
        inc.down.append(osd)
        self.down_since[osd] = time.monotonic()
        self.last_ping.pop(osd, None)
        await self.commit(inc)

    async def _watch_loop(self) -> None:
        period = min(self.hb_grace, self.out_interval) / 4
        last_tick = time.monotonic()
        while True:
            await asyncio.sleep(period)
            now = time.monotonic()
            # Reactor stall compensation: if this loop itself could not
            # run (single-core host busy, e.g. an XLA compile), peers
            # could not ping either — credit everyone the stall so a
            # blocked process does not read as a dead cluster.
            stall = now - last_tick - period
            last_tick = now
            if stall > period:
                for osd in self.last_ping:
                    self.last_ping[osd] += stall
            for osd, seen in list(self.last_ping.items()):
                if self.osdmap.osds[osd].up and now - seen > self.hb_grace:
                    await self._mark_down(osd)
            # down -> out: zero the reweight so CRUSH re-places the data
            # (capacity elasticity == "edit the map", SURVEY §5)
            for osd, since in list(self.down_since.items()):
                if now - since > self.out_interval and (
                    self.osdmap.osds[osd].weight != 0
                ):
                    inc = self._new_inc()
                    inc.weights[osd] = 0
                    await self.commit(inc)
