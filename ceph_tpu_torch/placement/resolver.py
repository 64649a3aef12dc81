"""PlacementResolver: the batched placement service of the serving
plane.

Every client op needs (up, acting, primary) for its pgid, and
recomputing host straw2 for it is per-op Python work. Within an epoch
CRUSH is a pure function of the map, so the resolver memoizes results
EPOCH-KEYED (one dict hit per op in steady state, invalidated wholesale
the instant the map moves) and resolves misses through the bulk-CRUSH
engine (placement/bulk.py; on the card its kernel csrc/crush_rule.cu) in
coalesced batches behind the
same window/size trigger discipline the ECBatcher uses: misses arriving
within ``client_placement_batch_window`` seconds — or until
``client_placement_batch_target`` pgids are queued — ride ONE device
dispatch instead of N host descents.

Placement is never a liveness dependency:

- the sync surface (``up_acting``/``full``) serves hits from the memo
  and misses from the host pipeline immediately — it is the drop-in
  replacement for the old ``PlacementMemo`` and what daemons use;
- the async surface parks misses on the coalescing window, and the
  policy routes — unsupported map shape (``CompiledMap`` rejects it),
  an epoch that moved mid-dispatch, a batch below
  ``client_placement_batch_min``, a cold (rule, size) whose first
  dispatch would stall the waiters on the kernel's build and load —
  serve exactly the affected waiters from the host pipeline;
- an engine that fails (no card, a kernel that does not build or
  launch) is not a policy route: its error reaches the waiters of the
  batch (and ``prewarm``'s caller), and a failed background warm
  reaches the next batch of its (rule, size);
- ``CEPH_TPU_PLACEMENT_BATCH=0`` is the A/B lever: the async surface
  becomes pure memo+host, so a bench pair attributes the win.

Device rows feed ``OSDMap.raw_to_up_acting`` — the SAME post-CRUSH
host code (upmap, up-filter, affinity, pg_temp) the per-pg path runs,
so batched results are bit-identical by construction (and asserted in
tests/test_placement_resolver.py and, against the JAX package's
resolver, tests/test_torch_resolver.py).

Counters (``stats``): placement_cache_hits / placement_cache_misses /
placement_batch_lookups (device dispatches) / placement_batched_pgids /
placement_host_resolves / placement_epoch_invalidations — the evidence
bench configs 6 and 10 report.

The device half is the port's: ``device`` names where batches run (None:
the CUDA card; ``"cpu"``: the engine's plain version), and a batch goes
to the engine unpadded (the kernel takes any batch; the JAX package
padded every batch to one shape so XLA compiled once per combination).
The cold/warm shield is keyed by (rule, size) alone: the batch length
costs the kernel nothing.
"""
from __future__ import annotations

import asyncio
import functools
import os

import numpy as np

from . import crushmap as cm

#: the bulk engine (placement/bulk.py) pulls in the kernels module;
#: daemons and clients import THIS module at boot, and most processes
#: (tests, tools, every mon/osd subprocess) never dispatch a batch — so
#: the engine loads lazily on the first actual compile, not at import
bulk = None


def _load_bulk():
    global bulk
    if bulk is None:
        from . import bulk as _bulk
        bulk = _bulk
    return bulk


def _batch_enabled() -> bool:
    return os.environ.get("CEPH_TPU_PLACEMENT_BATCH", "1") != "0"


class _MapCompile:
    """Per-CrushMap compile cache entry. Holds a strong reference to
    the CrushMap so an id() can never alias a GC'd map, and remembers
    a rejection (unsupported shape) so it is not re-attempted."""

    __slots__ = ("crush", "compiled", "rejected", "warm", "warming",
                 "cold_seen", "warm_errors")

    def __init__(self, crush):
        self.crush = crush
        self.compiled: bulk.CompiledMap | None = None
        self.rejected = False
        #: (ruleno, numrep) combos that ARE warm:
        #: only these dispatch on the op path — a cold combo's first
        #: dispatch (the kernel's nvcc build and load) must never stall
        #: parked ops, so cold flushes host-serve and warm in the
        #: background
        self.warm: set[tuple] = set()
        #: combos with a background warm in flight (dedup)
        self.warming: set[tuple] = set()
        #: cold miss-storms seen per combo: the background warm only
        #: kicks on the SECOND storm — a workload whose misses are a
        #: one-shot warm-up burst (config 6: stable map, pure hits
        #: after the first window) never pays a build at all, while
        #: epoch-churning workloads (swarm under thrash) warm on their
        #: second storm and dispatch device from the third
        self.cold_seen: dict[tuple, int] = {}
        #: a background warm's engine error, raised to the next batch of
        #: its combo
        self.warm_errors: dict[tuple, Exception] = {}


class PlacementStats:
    """Plain-int counter block (resolver instances live on the event
    loop; no lock needed)."""

    FIELDS = ("placement_cache_hits", "placement_cache_misses",
              "placement_batch_lookups", "placement_batched_pgids",
              "placement_host_resolves",
              "placement_epoch_invalidations",
              "placement_bg_warms")

    def __init__(self) -> None:
        for f in self.FIELDS:
            setattr(self, f, 0)

    def dump(self) -> dict[str, int]:
        return {f: getattr(self, f) for f in self.FIELDS}

    @property
    def hit_rate(self) -> float:
        total = self.placement_cache_hits + self.placement_cache_misses
        return self.placement_cache_hits / total if total else 0.0

    @staticmethod
    def aggregate(dumps) -> dict:
        """Sum per-resolver counter dumps (clients + daemons) and
        derive the combined hit_rate — the ONE home for the roll-up
        the bench and swarm payloads report."""
        total: dict = {}
        for d in dumps:
            for key, val in d.items():
                total[key] = total.get(key, 0) + val
        hits = total.get("placement_cache_hits", 0)
        misses = total.get("placement_cache_misses", 0)
        total["hit_rate"] = (round(hits / (hits + misses), 4)
                             if hits + misses else 0.0)
        return total


class PlacementResolver:
    """Epoch-keyed memoized CRUSH with batched device miss resolution.

    Owned by clients and daemons whose map only changes through epochs
    (same contract as the old PlacementMemo — NOT for the mon or tools
    that edit map objects in place without bumping the epoch)."""

    def __init__(self, conf=None, batch: bool | None = None,
                 device=None) -> None:
        self.conf = conf
        #: where batches run: None is the CUDA card, "cpu" the plain
        #: version of the engine
        self.device = device
        self.stats = PlacementStats()
        self._map = None
        self._epoch = -1
        self._memo: dict[tuple[int, int], tuple] = {}
        #: miss coalescing window: pool id -> [(pgid, fut)]
        self._pending: dict[int, list] = {}
        self._timers: dict[int, object] = {}
        self._scheduled: set[int] = set()
        #: compile cache, keyed by id(crushmap) with a strong map ref
        #: inside the entry (no GC aliasing)
        self._compiles: dict[int, _MapCompile] = {}
        self._batch = _batch_enabled() if batch is None else batch

    # -------------------------------------------------------- knobs

    def _window(self) -> float:
        if self.conf is None:
            return 0.002
        try:
            return float(self.conf["client_placement_batch_window"])
        except Exception:
            return 0.002

    def _target(self) -> int:
        if self.conf is None:
            return 64
        try:
            return int(self.conf["client_placement_batch_target"])
        except Exception:
            return 64

    def _min_batch(self) -> int:
        if self.conf is None:
            return 16
        try:
            return int(self.conf["client_placement_batch_min"])
        except Exception:
            return 16

    # ------------------------------------------------------ sync path

    def _sync_epoch(self, osdmap) -> None:
        if self._map is not osdmap or osdmap.epoch != self._epoch:
            if self._map is not None:
                self.stats.placement_epoch_invalidations += 1
            self._map = osdmap
            self._epoch = osdmap.epoch
            self._memo.clear()

    def full(self, osdmap, pgid: tuple[int, int]
             ) -> tuple[list[int], int, list[int], int]:
        """(up, up_primary, acting, acting_primary) — memo hit or an
        immediate host resolve (the PlacementMemo-compatible surface;
        fresh lists per call, callers mutate their vectors)."""
        self._sync_epoch(osdmap)
        hit = self._memo.get(pgid)
        if hit is not None:
            self.stats.placement_cache_hits += 1
            up_t, upp, act_t, ap = hit
            return list(up_t), upp, list(act_t), ap
        self.stats.placement_cache_misses += 1
        self.stats.placement_host_resolves += 1
        up, upp, acting, ap = osdmap.pg_to_up_acting_full(pgid)
        self._memo[pgid] = (tuple(up), upp, tuple(acting), ap)
        return up, upp, acting, ap

    def up_acting(self, osdmap, pgid: tuple[int, int]
                  ) -> tuple[list[int], int]:
        _up, _upp, acting, ap = self.full(osdmap, pgid)
        return acting, ap

    # ----------------------------------------------------- async path

    async def afull(self, osdmap, pgid: tuple[int, int]
                    ) -> tuple[list[int], int, list[int], int]:
        """Like ``full`` but misses park on the coalescing window and
        resolve through one batched device lookup; hits return
        inline. An engine failure raises here."""
        self._sync_epoch(osdmap)
        hit = self._memo.get(pgid)
        if hit is not None:
            self.stats.placement_cache_hits += 1
            up_t, upp, act_t, ap = hit
            return list(up_t), upp, list(act_t), ap
        self.stats.placement_cache_misses += 1
        if not self._batch:
            return self._host_fill(osdmap, pgid)
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        pool_id = pgid[0]
        queue = self._pending.setdefault(pool_id, [])
        queue.append((osdmap, pgid, fut))
        self._poke(pool_id, len(queue))
        up, upp, acting, ap = await fut
        return list(up), upp, list(acting), ap

    async def aup_acting(self, osdmap, pgid: tuple[int, int]
                         ) -> tuple[list[int], int]:
        _up, _upp, acting, ap = await self.afull(osdmap, pgid)
        return acting, ap

    def _host_fill(self, osdmap, pgid) -> tuple:
        self.stats.placement_host_resolves += 1
        up, upp, acting, ap = osdmap.pg_to_up_acting_full(pgid)
        if self._map is osdmap and self._epoch == osdmap.epoch:
            self._memo[pgid] = (tuple(up), upp, tuple(acting), ap)
        return up, upp, acting, ap

    # ------------------------------------------------- window policy

    def _poke(self, pool_id: int, queued: int) -> None:
        if pool_id in self._scheduled:
            return
        if queued >= self._target():
            self._arm_now(pool_id)
            return
        window = self._window()
        if window <= 0:
            self._arm_now(pool_id)
            return
        if pool_id not in self._timers:
            loop = asyncio.get_running_loop()
            self._timers[pool_id] = loop.call_later(
                window, self._flush, pool_id)
            # idle probe (the ECBatcher fast-flush stance): once the
            # loop drains its current ready set with no new miss
            # joining, nothing else can contribute this tick — flush
            # now instead of sleeping out the window. A serial caller
            # (tests, tools, cold single ops) pays ~one loop tick,
            # not 2 ms per miss; a same-tick burst still coalesces
            # whole, and a growing cross-tick storm keeps re-arming
            # until the size target or the window deadline fires.
            loop.call_soon(self._idle_probe, pool_id, queued)

    def _idle_probe(self, pool_id: int, seen: int) -> None:
        items = self._pending.get(pool_id)
        if items is None or pool_id in self._scheduled:
            return
        if len(items) == seen:
            self._flush(pool_id)
        else:
            asyncio.get_running_loop().call_soon(
                self._idle_probe, pool_id, len(items))

    def _arm_now(self, pool_id: int) -> None:
        self._scheduled.add(pool_id)
        asyncio.get_running_loop().call_soon(self._flush, pool_id)

    def _flush(self, pool_id: int) -> None:
        self._scheduled.discard(pool_id)
        timer = self._timers.pop(pool_id, None)
        if timer is not None:
            timer.cancel()
        items = self._pending.pop(pool_id, None)
        if not items:
            return
        asyncio.get_running_loop().create_task(
            self._run_batch(pool_id, items))

    # ---------------------------------------------------- batch body

    def _compile_for(self, crush) -> bulk.CompiledMap | None:
        entry = self._compiles.get(id(crush))
        if entry is None or entry.crush is not crush:
            # a new crush map supersedes the old entries: drop them
            # (each pins the full CrushMap + device arrays for the
            # process lifetime otherwise, and only the current map is
            # ever looked up again). In-flight batches/warms hold
            # their entry by reference and finish unharmed; losing a
            # stale warm-set just means the next storm re-warms —
            # the built kernel is per process and survives anyway.
            self._compiles.clear()
            entry = _MapCompile(crush)
            self._compiles[id(crush)] = entry
        if entry.rejected:
            return None
        if entry.compiled is None:
            try:
                entry.compiled = _load_bulk().CompiledMap(crush)
            except ValueError:
                # unsupported map shape: host oracle territory, and
                # stays that way for this map (never re-probed)
                entry.rejected = True
                return None
        return entry.compiled

    async def _run_batch(self, pool_id: int, items: list) -> None:
        # one flush can hold entries against different map objects
        # (client reconnect churn); group them
        by_map: dict[int, list] = {}
        for osdmap, pgid, fut in items:
            by_map.setdefault(id(osdmap), []).append(
                (osdmap, pgid, fut))
        for group in by_map.values():
            try:
                await self._run_group(pool_id, group)
            except Exception as e:
                # the engine failed: its error is the waiters' answer
                for _m, _pgid, fut in group:
                    if not fut.done():
                        fut.set_exception(e)

    async def _run_group(self, pool_id: int, group: list) -> None:
        osdmap = group[0][0]
        pool = osdmap.pools.get(pool_id)
        compiled = (None if pool is None
                    else self._compile_for(osdmap.crush))
        # dedup pgids: N waiters for one pgid cost one lane
        pgids = sorted({pgid for _m, pgid, _f in group})
        if compiled is None or len(pgids) < self._min_batch():
            self._resolve_host(group)
            return
        entry = self._compiles[id(osdmap.crush)]
        key = (pool.crush_rule, pool.size)
        error = entry.warm_errors.pop(key, None)
        if error is not None:
            raise error
        if key not in entry.warm:
            # cold (map, rule, size): the first dispatch (the kernel's
            # build and load) must NEVER stall parked ops — host-serve
            # the waiters now; a SECOND cold storm means the workload
            # re-misses (epoch churn), so warm then
            self._resolve_host(group)
            entry.cold_seen[key] = entry.cold_seen.get(key, 0) + 1
            if (entry.cold_seen[key] >= 2
                    and self.stats.placement_epoch_invalidations):
                # warm ONLY for epoch-churning workloads: on a stable
                # map every miss is one-shot warm-up (pure memo hits
                # forever after), and a warm dispatch buys nothing
                # back. Map churn is what makes misses recur; it is
                # also the gate (startup warming that wants the device
                # path regardless calls prewarm()).
                self._kick_warm(entry, osdmap, pool, key)
            return
        epoch0 = osdmap.epoch
        rows = await self._device_rows(osdmap, pool, compiled, pgids)
        if (osdmap.epoch != epoch0 or self._map is not osdmap
                or self._epoch != epoch0):
            # the epoch moved mid-dispatch, or the resolver has seen a
            # DIFFERENT map object since this batch was queued (a mon
            # gap-fill REPLACES the map wholesale, so its epoch alone
            # can't witness the change) — in either case the computed
            # rows describe a map that no longer exists; never memoize
            # them, and never roll the resolver's view back to the
            # batch's map: the waiters get fresh host answers on their
            # own (current) maps instead
            self._resolve_host(group)
            return
        self.stats.placement_batch_lookups += 1
        self.stats.placement_batched_pgids += len(pgids)
        table: dict[tuple[int, int], tuple] = {}
        for pgid, (raw, pps) in zip(pgids, rows):
            up, upp, acting, ap = osdmap.raw_to_up_acting(
                pgid, raw, pps)
            memo_row = (tuple(up), upp, tuple(acting), ap)
            table[pgid] = memo_row
            self._memo[pgid] = memo_row
        for _m, pgid, fut in group:
            if not fut.done():
                fut.set_result(table[pgid])

    def _kick_warm(self, entry: _MapCompile, osdmap, pool,
                   key: tuple) -> None:
        """Warm the bulk engine for one (rule, numrep) combo off the op
        path: a throwaway dispatch of one size target (it builds and
        loads the kernel on first use). Marks the combo warm on success;
        a failure is kept for the combo's next batch to raise."""
        if key in entry.warming or key in entry.warm:
            return
        entry.warming.add(key)
        ruleno, numrep = key
        xs = np.arange(self._target(), dtype=np.uint32)
        weights = np.array(osdmap.out_weights(), dtype=np.uint32,
                           copy=True)
        loop = asyncio.get_running_loop()

        async def warm() -> None:
            try:
                await loop.run_in_executor(
                    None, functools.partial(
                        bulk.do_rule_bulk, entry.compiled, ruleno, xs,
                        numrep, weights, device=self.device))
            except Exception as e:
                entry.warm_errors[key] = e
            else:
                entry.warm.add(key)
                self.stats.placement_bg_warms += 1
            finally:
                entry.warming.discard(key)

        loop.create_task(warm())

    def _resolve_host(self, group: list) -> None:
        for osdmap, pgid, fut in group:
            if fut.done():
                continue
            try:
                fut.set_result(tuple(self._host_fill(osdmap, pgid)))
            except Exception as e:  # pool vanished mid-window
                fut.set_exception(e)

    async def _device_rows(self, osdmap, pool, compiled, pgids,
                           ) -> list[tuple[list[int], int]]:
        """One bulk-CRUSH dispatch over the miss batch. Inputs (pps
        seeds, reweight vector, epoch) are snapshotted on the loop;
        the executor runs only the pure device dispatch."""
        pps = np.array([pool.raw_pg_to_pps(ps) for _p, ps in pgids],
                       dtype=np.uint32)
        weights = osdmap.out_weights()
        rule = compiled.compile_rule(pool.crush_rule, pool.size)
        firstn = rule.op in (cm.OP_CHOOSE_FIRSTN, cm.OP_CHOOSELEAF_FIRSTN)
        loop = asyncio.get_running_loop()
        out = await loop.run_in_executor(
            None, self._bulk_sync, compiled, pool.crush_rule,
            pps, pool.size, weights)
        rows: list[tuple[list[int], int]] = []
        for i in range(len(pgids)):
            raw = [int(v) for v in out[i]]
            if firstn:
                # the device engine NONE-pads short firstn rows at the
                # tail; the host pipeline expects the compacted form
                while raw and raw[-1] == cm.ITEM_NONE:
                    raw.pop()
            rows.append((raw, int(pps[i])))
        return rows

    def _bulk_sync(self, compiled, ruleno, pps, numrep,
                   weights) -> np.ndarray:
        return bulk.do_rule_bulk(compiled, ruleno, pps, numrep, weights,
                                 device=self.device)

    # -------------------------------------------------------- prewarm

    async def prewarm(self, osdmap, pool_ids) -> int:
        """Warm the bulk engine and device-resolve EVERY pgid of the
        given pools — the serving-process startup warm (config 10 calls
        it before the measured phase so a cold kernel build never rides
        a client op). Returns the number of pgids resolved: 0 with
        batching off, none of an unsupported map's. An engine failure
        raises.
        """
        if not self._batch:
            return 0
        self._sync_epoch(osdmap)
        warmed = 0
        target = self._target()
        for pool_id in pool_ids:
            pool = osdmap.pools.get(pool_id)
            if pool is None:
                continue
            compiled = self._compile_for(osdmap.crush)
            if compiled is None:
                continue
            entry = self._compiles[id(osdmap.crush)]
            all_pgids = [(pool_id, ps) for ps in range(pool.pg_num)]
            # chunk by the flush size-target: the batches op-path
            # flushes dispatch
            for lo in range(0, len(all_pgids), target):
                chunk = all_pgids[lo: lo + target]
                self._sync_epoch(osdmap)  # adopt bumps between chunks
                epoch0 = osdmap.epoch
                rows = await self._device_rows(osdmap, pool, compiled,
                                               chunk)
                entry.warm.add((pool.crush_rule, pool.size))
                if (self._map is not osdmap
                        or self._epoch != epoch0
                        or osdmap.epoch != epoch0):
                    # the map moved (in place or by replacement) while
                    # the dispatch was out: the engine is warm — that was
                    # the point — but these rows describe a dead map
                    # state and must NOT be memoized under the new
                    # epoch (they would serve stale primaries as cache
                    # HITS until the next bump)
                    continue
                self.stats.placement_batch_lookups += 1
                self.stats.placement_batched_pgids += len(chunk)
                for pgid, (raw, pps) in zip(chunk, rows):
                    up, upp, acting, ap = osdmap.raw_to_up_acting(
                        pgid, raw, pps)
                    self._memo[pgid] = (tuple(up), upp, tuple(acting),
                                        ap)
                warmed += len(chunk)
        return warmed

    def close(self) -> None:
        """Cancel armed windows and fail parked waiters cleanly."""
        for t in self._timers.values():
            t.cancel()
        self._timers.clear()
        self._scheduled.clear()
        pending, self._pending = self._pending, {}
        for items in pending.values():
            for _m, _p, fut in items:
                if not fut.done():
                    fut.cancel()
