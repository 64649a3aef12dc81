"""TestCluster: in-process dev cluster (the src/vstart.sh role).

Assembles mon + N OSDs + a client on a LocalBus, with the thrashing
hooks the qa tier uses (kill_osd / revive_osd / blackhole, the
OSDThrasher verbs of qa/tasks/ceph_manager.py:202). OSD stores survive
kill/revive — a revived OSD mounts the same store, exactly like a
restarted daemon finding its data on disk.

ceph_tpu_torch's own copy of ``ceph_tpu/cluster/vstart.py``. ``device``
(new) is resolved once and handed to every OSD and the client: the CUDA
card unless the caller names another (the CPU tests pass ``"cpu"``);
with none named and no card, construction raises. A quorum of mons
(``n_mons > 1``) runs on ``paxos_mon`` and uses no device.
"""
from __future__ import annotations

import asyncio

from ..device import resolve
from ..msg.messenger import LocalBus
from ..placement import crushmap as cm
from ..store.memstore import MemStore
from .client import RadosClient
from .faults import FaultPlane
from .mgr import MgrLite
from .mon import MonLite
from .osd import OSDLite


class _LeaderRef:
    """Late-bound view of the current mon leader (the mgr keeps
    reading the authoritative map across failovers)."""

    def __init__(self, cluster: "TestCluster"):
        self._c = cluster

    @property
    def osdmap(self):
        return self._c.mon.osdmap


class TestCluster:
    def __init__(self, n_osds: int = 5, hb_grace: float = 2.0,
                 out_interval: float = 4.0, hb_interval: float = 0.15,
                 crush: cm.CrushMap | None = None, n_mons: int = 1,
                 objectstore: str = "memstore",
                 data_dir: str | None = None,
                 osd_conf: dict | None = None,
                 faults: FaultPlane | None = None,
                 fault_seed: int = 0, device=None, **store_kw):
        self.device = resolve(device)
        #: the cluster's fault authority (cluster/faults.py): the bus
        #: honors its net policy, every (re)started OSD attaches its
        #: store injector, and the Thrasher drives lifecycle through it
        self.faults = faults if faults is not None \
            else FaultPlane(fault_seed)
        self.bus = LocalBus(faults=self.faults.net)
        self.n_osds = n_osds
        self.n_mons = n_mons
        self._hb_grace = hb_grace
        self._out_interval = out_interval
        self._crush = crush
        #: config overrides applied to every OSD before it boots (the
        #: vstart.sh `-o key=value` role) — e.g. the EC batch
        #: coalescing knobs or osd_op_concurrency
        self.osd_conf = dict(osd_conf or {})

        def _mon_store(rank: int):
            # durable clusters put mon state on the native kv too
            # (MonitorDBStore role) so a cold restart keeps the maps
            if data_dir is None:
                return None
            from .monstore import MonStore

            return MonStore(f"{data_dir}/mon.{rank}.kv")

        self._make_mon_store = _mon_store
        if n_mons > 1:
            from .paxos_mon import PaxosMon

            self.mons: list = [
                PaxosMon(self.bus, n_osds, rank=r, n_mons=n_mons,
                         crush=crush, hb_grace=hb_grace,
                         out_interval=out_interval,
                         store=_mon_store(r))
                for r in range(n_mons)
            ]
            self._mon = None
        else:
            self.mons = []
            self._mon = MonLite(self.bus, n_osds, crush=crush,
                                hb_grace=hb_grace,
                                out_interval=out_interval,
                                store=_mon_store(0))
        if objectstore == "memstore":
            self.stores = [MemStore() for _ in range(n_osds)]
        else:  # vstart.sh --bluestore role: one store dir per OSD
            from .. import store as store_mod

            assert data_dir is not None, "durable stores need data_dir"
            self.stores = [
                store_mod.create(objectstore, f"{data_dir}/osd.{i}",
                                 **store_kw)
                for i in range(n_osds)
            ]
        self.osds: list[OSDLite | None] = [None] * n_osds
        self.hb_interval = hb_interval
        self.mgr = MgrLite(self.bus, _LeaderRef(self), device=self.device)
        self.client = RadosClient(self.bus, device=self.device)

    @property
    def mon(self):
        """The authoritative mon: the single one, or the quorum
        leader (falling back to any live replica)."""
        if self._mon is not None:
            return self._mon
        for m in self.mons:
            if m is not None and m.is_leader():
                return m
        return next(m for m in self.mons if m is not None)

    async def start(self) -> None:
        if self._mon is not None:
            await self._mon.start()
        else:
            for m in self.mons:
                await m.start()
            await self.wait_quorum()
        await self.mgr.start()
        for i in range(self.n_osds):
            await self.start_osd(i)
        await self.client.connect()

    async def wait_quorum(self, timeout: float = 10.0) -> None:
        async def _wait():
            while not any(m is not None and m.is_leader()
                          for m in self.mons):
                await asyncio.sleep(0.02)
        await asyncio.wait_for(_wait(), timeout)

    async def kill_mon(self, rank: int) -> None:
        m = self.mons[rank]
        if m is not None:
            await m.stop()
            self.mons[rank] = None

    async def revive_mon(self, rank: int):
        """Restart a killed quorum mon (mon failover orchestration for
        the thrasher): the fresh replica rejoins and catches up via the
        collect round — or from its durable MonStore when one exists."""
        assert self.n_mons > 1 and self.mons[rank] is None
        from .paxos_mon import PaxosMon

        m = PaxosMon(self.bus, self.n_osds, rank=rank,
                     n_mons=self.n_mons, crush=self._crush,
                     hb_grace=self._hb_grace,
                     out_interval=self._out_interval,
                     store=self._make_mon_store(rank))
        self.mons[rank] = m
        await m.start()
        return m

    async def stop(self) -> None:
        try:
            await self.client.close()
            for i, osd in enumerate(self.osds):
                if osd is not None:
                    await osd.stop()
                    self.osds[i] = None
            await self.mgr.stop()
            if self._mon is not None:
                await self._mon.stop()
            for m in self.mons:
                if m is not None:
                    await m.stop()
        finally:  # a failed daemon stop must not leak mounted stores
            for s in self.stores:
                s.umount()

    async def start_osd(self, i: int) -> OSDLite:
        conf = None
        if self.osd_conf:
            from ..utils import config as cfg

            conf = cfg.proxy()
            conf.apply(self.osd_conf)
        osd = OSDLite(self.bus, i, store=self.stores[i],
                      hb_interval=self.hb_interval, conf=conf,
                      device=self.device)
        self.osds[i] = osd
        self.faults.attach_osd(osd)
        await osd.start()
        return osd

    async def kill_osd(self, i: int) -> None:
        """Crash-stop: deregister from the bus without goodbye; the mon
        notices via heartbeat timeout."""
        osd = self.osds[i]
        if osd is not None:
            await osd.stop()
            self.osds[i] = None

    async def revive_osd(self, i: int) -> OSDLite:
        return await self.start_osd(i)

    async def flap_osd(self, i: int, downtime: float = 0.5) -> OSDLite:
        """Kill + revive in one verb (the thrasher's flap): crash-stop,
        wait the mon's failure detection out, revive onto the same
        store (a restarted daemon finding its data on disk)."""
        await self.kill_osd(i)
        try:
            await self.wait_down(i, timeout=max(10.0, downtime * 4))
        except asyncio.TimeoutError:
            pass  # partitioned mon may lag; revive regardless
        if downtime > 0:
            await asyncio.sleep(downtime)
        return await self.revive_osd(i)

    async def wait_epoch(self, epoch: int, timeout: float = 10.0) -> None:
        """Block until the mon map reaches `epoch`."""
        async def _wait():
            while self.mon.osdmap.epoch < epoch:
                await asyncio.sleep(0.02)
        await asyncio.wait_for(_wait(), timeout)

    async def wait_down(self, osd_id: int, timeout: float = 10.0) -> None:
        async def _wait():
            while self.mon.osdmap.osds[osd_id].up:
                await asyncio.sleep(0.02)
        await asyncio.wait_for(_wait(), timeout)

    async def scrub_pg(self, pgid: tuple[int, int]) -> dict:
        """Run a scrub round on pgid's primary (the `ceph pg scrub`
        verb)."""
        up, primary = self.mon.osdmap.pg_to_up_acting_osds(pgid)
        osd = self.osds[primary]
        assert osd is not None, f"primary osd.{primary} is down"
        pg = osd._pg_for_primary(pgid)
        assert pg is not None
        return await pg.scrub()

    async def wait_clean(self, timeout: float = 30.0) -> None:
        """wait_active AND every pg_temp pin cleared (the data of any
        re-placement actually moved) — `wait for clean` proper."""
        await self.wait_active(timeout)

        async def _wait():
            while self.mon.osdmap.pg_temp:
                await asyncio.sleep(0.02)
        await asyncio.wait_for(_wait(), timeout)
        await self.wait_active(timeout)

    async def wait_active(self, timeout: float = 10.0) -> None:
        """Wait until every live OSD's PGs are active and map epochs have
        converged (the `ceph health` wait-for-clean role)."""
        async def _wait():
            while True:
                await asyncio.sleep(0.02)
                epoch = self.mon.osdmap.epoch
                live = [o for o in self.osds if o is not None]
                if not all(o.osdmap is not None and
                           o.osdmap.epoch == epoch for o in live):
                    continue
                if all(pg.state == "active"
                       for o in live for pg in o.pgs.values()):
                    return
        await asyncio.wait_for(_wait(), timeout)
