"""MgrLite: stats aggregation, health, and the loadable-module host
(the src/mgr DaemonServer/ClusterState + ActivePyModules roles).

Daemons push MMgrReport on their heartbeat cadence (perf-dump JSON +
per-PG state counts); the mgr keeps the latest report per OSD and
serves cluster status / health checks. Everything beyond that runs AS A
MODULE against the MgrModule API (cluster/mgr_module.py): prometheus,
balancer, and pg_autoscaler are built-in modules in
ceph_tpu_torch/mgr_modules/ — the same drop-in file format third-party
modules use via ``load_modules_from(dir)``. Module commands are served
on the admin socket next to the host's own status/health verbs.

Health mirrors the reference's checks it can see: OSD_DOWN (map),
PG_NOT_ACTIVE (reports), MGR_STALE_REPORTS (silence).

ceph_tpu_torch's own copy of ``ceph_tpu/cluster/mgr.py``.
"""
from __future__ import annotations

import asyncio
import json
import sys
import time

from ..utils.admin import AdminSocket
from . import messages as M
from .mgr_module import ModuleHost

HEALTH_OK = "HEALTH_OK"
HEALTH_WARN = "HEALTH_WARN"
HEALTH_ERR = "HEALTH_ERR"


class MgrLite(ModuleHost):
    def __init__(self, bus, mon, stale_secs: float = 5.0,
                 builtin_modules: bool = True):
        ModuleHost.__init__(self)
        self.bus = bus
        self.mon = mon
        self.name = "mgr"
        self.stale_secs = stale_secs
        self.reports: dict[int, dict] = {}  # osd -> {ts, epoch, perf, pgs}
        self.config_mirror: dict[str, str] = {}  # "who/key" -> value
        self.admin: AdminSocket | None = None
        self._sub_task: asyncio.Task | None = None
        self._running = False
        self._last_epoch = 0
        if builtin_modules:
            from ..mgr_modules import BUILTIN

            for name, cls in BUILTIN.items():
                self.load_module(name, cls)

    # ---------------------------------------------------------- lifecycle

    async def start(self) -> None:
        self.bus.register(self.name, self.handle)
        # keep the subscription alive across mon restarts/failovers: a
        # new leader only learns subscribers that speak up, so a
        # periodic idempotent re-subscribe is the liveness mechanism
        self._sub_task = asyncio.get_running_loop().create_task(
            self._subscribe_loop())
        self._running = True
        self._start_all_modules()

    async def _subscribe_loop(self) -> None:
        while True:
            try:
                await self.bus.send(self.name, "mon",
                                    M.MMonSubscribe(what="osdmap"))
            except Exception:
                pass  # no mon yet / mid-election: retry next tick
            try:
                await self.bus.send(
                    self.name, "mon",
                    M.MMgrDigest(digest=json.dumps(
                        self._digest()).encode()))
            except Exception:
                pass
            await asyncio.sleep(1.0)

    def _digest(self) -> dict:
        """Stats digest for the mon (MMonMgrReport role): aggregated
        pg states and per-pool [stored_bytes, objects] — the source
        for `ceph status` / `df` / `pg stat` and quota checks.

        Only UP OSDs contribute: a dead OSD's last report would keep
        counting bytes that recovery re-replicates onto survivors,
        double-counting usage (and falsely tripping quotas)."""
        pg_states: dict[str, int] = {}
        pools: dict[str, list[int]] = {}
        osds: dict[str, list[int]] = {}  # osd -> [bytes, pg instances]
        ops = 0
        osdmap = self.mon.osdmap
        for o, rep in self.reports.items():
            if not (0 <= o < osdmap.n_osds and osdmap.osds[o].up):
                continue
            per_osd = osds.setdefault(str(o), [0, 0])
            for state, n in rep["pgs"].items():
                pg_states[state] = pg_states.get(state, 0) + n
                per_osd[1] += n
            for pid, (b, ob) in rep.get("pools", {}).items():
                ent = pools.setdefault(pid, [0, 0])
                ent[0] += b
                ent[1] += ob
                per_osd[0] += b
            ops += int(rep["perf"].get("op", 0))
        return {"pg_states": pg_states, "pools": pools, "osds": osds,
                "ops": ops}

    async def stop(self) -> None:
        await self._stop_all_modules()
        self._running = False
        self.bus.unregister(self.name)
        if self._sub_task is not None:
            self._sub_task.cancel()
            try:
                await self._sub_task
            except asyncio.CancelledError:
                pass
            self._sub_task = None
        if self.admin is not None:
            await self.admin.stop()
            self.admin = None

    async def start_admin(self, path: str) -> None:
        sock = AdminSocket(path)
        sock.register("status", lambda a: self.status(),
                      "cluster status (ceph -s role)")
        sock.register("health", lambda a: self.health(),
                      "health checks")
        sock.register("config set", self._admin_config_set,
                      "central config: {who, key, value}")
        sock.register("config dump", lambda a: self.config_mirror,
                      "central config DB contents")
        sock.register("mgr modules", lambda a: sorted(self.modules),
                      "loaded mgr modules")
        # every module command rides the same socket (MonCommand role)
        for cmd, (_mod, desc) in sorted(self._commands.items()):
            sock.register(
                cmd,
                lambda a, _c=cmd: self.dispatch_command(_c, a or {}),
                desc)
        await sock.start()
        self.admin = sock

    def _command_added(self, cmd: str, desc: str) -> None:
        if self.admin is not None:
            self.admin.register(
                cmd,
                lambda a, _c=cmd: self.dispatch_command(_c, a or {}),
                desc)

    async def _admin_config_set(self, args: dict):
        await self.bus.send(self.name, "mon", M.MConfigSet(
            who=args["who"], key=args["key"], value=args["value"]))
        return "ok"

    # --------------------------------------------- ModuleHost services

    def _started(self) -> bool:
        return self._running

    def module_get(self, what: str):
        if what == "osd_map":
            return self.mon.osdmap
        if what == "reports":
            return self.reports
        if what == "status":
            return self.status()
        if what == "health":
            return self.health()
        raise KeyError(f"mgr get({what!r}) not served")

    def module_get_store(self, module: str, key: str, default):
        # the mon's central config DB under who="mgr" is the module KV
        # (MonKVStore role); empty string encodes a deleted key
        val = self.config_mirror.get(f"mgr/{module}/{key}")
        return default if not val else val

    async def module_set_store(self, module: str, key: str,
                               value: str | None) -> None:
        full_key = f"{module}/{key}"
        self.config_mirror[f"mgr/{full_key}"] = value or ""
        await self.bus.send(self.name, "mon", M.MConfigSet(
            who="mgr", key=full_key, value=value or ""))

    async def module_send_mon(self, msg) -> None:
        await self.bus.send(self.name, "mon", msg)

    def module_log(self, module: str, msg: str) -> None:
        print(f"[mgr.{module}] {msg}", file=sys.stderr)

    # ---------------------------------------------- back-compat surface

    async def autoscale_once(self, target_per_osd: int = 100) -> dict:
        """One pg_autoscaler round (kept as a host method; the logic
        lives in the pg_autoscaler module)."""
        return await self.modules["pg_autoscaler"].run_once(
            target_per_osd)

    def render_prometheus(self) -> str:
        return self.modules["prometheus"].render()

    async def handle(self, src: str, msg) -> None:
        if isinstance(msg, M.MMgrReport):
            self.reports[msg.osd] = {
                "ts": time.time(),
                "epoch": msg.epoch,
                "perf": json.loads(msg.perf.decode() or "{}"),
                "pgs": dict(msg.pgs),
                "pools": json.loads(msg.pools.decode() or "{}"),
            }
            self.notify_all("reports", msg.osd)
            epoch = self.mon.osdmap.epoch
            if epoch != self._last_epoch:
                self._last_epoch = epoch
                self.notify_all("osd_map", epoch)
        elif isinstance(msg, M.MConfig):
            self.config_mirror = {
                f"{w}/{k}": v for w, k, v in msg.entries}

    # ------------------------------------------------------------ surface

    def status(self) -> dict:
        osdmap = self.mon.osdmap
        up = sum(1 for o in osdmap.osds if o.up)
        inn = sum(1 for o in osdmap.osds if o.weight > 0)
        pg_states: dict[str, int] = {}
        ops = 0
        for rep in self.reports.values():
            for state, n in rep["pgs"].items():
                pg_states[state] = pg_states.get(state, 0) + n
            ops += int(rep["perf"].get("op", 0))
        return {
            "health": self.health()["status"],
            "epoch": osdmap.epoch,
            "osds": {"total": osdmap.n_osds, "up": up, "in": inn},
            "pools": len(osdmap.pools),
            "pgs": pg_states,
            "client_ops_total": ops,
            "mgr_modules": sorted(self.modules),
        }

    def health(self) -> dict:
        checks: dict[str, str] = {}
        osdmap = self.mon.osdmap
        down = [i for i, o in enumerate(osdmap.osds)
                if o.exists and not o.up]
        if down:
            checks["OSD_DOWN"] = f"{len(down)} osds down: {down}"
        now = time.time()
        stale = [o for o, rep in self.reports.items()
                 if now - rep["ts"] > self.stale_secs
                 and o not in down
                 and osdmap.osds[o].up]
        if stale:
            checks["MGR_STALE_REPORTS"] = (
                f"no recent reports from osds {sorted(stale)}"
            )
        inactive = 0
        for o, rep in self.reports.items():
            if osdmap.osds[o].up:
                inactive += sum(
                    n for state, n in rep["pgs"].items()
                    if state != "active"
                )
        if inactive:
            checks["PG_NOT_ACTIVE"] = f"{inactive} pg instances not active"
        status = HEALTH_OK if not checks else HEALTH_WARN
        return {"status": status, "checks": checks}
