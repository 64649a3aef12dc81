"""dashboard mgr module: a read-only web UI over the mgr's state (the
src/pybind/mgr/dashboard role, reduced to its monitoring slice — the
reference's ~30 K-LoC management UI stays a documented skip; what ships
is the at-a-glance cluster page + JSON API the role exists for).

Serves through the shared HttpFrontend plumbing (the same
rgw_asio_frontend-role server the S3/Swift dialects subclass): ``GET
/`` renders an auto-refreshing HTML status page (health banner,
OSD/pool/PG tables, per-OSD op counters), ``GET
/api/status|health|osds`` the same data as JSON. Port via module
option ``port`` (0 = ephemeral; the bound address lands on
``self.addr`` for tests/tooling).

ceph_tpu_torch's own copy of ``ceph_tpu/mgr_modules/dashboard.py``.
"""
from __future__ import annotations

import asyncio
import html
import json

from ..cluster.mgr_module import MgrModule
from ..services.rgw import HttpFrontend

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8">
<meta http-equiv="refresh" content="5">
<title>ceph-tpu dashboard</title>
<style>
 body {{ font-family: sans-serif; margin: 2em; }}
 .ok {{ background: #2e7d32; }} .warn {{ background: #e65100; }}
 .banner {{ color: white; padding: .6em 1em; border-radius: 4px; }}
 table {{ border-collapse: collapse; margin: 1em 0; }}
 td, th {{ border: 1px solid #ccc; padding: .3em .8em; }}
 th {{ background: #eee; }}
</style></head><body>
<h1>ceph-tpu</h1>
<div class="banner {cls}">{health}{checks}</div>
<h2>Cluster</h2>
<table>
<tr><th>epoch</th><th>OSDs up/in/total</th><th>pools</th>
<th>client ops</th><th>modules</th></tr>
<tr><td>{epoch}</td><td>{up}/{inn}/{total}</td><td>{pools}</td>
<td>{ops}</td><td>{modules}</td></tr>
</table>
<h2>PGs</h2><table><tr><th>state</th><th>count</th></tr>{pgs}</table>
<h2>OSDs</h2>
<table><tr><th>osd</th><th>up</th><th>weight</th><th>ops</th></tr>
{osds}</table>
</body></html>"""


class _Frontend(HttpFrontend):
    """The dashboard HTTP dialect over the shared server plumbing."""

    def __init__(self, module: "Module"):
        self.module = module
        self._server = None  # stop() before start() must be a no-op
        self.port = 0

    async def _handle(self, method: str, target: str, headers: dict,
                      body: bytes) -> tuple[int, dict, bytes]:
        if method not in ("GET", "HEAD"):
            return 405, {"content-type": "text/plain"}, b"GET only"
        m = self.module
        path = target.split("?", 1)[0]
        if path == "/":
            return 200, {"content-type": "text/html; charset=utf-8"}, \
                m._page()
        if path == "/api/status":
            return self._json(m.get("status"))
        if path == "/api/health":
            return self._json(m.get("health"))
        if path == "/api/osds":
            return self._json(m._osds())
        return 404, {"content-type": "text/plain"}, b"not found"

    @staticmethod
    def _json(obj) -> tuple[int, dict, bytes]:
        return 200, {"content-type": "application/json"}, \
            json.dumps(obj).encode()


class Module(MgrModule):
    """OPT-IN like the reference (`ceph mgr module enable dashboard`):
    loading the module registers its commands but binds NO socket;
    `dashboard start` (or the ``port`` module option) brings the
    server up — a fleet of TestCluster/bench mgrs must not each open
    an unauthenticated listener as a side effect of existing."""

    MODULE_OPTIONS = [{"name": "port", "default": ""}]
    COMMANDS = [
        {"cmd": "dashboard start",
         "desc": "bind the dashboard server (args: port, default "
                 "ephemeral)"},
        {"cmd": "dashboard url",
         "desc": "bound address of the dashboard server"},
    ]

    addr: tuple[str, int] | None = None
    _fe: _Frontend | None = None
    _bind_lock: asyncio.Lock | None = None

    async def handle_command(self, cmd: str, args: dict):
        if cmd == "dashboard start":
            await self._bind(int(args.get("port", 0)))
        return {"url": f"http://{self.addr[0]}:{self.addr[1]}/"
                if self.addr else None}

    # ------------------------------------------------------------ server

    async def _bind(self, port: int) -> None:
        # serialized: two concurrent starts must not double-bind (the
        # overwritten listener would leak past shutdown)
        if self._bind_lock is None:
            self._bind_lock = asyncio.Lock()
        async with self._bind_lock:
            if self.addr is not None:
                if port and port != self.addr[1]:
                    raise IOError(
                        f"dashboard already bound on port "
                        f"{self.addr[1]}, not {port}")
                return
            self._fe = _Frontend(self)
            host, bound = await self._fe.start(port=port)
            self.addr = (host, bound)
            self.log(f"dashboard on http://{host}:{bound}/")

    async def serve(self) -> None:
        port = self.get_module_option("port", "")
        if port != "":
            await self._bind(int(port))

    async def shutdown(self) -> None:
        if self._fe is not None:
            await self._fe.stop()

    def _osds(self) -> list[dict]:
        # osd_map/reports come back as direct references (no copy, no
        # recompute) — health() is the only computed get, fetched once
        osdmap = self.get("osd_map")
        reports = self.get("reports")
        return [{"osd": i, "up": bool(o.up),
                 "weight": o.weight / 0x10000,
                 "ops": int(reports.get(i, {}).get("perf", {})
                            .get("op", 0))}
                for i, o in enumerate(osdmap.osds)]

    def _page(self) -> bytes:
        # one fetch of each input per render: health once (status()
        # embeds its own pass), osdmap/reports shared with the table
        he = self.get("health")
        st = self.get("status")
        warn = he["status"] != "HEALTH_OK"
        checks = ("" if not he["checks"] else " — " + "; ".join(
            f"{k}: {v}" for k, v in sorted(he["checks"].items())))
        pgs = "".join(
            f"<tr><td>{html.escape(s)}</td><td>{n}</td></tr>"
            for s, n in sorted(st["pgs"].items())) or \
            "<tr><td colspan=2>none</td></tr>"
        osds = "".join(
            f"<tr><td>osd.{o['osd']}</td><td>{'up' if o['up'] else 'DOWN'}"
            f"</td><td>{o['weight']:.2f}</td><td>{o['ops']}</td></tr>"
            for o in self._osds())
        return _PAGE.format(
            cls="warn" if warn else "ok",
            health=html.escape(he["status"]),
            checks=html.escape(checks),
            epoch=st["epoch"], up=st["osds"]["up"],
            inn=st["osds"]["in"], total=st["osds"]["total"],
            pools=st["pools"], ops=st["client_ops_total"],
            modules=html.escape(", ".join(st["mgr_modules"])),
            pgs=pgs, osds=osds,
        ).encode()
