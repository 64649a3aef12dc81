"""telemetry mgr module: anonymized cluster report (the
src/pybind/mgr/telemetry role, zero-egress form).

The reference phones an opt-in report home over HTTPS; this build has
no egress, so "send" composes the same shape of report and persists it
locally (last_report in the module store) — the honest equivalent: the
report content and the opt-in state machine are the capability, the
HTTP POST is deployment plumbing. Strictly anonymized like the
reference's basic channel: counts, shapes, and profiles — never pool
names, object names, or addresses.

ceph_tpu_torch's own copy of ``ceph_tpu/mgr_modules/telemetry.py``.
"""
from __future__ import annotations

import asyncio
import json
import time

from ..cluster.mgr_module import MgrModule


class Module(MgrModule):
    COMMANDS = [
        {"cmd": "telemetry status", "desc": "opt-in state + last report"},
        {"cmd": "telemetry on", "desc": "enable periodic reports"},
        {"cmd": "telemetry off", "desc": "disable"},
        {"cmd": "telemetry show", "desc": "compose the current report"},
        {"cmd": "telemetry send", "desc": "compose + persist now"},
    ]
    MODULE_OPTIONS = [
        {"name": "interval_s", "default": 3600.0},
    ]

    def _report(self) -> dict:
        status = self.get("status")
        osdmap = self.get("osd_map")
        pools = []
        for p in osdmap.pools.values():
            pools.append({  # shapes only: no names (anonymized)
                "type": p.type,
                "size": p.size,
                "min_size": p.min_size,
                "pg_num": p.pg_num,
                "ec_profile": {k: v for k, v in p.ec_profile.items()
                               if k in ("k", "m", "plugin")},
            })
        return {
            "report_timestamp": time.time(),
            "channel": "basic",
            "osd": {"count": osdmap.n_osds,
                    "up": status["osds"]["up"],
                    "in": status["osds"]["in"]},
            "pools": pools,
            "pg_states": dict(status.get("pgs", {})),
            "health": status["health"],
            "client_ops_total": status.get("client_ops_total", 0),
        }

    async def handle_command(self, cmd: str, args: dict):
        if cmd == "telemetry status":
            last = self.get_store("last_report")
            return {"enabled": self.get_store("enabled") == "1",
                    "last_report_at": (json.loads(last)
                                       ["report_timestamp"]
                                       if last else None)}
        if cmd == "telemetry on":
            await self.set_store("enabled", "1")
            return {"enabled": True}
        if cmd == "telemetry off":
            await self.set_store("enabled", "0")
            return {"enabled": False}
        if cmd == "telemetry show":
            return self._report()
        if cmd == "telemetry send":
            rep = self._report()
            await self.set_store("last_report", json.dumps(rep))
            return {"sent": True,
                    "report_timestamp": rep["report_timestamp"]}
        raise NotImplementedError(cmd)

    async def serve(self) -> None:
        """Periodic report when opted in (the reference's send loop)."""
        while True:
            await asyncio.sleep(
                float(self.get_module_option("interval_s", 3600.0)))
            if self.get_store("enabled") == "1":
                rep = self._report()
                await self.set_store("last_report", json.dumps(rep))
                self.log("telemetry report persisted")
