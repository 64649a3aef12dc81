"""pg_autoscaler mgr module (the src/pybind/mgr/pg_autoscaler role):
plans pg_num/pgp_num changes from the map and submits them to the mon.
``serve()`` runs the periodic loop when the module option ``active``
is set; one-shot rounds ride the admin command either way.

ceph_tpu_torch's own copy of ``ceph_tpu/mgr_modules/pg_autoscaler.py``.
"""
from __future__ import annotations

import asyncio

from ..cluster import autoscaler
from ..cluster import messages as M
from ..cluster.mgr_module import MgrModule


class Module(MgrModule):
    COMMANDS = [
        {"cmd": "autoscaler run",
         "desc": "one pg_autoscaler round: {target_per_osd?}"},
    ]
    MODULE_OPTIONS = [
        {"name": "active", "default": ""},  # non-empty = loop on
        {"name": "interval", "default": "5.0"},
        {"name": "target_per_osd", "default": "100"},
    ]

    async def handle_command(self, cmd: str, args: dict) -> dict:
        return await self.run_once(
            int(args.get("target_per_osd", 100)))

    async def run_once(self, target_per_osd: int = 100) -> dict:
        """One round (module.py:706 role): pgp_num trails pg_num by a
        round so member-local collection splits complete before
        placement changes."""
        actions = autoscaler.plan(self.get("osd_map"), target_per_osd)
        for pool_id, key, value in actions:
            await self.send_mon(
                M.MPoolSet(pool_id=pool_id, key=key, value=value))
        return {"actions": [list(a) for a in actions]}

    async def serve(self) -> None:
        while True:
            if self.get_module_option("active"):
                try:
                    await self.run_once(int(
                        self.get_module_option("target_per_osd", 100)))
                except Exception as e:
                    self.log(f"autoscale round failed: {e!r}")
            await asyncio.sleep(
                float(self.get_module_option("interval", 5.0)))
