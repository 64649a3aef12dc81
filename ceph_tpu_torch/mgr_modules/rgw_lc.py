"""rgw_lc mgr module: background S3 lifecycle expiration (the
src/rgw/rgw_lc.cc RGWLC worker role, hosted on the mgr tick instead of
inside radosgw). Point it at the RGW pool with the ``pool`` module
option; each serve tick runs one lc_process pass.

ceph_tpu_torch's own copy of ``ceph_tpu/mgr_modules/rgw_lc.py``. The
port has no ``services/`` yet (ROADMAP §1 item 7), so a pass raises
``NotImplementedError`` where the reference builds its ``RGWLite``.
"""
from __future__ import annotations

import asyncio

from ..cluster.mgr_module import MgrModule


class Module(MgrModule):
    COMMANDS = [
        {"cmd": "lc process",
         "desc": "run one lifecycle pass now: {pool}"},
    ]
    MODULE_OPTIONS = [
        {"name": "pool", "default": ""},      # RGW pool id; "" = off
        {"name": "interval", "default": "5.0"},
    ]

    def _rgw(self, pool_id: int):
        raise NotImplementedError(
            "rgw_lc needs services/rgw.py, which the port has not taken "
            "yet (ROADMAP §1 item 7)")

    def _host_client(self):
        # the mgr host's bus carries a client entity for module IO
        if not hasattr(self, "_client"):
            from ..cluster.client import RadosClient

            self._client = RadosClient(self._host.bus,
                                       name="client.mgr-lc")
            self._connected = False
        return self._client

    async def _connected_client(self):
        cl = self._host_client()
        if not self._connected:
            await cl.connect()
            self._connected = True
        return cl

    async def handle_command(self, cmd: str, args: dict) -> dict:
        await self._connected_client()
        return await self._rgw(int(args["pool"])).lc_process()

    async def serve(self) -> None:
        while True:
            pool = self.get_module_option("pool")
            if pool:
                try:
                    await self._connected_client()
                    await self._rgw(int(pool)).lc_process()
                except Exception as e:
                    self.log(f"lc pass failed: {e!r}")
            await asyncio.sleep(
                float(self.get_module_option("interval", 5.0)))
