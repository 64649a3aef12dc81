"""The cluster case of ``tests/test_fabric.py`` on the port
(``ceph_tpu_torch``): one EC write/read cycle, byte-exact across the
cluster's messenger backends, every daemon on ``device="cpu"`` (the
kernels' plain versions).

The reference runs the TCP and shm arms as a ``ProcCluster`` of daemon
processes (``cluster/procstart.py``), which the port has not taken yet
(ROADMAP §1 item 4). Here the same daemons (mon, six OSDs, client) run
in one process, each on its own ``NetBus`` over the backend, so every
message between them crosses a real TCP socket or shm ring.
Tolerance: exact, as in the reference.
"""
import asyncio

import numpy as np
import torch

from ceph_tpu_torch.cluster.client import RadosClient
from ceph_tpu_torch.cluster.mon import MonLite
from ceph_tpu_torch.cluster.osd import OSDLite
from ceph_tpu_torch.cluster.vstart import TestCluster
from ceph_tpu_torch.msg.netbus import NetBus
from ceph_tpu_torch.placement.osdmap import Pool

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)


def run(coro, timeout=240):
    asyncio.run(asyncio.wait_for(coro, timeout))


def test_ec_write_read_byte_exact_across_backends(tmp_path, monkeypatch):
    """One EC write/read cycle, three messenger backends, one source
    buffer: every byte identical (the A/B the zero-copy plane must
    not break)."""
    monkeypatch.setenv("CEPH_TPU_SHM_DIR", str(tmp_path))
    data = np.random.default_rng(20).integers(
        0, 256, 1 << 20, dtype=np.uint8).tobytes()
    pool = dict(id=2, name="ab", size=6, min_size=4, pg_num=8,
                crush_rule=1, type="erasure",
                ec_profile={"plugin": "rs_tpu", "k": "4", "m": "2",
                            "stripe_unit": "65536"})
    results = {}

    async def localbus():
        c = TestCluster(n_osds=6, device="cpu")
        await c.start()
        try:
            await c.client.create_pool(Pool(**pool))
            await c.wait_active(30)
            await c.client.write_full(2, "obj", data)
            results["localbus"] = bytes(await c.client.read(2, "obj"))
        finally:
            await c.stop()

    async def netbus(backend):
        book = str(tmp_path / backend)
        buses = [NetBus(book, backend=backend) for _ in range(8)]
        for b in buses:
            await b.start()
        mon = MonLite(buses[0], 6)
        osds = [OSDLite(buses[1 + i], i, device="cpu") for i in range(6)]
        client = RadosClient(buses[7], device="cpu")
        try:
            await mon.start()
            for o in osds:
                await o.start()
            await client.connect()
            await client.create_pool(Pool(**pool))

            async def active():
                while not (all(o.osdmap is not None
                               and o.osdmap.epoch == mon.osdmap.epoch
                               for o in osds)
                           and all(pg.state == "active"
                                   for o in osds for pg in o.pgs.values())):
                    await asyncio.sleep(0.05)
            await asyncio.wait_for(active(), 60)
            await client.write_full(2, "obj", data)
            results[backend] = bytes(await client.read(2, "obj"))
        finally:
            await client.close()
            for o in osds:
                await o.stop()
            await mon.stop()
            for b in buses:
                await b.close()

    run(localbus())
    run(netbus("tcp"))
    run(netbus("shm"))
    assert results["localbus"] == data
    assert results["tcp"] == data
    assert results["shm"] == data
