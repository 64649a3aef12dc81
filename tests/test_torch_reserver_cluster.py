"""The cluster cases of ``tests/test_reserver.py`` on the port
(``ceph_tpu_torch``): bounded recovery under a mass remap and the remote
backfill slots, each cluster on ``device="cpu"`` (the kernels' plain
versions). The reference's cases are copied with only their imports and
device changed. Tolerance: exact, as in the reference.
"""
import asyncio

import numpy as np
import torch

from ceph_tpu_torch.cluster.vstart import TestCluster
from ceph_tpu_torch.placement.osdmap import Pool

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)


def run(coro, timeout=180):
    asyncio.run(asyncio.wait_for(coro, timeout))


def test_mass_remap_bounded_recovery_with_live_io():
    """Kill + out an OSD so many PGs re-place and recover; the local
    reserver bounds concurrent recoveries to osd_max_backfills while a
    client writer keeps making progress the whole time."""
    async def t():
        c = TestCluster(n_osds=6, out_interval=1.0, device="cpu")
        await c.start()
        await c.client.create_pool(
            Pool(id=1, name="p", size=3, pg_num=32, crush_rule=0))
        await c.wait_active(30)
        rng = np.random.default_rng(21)
        objs = {}
        for i in range(48):
            name = f"o{i}"
            objs[name] = bytes(
                rng.integers(0, 256, 8000, dtype=np.uint8))
            await c.client.write_full(1, name, objs[name])

        # watch concurrency: sample every reserver each tick
        peak = {"local": 0}
        stop = asyncio.Event()

        async def sampler():
            while not stop.is_set():
                for o in c.osds:
                    if o is not None:
                        peak["local"] = max(peak["local"],
                                            o.local_reserver.in_use)
                await asyncio.sleep(0.002)

        wrote = {"n": 0}

        async def writer():
            i = 0
            while not stop.is_set():
                await c.client.write_full(1, f"live{i}", b"x" * 2000)
                wrote["n"] += 1
                i += 1
                await asyncio.sleep(0.01)

        tasks = [asyncio.ensure_future(sampler()),
                 asyncio.ensure_future(writer())]
        # the remap: kill an OSD and let down->out re-place its PGs
        await c.kill_osd(5)
        await c.wait_down(5, 30)
        await asyncio.sleep(1.5)  # out fires; recoveries run
        await c.wait_active(60)
        stop.set()
        await asyncio.gather(*tasks)

        nbf = c.osds[0].conf["osd_max_backfills"]
        assert peak["local"] <= nbf, (
            f"{peak['local']} concurrent recoveries > bound {nbf}")
        assert wrote["n"] > 0, "client IO starved during recovery"
        for name, data in objs.items():
            assert await c.client.read(1, name) == data
        await c.stop()

    run(t())


def test_remote_slots_bound_inbound_backfills():
    """A revived empty-ish OSD is backfilled by many primaries at once;
    its remote reserver keeps inbound backfills at the bound."""
    async def t():
        c = TestCluster(n_osds=4, out_interval=1.0, device="cpu")
        await c.start()
        await c.client.create_pool(
            Pool(id=1, name="p", size=3, pg_num=32, crush_rule=0))
        await c.wait_active(30)
        rng = np.random.default_rng(5)
        objs = {f"k{i}": bytes(rng.integers(0, 256, 20_000,
                                            dtype=np.uint8))
                for i in range(40)}
        for n, d in objs.items():
            await c.client.write_full(1, n, d)
        await c.kill_osd(2)
        await c.wait_down(2, 30)
        await asyncio.sleep(1.5)  # out: data re-places without it
        await c.wait_active(60)
        for n, d in objs.items():  # churn so osd.2 is far behind
            await c.client.write_full(1, n, d + b"!")

        peak = {"remote": 0}
        stop = asyncio.Event()

        async def sampler():
            while not stop.is_set():
                o = c.osds[2]
                if o is not None:
                    peak["remote"] = max(peak["remote"],
                                         o.remote_reserver.in_use)
                await asyncio.sleep(0.002)

        samp = asyncio.ensure_future(sampler())
        await c.revive_osd(2)
        await c.wait_active(90)
        stop.set()
        await samp
        nbf = c.osds[2].conf["osd_max_backfills"]
        assert peak["remote"] <= nbf
        for n, d in objs.items():
            assert await c.client.read(1, n) == d + b"!"
        await c.stop()

    run(t())

