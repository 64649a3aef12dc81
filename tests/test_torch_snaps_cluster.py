"""The cluster cases of ``tests/test_snaps.py`` on the port
(``ceph_tpu_torch``): clone-on-write, reads at a snap, trimming, kill
and revive, each cluster on ``device="cpu"`` (the kernels' plain
versions). The reference's cases are copied with only their imports and
device changed. Tolerance: exact, as in the reference.
"""
import asyncio

import numpy as np
import pytest
import torch

from ceph_tpu_torch.cluster.vstart import TestCluster
from ceph_tpu_torch.placement.osdmap import Pool

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)


EC_PROFILE = {"plugin": "rs_tpu", "k": "3", "m": "2"}


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, 120))
    finally:
        loop.close()


async def make_rep(n=4):
    c = TestCluster(n_osds=n, device="cpu")
    await c.start()
    await c.client.create_pool(
        Pool(id=1, name="rep", size=3, pg_num=4, crush_rule=0))
    await c.wait_active(20)
    return c


async def make_ec(n=5):
    c = TestCluster(n_osds=n, device="cpu")
    await c.start()
    await c.client.create_pool(
        Pool(id=2, name="ec", size=5, min_size=3, pg_num=4, crush_rule=1,
             type="erasure", ec_profile=dict(EC_PROFILE)))
    await c.wait_active(20)
    return c


class SnapCtx:
    """Client-side selfmanaged SnapContext bookkeeping (the librados
    IoCtx snap-write-context role)."""

    def __init__(self, client, pool_id):
        self.client = client
        self.pool_id = pool_id
        self.seq = 0
        self.snaps: list[int] = []  # descending

    async def create(self) -> int:
        snapid = await self.client.selfmanaged_snap_create(self.pool_id)
        self.seq = snapid
        self.snaps.insert(0, snapid)
        return snapid

    async def remove(self, snapid: int) -> None:
        await self.client.selfmanaged_snap_remove(self.pool_id, snapid)
        if snapid in self.snaps:
            self.snaps.remove(snapid)

    @property
    def ctx(self):
        return (self.seq, list(self.snaps))


@pytest.mark.parametrize("pool_id,factory", [(1, make_rep), (2, make_ec)])
def test_snap_write_overwrite_read_at_snap(pool_id, factory):
    async def t():
        c = await factory()
        sc = SnapCtx(c.client, pool_id)
        v1 = b"version-one" * 700
        await c.client.write_full(pool_id, "o", v1, snapc=sc.ctx)
        s1 = await sc.create()
        v2 = b"version-TWO" * 900
        await c.client.write_full(pool_id, "o", v2, snapc=sc.ctx)
        s2 = await sc.create()
        # partial overwrite after second snap
        await c.client.write(pool_id, "o", 5, b"PATCH", snapc=sc.ctx)
        v3 = bytearray(v2)
        v3[5:10] = b"PATCH"

        assert await c.client.read(pool_id, "o") == bytes(v3)
        assert await c.client.read(pool_id, "o", snapid=s1) == v1
        assert await c.client.read(pool_id, "o", snapid=s2) == v2
        assert await c.client.stat(pool_id, "o", snapid=s1) == len(v1)
        # reads at a snap predating the object: ENOENT
        with pytest.raises(KeyError):
            await c.client.read(pool_id, "o2", snapid=s1)
        await c.stop()

    run(t())


@pytest.mark.parametrize("pool_id,factory", [(1, make_rep), (2, make_ec)])
def test_snap_delete_head_keeps_clones(pool_id, factory):
    async def t():
        c = await factory()
        sc = SnapCtx(c.client, pool_id)
        keep = b"keep-me" * 512
        await c.client.write_full(pool_id, "o", keep, snapc=sc.ctx)
        s1 = await sc.create()
        await c.client.delete(pool_id, "o", snapc=sc.ctx)
        # head is gone...
        with pytest.raises(KeyError):
            await c.client.read(pool_id, "o")
        with pytest.raises(KeyError):
            await c.client.stat(pool_id, "o")
        assert b"o" not in await c.client.list_objects(pool_id)
        # ...but the snapshot still serves the data (whiteout role)
        assert await c.client.read(pool_id, "o", snapid=s1) == keep
        # recreating the head works and the snap still resolves
        await c.client.write_full(pool_id, "o", b"new", snapc=sc.ctx)
        assert await c.client.read(pool_id, "o") == b"new"
        assert await c.client.read(pool_id, "o", snapid=s1) == keep
        await c.stop()

    run(t())


@pytest.mark.parametrize("pool_id,factory", [(1, make_rep), (2, make_ec)])
def test_snap_trim_reclaims_clones(pool_id, factory):
    async def t():
        c = await factory()
        sc = SnapCtx(c.client, pool_id)
        v1 = b"A" * 3000
        await c.client.write_full(pool_id, "o", v1, snapc=sc.ctx)
        s1 = await sc.create()
        await c.client.write_full(pool_id, "o", b"B" * 100, snapc=sc.ctx)
        assert await c.client.read(pool_id, "o", snapid=s1) == v1
        await sc.remove(s1)
        # trimming is async: wait for the clone object to disappear
        for _ in range(100):
            try:
                got = await c.client.read(pool_id, "o", snapid=s1)
            except KeyError:
                break
            await asyncio.sleep(0.05)
        else:
            raise AssertionError(f"snap {s1} still readable: {got!r}")
        assert await c.client.read(pool_id, "o") == b"B" * 100
        await c.stop()

    run(t())


def test_snap_trim_whiteout_head_reclaimed():
    async def t():
        c = await make_rep()
        sc = SnapCtx(c.client, 1)
        await c.client.write_full(1, "o", b"x" * 100, snapc=sc.ctx)
        s1 = await sc.create()
        await c.client.delete(1, "o", snapc=sc.ctx)
        assert await c.client.read(1, "o", snapid=s1) == b"x" * 100
        await sc.remove(s1)
        for _ in range(100):
            try:
                await c.client.read(1, "o", snapid=s1)
            except KeyError:
                break
            await asyncio.sleep(0.05)
        # head shell (whiteout) must be gone from the store too
        pgid = c.client.osdmap.object_to_pg(1, b"o")
        up, _ = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        cid = f"{pgid[0]}.{pgid[1]}"
        for o in up:
            store = c.stores[o]
            if cid in store.list_collections():
                assert b"o" not in store.list_objects(cid)
        await c.stop()

    run(t())


def test_snaps_survive_kill_revive():
    async def t():
        c = await make_ec()
        sc = SnapCtx(c.client, 2)
        rng = np.random.default_rng(5)
        v1 = bytes(rng.integers(0, 256, 50_000, dtype=np.uint8))
        await c.client.write_full(2, "o", v1, snapc=sc.ctx)
        s1 = await sc.create()
        await c.client.write(2, "o", 1000, b"Y" * 20_000, snapc=sc.ctx)
        v2 = bytearray(v1)
        v2[1000:21_000] = b"Y" * 20_000

        pgid = c.client.osdmap.object_to_pg(2, b"o")
        up, primary = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        victim = next(o for o in up if o != primary)
        await c.kill_osd(victim)
        await c.wait_down(victim, 20)
        # degraded: both head and snap readable
        assert await c.client.read(2, "o") == bytes(v2)
        assert await c.client.read(2, "o", snapid=s1) == v1
        # write while degraded, then revive: clone must recover too
        await c.client.write(2, "o", 0, b"Z" * 500, snapc=sc.ctx)
        v2[0:500] = b"Z" * 500
        await c.revive_osd(victim)
        await c.wait_active(30)
        up2, primary2 = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        others = [o for o in up2 if o not in (victim, primary2)][:2]
        for o in others:
            await c.kill_osd(o)
            await c.wait_down(o, 20)
        # the revived shard now serves both head and clone reconstruction
        assert await c.client.read(2, "o") == bytes(v2)
        assert await c.client.read(2, "o", snapid=s1) == v1
        await c.stop()

    run(t())


def test_write_to_snap_rejected():
    async def t():
        c = await make_rep()
        sc = SnapCtx(c.client, 1)
        await c.client.write_full(1, "o", b"data", snapc=sc.ctx)
        s1 = await sc.create()
        with pytest.raises(IOError):
            await c.client._submit(
                1, "o",
                [__import__("ceph_tpu.cluster.messages",
                            fromlist=["osd_op"]).osd_op(
                                "writefull", data=b"nope")],
                snapid=s1)
        await c.stop()

    run(t())

