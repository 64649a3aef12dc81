"""The cases of ``tests/test_paxos_mon.py`` on the port
(``ceph_tpu_torch``), each cluster on ``device="cpu"`` (the kernels'
plain versions; the mons use no device), copied with only their imports
and device changed, but for one wait: where the reference sleeps 0.5 s
for commits to fan out, this waits (up to 10 s) for every mon to reach
one epoch, then asserts as the reference does. The reference's own
words follow.

Multi-mon consensus tests: quorum formation, replicated commits,
leader failover, quorum loss (the Paxos.cc + Elector roles)."""
import asyncio

import pytest
import torch

from ceph_tpu_torch.cluster.vstart import TestCluster
from ceph_tpu_torch.placement.osdmap import Pool

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)


def run(coro, timeout=120):
    asyncio.run(asyncio.wait_for(coro, timeout))


async def make(n_mons=3, n_osds=4):
    c = TestCluster(n_osds=n_osds, n_mons=n_mons, device="cpu")
    await c.start()
    await c.client.create_pool(
        Pool(id=1, name="p", size=3, pg_num=8, crush_rule=0)
    )
    await c.wait_active(20)
    return c


def test_quorum_forms_and_cluster_works():
    async def t():
        c = await make()
        # lowest rank leads (classic elector)
        assert c.mon.rank == 0
        assert len(c.mon.quorum) >= 2
        await c.client.write_full(1, "obj", b"replicated-map-data")
        assert await c.client.read(1, "obj") == b"replicated-map-data"
        await c.stop()

    run(t())


def test_commits_replicate_to_all_mons():
    async def t():
        c = await make()
        await c.client.write_full(1, "x", b"data")
        # drive a few epochs: kill an OSD (mark-down commits a map)
        await c.kill_osd(3)
        await c.wait_down(3, 20)
        # let commits fan out: wait on the replicas' epochs, not a clock
        for _ in range(200):
            epochs = {m.osdmap.epoch for m in c.mons if m is not None}
            if len(epochs) == 1:
                break
            await asyncio.sleep(0.05)
        epochs = [m.osdmap.epoch for m in c.mons if m is not None]
        assert len(set(epochs)) == 1, f"divergent epochs {epochs}"
        downs = [m.osdmap.osds[3].up for m in c.mons if m is not None]
        assert not any(downs)
        await c.stop()

    run(t())


def test_leader_failover():
    async def t():
        c = await make()
        assert c.mon.rank == 0
        epoch_before = c.mon.osdmap.epoch
        await c.kill_mon(0)
        # a new leader takes over and keeps serving the cluster
        await c.wait_quorum(15)
        assert c.mon.rank == 1
        assert c.mon.osdmap.epoch >= epoch_before
        # map mutations still commit: kill an OSD, map must advance
        await c.kill_osd(2)
        await c.wait_down(2, 25)
        # IO keeps working under the new mon
        await c.client.write_full(1, "after-failover", b"ok")
        assert await c.client.read(1, "after-failover") == b"ok"
        await c.stop()

    run(t())


def test_quorum_loss_stalls_map_mutations():
    async def t():
        c = await make()
        await c.kill_mon(1)
        await c.kill_mon(2)
        await asyncio.sleep(0.3)
        # 1 of 3 alive: no majority -> map mutation must fail
        from ceph_tpu_torch.cluster.paxos_mon import QuorumLost
        from ceph_tpu_torch.placement.osdmap import Incremental

        leader = c.mons[0]
        inc = Incremental(epoch=leader.osdmap.epoch + 1, down=[3])
        with pytest.raises(QuorumLost):
            await leader.commit(inc)
        await c.stop()

    run(t())
