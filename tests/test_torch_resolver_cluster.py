"""The cluster cases of ``tests/test_placement_resolver.py`` on the port
(``ceph_tpu_torch``): a client op resent to the primary after a remap,
each cluster on ``device="cpu"`` (the kernels' plain versions). The
reference's cases are copied with only their imports and device changed.
Tolerance: exact, as in the reference.
"""
import asyncio

import torch

from ceph_tpu_torch.placement.osdmap import Pool

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)


def test_resend_lands_on_post_remap_primary():
    """Cluster tier: with the batched resolver armed on the op path,
    a primary dying mid-workload must re-target the resend onto the
    post-remap primary (the swarm-shaped epoch-correctness contract).
    """
    from ceph_tpu_torch.cluster.vstart import TestCluster

    async def run():
        c = TestCluster(n_osds=5, out_interval=1.0, device="cpu")
        await c.start()
        c.client.conf.set("client_placement_batch_min", 1)
        pool_id = await c.client.create_pool(
            Pool(id=7, name="remap", size=3, min_size=2, pg_num=8,
                 crush_rule=0))
        await c.wait_active(30)
        await c.client._placement.prewarm(c.client.osdmap, [pool_id])
        payload = b"x" * 4096
        await c.client.write_full(pool_id, "obj", payload)
        pgid = c.client.osdmap.object_to_pg(pool_id, b"obj")
        _up, primary = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        await c.kill_osd(primary)
        # the next write's tick-resend must land on the NEW primary
        # once the map moves (down -> out reroutes the PG)
        c.client.op_timeout = 30.0
        await c.client.write_full(pool_id, "obj", payload * 2)
        got = await c.client.read(pool_id, "obj")
        assert got == payload * 2
        stats = c.client.placement_stats()
        assert stats["placement_epoch_invalidations"] >= 1
        new_primary = c.client._calc_target(
            c.client.osdmap.object_to_pg(pool_id, b"obj"))
        assert new_primary != primary
        await c.stop()

    asyncio.run(run())

