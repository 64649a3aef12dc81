"""The cluster cases of ``tests/test_bluestore.py`` on the port
(``ceph_tpu_torch``): a cluster whose OSDs run BlueStoreLite, each
cluster on ``device="cpu"`` (the kernels' plain versions). The
reference's cases are copied with only their imports and device changed.
Tolerance: exact, as in the reference.
"""
import os

import torch

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)


def test_cluster_on_bluestore(tmp_path):
    """vstart --bluestore role: a full EC cluster runs on BlueStoreLite,
    survives an OSD kill + revive (remounting the same store), and a
    whole-cluster restart from the same data dirs."""
    import asyncio

    from ceph_tpu_torch.cluster import TestCluster
    from ceph_tpu_torch.placement.osdmap import Pool

    data = os.urandom(100_000)

    async def phase1():
        c = TestCluster(n_osds=5, objectstore="bluestore",
                        data_dir=str(tmp_path), size=32 << 20, device="cpu")
        await c.start()
        await c.client.create_pool(
            Pool(id=2, name="ec", size=5, min_size=3, pg_num=8,
                 crush_rule=1, type="erasure",
                 ec_profile={"plugin": "rs_tpu", "k": "3", "m": "2",
                             "backend": "device"}))
        await c.wait_active(20)
        await c.client.write_full(2, b"obj", data)
        assert await c.client.read(2, b"obj") == data
        await c.kill_osd(1)
        await c.wait_down(1)
        assert await c.client.read(2, b"obj") == data  # degraded
        await c.revive_osd(1)
        await c.wait_active(20)
        await c.stop()

    async def phase2():  # cold restart from the on-disk stores
        c = TestCluster(n_osds=5, objectstore="bluestore",
                        data_dir=str(tmp_path), size=32 << 20, device="cpu")
        await c.start()
        await c.client.create_pool(
            Pool(id=2, name="ec", size=5, min_size=3, pg_num=8,
                 crush_rule=1, type="erasure",
                 ec_profile={"plugin": "rs_tpu", "k": "3", "m": "2",
                             "backend": "device"}))
        await c.wait_active(20)
        assert await c.client.read(2, b"obj") == data
        await c.stop()

    asyncio.run(asyncio.wait_for(phase1(), 60))
    asyncio.run(asyncio.wait_for(phase2(), 60))

