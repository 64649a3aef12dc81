"""The cases of ``tests/test_fs.py`` on the port (``ceph_tpu_torch``),
each cluster on ``device="cpu"`` (the kernels' plain versions), copied
with only their imports and device changed; the reference's bounds
stay as they are. The reference's own words follow.

FS-lite tests: hierarchy, file IO through the striper, rename,
errors (the libcephfs/client test role, shrunk)."""
import asyncio

import numpy as np
import pytest

from ceph_tpu_torch.cluster.vstart import TestCluster
from ceph_tpu_torch.placement.osdmap import Pool
from ceph_tpu_torch.services.fs import Exists, FSLite, NoEnt, NotEmpty
import torch

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)


def run(coro):
    asyncio.run(asyncio.wait_for(coro, 120))


async def make():
    c = TestCluster(n_osds=4, device="cpu")
    await c.start()
    await c.client.create_pool(
        Pool(id=1, name="fs", size=3, pg_num=8, crush_rule=0)
    )
    await c.wait_active(20)
    fs = FSLite(c.client, 1)
    await fs.mkfs()
    return c, fs


def test_hierarchy():
    async def t():
        c, fs = await make()
        await fs.mkdir("/home")
        await fs.mkdir("/home/alice")
        await fs.mkdir("/home/bob")
        await fs.mkdir("/tmp")
        assert await fs.listdir("/") == ["home", "tmp"]
        assert await fs.listdir("/home") == ["alice", "bob"]
        with pytest.raises(Exists):
            await fs.mkdir("/home")
        with pytest.raises(NoEnt):
            await fs.listdir("/nonexistent")
        with pytest.raises(NotEmpty):
            await fs.rmdir("/home")
        await fs.rmdir("/home/bob")
        assert await fs.listdir("/home") == ["alice"]
        st = await fs.stat("/home")
        assert st["type"] == 1
        await c.stop()

    run(t())


def test_file_io():
    async def t():
        c, fs = await make()
        await fs.mkdir("/data")
        rng = np.random.default_rng(11)
        blob = rng.integers(0, 256, 3_000_000, dtype=np.uint8).tobytes()
        await fs.write("/data/big.bin", blob)  # create-on-write
        st = await fs.stat("/data/big.bin")
        assert st["type"] == 2 and st["size"] == len(blob)
        assert await fs.read("/data/big.bin") == blob
        # ranged read + overwrite inside the file
        assert await fs.read("/data/big.bin", 100, 50) == blob[100:150]
        await fs.write("/data/big.bin", b"PATCH", offset=1_000_000)
        got = await fs.read("/data/big.bin", 999_998, 10)
        assert got[2:7] == b"PATCH"
        # append past the end grows it
        await fs.write("/data/big.bin", b"TAIL", offset=len(blob))
        assert (await fs.stat("/data/big.bin"))["size"] == len(blob) + 4
        await fs.truncate("/data/big.bin", 10)
        assert await fs.read("/data/big.bin") == blob[:10]
        await fs.unlink("/data/big.bin")
        with pytest.raises(NoEnt):
            await fs.stat("/data/big.bin")
        await c.stop()

    run(t())


def test_rename():
    async def t():
        c, fs = await make()
        await fs.mkdir("/a")
        await fs.mkdir("/b")
        await fs.write("/a/f.txt", b"content")
        await fs.rename("/a/f.txt", "/b/g.txt")
        assert await fs.listdir("/a") == []
        assert await fs.listdir("/b") == ["g.txt"]
        assert await fs.read("/b/g.txt") == b"content"
        # rename a whole directory: children follow the inode
        await fs.mkdir("/a/sub")
        await fs.write("/a/sub/x", b"x")
        await fs.rename("/a/sub", "/b/sub2")
        assert await fs.read("/b/sub2/x") == b"x"
        with pytest.raises(Exists):
            await fs.rename("/b/g.txt", "/b/sub2")
        await c.stop()

    run(t())
