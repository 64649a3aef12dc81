"""The cases of ``tests/test_objectops.py`` on the port (``ceph_tpu_torch``),
each cluster on ``device="cpu"`` (the kernels' plain versions), copied
with only their imports and device changed; the reference's bounds
stay as they are. The reference's own words follow.

Compound object operations: op vectors, xattrs, omap, partial
writes/append/zero/truncate, atomicity (the librados ObjectOperation +
do_osd_ops surface)."""
import asyncio

import pytest

from ceph_tpu_torch.cluster.client import ObjectOperation
from ceph_tpu_torch.cluster.vstart import TestCluster
from ceph_tpu_torch.placement.osdmap import Pool
import torch

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)

EC_PROFILE = {"plugin": "rs_tpu", "k": "3", "m": "2"}


def run(coro):
    asyncio.run(asyncio.wait_for(coro, 120))


async def make_rep(n=4):
    c = TestCluster(n_osds=n, device="cpu")
    await c.start()
    await c.client.create_pool(
        Pool(id=1, name="rep", size=3, pg_num=8, crush_rule=0)
    )
    await c.wait_active(20)
    return c


async def make_ec(n=5):
    c = TestCluster(n_osds=n, device="cpu")
    await c.start()
    await c.client.create_pool(
        Pool(id=2, name="ec", size=5, min_size=3, pg_num=8, crush_rule=1,
             type="erasure", ec_profile=dict(EC_PROFILE))
    )
    await c.wait_active(20)
    return c


def test_partial_writes_append_zero_truncate():
    async def t():
        c = await make_rep()
        cl = c.client
        await cl.write_full(1, "o", b"0123456789")
        await cl.write(1, "o", 3, b"XYZ")
        assert await cl.read(1, "o") == b"012XYZ6789"
        await cl.append(1, "o", b"++")
        assert await cl.read(1, "o") == b"012XYZ6789++"
        await cl.zero(1, "o", 1, 2)
        assert await cl.read(1, "o") == b"0\0\0XYZ6789++"
        await cl.truncate(1, "o", 4)
        assert await cl.read(1, "o") == b"0\0\0X"
        await cl.truncate(1, "o", 8)  # grow zero-fills
        assert await cl.read(1, "o") == b"0\0\0X\0\0\0\0"
        # sparse write past the end
        await cl.write(1, "o", 12, b"end")
        assert await cl.stat(1, "o") == 15
        await c.stop()

    run(t())


def test_xattrs_roundtrip_replicated():
    async def t():
        c = await make_rep()
        cl = c.client
        await cl.write_full(1, "o", b"data")
        await cl.setxattr(1, "o", "owner", b"alice")
        await cl.setxattr(1, "o", "mode", b"0644")
        assert await cl.getxattr(1, "o", "owner") == b"alice"
        assert await cl.getxattrs(1, "o") == {
            "owner": b"alice", "mode": b"0644"
        }
        await cl.rmxattr(1, "o", "mode")
        assert await cl.getxattrs(1, "o") == {"owner": b"alice"}
        with pytest.raises(IOError):
            await cl.getxattr(1, "o", "mode")
        # xattrs survive a data overwrite
        await cl.write_full(1, "o", b"newdata")
        assert await cl.getxattr(1, "o", "owner") == b"alice"
        await c.stop()

    run(t())


def test_omap_roundtrip_replicated():
    async def t():
        c = await make_rep()
        cl = c.client
        await cl.write_full(1, "idx", b"")
        await cl.omap_set(1, "idx", {b"k1": b"v1", b"k2": b"v2"})
        assert await cl.omap_get(1, "idx") == {b"k1": b"v1", b"k2": b"v2"}
        await cl.omap_rm(1, "idx", [b"k1"])
        assert await cl.omap_get(1, "idx") == {b"k2": b"v2"}
        await c.stop()

    run(t())


def test_omap_rejected_on_ec_pool():
    async def t():
        c = await make_ec()
        await c.client.write_full(2, "o", b"x" * 1000)
        with pytest.raises(IOError, match="-95"):
            await c.client.omap_set(2, "o", {b"k": b"v"})
        await c.stop()

    run(t())


def test_xattrs_on_ec_pool_survive_recovery():
    async def t():
        c = await make_ec()
        cl = c.client
        await cl.write_full(2, "o", b"payload" * 500)
        await cl.setxattr(2, "o", "tag", b"gold")
        assert await cl.getxattr(2, "o", "tag") == b"gold"
        # kill the primary: new primary must still serve the xattr
        pgid = cl.osdmap.object_to_pg(2, b"o")
        up, primary = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        await c.kill_osd(primary)
        await c.wait_down(primary, 20)
        await c.wait_active(30)
        assert await cl.getxattr(2, "o", "tag") == b"gold"
        assert await cl.read(2, "o") == b"payload" * 500
        await c.stop()

    run(t())


def test_compound_atomic_and_read_your_writes():
    async def t():
        c = await make_rep()
        cl = c.client
        op = (ObjectOperation()
              .create()
              .write_full(b"hello world")
              .setxattr("lang", b"en")
              .omap_set({b"seq": b"1"})
              .read()
              .stat())
        outs = await cl.operate(1, "doc", op)
        assert outs[4] == b"hello world"  # read sees earlier write
        # failing op aborts the WHOLE vector: the write must not land
        bad = (ObjectOperation()
               .write_full(b"SHOULD NOT PERSIST")
               .getxattr("nonexistent"))
        with pytest.raises(IOError):
            await cl.operate(1, "doc", bad)
        assert await cl.read(1, "doc") == b"hello world"
        assert await cl.getxattr(1, "doc", "lang") == b"en"
        # exclusive create on an existing object fails
        with pytest.raises(IOError, match="-17"):
            await cl.operate(1, "doc", ObjectOperation().create())
        await c.stop()

    run(t())


def test_read_nonexistent_still_enoent():
    async def t():
        c = await make_rep()
        with pytest.raises(KeyError):
            await c.client.read(1, "ghost")
        with pytest.raises(KeyError):
            await c.client.stat(1, "ghost")
        await c.stop()

    run(t())
