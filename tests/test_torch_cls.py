"""The cases of ``tests/test_cls.py`` on the port (``ceph_tpu_torch``),
each cluster on ``device="cpu"`` (the kernels' plain versions), copied
with only their imports and device changed. The reference's own words
follow.

cls object class tests: lock/refcount/version over a live cluster
(src/cls test roles)."""
import asyncio

import pytest

from ceph_tpu_torch.cluster.client import ObjectOperation
from ceph_tpu_torch.cluster.vstart import TestCluster
from ceph_tpu_torch.placement.osdmap import Pool
from ceph_tpu_torch.utils import denc
import torch

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)


def run(coro):
    asyncio.run(asyncio.wait_for(coro, 120))


async def make():
    c = TestCluster(n_osds=3, device="cpu")
    await c.start()
    await c.client.create_pool(
        Pool(id=1, name="p", size=3, pg_num=4, crush_rule=0)
    )
    await c.wait_active(20)
    return c


def lock_input(name, ltype, owner, cookie):
    return (denc.enc_str(name) + denc.enc_str(ltype)
            + denc.enc_str(owner) + denc.enc_str(cookie))


def unlock_input(name, owner, cookie):
    return denc.enc_str(name) + denc.enc_str(owner) + denc.enc_str(cookie)


def test_cls_lock_exclusive_and_shared():
    async def t():
        c = await make()
        cl = c.client
        await cl.write_full(1, "o", b"guarded")
        await cl.execute(1, "o", "lock", "lock",
                         lock_input("L", "exclusive", "client.a", "c1"))
        # a second exclusive locker bounces with EBUSY (-16)
        with pytest.raises(IOError, match="-16"):
            await cl.execute(1, "o", "lock", "lock",
                             lock_input("L", "exclusive", "client.b",
                                        "c2"))
        # re-entrant grant for the same owner+cookie
        await cl.execute(1, "o", "lock", "lock",
                         lock_input("L", "exclusive", "client.a", "c1"))
        await cl.execute(1, "o", "lock", "unlock",
                         unlock_input("L", "client.a", "c1"))
        # shared locks coexist
        await cl.execute(1, "o", "lock", "lock",
                         lock_input("L", "shared", "client.a", "c1"))
        await cl.execute(1, "o", "lock", "lock",
                         lock_input("L", "shared", "client.b", "c2"))
        with pytest.raises(IOError, match="-16"):
            await cl.execute(1, "o", "lock", "lock",
                             lock_input("L", "exclusive", "client.x",
                                        "c9"))
        # break client.b's locks by owner
        await cl.execute(1, "o", "lock", "break_lock",
                         denc.enc_str("L") + denc.enc_str("client.b"))
        info = await cl.execute(1, "o", "lock", "get_info",
                                denc.enc_str("L"))
        ltype, _off = denc.dec_str(info, 0)
        assert ltype == "shared"
        await c.stop()

    run(t())


def test_cls_refcount_removes_on_last_put():
    async def t():
        c = await make()
        cl = c.client
        await cl.write_full(1, "blob", b"shared-data")
        await cl.execute(1, "blob", "refcount", "get", denc.enc_str("t1"))
        await cl.execute(1, "blob", "refcount", "get", denc.enc_str("t2"))
        raw = await cl.execute(1, "blob", "refcount", "read")
        tags, _ = denc.dec_list(raw, 0, denc.dec_str)
        assert sorted(tags) == ["t1", "t2"]
        await cl.execute(1, "blob", "refcount", "put", denc.enc_str("t1"))
        assert await cl.read(1, "blob") == b"shared-data"  # still alive
        await cl.execute(1, "blob", "refcount", "put", denc.enc_str("t2"))
        with pytest.raises(KeyError):
            await cl.read(1, "blob")  # last ref dropped -> removed
        await c.stop()

    run(t())


def test_cls_version_gate_in_compound_op():
    async def t():
        c = await make()
        cl = c.client
        await cl.write_full(1, "doc", b"v0")
        await cl.execute(1, "doc", "version", "set", denc.enc_u64(7))
        # guarded update: succeeds when the version matches...
        op = (ObjectOperation()
              .call("version", "check_eq", denc.enc_u64(7))
              .write_full(b"v1")
              .call("version", "inc"))
        await cl.operate(1, "doc", op)
        assert await cl.read(1, "doc") == b"v1"
        raw = await cl.execute(1, "doc", "version", "read")
        assert denc.dec_u64(raw, 0)[0] == 8
        # ...and the whole compound aborts when it does not
        bad = (ObjectOperation()
               .call("version", "check_eq", denc.enc_u64(7))
               .write_full(b"SHOULD NOT LAND"))
        with pytest.raises(IOError, match="-125"):
            await cl.operate(1, "doc", bad)
        assert await cl.read(1, "doc") == b"v1"
        await c.stop()

    run(t())


def test_unknown_class_method():
    async def t():
        c = await make()
        await c.client.write_full(1, "o", b"x")
        with pytest.raises(IOError, match="-95"):
            await c.client.execute(1, "o", "nope", "method")
        await c.stop()

    run(t())
