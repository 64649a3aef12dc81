"""The cases of ``tests/test_watch_notify.py`` on the port (``ceph_tpu_torch``),
each cluster on ``device="cpu"`` (the kernels' plain versions), copied
with only their imports and device changed; the reference's bounds
stay as they are. The reference's own words follow.

watch/notify tests (the librados watch_notify test role)."""
import asyncio

import pytest

from ceph_tpu_torch.cluster.vstart import TestCluster
from ceph_tpu_torch.placement.osdmap import Pool
import torch

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)


def run(coro):
    asyncio.run(asyncio.wait_for(coro, 60))


async def make():
    c = TestCluster(n_osds=3, device="cpu")
    await c.start()
    await c.client.create_pool(
        Pool(id=1, name="p", size=3, pg_num=4, crush_rule=0)
    )
    await c.wait_active(20)
    return c


def test_watch_notify_roundtrip():
    async def t():
        c = await make()
        cl = c.client
        await cl.write_full(1, "bell", b"x")
        events = []
        got = asyncio.Event()

        def on_notify(oid, notify_id, payload):
            events.append((oid, notify_id, payload))
            got.set()

        cookie = await cl.watch(1, "bell", on_notify)
        nid = await cl.notify(1, "bell", b"ding")
        await asyncio.wait_for(got.wait(), 5)
        assert events == [(b"bell", nid, b"ding")]
        # second notify; ids increase
        got.clear()
        nid2 = await cl.notify(1, "bell", b"dong")
        await asyncio.wait_for(got.wait(), 5)
        assert nid2 > nid and events[-1][2] == b"dong"
        # unwatch: no more deliveries
        await cl.unwatch(1, "bell", cookie)
        await cl.notify(1, "bell", b"silent")
        await asyncio.sleep(0.2)
        assert len(events) == 2
        # watching a nonexistent object is ENOENT
        with pytest.raises(KeyError):
            await cl.watch(1, "ghost", on_notify)
        await c.stop()

    run(t())


def test_multiple_watchers():
    async def t():
        c = await make()
        cl = c.client
        await cl.write_full(1, "topic", b"x")
        hits = []
        c1 = await cl.watch(1, "topic",
                            lambda o, n, p: hits.append(("w1", p)))
        c2 = await cl.watch(1, "topic",
                            lambda o, n, p: hits.append(("w2", p)))
        await cl.notify(1, "topic", b"fanout")
        await asyncio.sleep(0.2)
        assert sorted(hits) == [("w1", b"fanout"), ("w2", b"fanout")]
        await cl.unwatch(1, "topic", c1)
        await cl.unwatch(1, "topic", c2)
        await c.stop()

    run(t())
