"""The cases of ``tests/test_rgw_notify.py`` on the port (``ceph_tpu_torch``),
each cluster on ``device="cpu"`` (the kernels' plain versions), copied
with only their imports and device changed; the reference's bounds
stay as they are. The reference's own words follow.

RGW bucket-notification tests: topics, rule filters, reliable
event queues, pull/ack consumption (the rgw_notify + pubsub suite
role)."""
import asyncio

import pytest

from ceph_tpu_torch.cluster.vstart import TestCluster
from ceph_tpu_torch.placement.osdmap import Pool
from ceph_tpu_torch.services.rgw import RGWError, RGWLite
from ceph_tpu_torch.services.rgw_notify import (
    TopicQueue,
    create_topic,
    delete_topic,
    get_bucket_notification,
    list_topics,
    put_bucket_notification,
)
import torch

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)


def run(coro):
    asyncio.run(asyncio.wait_for(coro, 120))


async def make():
    c = TestCluster(n_osds=4, device="cpu")
    await c.start()
    await c.client.create_pool(
        Pool(id=1, name="rgw", size=3, pg_num=8, crush_rule=0))
    await c.wait_active(20)
    rgw = RGWLite(c.client, 1)
    await rgw.create_bucket("b")
    return c, rgw


def test_topics_and_event_flow():
    async def t():
        c, rgw = await make()
        await create_topic(rgw, "events")
        assert await list_topics(rgw) == ["events"]
        # a rule referencing a missing topic is rejected
        with pytest.raises(RGWError, match="no such topic"):
            await put_bucket_notification(
                rgw, "b", [{"id": "r", "topic": "nope"}])
        await put_bucket_notification(rgw, "b", [
            {"id": "all", "topic": "events",
             "events": ["s3:ObjectCreated:*",
                        "s3:ObjectRemoved:*"]}])
        assert (await get_bucket_notification(rgw, "b"))[0]["id"] \
            == "all"
        await rgw.put_object("b", "k1", b"hello")
        await rgw.delete_object("b", "k1")
        up = await rgw.initiate_multipart("b", "big")
        await rgw.upload_part("b", "big", up, 1, b"x" * 100)
        await rgw.complete_multipart("b", "big", up, [1])
        q = TopicQueue(rgw.client, 1, "events")
        events, marker, _tr = await q.pull()
        names = [e["eventName"] for e in events]
        assert names == ["s3:ObjectCreated:Put",
                         "s3:ObjectRemoved:Delete",
                         "s3:ObjectCreated:CompleteMultipartUpload"]
        assert events[0]["s3"]["object"]["key"] == "k1"
        assert events[0]["s3"]["object"]["size"] == 5
        assert events[2]["s3"]["object"]["eTag"].endswith("-1")
        # ack drops processed history; new events keep flowing
        await q.ack(marker)
        events, marker2, _tr = await q.pull(marker)
        assert events == []
        await rgw.put_object("b", "k2", b"again")
        events, _m, _tr = await q.pull(marker)
        assert [e["eventName"] for e in events] == \
            ["s3:ObjectCreated:Put"]
        await c.stop()

    run(t())


def test_filters_and_versioned_markers():
    async def t():
        c, rgw = await make()
        await create_topic(rgw, "creates")
        await put_bucket_notification(rgw, "b", [
            {"id": "c", "topic": "creates",
             "events": ["s3:ObjectCreated:*"], "prefix": "logs/"}])
        await rgw.put_object("b", "logs/a", b"1")   # matches
        await rgw.put_object("b", "data/a", b"2")   # prefix miss
        await rgw.delete_object("b", "logs/a")      # event-type miss
        q = TopicQueue(rgw.client, 1, "creates")
        events, _m, _tr = await q.pull()
        assert [e["s3"]["object"]["key"] for e in events] == ["logs/a"]
        # versioned bucket: marker creation emits its own event name
        await create_topic(rgw, "rm")
        rgw._notif_cache.clear()
        await put_bucket_notification(rgw, "b", [
            {"id": "rm", "topic": "rm",
             "events": ["s3:ObjectRemoved:*"]}])
        await rgw.put_bucket_versioning("b", "Enabled")
        _e, vid = await rgw.put_object("b", "v", b"x")
        marker_vid = await rgw.delete_object("b", "v")
        await rgw.delete_object("b", "v", version_id=vid)
        qrm = TopicQueue(rgw.client, 1, "rm")
        events, _m, _tr = await qrm.pull()
        assert [(e["eventName"], e["s3"]["object"]["versionId"])
                for e in events] == [
            ("s3:ObjectRemoved:DeleteMarkerCreated", marker_vid),
            ("s3:ObjectRemoved:Delete", vid)]
        # unconfigured buckets stay silent and cheap
        await rgw.create_bucket("quiet")
        await rgw.put_object("quiet", "k", b"x")
        events, _m, _tr = await qrm.pull()
        assert len(events) == 2
        # a topic still referenced by live rules refuses deletion —
        # its queue would keep filling with no consumer
        with pytest.raises(RGWError, match="still referenced"):
            await delete_topic(rgw, "rm")
        await delete_topic(rgw, "creates")  # unreferenced: fine
        assert await list_topics(rgw) == ["rm"]
        await c.stop()

    run(t())


def test_copy_emits_copy_event():
    async def t():
        c, rgw = await make()
        await create_topic(rgw, "t")
        await put_bucket_notification(rgw, "b", [
            {"id": "c", "topic": "t",
             "events": ["s3:ObjectCreated:Copy"]}])
        await rgw.put_object("b", "src", b"data")  # Put: filtered out
        await rgw.copy_object("b", "src", "b", "dst")
        q = TopicQueue(rgw.client, 1, "t")
        events, _m, _tr = await q.pull()
        assert [(e["eventName"], e["s3"]["object"]["key"])
                for e in events] == [("s3:ObjectCreated:Copy", "dst")]
        await c.stop()

    run(t())
