"""The cases of ``tests/test_rgw_sync.py`` on the port (``ceph_tpu_torch``),
each cluster on ``device="cpu"`` (the kernels' plain versions), copied
with only their imports and device changed; the reference's bounds
stay as they are. The reference's own words follow.

RGW multisite sync tests: datalog tailing, full-sync bootstrap,
versioned replication, marker persistence (the rgw multisite suite
role, shrunk to two zones on one cluster)."""
import asyncio
import hashlib

import numpy as np
import pytest

from ceph_tpu_torch.cluster.vstart import TestCluster
from ceph_tpu_torch.placement.osdmap import Pool
from ceph_tpu_torch.services.rgw import RGWError, RGWLite
from ceph_tpu_torch.services.rgw_sync import RGWSyncAgent
import torch

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)


def run(coro):
    asyncio.run(asyncio.wait_for(coro, 180))


async def make():
    c = TestCluster(n_osds=4, device="cpu")
    await c.start()
    await c.client.create_pool(
        Pool(id=1, name="zone-a", size=3, pg_num=8, crush_rule=0))
    await c.client.create_pool(
        Pool(id=2, name="zone-b", size=3, pg_num=8, crush_rule=0))
    await c.wait_active(20)
    src = RGWLite(c.client, 1, zone="a", datalog=True)
    dst = RGWLite(c.client, 2, zone="b")
    return c, src, dst, RGWSyncAgent(src, dst)


def test_incremental_sync_plain():
    async def t():
        c, src, dst, agent = await make()
        await src.create_bucket("b")
        await src.put_object("b", "k1", b"one",
                             content_type="text/plain",
                             meta={"color": "red"})
        await src.put_object("b", "k2", b"two")
        await agent.sync_once()
        assert await dst.list_buckets() == ["b"]
        got, meta = await dst.get_object("b", "k1")
        assert got == b"one" and meta["content_type"] == "text/plain"
        assert meta["meta"] == {"color": "red"}
        # etag + mtime preserved verbatim across zones
        s = await src.head_object("b", "k1")
        assert (meta["etag"], meta["mtime"]) == (s["etag"], s["mtime"])
        # overwrite + delete propagate
        await src.put_object("b", "k1", b"one-v2")
        await src.delete_object("b", "k2")
        await agent.sync_once()
        got, _ = await dst.get_object("b", "k1")
        assert got == b"one-v2"
        with pytest.raises(RGWError, match="NoSuchKey"):
            await dst.get_object("b", "k2")
        # idempotent: nothing new -> nothing applied
        r = await agent.sync_once()
        assert r["applied"] == 0
        # metadata-only change (same bytes, new content-type/meta)
        # still replicates — replication identity covers the index row
        await src.put_object("b", "k1", b"one-v2",
                             content_type="text/html",
                             meta={"rev": "2"})
        await agent.sync_once()
        got, meta = await dst.get_object("b", "k1")
        assert got == b"one-v2" and meta["content_type"] == "text/html"
        assert meta["meta"] == {"rev": "2"}
        await c.stop()

    run(t())


def test_full_sync_bootstrap_and_striped():
    async def t():
        c, src, dst, agent = await make()
        await src.create_bucket("boot")
        big = np.random.default_rng(7).integers(
            0, 256, (1 << 22) + 4096, dtype=np.uint8).tobytes()
        await src.put_object("boot", "big", big)  # striped form
        await src.put_object("boot", "small", b"s")
        # multipart object: lands assembled on dst, same "-N" etag
        up = await src.initiate_multipart("boot", "mp")
        p1 = b"a" * 1024
        p2 = b"b" * 2048
        await src.upload_part("boot", "mp", up, 1, p1)
        await src.upload_part("boot", "mp", up, 2, p2)
        etag = await src.complete_multipart("boot", "mp", up, [1, 2])
        assert etag.endswith("-2")
        await agent.sync_once()
        got, meta = await dst.get_object("boot", "big")
        assert got == big
        got, meta = await dst.get_object("boot", "mp")
        assert got == p1 + p2 and meta["etag"] == etag
        assert not meta["multipart"]  # assembled on the destination
        # re-sync converges (etag equality, no blind re-copy)
        r = await agent.sync_once()
        assert r["applied"] == 0
        await c.stop()

    run(t())


def test_versioned_sync():
    async def t():
        c, src, dst, agent = await make()
        await src.create_bucket("v")
        await src.put_object("v", "pre", b"null-data")  # pre-versioning
        await src.put_bucket_versioning("v", "Enabled")
        _e1, v1 = await src.put_object("v", "k", b"ver1")
        _e2, v2 = await src.put_object("v", "k", b"ver2")
        marker_vid = await src.delete_object("v", "k")  # delete marker
        _e3, v3 = await src.put_object("v", "k", b"ver3")
        await src.put_object("v", "pre", b"shadows-null")
        await agent.sync_once()
        assert await dst.get_bucket_versioning("v") == "Enabled"
        # full version timeline replicated, newest-first, same vids
        sv = await src.list_object_versions("v", prefix="k")
        dv = await dst.list_object_versions("v", prefix="k")
        assert [(e["version_id"], e["delete_marker"], e["is_latest"])
                for e in sv] == \
               [(e["version_id"], e["delete_marker"], e["is_latest"])
                for e in dv]
        assert {e["version_id"] for e in dv} == \
               {v1, v2, v3, marker_vid}
        for vid, want in ((v1, b"ver1"), (v2, b"ver2"), (v3, b"ver3")):
            got, _ = await dst.get_object("v", "k", version_id=vid)
            assert got == want
        # preserved null version rode along
        got, _ = await dst.get_object("v", "pre", version_id="null")
        assert got == b"null-data"
        # by-vid deletion of the CURRENT version propagates; the
        # promotion lands the delete marker (next-newest) as current on
        # both sides, so the key reads absent
        await src.delete_object("v", "k", version_id=v3)
        await agent.sync_once()
        with pytest.raises(RGWError, match="NoSuchKey"):
            await src.get_object("v", "k")
        with pytest.raises(RGWError, match="NoSuchKey"):
            await dst.get_object("v", "k")
        await c.stop()

    run(t())


def test_versioned_current_after_vid_delete():
    async def t():
        c, src, dst, agent = await make()
        await src.create_bucket("v")
        await src.put_bucket_versioning("v", "Enabled")
        _e1, v1 = await src.put_object("v", "k", b"a")
        _e2, v2 = await src.put_object("v", "k", b"b")
        await src.delete_object("v", "k", version_id=v2)
        await agent.sync_once()
        # v2 gone on both sides; v1 promoted back to current
        got, meta = await dst.get_object("v", "k")
        assert got == b"a" and meta["version_id"] == v1
        with pytest.raises(RGWError, match="NoSuchVersion"):
            await dst.get_object("v", "k", version_id=v2)
        await c.stop()

    run(t())


def test_marker_persistence_and_trim():
    async def t():
        c, src, dst, agent = await make()
        agent.trim = True
        await src.create_bucket("m")
        await src.put_object("m", "k", b"x")
        r1 = await agent.sync_once()
        assert r1["applied"] > 0
        # trimmed: the source log holds nothing before the marker
        head, ents, _tr = await src.datalog.list(0, 100)
        assert not ents and head == r1["marker"]
        # a NEW agent over the same zones resumes from the durable
        # marker: no second full sync, no replays
        agent2 = RGWSyncAgent(src, dst)
        r2 = await agent2.sync_once()
        assert r2["applied"] == 0 and r2["marker"] == r1["marker"]
        await src.put_object("m", "k2", b"y")
        r3 = await agent2.sync_once()
        assert r3["applied"] >= 1
        got, _ = await dst.get_object("m", "k2")
        assert got == b"y"
        await c.stop()

    run(t())


def test_bucket_teardown_and_background_loop():
    async def t():
        c, src, dst, agent = await make()
        await src.create_bucket("gone")
        await src.put_object("gone", "k", b"x")
        await agent.sync_once()
        assert await dst.list_buckets() == ["gone"]
        await src.delete_object("gone", "k")
        await src.delete_bucket("gone")
        await agent.sync_once()
        assert await dst.list_buckets() == []
        # background loop picks up new writes without explicit calls
        await src.create_bucket("live")
        agent.start(interval=0.05)
        await src.put_object("live", "k", b"tail")
        for _ in range(100):
            try:
                got, _ = await dst.get_object("live", "k")
                if got == b"tail":
                    break
            except RGWError:
                pass
            await asyncio.sleep(0.05)
        else:
            raise AssertionError("background sync never converged")
        await agent.stop()
        await c.stop()

    run(t())


def test_sigv4_unaffected_requires_datalog():
    """An agent over a zone without a datalog is a configuration
    error, reported eagerly."""
    async def t():
        c = TestCluster(n_osds=3, device="cpu")
        await c.start()
        await c.client.create_pool(
            Pool(id=1, name="z", size=2, pg_num=4, crush_rule=0))
        await c.wait_active(20)
        src = RGWLite(c.client, 1)
        with pytest.raises(ValueError, match="datalog"):
            RGWSyncAgent(src, src)
        await c.stop()

    run(t())


def test_acl_replication():
    """ACL changes replicate: on create, on ACL-only rewrite of a
    plain object, and on an in-place version-row rewrite (_ent_sig
    must cover owner/acl, and matching version rows must be
    re-compared, not just copied-when-missing)."""
    async def t():
        c, src, dst, agent = await make()
        await src.create_bucket("b", owner="alice")
        await src.put_object("b", "k", b"data", owner="alice",
                             acl="*:READ")
        await agent.sync_once()
        assert await dst.get_bucket_acl("b") == \
            await src.get_bucket_acl("b")
        assert await dst.get_object_acl("b", "k") == ("alice", "*:READ")
        # ACL-only rewrite (same bytes) propagates — e.g. revoking
        # public-read must not leave the peer zone serving it publicly
        await src.put_object_acl("b", "k", "alice", "")
        await agent.sync_once()
        assert await dst.get_object_acl("b", "k") == ("alice", "")
        # versioned: in-place ACL rewrite of an EXISTING version row
        await src.put_bucket_versioning("b", "Enabled")
        _e, v1 = await src.put_object("b", "vk", b"v1", owner="alice")
        await agent.sync_once()
        assert (await dst.get_object_acl("b", "vk",
                                         version_id=v1)) == \
            ("alice", "")
        await src.put_object_acl("b", "vk", "alice", "bob:READ",
                                 version_id=v1)
        await agent.sync_once()
        assert (await dst.get_object_acl("b", "vk",
                                         version_id=v1)) == \
            ("alice", "bob:READ")
        await c.stop()

    run(t())
