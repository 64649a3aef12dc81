"""The cases of ``tests/test_multimds.py`` on the port (``ceph_tpu_torch``),
each cluster on ``device="cpu"`` (the kernels' plain versions), copied
with only their imports and device changed; the reference's bounds
stay as they are. The reference's own words follow (without its asides
naming review rounds).

Multi-MDS tests: subtree authority partitioning, client redirects,
export (authority handover with cap recall), cross-subtree rename via
peer requests, balancer-driven migration, and export crash replay
(the MDBalancer/Migrator suite role).
"""
import asyncio

import pytest

from ceph_tpu_torch.cluster.vstart import TestCluster
from ceph_tpu_torch.placement.osdmap import Pool
from ceph_tpu_torch.services.fs import FSError, FSLite, NoEnt
from ceph_tpu_torch.services.mds import FSClient, MDBalancer, MDSLite
import torch

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)


def run(coro):
    asyncio.run(asyncio.wait_for(coro, 120))


async def make(n_ranks=2):
    c = TestCluster(n_osds=4, device="cpu")
    await c.start()
    await c.client.create_pool(
        Pool(id=1, name="fs", size=3, pg_num=8, crush_rule=0))
    await c.wait_active(20)
    await FSLite(c.client, 1).mkfs()
    mdss = []
    for r in range(n_ranks):
        m = MDSLite(c.bus, c.client, 1, name=f"mds.{r}")
        await m.start()
        mdss.append(m)
    cl = FSClient(c.bus, c.client, 1, name="fsclient.a")
    await cl.connect()
    return c, mdss, cl


def test_export_and_redirect():
    async def t():
        c, (m0, m1), cl = await make()
        await cl.mkdir("/proj")
        await cl.mkdir("/home")
        await cl.create("/proj/f")
        await cl.write("/proj/f", b"before-export")
        # hand /proj to rank 1; the client's cached map is now stale
        await m0.export_dir("/proj", 1)
        assert m0.auth_rank("/proj") == 1
        # stale-map client transparently follows the redirect
        assert await cl.read("/proj/f") == b"before-export"
        assert cl.submap.get("/proj") == 1
        # mutations land at the new authority; rank 0 still owns /home
        await cl.create("/proj/g")
        await cl.write("/proj/g", b"at-rank-1")
        assert await cl.read("/proj/g") == b"at-rank-1"
        await cl.mkdir("/home/sub")
        assert await cl.listdir("/home") == ["sub"]
        # a SECOND client starting cold (map says rank 0) also follows
        cl2 = FSClient(c.bus, c.client, 1, name="fsclient.b")
        await cl2.connect()
        assert sorted(await cl2.listdir("/proj")) == ["f", "g"]
        # rank 1 cannot re-export what it could, rank 0 cannot export
        # what it no longer owns
        with pytest.raises(FSError):
            await m0.export_dir("/proj", 0)
        with pytest.raises(FSError):
            await m0.export_dir("/", 1)
        await c.stop()

    run(t())


def test_export_recalls_caps():
    async def t():
        c, (m0, m1), cl = await make()
        await cl.mkdir("/d")
        await cl.create("/d/f")
        await cl.write("/d/f", b"x" * 999)  # buffered under the w cap
        assert cl.wcaps  # cap held, size client-side only
        await m0.export_dir("/d", 1)
        # the recall flushed the size into the dentry BEFORE handover:
        # the new authority serves the true size with no cap roundtrip
        assert not cl.wcaps
        st = await cl.stat("/d/f")
        assert st["size"] == 999
        # reopening now grants the cap at rank 1
        await cl.write("/d/f", b"y" * 5, offset=999)
        st2 = await cl.stat("/d/f")
        assert st2["size"] == 1004
        await c.stop()

    run(t())


def test_cross_subtree_rename():
    async def t():
        c, (m0, m1), cl = await make()
        await cl.mkdir("/a")
        await cl.mkdir("/b")
        await m0.export_dir("/b", 1)
        await cl.create("/a/f")
        await cl.write("/a/f", b"moving")
        # rank 0 owns the source, rank 1 the destination dirfrag: the
        # link half travels as a peer request
        await cl.rename("/a/f", "/b/f")
        assert await cl.listdir("/a") == []
        assert await cl.listdir("/b") == ["f"]
        assert await cl.read("/b/f") == b"moving"
        # and back
        await cl.rename("/b/f", "/a/f2")
        assert await cl.listdir("/b") == []
        assert await cl.read("/a/f2") == b"moving"
        # destination collision surfaces as Exists, both directions
        await cl.create("/b/dup")
        await cl.create("/a/dup")
        from ceph_tpu_torch.services.fs import Exists

        with pytest.raises(Exists):
            await cl.rename("/a/dup", "/b/dup")
        await c.stop()

    run(t())


def test_opposite_cross_renames_no_deadlock():
    """Simultaneous A->B and B->A renames must both complete: the
    initiating rank releases its mutation lock before awaiting the
    peer link (the ABBA hazard)."""
    async def t():
        c, (m0, m1), cl = await make()
        await cl.mkdir("/a")
        await cl.mkdir("/b")
        await m0.export_dir("/b", 1)
        await cl.create("/a/x")
        await cl.write("/a/x", b"xx")
        await cl.create("/b/y")
        await cl.write("/b/y", b"yy")
        await asyncio.wait_for(asyncio.gather(
            cl.rename("/a/x", "/b/x2"),
            cl.rename("/b/y", "/a/y2"),
        ), timeout=5)  # well under the 8 s peer timeout
        assert await cl.read("/b/x2") == b"xx"
        assert await cl.read("/a/y2") == b"yy"
        assert await cl.listdir("/a") == ["y2"]
        assert await cl.listdir("/b") == ["x2"]
        await c.stop()

    run(t())


def test_dir_rename_across_subtrees_recalls_caps():
    """Renaming a DIRECTORY into another rank's subtree recalls every
    write cap underneath and rewrites recorded open paths, so flushes
    land on the moved dentries."""
    async def t():
        c, (m0, m1), cl = await make()
        await cl.mkdir("/src")
        await cl.mkdir("/dstroot")
        await m0.export_dir("/dstroot", 1)
        await cl.create("/src/f")
        await cl.write("/src/f", b"z" * 321)  # size buffered in cap
        await cl.rename("/src", "/dstroot/moved")
        assert not cl.wcaps  # recalled (size flushed pre-move)
        st = await cl.stat("/dstroot/moved/f")
        assert st["size"] == 321
        assert await cl.read("/dstroot/moved/f") == b"z" * 321
        await c.stop()

    run(t())


def test_balancer_moves_hot_subtree():
    async def t():
        c, (m0, m1), cl = await make()
        await cl.mkdir("/hot")
        await cl.mkdir("/cold")
        await cl.create("/hot/f")
        for _ in range(30):  # hammer /hot through rank 0
            await cl.listdir("/hot")
        bal = MDBalancer([m0, m1], ratio=2.0, min_load=8.0)
        moves = await bal.tick()
        assert moves and moves[0][0] == "/hot" and moves[0][2] == 1
        assert m0.auth_rank("/hot") == 1
        # the namespace still works end to end after the move
        assert await cl.read("/hot/f") == b""
        await cl.write("/hot/f", b"served-by-1")
        assert await cl.read("/hot/f") == b"served-by-1"
        # balanced now: an immediate second tick moves nothing
        assert await bal.tick() == []
        await c.stop()

    run(t())


def test_client_pin_sticky_and_validated():
    """set_subtree_pin (ceph.dir.pin role): client-driven, sticky
    against the balancer, unpinnable, and rejected for dead ranks."""
    async def t():
        c, (m0, m1), cl = await make()
        await cl.mkdir("/pinned")
        await cl.create("/pinned/f")
        await cl.set_subtree_pin("/pinned", 1)
        assert m0.auth_rank("/pinned") == 1
        await cl.write("/pinned/f", b"x" * 10)
        assert (await cl.stat("/pinned/f"))["size"] == 10
        # hammer rank 1 so the balancer would WANT to move /pinned —
        # the pin keeps it put
        for _ in range(40):
            await cl.listdir("/pinned")
        bal = MDBalancer([m0, m1], ratio=2.0, min_load=8.0)
        assert await bal.tick() == []
        assert m1.auth_rank("/pinned") == 1
        # unpin reverts to the parent's authority (rank 0)
        await cl.set_subtree_pin("/pinned", -1)
        assert "/pinned" not in m1.subtrees
        assert await cl.read("/pinned/f") == b"x" * 10  # via rank 0
        # pinning to a rank that does not exist is refused before the
        # durable flip — no blackholed subtree
        with pytest.raises(FSError):
            await cl.set_subtree_pin("/pinned", 7)
        assert m0.auth_rank("/pinned") == 0
        await c.stop()

    run(t())


def test_export_crash_replay():
    async def t():
        c, (m0, m1), cl = await make()
        await cl.mkdir("/x")
        # journal the export intent, then "crash" before applying:
        # a restarted rank replays the flip from its journal
        args = {"path": b"/x", "rank": b"\x01\x00\x00\x00"}
        await m0._journal("export", args)
        await m0.stop()
        m0b = MDSLite(c.bus, c.client, 1, name="mds.0")
        await m0b.start()
        assert m0b.auth_rank("/x") == 1
        assert m1.auth_rank("/x") == 1 or True  # m1 refreshes lazily
        # the client finds the new authority through the redirect
        await cl.create("/x/f")
        assert await cl.listdir("/x") == ["f"]
        await c.stop()

    run(t())


def test_snapshots_across_ranks():
    """A snapshot taken at rank 1 must COW data written through a
    client whose snapc came from BOTH ranks (the merge rule)."""
    async def t():
        c, (m0, m1), cl = await make()
        await cl.mkdir("/s")
        await m0.export_dir("/s", 1)
        await cl.create("/s/f")
        await cl.write("/s/f", b"v1")
        sid = await cl.mksnap("/s", "snap1")  # served by rank 1
        assert sid > 0
        # talk to rank 0 (refreshes client snapc from its view, which
        # lacks rank 1's snap) — the MERGE keeps snap1's id
        await cl.mkdir("/elsewhere")
        assert sid in cl._snapc[1]
        await cl.write("/s/f", b"v2")
        assert await cl.read("/s/f") == b"v2"
        assert await cl.snap_read("/s", "snap1", "f") == b"v1"
        await c.stop()

    run(t())
