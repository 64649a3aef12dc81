"""The cases of ``tests/test_mds.py`` on the port (``ceph_tpu_torch``),
each cluster on ``device="cpu"`` (the kernels' plain versions), copied
with only their imports and device changed; the reference's bounds
stay as they are. The reference's own words follow (without its asides
naming review rounds).

MDSLite daemon: metadata authority, capabilities with revoke, and
MDLog-role journal recovery.

Acceptance: a two-client coherence test and a kill-MDS-mid-rename
recovery test.
"""
import asyncio

import pytest

from ceph_tpu_torch.cluster.vstart import TestCluster
from ceph_tpu_torch.placement.osdmap import Pool
from ceph_tpu_torch.services.fs import Exists, FSLite, NoEnt
from ceph_tpu_torch.services.mds import FSClient, MDSLite, _MDSCrash
import torch

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)


def run(coro):
    asyncio.run(asyncio.wait_for(coro, 120))


async def make():
    c = TestCluster(n_osds=4, device="cpu")
    await c.start()
    await c.client.create_pool(
        Pool(id=1, name="fs", size=3, pg_num=8, crush_rule=0))
    await c.wait_active(20)
    await FSLite(c.client, 1).mkfs()
    mds = MDSLite(c.bus, c.client, 1)
    await mds.start()
    a = FSClient(c.bus, c.client, 1, name="fsclient.a")
    b = FSClient(c.bus, c.client, 1, name="fsclient.b")
    await a.connect()
    await b.connect()
    return c, mds, a, b


def test_two_client_coherence():
    """mkdir/create/rename/write by one client are immediately visible
    to the other — the single-authority serialization the library
    version of fs.py could not give."""
    async def t():
        c, mds, a, b = await make()
        await a.mkdir("/shared")
        assert await b.listdir("/") == ["shared"]
        await a.create("/shared/f")
        await a.write("/shared/f", b"written-by-A" * 100)
        # B's stat RECALLS A's write cap: A's buffered size flushes to
        # the MDS, so B sees the true size without A closing the file
        st = await b.stat("/shared/f")
        assert st["size"] == 1200
        assert await b.read("/shared/f") == b"written-by-A" * 100
        # B renames while A still has the path; A reopens and writes
        await b.rename("/shared/f", "/shared/g")
        assert await a.listdir("/shared") == ["g"]
        with pytest.raises(NoEnt):
            await b.stat("/shared/f")
        await b.write("/shared/g", b"B!", 0)
        st2 = await a.stat("/shared/g")
        assert st2["size"] == 1200  # B's partial overwrite kept length
        assert (await a.read("/shared/g"))[:2] == b"B!"
        # concurrent mkdir of the same name: exactly one wins
        results = await asyncio.gather(
            a.mkdir("/race"), b.mkdir("/race"), return_exceptions=True)
        assert sum(1 for r in results if r is None) == 1
        assert sum(1 for r in results if isinstance(r, Exists)) == 1
        await a.close()
        await b.close()
        await c.stop()

    run(t())


def test_write_cap_exclusive_and_revoked():
    async def t():
        c, mds, a, b = await make()
        await a.create("/f")
        await a.write("/f", b"x" * 5000)
        ino = a._paths["/f"]
        assert ino in a.wcaps  # A buffers size 5000 under its cap
        assert a.wcaps[ino] == 5000
        # B opening for write revokes A's cap (exclusive)
        await b.open("/f", "w")
        assert ino not in a.wcaps  # revoked + flushed
        st = await mds.fs.stat("/f")
        assert st["size"] == 5000  # A's buffered size landed
        await b.write("/f", b"y" * 100, offset=5000)
        await b.close()
        assert (await a.stat("/f"))["size"] == 5100
        await a.close()
        await c.stop()

    run(t())


def test_mds_crash_mid_rename_recovers():
    """Kill the MDS between the two dirfrag updates of a rename: the
    journal replay on the next MDS completes it — the file exists at
    exactly one path (MDLog crash-recovery role)."""
    async def t():
        c, mds, a, b = await make()
        await a.mkdir("/d1")
        await a.mkdir("/d2")
        await a.create("/d1/f")
        await a.write("/d1/f", b"payload" * 10)
        # flush A's cap so the size is durable before the crash
        await a.close()

        mds._crash_mid_rename = True
        with pytest.raises(Exception):
            await b.rename("/d1/f", "/d2/f")
        # the daemon died mid-op: destination linked, source not yet
        # unlinked — both paths resolve right now (the torn state)
        await mds.stop()

        mds2 = MDSLite(c.bus, c.client, 1)
        await mds2.start()  # journal replay completes the rename
        assert await b.listdir("/d1") == []
        assert await b.listdir("/d2") == ["f"]
        assert await b.read("/d2/f") == b"payload" * 10
        # and the namespace still takes mutations
        await b.rename("/d2/f", "/d1/f")
        assert await b.listdir("/d1") == ["f"]
        await b.close()
        await mds2.stop()
        await c.stop()

    run(t())


def test_mds_restart_idempotent_replay():
    """A completed-but-unexpired journal entry replays as a no-op."""
    async def t():
        c, mds, a, b = await make()
        await a.mkdir("/x")
        await a.create("/x/file")
        # simulate crash AFTER apply but BEFORE expire: rewind pointer
        await c.client.omap_set(1, b"mdslog", {b"expired_upto":
                                               b"\x00" * 8})
        await mds.stop()
        mds2 = MDSLite(c.bus, c.client, 1)
        await mds2.start()  # replays mkdir + create: both exist already
        assert await b.listdir("/x") == ["file"]
        await b.write("/x/file", b"ok")
        assert await b.read("/x/file") == b"ok"
        await a.close()
        await b.close()
        await mds2.stop()
        await c.stop()

    run(t())


def test_trim_then_restart_preserves_crash_recovery():
    """Regression: after a journal trim and an
    MDS restart, new intents must journal at seqs ABOVE the persisted
    expired_upto — otherwise a later crash replay skips them and a torn
    rename persists, exactly the failure the journal exists to prevent."""
    async def t():
        c, mds, a, b = await make()
        await a.mkdir("/d1")
        await a.mkdir("/d2")
        await a.create("/d1/f")
        await a.close()
        # force a trim: pretend the journal body crossed the threshold
        mds._jbytes = (1 << 20) + 1
        await a.connect()
        await a.mkdir("/junk")  # any journaled mutation triggers _expire
        assert mds._jbytes == 0  # trimmed
        await mds.stop()

        # restart: _seq must resume above the pre-trim high-water
        mds2 = MDSLite(c.bus, c.client, 1)
        await mds2.start()
        assert mds2._seq >= mds._seq

        # now crash mid-rename on the restarted daemon; replay must
        # complete it (would be skipped as "expired" before the fix)
        mds2._crash_mid_rename = True
        with pytest.raises(Exception):
            await b.rename("/d1/f", "/d2/f")
        await mds2.stop()
        mds3 = MDSLite(c.bus, c.client, 1)
        await mds3.start()
        assert await b.listdir("/d1") == []
        assert await b.listdir("/d2") == ["f"]
        await a.close()
        await b.close()
        await mds3.stop()
        await c.stop()

    run(t())


def test_dead_client_evicted():
    """A vanished cap holder cannot wedge the namespace: the revoke
    times out and the MDS evicts the cap (session-eviction role)."""
    async def t():
        c, mds, a, b = await make()
        mds.revoke_timeout = 0.3
        await a.create("/f")
        await a.write("/f", b"z" * 10)
        # A disappears without closing (no unregister -> revoke times out)
        c.bus.unregister("fsclient.a")
        st = await b.stat("/f")  # must not hang; buffered size is lost
        assert st["size"] in (0, 10)  # eviction drops the unflushed size
        await b.write("/f", b"recovered")
        assert await b.read("/f") == b"recovered"
        await b.close()
        await c.stop()

    run(t())


def test_fs_snapshots_read_back_after_mutation():
    """.snap-role read-only snapshots (SnapServer + snaprealm roles):
    metadata freezes at mksnap, file DATA is lazy-COW
    through the data pool's SnapContext — overwrite, truncate, delete,
    and new files after the snapshot never leak into it."""
    async def t():
        c, mds, a, b = await make()
        await a.mkdir("/proj")
        await a.mkdir("/proj/sub")
        await a.write("/proj/report", b"version-one")
        await a.write("/proj/sub/data", b"D" * 5000)
        await a._flush(a._paths["/proj/report"])
        await a._flush(a._paths["/proj/sub/data"])

        await a.mksnap("/proj", "s1")
        assert await a.lssnap("/proj") == ["s1"]

        # mutate everything after the snapshot
        await a.write("/proj/report", b"VERSION-TWO-IS-LONGER")
        await a.unlink("/proj/sub/data")
        await a.write("/proj/new-file", b"born later")
        await a._flush(a._paths["/proj/report"])

        # live view reflects the mutations...
        assert await a.read("/proj/report") == b"VERSION-TWO-IS-LONGER"
        assert sorted(await a.listdir("/proj")) == \
            ["new-file", "report", "sub"]
        # ...the snapshot does not — including from ANOTHER client
        assert await b.snap_read("/proj", "s1", "report") \
            == b"version-one"
        assert await b.snap_read("/proj", "s1", "sub/data") \
            == b"D" * 5000
        assert await b.snap_listdir("/proj", "s1") == \
            ["report", "sub"]
        st = await b.snap_stat("/proj", "s1", "report")
        assert st["size"] == len(b"version-one")

        # rmsnap removes the frozen view and the key from lssnap
        await a.rmsnap("/proj", "s1")
        assert await a.lssnap("/proj") == []
        import pytest as _pytest

        from ceph_tpu_torch.services import fs as fslib

        with _pytest.raises(fslib.NoEnt):
            await b.snap_read("/proj", "s1", "report")
        await c.stop()

    run(t())


def test_snapshot_recalls_foreign_write_caps():
    """mksnap recalls write caps under the subtree, so a snapshot taken
    by client A freezes client B's BUFFERED size, and B's next write
    re-opens with the new SnapContext (COW stays correct)."""
    async def t():
        c, mds, a, b = await make()
        await b.write("/doc", b"buffered-by-b")
        # b holds the w cap with a buffered size; a snapshots the root
        await a.mksnap("/", "root-snap")
        # the recall flushed b's size into the dentry the snap froze
        assert await a.snap_read("/", "root-snap", "doc") \
            == b"buffered-by-b"
        # b's next write goes through a fresh open (cap was recalled)
        # and carries the updated SnapContext
        await b.write("/doc", b"after-snap-bbbb")
        await b._flush(b._paths["/doc"])
        assert await a.read("/doc") == b"after-snap-bbbb"
        assert await a.snap_read("/", "root-snap", "doc") \
            == b"buffered-by-b"
        await c.stop()

    run(t())


def test_snapshots_survive_mds_restart():
    """The snap table persists (SnapServer store role): a restarted MDS
    serves existing snapshots."""
    async def t():
        c, mds, a, b = await make()
        await a.write("/f", b"pre-snap")
        await a._flush(a._paths["/f"])
        await a.mksnap("/", "keep")
        await a.write("/f", b"post-snap!")
        await a._flush(a._paths["/f"])

        await mds.stop()
        mds2 = MDSLite(c.bus, c.client, 1)
        await mds2.start()
        assert await a.lssnap("/") == ["keep"]
        assert await a.snap_read("/", "keep", "f") == b"pre-snap"
        assert await a.read("/f") == b"post-snap!"
        await c.stop()

    run(t())


def test_object_cacher_fs_cap_fence():
    """ObjectCacher under the fs client: buffered data flushes when the
    MDS revokes the write cap, so the OTHER client reads it all."""
    async def t():
        c, mds, _a, _b = await make()
        a = FSClient(c.bus, c.client, 1, name="fsclient.ca",
                     cache=True)
        b = FSClient(c.bus, c.client, 1, name="fsclient.cb")
        await a.connect()
        await b.connect()
        await a.write("/doc", b"cached-" * 1000)
        assert a._cacher.dirty_bytes() > 0  # write-back, not landed
        # b's stat triggers the cap revoke -> a flushes data THEN size
        assert await b.read("/doc") == b"cached-" * 1000
        assert a._cacher.dirty_bytes() == 0
        await a.close()
        await b.close()
        await c.stop()

    run(t())


def test_cached_reader_invalidated_by_foreign_write():
    """Reader-side coherence: a cached fs reader registers an r cap, so
    a foreign writer's open revokes it and the cache drops — the next
    read sees the new content (no stale serve)."""
    async def t():
        c, mds, _a, _b = await make()
        rdr = FSClient(c.bus, c.client, 1, name="fsclient.r",
                       cache=True)
        wtr = FSClient(c.bus, c.client, 1, name="fsclient.w")
        await rdr.connect()
        await wtr.connect()
        await wtr.write("/news", b"first edition")
        await wtr._flush(wtr._paths["/news"])
        assert await rdr.read("/news") == b"first edition"  # cached now
        await wtr.write("/news", b"SECOND edition")
        await wtr._flush(wtr._paths["/news"])
        # the writer's open revoked rdr's r cap -> cache invalidated
        assert await rdr.read("/news") == b"SECOND edition"
        await rdr.close()
        await wtr.close()
        await c.stop()

    run(t())


def test_fs_cache_coherent_across_truncate():
    """FSClient.truncate goes through the MDS behind the data cache:
    cached/buffered bytes past the cut must neither be served nor
    re-flushed at a later cap fence."""
    async def t():
        c, mds, _a, _b = await make()
        fsc = FSClient(c.bus, c.client, 1, name="fsclient.tr",
                       cache=True)
        await fsc.connect()
        await fsc.write("/f", b"D" * 50_000)
        assert (await fsc.read("/f"))[:50] == b"D" * 50
        await fsc.truncate("/f", 10)
        await fsc.write("/f", b"x", offset=50_000)  # re-extend
        got = await fsc.read("/f")
        assert got[:10] == b"D" * 10
        assert got[10:50_000] == b"\x00" * (50_000 - 10)
        assert got[50_000:] == b"x"
        await fsc.close()
        await c.stop()

    run(t())


def test_truncate_of_unopened_path_keeps_other_dirty_data():
    """A truncate of a path this client never opened must not discard
    OTHER files' buffered dirty writes in the wholesale invalidate
    (a confirmed repro)."""
    async def t():
        c, mds, _a, _b = await make()
        w = FSClient(c.bus, c.client, 1, name="fsclient.w2")
        await w.connect()
        await w.write("/other", b"O" * 3000)
        await w.close()
        fsc = FSClient(c.bus, c.client, 1, name="fsclient.k",
                       cache=True)
        await fsc.connect()
        await fsc.write("/doc", b"IMPORTANT" * 1000)
        assert fsc._cacher.dirty_bytes() > 0
        await fsc.truncate("/other", 10)  # never opened here
        await fsc.close()
        rdr = FSClient(c.bus, c.client, 1, name="fsclient.k2")
        await rdr.connect()
        assert await rdr.read("/doc") == b"IMPORTANT" * 1000
        assert await rdr.read("/other") == b"O" * 10
        await rdr.close()
        await c.stop()

    run(t())


def test_foreign_truncate_invalidates_cached_reader():
    """The MDS truncate verb recalls caps: a cached reader must not
    serve pre-truncate bytes after another client cut the file
    (a confirmed repro)."""
    async def t():
        c, mds, _a, _b = await make()
        w = FSClient(c.bus, c.client, 1, name="fsclient.tw")
        r = FSClient(c.bus, c.client, 1, name="fsclient.trd",
                     cache=True)
        await w.connect()
        await r.connect()
        await w.write("/f", b"D" * 50_000)
        await w._flush(w._paths["/f"])
        assert await r.read("/f") == b"D" * 50_000  # cached now
        await w.truncate("/f", 10)
        await w.write("/f", b"z", offset=49_999)  # re-extend
        await w._flush(w._paths["/f"])
        got = await r.read("/f")
        assert got[:10] == b"D" * 10
        assert got[10:49_999] == b"\x00" * (49_999 - 10)
        assert got[49_999:] == b"z"
        await w.close()
        await r.close()
        await c.stop()

    run(t())


def test_quota_count_cache_deflates_on_unlink():
    """Regression: the realm count cache self-advances on every
    accepted create (and each accept re-extends its TTL), but deletes
    must deflate it too — otherwise a sustained create/delete churn
    under a max_files quota returns EDQUOT while the realm is actually
    under the limit."""
    import ceph_tpu_torch.services.fs as fslib

    async def t():
        c, mds, a, _b = await make()
        await a.mkdir("/q")
        await a.set_quota("/q", max_files=3)
        await a.create("/q/f1")
        await a.create("/q/f2")
        await a.create("/q/f3")
        with pytest.raises(fslib.QuotaExceeded):
            await a.create("/q/f4")
        # churn: delete + create repeatedly WITHIN the cache TTL; the
        # cached count must deflate on each unlink or the self-advance
        # keeps it pinned at the limit and every create EDQUOTs
        for i in range(5):
            await a.unlink("/q/f1")
            await a.create("/q/f1")
        # rmdir deflates too: swap a dir out for a file at the limit
        await a.unlink("/q/f1")
        await a.mkdir("/q/d1")
        with pytest.raises(fslib.QuotaExceeded):
            await a.create("/q/f5")
        await a.rmdir("/q/d1")
        await a.create("/q/f5")
        # rename OUT of the realm deflates it the same way (and the
        # realm-free destination never blocks)
        await a.mkdir("/out")
        await a.rename("/q/f5", "/out/f5")
        await a.create("/q/f6")
        with pytest.raises(fslib.QuotaExceeded):
            await a.create("/q/f7")
        await c.stop()

    run(t())


def test_quotas_files_and_bytes():
    """ceph.quota.max_files (MDS-enforced on create/mkdir) and
    max_bytes (client-enforced on growing writes), realm nesting,
    rstat surface, and clearing."""
    import ceph_tpu_torch.services.fs as fslib

    async def t():
        c, mds, a, b = await make()
        await a.mkdir("/q")
        await a.set_quota("/q", max_files=3)
        await a.create("/q/f1")
        await a.create("/q/f2")
        await a.mkdir("/q/sub")  # 3rd entry hits the limit
        with pytest.raises(fslib.QuotaExceeded):
            await a.create("/q/f3")
        # enforcement is realm-wide: the OTHER client hits it too,
        # and nested dirs count against the same realm
        with pytest.raises(fslib.QuotaExceeded):
            await b.create("/q/sub/nested")
        # outside the realm creation is free
        await a.create("/free")
        # lift the file quota, set a byte quota
        await a.set_quota("/q", max_bytes=4096)
        await a.create("/q/f3")
        await a.write("/q/f3", b"x" * 2048)
        await a._flush(a._paths["/q/f3"])
        b._quota_cache.clear()
        with pytest.raises(fslib.QuotaExceeded):
            await b.write("/q/big", b"y" * 4096)
        # usage surface (getquota + dirstat)
        q = await a.get_quota("/q/sub")
        assert q["realm"] == "/q" and q["max_bytes"] == 4096
        assert q["rbytes"] >= 2048
        st = await a.dir_stat("/q")
        # f1 f2 f3 + the empty "big" left by the rejected write (the
        # create lands before the byte check, POSIX-style)
        assert st["rfiles"] == 4 and st["rsubdirs"] == 1
        assert st["rbytes"] >= 2048
        # clear the quota: writes flow again
        await a.set_quota("/q")
        b._quota_cache.clear()
        await b.write("/q/big", b"y" * 8192)
        await c.stop()

    run(t())


def test_quota_nested_realms():
    """A deeper realm with a tighter limit wins for paths under it;
    the outer realm still governs siblings."""
    import ceph_tpu_torch.services.fs as fslib

    async def t():
        c, mds, a, b = await make()
        await a.mkdir("/outer")
        await a.mkdir("/outer/inner")
        await a.set_quota("/outer", max_files=10)
        await a.set_quota("/outer/inner", max_files=1)
        await a.create("/outer/inner/one")
        with pytest.raises(fslib.QuotaExceeded):
            await a.create("/outer/inner/two")
        # sibling under the outer realm only: fine
        for i in range(3):
            await a.create(f"/outer/s{i}")
        q = await a.get_quota("/outer/inner/one")
        assert q["realm"] == "/outer/inner"
        await c.stop()

    run(t())
