"""The cases of ``tests/test_rbd.py`` on the port (``ceph_tpu_torch``),
each cluster on ``device="cpu"`` (the kernels' plain versions), copied
with only their imports and device changed; the reference's bounds
stay as they are. The reference's own words follow.

RBD-lite tests: image lifecycle, striped IO, snapshots, layering
(the librbd test role)."""
import asyncio

import numpy as np
import pytest

from ceph_tpu_torch.cluster.vstart import TestCluster
from ceph_tpu_torch.osdc.striper import FileLayout
from ceph_tpu_torch.placement.osdmap import Pool
from ceph_tpu_torch.services import RBD, ImageNotFound
from ceph_tpu_torch.services.rbd import ImageExists
import torch

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)

LAYOUT = FileLayout(stripe_unit=8192, stripe_count=1, object_size=8192)


def run(coro):
    asyncio.run(asyncio.wait_for(coro, 120))


async def make():
    c = TestCluster(n_osds=4, device="cpu")
    await c.start()
    await c.client.create_pool(
        Pool(id=1, name="rbd", size=3, pg_num=8, crush_rule=0)
    )
    await c.wait_active(20)
    return c, RBD(c.client, 1)


def test_image_lifecycle_and_io():
    async def t():
        c, rbd = await make()
        await rbd.create("disk", 64 * 1024, LAYOUT)
        with pytest.raises(ImageExists):
            await rbd.create("disk", 1024)
        img = await rbd.open("disk")
        assert img.size == 64 * 1024
        rng = np.random.default_rng(3)
        data = rng.integers(0, 256, 30000, dtype=np.uint8).tobytes()
        await img.write(1000, data)
        assert await img.read(1000, 30000) == data
        # holes read as zeros
        assert await img.read(40000, 100) == b"\0" * 100
        # cross-object overwrite
        await img.write(8000, b"B" * 400)
        got = await img.read(7990, 420)
        assert got[10:410] == b"B" * 400
        # discard zeroes a range
        await img.discard(1000, 500)
        assert await img.read(1000, 500) == b"\0" * 500
        with pytest.raises(IOError):
            await img.write(64 * 1024 - 10, b"x" * 20)  # past end
        await c.stop()

    run(t())


def test_resize_and_remove():
    async def t():
        c, rbd = await make()
        await rbd.create("vol", 40960, LAYOUT)  # 5 objects
        img = await rbd.open("vol")
        await img.write(0, b"A" * 40960)
        await img.resize(12000)  # shrink into object 1
        assert img.size == 12000
        assert await img.read(0, 12000) == b"A" * 12000
        await img.resize(20000)  # grow: new bytes read as zeros
        got = await img.read(0, 20000)
        assert got[:12000] == b"A" * 12000
        assert got[12000:] == b"\0" * 8000
        await rbd.remove("vol")
        with pytest.raises(ImageNotFound):
            await rbd.open("vol")
        await c.stop()

    run(t())


def test_snapshots_and_rollback():
    async def t():
        c, rbd = await make()
        await rbd.create("img", 32768, LAYOUT)
        img = await rbd.open("img")
        await img.write(0, b"v1" * 8000)
        await img.snap_create("s1")
        await img.write(0, b"v2" * 8000)
        assert await img.read(0, 16000) == b"v2" * 8000
        # read-at-snap sees the old data
        at_s1 = await rbd.open("img", snap="s1")
        assert await at_s1.read(0, 16000) == b"v1" * 8000
        with pytest.raises(IOError):
            await at_s1.write(0, b"nope")
        assert await img.snap_list() == ["s1"]
        await img.snap_rollback("s1")
        assert await img.read(0, 16000) == b"v1" * 8000
        await img.snap_remove("s1")
        assert await img.snap_list() == []
        # removing an image with snapshots is refused
        await img.snap_create("s2")
        with pytest.raises(RuntimeError):
            await rbd.remove("img")
        await c.stop()

    run(t())


def test_clone_cow_and_flatten():
    async def t():
        c, rbd = await make()
        await rbd.create("base", 32768, LAYOUT)
        base = await rbd.open("base")
        await base.write(0, b"GOLD" * 4096)  # 16384 bytes, 2 objects
        await base.snap_create("gold")
        await rbd.clone("base", "gold", "child")
        child = await rbd.open("child")
        assert child.parent == ("base", "gold")
        # unwritten child extents read through to the parent snapshot
        assert await child.read(0, 16384) == b"GOLD" * 4096
        # COW: writing the child leaves the parent untouched
        await child.write(0, b"EDIT")
        assert (await child.read(0, 8))[:4] == b"EDIT"
        assert await base.read(0, 8) == b"GOLDGOLD"
        # the copied-up object carries the rest of the parent bytes
        assert await child.read(4, 100) == (b"GOLD" * 30)[4 - 4:100]
        # parent changes after the snap are invisible to the child
        await base.write(8192, b"NEWBASE!")
        assert await child.read(8192, 8) == b"GOLD" * 2
        await child.flatten()
        assert child.parent is None
        # flatten made the child self-contained: removing base works
        await base.snap_remove("gold")
        await rbd.remove("base")
        assert await child.read(0, 4) == b"EDIT"
        await c.stop()

    run(t())


def test_clone_child_snapshot_preserves_parent_backed_data():
    """A snapshot of a clone child must serve parent-backed extents the
    child never copied up — at the child's snap the object's logical
    content was the parent's clone-time data (librbd layered-snap
    semantics)."""
    async def t():
        c, rbd = await make()
        await rbd.create("base", 32768, LAYOUT)
        base = await rbd.open("base")
        await base.write(0, b"GOLD" * 4096)
        await base.snap_create("gold")
        await rbd.clone("base", "gold", "child")
        child = await rbd.open("child")
        await child.snap_create("cs")  # O(1): no data copied
        # write AFTER the snap: triggers copy-up + overwrite
        await child.write(0, b"EDIT")
        # the snap still shows parent content, not zeros and not EDIT
        snapv = await rbd.open("child", snap="cs")
        assert await snapv.read(0, 8) == b"GOLDGOLD"
        # an object never touched in the child also resolves via parent
        assert await snapv.read(8192, 8) == b"GOLD" * 2
        # head shows the edit
        assert (await child.read(0, 8))[:4] == b"EDIT"
        await c.stop()

    run(t())


def test_exclusive_lock_two_clients_cooperative():
    """Two live image handles serialize through the exclusive lock
    (ExclusiveLock.h:20 role): the second handle's acquire notifies the
    holder, which releases cooperatively, and ownership transfers."""
    async def t():
        from ceph_tpu_torch.cluster.client import RadosClient

        c, rbd = await make()
        await rbd.create("disk", 64 * 1024, LAYOUT)
        img_a = await rbd.open("disk")
        await img_a.write(0, b"A" * 8192)  # lazy acquire
        assert img_a.lock_owned

        c2 = RadosClient(c.bus, name="client.1", device="cpu")
        await c2.connect()
        rbd_b = RBD(c2, 1)
        img_b = await rbd_b.open("disk")
        assert not img_b.lock_owned
        await img_b.write(8192, b"B" * 8192)  # cooperative handover
        assert img_b.lock_owned
        assert not img_a.lock_owned  # holder released on request
        # data from both writers is intact
        assert await img_a.read(0, 8192) == b"A" * 8192
        assert await img_b.read(8192, 8192) == b"B" * 8192
        # and A can take it back the same way
        await img_a.write(0, b"C" * 100)
        assert img_a.lock_owned and not img_b.lock_owned
        await c2.close()
        await c.stop()

    run(t())


def test_exclusive_lock_steal_fences_dead_holder():
    """A holder that never answers the cooperative request is stolen
    from: break_lock + osdmap blocklist. The stale holder's later
    writes bounce EBLOCKLISTED at the OSD (the fence that makes the
    steal safe)."""
    async def t():
        from ceph_tpu_torch.cluster.client import RadosClient

        c, rbd = await make()
        await rbd.create("disk", 64 * 1024, LAYOUT)
        img_a = await rbd.open("disk")
        # "dead" holder: ignores request_lock notifies
        img_a._header_notify = lambda *a: None
        await img_a.write(0, b"A" * 8192)
        assert img_a.lock_owned

        c2 = RadosClient(c.bus, name="client.1", device="cpu")
        await c2.connect()
        img_b = await RBD(c2, 1).open("disk")
        await img_b.acquire_lock(timeout=0.8)
        assert img_b.lock_owned
        assert "client.0" in c2.osdmap.blocklist
        await img_b.write(8192, b"B" * 8192)

        # the fenced holder cannot write anymore — not via rbd, not raw
        with pytest.raises(ConnectionAbortedError):
            await img_a.client.write_full(1, "fenced-probe", b"x")
        # B's view of the image is authoritative
        assert await img_b.read(8192, 8192) == b"B" * 8192
        await c2.close()
        await c.stop()

    run(t())


def test_object_map_fast_diff_and_flatten():
    """The object map tracks which data objects exist under the lock
    (ObjectMap.h role) and prunes flatten/remove sweeps."""
    async def t():
        c, rbd = await make()
        await rbd.create("disk", 10 * 8192, LAYOUT)
        img = await rbd.open("disk")
        await img.write(0, b"x" * 8192)          # object 0
        await img.write(3 * 8192, b"y" * 8192)   # object 3
        m = img.object_map()
        assert m is not None and list(m) == [1, 0, 0, 1] + [0] * 6

        # map survives a release/re-acquire (persisted bitmap)
        await img.release_lock()
        assert img.object_map() is None  # not authoritative unlocked
        await img.write(5 * 8192, b"z" * 100)    # re-acquires
        assert list(img.object_map()) == [1, 0, 0, 1, 0, 1] + [0] * 4

        # clone + flatten: the child's map prunes copy-up stats
        await img.snap_create("s1")
        await rbd.clone("disk", "s1", "child")
        child = await rbd.open("child")
        await child.write(0, b"c" * 100)   # child owns object 0
        await child.flatten()
        assert child.parent is None
        got = await child.read(3 * 8192, 8192)
        assert got == b"y" * 8192  # copied up from parent at flatten
        assert list(child.object_map())[:4] == [1, 0, 0, 1]
        await c.stop()

    run(t())


def test_object_cacher_rbd_write_back_and_fence():
    """ObjectCacher under rbd (ObjectCacher.h role): reads serve from
    cache after one fetch, writes buffer (write-back — nothing lands
    until a flush boundary), and the exclusive-lock release fence
    flushes so the next owner sees everything."""
    async def t():
        c, rbd = await make()
        await rbd.create("disk", 8 * 8192, LAYOUT)
        img = await rbd.open("disk", cache=True)
        await img.write(0, b"A" * 8192)
        # write-back: buffered, not yet on the OSDs
        assert img._cacher.dirty_bytes() == 8192
        assert await img.read(0, 8192) == b"A" * 8192  # served hot
        hits0 = img._cacher.hits
        await img.read(0, 100)
        await img.read(4000, 100)
        assert img._cacher.hits >= hits0 + 2  # no server round trips

        # the lock-release fence flushes; an UNCACHED second handle
        # (fresh client view) reads everything back
        await img.release_lock()
        assert img._cacher.dirty_bytes() == 0
        img2 = await rbd.open("disk")
        assert await img2.read(0, 8192) == b"A" * 8192

        # snapshot boundary flushes buffered writes into the snap
        await img.write(8192, b"B" * 8192)
        await img.snap_create("s")
        await img.write(8192, b"C" * 8192)
        await img.flush()
        snap_view = await rbd.open("disk", snap="s")
        assert await snap_view.read(8192, 8192) == b"B" * 8192
        assert await img.read(8192, 8192) == b"C" * 8192
        await c.stop()

    run(t())


def test_cache_coherent_across_rollback_and_shrink():
    """snap_rollback and shrink mutate objects server-side with the
    RAW client; a cached image must not serve (or later re-flush)
    pre-rollback / past-the-cut bytes."""
    async def t():
        c, rbd = await make()
        await rbd.create("disk", 8 * 8192, LAYOUT)
        img = await rbd.open("disk", cache=True)
        await img.write(0, b"A" * 8192)
        await img.snap_create("s")          # fence: A is in the snap
        assert await img.read(0, 8192) == b"A" * 8192  # cached clean
        await img.write(0, b"B" * 8192)     # buffered dirty
        await img.snap_rollback("s")
        # rollback wins over both the cached clean A-copy and the
        # buffered B write (flushed before the rollback rewrote it)
        assert await img.read(0, 8192) == b"A" * 8192
        img2 = await rbd.open("disk")
        assert await img2.read(0, 8192) == b"A" * 8192

        # shrink: cached bytes past the cut must die with the resize
        await img.write(8192, b"C" * 8192)
        assert await img.read(8192, 8192) == b"C" * 8192
        await img.resize(8192 + 100)
        await img.resize(2 * 8192)
        tail = await img.read(8192, 8192)
        assert tail == b"C" * 100 + b"\x00" * (8192 - 100)
        await c.stop()

    run(t())


def test_deep_copy_with_snapshot_history():
    """deep_copy replays every snapshot level: dst@s == src@s for all
    s, head matches, and a new layout is honored (DeepCopyRequest
    role)."""
    async def t():
        c, rbd = await make()
        await rbd.create("src", 4 * 8192, LAYOUT)
        img = await rbd.open("src")
        await img.write(0, b"v1" * 4096)
        await img.snap_create("s1")
        await img.write(8192, b"v2" * 4096)
        await img.snap_create("s2")
        await img.write(0, b"v3" * 4096)
        await img.release_lock()

        new_layout = FileLayout(stripe_unit=4096, stripe_count=2,
                                object_size=16384)
        await rbd.deep_copy("src", "dst", layout=new_layout)
        dst = await rbd.open("dst")
        assert dst.snaps == ["s1", "s2"]
        assert dst.layout.object_size == 16384
        assert await dst.read(0, 8192) == b"v3" * 4096
        assert await dst.read(8192, 8192) == b"v2" * 4096
        for s, want0, want1 in [("s1", b"v1" * 4096, b"\x00" * 8192),
                                ("s2", b"v1" * 4096, b"v2" * 4096)]:
            view = await rbd.open("dst", snap=s)
            assert await view.read(0, 8192) == want0
            assert await view.read(8192, 8192) == want1
        # the copy is independent of the source
        img2 = await rbd.open("src")
        await img2.write(0, b"XX")
        assert (await dst.read(0, 2)) == b"v3"
        await c.stop()

    run(t())


def test_migration_lifecycle():
    """prepare -> target serves reads/writes with source fallback ->
    execute moves data+snaps -> commit retires the source
    (librbd api/Migration.cc role)."""
    async def t():
        c, rbd = await make()
        await rbd.create("old", 4 * 8192, LAYOUT)
        img = await rbd.open("old")
        await img.write(0, b"A" * 8192)
        await img.snap_create("s")
        await img.write(8192, b"B" * 8192)
        await img.release_lock()

        new_layout = FileLayout(stripe_unit=8192, stripe_count=1,
                                object_size=16384)
        await rbd.migration_prepare("old", "new", layout=new_layout)
        # the source refuses normal opens now
        with pytest.raises(RuntimeError, match="mid-migration"):
            await rbd.open("old")
        # the target serves the source's data before any copy happened
        dst = await rbd.open("new")
        assert await dst.read(0, 8192) == b"A" * 8192
        assert await dst.read(8192, 8192) == b"B" * 8192
        # a write to the target copies up and sticks (into dst object
        # 1 = bytes [16384, 32768), a source hole — so dst object 0
        # stays unowned and its snapshot history replays properly)
        await dst.write(16384 + 100, b"LIVE")
        assert (await dst.read(16384 + 96, 12)
                ) == b"\x00" * 4 + b"LIVE" + b"\x00" * 4
        # commit before execute is refused
        with pytest.raises(RuntimeError, match="not executed"):
            await rbd.migration_commit("new")
        await rbd.migration_execute("new")
        await rbd.migration_commit("new")
        # source is gone; target stands alone with the snap history
        with pytest.raises(ImageNotFound):
            await rbd.open("old")
        dst2 = await rbd.open("new")
        assert dst2.snaps == ["s"]
        assert await dst2.read(0, 8192) == b"A" * 8192
        assert await dst2.read(8192, 8192) == b"B" * 8192
        got = await dst2.read(16384 + 96, 12)
        assert got == b"\x00" * 4 + b"LIVE" + b"\x00" * 4
        snap_view = await rbd.open("new", snap="s")
        # object 0 was never client-written: its history replayed
        # properly — at snap s the B range did not exist yet
        assert await snap_view.read(0, 8192) == b"A" * 8192
        assert await snap_view.read(8192, 8192) == b"\x00" * 8192
        # object 1 was client-written post-prepare: its history
        # collapses onto the written content (documented lite
        # semantics)
        assert (await snap_view.read(16384 + 100, 4)) == b"LIVE"
        await c.stop()

    run(t())


def test_migration_abort_restores_source():
    async def t():
        c, rbd = await make()
        await rbd.create("keep", 2 * 8192, LAYOUT)
        img = await rbd.open("keep")
        await img.write(0, b"K" * 100)
        await img.release_lock()
        await rbd.migration_prepare("keep", "scrapped")
        dst = await rbd.open("scrapped")
        await dst.write(0, b"doomed")
        await rbd.migration_abort("scrapped")
        with pytest.raises(ImageNotFound):
            await rbd.open("scrapped")
        img2 = await rbd.open("keep")  # source serves again, untouched
        assert await img2.read(0, 100) == b"K" * 100
        await c.stop()

    run(t())


def test_wide_striping_flatten_rollback_remove():
    """Regression: _object_count assumed sequential layout; with
    stripe_count > 1 a small image spreads over the whole object SET,
    and flatten/rollback/remove must sweep every object of the set
    (Striper::get_num_objects role)."""
    async def t():
        c, rbd = await make()
        wide = FileLayout(stripe_unit=4096, stripe_count=4,
                          object_size=16384)
        await rbd.create("w", 64 * 1024, wide)
        img = await rbd.open("w")
        rng = np.random.default_rng(9)
        data = rng.integers(0, 256, 50_000, dtype=np.uint8).tobytes()
        await img.write(0, data)
        await img.snap_create("s")
        await img.write(0, b"\x55" * len(data))
        await rbd.clone("w", "s", "wc")
        child = await rbd.open("wc")
        await child.flatten()
        # every object of the set was copied up, not just object 0
        assert await child.read(0, len(data)) == data
        await child.release_lock()
        # rollback sweeps the whole set too
        await img.snap_rollback("s")
        assert await img.read(0, len(data)) == data
        await img.release_lock()
        # remove leaves no stray data objects behind
        await rbd.remove("wc")
        with pytest.raises(ImageNotFound):
            await rbd.open("wc")
        await c.stop()

    run(t())


def test_wide_striping_shrink_keeps_live_data():
    """Regression: shrink used sequential object math and deleted
    mid-set objects holding live striped data."""
    async def t():
        c, rbd = await make()
        wide = FileLayout(stripe_unit=4096, stripe_count=4,
                          object_size=16384)
        await rbd.create("w", 64 * 1024, wide)
        img = await rbd.open("w")
        rng = np.random.default_rng(13)
        data = rng.integers(0, 256, 64 * 1024,
                            dtype=np.uint8).tobytes()
        await img.write(0, data)
        # shrink to 16384: stripe units 0-3 live at offset 0 of
        # objects 0-3 — the old math deleted objects 1..3 outright
        await img.resize(16384)
        assert await img.read(0, 16384) == data[:16384]
        # grow back: the cut range reads as zeros, the kept prefix
        # stays intact
        await img.resize(64 * 1024)
        assert await img.read(0, 16384) == data[:16384]
        assert await img.read(16384, 4096) == b"\x00" * 4096
        await img.release_lock()
        await c.stop()

    run(t())


def test_retained_bytes_matches_extent_enumeration():
    """Property check: the closed-form shrink math equals brute-force
    extent enumeration across randomized layouts."""
    import random

    from ceph_tpu_torch.osdc.striper import file_to_extents
    from ceph_tpu_torch.services.rbd import retained_bytes

    random.seed(7)
    for _ in range(500):
        su = random.choice([512, 4096, 65536])
        sc = random.choice([1, 2, 4, 7])
        upo = random.choice([1, 2, 4, 8])
        lo = FileLayout(stripe_unit=su, stripe_count=sc,
                        object_size=su * upo)
        upto = random.randrange(0, su * upo * sc * 3 + 3)
        want = {}
        if upto:
            for ex in file_to_extents(lo, 0, upto, "o{objectno}"):
                want[ex.objectno] = max(want.get(ex.objectno, 0),
                                        ex.offset + ex.length)
        hi = max(want.keys(), default=-1) + 3
        for objno in range(hi):
            assert retained_bytes(lo, upto, objno) == \
                want.get(objno, 0), (lo, upto, objno)


def test_trash_lifecycle():
    """rbd trash mv/ls/restore/rm/purge: deferred delete with the
    name reserved while trashed (data objects are name-keyed here)."""
    async def t():
        c, rbd = await make()
        await rbd.create("disk", 32 * 1024, LAYOUT)
        img = await rbd.open("disk")
        await img.write(0, b"precious" * 512)
        await img.release_lock()
        tid = await rbd.trash_move("disk", delay_s=3600)
        assert await rbd.list() == []
        ents = await rbd.trash_list()
        assert len(ents) == 1 and ents[0]["name"] == "disk" \
            and ents[0]["id"] == tid
        # the name is reserved while trashed
        with pytest.raises(ImageExists):
            await rbd.create("disk", 1024)
        # inside the deferment window rm refuses without force
        with pytest.raises(RuntimeError):
            await rbd.trash_remove(tid)
        # restore brings the image back intact
        assert await rbd.trash_restore(tid) == "disk"
        img = await rbd.open("disk")
        assert (await img.read(0, 8))[:8] == b"precious"
        await img.release_lock()
        assert await rbd.trash_list() == []
        # trash again and force-remove: data really gone
        tid = await rbd.trash_move("disk")
        await rbd.trash_remove(tid, force=True)
        assert await rbd.list() == []
        assert await rbd.trash_list() == []
        await rbd.create("disk", 1024)  # name free again
        # purge honors deferment
        await rbd.create("short", 4096, LAYOUT)
        await rbd.create("long", 4096, LAYOUT)
        await rbd.trash_move("short")
        await rbd.trash_move("long", delay_s=3600)
        assert await rbd.trash_purge() == ["short"]
        assert [e["name"] for e in await rbd.trash_list()] == ["long"]
        await c.stop()

    run(t())


def test_groups_and_group_snapshots():
    """Consistency groups: membership, the all-member lock barrier on
    group snapshots, and group rollback."""
    async def t():
        c, rbd = await make()
        await rbd.create("a", 16 * 1024, LAYOUT)
        await rbd.create("b", 16 * 1024, LAYOUT)
        await rbd.group_create("g")
        with pytest.raises(ImageExists):
            await rbd.group_create("g")
        assert await rbd.group_list() == ["g"]
        await rbd.group_image_add("g", "a")
        await rbd.group_image_add("g", "b")
        with pytest.raises(ImageExists):  # already in a group
            await rbd.group_image_add("g", "a")
        assert await rbd.group_image_list("g") == ["a", "b"]
        # a grouped image cannot be removed or trashed
        with pytest.raises(RuntimeError):
            await rbd.remove("a")
        with pytest.raises(RuntimeError):
            await rbd.trash_move("a")
        # write state, snap the group, overwrite, roll back
        ia = await rbd.open("a")
        ib = await rbd.open("b")
        await ia.write(0, b"A1" * 100)
        await ib.write(0, b"B1" * 100)
        await ia.release_lock()
        await ib.release_lock()
        await rbd.group_snap_create("g", "s1")
        snaps = await rbd.group_snap_list("g")
        assert snaps[0]["name"] == "s1" \
            and len(snaps[0]["members"]) == 2
        # member images carry the per-image group snap
        ia = await rbd.open("a")
        assert any(s.startswith(".group.g.") for s in ia.snaps)
        await ia.write(0, b"A2" * 100)
        await ia.release_lock()
        await rbd.group_snap_rollback("g", "s1")
        ia = await rbd.open("a")
        assert (await ia.read(0, 4)) == b"A1A1"
        await ia.release_lock()
        # snap removal then group teardown
        await rbd.group_snap_remove("g", "s1")
        assert await rbd.group_snap_list("g") == []
        await rbd.group_remove("g")
        assert await rbd.group_list() == []
        await rbd.remove("a")  # detached: removable again
        await c.stop()

    run(t())
