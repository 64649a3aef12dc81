"""The cases of ``tests/test_mirror.py`` on the port (``ceph_tpu_torch``),
each cluster on ``device="cpu"`` (the kernels' plain versions), copied
with only their imports and device changed; the reference's bounds
stay as they are. The reference's own words follow.

rbd-mirror-lite: journaled images + cross-cluster async replication
(the src/journal + rbd_mirror roles). Two independent in-process
clusters; the daemon replays the primary's image journals onto the
secondary and survives trims, incremental syncs, and the promote
split-brain guard."""
import asyncio
import os

import pytest

from ceph_tpu_torch.cluster import TestCluster
from ceph_tpu_torch.placement.osdmap import Pool
from ceph_tpu_torch.services import mirror as mir
from ceph_tpu_torch.services.rbd import RBD
import torch

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)


def run(coro):
    asyncio.run(asyncio.wait_for(coro, 120))


async def make_site(pool_id=1):
    c = TestCluster(n_osds=4, device="cpu")
    await c.start()
    await c.client.create_pool(
        Pool(id=pool_id, name="rbd", size=3, pg_num=8, crush_rule=0))
    await c.wait_active(20)
    return c


def test_journal_append_read_trim():
    async def t():
        a = await make_site()
        rbd = RBD(a.client, 1)
        await rbd.create("img", 1 << 22)
        img = await mir.journaled(a.client, 1, "img")
        await img.write(0, b"abc" * 1000)
        await img.write(8192, b"xyz")
        entries = await img.journal_read(0)
        assert [e[1][0] for e in entries] == [mir.E_WRITE, mir.E_WRITE]
        assert entries[0][1][3] == b"abc" * 1000
        # trim the first entry; positions stay logical
        first_end = entries[0][0]
        await img.journal_trim(first_end)
        tail = await img.journal_read(first_end)
        assert len(tail) == 1 and tail[0][1][3] == b"xyz"
        assert await img.journal_tail() == entries[1][0]
        await a.stop()

    run(t())


def test_mirror_replicates_and_stays_incremental():
    async def t():
        a = await make_site()
        b = await make_site()
        rbd_a = RBD(a.client, 1)
        await rbd_a.create("vol", 1 << 22)
        img = await mir.journaled(a.client, 1, "vol")
        data1 = os.urandom(10000)
        await img.write(5000, data1)

        d = mir.MirrorDaemon(a.client, 1, b.client, 1)
        # bootstrap copies the head as of the journal tail: the pre-sync
        # write arrives via the copy, not replay
        assert await d.sync_image("vol") == 0
        dst = await RBD(b.client, 1).open("vol")
        assert await dst.read(5000, 10000) == data1
        assert dst.size == 1 << 22

        # incremental: only NEW entries replay (journal was trimmed)
        data2 = os.urandom(3000)
        await img.write(0, data2)
        await img.discard(5000, 8192)
        await img.resize(1 << 21)
        assert await d.sync_image("vol") == 3
        dst = await RBD(b.client, 1).open("vol")
        assert await dst.read(0, 3000) == data2
        assert await dst.read(5000, 100) == b"\x00" * 100
        assert dst.size == 1 << 21
        assert await d.sync_image("vol") == 0  # caught up
        await a.stop()
        await b.stop()

    run(t())


def test_mirror_snapshots_and_daemon_loop():
    async def t():
        a = await make_site()
        b = await make_site()
        rbd_a = RBD(a.client, 1)
        await rbd_a.create("snapvol", 1 << 20)
        img = await mir.journaled(a.client, 1, "snapvol")
        await img.write(0, b"v1" * 500)
        await img.snap_create("s1")
        await img.write(0, b"v2" * 500)

        d = mir.MirrorDaemon(a.client, 1, b.client, 1,
                             poll_interval=0.05)
        await d.start()
        for _ in range(100):  # wait until the loop catches up
            try:
                dst = await RBD(b.client, 1).open("snapvol")
                if (await dst.read(0, 1000) == b"v2" * 500
                        and "s1" in await dst.snap_list()):
                    break
            except Exception:
                pass
            await asyncio.sleep(0.05)
        await d.stop()
        dst = await RBD(b.client, 1).open("snapvol")
        assert await dst.read(0, 1000) == b"v2" * 500
        snap_view = await RBD(b.client, 1).open("snapvol", snap="s1")
        assert await snap_view.read(0, 1000) == b"v1" * 500
        await a.stop()
        await b.stop()

    run(t())


def test_promote_guard_blocks_split_brain():
    async def t():
        a = await make_site()
        b = await make_site()
        await RBD(a.client, 1).create("guard", 1 << 20)
        img = await mir.journaled(a.client, 1, "guard")
        await img.write(0, b"x" * 100)
        d = mir.MirrorDaemon(a.client, 1, b.client, 1)
        await d.sync_image("guard")
        # failover: promote the secondary; further replay must refuse
        await mir.promote(b.client, 1, "guard")
        await img.write(200, b"y" * 100)
        with pytest.raises(IOError, match="promoted"):
            await d.sync_image("guard")
        # demote re-enables replication
        await mir.demote(b.client, 1, "guard")
        assert await d.sync_image("guard") == 1
        dst = await RBD(b.client, 1).open("guard")
        assert await dst.read(200, 100) == b"y" * 100
        await a.stop()
        await b.stop()

    run(t())


def test_rejected_write_leaves_no_journal_entry():
    """A past-end write must fail BEFORE journaling, or the secondary
    would replay a phantom mutation the primary never applied."""
    async def t():
        a = await make_site()
        await RBD(a.client, 1).create("small", 4096)
        img = await mir.journaled(a.client, 1, "small")
        with pytest.raises(IOError, match="past end"):
            await img.write(4096, b"x" * 100)
        assert await img.journal_read(0) == []
        await a.stop()

    run(t())


def test_bootstrap_replicates_snapshot_history():
    """Bootstrap of an absent secondary must reproduce each snapshot's
    OWN content (oldest-first), not stamp snapshots onto the current
    head — and must not replay pre-bootstrap journal entries."""
    async def t():
        a = await make_site()
        b = await make_site()
        await RBD(a.client, 1).create("hist", 1 << 20)
        img = await mir.journaled(a.client, 1, "hist")
        await img.write(0, b"A" * 4096)
        await img.snap_create("s1")
        await img.write(8192, b"B" * 4096)  # post-s1 data
        await img.write(0, b"\x00" * 4096)  # zeroed since s1
        d = mir.MirrorDaemon(a.client, 1, b.client, 1)
        await d.sync_image("hist")
        sview = await RBD(b.client, 1).open("hist", snap="s1")
        assert await sview.read(0, 4096) == b"A" * 4096
        assert await sview.read(8192, 4096) == b"\x00" * 4096  # no B!
        head = await RBD(b.client, 1).open("hist")
        assert await head.read(8192, 4096) == b"B" * 4096
        assert await head.read(0, 4096) == b"\x00" * 4096
        await a.stop()
        await b.stop()

    run(t())


def test_cls_journal_trim_atomicity_semantics():
    """journal.trim runs server-side (atomic with appends): trimming to
    a mid-journal offset keeps later records; past-tail trim errors."""
    async def t():
        a = await make_site()
        await RBD(a.client, 1).create("jt", 1 << 20)
        img = await mir.journaled(a.client, 1, "jt")
        await img.write(0, b"one")
        await img.write(100, b"two")
        entries = await img.journal_read(0)
        await img.journal_trim(entries[0][0])
        left = await img.journal_read(entries[0][0])
        assert [e[1][3] for e in left] == [b"two"]
        with pytest.raises(IOError):
            await img.journal_trim(entries[1][0] + 999)
        # records appended AFTER a trim parse cleanly from the position
        await img.write(200, b"three")
        tail = await img.journal_read(entries[0][0])
        assert [e[1][3] for e in tail] == [b"two", b"three"]
        await a.stop()

    run(t())


def test_bootstrap_existing_image():
    """An image with pre-journal history bootstraps via full copy, then
    journal entries replay on top."""
    async def t():
        a = await make_site()
        b = await make_site()
        rbd_a = RBD(a.client, 1)
        await rbd_a.create("boot", 1 << 21)
        plain = await rbd_a.open("boot")
        old = os.urandom(7000)
        await plain.write(100_000, old)  # unjournaled history
        img = await mir.journaled(a.client, 1, "boot")
        new = os.urandom(500)
        await img.write(0, new)
        d = mir.MirrorDaemon(a.client, 1, b.client, 1)
        await d.sync_image("boot")
        dst = await RBD(b.client, 1).open("boot")
        assert await dst.read(100_000, 7000) == old
        assert await dst.read(0, 500) == new
        await a.stop()
        await b.stop()

    run(t())
