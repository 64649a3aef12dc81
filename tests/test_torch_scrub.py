"""The cases of ``tests/test_scrub.py`` on the port (``ceph_tpu_torch``),
each cluster on ``device="cpu"`` (the kernels' plain versions), copied
with only their imports and device changed. Two cases of its own close
the file: scrub's device seam (``digest_map(device=True,
torch_device=...)``) against the host engine and the JAX package, and a
host-digest scrub that never resolves a card. The reference's own words
follow.

Scrub + fault-injection tests (the qa/standalone/scrub and
test-erasure-eio.sh roles): digest batching, corrupt-shard detection and
repair, EIO-resilient reconstruct-on-read."""
import asyncio

import numpy as np
import pytest

from ceph_tpu_torch import native
from ceph_tpu_torch.cluster.scrub import digest_map, pick_authoritative
from ceph_tpu_torch.cluster.vstart import TestCluster
from ceph_tpu_torch.placement.osdmap import Pool
from ceph_tpu_torch.store import Transaction
from ceph_tpu_torch.store.memstore import MemStore
from ceph_tpu_torch.utils.fault import FaultInjector
import torch

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)

EC_PROFILE = {"plugin": "rs_tpu", "k": "3", "m": "2"}


def run(coro):
    asyncio.run(asyncio.wait_for(coro, 120))


# ------------------------------------------------------------ units


def test_digest_map_batches_by_size():
    s = MemStore()
    t = Transaction().create_collection("c")
    rng = np.random.default_rng(0)
    blobs = {}
    for i, size in enumerate([100, 100, 100, 256, 0, 256]):
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        oid = b"o%d" % i
        blobs[oid] = data
        t.write("c", oid, 0, data)
    s.apply_transaction(t)
    got = digest_map(s, "c")
    assert set(got) == set(blobs)
    for oid, data in blobs.items():
        want = native.crc32c(np.frombuffer(data, np.uint8)) if data \
            else native.crc32c(None)
        assert got[oid] == (len(data), want), oid


def test_pick_authoritative():
    v1, v2 = (1, 1), (1, 2)
    # newest version wins regardless of count
    key, auth = pick_authoritative({
        (0, -1): (v2, (10, 0xAA)),
        (1, -1): (v1, (10, 0xBB)),
        (2, -1): (v1, (10, 0xBB)),
    })
    assert key == (0, -1) and auth == (v2, (10, 0xAA))
    # same version: majority digest wins
    key, auth = pick_authoritative({
        (0, -1): (v2, (10, 0xAA)),
        (1, -1): (v2, (10, 0xBB)),
        (2, -1): (v2, (10, 0xBB)),
    })
    assert key == (1, -1) and auth == (v2, (10, 0xBB))


def test_fault_injector():
    f = FaultInjector()
    assert not f.hit("x")
    f.arm("x", count=2, oid=b"a")
    assert f.hit("x", oid=b"a")
    assert not f.hit("x", oid=b"b")  # filter mismatch
    assert f.hit("x", oid=b"a")
    assert not f.hit("x", oid=b"a")  # budget exhausted
    assert f.fired("x") == 2
    f.arm("y")
    for _ in range(5):
        assert f.hit("y")
    f.clear()
    assert not f.hit("y")


# ---------------------------------------------------------- clusters


async def make_rep_cluster(n=4):
    c = TestCluster(n_osds=n, device="cpu")
    await c.start()
    await c.client.create_pool(
        Pool(id=1, name="rep", size=3, pg_num=8, crush_rule=0)
    )
    await c.wait_active(20)
    return c


async def make_ec_cluster(n=5):
    c = TestCluster(n_osds=n, device="cpu")
    await c.start()
    await c.client.create_pool(
        Pool(id=2, name="ec", size=5, min_size=3, pg_num=8, crush_rule=1,
             type="erasure", ec_profile=dict(EC_PROFILE))
    )
    await c.wait_active(20)
    return c


def corrupt_object(store, cid: bytes | str, oid: bytes, flip: int = 0):
    """Flip one bit in an object's data behind the store's back (the
    bit-rot simulation of test-erasure-eio.sh corrupt verbs)."""
    obj = store.colls[cid].objects[oid]
    obj.data[flip] ^= 0x01


def test_scrub_clean_replicated():
    async def t():
        c = await make_rep_cluster()
        await c.client.write_full(1, "a", b"A" * 5000)
        await c.client.write_full(1, "b", b"B" * 100)
        pgid = c.client.osdmap.object_to_pg(1, b"a")
        report = await c.scrub_pg(pgid)
        assert report["inconsistent"] == []
        assert report["clean"] >= 1
        await c.stop()

    run(t())


def test_scrub_detects_and_repairs_replica_bitrot():
    async def t():
        c = await make_rep_cluster()
        payload = b"precious" * 1000
        await c.client.write_full(1, "obj", payload)
        pgid = c.client.osdmap.object_to_pg(1, b"obj")
        up, primary = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        victim = next(o for o in up if o != primary)
        cid = f"{pgid[0]}.{pgid[1]}"
        corrupt_object(c.stores[victim], cid, b"obj", flip=17)
        report = await c.scrub_pg(pgid)
        assert b"obj" in report["inconsistent"]
        assert (victim, -1) in report["repaired"]
        # re-scrub: clean now, and the replica's bytes match
        report2 = await c.scrub_pg(pgid)
        assert report2["inconsistent"] == []
        assert bytes(
            c.stores[victim].colls[cid].objects[b"obj"].data
        ) == payload
        await c.stop()

    run(t())


def test_scrub_detects_and_repairs_ec_shard_bitrot():
    async def t():
        c = await make_ec_cluster()
        payload = bytes(range(256)) * 200
        await c.client.write_full(2, "obj", payload)
        pgid = c.client.osdmap.object_to_pg(2, b"obj")
        up, primary = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        victim = next(o for o in up if o != primary)
        shard = up.index(victim)
        cid = f"{pgid[0]}.{pgid[1]}s{shard}"
        corrupt_object(c.stores[victim], cid, b"obj", flip=3)
        report = await c.scrub_pg(pgid)
        assert b"obj" in report["inconsistent"]
        assert (victim, shard) in report["repaired"]
        report2 = await c.scrub_pg(pgid)
        assert report2["inconsistent"] == []
        # the repaired shard decodes with the rest
        assert await c.client.read(2, "obj") == payload
        await c.stop()

    run(t())


def test_ec_read_survives_injected_eio():
    """test-erasure-eio.sh role: EIO on a shard sub-read must not fail
    the client read — the primary reconstructs from survivors."""
    async def t():
        c = await make_ec_cluster()
        payload = b"resilient" * 3000
        await c.client.write_full(2, "obj", payload)
        pgid = c.client.osdmap.object_to_pg(2, b"obj")
        up, primary = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        victim = next(o for o in up if o != primary)
        c.osds[victim].fault.arm("ec_sub_read", oid=b"obj")
        got = await c.client.read(2, "obj")
        assert got == payload
        assert c.osds[victim].fault.fired("ec_sub_read") >= 0
        await c.stop()

    run(t())


def test_ec_read_survives_primary_local_corruption():
    """The primary's own shard fails its hinfo check: the read must
    reconstruct around it instead of erroring."""
    async def t():
        c = await make_ec_cluster()
        payload = b"local-rot" * 2500
        await c.client.write_full(2, "obj", payload)
        pgid = c.client.osdmap.object_to_pg(2, b"obj")
        up, primary = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        shard = up.index(primary)
        cid = f"{pgid[0]}.{pgid[1]}s{shard}"
        corrupt_object(c.stores[primary], cid, b"obj", flip=0)
        assert await c.client.read(2, "obj") == payload
        await c.stop()

    run(t())


def test_ec_read_fails_only_beyond_m_erasures():
    async def t():
        c = await make_ec_cluster()
        payload = b"limit" * 4000
        await c.client.write_full(2, "obj", payload)
        pgid = c.client.osdmap.object_to_pg(2, b"obj")
        up, primary = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        others = [o for o in up if o != primary]
        # m=2: two injected EIOs still decode…
        for v in others[:2]:
            c.osds[v].fault.arm("ec_sub_read", oid=b"obj")
        assert await c.client.read(2, "obj") == payload
        # …a third makes the object unreadable (IOError -> EAGAIN-> give
        # up) but must not wedge the PG
        c.osds[others[2]].fault.arm("ec_sub_read", oid=b"obj")
        with pytest.raises(Exception):
            await asyncio.wait_for(c.client.read(2, "obj"), 30)
        for o in others:
            c.osds[o].fault.clear()
        assert await c.client.read(2, "obj") == payload
        await c.stop()

    run(t())


# ------------------------------------------------ the port's device seam


def _group_store(n: int, size: int):
    s = MemStore()
    t = Transaction().create_collection("c")
    rng = np.random.default_rng(n + size)
    for i in range(n):
        t.write("c", b"o%d" % i, 0,
                rng.integers(0, 256, size, dtype=np.uint8).tobytes())
    s.apply_transaction(t)
    return s


def test_digest_map_device_groups_equal_the_host_and_the_reference():
    """``device=True`` sends a group of >= DEVICE_GROUP_MIN word-aligned
    blobs to the CRC path on ``torch_device`` (here the plain version on
    the CPU): the digests equal the C++ core's and the JAX package's
    (whose device route runs on JAX's CPU)."""
    from ceph_tpu.cluster.scrub import digest_map as jdigest_map
    from ceph_tpu.store.memstore import MemStore as JMemStore
    from ceph_tpu.store import Transaction as JTransaction
    from ceph_tpu_torch.cluster.scrub import DEVICE_GROUP_MIN
    from test_torch_native import jax_library

    jax_library()  # the JAX package's C++ core, once its build is whole
    s = _group_store(DEVICE_GROUP_MIN, 1024)
    host = digest_map(s, "c")
    dev = digest_map(s, "c", device=True, torch_device="cpu")
    assert dev == host
    js = JMemStore()
    t = JTransaction().create_collection("c")
    for oid in s.list_objects("c"):
        t.write("c", oid, 0, s.read("c", oid))
    js.apply_transaction(t)
    assert jdigest_map(js, "c", device=True) == host


def test_digest_map_resolves_its_device_only_for_a_device_group(
        monkeypatch):
    """A scrub on the host engine never resolves a device: with no card
    and none named, ``device=True`` raises only when a group qualifies
    for the device, and a cluster built on ``"cpu"`` stays there."""
    from ceph_tpu_torch.cluster.scrub import DEVICE_GROUP_MIN

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    small = _group_store(4, 1024)
    assert digest_map(small, "c", device=True) == digest_map(small, "c")
    big = _group_store(DEVICE_GROUP_MIN, 1024)
    with pytest.raises(RuntimeError, match="CUDA"):
        digest_map(big, "c", device=True)
    assert digest_map(big, "c", device=True, torch_device="cpu") == \
        digest_map(big, "c")

    async def t():
        c = TestCluster(n_osds=3, device="cpu")
        await c.start()
        await c.client.create_pool(
            Pool(id=1, name="rep", size=3, pg_num=4, crush_rule=0))
        await c.wait_active(20)
        await c.client.write_full(1, "a", b"A" * 4096)
        pgid = c.client.osdmap.object_to_pg(1, b"a")
        report = await c.scrub_pg(pgid)
        assert report["inconsistent"] == [] and report["clean"] >= 1
        assert all(o.device == torch.device("cpu") for o in c.osds)
        await c.stop()

    run(t())
