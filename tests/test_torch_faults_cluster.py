"""The cluster cases of ``tests/test_faults.py`` on the port
(``ceph_tpu_torch``): every case that builds a cluster or reads the PG
or the client, the mon-quorum case among them and the chip-loss thrash
over the multi-device data plane (a virtual mesh of 8 CPU slots,
``pin_virtual(8)``), each cluster on ``device="cpu"`` (the kernels'
plain versions). The reference's cases
are copied with only their imports and device changed. Tolerance: exact,
as in the reference.
"""
import asyncio

import numpy as np
import pytest
import torch

from ceph_tpu_torch.cluster import TestCluster
from ceph_tpu_torch.cluster.faults import Thrasher, build_schedule
from ceph_tpu_torch.cluster.pg import PG, UNFOUND_GRACE
from ceph_tpu_torch.placement.osdmap import Pool
from ceph_tpu_torch.store import transaction as tx

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)


EC_PROFILE = {"plugin": "rs_tpu", "k": "3", "m": "2", "backend": "device"}


#: repair-economics codec arms: the same seeded thrash (bitrot on
#: reads + flaps) exercises each codec family's CRC verify-on-read +
#: async repair path through the batched decode pipeline
THRASH_PROFILES = {
    "rs": EC_PROFILE,
    "clay": {"plugin": "clay", "k": "3", "m": "2",
             "backend": "device", "stripe_unit": "4096"},
    "blaum_roth": {"plugin": "bitmatrix", "technique": "blaum_roth",
                   "k": "3", "m": "2", "backend": "device",
                   "stripe_unit": "4096"},
}


def run(coro, timeout=180):
    asyncio.run(asyncio.wait_for(coro, timeout))


async def make_ec_cluster(n=5, seed=0, pg_num=8, profile=None):
    c = TestCluster(n_osds=n, fault_seed=seed, device="cpu")
    await c.start()
    await c.client.create_pool(
        Pool(id=2, name="ec", size=5, min_size=3, pg_num=pg_num,
             crush_rule=1, type="erasure",
             ec_profile=dict(profile or EC_PROFILE))
    )
    await c.wait_active(20)
    return c


def test_blackhole_compat_view():
    """LocalBus.blackholes is now a view over the policy — the
    historical test verb keeps working verbatim."""
    c = TestCluster(n_osds=3, device="cpu")
    c.bus.blackholes.add("osd.1")
    assert c.faults.net.plan("osd.0", "osd.1") is None
    c.bus.blackholes.discard("osd.1")
    assert c.faults.net.plan("osd.0", "osd.1") == [0.0]


def test_partition_heal_cluster_converges():
    """Isolate a PG's primary from everyone mid-workload: the mon
    marks it down, the interval moves on, ops complete; heal + revive
    and the cluster returns to clean with byte-exact reads."""
    async def t():
        c = await make_ec_cluster(seed=3)
        c.client.op_timeout = 60.0
        data = b"partition-me" * 512
        await c.client.write_full(2, "obj", data)
        pgid = c.client.osdmap.object_to_pg(2, b"obj")
        _, primary = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        c.faults.net.partition({f"osd.{primary}"}, {"*"})
        await c.wait_down(primary, 20)
        data2 = b"post-partition" * 500
        await c.client.write_full(2, "obj", data2)  # re-peered interval
        assert await c.client.read(2, "obj") == data2
        c.faults.net.heal()
        await c.wait_active(40)
        assert await c.client.read(2, "obj") == data2
        await c.stop()

    run(t())


def test_duplicate_delivery_idempotent():
    """Duplicate EVERY client->OSD message: the PG's reqid dedup must
    keep non-idempotent verbs exactly-once."""
    async def t():
        c = TestCluster(n_osds=4, fault_seed=1, device="cpu")
        await c.start()
        await c.client.create_pool(
            Pool(id=1, name="rep", size=3, pg_num=8, crush_rule=0))
        await c.wait_active(20)
        c.faults.net.set_link("client.0", "*", dup=1.0)
        await c.client.write_full(1, "obj", b"base-")
        for i in range(6):
            await c.client.append(1, "obj", b"x%d" % i)
        await c.bus.drain()
        got = await c.client.read(1, "obj")
        assert got == b"base-" + b"".join(b"x%d" % i for i in range(6))
        assert c.faults.net.counters.get("dup", 0) >= 7
        await c.stop()

    run(t())


def test_injected_eio_excludes_shard_and_read_succeeds():
    """The original fault sites still compose with the plane: injected
    sub-read EIO on one member leaves the read bit-exact (reconstructed
    from survivors) and shows up in faults_injected_*."""
    async def t():
        c = await make_ec_cluster(seed=5)
        data = np.random.default_rng(9).integers(
            0, 256, 3 * 4096 * 2, dtype=np.uint8).tobytes()
        await c.client.write_full(2, "obj", data)
        pgid = c.client.osdmap.object_to_pg(2, b"obj")
        up, primary = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        victim = next(o for o in up if o != primary)
        c.osds[victim].fault.arm("ec_sub_read", oid=b"obj")
        assert await c.client.read(2, "obj") == data
        assert c.osds[victim].fault.fired("ec_sub_read") >= 1
        assert c.faults.injected().get("ec_sub_read", 0) >= 1
        d = c.osds[victim].perf.dump()
        assert d.get("faults_injected_ec_sub_read", 0) >= 1
        await c.stop()

    run(t())


def _doctor_stale(store, cid, oid, saved):
    """Reinstall a saved (data, attrs) shard state — the on-disk shape
    of a revived stale member whose recovery was missed."""
    data, attrs = saved
    t = tx.Transaction()
    t.truncate(cid, oid, 0)
    t.write(cid, oid, 0, data)
    t.rmattrs(cid, oid)
    t.setattrs(cid, oid, dict(attrs))
    store.queue_transaction(t)


def test_stale_shard_read_version_crosscheck():
    """THE ROADMAP wrong-bytes gap, reproduced deterministically: two
    data shards carry a self-consistent STALE generation (valid against
    their own stale hinfo). On the seed read path (version check off)
    the read mixes generations and returns wrong bytes; with the
    ATTR_V cross-check the laggards are excluded like hinfo failures
    and the read decodes correct bytes from the surviving quorum."""
    async def t():
        c = await make_ec_cluster(seed=2)
        rng = np.random.default_rng(17)
        v1 = rng.integers(0, 256, 3 * 4096 * 2, dtype=np.uint8).tobytes()
        await c.client.write_full(2, "obj", v1)
        pgid = c.client.osdmap.object_to_pg(2, b"obj")
        up, primary = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        # two non-primary DATA shards (positions < k): the ones a
        # default fetch plan actually reads
        victims = [(s, o) for s, o in enumerate(up[:3]) if o != primary]
        assert len(victims) >= 2
        victims = victims[:2]
        saved = {}
        for s, o in victims:
            cid = f"{pgid[0]}.{pgid[1]}s{s}"
            saved[s] = (bytes(c.stores[o].read(cid, b"obj")),
                        dict(c.stores[o].getattrs(cid, b"obj")))
        # shrinking rewrite, all members healthy
        v2 = rng.integers(0, 256, 3 * 4096, dtype=np.uint8).tobytes()
        await c.client.write_full(2, "obj", v2)
        # re-plant the stale generation on the two victims
        for s, o in victims:
            cid = f"{pgid[0]}.{pgid[1]}s{s}"
            _doctor_stale(c.stores[o], cid, b"obj", saved[s])

        # seed read path: trusts per-shard hinfo only -> mixes stale
        # and new cells -> wrong bytes (or a reconstruct error)
        PG._ec_version_check = False
        try:
            try:
                got = await c.client.read(2, "obj")
                assert got != v2, "seed read path should serve rot here"
            except (IOError, KeyError):
                pass  # "cannot reconstruct" is the other seed symptom
        finally:
            PG._ec_version_check = True

        # hardened path: version-lagging shards excluded, bytes exact
        assert await c.client.read(2, "obj") == v2
        prim = c.osds[primary]
        assert prim.perf.dump().get("ec_read_stale_shard", 0) >= 1
        await c.stop()

    run(t())


def test_stale_primary_size_ranged_read_probes():
    """The primary itself can be the revived stale shard: a ranged read
    planned past its stale (smaller) ATTR_SIZE must not short-circuit
    to empty — it probes a cell, learns the authoritative size from the
    fresh quorum, and re-plans."""
    async def t():
        c = await make_ec_cluster(seed=15)
        rng = np.random.default_rng(77)
        v1 = rng.integers(0, 256, 3 * 4096, dtype=np.uint8).tobytes()
        await c.client.write_full(2, "obj", v1)
        pgid = c.client.osdmap.object_to_pg(2, b"obj")
        up, primary = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        ppos = up.index(primary)
        cid = f"{pgid[0]}.{pgid[1]}s{ppos}"
        saved = (bytes(c.stores[primary].read(cid, b"obj")),
                 dict(c.stores[primary].getattrs(cid, b"obj")))
        v2 = rng.integers(0, 256, 3 * 4096 * 2, dtype=np.uint8).tobytes()
        await c.client.write_full(2, "obj", v2)  # GREW the object
        _doctor_stale(c.stores[primary], cid, b"obj", saved)
        # offset beyond the stale size, inside the real object
        off = len(v1) + 512
        got = await c.client.read(2, "obj", offset=off, length=1000)
        assert got == v2[off:off + 1000]
        assert await c.client.read(2, "obj") == v2
        await c.stop()

    run(t())


def test_past_eof_probe_cached_on_healthy_path():
    """The past-EOF quorum probe runs ONCE per (oid, local version):
    after a probe confirms the primary's size attr against the quorum,
    later past-EOF reads short-circuit locally — proven by cutting the
    primary off from every other OSD and reading past EOF again."""
    async def t():
        c = await make_ec_cluster(seed=17)
        data = b"z" * (3 * 4096)
        await c.client.write_full(2, "obj", data)
        # first past-EOF read: probes the quorum, caches the verdict
        assert await c.client.read(2, "obj", offset=len(data) + 100,
                                   length=50) == b""
        pgid = c.client.osdmap.object_to_pg(2, b"obj")
        _, primary = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        # cut the primary off from all OTHER OSDs (client + mon still
        # reach it, so the op arrives and the osdmap holds still): a
        # re-probe would stall on dead sub-reads — the cache must not
        others = {f"osd.{o}" for o in range(5) if o != primary}
        c.faults.net.partition({f"osd.{primary}"}, others)
        got = await asyncio.wait_for(
            c.client.read(2, "obj", offset=len(data) + 100, length=50),
            timeout=5)
        assert got == b""
        c.faults.net.heal()
        await c.stop()

    run(t())


def test_interrupted_fanout_falls_back_to_decodable_generation():
    """A write fan-out that died mid-flight leaves a MINORITY of shards
    one generation ahead (< k members — never ack-able). The version
    cross-check must not brick the read: it falls back to the newest
    generation with >= k members and serves IT consistently (never a
    mix, never 'cannot reconstruct')."""
    async def t():
        c = await make_ec_cluster(seed=14)
        rng = np.random.default_rng(55)
        v1 = rng.integers(0, 256, 3 * 4096, dtype=np.uint8).tobytes()
        await c.client.write_full(2, "obj", v1)
        pgid = c.client.osdmap.object_to_pg(2, b"obj")
        up, _primary = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        # snapshot gen-N state of a MAJORITY (3 shards)
        saved = {}
        for s in range(3):
            cid = f"{pgid[0]}.{pgid[1]}s{s}"
            saved[s] = (bytes(c.stores[up[s]].read(cid, b"obj")),
                        dict(c.stores[up[s]].getattrs(cid, b"obj")))
        v2 = rng.integers(0, 256, 3 * 4096, dtype=np.uint8).tobytes()
        await c.client.write_full(2, "obj", v2)
        # re-plant gen N on the majority: now only 2 shards carry the
        # newer generation — exactly the dead-mid-fanout shape
        for s in range(3):
            cid = f"{pgid[0]}.{pgid[1]}s{s}"
            _doctor_stale(c.stores[up[s]], cid, b"obj", saved[s])
        got = await c.client.read(2, "obj")
        assert got == v1, "fallback must serve the decodable gen whole"
        await c.stop()

    run(t())


def test_interrupted_shrinking_fanout_refetches_wider():
    """An interrupted SHRINKING fan-out: the < k ahead generation is
    smaller than the decodable gen-N fallback, so the read is planned
    on the small size, version-demotes the gen-N majority, falls back
    to it, learns the larger authoritative size, and must refetch
    WIDER — the demoted shards must rejoin that replan (leaving them
    in the failed set would strand the only decodable generation and
    brick the read with 'cannot reconstruct')."""
    async def t():
        c = await make_ec_cluster(seed=16)
        rng = np.random.default_rng(91)
        # gen N: two stripes; gen N+1 (interrupted): one stripe
        v1 = rng.integers(0, 256, 3 * 4096 * 2, dtype=np.uint8).tobytes()
        await c.client.write_full(2, "obj", v1)
        pgid = c.client.osdmap.object_to_pg(2, b"obj")
        up, primary = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        ppos = up.index(primary)
        # keep the primary's shard AND one shard from the other class
        # (data if the primary holds parity, parity otherwise) on the
        # ahead generation, so the first fetch plan sees a version mix
        other = 0 if ppos >= 3 else 3
        doctored = [s for s in range(5) if s not in (ppos, other)][:3]
        saved = {}
        for s in doctored:
            cid = f"{pgid[0]}.{pgid[1]}s{s}"
            saved[s] = (bytes(c.stores[up[s]].read(cid, b"obj")),
                        dict(c.stores[up[s]].getattrs(cid, b"obj")))
        v2 = rng.integers(0, 256, 3 * 4096, dtype=np.uint8).tobytes()
        await c.client.write_full(2, "obj", v2)  # shrinks the object
        for s in doctored:
            cid = f"{pgid[0]}.{pgid[1]}s{s}"
            _doctor_stale(c.stores[up[s]], cid, b"obj", saved[s])
        got = await c.client.read(2, "obj")
        assert got == v1, "wider replan must serve gen N byte-exact"
        await c.stop()

    run(t())


def test_kill_two_degraded_write_revive_both():
    """The integration shape of the same gap (ROADMAP open item): kill
    TWO members of a k=3,m=2 PG, do a shrinking degraded write, revive
    both — every subsequent read must return the new bytes, including
    reads forced through the revived shards."""
    async def t():
        c = await make_ec_cluster(seed=4)
        rng = np.random.default_rng(21)
        v1 = rng.integers(0, 256, 3 * 4096 * 2, dtype=np.uint8).tobytes()
        await c.client.write_full(2, "obj", v1)
        pgid = c.client.osdmap.object_to_pg(2, b"obj")
        up, primary = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        victims = [o for o in up if o != primary][:2]
        for v in victims:
            await c.kill_osd(v)
            await c.wait_down(v, 20)
        v2 = rng.integers(0, 256, 3 * 4096, dtype=np.uint8).tobytes()
        await c.client.write_full(2, "obj", v2)  # k shards exactly
        for v in victims:
            await c.revive_osd(v)
        await c.wait_active(40)
        assert await c.client.read(2, "obj") == v2
        # force the revived shards into the decode set: kill two OTHERS
        up2, primary2 = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        others = [o for o in up2 if o not in victims][:2]
        for o in others:
            await c.kill_osd(o)
            await c.wait_down(o, 20)
        assert await c.client.read(2, "obj") == v2
        await c.stop()

    run(t())


def test_converged_head_never_fabricates_ack():
    """Acked-write-loss regression (thrash-found): a write whose cells
    reached < k shards bounces; peering then skips it as unfound and
    CONVERGES every member's log head over the gap. Heads now claim a
    generation no quorum can decode — and after a primary flap wipes
    the in-memory phantom blacklist, the seed's reply-cache rebuild
    read those converged heads as content-coverage and fabricated an
    OK for the still-resending client: the write "succeeded" yet reads
    serve the OLD generation forever. The persistent missing-set must
    keep the gap on record across the flap, so the resend re-executes
    for real and the new bytes land on all shards."""
    async def t():
        c = await make_ec_cluster(seed=11)
        c.client.op_timeout = 120.0
        rng = np.random.default_rng(77)
        p1 = rng.integers(0, 256, 3 * 4096 * 2, dtype=np.uint8).tobytes()
        await c.client.write_full(2, "obj", p1)
        pgid = c.client.osdmap.object_to_pg(2, b"obj")
        up, primary = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        others = [o for o in up if o != primary]
        cut, dead = others[0], others[1:3]
        # cut one member at the wire (still "up" in the map), kill two:
        # the gen-2 fanout applies on at most primary + one peer (< k),
        # gathers no full ack, and bounces EAGAIN to the client
        c.faults.net.set_link(f"osd.{cut}", "*", drop=1.0)
        c.faults.net.set_link("*", f"osd.{cut}", drop=1.0)
        for o in dead:
            await c.kill_osd(o)
        p2 = rng.integers(0, 256, 3 * 4096, dtype=np.uint8).tobytes()
        wtask = asyncio.create_task(c.client.write_full(2, "obj", p2))
        await asyncio.sleep(2.0)
        assert not wtask.done()  # still bouncing: no quorum for gen-2
        # silence the client so its resend cannot land before the flap
        c.faults.net.set_link("client.0", "*", drop=1.0)
        c.faults.net.set_link("*", "client.0", drop=1.0)
        # heal the member cut and revive the dead: peering pushes the
        # orphan gen-2 (2 members < k), fails, waits out UNFOUND_GRACE,
        # then converges every head over the recorded gap
        c.faults.net.clear_link(f"osd.{cut}", "*")
        c.faults.net.clear_link("*", f"osd.{cut}")
        for o in dead:
            await c.revive_osd(o)
        # generous: peering must wait out UNFOUND_GRACE retry rounds
        # before it converges, and full-suite load stretches each round
        await c.wait_active(150)
        await asyncio.sleep(UNFOUND_GRACE + 4.0)
        # flap the primary: its in-memory phantom blacklist dies; only
        # the PERSISTENT missing set still marks the gap
        await c.kill_osd(primary)
        await c.wait_down(primary, 20)
        await c.revive_osd(primary)
        await c.wait_active(150)
        # un-silence the client: the pending resend must RE-EXECUTE
        # (not be acked from a fabricated cache entry) and land gen-2
        # on every live shard
        c.faults.net.clear_link("client.0", "*")
        c.faults.net.clear_link("*", "client.0")
        await asyncio.wait_for(wtask, 90)
        assert await c.client.read(2, "obj") == p2
        report = await c.scrub_pg(pgid)
        report = await c.scrub_pg(pgid)
        assert report["inconsistent"] == [], report
        assert await c.client.read(2, "obj") == p2
        await c.stop()

    run(t(), timeout=600)


def test_bitrot_caught_counted_and_repaired():
    """osd_ec_verify_on_read (default on): a flipped bit fails hinfo,
    the shard is excluded (read still byte-exact), ec_read_crc_err
    counts it, and a read-triggered repair reinstalls the shard so a
    later scrub finds nothing."""
    async def t():
        c = await make_ec_cluster(seed=6)
        data = np.random.default_rng(33).integers(
            0, 256, 3 * 4096 * 2, dtype=np.uint8).tobytes()
        await c.client.write_full(2, "obj", data)
        pgid = c.client.osdmap.object_to_pg(2, b"obj")
        up, primary = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        victim = next(o for o in up if o != primary)
        c.osds[victim].fault.arm("ec_read_bitflip", count=1, oid=b"obj")
        assert await c.client.read(2, "obj") == data
        crc = sum(o.perf.dump().get("ec_read_crc_err", 0)
                  for o in c.osds if o is not None)
        assert crc >= 1

        async def repaired():
            while not any(o.perf.dump().get("ec_read_repairs", 0)
                          for o in c.osds if o is not None):
                await asyncio.sleep(0.02)
        await asyncio.wait_for(repaired(), 20)
        report = await c.scrub_pg(pgid)
        assert report["inconsistent"] == [], report
        await c.stop()

    run(t())


def test_verify_on_read_off_serves_rot():
    """The knob's contrapositive: with osd_ec_verify_on_read=false a
    flipped bit sails through the normal read path — which is exactly
    why the verification defaults on."""
    async def t():
        c = TestCluster(n_osds=5, fault_seed=8,
                        osd_conf={"osd_ec_verify_on_read": False},
                        device="cpu")
        await c.start()
        await c.client.create_pool(
            Pool(id=2, name="ec", size=5, min_size=3, pg_num=8,
                 crush_rule=1, type="erasure",
                 ec_profile=dict(EC_PROFILE)))
        await c.wait_active(20)
        data = np.random.default_rng(3).integers(
            0, 256, 3 * 4096, dtype=np.uint8).tobytes()
        await c.client.write_full(2, "obj", data)
        pgid = c.client.osdmap.object_to_pg(2, b"obj")
        up, primary = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        # rot a DATA shard (position < k) so the flip lands in the
        # returned logical bytes, not a parity cell
        s, o = next((s, o) for s, o in enumerate(up[:3])
                    if o != primary)
        c.osds[o].fault.arm("ec_read_bitflip", count=1, oid=b"obj")
        got = await c.client.read(2, "obj")
        assert got != data and len(got) == len(data)
        await c.stop()

    run(t())


def test_torn_write_detected_by_scrub():
    """A torn shard write (prefix of the transaction persisted) leaves
    the shard divergent; scrub detects and repairs it, and reads stay
    correct throughout (the write itself still all-acked because the
    tear is on-disk state, not the ack path)."""
    async def t():
        c = await make_ec_cluster(seed=9)
        data = np.random.default_rng(41).integers(
            0, 256, 3 * 4096 * 2, dtype=np.uint8).tobytes()
        await c.client.write_full(2, "seed-obj", data)  # PG exists now
        pgid = c.client.osdmap.object_to_pg(2, b"torn")
        up, primary = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        victim = next(o for o in up if o != primary)
        c.osds[victim].fault.arm("torn_write", count=1, oid=b"torn")
        await c.client.write_full(2, "torn", data)
        assert await c.client.read(2, "torn") == data
        report = await c.scrub_pg(pgid)
        if c.osds[victim].fault.fired("torn_write"):
            assert b"torn" in report["inconsistent"], report
        report2 = await c.scrub_pg(pgid)
        assert report2["inconsistent"] == [], report2
        assert await c.client.read(2, "torn") == data
        await c.stop()

    run(t())


def test_ec_batcher_fails_closed_per_op():
    """An injected dispatch error fails ONLY the op whose stripes still
    fail alone: batch-mates recover via isolation, the queue keeps
    flowing, and the failure counters split by cause."""
    from ceph_tpu_torch.cluster.ecbatch import ECBatcher
    from ceph_tpu_torch.ec import load_codec
    from ceph_tpu_torch.utils.fault import FaultInjector
    from ceph_tpu_torch.utils.perf import PerfCounters

    codec = load_codec({"plugin": "rs_tpu", "k": "3", "m": "2",
                        "backend": "host"}, device="cpu")
    perf = PerfCounters("t")
    ECBatcher.declare_counters(perf)
    fault = FaultInjector()
    fault.arm("ec_batch", count=2)  # batch dispatch + first retry

    def cells(seed):
        return np.random.default_rng(seed).integers(
            0, 256, (1, 3, 256), dtype=np.uint8)

    async def t():
        b = ECBatcher(perf, fault=fault)
        waits = [asyncio.ensure_future(b.encode_cells(codec, cells(i)))
                 for i in range(3)]
        results = await asyncio.gather(*waits, return_exceptions=True)
        failures = [r for r in results if isinstance(r, RuntimeError)]
        ok = [r for r in results if not isinstance(r, BaseException)]
        assert len(failures) == 1 and len(ok) == 2
        for parity, _crcs in ok:
            assert parity.shape == (1, 2, 256)
        # the bucket is not wedged: later work flows
        parity, _ = await b.encode_cells(codec, cells(99))
        assert parity.shape == (1, 2, 256)

    run(t())
    d = perf.dump()
    assert d["ec_batch_failures"] == 1
    assert d["ec_batch_failures_injected"] == 1
    assert d["ec_batch_failures_dispatch"] == 0
    assert d["ec_batch_isolated"] == 2


def test_ec_batcher_failure_release_is_single_shot():
    """The failure path must release the bucket exactly once: a fresh
    batch that starts while the failed batch's isolation retries are
    still grinding owns the in-flight marker — a second (finally-path)
    discard after the retries would let a third concurrent dispatch
    launch for the same bucket and break the double-buffer invariant."""
    from ceph_tpu_torch.cluster.ecbatch import ECBatcher
    from ceph_tpu_torch.ec import load_codec
    from ceph_tpu_torch.utils.fault import InjectedError
    from ceph_tpu_torch.utils.perf import PerfCounters

    codec = load_codec({"plugin": "rs_tpu", "k": "3", "m": "2",
                        "backend": "host"}, device="cpu")
    perf = PerfCounters("t")
    ECBatcher.declare_counters(perf)

    def cells(seed):
        return np.random.default_rng(seed).integers(
            0, 256, (1, 3, 256), dtype=np.uint8)

    async def t():
        b = ECBatcher(perf)
        seen = {}
        fail_gate = asyncio.Event()   # holds B1's failure path open
        b2_entered = asyncio.Event()
        b2_gate = asyncio.Event()     # holds B2 mid-dispatch
        state = {"calls": 0}
        real_disp = b._dispatch_once
        real_fail = b._fail_closed

        async def disp(loop, key, codec_, cells_):
            seen.setdefault("key", key)
            state["calls"] += 1
            if state["calls"] == 1:
                raise InjectedError("injected batch failure")
            if state["calls"] == 2:
                b2_entered.set()
                await b2_gate.wait()
            return await real_disp(loop, key, codec_, cells_)

        async def held_fail(loop, key, items, exc):
            await fail_gate.wait()
            await real_fail(loop, key, items, exc)

        b._dispatch_once = disp
        b._fail_closed = held_fail

        fut1 = asyncio.ensure_future(b.encode_cells(codec, cells(1)))
        while state["calls"] < 1:       # B1 dispatched and failed
            await asyncio.sleep(0.001)
        await asyncio.sleep(0.01)       # except path released + parked
        fut2 = asyncio.ensure_future(b.encode_cells(codec, cells(2)))
        await asyncio.wait_for(b2_entered.wait(), 5)
        key = seen["key"]
        assert key in b._inflight       # B2 owns the bucket
        fail_gate.set()                 # B1's _run finishes now
        await asyncio.sleep(0.05)
        assert key in b._inflight, \
            "failure path released the bucket twice"
        b2_gate.set()
        parity, _ = await asyncio.wait_for(fut2, 10)
        assert parity.shape == (1, 2, 256)
        with pytest.raises(RuntimeError):
            await fut1

    run(t())
    d = perf.dump()
    assert d["ec_batch_failures"] == 1
    assert d["ec_batch_failures_injected"] == 1


def test_injected_batch_failure_only_fails_affected_op_end_to_end():
    """Cluster shape of fail-closed: arm one injected dispatch failure
    mid-workload — the affected op EAGAINs, the client's bounded-
    backoff retry lands it, no op is lost and nothing wedges."""
    async def t():
        c = await make_ec_cluster(seed=10)
        pgid = c.client.osdmap.object_to_pg(2, b"o0")
        _, primary = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        c.osds[primary].fault.arm("ec_batch", count=1, kind="enc")
        datas = {f"o{i}": bytes([i + 1]) * 8192 for i in range(6)}
        await asyncio.gather(*(c.client.write_full(2, n, d)
                               for n, d in datas.items()))
        for n, d in datas.items():
            assert await c.client.read(2, n) == d
        assert c.client.op_retries >= 0  # counter exists and is sane
        await c.stop()

    run(t())


def test_client_backoff_bounded_exponential_with_jitter():
    from ceph_tpu_torch.cluster.client import RadosClient

    client = RadosClient(bus=None, device="cpu")
    base = client.conf["client_backoff_base"]
    cap = client.conf["client_backoff_max"]
    for attempt in range(24):
        raw = min(cap, base * (1 << min(attempt, 16)))
        for _ in range(8):
            d = client._backoff(attempt)
            assert raw * 0.5 <= d <= raw  # jittered, never above cap
    assert client._backoff(50) <= cap


@pytest.mark.parametrize("profile", list(THRASH_PROFILES))
def test_short_thrash_converges_and_replays(profile):
    """Tier-1 thrash per codec family: a seeded short schedule (flaps
    [+ a partition on the rs arm] + 1-2% bitrot) under concurrent
    oracle writers must converge to active+clean, scrub-clean,
    byte-exact — the same seed reproduces the same schedule, and the
    non-RS arms prove each codec's verify-on-read + async repair path
    through the batched decode pipeline (clay, blaum_roth)."""
    # rs keeps the historical 5 s shape; the codec arms run a leaner
    # 3 s schedule (bitrot is the point there, not partitions)
    dur, n_obj, writers, partitions, bitrot = {
        "rs": (5.0, 6, 3, True, 0.01),
        "clay": (3.0, 4, 2, False, 0.02),
        "blaum_roth": (3.0, 4, 2, False, 0.02),
    }[profile]

    async def t():
        c = await make_ec_cluster(seed=1234, pg_num=8,
                                  profile=THRASH_PROFILES[profile])
        c.client.op_timeout = 150.0
        thr = Thrasher(c, 2, seed=1234, duration=dur, max_unavail=2,
                       bitrot_p=bitrot, partitions=partitions,
                       n_objects=n_obj, obj_size=16 << 10,
                       writers=writers, settle_timeout=90.0)
        assert thr.schedule == build_schedule(1234, dur, 5,
                                              max_unavail=2,
                                              partitions=partitions)
        verdict = await thr.run()
        assert verdict["passed"], verdict
        assert verdict["converged"]
        assert verdict["scrub_inconsistent"] == []
        assert verdict["oracle_mismatches"] == []
        assert verdict["writes_acked"] > 0
        assert [[e.t, e.kind, e.target] for e in thr.schedule] == \
            verdict["events"]
        if profile != "rs":
            # the arm's writes rode the batched cell pipeline (the
            # degraded-dispatch counter-proof lives in
            # test_repair_economics — here kills/reads race the heal)
            enc = sum(o.perf.dump().get("ec_batches", 0)
                      for o in c.osds if o is not None)
            assert enc > 0
        await c.stop()

    run(t(), timeout=300)


@pytest.mark.slow
def test_thrash_60s_acceptance():
    """The acceptance thrash: 60 seconds of OSD flaps + one
    rolling partition + bitrot on 1% of reads against a k=3,m=2 pool
    with concurrent writers; converges to active+clean with zero
    deep-scrub inconsistencies and byte-exact oracle reads, and the
    seed reproduces the schedule."""
    async def t():
        seed = 20260803
        c = await make_ec_cluster(seed=seed, pg_num=8)
        c.client.op_timeout = 300.0
        thr = Thrasher(c, 2, seed=seed, duration=60.0, max_unavail=2,
                       bitrot_p=0.01, partitions=True, n_objects=10,
                       obj_size=24 << 10, writers=4,
                       settle_timeout=120.0)
        assert thr.schedule == build_schedule(seed, 60.0, 5,
                                              max_unavail=2,
                                              partitions=True)
        verdict = await thr.run()
        assert verdict["passed"], verdict
        await c.stop()

    run(t(), timeout=600)


def test_unfound_grace_anchors_on_recovery_progress():
    """The orphan-rollback gate (ROADMAP item d): UNFOUND_GRACE alone
    is a wall clock, and a merely SLOW recovery (delayed reconstructs)
    exhausts it while acked objects are still recoverable — the skip
    then converges heads over the gap and scrub rolls the generation
    back. The gate must re-anchor whenever recovery progressed since
    the mark, and only classify unfound after a full grace with ZERO
    progress."""
    async def t():
        pg = PG.__new__(PG)  # pure gate logic: no cluster needed
        pg._unfound_since = {}
        pg._recovery_progress = 0
        oid = b"debris"
        # first failure only marks
        assert not pg._unfound_grace_spent(oid)
        t0, p0 = pg._unfound_since[oid]
        assert p0 == 0
        # wall clock spent but recovery progressed since the mark:
        # NOT unfound — the mark re-anchors at the new reading
        pg._unfound_since[oid] = (t0 - UNFOUND_GRACE - 1.0, p0)
        pg._note_recovery_progress()
        assert not pg._unfound_grace_spent(oid)
        t1, p1 = pg._unfound_since[oid]
        assert p1 == pg._recovery_progress and t1 > t0 - 1.0
        # grace not yet spent at the new anchor: still not unfound
        assert not pg._unfound_grace_spent(oid)
        # a full grace with no progress at all: unfound
        pg._unfound_since[oid] = (t1 - UNFOUND_GRACE - 1.0, p1)
        assert pg._unfound_grace_spent(oid)

    run(t(), timeout=10)


@pytest.mark.slow
def test_slow_recovery_keeps_acked_writes(monkeypatch):
    """ROADMAP item (d) regression: delaying _reconstruct_chunk by
    ~80 ms per call (a saturated device link / cold-compile shape)
    made the 20 s seeded thrash lose an acked generation ~1-in-3 on
    plain rs at seed 20260803 — UNFOUND_GRACE expired while recovery
    was still grinding, the skip converged heads over the gap, and
    scrub rolled the orphan back. With the grace anchored on recovery
    progress the same run stays byte-exact."""
    orig = PG._reconstruct_chunk

    async def slow_reconstruct(self, oid, shard):
        await asyncio.sleep(0.08)
        return await orig(self, oid, shard)

    monkeypatch.setattr(PG, "_reconstruct_chunk", slow_reconstruct)

    async def t():
        seed = 20260803
        c = await make_ec_cluster(seed=seed, pg_num=8)
        c.client.op_timeout = 300.0
        thr = Thrasher(c, 2, seed=seed, duration=20.0, max_unavail=2,
                       bitrot_p=0.01, partitions=True, n_objects=8,
                       obj_size=24 << 10, writers=4,
                       settle_timeout=150.0)
        verdict = await thr.run()
        assert verdict["passed"], verdict
        await c.stop()

    run(t(), timeout=600)


def test_late_subop_pg_shell_never_wedges_wait_clean():
    """Thrash-found convergence wedge: a late/duplicated sub-op (or a
    prior-interval push) addressed to a shard position this OSD no
    longer holds creates a fresh PG instance via _ensure_pg. With the
    map epoch stable afterwards, on_map never runs again — the shell
    kept the constructor's 'peering' forever and wait_clean never
    returned. _ensure_pg must classify the newborn instance against
    the CURRENT map immediately (stray/replica -> active, genuine
    primary -> peering task)."""
    async def t():
        c = await make_ec_cluster(seed=17)
        await c.client.write_full(2, "obj", b"x" * (3 * 4096))
        pgid = c.client.osdmap.object_to_pg(2, b"obj")
        up, primary = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        osd = c.osds[up[1]]
        # a shard position some OTHER OSD holds under the current map:
        # exactly what a delayed MECSubWrite from a prior pg_temp
        # interval addresses
        stray_shard = next(s for s in range(len(up))
                           if up[s] != osd.id)
        shell = osd._ensure_pg(pgid, stray_shard)
        assert shell.state == "active"  # stray: serve, never drive
        # and the cluster still converges with the shell registered
        await c.wait_clean(30)
        await c.stop()

    run(t())


def test_primary_delta_write_over_missing_base_bounces():
    """Review-found sibling of the handle_ec_write missing-base bounce:
    the PRIMARY's own shard used to apply a delta write even when its
    base content was on the missing record (head converged over a
    skipped unfound push), stamping the new ATTR_V + copied hinfo over
    absent cells — zeros that hash as zero cells, corruption neither
    CRC nor the version cross-check can convict. The fan-out must
    bounce (EAGAIN -> client retry) and re-peer so recovery restores
    the base first; the retried write then lands byte-exact."""
    async def t():
        c = await make_ec_cluster(seed=19)
        rng = np.random.default_rng(55)
        data = rng.integers(0, 256, 3 * 4096 * 2, dtype=np.uint8).tobytes()
        await c.client.write_full(2, "obj", data)
        pgid = c.client.osdmap.object_to_pg(2, b"obj")
        up, primary = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        posd = c.osds[primary]
        key = (pgid[0], pgid[1], up.index(primary))
        pg = posd.pgs[key]
        # simulate the converged-over gap: the primary's own shard
        # base is gone and the gap is on record
        from ceph_tpu_torch.cluster.pg import ATTR_V as AV
        import ceph_tpu_torch.utils.denc as denc
        raw = posd.store.getattr(pg.cid, b"obj", AV)
        ver = (denc.dec_u32(raw, 0)[0], denc.dec_u64(raw, 4)[0])
        t0 = tx.Transaction()
        t0.remove(pg.cid, b"obj")
        posd.store.queue_transaction(t0)
        pg.missing[b"obj"] = ver
        # a partial (delta) overwrite: must NOT serve from the absent
        # base; the bounce re-peers, recovery reinstalls the shard,
        # the client's retry lands
        patch = rng.integers(0, 256, 512, dtype=np.uint8).tobytes()
        await c.client.write(2, "obj", 1024, patch)
        want = data[:1024] + patch + data[1024 + 512:]
        assert await c.client.read(2, "obj") == want
        assert pg.missing.get(b"obj") is None  # recovered, gap cleared
        await c.stop()

    run(t())


def test_chip_loss_fault_scopes_to_owning_osds():
    """The chip-loss arm fires EC device dispatches only on the dark
    chip's owners, re-arms on revive (a revived OSD whose chip is
    still dark comes back dark), and chip_heal disarms everywhere
    without touching other armed sites."""
    async def t():
        c = await make_ec_cluster(seed=17)
        c.faults.store_fault("ec_read_bitflip", p=0.01)  # another arm
        # chip 1 of 4 owns osd.1 (1 % 4) — and nobody else at n=5
        c.faults.store_fault("ec_batch", p=1.0, osd_ids=[1])
        assert c.osds[1].fault._arms.get("ec_batch")
        assert not c.osds[0].fault._arms.get("ec_batch")
        assert not c.osds[4].fault._arms.get("ec_batch")
        await c.kill_osd(1)
        await c.revive_osd(1)
        assert c.osds[1].fault._arms.get("ec_batch")
        c.faults.clear_store_fault("ec_batch")
        assert not c.osds[1].fault._arms.get("ec_batch")
        # the unrelated site survives the single-site heal
        assert c.osds[2].fault._arms.get("ec_read_bitflip")
        await c.stop()

    run(t())


def test_short_chip_loss_thrash_converges_over_mesh():
    """Tier-1 chip-loss thrash: the serving mesh on (device engine,
    collective repair) over a virtual mesh of 8 CPU slots
    (``pin_virtual(8)``), a seeded ~4 s schedule that includes mesh-chip
    losses, byte-exact convergence — the small sibling of the 20 s CLI
    acceptance run (``ceph_tpu_torch.tools.thrash --chip-loss``). The
    reference's bounds, as they are."""
    from ceph_tpu_torch import parallel
    from ceph_tpu_torch.parallel import runtime

    parallel.pin_virtual(8)

    async def t():
        c = TestCluster(n_osds=5, fault_seed=4242, osd_conf={
            "osd_ec_mesh_devices": 8,
            "osd_ec_mesh_width": 2,
            "parallel_repair_mode": "allgather",
        }, device="cpu")
        await c.start()
        await c.client.create_pool(
            Pool(id=2, name="ec", size=5, min_size=3, pg_num=8,
                 crush_rule=1, type="erasure",
                 ec_profile=dict(EC_PROFILE)))
        await c.wait_active(20)
        c.client.op_timeout = 150.0
        runtime.STATS.reset()
        thr = Thrasher(c, 2, seed=4242, duration=4.0, max_unavail=2,
                       bitrot_p=0.0, partitions=False, n_objects=6,
                       obj_size=16 << 10, writers=3,
                       settle_timeout=90.0, chip_loss=True, n_chips=8)
        assert thr.schedule == build_schedule(
            4242, 4.0, 5, max_unavail=2, partitions=False,
            chip_loss=True, n_chips=8)
        assert any(e.kind == "chip_loss" for e in thr.schedule)
        verdict = await thr.run()
        assert verdict["passed"], verdict
        assert verdict["writes_acked"] > 0
        assert any(k == "chip_loss" for _, k, _ in verdict["events"])
        await c.stop()

    run(t(), timeout=300)
    # the thrash actually rode the mesh
    assert runtime.STATS.dump()["mesh_encode_dispatches"] > 0
    assert runtime.STATS.dump()["mesh_host_gathers"] == 0


def test_plane_store_fault_rearms_on_revive():
    """A plane-registered store fault survives kill/revive: the spec
    re-arms on the fresh injector (specs outlive incarnations)."""
    async def t():
        c = await make_ec_cluster(seed=13)
        c.faults.store_fault("ec_sub_read", p=1.0, oid=b"nope")
        victim = 1
        assert c.osds[victim].fault._arms.get("ec_sub_read")
        await c.kill_osd(victim)
        await c.revive_osd(victim)
        assert c.osds[victim].fault._arms.get("ec_sub_read")
        # re-arming REPLACES on live injectors (no stacked arms — live
        # and revived OSDs must fire at the same rate)
        c.faults.store_fault("ec_sub_read", p=0.5, oid=b"nope")
        assert len(c.osds[victim].fault._arms["ec_sub_read"]) == 1
        c.faults.clear_store_faults()
        assert not c.osds[victim].fault._arms.get("ec_sub_read")
        await c.stop()

    run(t())


def test_revived_peon_rediscovers_leader_without_election():
    """Mon-failover rejoin: a revived peon boots leaderless and
    campaigns; the healthy leader must answer with a victory
    re-announce (fold-in) rather than silence — quorum-membership
    tests alone miss this, because the leader's quorum list never
    shrank while the peon was down, yet the peon's own `leader` stays
    None and every client op forwarded through it would fail."""
    async def t():
        c = TestCluster(n_osds=3, n_mons=3, device="cpu")
        await c.start()
        peon = next(r for r, m in enumerate(c.mons)
                    if m is not None and not m.is_leader())
        await c.kill_mon(peon)
        m = await c.revive_mon(peon)
        for _ in range(200):
            if m.leader is not None and m.rank in m.quorum:
                break
            await asyncio.sleep(0.05)
        assert m.leader is not None, "revived peon never found the leader"
        assert m.rank in m.quorum, "revived peon never rejoined quorum"
        await c.stop()

    run(t())
