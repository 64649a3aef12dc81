"""The cases of ``tests/test_delta_path.py`` on the port (``ceph_tpu_torch``),
each cluster on ``device="cpu"`` (the kernels' plain versions), copied
with only their imports and device changed; the reference's bounds
stay as they are. The reference's own words follow.

Delta write path: op-granular replication + EC partial-stripe RMW.

The acceptance bar from the reference's data-path shape
(ReplicatedBackend.cc:465 ships the op transaction; ECBackend.cc:1898
start_rmw reads/encodes only touched stripes): a 4 KiB write into a
4 MiB object must move O(stripe) bytes end-to-end, independent of the
object size — asserted here by counting actual encoded wire bytes on
the bus.
"""
import asyncio

import numpy as np
import pytest

from ceph_tpu_torch.cluster.vstart import TestCluster
from ceph_tpu_torch.placement.osdmap import Pool
import torch

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)

EC_PROFILE = {"plugin": "rs_tpu", "k": "3", "m": "2"}
MIB = 1024 * 1024


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, 120))
    finally:
        loop.close()


class WireCounter:
    """Wraps LocalBus.send, counting encoded bytes per message type."""

    def __init__(self, bus):
        self.bus = bus
        self.orig = bus.send
        self.by_type: dict[str, int] = {}
        bus.send = self.send

    async def send(self, src, dst, msg):
        name = type(msg).__name__
        self.by_type[name] = self.by_type.get(name, 0) + len(msg.encode())
        await self.orig(src, dst, msg)

    def reset(self):
        self.by_type = {}

    def total(self, *names):
        if not names:
            return sum(self.by_type.values())
        return sum(self.by_type.get(n, 0) for n in names)


async def make_rep(n=4):
    c = TestCluster(n_osds=n, device="cpu")
    await c.start()
    await c.client.create_pool(
        Pool(id=1, name="rep", size=3, pg_num=4, crush_rule=0)
    )
    await c.wait_active(20)
    return c


async def make_ec(n=5):
    c = TestCluster(n_osds=n, device="cpu")
    await c.start()
    await c.client.create_pool(
        Pool(id=2, name="ec", size=5, min_size=3, pg_num=4, crush_rule=1,
             type="erasure", ec_profile=dict(EC_PROFILE))
    )
    await c.wait_active(20)
    return c


def test_replicated_small_write_ships_delta_not_object():
    async def t():
        c = await make_rep()
        big = bytes(np.random.default_rng(0).integers(
            0, 256, 4 * MIB, dtype=np.uint8))
        await c.client.write_full(1, "obj", big)
        wc = WireCounter(c.bus)
        await c.client.write(1, "obj", 1 * MIB + 123, b"\xAA" * 4096)
        # 2 replicas x (4 KiB payload + txn/log framing) << object size
        rep_bytes = wc.total("MOSDRepOp")
        assert rep_bytes < 64 * 1024, f"RepOp shipped {rep_bytes} B"
        want = bytearray(big)
        want[1 * MIB + 123 : 1 * MIB + 123 + 4096] = b"\xAA" * 4096
        assert await c.client.read(1, "obj") == bytes(want)
        await c.stop()

    run(t())


def test_ec_small_write_moves_o_stripe_bytes():
    async def t():
        c = await make_ec()
        rng = np.random.default_rng(1)
        big = bytes(rng.integers(0, 256, 4 * MIB, dtype=np.uint8))
        await c.client.write_full(2, "obj", big)
        wc = WireCounter(c.bus)
        off = 1 * MIB + 5000  # straddles cells, not stripe-aligned
        await c.client.write(2, "obj", off, b"\xBB" * 4096)
        moved = wc.total("MECSubWrite", "MECSubRead", "MECSubReadReply",
                        "MECSubWriteReply")
        # touched stripes ~2 of 342: old-stripe reads + per-shard cell
        # deltas + CRC patches; full-object would be >5.6 MiB encoded
        assert moved < 300 * 1024, f"EC RMW moved {moved} B"
        want = bytearray(big)
        want[off : off + 4096] = b"\xBB" * 4096
        assert await c.client.read(2, "obj") == bytes(want)
        await c.stop()

    run(t())


def test_ec_rmw_parity_consistent_under_two_losses():
    """Partial overwrites must leave every stripe a consistent codeword:
    kill two shards and reconstruct-read the whole object."""
    async def t():
        c = await make_ec()
        rng = np.random.default_rng(2)
        data = bytearray(rng.integers(0, 256, 200_000, dtype=np.uint8))
        await c.client.write_full(2, "obj", bytes(data))
        # a burst of partial mutations: overwrites, append, zero, truncate
        for _ in range(10):
            off = int(rng.integers(0, 190_000))
            ln = int(rng.integers(1, 9000))
            payload = bytes(rng.integers(0, 256, ln, dtype=np.uint8))
            await c.client.write(2, "obj", off, payload)
            data[off : off + ln] = payload
        await c.client.zero(2, "obj", 50_000, 7000)
        data[50_000:57_000] = b"\0" * 7000
        tail = bytes(rng.integers(0, 256, 5000, dtype=np.uint8))
        await c.client.append(2, "obj", tail)
        data.extend(tail)
        await c.client.truncate(2, "obj", 150_000)
        del data[150_000:]
        assert await c.client.read(2, "obj") == bytes(data)

        pgid = c.client.osdmap.object_to_pg(2, b"obj")
        up, primary = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        victims = [o for o in up if o != primary][:2]
        for v in victims:
            await c.kill_osd(v)
            await c.wait_down(v, 20)
        assert await c.client.read(2, "obj") == bytes(data)
        await c.stop()

    run(t())


@pytest.mark.parametrize("pool_id,factory", [(1, make_rep), (2, make_ec)])
def test_random_mutations_match_shadow(pool_id, factory):
    async def t():
        c = await factory()
        rng = np.random.default_rng(42 + pool_id)
        shadow = bytearray()
        await c.client.write_full(pool_id, "o", b"")
        for i in range(18):
            kind = rng.choice(["write", "zero", "truncate", "append",
                               "read"])
            if kind == "write":
                off = int(rng.integers(0, 60_000))
                ln = int(rng.integers(1, 20_000))
                p = bytes(rng.integers(0, 256, ln, dtype=np.uint8))
                await c.client.write(pool_id, "o", off, p)
                if len(shadow) < off + ln:
                    shadow.extend(b"\0" * (off + ln - len(shadow)))
                shadow[off : off + ln] = p
            elif kind == "zero":
                off = int(rng.integers(0, 60_000))
                ln = int(rng.integers(1, 20_000))
                await c.client.zero(pool_id, "o", off, ln)
                if len(shadow) < off + ln:
                    shadow.extend(b"\0" * (off + ln - len(shadow)))
                shadow[off : off + ln] = b"\0" * ln
            elif kind == "truncate":
                size = int(rng.integers(0, 80_000))
                await c.client.truncate(pool_id, "o", size)
                if size < len(shadow):
                    del shadow[size:]
                else:
                    shadow.extend(b"\0" * (size - len(shadow)))
            elif kind == "append":
                ln = int(rng.integers(1, 10_000))
                p = bytes(rng.integers(0, 256, ln, dtype=np.uint8))
                await c.client.append(pool_id, "o", p)
                shadow.extend(p)
            else:
                assert await c.client.read(pool_id, "o") == bytes(shadow)
                assert await c.client.stat(pool_id, "o") == len(shadow)
        assert await c.client.read(pool_id, "o") == bytes(shadow)
        await c.stop()

    run(t())


def test_ec_xattr_update_touches_no_data(  ):
    async def t():
        c = await make_ec()
        await c.client.write_full(2, "obj", b"Z" * MIB)
        wc = WireCounter(c.bus)
        await c.client.setxattr(2, "obj", "color", b"blue")
        assert wc.total("MECSubRead") == 0  # no old stripes fetched
        assert wc.total("MECSubWrite") < 8 * 1024
        assert await c.client.getxattr(2, "obj", "color") == b"blue"
        await c.stop()

    run(t())
