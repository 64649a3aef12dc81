"""The cluster cases of ``tests/test_ec_batcher.py`` on the port
(``ceph_tpu_torch``): EC read atomicity against a concurrent write and
cross-tick coalescing, each cluster on ``device="cpu"`` (the kernels'
plain versions). The reference's cases are copied with only their
imports and device changed. Tolerance: exact, as in the reference.
"""
import asyncio
import time

import numpy as np
import pytest
import torch

from ceph_tpu_torch import native

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)


DEV_PROFILE = {"plugin": "rs_tpu", "k": "3", "m": "2", "backend": "device"}


def run(coro):
    asyncio.run(asyncio.wait_for(coro, 120))


def test_ec_read_is_atomic_against_concurrent_write():
    """With ops dispatched concurrently (osd_op_concurrency > 1), an EC
    read racing a write's multi-shard fanout must never return a torn
    mix of old and new cells — reads serialize on the PG lock."""
    from ceph_tpu_torch.cluster.vstart import TestCluster
    from ceph_tpu_torch.ec import rs_plugin
    from ceph_tpu_torch.placement.osdmap import Pool

    old = b"A" * 24576  # two full stripes at k=3, su=4096
    new = b"B" * 24576

    async def t():
        c = TestCluster(n_osds=5, device="cpu")
        await c.start()
        await c.client.create_pool(Pool(
            id=2, name="ec", size=5, min_size=3, pg_num=8, crush_rule=1,
            type="erasure", ec_profile={"plugin": "rs_tpu", "k": "3",
                                        "m": "2", "backend": "device"}))
        await c.wait_active(30)
        await c.client.write_full(2, "obj", old)
        # slow the encode so the overwrite sits mid-fanout while the
        # read races it
        real = rs_plugin.RSCodec.encode_crc_batch

        def slow(self, data, cell_bytes):
            time.sleep(0.15)
            return real(self, data, cell_bytes)

        rs_plugin.RSCodec.encode_crc_batch = slow
        try:
            w = asyncio.ensure_future(c.client.write_full(2, "obj", new))
            await asyncio.sleep(0.05)
            got = await c.client.read(2, "obj")
            await w
        finally:
            rs_plugin.RSCodec.encode_crc_batch = real
        assert got in (old, new), "torn EC read: mixed old/new cells"
        assert await c.client.read(2, "obj") == new
        await c.stop()

    run(t())


def test_cluster_coalescing_beats_single_tick_baseline(monkeypatch):
    """Acceptance: on the device engine, concurrent writers
    and the coalescing knobs on, mean stripes_per_batch >= 4x the
    single-tick baseline — and the write path performs no separate
    host CRC pass over encoded cells (CRCs ride the fused dispatch)."""
    from ceph_tpu_torch.cluster.vstart import TestCluster
    from ceph_tpu_torch.placement.osdmap import Pool

    # The port has no engine probe (``ec/engine.py`` is dropped by
    # decision): ``backend=auto`` resolves to the device engine, here
    # the plain versions on the CPU, and nothing needs a warm-up.

    crc_calls = {"n": 0}
    real_crc_batch = native.crc32c_batch

    def counting_crc_batch(*a, **kw):
        crc_calls["n"] += 1
        return real_crc_batch(*a, **kw)

    async def run_one(osd_conf: dict, writers: int,
                      objs: int) -> float:
        c = TestCluster(n_osds=5, osd_conf=osd_conf, device="cpu")
        await c.start()
        c.client.op_timeout = 60.0
        # many PGs: writes serialize per-PG (the reference ordering
        # contract), so the count of concurrently-busy PGs per OSD
        # bounds how many stripes can park at once — the real knob
        # behind coalescing depth
        await c.client.create_pool(Pool(
            id=2, name="ec", size=5, min_size=3, pg_num=128,
            crush_rule=1, type="erasure",
            ec_profile={"plugin": "rs_tpu", "k": "3", "m": "2",
                        "backend": "auto"}))
        await c.wait_active(60)
        # exactly one stripe per object: width = k * stripe_unit
        payload = np.random.default_rng(13).integers(
            0, 256, 3 * 4096, dtype=np.uint8).tobytes()

        async def writer(w: int) -> None:
            for i in range(objs):
                await c.client.write_full(2, f"o{w}-{i}", payload)

        await asyncio.gather(*(writer(w) for w in range(writers)))
        batches = stripes = 0
        for osd in c.osds:
            d = osd.perf.dump()
            batches += int(d["ec_batches"])
            stripes += int(d["ec_batch_stripes"]["sum"])
        await c.stop()
        assert stripes == writers * objs
        return stripes / max(batches, 1)

    async def t():
        base = await run_one(
            {"osd_op_concurrency": 1, "osd_ec_batch_window": 0.0,
             "osd_ec_batch_target_stripes": 0},
            writers=4, objs=3)
        assert base == pytest.approx(1.0), base  # single-tick shape
        monkeypatch.setattr(native, "crc32c_batch", counting_crc_batch)
        try:
            coalesced = await run_one(
                {"osd_op_concurrency": 128,
                 "osd_ec_batch_window": 0.05,
                 "osd_ec_batch_target_stripes": 12},
                writers=96, objs=2)
        finally:
            monkeypatch.setattr(native, "crc32c_batch", real_crc_batch)
        # no separate host CRC pass anywhere in the device write path
        assert crc_calls["n"] == 0
        assert coalesced >= 4 * base, (coalesced, base)

    run(t())

