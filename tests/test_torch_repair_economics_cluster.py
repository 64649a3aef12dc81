"""The cluster cases of ``tests/test_repair_economics.py`` on the port
(``ceph_tpu_torch``): the PG's sub-chunk slice plan and a Clay recovery
storm, each cluster on ``device="cpu"`` (the kernels' plain versions).
The reference's cases are copied with only their imports and device
changed. Tolerance: exact, as in the reference.
"""
import asyncio

import numpy as np
import torch

from ceph_tpu_torch.ec import load_codec

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)


def run(coro, timeout=120):
    asyncio.run(asyncio.wait_for(coro, timeout))


def test_slice_subruns_selects_per_cell():
    from ceph_tpu_torch.cluster.pg import (_pack_subruns, _slice_subruns,
                                           _unpack_subruns)

    codec = load_codec({"plugin": "clay", "k": "4", "m": "2"}, device="cpu")
    subs = codec.get_sub_chunk_count()  # 8
    su = 8 * 16
    chunk = np.arange(2 * su, dtype=np.uint8).tobytes()  # 2 cells
    runs = [(0, 2), (4, 2)]
    raw = _pack_subruns(runs)
    assert _unpack_subruns(raw) == runs
    out = np.frombuffer(_slice_subruns(chunk, su, raw, codec),
                        dtype=np.uint8)
    cells = np.frombuffer(chunk, dtype=np.uint8).reshape(2, subs, 16)
    want = np.concatenate(
        [cells[:, 0:2, :], cells[:, 4:6, :]], axis=1).reshape(-1)
    np.testing.assert_array_equal(out, want)


def test_cluster_clay_subchunk_recovery_storm():
    """Kill + out one member of a Clay pool: the backfill rebuild of
    its shards must ride the SUB-CHUNK repair path (counter-proven:
    ec_repair_subchunk > 0 and fetched/rebuilt < k), through batched
    decode dispatches, and every object stays byte-exact."""
    from ceph_tpu_torch.cluster import TestCluster
    from ceph_tpu_torch.placement.osdmap import Pool

    async def t():
        c = TestCluster(n_osds=7, out_interval=1.0, device="cpu")
        await c.start()
        await c.client.create_pool(Pool(
            id=2, name="p", size=5, min_size=3, pg_num=4,
            crush_rule=1, type="erasure",
            ec_profile={"plugin": "clay", "k": "3", "m": "2",
                        "backend": "device", "stripe_unit": "4096"}))
        await c.wait_active(30)
        rng = np.random.default_rng(11)
        datas = {}
        for i in range(4):
            d = rng.integers(0, 256, 40000, dtype=np.uint8).tobytes()
            datas[f"o{i}"] = d
            await c.client.write_full(2, f"o{i}", d)
        pgid = c.client.osdmap.object_to_pg(2, b"o0")
        up, primary = c.mon.osdmap.pg_to_up_acting_osds(pgid)
        victim = next(o for o in up if o != primary)
        await c.kill_osd(victim)
        await c.wait_down(victim, 20)
        await asyncio.sleep(1.5)  # past out_interval: remap + backfill
        await c.wait_clean(60)
        for n, d in datas.items():
            assert await c.client.read(2, n) == d, n
        tot = {}
        for o in c.osds:
            if o is None:
                continue
            for key, v in o.perf.dump().items():
                if isinstance(v, (int, float)):
                    tot[key] = tot.get(key, 0) + v
        assert tot.get("ec_repair_subchunk", 0) > 0, tot
        fetched = tot.get("ec_repair_bytes_fetched", 0)
        rebuilt = tot.get("ec_repair_bytes_rebuilt", 0)
        assert rebuilt > 0
        # clay k=3 m=2 d=4 q=2: sub-chunk amp d/q = 2.0 < k = 3; the
        # mixed ledger (some full-path rebuilds ride along) must still
        # beat the MDS bound
        assert fetched / rebuilt < 3.0, (fetched, rebuilt)
        assert tot.get("ec_decode_batches", 0) > 0
        await c.stop()

    run(t(), timeout=180)

