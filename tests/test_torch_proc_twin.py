"""One deterministic schedule through the JAX package's ProcCluster and the
port's, with equal results required.

The schedule, over TCP between daemon processes with WalStores: one mon
and 7 OSDs, an EC pool (jerasure reed_sol_van k=4, m=2) and a replicated
size-3 pool; objects written to both, a 4 KiB overwrite, kill -9 of an
OSD's process, a degraded read of everything, the OSD revived (a cold
start from its WalStore) and the cluster recovered to active+clean (no
pg_temp left), a last read. The JAX cluster's daemons run CPU JAX; the
port's run on ``device="cpu"`` (the kernels' plain versions).

Tolerance: exact. Client-visible bytes are equal, and so is every shard:
after the stop, for every object and shard id, the shard's bytes and its
``hash_info`` CRCs as the OSD that the final map places that shard on
holds them (each package's stores mounted with the port's WalStore). Map
epochs depend on heartbeat timing and are not compared; the mon stores
are held across the packages by ``test_torch_monstore.py``.
"""
import asyncio
import hashlib
import importlib
import signal

import numpy as np
import torch

import ceph_tpu_torch.store as port_store
from test_torch_native import jax_native_whole  # noqa: F401

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)

EC_POOL, REP_POOL = 2, 1
N_OSDS, PG_NUM, KILLED = 7, 8, 1
SEED = 20261017


def _objects(rng) -> dict[tuple[int, str], bytes]:
    """(pool, name) -> bytes: stripe-aligned, ragged and tiny objects."""
    sizes = (1 << 19, 32768, 100_000, 4096 * 9 + 17, 3)
    return {(pool, f"obj-{i}"): rng.integers(0, 256, n,
                                             dtype=np.uint8).tobytes()
            for pool in (EC_POOL, REP_POOL) for i, n in enumerate(sizes)}


async def _wait_clean(c, timeout: float) -> None:
    """ProcCluster.wait_active and no pg_temp pin left in the map (the
    data of every re-placement moved back)."""
    deadline = asyncio.get_running_loop().time() + timeout
    while True:
        await c.wait_active(timeout)
        await c._refresh_map()
        if not c.client.osdmap.pg_temp:
            await c.wait_active(timeout)
            return
        assert asyncio.get_running_loop().time() < deadline, "pg_temp left"
        await asyncio.sleep(0.1)


async def _schedule(pkg: str, data_dir: str) -> dict:
    procstart = importlib.import_module(f"{pkg}.cluster.procstart")
    osdmap = importlib.import_module(f"{pkg}.placement.osdmap")
    kw = {"device": "cpu"} if pkg == "ceph_tpu_torch" else {}
    c = procstart.ProcCluster(data_dir, n_osds=N_OSDS, backend="tcp",
                              objectstore="walstore", **kw)
    reads = {}
    await c.start()
    try:
        c.client.op_timeout = 60.0
        await c.client.create_pool(osdmap.Pool(
            id=REP_POOL, name="rep", size=3, pg_num=PG_NUM, crush_rule=0))
        await c.client.create_pool(osdmap.Pool(
            id=EC_POOL, name="ec", size=6, min_size=4, pg_num=PG_NUM,
            crush_rule=1, type="erasure",
            ec_profile={"plugin": "jerasure", "technique": "reed_sol_van",
                        "k": "4", "m": "2", "backend": "device"}))
        await c.wait_active(120)
        rng = np.random.default_rng(SEED)
        objs = _objects(rng)
        for (pool, name), data in objs.items():
            await c.client.write_full(pool, name, data)
        patch = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
        for pool in (EC_POOL, REP_POOL):
            await c.client.write(pool, "obj-0", 4096 * 37, patch)
            d = bytearray(objs[(pool, "obj-0")])
            d[4096 * 37:4096 * 38] = patch
            objs[(pool, "obj-0")] = bytes(d)

        async def read_all(tag):
            for (pool, name), want in sorted(objs.items()):
                got = bytes(await c.client.read(pool, name))
                reads[f"{tag}:{pool}:{name}"] = \
                    hashlib.sha256(got).hexdigest()
                assert got == want, (pkg, tag, pool, name)

        c.kill_osd(KILLED, signal.SIGKILL)
        await c.wait_down(KILLED, 60)
        await read_all("degraded")
        await c.revive_osd(KILLED)
        await c.wait_up(KILLED, 60)
        await _wait_clean(c, 120)
        await read_all("clean")
        final = c.client.osdmap
        placed = {}
        for (pool, name) in objs:
            pgid = final.object_to_pg(pool, name.encode())
            acting, _ = final.pg_to_up_acting_osds(pgid)
            placed[(pool, name)] = (pgid, list(acting))
    finally:
        await c.stop()
    return {"reads": reads, "placed": placed}


def _shards(data_dir: str, placed: dict) -> dict:
    """(pool, name, shard id) -> [sha256 of the shard's bytes, its
    hash_info CRCs], each read from the OSD the final map places that
    shard on (a replica's shard id is its position in the acting set)."""
    from ceph_tpu_torch.cluster.pg import ATTR_HINFO
    from ceph_tpu_torch.cluster.stripe import dec_hinfo

    stores: dict[int, object] = {}
    out = {}
    try:
        for (pool, name), ((p, ps), acting) in sorted(placed.items()):
            for shard, osd in enumerate(acting):
                if osd not in stores:
                    stores[osd] = port_store.create(
                        "walstore", f"{data_dir}/osd.{osd}")
                s = stores[osd]
                cid = f"{p}.{ps}s{shard}" if pool == EC_POOL \
                    else f"{p}.{ps}"
                oid = name.encode()
                raw = s.getattrs(cid, oid).get(ATTR_HINFO)
                out[f"{pool}:{name}:{shard}"] = [
                    hashlib.sha256(s.read(cid, oid)).hexdigest(),
                    [] if raw is None else [int(x) for x in dec_hinfo(raw)]]
    finally:
        for s in stores.values():
            s.umount()
    return out


def test_proc_cluster_schedule_equals_the_reference(tmp_path):
    results = {}
    for pkg in ("ceph_tpu", "ceph_tpu_torch"):
        d = tmp_path / pkg
        d.mkdir()
        res = asyncio.run(asyncio.wait_for(_schedule(pkg, str(d)), 240))
        res["shards"] = _shards(str(d), res["placed"])
        results[pkg] = res
    want, got = results["ceph_tpu"], results["ceph_tpu_torch"]
    assert got["reads"] == want["reads"]
    assert got["shards"].keys() == want["shards"].keys()
    for key in want["shards"]:
        assert got["shards"][key] == want["shards"][key], key
    ec = [v for k, v in want["shards"].items()
          if k.startswith(f"{EC_POOL}:")]
    assert len(ec) == 5 * 6 and all(h for _, h in ec)
