"""The cases of ``tests/test_monstore.py`` on the port
(``ceph_tpu_torch``), each cluster on ``device="cpu"`` (the kernels'
plain versions), copied with only their imports and device changed;
then one case where each package mounts the ``mon.N.kv`` stores that the
other's mon quorum wrote, with equal maps (tolerance: exact). The
reference's own words follow.

Durable mon: MonitorDBStore-role persistence on the native kv.

Acceptance (VERDICT r2 item 5): kill all mons+OSDs, restart from disk,
and the cluster converges with its maps, pools, config DB, and epochs
intact — no pool re-creation, no data loss.
"""
import asyncio

import importlib
import shutil

import numpy as np
import pytest
import torch

from ceph_tpu_torch.cluster.monstore import MonStore
from ceph_tpu_torch.cluster.vstart import TestCluster
from ceph_tpu_torch.placement.osdmap import Pool
from test_torch_native import jax_native_whole  # noqa: F401

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)

EC_PROFILE = {"plugin": "rs_tpu", "k": "3", "m": "2"}


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, 180))
    finally:
        loop.close()


# ------------------------------------------------------------- unit level


def test_monstore_map_roundtrip(tmp_path):
    s = MonStore(str(tmp_path / "mon.kv"))
    s.save_map(b"FULLMAP", 7, b"INC7", 7, next_pool_id=4)
    s.save_map(b"FULLMAP8", 8, b"INC8", 8, next_pool_id=5)
    full, last, history, npool = s.load_map()
    assert full == b"FULLMAP8"
    assert last == 8
    assert history == {7: b"INC7", 8: b"INC8"}
    assert npool == 5
    s.close()
    # reopen: state survives
    s2 = MonStore(str(tmp_path / "mon.kv"))
    assert s2.load_map()[1] == 8
    s2.close()


def test_monstore_paxos_roundtrip(tmp_path):
    s = MonStore(str(tmp_path / "mon.kv"))
    assert s.load_paxos() == (0, 0, 0, None)
    s.save_paxos(103, 105, 105, (105, 9, b"value"))
    assert s.load_paxos() == (103, 105, 105, (105, 9, b"value"))
    s.save_paxos(109, 106, 106, None)
    assert s.load_paxos() == (109, 106, 106, None)
    s.close()


def test_paxos_pn_restore_stays_rank_disjoint(tmp_path):
    """A restarted mon's pn must exceed everything it saw pre-crash AND
    stay on its rank's residue class mod n_mons (global uniqueness)."""
    from ceph_tpu_torch.cluster.paxos_mon import PaxosMon
    from ceph_tpu_torch.msg.messenger import LocalBus

    n_mons = 3
    for rank, promised in ((0, 106), (1, 104), (2, 0)):
        st = MonStore(str(tmp_path / f"m{rank}.kv"))
        st.save_paxos(100 + rank, promised, promised, None)
        st.close()
        m = PaxosMon(LocalBus(), 3, rank=rank, n_mons=n_mons,
                     store=MonStore(str(tmp_path / f"m{rank}.kv")))
        assert m.pn > promised
        assert m.pn % n_mons == (100 + rank) % n_mons
        m.store.close()


def test_monstore_config_roundtrip(tmp_path):
    s = MonStore(str(tmp_path / "mon.kv"))
    s.save_config("osd", "debug_level", "5")
    s.save_config("global", "x", "y")
    assert s.load_config() == {("osd", "debug_level"): "5",
                               ("global", "x"): "y"}
    s.replace_config({("mon", "a"): "b"})
    assert s.load_config() == {("mon", "a"): "b"}
    s.close()


# --------------------------------------------------------- cluster level


def test_full_cluster_restart_keeps_maps(tmp_path):
    data = bytes(np.random.default_rng(0).integers(
        0, 256, 80_000, dtype=np.uint8))
    saved = {}

    async def phase1():
        c = TestCluster(n_osds=5, objectstore="walstore",
                        data_dir=str(tmp_path), device="cpu")
        await c.start()
        await c.client.create_pool(
            Pool(id=1, name="rep", size=3, pg_num=4, crush_rule=0))
        await c.client.create_pool(
            Pool(id=2, name="ec", size=5, min_size=3, pg_num=4,
                 crush_rule=1, type="erasure",
                 ec_profile=dict(EC_PROFILE)))
        await c.wait_active(20)
        await c.client.write_full(1, "r", data)
        await c.client.write_full(2, "e", data)
        # a snapshot and a config entry must survive the restart too
        snapid = await c.client.selfmanaged_snap_create(2)
        await c.client.write_full(2, "e", b"after-snap" * 100,
                                  snapc=(snapid, [snapid]))
        saved["snapid"] = snapid
        saved["epoch"] = c.mon.osdmap.epoch
        saved["pools"] = set(c.mon.osdmap.pools)
        await c.stop()

    async def phase2():
        c = TestCluster(n_osds=5, objectstore="walstore",
                        data_dir=str(tmp_path), device="cpu")
        await c.start()
        # the mon recovered its maps: pools exist WITHOUT re-creation,
        # and the epoch continued from where it was
        assert set(c.mon.osdmap.pools) >= saved["pools"]
        assert c.mon.osdmap.epoch >= saved["epoch"]
        assert c.mon.osdmap.pools[2].snap_seq >= saved["snapid"]
        await c.wait_active(30)
        assert await c.client.read(1, "r") == data
        assert await c.client.read(2, "e") == b"after-snap" * 100
        # the pre-snap content still resolves through the clone
        assert await c.client.read(2, "e",
                                   snapid=saved["snapid"]) == data
        await c.stop()

    run(phase1())
    run(phase2())


def test_paxos_mons_restart_with_quorum(tmp_path):
    saved = {}

    async def phase1():
        c = TestCluster(n_osds=4, n_mons=3, objectstore="walstore",
                        data_dir=str(tmp_path), device="cpu")
        await c.start()
        await c.client.create_pool(
            Pool(id=1, name="rep", size=3, pg_num=4, crush_rule=0))
        # generous: paxos elections + peering on a loaded single-core
        # box can take far longer than the idle-box 3 s (this test
        # flaked at ~1/3 full-suite runs with tighter budgets)
        await c.wait_active(60)
        await c.client.write_full(1, "obj", b"paxos-durable" * 50)
        saved["epoch"] = c.mon.osdmap.epoch
        await c.stop()

    async def phase2():
        c = TestCluster(n_osds=4, n_mons=3, objectstore="walstore",
                        data_dir=str(tmp_path), device="cpu")
        await c.start()  # waits for quorum
        assert c.mon.osdmap.epoch >= saved["epoch"]
        assert 1 in c.mon.osdmap.pools
        await c.wait_active(60)
        assert await c.client.read(1, "obj") == b"paxos-durable" * 50
        # the recovered cluster still takes writes
        await c.client.write_full(1, "obj2", b"new")
        assert await c.client.read(1, "obj2") == b"new"
        await c.stop()

    run(phase1())
    run(phase2())


# ------------------------------------------------- across the two packages


def _mon_quorum_writes(pkg: str, data_dir: str) -> None:
    """A 3-mon quorum of ``pkg`` with WalStore OSDs: two pools, a config
    entry, an OSD marked down, so each mon.N.kv holds a map history,
    Paxos state and the config DB."""
    vstart = importlib.import_module(f"{pkg}.cluster.vstart")
    osdmap = importlib.import_module(f"{pkg}.placement.osdmap")
    messages = importlib.import_module(f"{pkg}.cluster.messages")
    kw = {"device": "cpu"} if pkg == "ceph_tpu_torch" else {}

    async def t():
        c = vstart.TestCluster(n_osds=5, n_mons=3, objectstore="walstore",
                               data_dir=data_dir, **kw)
        await c.start()
        try:
            await c.client.create_pool(osdmap.Pool(
                id=1, name="rep", size=3, pg_num=4, crush_rule=0))
            await c.client.create_pool(osdmap.Pool(
                id=2, name="ec", size=5, min_size=3, pg_num=4,
                crush_rule=1, type="erasure",
                ec_profile=dict(EC_PROFILE)))
            await c.wait_active(60)
            await c.mon.handle("client.x", messages.MConfigSet(
                who="osd", key="osd_subop_timeout", value="7.5"))
            await c.kill_osd(4)
            await c.wait_down(4, 30)
            # every replica applied the last commit before the stop
            for _ in range(200):
                epochs = {m.osdmap.epoch for m in c.mons if m is not None}
                if len(epochs) == 1:
                    break
                await asyncio.sleep(0.05)
        finally:
            await c.stop()

    run(t())


def _mount(pkg: str, path: str, rank: int) -> dict:
    """What ``pkg``'s PaxosMon restores from ``path`` (its osdmap in its
    own encoding, the incremental history, the pool-id watermark, the
    config DB and the Paxos state)."""
    monstore = importlib.import_module(f"{pkg}.cluster.monstore")
    paxos_mon = importlib.import_module(f"{pkg}.cluster.paxos_mon")
    messenger = importlib.import_module(f"{pkg}.msg.messenger")
    menc = importlib.import_module(f"{pkg}.placement.encoding")
    store = monstore.MonStore(path)
    try:
        m = paxos_mon.PaxosMon(messenger.LocalBus(), 5, rank=rank,
                               n_mons=3, store=store)
        return {"map": menc.encode_osdmap(m.osdmap),
                "epoch": m.osdmap.epoch, "history": dict(m.history),
                "next_pool_id": m._next_pool_id,
                "config": dict(m.config_db),
                "paxos": store.load_paxos(), "pn": m.pn,
                "raw": store.load_map()}
    finally:
        store.close()


@pytest.mark.parametrize("writer", ["ceph_tpu", "ceph_tpu_torch"])
def test_mon_stores_mount_across_packages(writer, tmp_path):
    """Each package's quorum writes its three mon.N.kv stores; both
    packages mount each of them and restore the same map (equal bytes
    in each package's encoding), history, config DB and Paxos state."""
    _mon_quorum_writes(writer, str(tmp_path))
    for rank in range(3):
        # a mount moves the Paxos pn on (and saves it): each package
        # mounts its own copy of what the writer left
        path = tmp_path / f"mon.{rank}.kv"
        for pkg in ("ceph_tpu", "ceph_tpu_torch"):
            shutil.copytree(path, tmp_path / pkg / path.name)
        ref = _mount("ceph_tpu", str(tmp_path / "ceph_tpu" / path.name),
                     rank)
        port = _mount("ceph_tpu_torch",
                      str(tmp_path / "ceph_tpu_torch" / path.name), rank)
        assert port == ref, rank
        assert set(ref["raw"][2]) and ref["epoch"] == ref["raw"][1]
        assert {1, 2} <= set(importlib.import_module(
            "ceph_tpu_torch.placement.encoding").decode_osdmap(
                port["map"])[0].pools)
        assert port["config"] == {("osd", "osd_subop_timeout"): "7.5"}
