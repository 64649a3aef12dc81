"""The cases of ``tests/test_balancer_config.py`` on the port
(``ceph_tpu_torch``), each cluster on ``device="cpu"`` (the kernels'
plain versions), copied with only their imports and device changed.
The reference's own words follow.

Balancer (upmap optimizer, mgr balancer-module role) and the
central config DB (ConfigMonitor / MConfig push role)."""
import asyncio
import os

from ceph_tpu_torch.cluster import TestCluster, balancer
from ceph_tpu_torch.placement import crushmap as cm
from ceph_tpu_torch.placement.osdmap import OSDMap, Pool
from ceph_tpu_torch.utils.admin import admin_command
import torch

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)


def run(coro):
    asyncio.run(asyncio.wait_for(coro, 120))


async def _until(pred, timeout=10.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while not pred():
        if asyncio.get_running_loop().time() > deadline:
            raise AssertionError("condition never became true")
        await asyncio.sleep(0.02)


# ----------------------------------------------------------- balancer


def _map_with_pool(n_osds=6, pg_num=64) -> OSDMap:
    crush = cm.build_flat(n_osds)
    crush.add_rule(cm.flat_firstn_rule(0))
    m = OSDMap(crush, n_osds)
    m.pools[1] = Pool(id=1, name="p", size=3, pg_num=pg_num,
                      crush_rule=0)
    return m


def test_compute_moves_improves_spread():
    m = _map_with_pool()
    before = balancer.spread(m, 1)
    moves = balancer.compute_moves(m, 1, max_moves=50)
    if before["spread"] <= 1:
        assert moves == []
        return
    for pgid, pairs in moves:
        m.pg_upmap_items[pgid] = pairs
    after = balancer.spread(m, 1)
    assert after["spread"] < before["spread"]
    # every PG still maps to `size` distinct up OSDs
    for ps in range(m.pools[1].pg_num):
        up, _ = m.pg_to_up_acting_osds((1, ps))
        ups = [o for o in up if o is not None and o >= 0]
        assert len(ups) == len(set(ups)) == 3


def test_compute_moves_respects_failure_domains():
    crush = cm.build_hierarchy(osds_per_host=2, n_hosts=4)
    crush.add_rule(cm.replicated_rule(0))
    m = OSDMap(crush, 8)
    m.pools[1] = Pool(id=1, name="p", size=3, pg_num=64, crush_rule=0)
    parents = balancer._parents(m)
    assert parents is not None
    moves = balancer.compute_moves(m, 1, max_moves=50)
    for pgid, pairs in moves:
        m.pg_upmap_items[pgid] = pairs
    for ps in range(64):
        up, _ = m.pg_to_up_acting_osds((1, ps))
        ups = [o for o in up if o is not None and o >= 0]
        doms = [parents[o] for o in ups]
        assert len(set(doms)) == len(doms), (ps, ups, doms)


def test_balancer_via_mgr_and_data_survives(tmp_path):
    async def t():
        c = TestCluster(n_osds=6, device="cpu")
        await c.start()
        await c.client.create_pool(
            Pool(id=1, name="p", size=3, pg_num=64, crush_rule=0))
        await c.wait_active(30)
        data = {f"o{i}".encode(): os.urandom(2000) for i in range(12)}
        for k, v in data.items():
            await c.client.write_full(1, k, v)
        sock = str(tmp_path / "mgr.sock")
        await c.mgr.start_admin(sock)
        before = await admin_command(sock, "balancer status", pool=1)
        res = await admin_command(sock, "balancer run", pool=1,
                                  max_moves=50)
        if before["spread"] > 1:
            assert res["moves"], "skewed pool but no moves proposed"
            await c.wait_epoch(c.mon.osdmap.epoch, 10)
            after = await admin_command(sock, "balancer status", pool=1)
            assert after["spread"] < before["spread"]
        await c.wait_active(30)  # PGs re-peer onto the new mapping
        for k, v in data.items():
            assert await c.client.read(1, k) == v
        await c.stop()

    run(t())


# ------------------------------------------------------- central config


def test_config_push_reaches_all_osds(tmp_path):
    async def t():
        c = TestCluster(n_osds=4, device="cpu")
        await c.start()
        sock = str(tmp_path / "mgr.sock")
        await c.mgr.start_admin(sock)
        assert await admin_command(
            sock, "config set", who="osd", key="osd_subop_timeout",
            value="7.5") == "ok"
        await _until(lambda: all(
            o.conf.get("osd_subop_timeout") == 7.5 for o in c.osds))
        # per-instance beats class for that instance only
        await admin_command(sock, "config set", who="osd.2",
                            key="osd_subop_timeout", value="2.0")
        await _until(
            lambda: c.osds[2].conf.get("osd_subop_timeout") == 2.0)
        assert c.osds[0].conf.get("osd_subop_timeout") == 7.5
        # mirror serves config dump
        dump = await admin_command(sock, "config dump")
        assert dump["osd/osd_subop_timeout"] == "7.5"
        # a REVIVED osd gets the DB on subscribe (late joiner)
        await c.kill_osd(1)
        await c.wait_down(1)
        await c.revive_osd(1)
        await _until(
            lambda: c.osds[1].conf.get("osd_subop_timeout") == 7.5)
        await c.stop()

    run(t())


def test_config_survives_mon_failover():
    """The config DB mirrors to peer mons, so a new leader after
    failover still serves it to (re)booting daemons."""
    async def t():
        c = TestCluster(n_osds=3, n_mons=3, device="cpu")
        await c.start()
        await c.wait_quorum(10)
        leader = c.mon.rank
        await c.mon.handle("client.x", __import__(
            "ceph_tpu_torch.cluster.messages", fromlist=["M"]).MConfigSet(
                who="osd", key="osd_subop_timeout", value="9.0"))
        await _until(lambda: all(
            o.conf.get("osd_subop_timeout") == 9.0 for o in c.osds))
        await c.kill_mon(leader)
        await c.wait_quorum(10)
        assert c.mon.config_db[("osd", "osd_subop_timeout")] == "9.0"
        # a rebooting OSD gets the DB from the NEW leader
        await c.kill_osd(0)
        await c.wait_down(0)
        await c.revive_osd(0)
        await _until(
            lambda: c.osds[0].conf.get("osd_subop_timeout") == 9.0)
        await c.stop()

    run(t())


def test_bad_config_value_rejected_quietly():
    async def t():
        c = TestCluster(n_osds=2, device="cpu")
        await c.start()
        await c.mon.handle("client.x", __import__(
            "ceph_tpu_torch.cluster.messages", fromlist=["M"]).MConfigSet(
                who="osd", key="osd_subop_timeout", value="not-a-float"))
        await asyncio.sleep(0.1)
        # daemons keep running with their old value
        assert c.osds[0].conf.get("osd_subop_timeout") > 0
        await c.stop()

    run(t())
