"""The cases of ``tests/test_ceph_cli.py`` on the port (``ceph_tpu_torch``),
each cluster on ``device="cpu"`` (the kernels' plain versions), copied
with only their imports and device changed; the reference's bounds
stay as they are. The reference's own words follow.

MonCommand surface + `ceph` CLI (src/ceph.in + MonCommands.h roles):
argv matching against the served descriptor table, map/status/pool
commands, pool quotas (FLAG_FULL_QUOTA), and pool deletion.
"""
import asyncio
import json

import pytest

from ceph_tpu_torch.cluster import moncommands
from ceph_tpu_torch.cluster import messages as M
from ceph_tpu_torch.cluster.client import RadosError
from ceph_tpu_torch.cluster.vstart import TestCluster
from ceph_tpu_torch.placement.osdmap import Pool
import torch

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)


def run(coro):
    asyncio.run(asyncio.wait_for(coro, 120))


async def make(n_osds=4):
    c = TestCluster(n_osds=n_osds, device="cpu")
    await c.start()
    await c.client.create_pool(
        Pool(id=1, name="p", size=3, pg_num=8, crush_rule=0))
    await c.wait_active(20)
    return c


# ------------------------------------------------------- argv matching


def test_match_argv():
    assert moncommands.match_argv(["status"]) == {"prefix": "status"}
    assert moncommands.match_argv(["osd", "tree"]) == {
        "prefix": "osd tree"}
    # literal-prefix beats shorter commands; params coerce types
    got = moncommands.match_argv(["osd", "pool", "set", "p",
                                  "pg_num", "16"])
    assert got == {"prefix": "osd pool set", "pool": "p",
                   "var": "pg_num", "val": "16"}
    got = moncommands.match_argv(["osd", "out", "1", "3"])
    assert got == {"prefix": "osd out", "ids": [1, 3]}
    got = moncommands.match_argv(["osd", "reweight", "2", "0.5"])
    assert got["id"] == 2 and got["weight"] == 0.5
    # optional arg omitted / present
    assert moncommands.match_argv(["health"]) == {"prefix": "health"}
    assert moncommands.match_argv(["health", "detail"])["detail"] \
        == "detail"
    # junk does not match
    assert moncommands.match_argv(["osd", "frobnicate"]) is None
    assert moncommands.match_argv(["osd", "reweight", "2", "x"]) is None


def test_descriptions_served():
    async def t():
        c = await make(n_osds=3)
        try:
            rc, _outs, outb = await c.client.mon_command(
                ["get_command_descriptions"])
            assert rc == 0
            descs = json.loads(outb)
            prefixes = {d["prefix"] for d in descs}
            assert {"status", "osd tree", "osd pool create",
                    "config dump"} <= prefixes
        finally:
            await c.stop()

    run(t())


# -------------------------------------------------------- map commands


def test_status_health_tree_and_df():
    async def t():
        c = await make()
        try:
            for i in range(6):
                await c.client.write_full(1, f"o{i}", b"z" * 500)
            # poll until OSD reports -> mgr digest -> mon land (the
            # stats path is throttled at ~2 s + 1 s digest tick)
            for _ in range(60):
                rc, outs, outb = await c.client.mon_command(["status"])
                assert rc == 0
                st = json.loads(outb)
                if st["pgmap"]["objects"] == 6:
                    break
                await asyncio.sleep(0.25)
            assert st["osdmap"]["num_up_osds"] == 4
            assert st["pgmap"]["num_pools"] == 1
            assert st["pgmap"]["pgs_by_state"].get("active", 0) > 0
            assert st["pgmap"]["objects"] == 6
            assert "HEALTH_OK" in outs

            rc, outs, _ = await c.client.mon_command(["health"])
            assert rc == 0 and outs.startswith("HEALTH_OK")

            rc, outs, outb = await c.client.mon_command(["osd", "tree"])
            assert rc == 0
            nodes = json.loads(outb)
            osd_rows = [n for n in nodes if n["type"] == "osd"]
            assert len(osd_rows) == 4
            assert all(n["status"] == "up" for n in osd_rows)

            rc, _, outb = await c.client.mon_command(["df"])
            pools = json.loads(outb)["pools"]
            assert pools[0]["name"] == "p"
            assert pools[0]["objects"] == 6
            # size-3 replication: raw stored bytes ~ 3 * 6 * 500
            assert pools[0]["stored_bytes"] >= 3 * 6 * 500

            rc, outs, outb = await c.client.mon_command(["pg", "stat"])
            assert rc == 0 and json.loads(outb)["num_pgs"] > 0

            rc, _, outb = await c.client.mon_command(["osd", "ls"])
            assert json.loads(outb) == [0, 1, 2, 3]
        finally:
            await c.stop()

    run(t())


def test_osd_out_in_and_reweight():
    async def t():
        c = await make()
        try:
            rc, outs, _ = await c.client.mon_command(["osd", "out", "3"])
            assert rc == 0
            assert c.mon.osdmap.osds[3].weight == 0
            rc, _, _ = await c.client.mon_command(["osd", "in", "3"])
            assert c.mon.osdmap.osds[3].weight == 0x10000
            rc, _, _ = await c.client.mon_command(
                ["osd", "reweight", "3", "0.25"])
            assert c.mon.osdmap.osds[3].weight == 0x4000
            rc, outs, _ = await c.client.mon_command(
                ["osd", "reweight", "9", "0.5"])
            assert rc == M.ENOENT
        finally:
            await c.stop()

    run(t())


def test_pool_create_get_set_and_config():
    async def t():
        c = await make(n_osds=3)
        try:
            rc, outs, outb = await c.client.mon_command(
                ["osd", "pool", "create", "rep2", "8", "replicated",
                 "2"])
            assert rc == 0
            pid = json.loads(outb)["pool_id"]
            assert c.mon.osdmap.pools[pid].size == 2

            rc, _, outb = await c.client.mon_command(
                ["osd", "pool", "ls"])
            assert set(json.loads(outb)) == {"p", "rep2"}

            rc, _, outb = await c.client.mon_command(
                ["osd", "pool", "get", "rep2", "size"])
            assert json.loads(outb) == {"size": 2}

            rc, _, _ = await c.client.mon_command(
                ["osd", "pool", "set", "rep2", "pg_num", "16"])
            assert rc == 0
            assert c.mon.osdmap.pools[pid].pg_num == 16

            rc, _, _ = await c.client.mon_command(
                ["config", "set", "osd", "debug_level", "3"])
            assert rc == 0
            rc, outs, _ = await c.client.mon_command(
                ["config", "get", "osd", "debug_level"])
            assert outs == "3"
            rc, _, outb = await c.client.mon_command(["config", "dump"])
            assert any(e["key"] == "debug_level"
                       for e in json.loads(outb))
        finally:
            await c.stop()

    run(t())


def test_blocklist_commands():
    async def t():
        c = await make(n_osds=3)
        try:
            rc, _, _ = await c.client.mon_command(
                ["osd", "blocklist", "add", "client.evil"])
            assert rc == 0
            await c.client._await_epoch(c.mon.osdmap.epoch)
            rc, _, outb = await c.client.mon_command(
                ["osd", "blocklist", "ls"])
            assert json.loads(outb) == ["client.evil"]
            rc, _, _ = await c.client.mon_command(
                ["osd", "blocklist", "rm", "client.evil"])
            assert rc == 0
            rc, _, outb = await c.client.mon_command(
                ["osd", "blocklist", "ls"])
            assert json.loads(outb) == []
        finally:
            await c.stop()

    run(t())


# ------------------------------------------------------------- quotas


def test_pool_quota_blocks_writes_and_clears():
    async def t():
        c = await make()
        try:
            rc, _, _ = await c.client.mon_command(
                ["osd", "pool", "set", "p", "quota_max_objects", "3"])
            assert rc == 0
            for i in range(4):
                await c.client.write_full(1, f"q{i}", b"d" * 64)
            # wait for stats to flow and the mon to flag the pool full
            for _ in range(80):
                if c.client.osdmap.pools[1].full:
                    break
                await asyncio.sleep(0.25)
            assert c.client.osdmap.pools[1].full
            with pytest.raises(RadosError) as ei:
                await c.client.write_full(1, "overflow", b"x")
            assert ei.value.code == M.EDQUOT
            # reads still work on a full pool
            assert await c.client.read(1, "q0") == b"d" * 64
            h = moncommands._health(c.mon)
            assert "POOL_FULL" in h["checks"]
            # lift the quota: the flag clears and writes resume
            rc, _, _ = await c.client.mon_command(
                ["osd", "pool", "set", "p", "quota_max_objects", "0"])
            for _ in range(80):
                if not c.client.osdmap.pools[1].full:
                    break
                await asyncio.sleep(0.25)
            assert not c.client.osdmap.pools[1].full
            await c.client.write_full(1, "overflow", b"x")
        finally:
            await c.stop()

    run(t())


def test_full_pool_allows_delete_and_self_clears():
    """FULL_TRY stance: a quota-FULL pool must accept deletes so space
    can be reclaimed and the FULL flag can clear WITHOUT raising the
    quota — otherwise the pool is wedged forever."""
    async def t():
        c = await make()
        try:
            rc, _, _ = await c.client.mon_command(
                ["osd", "pool", "set", "p", "quota_max_objects", "3"])
            assert rc == 0
            # exactly 3 writes: the flag trips at objs >= quota, so a
            # 4th write would race the stats digest and flake
            for i in range(3):
                await c.client.write_full(1, f"q{i}", b"d" * 64)
            for _ in range(80):
                if c.client.osdmap.pools[1].full:
                    break
                await asyncio.sleep(0.25)
            assert c.client.osdmap.pools[1].full
            with pytest.raises(RadosError):
                await c.client.write_full(1, "overflow", b"x")
            # deletes ride through the FULL flag
            await c.client.delete(1, "q0")
            await c.client.delete(1, "q1")
            # with usage back under quota the mon clears FULL and
            # writes resume — the flag self-clears via reclamation
            for _ in range(80):
                if not c.client.osdmap.pools[1].full:
                    break
                await asyncio.sleep(0.25)
            assert not c.client.osdmap.pools[1].full
            await c.client.write_full(1, "after", b"x")
        finally:
            await c.stop()

    run(t())


# ----------------------------------------------------------- pool rm


def test_pool_rm_requires_triple_interlock():
    """Pool deletion is gated like the reference: the
    mon_allow_pool_delete config flag, the name twice, and the
    --yes-i-really-really-mean-it literal — each missing piece is
    EPERM and the pool survives."""
    async def t():
        c = await make()
        try:
            # config flag off: refused regardless of confirmations
            rc, outs, _ = await c.client.mon_command(
                ["osd", "pool", "rm", "p", "p",
                 "--yes-i-really-really-mean-it"])
            assert rc == M.EPERM
            assert "mon_allow_pool_delete" in outs
            rc, _, _ = await c.client.mon_command(
                ["config", "set", "mon", "mon_allow_pool_delete",
                 "true"])
            assert rc == 0
            # flag on, but no / wrong confirmation: still refused
            rc, outs, _ = await c.client.mon_command(
                ["osd", "pool", "rm", "p"])
            assert rc == M.EPERM
            rc, _, _ = await c.client.mon_command(
                ["osd", "pool", "rm", "p", "q",
                 "--yes-i-really-really-mean-it"])
            assert rc == M.EPERM
            rc, _, _ = await c.client.mon_command(
                ["osd", "pool", "rm", "p", "p"])
            assert rc == M.EPERM
            assert 1 in c.mon.osdmap.pools
        finally:
            await c.stop()

    run(t())


def test_pool_rm_drops_pgs_and_objects():
    async def t():
        c = await make()
        try:
            for i in range(5):
                await c.client.write_full(1, f"del{i}", b"y" * 128)
            rc, _, _ = await c.client.mon_command(
                ["config", "set", "mon", "mon_allow_pool_delete",
                 "true"])
            assert rc == 0
            rc, _, _ = await c.client.mon_command(
                ["osd", "pool", "rm", "p", "p",
                 "--yes-i-really-really-mean-it"])
            assert rc == 0
            assert 1 not in c.mon.osdmap.pools
            # OSDs drop the pool's PGs + collections on the new epoch
            for _ in range(40):
                left = [k for o in c.osds if o is not None
                        for k in o.pgs if k[0] == 1]
                if not left:
                    break
                await asyncio.sleep(0.1)
            assert not left
            rc, _, _ = await c.client.mon_command(
                ["osd", "pool", "rm", "p", "p",
                 "--yes-i-really-really-mean-it"])
            assert rc == M.ENOENT
        finally:
            await c.stop()

    run(t())


def test_osd_df_and_upmap_commands():
    async def t():
        c = await make()
        try:
            for i in range(4):
                await c.client.write_full(1, f"d{i}", b"w" * 1000)
            rc, outs, outb = await c.client.mon_command(
                ["osd", "df"])
            assert rc == 0
            rows = json.loads(outb)
            assert len(rows) == 4
            # stats flow on the digest tick: poll until EVERY replica's
            # usage landed (a lone early heartbeat reports a partial
            # sum that would flake the assertion below)
            for _ in range(60):
                rc, _, outb = await c.client.mon_command(["osd", "df"])
                rows = json.loads(outb)
                if sum(r["used_bytes"] for r in rows) >= 4 * 1000:
                    break
                await asyncio.sleep(0.25)
            assert sum(r["used_bytes"] for r in rows) >= 4 * 1000
            assert all(r["pgs"] > 0 for r in rows)
            # upmap: swap one PG's replica, then clear it
            up, _ = c.mon.osdmap.pg_to_up_acting_osds((1, 0))
            absent = next(i for i in range(4) if i not in up)
            rc, outs, _ = await c.client.mon_command(
                ["osd", "pg-upmap-items", "1.0",
                 str(up[0]), str(absent)])
            assert rc == 0
            up2, _ = c.mon.osdmap.pg_to_up_acting_osds((1, 0))
            assert absent in up2 and up[0] not in up2
            rc, _, _ = await c.client.mon_command(
                ["osd", "rm-pg-upmap-items", "1.0"])
            assert rc == 0
            up3, _ = c.mon.osdmap.pg_to_up_acting_osds((1, 0))
            assert up3 == up
            # bad pgid -> -22, not a crash
            rc, _, _ = await c.client.mon_command(
                ["osd", "pg-upmap-items", "junk", "0", "1"])
            assert rc == -22
        finally:
            await c.stop()

    run(t())


def test_rados_namespaces_ioctx():
    """IoCtx namespace scoping (rados_ioctx_set_namespace role): same
    object names coexist per namespace; listings are scoped; the
    default namespace rejects the reserved lead byte."""
    async def t():
        c = await make(n_osds=3)
        try:
            blue = c.client.ioctx(1, "blue")
            green = c.client.ioctx(1, "green")
            await c.client.write_full(1, "obj", b"default")
            await blue.write_full(1, "obj", b"blue")
            await green.write_full(1, "obj", b"green")
            assert await c.client.read(1, "obj") == b"default"
            assert await blue.read(1, "obj") == b"blue"
            assert await green.read(1, "obj") == b"green"
            assert await blue.list_objects(1) == [b"obj"]
            assert sorted(await blue.ioctx(1).list_namespaces(1)) == [
                "", "blue", "green"]
            # xattrs/omap ride the same scoping
            await blue.setxattr(1, "obj", "k", b"v")
            assert await blue.getxattr(1, "obj", "k") == b"v"
            import pytest as _pt
            # missing xattr on an EXISTING object is ENODATA, not
            # KeyError (KeyError maps only from ENOENT; other callers
            # rely on the ENODATA distinction — see absent_attr)
            with _pt.raises(RadosError) as ei:
                await green.getxattr(1, "obj", "k")
            assert ei.value.code == RadosError.ENODATA
            # delete is scoped
            await blue.delete(1, "obj")
            with _pt.raises(KeyError):
                await blue.read(1, "obj")
            assert await green.read(1, "obj") == b"green"
            # default namespace: reserved byte refused
            with _pt.raises(ValueError):
                await c.client.ioctx(1).write_full(1, b"\x1ex", b"d")
        finally:
            await c.stop()

    run(t())


def test_rbd_pool_namespaces():
    """rbd pool namespaces: registry create/ls/rm, per-namespace image
    directories, and non-empty protection."""
    from ceph_tpu_torch.osdc.striper import FileLayout
    from ceph_tpu_torch.services import RBD

    lo = FileLayout(stripe_unit=8192, stripe_count=1,
                    object_size=8192)

    async def t():
        c = await make(n_osds=3)
        try:
            rbd = RBD(c.client, 1)
            await rbd.namespace_create("tenant-a")
            await rbd.namespace_create("tenant-b")
            assert await rbd.namespace_list() == ["tenant-a",
                                                  "tenant-b"]
            ra = RBD(c.client, 1, namespace="tenant-a")
            rb = RBD(c.client, 1, namespace="tenant-b")
            await rbd.create("disk", 16 * 1024, lo)
            await ra.create("disk", 16 * 1024, lo)  # same name, own ns
            await rb.create("other", 16 * 1024, lo)
            assert await rbd.list() == ["disk"]
            assert await ra.list() == ["disk"]
            assert await rb.list() == ["other"]
            ia = await ra.open("disk")
            await ia.write(0, b"tenant-a data")
            await ia.release_lock()
            i0 = await rbd.open("disk")
            assert await i0.read(0, 13) == b"\0" * 13  # isolated
            await i0.release_lock()
            # trash is per-namespace too
            tid = await ra.trash_move("disk")
            assert await ra.list() == [] and await rbd.list() == ["disk"]
            import pytest as _pt
            with _pt.raises(RuntimeError):  # trash entry keeps it busy
                await rbd.namespace_remove("tenant-a")
            await ra.trash_restore(tid)
            await ra.remove("disk")
            await rbd.namespace_remove("tenant-a")
            assert await rbd.namespace_list() == ["tenant-b"]
            with _pt.raises(RuntimeError):
                await rbd.namespace_remove("tenant-b")
        finally:
            await c.stop()

    run(t())
