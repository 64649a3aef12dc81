"""The cases of ``tests/test_mgr.py`` on the port (``ceph_tpu_torch``),
each cluster on ``device="cpu"`` (the kernels' plain versions), copied
with only their imports and device changed. The drop-in module it writes
imports the port's ``MgrModule``. The reference's own words follow.

MgrLite + OpTracker tests (DaemonServer/ClusterState, prometheus
exporter, OpRequest dump_historic_ops roles)."""
import asyncio

from ceph_tpu_torch.cluster.vstart import TestCluster
from ceph_tpu_torch.placement.osdmap import Pool
from ceph_tpu_torch.utils.admin import admin_command
import torch

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)


def run(coro):
    asyncio.run(asyncio.wait_for(coro, 120))


async def make():
    c = TestCluster(n_osds=4, device="cpu")
    await c.start()
    await c.client.create_pool(
        Pool(id=1, name="p", size=3, pg_num=8, crush_rule=0)
    )
    await c.wait_active(20)
    return c


def test_mgr_status_and_health():
    async def t():
        c = await make()
        for i in range(5):
            await c.client.write_full(1, f"o{i}", b"x" * 100)
        await asyncio.sleep(c.hb_interval * 3)  # reports flow on hb
        st = c.mgr.status()
        assert st["osds"] == {"total": 4, "up": 4, "in": 4}
        assert st["pools"] == 1
        assert st["pgs"].get("active", 0) > 0
        assert st["client_ops_total"] >= 5
        assert st["health"] == "HEALTH_OK"
        # kill an OSD: health degrades to WARN with OSD_DOWN
        await c.kill_osd(3)
        await c.wait_down(3, 20)
        h = c.mgr.health()
        assert h["status"] == "HEALTH_WARN"
        assert "OSD_DOWN" in h["checks"]
        await c.stop()

    run(t())


def test_mgr_prometheus_exposition(tmp_path):
    async def t():
        c = await make()
        await c.client.write_full(1, "obj", b"data")
        await asyncio.sleep(c.hb_interval * 3)
        await c.mgr.start_admin(str(tmp_path / "mgr.sock"))
        text = await admin_command(c.mgr.admin.path, "prometheus")
        assert 'ceph_osd_up{osd="0"} 1' in text
        assert "ceph_osd_op_total" in text
        assert 'ceph_pg_states{state="active"}' in text
        status = await admin_command(c.mgr.admin.path, "status")
        assert status["osds"]["up"] == 4
        health = await admin_command(c.mgr.admin.path, "health")
        assert health["status"] == "HEALTH_OK"
        await c.stop()

    run(t())


def test_optracker_timelines(tmp_path):
    async def t():
        c = await make()
        for i in range(3):
            await c.client.write_full(1, f"t{i}", b"payload")
            await c.client.read(1, f"t{i}")
        # find the OSD(s) that served ops and check their history
        total_hist = 0
        for osd in c.osds:
            hist = osd.optracker.dump_historic_ops()
            total_hist += hist["num_ops"]
            for op in hist["ops"]:
                events = [e["event"] for e in op["events"]]
                assert events[0] == "queued"
                assert "dequeued" in events
                assert events[-1] == "done"
                assert op["duration"] is not None
                assert "osd_op" in op["description"]
            assert osd.optracker.dump_ops_in_flight()["num_ops"] == 0
        assert total_hist >= 6
        # admin socket surface
        osd = next(o for o in c.osds
                   if o.optracker.dump_historic_ops()["num_ops"])
        await osd.start_admin(str(tmp_path / "osd.sock"))
        dump = await admin_command(osd.admin.path, "dump_historic_ops")
        assert dump["num_ops"] >= 1
        await c.stop()

    run(t())


THIRD_PARTY_MODULE = '''
"""A third-party mgr module (drop-in file format)."""
from ceph_tpu_torch.cluster.mgr_module import MgrModule


class Module(MgrModule):
    COMMANDS = [{"cmd": "hello world", "desc": "demo command"}]

    def __init__(self, name, host):
        super().__init__(name, host)
        self.notifies = []

    def notify(self, what, ident):
        self.notifies.append((what, ident))

    async def serve(self):
        await self.set_store("served", "yes")

    async def handle_command(self, cmd, args):
        osdmap = self.get("osd_map")
        return {"greeting": args.get("name", "world"),
                "osds": osdmap.n_osds,
                "served": self.get_store("served"),
                "notified": bool(self.notifies)}
'''


def test_mgr_module_host_drop_in(tmp_path):
    """A third-party module FILE drops into a directory and runs
    (ActivePyModules role): its command registers on the admin socket,
    serve() runs, notify() fires on reports, and set_store/get_store
    persist through the mon's config DB."""
    async def t():
        mod_dir = tmp_path / "modules"
        mod_dir.mkdir()
        (mod_dir / "hello.py").write_text(THIRD_PARTY_MODULE)

        c = await make()
        loaded = c.mgr.load_modules_from(mod_dir)
        assert loaded == ["hello"]
        # builtins run as modules too — the substrate, not hardcoded
        assert {"balancer", "pg_autoscaler", "prometheus"} \
            <= set(c.mgr.modules)
        await asyncio.sleep(0.6)  # serve() ran; a report tick arrived
        await c.mgr.start_admin(str(tmp_path / "mgr.sock"))
        out = await admin_command(c.mgr.admin.path, "hello world",
                                  name="ceph")
        assert out["greeting"] == "ceph"
        assert out["osds"] == 4
        assert out["served"] == "yes"  # set_store -> config DB -> back
        assert out["notified"]  # notify() delivered
        mods = await admin_command(c.mgr.admin.path, "mgr modules")
        assert "hello" in mods
        await c.stop()

    run(t())


def test_mgr_module_store_survives_mgr_restart(tmp_path):
    """Module KV (set_store/get_store) lives in the mon's central
    config DB, so a fresh mgr instance sees it (MonKVStore role)."""
    async def t():
        c = await make()
        await c.mgr.modules["pg_autoscaler"].set_store("marker", "42")
        await asyncio.sleep(0.3)

        from ceph_tpu_torch.cluster.mgr import MgrLite

        await c.mgr.stop()
        mgr2 = MgrLite(c.bus, c.mgr.mon)
        await mgr2.start()
        await asyncio.sleep(1.2)  # subscribe -> MConfig push lands
        assert mgr2.modules["pg_autoscaler"].get_store("marker") == "42"
        c.mgr = mgr2  # let cluster teardown stop the new instance
        await c.stop()

    run(t())


def test_dashboard_module():
    """The dashboard mgr module serves the read-only web UI + JSON API
    (src/pybind/mgr/dashboard monitoring-slice role)."""
    async def t():
        c = await make()
        await c.client.write_full(1, "obj", b"data")
        await asyncio.sleep(c.hb_interval * 3)  # reports flow
        dash = c.mgr.modules["dashboard"]
        # opt-in like the reference: no socket until `dashboard start`
        assert dash.addr is None
        out = await c.mgr.dispatch_command("dashboard start", {})
        assert dash.addr is not None
        assert out["url"] == f"http://{dash.addr[0]}:{dash.addr[1]}/"

        async def get(path):
            r, w = await asyncio.open_connection(*dash.addr)
            w.write(f"GET {path} HTTP/1.1\r\nhost: x\r\n\r\n".encode())
            await w.drain()
            status = int((await r.readline()).split()[1])
            hdrs = {}
            while True:
                line = await r.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                k, v = line.decode().split(":", 1)
                hdrs[k.strip().lower()] = v.strip()
            body = await r.readexactly(int(hdrs.get("content-length",
                                                    "0")))
            w.close()
            return status, body

        code, body = await get("/")
        page = body.decode()
        assert code == 200 and "HEALTH_OK" in page
        assert "osd.3" in page and "active" in page
        import json as _json

        code, body = await get("/api/status")
        st = _json.loads(body)
        assert code == 200 and st["osds"]["up"] == 4
        code, body = await get("/api/osds")
        osds = _json.loads(body)
        assert len(osds) == 4 and all(o["up"] for o in osds)
        code, _ = await get("/nope")
        assert code == 404
        # degraded cluster renders the warning banner
        await c.kill_osd(3)
        await c.wait_down(3, 20)
        code, body = await get("/")
        assert b"HEALTH_WARN" in body and b"OSD_DOWN" in body
        # the `dashboard url` command answers with the bound address
        out = await c.mgr.dispatch_command("dashboard url", {})
        assert out["url"].startswith("http://127.0.0.1:")
        await c.stop()

    run(t())


def test_osd_bench_admin_command(tmp_path):
    """`ceph tell osd.N bench` role: raw store write throughput via
    the admin socket, scratch state cleaned up."""
    async def t():
        c = await make()
        osd = c.osds[0]
        await osd.start_admin(str(tmp_path / "osd.sock"))
        out = await admin_command(osd.admin.path, "bench",
                                  count=8, size=65536)
        assert out["bytes_written"] == 8 * 65536
        assert out["bytes_per_sec"] > 0 and out["iops"] > 0
        # scratch collection removed (unique per-invocation cid)
        assert not [cid for cid in osd.store.list_collections()
                    if str(cid).startswith(f"bench.{osd.id}")]
        # size clamp: an absurd request is bounded, not fatal
        out = await admin_command(osd.admin.path, "bench",
                                  count=2, size=1 << 30)
        assert out["blocksize"] == 4 << 20
        await c.stop()

    run(t())


def test_crash_module():
    """crash mgr module: post/ls/info/rm/prune + recent summary,
    persisted in the mon-backed module store."""
    async def t():
        c = await make()
        out = await c.mgr.dispatch_command(
            "crash post", {"entity": "osd.2",
                           "backtrace": "0x1 raise\n0x2 abort"})
        cid = out["crash_id"]
        ls = await c.mgr.dispatch_command("crash ls", {})
        assert [e["crash_id"] for e in ls] == [cid]
        info = await c.mgr.dispatch_command("crash info", {"id": cid})
        assert info["entity_name"] == "osd.2" \
            and "abort" in info["backtrace"]
        stat = await c.mgr.dispatch_command("crash stat", {})
        assert stat == {"total": 1, "recent": 1,
                        "health": "RECENT_CRASH"}
        # an ancient crash prunes; the fresh one survives
        import time as _t
        old = await c.mgr.dispatch_command(
            "crash post", {"entity": "osd.0",
                           "ts": _t.time() - 30 * 86400})
        out = await c.mgr.dispatch_command("crash prune",
                                           {"keep_days": 14})
        assert out == {"removed": 1}
        ls = await c.mgr.dispatch_command("crash ls", {})
        assert [e["crash_id"] for e in ls] == [cid]
        await c.mgr.dispatch_command("crash rm", {"id": cid})
        assert await c.mgr.dispatch_command("crash ls", {}) == []
        assert old["crash_id"]  # only shape-used above
        await c.stop()

    run(t())


def test_telemetry_module():
    """telemetry mgr module: opt-in state machine + anonymized report
    (shapes and counts, no pool names)."""
    async def t():
        c = await make()
        st = await c.mgr.dispatch_command("telemetry status", {})
        assert st == {"enabled": False, "last_report_at": None}
        rep = await c.mgr.dispatch_command("telemetry show", {})
        assert rep["osd"]["count"] == 4
        assert rep["pools"] and rep["pools"][0]["size"] == 3
        # anonymized: no pool names anywhere in the report
        import json as _json
        assert "'p'" not in str(rep) and '"p"' not in _json.dumps(rep)
        await c.mgr.dispatch_command("telemetry on", {})
        out = await c.mgr.dispatch_command("telemetry send", {})
        assert out["sent"]
        st = await c.mgr.dispatch_command("telemetry status", {})
        assert st["enabled"] and st["last_report_at"] is not None
        await c.mgr.dispatch_command("telemetry off", {})
        st = await c.mgr.dispatch_command("telemetry status", {})
        assert not st["enabled"]
        await c.stop()

    run(t())
