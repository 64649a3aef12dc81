"""The cluster cases of ``tests/test_trace.py`` on the port
(``ceph_tpu_torch``): a trace through an EC write and the admin socket's
tracing dump, each cluster on ``device="cpu"`` (the kernels' plain
versions). The reference's cases are copied with only their imports and
device changed. Tolerance: exact, as in the reference.
"""
import asyncio
import os

import torch

from ceph_tpu_torch.cluster import TestCluster
from ceph_tpu_torch.placement.osdmap import Pool
from ceph_tpu_torch.utils import trace

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)


def run(coro):
    asyncio.run(asyncio.wait_for(coro, 120))


def test_trace_propagates_through_ec_write():
    """One client write to an EC pool must produce client, pg.do_op and
    ec_sub_write spans sharing one trace id, parented as a tree."""
    async def t():
        c = TestCluster(n_osds=5, device="cpu")
        await c.start()
        await c.client.create_pool(
            Pool(id=2, name="ec", size=5, min_size=3, pg_num=4,
                 crush_rule=1, type="erasure",
                 ec_profile={"plugin": "rs_tpu", "k": "3", "m": "2"}))
        await c.wait_active(20)
        await c.client.write_full(2, b"traced-obj", b"z" * 20000)
        got = await c.client.read(2, b"traced-obj")
        assert got == b"z" * 20000
        await c.stop()

    run(t())
    client_spans = [s for s in trace.get_tracer("client.0").dump()
                    if s["name"] == "writefull"
                    and s["tags"].get("oid") == "traced-obj"]
    assert client_spans, "client span missing"
    root = client_spans[-1]
    spans = trace.dump_all()
    tree = [s for s in spans if s["traceId"] == root["traceId"]]
    names = {s["name"] for s in tree}
    assert "pg.do_op writefull" in names
    assert "ec_sub_write" in names
    # parenting: do_op under the client span, sub-writes under do_op
    do_op = next(s for s in tree if s["name"] == "pg.do_op writefull")
    assert do_op["parentId"] == root["id"]
    subs = [s for s in tree if s["name"] == "ec_sub_write"]
    assert subs and all(s["parentId"] == do_op["id"] for s in subs)
    # spans come from more than one daemon (distributed, not local)
    services = {s["localEndpoint"]["serviceName"] for s in tree}
    assert len(services) >= 3


def test_admin_socket_dump_tracing_and_exporter(tmp_path):
    async def t():
        c = TestCluster(n_osds=3, device="cpu")
        await c.start()
        await c.client.create_pool(
            Pool(id=1, name="rep", size=3, pg_num=4, crush_rule=0))
        await c.wait_active(20)
        await c.client.write_full(1, b"obj", b"x" * 500)
        sock_dir = str(tmp_path / "asok")
        os.makedirs(sock_dir)
        for i, osd in enumerate(c.osds):
            await osd.start_admin(os.path.join(sock_dir, f"osd.{i}.sock"))
        from ceph_tpu_torch.utils.admin import admin_command

        dumps = []
        for i in range(3):
            dumps.extend(await admin_command(
                os.path.join(sock_dir, f"osd.{i}.sock"), "dump_tracing"))
        assert any(s["name"].startswith("pg.do_op") for s in dumps)

        # the port's standalone exporter scrapes the same sockets
        from ceph_tpu_torch.tools import exporter

        text = await exporter.scrape(sock_dir)
        assert 'ceph_tpu_daemon_up{ceph_daemon="osd.1"} 1' in text
        assert "ceph_tpu_op" in text  # op counters made it through
        await c.stop()

    run(t())

