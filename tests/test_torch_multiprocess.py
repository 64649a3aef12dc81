"""The OSD, auth and EC cases of ``tests/test_multiprocess.py`` on the
port (``ceph_tpu_torch``): a ``ProcCluster`` of daemon processes
(``python -m ceph_tpu_torch.cluster.daemon``), every one on
``device="cpu"`` (the kernels' plain versions, torch on one thread), the
launcher's client too. The three mon-quorum cases are in
``test_torch_multiprocess_mon.py``, so that ``--dist loadfile`` puts the
two halves on two workers, and the two MDS cases
(``test_multiprocess_mds_kill9_replay``,
``test_multiprocess_multimds_pin_and_cross_rename``) are in
``test_torch_multiprocess_mds.py``. The cases are copied with only their imports and device changed, and the outer
deadline of each run cut from 480 s to 200 s (a port daemon starts in a
few seconds, a JAX one compiles). The reference's own words follow.

Multi-process cluster tier: mon + OSDs as separate OS processes over
real TCP sockets (the vstart.sh + qa/standalone role — VERDICT r3 #1).

What this tier proves that the in-process tier cannot: the wire is real
(kernel sockets, process isolation), kill -9 is a REAL crash (the
process dies mid-whatever, no cooperative cleanup), and revival is a
cold daemon start that must recover from its on-disk store.
"""
import asyncio
import os
import signal

import pytest
import torch

from ceph_tpu_torch.cluster.procstart import ProcCluster
from ceph_tpu_torch.placement.osdmap import Pool

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)


def run(coro, timeout=200):
    asyncio.run(asyncio.wait_for(coro, timeout))


async def wait_quorum(client, n_mons: int, deadline_s: float = 120.0,
                      require_rank: int | None = None,
                      strict: bool = False) -> None:
    """Deadline-poll quorum_status until n_mons ranks (optionally a
    specific one) sit in the quorum. Under full-suite load mon
    processes stall behind jax-import compiles, so a paxos commit
    issued on an unformed quorum times out — the long-standing mon
    flake. ``strict`` asserts at the deadline; otherwise the caller's
    own retries get their chance."""
    import json as _json
    import time as _time

    deadline = _time.monotonic() + deadline_s
    while True:
        try:
            _, _, outb = await client.mon_command(["quorum_status"])
            q = _json.loads(outb)["quorum"]
            if len(q) == n_mons and (require_rank is None
                                     or require_rank in q):
                return
        except (IOError, asyncio.TimeoutError):
            pass
        if _time.monotonic() >= deadline:
            assert not strict, \
                f"quorum of {n_mons} (rank {require_rank}) never formed"
            return
        await asyncio.sleep(0.25)


async def make(tmp, n_osds=3, n_mons=1, auth=False, secure=False):
    c = ProcCluster(str(tmp), n_osds=n_osds, n_mons=n_mons,
                    auth=auth, secure=secure, device="cpu")
    await c.start()
    if n_mons > 1:
        # ProcCluster.start's quorum wait is bounded best-effort
        # (30 s): make sure the quorum actually FORMED before the
        # first pool create issues a paxos commit
        await wait_quorum(c.client, n_mons)
    await c.client.create_pool(
        Pool(id=1, name="p", size=3, pg_num=8, crush_rule=0))
    await c.wait_active(120)
    return c


def test_multiprocess_io_roundtrip(tmp_path):
    """Write/read through real sockets: client process -> OSD
    processes, replicated pool."""
    async def t():
        c = await make(tmp_path)
        try:
            payload = {f"obj{i}": os.urandom(2000 + 37 * i)
                       for i in range(12)}
            for name, data in payload.items():
                await c.client.write_full(1, name, data)
            for name, data in payload.items():
                assert await c.client.read(1, name) == data
            listed = await c.client.list_objects(1)
            assert sorted(listed) == sorted(
                n.encode() for n in payload)
        finally:
            await c.stop()

    run(t())


def test_multiprocess_kill9_and_revive(tmp_path):
    """kill -9 an OSD *process*; the mon marks it down, IO keeps
    working degraded; a cold restart mounts the same store and the
    cluster heals with no lost data."""
    async def t():
        c = await make(tmp_path)
        try:
            data = {f"k{i}": os.urandom(4096) for i in range(10)}
            for n, d in data.items():
                await c.client.write_full(1, n, d)
            c.kill_osd(1, signal.SIGKILL)
            await c.wait_down(1, 80)
            # degraded reads AND writes still serve
            for n, d in data.items():
                assert await c.client.read(1, n) == d
            await c.client.write_full(1, "while-down", b"degraded")
            await c.revive_osd(1)
            await c.wait_up(1, 80)
            await c.wait_active(90)
            for n, d in data.items():
                assert await c.client.read(1, n) == d
            assert await c.client.read(1, "while-down") == b"degraded"
        finally:
            await c.stop()

    run(t())


def test_multiprocess_full_restart_durability(tmp_path):
    """Stop EVERY process; restart the whole cluster from disk; the
    pool and its objects survive (the durable-store + mon-store
    cold-boot arc, end to end over processes)."""
    async def t():
        c = await make(tmp_path)
        await c.client.write_full(1, "persist", b"x" * 10_000)
        await c.stop()

        c2 = ProcCluster(str(tmp_path), n_osds=3, n_mons=1,
                         device="cpu")
        await c2.start()
        try:
            await c2.wait_active(120)
            assert await c2.client.read(1, "persist") == b"x" * 10_000
            await c2.client.write_full(1, "again", b"second life")
            assert await c2.client.read(1, "again") == b"second life"
        finally:
            await c2.stop()

    run(t())


def test_multiprocess_cephx_secure(tmp_path):
    """The same tier with cephx auth + AES-GCM secure wire on."""
    pytest.importorskip("cryptography")
    async def t():
        c = await make(tmp_path, auth=True, secure=True)
        try:
            await c.client.write_full(1, "sec", b"over-encrypted-tcp")
            assert await c.client.read(1, "sec") == b"over-encrypted-tcp"
        finally:
            await c.stop()

    run(t())


def test_multiprocess_entity_auth_blocks_impersonation(tmp_path):
    """Per-entity wire auth (VERDICT r4 #5): a rogue process that holds
    ONLY the shared node key (so it passes the connection handshake)
    must not be able to speak AS "mon" — neither through the API (no
    signing key) nor by forging an envelope signed with the node key
    (receivers verify against the claimed src entity's own key)."""
    async def t():
        import copy

        from ceph_tpu_torch.cluster import messages as M
        from ceph_tpu_torch.cluster.daemon import load_keyring
        from ceph_tpu_torch.msg.auth import KeyServer
        from ceph_tpu_torch.msg.netbus import NetBus, _env_sig
        from ceph_tpu_torch.placement import encoding as menc

        c = await make(tmp_path, auth=True)
        try:
            await c.client.write_full(1, "legit", b"ok")

            full_keys = load_keyring(c.book)
            rogue_keys = KeyServer()
            rogue_keys.add("node", full_keys.get("node"))
            rogue = NetBus(c.book, keys=rogue_keys)
            await rogue.start()
            try:
                # (a) the honest API cannot even sign as the mon
                with pytest.raises(Exception):
                    await rogue.send("mon", "osd.0",
                                     M.MPing(osd=0, epoch=1))
                # (b) forged envelope: a poisoned full map (huge epoch,
                # osd.1 marked down) signed with the NODE key under
                # src="mon" — the OSD must drop it at the door
                poisoned = copy.deepcopy(c.client.osdmap)
                poisoned.epoch += 50
                poisoned.osds[1].up = False
                msg = M.MOSDMapMsg(
                    full=menc.encode_osdmap(poisoned),
                    incrementals=[], epoch=poisoned.epoch)
                payload = msg.encode()
                env = M.MEnvelope(
                    src="mon", dst="osd.0", mtype=M.MOSDMapMsg.TYPE,
                    payload=payload,
                    sig=_env_sig(full_keys.get("node"), "mon", "osd.0",
                                 M.MOSDMapMsg.TYPE, payload))
                addr = rogue._resolve("osd.0")
                node = f"@{addr[0]}:{addr[1]}"
                rogue._tcp.addrbook[node] = addr
                await rogue._tcp.send(node, env)
                await asyncio.sleep(0.5)
            finally:
                await rogue.close()

            # the cluster never saw the forgery: osd.1 stays up and IO
            # keeps working on sane epochs
            await c.client.write_full(1, "after", b"still-works")
            assert await c.client.read(1, "after") == b"still-works"
            await c._refresh_map()
            assert c.client.osdmap.osds[1].up
            assert c.client.osdmap.epoch < 50
        finally:
            await c.stop()

    run(t())


def test_multiprocess_ec_pool(tmp_path):
    """EC k=2,m=1 pool across OSD processes: encode on the primary's
    process, shard sub-writes over real sockets, degraded read after a
    process kill."""
    async def t():
        c = ProcCluster(str(tmp_path), n_osds=4, device="cpu")
        await c.start()
        try:
            await c.client.create_pool(Pool(
                id=2, name="ec", size=3, min_size=2, pg_num=4,
                crush_rule=1, type="erasure",
                ec_profile={"plugin": "rs_tpu", "k": "2", "m": "1"}))
            await c.wait_active(90)
            blob = os.urandom(40_000)
            await c.client.write_full(2, "ec-obj", blob)
            assert await c.client.read(2, "ec-obj") == blob
            # kill a shard holder; reconstruction serves the read
            pgid = c.client.osdmap.object_to_pg(2, b"ec-obj")
            acting, _ = c.client.osdmap.pg_to_up_acting_osds(pgid)
            c.kill_osd(acting[1], signal.SIGKILL)
            await c.wait_down(acting[1], 40)
            assert await c.client.read(2, "ec-obj") == blob
        finally:
            await c.stop()

    run(t())
