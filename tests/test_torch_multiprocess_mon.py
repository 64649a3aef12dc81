"""The three mon-quorum cases of ``tests/test_multiprocess.py`` on the
port (``ceph_tpu_torch``): a ``ProcCluster`` of three Paxos mon processes
and three OSD processes, every one on ``device="cpu"``. The helpers are
``test_torch_multiprocess.py``'s. Copied with only their imports and
device changed and the outer deadlines cut (420 s and 300 s, and 480 s
for the mon command, to 200 s): the waits inside are the reference's
state polls (``wait_quorum``, ``wait_down``, ``wait_active``), each with
its own deadline. The reference's own words follow each case's name.
"""
import asyncio
import signal

from ceph_tpu_torch.cluster.procstart import ProcCluster
from ceph_tpu_torch.placement.osdmap import Pool
from test_torch_multiprocess import make, run, wait_quorum


def test_multiprocess_mon_leader_kill9(tmp_path):
    """Paxos over real sockets (VERDICT r4 #3): kill -9 the LEADER mon
    process mid-write-stream. The quorum re-elects, the public "mon"
    book alias hands over, in-flight IO completes, failure adjudication
    (an OSD kill) still commits new map epochs, and the revived mon
    catches up far enough to carry a later majority."""
    async def t():
        c = ProcCluster(str(tmp_path), n_osds=3, n_mons=3,
                        device="cpu")
        await c.start()
        try:
            # start()'s quorum wait is bounded best-effort (30 s):
            # under full-suite load mon boots stall past it, and the
            # pool create below then issues a paxos commit against an
            # UNFORMED quorum (the diagnosed mon-flake root) — make()
            # carries this guard, direct constructions need it too
            await wait_quorum(c.client, 3)
            await c.client.create_pool(
                Pool(id=1, name="p", size=3, pg_num=8, crush_rule=0))
            await c.wait_active(90)
            for i in range(5):
                await c.client.write_full(1, f"pre{i}", b"x" * 4096)

            leader = c.leader_mon_rank()
            c.kill_mon(leader, signal.SIGKILL)
            # client IO rides OSDs directly: the stream must keep
            # landing while the survivors elect
            for i in range(5):
                await c.client.write_full(1, f"mid{i}", b"y" * 4096)
            # a map MUTATION needs a live quorum: kill an OSD and wait
            # for the down mark (heartbeat adjudication -> Paxos commit
            # by the NEW leader)
            c.kill_osd(2, signal.SIGKILL)
            await c.wait_down(2, 60)
            new_leader = c.leader_mon_rank()
            assert new_leader != leader
            for i in range(5):
                assert await c.client.read(1, f"pre{i}") == b"x" * 4096
                assert await c.client.read(1, f"mid{i}") == b"y" * 4096

            await c.revive_osd(2)
            await c.wait_up(2, 60)
            await c.wait_active(120)

            # revived mon catches up from its durable store + collect
            # round: bring the old leader back, then kill the CURRENT
            # leader — the next majority (2/3) must include the revived
            # rank, so a successful quorum commit proves catch-up.
            # Deadline-poll the revived rank INTO the quorum before the
            # kill (a fixed sleep flaked under suite load: killing the
            # leader while the revived mon was still syncing left no
            # electable majority and the pool create timed out — the
            # long-standing "mon flake")
            await c.revive_mon(leader)
            await wait_quorum(c.client, 3, 90, require_rank=leader,
                              strict=True)
            current = c.leader_mon_rank()
            c.kill_mon(current, signal.SIGKILL)
            await c.client.create_pool(
                Pool(id=2, name="after", size=2, pg_num=4, crush_rule=0))
            await c.client.write_full(2, "obj", b"post-failover")
            assert await c.client.read(2, "obj") == b"post-failover"
        finally:
            await c.stop()

    run(t(), timeout=200)


def test_multiprocess_mon_peon_kill9(tmp_path):
    """kill -9 a PEON mon process: the quorum (leader + survivor)
    keeps committing with no election needed."""
    async def t():
        c = ProcCluster(str(tmp_path), n_osds=3, n_mons=3,
                        device="cpu")
        await c.start()
        try:
            # same unformed-quorum guard as make() / leader_kill9
            await wait_quorum(c.client, 3)
            await c.client.create_pool(
                Pool(id=1, name="p", size=3, pg_num=8, crush_rule=0))
            await c.wait_active(90)
            leader = c.leader_mon_rank()
            peon = next(r for r in range(3) if r != leader)
            c.kill_mon(peon, signal.SIGKILL)
            # both plain IO and quorum commits still work on 2/3
            await c.client.write_full(1, "obj", b"peonless")
            assert await c.client.read(1, "obj") == b"peonless"
            await c.client.create_pool(
                Pool(id=2, name="q", size=2, pg_num=4, crush_rule=0))
            await c.client.write_full(2, "obj2", b"committed")
            assert await c.client.read(2, "obj2") == b"committed"
            assert c.leader_mon_rank() == leader
        finally:
            await c.stop()

    run(t(), timeout=200)


def test_multiprocess_mon_command(tmp_path):
    """The `ceph` CLI seam over real sockets: MMonCommand rides
    NetBus to a mon PROCESS (forwarded to the paxos leader when it
    lands on a peon) and mutates the committed map."""
    import json

    import time

    async def t():
        c = await make(tmp_path, n_mons=3)
        try:
            # poll the status digest with a deadline: under full-suite
            # load a mon can answer before every peer joined the
            # quorum / every OSD booted, so a single read races
            # (num_mons came back 2-of-3 in the wild; 90 s: elections
            # among freshly spawned mon processes stall behind suite-
            # load compiles)
            deadline = time.monotonic() + 90
            while True:
                rc, outs, outb = await c.client.mon_command(["status"])
                assert rc == 0
                st = json.loads(outb)
                if (st["osdmap"]["num_up_osds"] == 3
                        and st["monmap"]["num_mons"] == 3):
                    break
                assert time.monotonic() < deadline, st
                await asyncio.sleep(0.25)
            rc, _, outb = await c.client.mon_command(["osd", "tree"])
            assert rc == 0
            rows = [n for n in json.loads(outb) if n["type"] == "osd"]
            assert len(rows) == 3
            # a mutating command commits through paxos quorum
            rc, _, _ = await c.client.mon_command(
                ["osd", "reweight", "2", "0.5"])
            assert rc == 0
            for _ in range(100):
                if (c.client.osdmap is not None
                        and c.client.osdmap.osds[2].weight == 0x8000):
                    break
                await asyncio.sleep(0.1)
            assert c.client.osdmap.osds[2].weight == 0x8000
            # quorum_status names a leader all ranks agree on (same
            # deadline poll: membership may still be converging)
            deadline = time.monotonic() + 90
            while True:
                rc, _, outb = await c.client.mon_command(["quorum_status"])
                q = json.loads(outb)
                if len(q["quorum"]) == 3:
                    break
                assert time.monotonic() < deadline, q
                await asyncio.sleep(0.25)
        finally:
            await c.stop()

    run(t())
