"""The cases of ``tests/test_write_pipeline.py`` on the port (``ceph_tpu_torch``),
each cluster on ``device="cpu"`` (the kernels' plain versions), copied
with only their imports and device changed; the reference's bounds
stay as they are. The reference's own words follow.

End-to-end write-path pipelining (client op windows, corked wire
batching, store group commit).

Three layers, one contract each:
- the client aio window honors ``client_max_inflight`` as real
  backpressure, completes ops on one object in submission order, and
  keeps the tick-resend machinery working per-op inside the window;
- the corked TcpMessenger writer coalesces N queued frames into one
  write + one drain, preserves per-pair ordering (secure mode's
  counter nonces included), and surfaces SendError to exactly the
  caller whose message rode the failed burst; LocalBus's in-process
  cork keeps FIFO and counts burst occupancy;
- store group commit flushes/fsyncs ONCE per window of transactions,
  fires on_commit only after the group's barrier, and a crash between
  append and flush replays to a clean prefix.
"""
import asyncio
import os
import shutil

import pytest

from ceph_tpu_torch.cluster import TestCluster
from ceph_tpu_torch.cluster import messages as M
from ceph_tpu_torch.msg.messenger import LocalBus, SendError, TcpMessenger
from ceph_tpu_torch.placement.osdmap import Pool
from ceph_tpu_torch.store import transaction as tx
from ceph_tpu_torch.store.walstore import WalStore
import torch

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)


def run(coro):
    asyncio.run(asyncio.wait_for(coro, 120))


async def make_rep_cluster(n=4, **kw):
    c = TestCluster(n_osds=n, **kw, device="cpu")
    await c.start()
    await c.client.create_pool(
        Pool(id=1, name="rep", size=3, pg_num=8, crush_rule=0))
    await c.wait_active(20)
    return c


# ------------------------------------------------------ client op window


def test_aio_window_backpressure_and_occupancy():
    """client_max_inflight is a hard budget: a submitter pushing 12 ops
    through a 4-slot window never observes more than 4 in flight, and
    the occupancy stats prove the window actually ran full."""
    async def t():
        c = await make_rep_cluster()
        c.client.conf.set("client_max_inflight", 4)
        comps = []
        for i in range(12):
            comps.append(await c.client.aio_write_full(
                1, f"w{i}", b"x" * 1024))
            assert c.client._aio_inflight <= 4
        await c.client.writes_wait()
        for comp in comps:
            comp.result()  # raises if any write failed
        ws = c.client.window_stats
        assert ws["max"] <= 4
        assert ws["count"] == 12
        assert ws["sum"] / ws["count"] > 1.0  # pipelined, not serial
        for i in range(12):
            assert await c.client.read(1, f"w{i}") == b"x" * 1024
        await c.stop()

    run(t())


def test_aio_per_object_completion_order():
    """Ops on ONE object execute and complete in submission order;
    the object ends with the last submission's bytes."""
    async def t():
        c = await make_rep_cluster()
        c.client.conf.set("client_max_inflight", 8)
        order = []
        comps = []
        for i in range(6):
            comp = await c.client.aio_write_full(
                1, "same", f"payload-{i}".encode())
            comp._fut.add_done_callback(
                lambda _f, i=i: order.append(i))
            comps.append(comp)
        await c.client.writes_wait()
        for comp in comps:
            comp.result()
        assert order == sorted(order), order
        assert await c.client.read(1, "same") == b"payload-5"
        await c.stop()

    run(t())


def test_aio_resend_inside_window():
    """The tick-resend machinery keeps working per-op INSIDE the
    window: ops submitted into a partition complete after heal, via
    resends, with no outside intervention."""
    async def t():
        c = await make_rep_cluster()
        c.client.conf.set("client_max_inflight", 8)
        c.client.conf.set("client_backoff_max", 0.5)
        c.client.op_timeout = 30.0
        before = c.client.op_retries
        c.faults.net.partition({"client.0"}, {"*"})
        comps = [await c.client.aio_write_full(1, f"p{i}", b"y" * 512)
                 for i in range(4)]
        await asyncio.sleep(1.0)
        assert not any(comp.done() for comp in comps)
        c.faults.net.heal()
        await c.client.writes_wait()
        for comp in comps:
            comp.result()
        assert c.client.op_retries > before
        for i in range(4):
            assert await c.client.read(1, f"p{i}") == b"y" * 512
        await c.stop()

    run(t())


# -------------------------------------------------- corked wire batching


async def _tcp_pair(got, done_at, keys=None, secure=False):
    async def dispatch(src, msg):
        got.append(msg)
        if len(got) >= done_at[0]:
            done_at[1].set()

    async def drop(src, msg):
        pass

    a = TcpMessenger("client.1", drop, keys=keys, secure=secure)
    b = TcpMessenger("osd.0", dispatch, keys=keys, secure=secure)
    host, port = await b.listen()
    a.addrbook["osd.0"] = (host, port)
    return a, b


def test_corked_writer_coalesces_frames():
    """N concurrently queued frames reach the peer in order through
    FEWER than N drain barriers (frames_per_drain > 1)."""
    async def t():
        got, done = [], (20, asyncio.Event())
        a, b = await _tcp_pair(got, done)
        await asyncio.gather(*(
            a.send("osd.0", M.MOSDBoot(osd=i)) for i in range(20)))
        await asyncio.wait_for(done[1].wait(), 5)
        assert [m.osd for m in got] == list(range(20))  # per-pair FIFO
        assert a.frames_sent == 20
        assert a.drains < 20, (a.drains, a.frames_sent)
        assert a.frames_per_drain > 1.0
        await a.close()
        await b.close()

    run(t())


def _have_aesgcm() -> bool:
    try:
        from cryptography.hazmat.primitives.ciphers.aead import (  # noqa
            AESGCM)
        return True
    except Exception:
        return False


@pytest.mark.parametrize("secure", [
    False,
    pytest.param(True, marks=pytest.mark.skipif(
        not _have_aesgcm(),
        reason="secure mode needs the cryptography package")),
])
def test_corked_writer_authed_ordering(secure):
    """Signing/encryption happen in the writer task in queue order:
    per-frame HMACs (and, with AES-GCM available, secure mode's
    counter nonces) survive corking — an out-of-order encrypt would be
    rejected as a replay by the peer."""
    async def t():
        from ceph_tpu_torch.msg.auth import KeyServer

        keys = KeyServer()
        keys.add("client.1", b"k" * 16)
        keys.add("osd.0", b"o" * 16)
        got, done = [], (16, asyncio.Event())
        a, b = await _tcp_pair(got, done, keys=keys, secure=secure)
        await asyncio.gather(*(
            a.send("osd.0", M.MOSDBoot(osd=i)) for i in range(16)))
        await asyncio.wait_for(done[1].wait(), 5)
        assert [m.osd for m in got] == list(range(16))
        assert a.drains < 16
        await a.close()
        await b.close()

    run(t())


def test_corked_writer_senderror_reaches_caller():
    """Every message riding a burst that cannot connect fails ITS
    caller with SendError — no silent drops, no hung futures."""
    async def t():
        async def drop(src, msg):
            pass

        a = TcpMessenger("client.1", drop)
        a.addrbook["osd.9"] = ("127.0.0.1", 1)  # nothing listens
        results = await asyncio.gather(
            *(a.send("osd.9", M.MOSDBoot(osd=i)) for i in range(5)),
            return_exceptions=True)
        assert all(isinstance(r, SendError) for r in results), results
        await a.close()

    run(t())


def test_localbus_cork_fifo_and_burst_counters():
    """Same-tick LocalBus sends to one destination ride one delivery
    burst, in order."""
    async def t():
        got = []

        async def handler(src, msg):
            got.append(msg.osd)

        bus = LocalBus()
        bus.register("osd.0", handler)
        bus.register("client.0", handler)
        for i in range(10):
            await bus.send("client.0", "osd.0", M.MOSDBoot(osd=i))
        await bus.drain()
        assert got == list(range(10))
        assert bus.delivery_bursts == 1
        assert bus.frames_delivered == 10
        assert bus.frames_per_drain == 10.0

    run(t())


# ------------------------------------------------------ store group commit


def _txn(i: int, cid="c") -> tx.Transaction:
    t = tx.Transaction()
    t.write(cid, b"o%d" % i, 0, b"v" * 512)
    return t


def test_walstore_group_commit_fsyncs_once_per_group(tmp_path,
                                                     monkeypatch):
    """20 transactions inside one commit window pay ~1 fsync, not 20;
    the per-txn store pays 20. Counters prove the grouping."""
    import ceph_tpu_torch.store.walstore as ws_mod

    fsyncs = []
    real_fsync = os.fsync
    monkeypatch.setattr(ws_mod.os, "fsync",
                        lambda fd: (fsyncs.append(fd),
                                    real_fsync(fd))[1])

    s = WalStore(str(tmp_path / "grouped"), fsync=True,
                 commit_window_ms=2000.0, commit_max_txns=64)
    s.mount()
    t0 = tx.Transaction()
    t0.create_collection("c")
    s.queue_transaction(t0)
    for i in range(20):
        s.queue_transaction(_txn(i))
    s._committer.flush_now()
    grouped_fsyncs = len(fsyncs)
    st = s.commit_stats
    assert st.txns == 21
    assert st.commits < 21
    assert st.txns / st.commits > 1.0
    assert st.commits_grouped >= 1
    s.umount()
    assert grouped_fsyncs <= 3  # mount-side + the group barriers

    fsyncs.clear()
    s2 = WalStore(str(tmp_path / "perTxn"), fsync=True)
    s2.mount()
    t0 = tx.Transaction()
    t0.create_collection("c")
    s2.queue_transaction(t0)
    for i in range(20):
        s2.queue_transaction(_txn(i))
    assert len(fsyncs) >= 21  # one barrier per transaction
    assert s2.commit_stats.txns / s2.commit_stats.commits == 1.0
    s2.umount()


def test_walstore_group_commit_on_commit_after_flush(tmp_path):
    """on_commit fires only at the group boundary — never before the
    flush that makes the transaction durable."""
    s = WalStore(str(tmp_path / "s"), commit_window_ms=60000.0,
                 commit_max_txns=1000)
    s.mount()
    fired = []
    t0 = tx.Transaction()
    t0.create_collection("c")
    s.queue_transaction(t0, lambda: fired.append(0))
    s._committer.flush_now()
    assert fired == [0]
    s.queue_transaction(_txn(1), lambda: fired.append(1))
    s.queue_transaction(_txn(2), lambda: fired.append(2))
    assert fired == [0]  # pending: window far away, no flush yet
    # reads see the committed-to-memory state before the barrier
    assert s.read("c", b"o1") == b"v" * 512
    s._committer.flush_now()
    assert fired == [0, 1, 2]
    s.umount()


def test_walstore_group_commit_crash_replays_flushed_prefix(tmp_path):
    """Crash between append and flush: the copy-at-crash image mounts
    clean and serves exactly the flushed prefix (unflushed tail
    discarded, its on_commit never fired — the acked/unacked line)."""
    src = tmp_path / "src"
    s = WalStore(str(src), commit_window_ms=60000.0,
                 commit_max_txns=1000)
    s.mount()
    acked = []
    t0 = tx.Transaction()
    t0.create_collection("c")
    s.queue_transaction(t0)
    s.queue_transaction(_txn(1), lambda: acked.append(1))
    s._committer.flush_now()  # txn 1 durable + acked
    s.queue_transaction(_txn(2), lambda: acked.append(2))  # buffered
    assert acked == [1]
    crash = tmp_path / "crash"
    shutil.copytree(src, crash)  # the disk at power-cut time
    s._committer.flush_now()
    s.umount()

    s2 = WalStore(str(crash))
    s2.mount()
    assert s2.read("c", b"o1") == b"v" * 512  # acked write survived
    # the unacked tail either replayed whole or vanished whole — a
    # torn record must never half-apply
    try:
        data = s2.read("c", b"o2")
        assert data == b"v" * 512
    except Exception:
        pass  # discarded with the torn tail: fine, it was never acked
    s2.umount()


def test_bluestore_group_commit_read_your_write_and_batching(tmp_path):
    """BlueStoreLite grouped mode: deferred small overwrites stay
    readable through the pending-patch overlay before the group
    flushes, kv batches drop below one-per-txn, and a clean remount
    serves the grouped writes."""
    from ceph_tpu_torch.store.bluestore import BlueStoreLite

    s = BlueStoreLite(str(tmp_path / "bs"), size=16 << 20,
                      commit_window_ms=2000.0, commit_max_txns=64)
    s.mount()
    batches = []
    real_batch = s.kv.batch
    s.kv.batch = lambda ops: (batches.append(len(ops)),
                              real_batch(ops))[1]
    t0 = tx.Transaction()
    t0.create_collection("c")
    s.queue_transaction(t0)
    base = bytes(range(256)) * 32  # 8 KiB
    t1 = tx.Transaction()
    t1.write("c", b"obj", 0, base)
    s.queue_transaction(t1)
    # small partial overwrite of a committed block -> deferred patch
    s._committer.flush_now()
    t2 = tx.Transaction()
    t2.write("c", b"obj", 100, b"PATCH")
    s.queue_transaction(t2)
    want = base[:100] + b"PATCH" + base[105:]
    assert s.read("c", b"obj") == want  # overlay serves the patch
    kv_batches_before_flush = len(batches)
    s._committer.flush_now()
    assert s.read("c", b"obj") == want  # device serves it after
    assert kv_batches_before_flush < 3
    st = s.commit_stats
    assert st.txns == 3
    assert st.commits <= st.txns
    s.umount()

    s2 = BlueStoreLite(str(tmp_path / "bs"), size=16 << 20)
    s2.mount()
    assert s2.read("c", b"obj") == want
    s2.umount()


def test_cluster_acks_wait_for_group_flush(tmp_path):
    """With a commit window armed, a client write is acked only after
    every shard's group flushed — an ack outrunning the flush would
    let a crash lose acked bytes (the acked-write-loss class the
    thrasher exists to catch)."""
    async def t():
        c = TestCluster(n_osds=4, objectstore="walstore",
                        data_dir=str(tmp_path), compression=None,
                        commit_window_ms=60000.0,
                        commit_max_txns=10_000, device="cpu")
        await c.start()
        await c.client.create_pool(
            Pool(id=1, name="rep", size=3, pg_num=4, crush_rule=0))
        await c.wait_active(20)
        comp = await c.client.aio_write_full(1, "durable", b"d" * 2048)
        await asyncio.sleep(0.8)
        # the window is an hour away and nothing forced a flush: the
        # ack must still be pending
        assert not comp.done()
        for _ in range(200):
            for s in c.stores:
                s._committer.flush_now()
            if comp.done():
                break
            await asyncio.sleep(0.05)
        await comp.wait()
        assert await c.client.read(1, "durable") == b"d" * 2048
        await c.stop()

    run(t())


# --------------------------------------------------- cluster-level smoke


def test_cluster_over_walstore_group_commit(tmp_path):
    """The whole write path — aio window, corked LocalBus, EC fan-out,
    group-commit walstore — serves byte-exact reads."""
    async def t():
        c = TestCluster(n_osds=5, objectstore="walstore",
                        data_dir=str(tmp_path), compression=None,
                        commit_window_ms=5.0, commit_max_txns=32, device="cpu")
        await c.start()
        await c.client.create_pool(
            Pool(id=2, name="ec", size=5, min_size=3, pg_num=8,
                 crush_rule=1, type="erasure",
                 ec_profile={"plugin": "rs_tpu", "k": "3", "m": "2"}))
        await c.wait_active(20)
        c.client.conf.set("client_max_inflight", 8)
        payload = os.urandom(1 << 16)
        comps = [await c.client.aio_write_full(2, f"g{i}", payload)
                 for i in range(16)]
        await c.client.writes_wait()
        for comp in comps:
            comp.result()
        for i in range(16):
            assert await c.client.read(2, f"g{i}") == payload
        grouped = sum(s.commit_stats.commits_grouped for s in c.stores)
        txns = sum(s.commit_stats.txns for s in c.stores)
        commits = sum(s.commit_stats.commits for s in c.stores)
        assert txns > 0 and commits > 0
        assert grouped >= 1 or txns == commits  # grouping is load-dependent
        await c.stop()

    run(t())
