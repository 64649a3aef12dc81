"""The port's shared-memory ring messenger (``ceph_tpu_torch.msg.shmring``)
and latency histograms (``utils.lathist``): the ring and histogram units of
``test_fabric.py`` on the port, a port ShmMessenger and a JAX one talking
in both directions, and histograms equal to the JAX package's on the same
samples; and NetBus following the "mon" alias to its new holder. Ring
files live under ``tmp_path`` (CEPH_TPU_SHM_DIR); doorbell
sockets sit in Linux's abstract namespace, so no path length or leftover
file is at stake. Tolerance: exact equality. Every wait is bounded."""
import asyncio
import json
import os
import random

import pytest
import torch

from ceph_tpu.cluster import messages as JM
from ceph_tpu.msg.shmring import ShmMessenger as JShmMessenger
from ceph_tpu.utils.lathist import LatHist as JLatHist
from ceph_tpu_torch.cluster import messages as M
from ceph_tpu_torch.cluster.faults import NetFaultPolicy
from ceph_tpu_torch.msg.messenger import SendError
from ceph_tpu_torch.msg.shmring import ShmMessenger, ShmRing
from ceph_tpu_torch.utils.lathist import LatHist
from test_torch_native import jax_native_whole  # noqa: F401

torch.set_num_threads(1)


def run(coro, timeout: float = 30.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


@pytest.fixture(autouse=True)
def ring_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("CEPH_TPU_SHM_DIR", str(tmp_path))
    return tmp_path


def _sock(name: str) -> str:
    return f"\0ctsm-test-{os.getpid()}-{name}"


# ------------------------------------------------------------- ring units


def _ring_pair(tmp_path, slots=4, arena=1 << 16):
    path = str(tmp_path / "ring")
    prod = ShmRing(path, slots=slots, arena_bytes=arena, create=True)
    cons = ShmRing(path, slots=slots, arena_bytes=arena, create=False)
    return prod, cons


def test_ring_wraparound_reuses_slots_and_extents(tmp_path):
    prod, cons = _ring_pair(tmp_path, slots=4)
    for i in range(40):
        payload = bytes([i & 0xFF]) * (100 + i)
        assert prod.try_send([payload], mtype=7)
        msgs = cons.recv_all()
        assert len(msgs) == 1
        assert bytes(msgs[0].view) == payload and msgs[0].mtype == 7
        msgs[0].release()
    assert prod.sends == 40 and prod.backpressure_hits == 0
    prod.close(unlink=True)
    cons.close()
    assert not (tmp_path / "ring").exists()


def test_ring_full_backpressure_then_release_unblocks(tmp_path):
    prod, cons = _ring_pair(tmp_path, slots=4)
    for _ in range(4):
        assert prod.try_send([b"x" * 64], mtype=1)
    assert not prod.try_send([b"y" * 64], mtype=1)
    assert prod.backpressure_hits == 1
    msgs = cons.recv_all()
    assert len(msgs) == 4
    assert not prod.try_send([b"y" * 64], mtype=1)  # consumed, not released
    for m_ in msgs:
        m_.release()
    assert prod.try_send([b"y" * 64], mtype=1)
    got = cons.recv_all()
    assert len(got) == 1 and bytes(got[0].view) == b"y" * 64
    got[0].release()
    prod.close(unlink=True)
    cons.close()


def test_ring_arena_exhaustion_is_backpressure(tmp_path):
    prod, cons = _ring_pair(tmp_path, slots=64, arena=4096)
    assert prod.try_send([b"a" * 3000], mtype=1)
    assert not prod.try_send([b"b" * 3000], mtype=1)  # slots left, no arena
    for m_ in cons.recv_all():
        m_.release()
    assert prod.try_send([b"b", b"b" * 2999], mtype=1)  # two segments
    got = cons.recv_all()
    assert bytes(got[0].view) == b"b" * 3000
    got[0].release()
    prod.close(unlink=True)
    cons.close()


def test_ring_reclaim_after_peer_death_zombie_release_noop(tmp_path):
    """The ABA guard: a reclaimed slot's epoch moves on, so a zombie
    consumer's late release cannot free the slot's next occupant."""
    prod, cons = _ring_pair(tmp_path, slots=8)
    for i in range(5):
        assert prod.try_send([b"z" * 200], mtype=i)
    zombies = cons.recv_all()
    assert len(zombies) == 5
    assert prod.reclaim_dead() == 5 and prod.reclaimed_dead == 5
    for _ in range(8):
        assert prod.try_send([b"w" * 200], mtype=9)
    for z in zombies:
        z.release()
    assert not prod.try_send([b"v"], mtype=1)  # every slot still live
    fresh = cons.recv_all()
    assert len(fresh) == 8
    assert all(bytes(m_.view) == b"w" * 200 for m_ in fresh)
    for m_ in fresh:
        m_.release()
    assert prod.try_send([b"ok"], mtype=1)
    last = cons.recv_all()
    assert len(last) == 1 and bytes(last[0].view) == b"ok"
    last[0].release()
    prod.close(unlink=True)
    cons.close()


def test_ring_release_is_idempotent(tmp_path):
    prod, cons = _ring_pair(tmp_path, slots=2)
    assert prod.try_send([b"a"], mtype=1)
    (msg,) = cons.recv_all()
    msg.release()
    msg.release()
    assert bytes(msg.view) == b""
    assert prod.try_send([b"b"], mtype=1) and prod.try_send([b"c"], mtype=1)
    prod.close(unlink=True)
    cons.close()


# ---------------------------------------------------------- messengers


def test_shm_messenger_roundtrip_delivery():
    async def body():
        inbox_a, inbox_b = [], []

        async def da(src, msg):
            inbox_a.append((src, msg))

        async def db(src, msg):
            inbox_b.append((src, msg))

        a, b = ShmMessenger("a", da), ShmMessenger("b", db)
        sa, sb = await a.listen(_sock("a")), await b.listen(_sock("b"))
        try:
            for i in range(50):
                await a.send(sb, M.MPing(osd=i, epoch=i * 2))
            while len(inbox_b) < 50:
                await asyncio.sleep(0.01)
            src, last = inbox_b[-1]
            assert src == "a" and (last.osd, last.epoch) == (49, 98)
            assert [m.osd for _, m in inbox_b] == list(range(50))
            await b.send(sa, M.MPing(osd=7, epoch=1))
            while len(inbox_a) < 1:
                await asyncio.sleep(0.01)
            assert a.zero_copy_gathers == 50 and a.doorbells >= 1
        finally:
            await a.close()
            await b.close()

    run(body())


@pytest.mark.parametrize("port_side", ["sender", "receiver"])
def test_shm_messengers_of_both_packages_talk(port_side):
    """The ring layout, the JSON hello and the payload envelope are the
    same in both packages: a 1 MiB body and a reply cross either way."""
    tx_cls, rx_cls = ((ShmMessenger, JShmMessenger) if port_side == "sender"
                      else (JShmMessenger, ShmMessenger))
    tx_pkg, rx_pkg = (M, JM) if port_side == "sender" else (JM, M)

    async def body():
        got, back = [], []

        async def on_rx(src, msg):
            got.append((src, msg))
            await rx.send(_sock("tx"), rx_pkg.MECSubWriteReply(
                tid=msg.tid, pgid=msg.pgid, shard=msg.shard, result=0))

        async def on_tx(src, msg):
            back.append((src, msg))

        tx, rx = tx_cls("primary", on_tx), rx_cls("osd.4", on_rx)
        await tx.listen(_sock("tx"))
        await rx.listen(_sock("rx"))
        data = bytes(range(256)) * 4096
        try:
            for tid in range(3):
                await tx.send(_sock("rx"), tx_pkg.MECSubReadReply(
                    tid=tid, pgid=(2, 9), shard=4, result=0, data=data,
                    digest=tid, size=len(data), attrs={}, ver=(1, tid)))
            while len(back) < 3:
                await asyncio.sleep(0.01)
        finally:
            await tx.close()
            await rx.close()
        assert [m.tid for _, m in got] == [0, 1, 2]
        assert all(src == "primary" and bytes(m.data) == data
                   for src, m in got)
        assert sorted(m.tid for _, m in back) == [0, 1, 2]
        assert all(src == "osd.4" for src, _ in back)

    run(body())


def test_shm_send_to_a_missing_peer_raises():
    async def body():
        a = ShmMessenger("a", lambda s, m: None)
        with pytest.raises(SendError):
            await a.send(_sock("nobody"), M.MPing(osd=1, epoch=1))
        await a.close()

    run(body())


def test_shm_full_ring_past_its_deadline_raises():
    """A consumer that never drains: the producer backs off, then fails
    the send once its deadline passes instead of hanging."""
    async def body():
        b = ShmMessenger("b", lambda s, m: None)
        await b.listen(_sock("b"))
        a = ShmMessenger("a", lambda s, m: None, slots=2, arena_bytes=4096)
        b._drain_ring = lambda ring: asyncio.sleep(0)  # a stuck consumer
        try:
            await a.send(_sock("b"), M.MPing(osd=1, epoch=1))
            await a.send(_sock("b"), M.MPing(osd=2, epoch=1))
            with pytest.raises(SendError, match="full"):
                await a.send(_sock("b"), M.MPing(osd=3, epoch=1),
                             timeout=0.2)
        finally:
            await a.close()
            await b.close()

    run(body())


# ------------------------------------------------- histogram semantics


def test_lathist_merge_exact_where_averaging_is_wrong():
    a, b = LatHist(), LatHist()
    for _ in range(1000):
        a.note_ms(1.0)
    for _ in range(100):
        b.note_ms(100.0)
    pooled = sorted([1.0] * 1000 + [100.0] * 100)
    exact_p99 = pooled[int(0.99 * len(pooled))]
    merged = LatHist.merged([a, b])
    assert merged.count == 1100
    assert abs(merged.percentile(0.99) - exact_p99) / exact_p99 < 0.02
    averaged = (a.percentile(0.99) + b.percentile(0.99)) / 2
    assert abs(averaged - exact_p99) / exact_p99 > 0.4


def test_lathist_json_roundtrip_and_merge_associativity():
    hs = [LatHist() for _ in range(3)]
    for i, h in enumerate(hs):
        for j in range(50):
            h.note_ms(0.5 * (i + 1) * (j + 1))
    back = [LatHist.from_json(json.loads(json.dumps(h.to_json())))
            for h in hs]
    m1 = LatHist.merged(back)
    m2 = LatHist.merged([back[2], back[0], back[1]])
    assert m1.count == m2.count == 150
    for p in (0.5, 0.99, 0.999):
        assert m1.percentile(p) == m2.percentile(p)
    assert m1.total_ms == pytest.approx(sum(h.total_ms for h in hs))
    assert LatHist().percentile(0.5) == 0.0 and LatHist().mean_ms == 0.0


@pytest.mark.parametrize("seed", range(4))
def test_lathist_equals_the_reference_on_the_same_samples(seed):
    rng = random.Random(seed)
    port, jax = LatHist(), JLatHist()
    for _ in range(2000):
        ms = rng.lognormvariate(0.0, 2.0) * rng.choice((1e-4, 1.0, 1e3))
        port.note_ms(ms)
        jax.note_s(ms / 1e3) if seed % 2 else jax.note_ms(ms)
    if seed % 2 == 0:
        assert port.to_json() == jax.to_json()
    for p in (0.0, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert port.percentile(p) == pytest.approx(jax.percentile(p),
                                                   rel=1e-12)
    assert LatHist.from_json(jax.to_json()).buckets == jax.buckets


# ------------------------------------------- fault plans on each transport


async def _transport(kind: str, policy, inbox: list):
    """(send(i), close()) from "a" to "b" over ``kind`` with ``policy``
    on the sender side, delivering into ``inbox``."""
    from ceph_tpu_torch.msg.messenger import LocalBus, TcpMessenger

    async def db(src, msg):
        inbox.append(msg.osd)

    if kind == "localbus":
        bus = LocalBus(faults=policy)
        bus.register("b", db)
        return (lambda m: bus.send("a", "b", m)), bus.drain
    if kind == "tcp":
        a = TcpMessenger("a", lambda s, m: None, faults=policy)
        b = TcpMessenger("b", db)
        a.addrbook["b"] = await b.listen()

        async def close():
            await a.close()
            await b.close()
        return (lambda m: a.send("b", m)), close
    a = ShmMessenger("a", lambda s, m: None, faults=policy)
    b = ShmMessenger("b", db)
    await b.listen(_sock("b"))

    async def close():
        await a.close()
        await b.close()
    return (lambda m: a.send(_sock("b"), m)), close


@pytest.mark.parametrize("kind", ["localbus", "tcp", "shm"])
def test_fault_plan_draws_equal_the_reference_on_each_transport(kind):
    """The port's transports consult ``NetFaultPolicy.plan`` once a send:
    the JAX package's policy, with the same seed and mix, draws the same
    plans, and the deliveries follow them copy for copy."""
    from ceph_tpu.cluster.faults import NetFaultPolicy as JNetFaultPolicy

    n = 80
    dst = "b" if kind != "shm" else _sock("b")
    ref = JNetFaultPolicy(random.Random(42))
    ref.set_link("a", "*", drop=0.3, dup=0.3)
    plans = [ref.plan("a", dst) for _ in range(n)]
    expect = sorted(i for i, p in enumerate(plans) if p is not None
                    for _ in p)
    assert 0 < len(expect) < 2 * n and len(expect) != n

    async def body():
        pol = NetFaultPolicy(random.Random(42))
        pol.set_link("a", "*", drop=0.3, dup=0.3)
        inbox = []
        send, close = await _transport(kind, pol, inbox)
        try:
            for i in range(n):
                await send(M.MPing(osd=i, epoch=0))
            while len(inbox) < len(expect):
                await asyncio.sleep(0.01)
            await asyncio.sleep(0.05)  # and no extra copies
        finally:
            await close()
        assert sorted(inbox) == expect
        assert pol.counters == ref.counters

    run(body())


@pytest.mark.parametrize("kind", ["localbus", "tcp", "shm"])
def test_delay_and_partition_on_each_transport(kind):
    async def body():
        pol = NetFaultPolicy(random.Random(3))
        inbox = []
        send, close = await _transport(kind, pol, inbox)
        try:
            pol.partition({"a"}, {"*"})
            await send(M.MPing(osd=1, epoch=1))
            await asyncio.sleep(0.1)
            assert inbox == [] and pol.counters["partition_drop"] == 1
            pol.heal()
            pol.set_link("a", "*", delay=0.2)
            loop = asyncio.get_running_loop()
            t0 = loop.time()
            await send(M.MPing(osd=2, epoch=2))
            while not inbox:
                await asyncio.sleep(0.01)
            assert loop.time() - t0 >= 0.19 and inbox == [2]
        finally:
            await close()

    run(body())


@pytest.mark.parametrize("backend", ["tcp", "shm"])
def test_netbus_follows_the_mon_alias_to_its_new_holder(backend, tmp_path):
    """The "mon" alias moves between LIVE processes when a new leader is
    elected. A sender that reached the old holder must reach the new
    one next: the old holder is alive, so a send to it succeeds and is
    dropped there (the entity is gone), and the port re-reads the book
    entry on every send (the reference cached it until a send failed, so
    a client that cached a peon's address mid-election timed out every
    mon op after it, ROADMAP §3)."""
    from ceph_tpu_torch.msg.netbus import NetBus

    async def t():
        book = str(tmp_path / "book")
        old, new, client = (NetBus(book, backend=backend)
                            for _ in range(3))
        for bus in (old, new, client):
            await bus.start()
        got = {"old": [], "new": []}

        def sink(key):
            async def handle(src, msg):
                got[key].append(msg.epoch)
            return handle

        async def until(cond):
            while not cond():
                await asyncio.sleep(0.01)

        try:
            old.register("mon", sink("old"))
            await client.send("client.0", "mon", M.MPing(osd=0, epoch=1))
            await asyncio.wait_for(until(lambda: got["old"]), 10)
            old.unregister("mon")  # the old leader loses the election
            new.register("mon", sink("new"))
            await client.send("client.0", "mon", M.MPing(osd=0, epoch=2))
            await asyncio.wait_for(until(lambda: got["new"]), 10)
            assert got == {"old": [1], "new": [2]}
        finally:
            for bus in (old, new, client):
                await bus.close()

    run(t())
