"""The cluster tier's leaves on the port: the mClock scheduler and
Throttle (``cluster.scheduler``), the backfill reserver (``reserver``), the
op tracker (``optracker``), hedged fan-outs (``hedge``) and the PG log
(``pglog``). The units of ``test_scheduler.py``, ``test_reserver.py`` and
``test_hedging.py`` that need no cluster run on the port, and each leaf is
driven alike through both packages on seeded cases: equal dequeue orders,
grants, hedge delays, outcomes, counters and log bytes. The cluster cases
of those files wait for the cluster tier. Tolerance: exact equality."""
import asyncio
import random

import pytest
import torch

from ceph_tpu.cluster import hedge as jhedge
from ceph_tpu.cluster import optracker as joptracker
from ceph_tpu.cluster import pglog as jpglog
from ceph_tpu.cluster import reserver as jreserver
from ceph_tpu.cluster import scheduler as jscheduler
from ceph_tpu_torch.cluster import hedge, optracker, pglog, reserver, scheduler
from ceph_tpu_torch.cluster.hedge import (PeerLatencyEWMA, hedge_enabled,
                                          hedged_fanout)
from ceph_tpu_torch.cluster.reserver import AsyncReserver
from ceph_tpu_torch.cluster.scheduler import (BEST_EFFORT, CLIENT, RECOVERY,
                                              MClockScheduler, Throttle)

torch.set_num_threads(1)


def run(coro, timeout: float = 30.0):
    return asyncio.run(asyncio.wait_for(coro, timeout))


# --------------------------------------------------------------- scheduler


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def drain(s, n):
    out = []
    for _ in range(n):
        item = s.dequeue()
        if item is None:
            break
        out.append(item)
    return out


def test_reservation_served_first():
    clk = FakeClock()
    s = MClockScheduler({CLIENT: (10.0, 1.0, 0.0),
                         RECOVERY: (1.0, 1.0, 0.0)}, clock=clk)
    for i in range(3):
        s.enqueue(CLIENT, f"c{i}")
    s.enqueue(RECOVERY, "r0")
    clk.t += 10
    got = drain(s, 4)
    assert set(got) == {"c0", "c1", "c2", "r0"} and got[0] == "c0"


def test_weight_shares_spare_capacity():
    clk = FakeClock()
    s = MClockScheduler({CLIENT: (0.0, 4.0, 0.0),
                         RECOVERY: (0.0, 1.0, 0.0)}, clock=clk)
    for i in range(8):
        s.enqueue(CLIENT, f"c{i}")
        s.enqueue(RECOVERY, f"r{i}")
    got = drain(s, 10)
    assert got.count("r0") + got.count("r1") <= 2
    assert sum(1 for g in got if g.startswith("c")) >= 7


def test_limit_defers_eligibility():
    clk = FakeClock()
    s = MClockScheduler({RECOVERY: (0.0, 1.0, 2.0)}, clock=clk)
    for i in range(4):
        s.enqueue(RECOVERY, f"r{i}")
    assert drain(s, 10) == ["r0"]
    assert s.dequeue() is None
    assert s.next_eligible_in() == pytest.approx(0.5)
    clk.t += 0.5
    assert s.dequeue() == "r1" and s.dequeue() is None
    clk.t += 10
    assert drain(s, 10) == ["r2", "r3"] and len(s) == 0


def test_idle_class_does_not_bank_credit():
    clk = FakeClock()
    s = MClockScheduler({BEST_EFFORT: (0.0, 1.0, 1.0)}, clock=clk)
    s.enqueue(BEST_EFFORT, "a")
    assert drain(s, 1) == ["a"]
    clk.t += 1000
    for i in range(5):
        s.enqueue(BEST_EFFORT, f"b{i}")
    assert len(drain(s, 10)) <= 2


def test_async_get():
    async def scenario():
        s = MClockScheduler({CLIENT: (100.0, 1.0, 0.0)})
        s.enqueue(CLIENT, "x")
        assert await asyncio.wait_for(s.get(), 5) == "x"
        fut = asyncio.ensure_future(s.get())
        await asyncio.sleep(0.05)
        assert not fut.done()
        s.enqueue(CLIENT, "y")
        assert await asyncio.wait_for(fut, 5) == "y"

    run(scenario())


def test_throttle():
    async def scenario():
        th = Throttle(100)
        await th.acquire(60)
        await th.acquire(40)
        assert th.past_midpoint()
        blocked = asyncio.ensure_future(th.acquire(10))
        await asyncio.sleep(0.02)
        assert not blocked.done()
        th.release(60)
        await asyncio.wait_for(blocked, 5)
        th.release(50)
        await asyncio.wait_for(th.acquire(1000), 5)  # oversized, alone
        th.release(1000)

    run(scenario())


@pytest.mark.parametrize("seed", range(4))
def test_scheduler_dequeues_as_the_reference(seed):
    """One seeded stream of enqueues, clock steps and dequeues through
    both packages' schedulers: the same items come out in the same
    order, with the same eligibility waits."""
    def drive(mod):
        rng, clk = random.Random(seed), FakeClock()
        s = mod.MClockScheduler({
            mod.CLIENT: (50.0, 4.0, 0.0), mod.RECOVERY: (5.0, 1.0, 20.0),
            mod.SCRUB: (0.0, 0.5, 5.0), mod.BEST_EFFORT: (0.0, 1.0, 0.0)},
            clock=clk)
        classes = [mod.CLIENT, mod.RECOVERY, mod.SCRUB, mod.BEST_EFFORT]
        out = []
        for step in range(400):
            r = rng.random()
            if r < 0.5:
                s.enqueue(rng.choice(classes), step)
            elif r < 0.8:
                out.append(s.dequeue())
            else:
                clk.t += rng.random() * 0.2
                out.append(s.next_eligible_in())
        return out + drain(s, 1000)

    assert drive(scheduler) == drive(jscheduler)


# ---------------------------------------------------------------- reserver


def test_reserver_bounds_and_priorities():
    async def scenario():
        r = AsyncReserver(2)
        order = []

        async def worker(key, prio):
            await r.request(key, prio)
            order.append(key)

        await r.request("a")
        await r.request("b")
        assert r.in_use == 2
        t_lo = asyncio.ensure_future(worker("lo", 0))
        t_hi = asyncio.ensure_future(worker("hi", 10))
        await asyncio.sleep(0.01)
        assert r.in_use == 2 and not order
        r.release("a")
        await asyncio.sleep(0.01)
        assert order == ["hi"]
        r.release("b")
        await asyncio.sleep(0.01)
        assert order == ["hi", "lo"]
        await r.request("hi")
        assert r.held("hi") and not r.held("a")
        r.release("nope")
        r.set_max(3)
        await r.request("c")
        assert r.in_use == 3
        await asyncio.gather(t_lo, t_hi)

    run(scenario())


@pytest.mark.parametrize("seed", range(3))
def test_reserver_grants_as_the_reference(seed):
    def drive(mod):
        async def scenario():
            rng = random.Random(seed)
            r = mod.AsyncReserver(2)
            grants, tasks = [], []

            async def want(key, prio):
                await r.request(key, prio)
                grants.append(key)

            for step in range(60):
                op = rng.random()
                if op < 0.5:
                    tasks.append(asyncio.ensure_future(
                        want(f"pg{step}", rng.randrange(4))))
                elif op < 0.9 and grants:
                    r.release(rng.choice(grants))
                else:
                    r.set_max(rng.randrange(1, 4))
                await asyncio.sleep(0)
                await asyncio.sleep(0)
            r.set_max(1000)
            await asyncio.gather(*tasks)
            return grants, r.in_use

        return run(scenario())

    assert drive(reserver) == drive(jreserver)


# ---------------------------------------------------------------- optracker


def test_op_tracker_in_flight_history_and_slow_ops(monkeypatch):
    now = [100.0]
    monkeypatch.setattr(optracker.time, "time", lambda: now[0])
    tr = optracker.OpTracker(history_size=2, slow_op_warn_secs=5.0)
    ops = [tr.create(f"osd_op(client.{i})") for i in range(3)]
    assert [o.seq for o in ops] == [1, 2, 3]
    ops[0].mark("reached_pg")
    now[0] = 104.0
    tr.finish(ops[0])
    now[0] = 106.0
    assert [o.seq for o in tr.slow_ops()] == [2, 3]
    inflight = tr.dump_ops_in_flight()
    assert inflight["num_ops"] == 2
    assert inflight["ops"][0]["duration"] is None
    assert inflight["ops"][0]["age"] == 6.0
    tr.finish(ops[1])
    tr.finish(ops[2])
    hist = tr.dump_historic_ops()
    assert hist["num_ops"] == 2  # bounded history
    assert [o["seq"] for o in hist["ops"]] == [2, 3]
    first = ops[0].dump()
    assert first["duration"] == 4.0
    assert [e["event"] for e in first["events"]] == ["queued", "reached_pg",
                                                    "done"]
    assert tr.dump_historic_ops(limit=1)["num_ops"] == 1


def test_op_tracker_dumps_as_the_reference(monkeypatch):
    def drive(mod):
        now = [50.0]
        monkeypatch.setattr(mod.time, "time", lambda: now[0])
        tr = mod.OpTracker(history_size=3, slow_op_warn_secs=1.0)
        ops = []
        for i in range(6):
            ops.append(tr.create(f"op{i}"))
            now[0] += 0.75
            ops[-1].mark("started")
            if i % 2:
                tr.finish(ops[i - 1])
        return (tr.dump_ops_in_flight(), tr.dump_historic_ops(),
                [o.seq for o in tr.slow_ops()])

    assert drive(optracker) == drive(joptracker)


# -------------------------------------------------------------------- hedge


def test_ewma_adapts_and_defaults():
    e = PeerLatencyEWMA(alpha=0.25)
    assert e.latency(3) == 0.0
    e.observe(3, 0.1)
    assert e.latency(3) == pytest.approx(0.1)
    e.observe(3, 0.2)
    assert e.latency(3) == pytest.approx(0.125)
    for _ in range(40):
        e.observe(3, 0.5)
    assert e.latency(3) == pytest.approx(0.5, rel=0.01)


def test_hedge_delay_clamped_to_backoff_bounds():
    e = PeerLatencyEWMA()
    assert e.hedge_delay([1, 2]) == pytest.approx(0.05)
    e.observe(1, 0.001)
    assert e.hedge_delay([1]) == pytest.approx(0.05)
    e.observe(2, 0.2)
    assert e.hedge_delay([1, 2]) == pytest.approx(0.4)
    for _ in range(21):
        e.observe(2, 100.0)
    assert e.hedge_delay([1, 2]) == pytest.approx(2.0)


def test_one_straggler_cannot_postpone_the_hedge():
    e = PeerLatencyEWMA()
    for p in (1, 2, 3, 4):
        e.observe(p, 0.01)
    e.observe(5, 5.0)
    assert e.hedge_delay([1, 2, 3, 4, 5]) == pytest.approx(0.05)


def test_hedge_enabled_env_lever_and_conf(monkeypatch):
    monkeypatch.delenv("CEPH_TPU_HEDGE", raising=False)
    assert hedge_enabled(None)
    assert not hedge_enabled({"osd_hedge_reads": False})
    assert hedge_enabled({})  # an unknown knob: on
    monkeypatch.setenv("CEPH_TPU_HEDGE", "0")
    assert not hedge_enabled(None)
    assert not hedge_enabled({"osd_hedge_reads": True})


def test_hedge_delays_equal_the_reference():
    conf = {"client_backoff_base": 0.02, "client_backoff_max": 1.0,
            "osd_hedge_delay_factor": 3.0}
    for c in (None, conf):
        rng = random.Random(9)
        e, j = PeerLatencyEWMA(c), jhedge.PeerLatencyEWMA(c)
        for _ in range(300):
            peer, secs = rng.randrange(8), rng.expovariate(20.0)
            e.observe(peer, secs)
            j.observe(peer, secs)
            plan = rng.sample(range(10), rng.randrange(1, 6))
            assert e.hedge_delay(plan) == j.hedge_delay(plan)


class _Perf:
    def __init__(self):
        self.c = {}

    def inc(self, name, v=1):
        self.c[name] = self.c.get(name, 0) + v


class _FakeOsd:
    def __init__(self, delay=0.01):
        self.conf = None
        self.perf = _Perf()
        self._delay = delay

    def hedge_delay(self, peers):
        return self._delay


def _cand(key, peer, result, delay, log):
    async def _one():
        try:
            await asyncio.sleep(delay)
            log.append(("done", key))
            return result
        except asyncio.CancelledError:
            log.append(("cancelled", key))
            raise
    return (key, peer, _one)


def test_hedged_fanout_first_sufficient_cancels_losers():
    async def scenario():
        osd, log = _FakeOsd(delay=0.01), []
        before = len(asyncio.all_tasks())
        out = await hedged_fanout(
            osd, [_cand("a", 1, b"A", 0.0, log),
                  _cand("slow", 2, b"S", 5.0, log)],
            [_cand("h", 3, b"H", 0.0, log)],
            sufficient=lambda o: len(o) >= 2, nbytes=len)
        assert out == {"a": b"A", "h": b"H"}
        assert ("cancelled", "slow") in log
        assert osd.perf.c["ec_hedges_fired"] == 1
        assert osd.perf.c["ec_hedges_won"] == 1
        assert osd.perf.c.get("ec_hedges_canceled", 0) == 0
        assert len(asyncio.all_tasks()) == before

    run(scenario())


def test_hedged_fanout_cancels_unfinished_hedges():
    async def scenario():
        osd, log = _FakeOsd(delay=0.01), []
        out = await hedged_fanout(
            osd, [_cand("a", 1, b"A", 0.05, log)],
            [_cand("h1", 2, b"H", 5.0, log), _cand("h2", 3, b"H", 5.0, log)],
            sufficient=lambda o: "a" in o)
        assert out == {"a": b"A"}
        assert osd.perf.c["ec_hedges_fired"] == 2
        assert osd.perf.c.get("ec_hedges_won", 0) == 0
        assert osd.perf.c["ec_hedges_canceled"] == 2
        assert ("cancelled", "h1") in log and ("cancelled", "h2") in log

    run(scenario())


def test_hedged_fanout_env_off_is_plan_exact(monkeypatch):
    monkeypatch.setenv("CEPH_TPU_HEDGE", "0")

    async def scenario():
        osd, log = _FakeOsd(delay=0.0), []
        out = await hedged_fanout(
            osd, [_cand("a", 1, b"A", 0.02, log)],
            [_cand("h", 2, b"H", 0.0, log)], sufficient=lambda o: "a" in o)
        assert out == {"a": b"A"} and osd.perf.c == {}
        assert not any(k == "h" for _e, k in log)

    run(scenario())


def test_hedged_fanout_records_exceptions_and_wasted_bytes():
    async def scenario():
        osd = _FakeOsd(delay=0.0)

        async def boom():
            raise IOError("transport")

        out = await hedged_fanout(osd, [("x", 1, boom)], [],
                                  sufficient=lambda o: len(o) >= 1)
        assert isinstance(out["x"], IOError)
        log = []
        out = await hedged_fanout(
            osd, [_cand("a", 1, b"A" * 10, 0.03, log)],
            [_cand("h", 2, b"H" * 7, 0.0, log)],
            sufficient=lambda o: "a" in o, nbytes=len)
        # the hedge landed first but "a" alone suffices: its 7 bytes
        # were the price of the tail cut
        assert set(out) == {"a", "h"}
        assert osd.perf.c["ec_hedges_wasted_bytes"] == 7

    run(scenario())


def test_hedged_fanout_outcomes_and_ledger_equal_the_reference():
    def drive(mod):
        async def scenario():
            osd, log = _FakeOsd(delay=0.02), []
            out = await mod.hedged_fanout(
                osd, [_cand(f"p{i}", i, bytes([i]) * (i + 1),
                            0.001 * i if i != 2 else 5.0, log)
                      for i in range(4)],
                [_cand(f"h{i}", 10 + i, b"h" * 3, 0.005 + 0.5 * i, log)
                 for i in range(2)],
                sufficient=lambda o: len(o) >= 4, nbytes=len)
            return sorted(out), osd.perf.c, sorted(log)

        return run(scenario())

    assert drive(hedge) == drive(jhedge)


# -------------------------------------------------------------------- pglog


def _entries(pkg, rng: random.Random, n: int):
    out, v = [], (1, 0)
    for _ in range(n):
        prior = v
        v = (v[0] + (rng.random() < 0.1), v[1] + rng.randrange(1, 4))
        out.append(pkg.Entry(rng.choice((pkg.OP_MODIFY, pkg.OP_DELETE)),
                             f"obj{rng.randrange(6)}".encode(), v, prior,
                             (f"client.{rng.randrange(3)}",
                              rng.randrange(1 << 40))))
    return out


def test_pg_log_append_trim_and_deltas():
    log = pglog.PGLog()
    ents = _entries(pglog, random.Random(1), 10)
    for e in ents:
        log.append(e)
    with pytest.raises(ValueError):
        log.append(ents[3])  # not newer than the head
    assert log.head == ents[-1].version
    log.trim(4)
    assert log.tail == ents[5].version and len(log.entries) == 4
    assert log.entries_after(ents[2].version) is None  # behind the tail
    assert log.entries_after(ents[7].version) == ents[8:]
    newest = {}
    for e in ents[6:]:
        newest[e.oid] = e
    assert log.missing_after(log.tail) == newest
    assert log.missing_after(ents[0].version) is None
    dec, used = pglog.PGLog.decode(log.encode())
    assert dec == log and used == len(log.encode())
    assert bytes(log.encode_bl()) == log.encode()


@pytest.mark.parametrize("seed", range(4))
def test_pg_log_and_info_bytes_equal_the_reference(seed):
    rng = random.Random(seed)
    ents = _entries(pglog, rng, 12)
    jents = _entries(jpglog, random.Random(seed), 12)
    assert [e.encode() for e in ents] == [e.encode() for e in jents]
    log, jlog_ = pglog.PGLog(), jpglog.PGLog()
    for e, j in zip(ents, jents):
        log.append(e)
        jlog_.append(j)
    log.trim(8)
    jlog_.trim(8)
    assert log.encode() == jlog_.encode()
    missing = {e.oid: e.version for e in ents[:5]}
    info = pglog.PGInfo(log.head, log, missing)
    jinfo = jpglog.PGInfo(jlog_.head, jlog_, dict(missing))
    wire = info.encode()
    assert wire == jinfo.encode()
    assert pglog.PGInfo.decode(jinfo.encode())[0] == info
    assert pglog.enc_missing(missing) == jpglog.enc_missing(missing)
    assert pglog.dec_missing(pglog.enc_missing(missing))[0] == missing
    assert pglog.Entry.decode(jents[0].encode())[0] == ents[0]
