"""The cases of ``tests/test_hedging.py`` on the port (``ceph_tpu_torch``),
each cluster on ``device="cpu"`` (the kernels' plain versions), copied
with only their imports and device changed. The cold-shape shield's
probe codec carries a device and takes int32 word tensors, as the port's
batcher hands them. The three lint-fixture cases test tpulint, which
lints only the JAX package; in their place the two hedge rules read the
port's cluster files and must find what they find in the reference's.
The reference's own words follow.

Straggler-proof dispatch: hedged EC fan-outs with loser
cancellation, per-peer EWMA hedge delays, rateless over-decomposition
of batched recovery matmuls, the slow-OSD fault arm, and the seeded
straggler thrash.

The contract under test: hedging changes WHEN bytes arrive, never
WHICH bytes — hedged reads are byte-exact vs unhedged under injected
stragglers, cancelled losers leak neither tasks nor reply
expectations (``ec_hedges_canceled == fired - won`` by construction),
and the over-decomposed device dispatch is bit-identical to the
legacy single dispatch for every (k, m, erasure) draw.
"""
import asyncio
import random
import time

import numpy as np
import pytest

from ceph_tpu_torch.cluster import TestCluster
from ceph_tpu_torch.cluster.ecbatch import ECBatcher
from ceph_tpu_torch.cluster.faults import Thrasher, build_schedule
from ceph_tpu_torch.cluster.hedge import (PeerLatencyEWMA, hedge_enabled,
                                          hedged_fanout)
from ceph_tpu_torch.ec import load_codec
from ceph_tpu_torch.placement.osdmap import Pool
import torch

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)

EC_PROFILE = {"plugin": "rs_tpu", "k": "3", "m": "2",
              "backend": "device"}

HEDGE_KEYS = ("ec_hedges_fired", "ec_hedges_won", "ec_hedges_canceled",
              "ec_hedges_wasted_bytes")


def run(coro, timeout=180):
    asyncio.run(asyncio.wait_for(coro, timeout))


async def make_ec_cluster(n=5, seed=0, pg_num=8, profile=None):
    c = TestCluster(n_osds=n, fault_seed=seed, device="cpu")
    await c.start()
    await c.client.create_pool(
        Pool(id=2, name="ec", size=5, min_size=3, pg_num=pg_num,
             crush_rule=1, type="erasure",
             ec_profile=dict(profile or EC_PROFILE)))
    await c.wait_active(20)
    return c


def hedge_totals(c) -> dict:
    tot = {k: 0 for k in HEDGE_KEYS}
    for o in c.osds:
        if o is None:
            continue
        d = o.perf.dump()
        for k in HEDGE_KEYS:
            tot[k] += int(d.get(k, 0))
    return tot


# --------------------------------------------------- EWMA hedge delay


def test_ewma_adapts_and_defaults():
    e = PeerLatencyEWMA(alpha=0.25)
    assert e.latency(3) == 0.0  # never-seen peer
    e.observe(3, 0.1)
    assert e.latency(3) == pytest.approx(0.1)  # first sample seeds
    e.observe(3, 0.2)
    assert e.latency(3) == pytest.approx(0.125)  # prev + a*(x - prev)
    # adaptation converges toward a shifted latency regime
    for _ in range(40):
        e.observe(3, 0.5)
    assert e.latency(3) == pytest.approx(0.5, rel=0.01)


def test_hedge_delay_clamped_to_backoff_bounds():
    e = PeerLatencyEWMA()  # conf-less: base 0.05, cap 2.0, factor 2.0
    # unknown peers: floor at the backoff base (cheap insurance)
    assert e.hedge_delay([1, 2]) == pytest.approx(0.05)
    e.observe(1, 0.001)
    assert e.hedge_delay([1]) == pytest.approx(0.05)  # fast peer: floor
    e.observe(2, 0.2)
    # two-peer plan: upper median == slower peer, 2 x 0.2
    assert e.hedge_delay([1, 2]) == pytest.approx(0.4)
    e.observe(2, 100.0)
    for _ in range(20):
        e.observe(2, 100.0)
    assert e.hedge_delay([1, 2]) == pytest.approx(2.0)  # cap


def test_one_straggler_cannot_postpone_the_hedge():
    """The delay keys on the MEDIAN planned peer: a single known-slow
    peer in a healthy plan must not inflate the deadline — that is
    the exact plan the hedge exists to cut short."""
    e = PeerLatencyEWMA()
    for p in (1, 2, 3, 4):
        e.observe(p, 0.01)
    e.observe(5, 5.0)  # the straggler the fan-out routes around
    assert e.hedge_delay([1, 2, 3, 4, 5]) == pytest.approx(0.05)


def test_hedge_enabled_env_lever(monkeypatch):
    monkeypatch.delenv("CEPH_TPU_HEDGE", raising=False)
    assert hedge_enabled(None)
    monkeypatch.setenv("CEPH_TPU_HEDGE", "0")
    assert not hedge_enabled(None)


# ------------------------------------------------ hedged_fanout unit


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
    """A straggling primary is routed around: the hedge completes,
    the fan-out resolves on the first sufficient subset, the loser is
    cancelled (its CancelledError cleanup RUNS), and the ledger closes
    with canceled == fired - won."""
    async def t():
        osd = _FakeOsd(delay=0.01)
        log = []
        before = len(asyncio.all_tasks())
        out = await hedged_fanout(
            osd,
            [_cand("a", 1, b"A", 0.0, log),
             _cand("slow", 2, b"S", 5.0, log)],
            [_cand("h", 3, b"H", 0.0, log)],
            sufficient=lambda o: len(o) >= 2,
            nbytes=len)
        assert out == {"a": b"A", "h": b"H"}  # loser ABSENT
        assert ("cancelled", "slow") in log
        assert osd.perf.c["ec_hedges_fired"] == 1
        assert osd.perf.c["ec_hedges_won"] == 1
        assert osd.perf.c.get("ec_hedges_canceled", 0) == 0
        # task census returns to baseline: losers were awaited dead
        assert len(asyncio.all_tasks()) == before
    run(t(), timeout=30)


def test_hedged_fanout_cancels_unfinished_hedges():
    """Primaries resolving after the hedge wave fired but before the
    hedges complete: every fired hedge is cancelled and the invariant
    canceled == fired - won holds."""
    async def t():
        osd = _FakeOsd(delay=0.01)
        log = []
        out = await hedged_fanout(
            osd,
            [_cand("a", 1, b"A", 0.05, log)],
            [_cand("h1", 2, b"H", 5.0, log),
             _cand("h2", 3, b"H", 5.0, log)],
            sufficient=lambda o: "a" in o)
        assert out == {"a": b"A"}
        assert osd.perf.c["ec_hedges_fired"] == 2
        assert osd.perf.c.get("ec_hedges_won", 0) == 0
        assert osd.perf.c["ec_hedges_canceled"] == 2
        assert ("cancelled", "h1") in log and ("cancelled", "h2") in log
    run(t(), timeout=30)


def test_hedged_fanout_env_off_is_plan_exact(monkeypatch):
    """CEPH_TPU_HEDGE=0 (the A/B lever): extras never launch, no
    hedge counters move — the legacy plan-exact fan-out."""
    monkeypatch.setenv("CEPH_TPU_HEDGE", "0")

    async def t():
        osd = _FakeOsd(delay=0.0)
        log = []
        out = await hedged_fanout(
            osd,
            [_cand("a", 1, b"A", 0.02, log)],
            [_cand("h", 2, b"H", 0.0, log)],
            sufficient=lambda o: "a" in o)
        assert out == {"a": b"A"}
        assert osd.perf.c == {}
        assert not any(k == "h" for _e, k in log)
    run(t(), timeout=30)


def test_hedged_fanout_records_exceptions_as_outcomes():
    """A raising factory records the exception AS the outcome —
    callers keep their own transient-vs-failed triage."""
    async def t():
        osd = _FakeOsd()

        async def boom():
            raise IOError("transport")

        out = await hedged_fanout(
            osd, [("x", 1, boom)], [],
            sufficient=lambda o: len(o) >= 1)
        assert isinstance(out["x"], IOError)
    run(t(), timeout=30)


# ------------------------------- hedged read vs stragglers (cluster)


def test_hedged_read_byte_exact_and_leak_free(monkeypatch):
    """Under a persistently slow OSD, hedged EC reads return the exact
    written bytes, route around the straggler (hedges fire AND win),
    cancel losers without leaking reply expectations, and the unhedged
    A/B arm (CEPH_TPU_HEDGE=0) reads the same bytes the slow way."""
    monkeypatch.delenv("CEPH_TPU_HEDGE", raising=False)

    async def t():
        c = await make_ec_cluster(seed=7)
        try:
            rng = random.Random(99)
            payloads = {f"hedge-{i}": rng.randbytes(16 << 10)
                        for i in range(6)}
            for name, data in payloads.items():
                await c.client.write_full(2, name, data)
            # one persistently slow daemon: lognormal service-time
            # inflation on its shard-serving path, median well above
            # the 50 ms hedge-delay floor
            c.faults.slow_osd([1], scale=0.3, sigma=0.2)
            for name, data in payloads.items():
                got = await c.client.read(2, name)
                assert got == data, f"hedged read tore {name}"
            tot = hedge_totals(c)
            assert tot["ec_hedges_fired"] > 0
            assert tot["ec_hedges_won"] > 0
            assert tot["ec_hedges_canceled"] == \
                tot["ec_hedges_fired"] - tot["ec_hedges_won"]
            # leak-free: every reply expectation drained (cancelled
            # losers ran their drop_reply cleanup); straggler replies
            # to dropped subtids are no-ops
            deadline = asyncio.get_running_loop().time() + 15.0
            while asyncio.get_running_loop().time() < deadline:
                if all(not o.pending for o in c.osds if o is not None):
                    break
                await asyncio.sleep(0.1)
            assert all(not o.pending for o in c.osds if o is not None)
            # A/B arm: unhedged reads the same bytes, just without
            # firing hedges
            monkeypatch.setenv("CEPH_TPU_HEDGE", "0")
            fired0 = hedge_totals(c)["ec_hedges_fired"]
            for name, data in payloads.items():
                assert await c.client.read(2, name) == data
            assert hedge_totals(c)["ec_hedges_fired"] == fired0
        finally:
            monkeypatch.delenv("CEPH_TPU_HEDGE", raising=False)
            await c.stop()
    run(t(), timeout=240)


# --------------------------- device tier: rateless over-decomposition


def _conf(**kw):
    # plain dict: absent knobs raise KeyError and the batcher falls
    # back to its defaults (window 0, mesh off, repair off)
    return dict(kw)


def _su_for(codec, base=1024):
    """A stripe_unit that is a fixed point of get_chunk_size — what
    osd.sinfo_for would compute for the pool."""
    su = base
    for _ in range(8):
        got = codec.get_chunk_size(codec.k * su)
        if got == su:
            return su
        su = got
    raise AssertionError("stripe unit did not stabilize")


class _BatchPerf:
    def __init__(self):
        self.c = {}

    def add_u64_counter(self, name, *a, **k):
        self.c[name] = 0

    def add_histogram(self, *a, **k):
        pass

    def inc(self, name, v=1):
        self.c[name] = self.c.get(name, 0) + v

    def observe(self, *a, **k):
        pass


def test_overdecompose_decode_parity_random_draws():
    """First-sufficient over-decomposed decode is bit-identical to the
    legacy full-round dispatch across random (k, m, erasure) draws on
    the host engine, and the sub-task ledger balances: every block
    resolves once, its hedge duplicate is shed."""
    async def t():
        rng = np.random.default_rng(20260806)
        for trial in range(5):
            k = int(rng.integers(2, 6))
            m = int(rng.integers(1, 4))
            codec = load_codec({"plugin": "rs_tpu", "k": str(k),
                                "m": str(m), "backend": "host"}, device="cpu")
            su = _su_for(codec)
            b = int(rng.integers(9, 48))
            cells = rng.integers(0, 256, (b, k, su), dtype=np.uint8)
            legacy = ECBatcher(perf=None, conf=_conf())
            parity, _ = await legacy.encode_cells(codec, cells)
            every = np.concatenate([cells, parity], axis=1)
            # erase a random data row (plus up to m-1 others), decode
            # the erased data from exactly k survivors
            lost = int(rng.integers(0, k))
            others = [x for x in range(k + m) if x != lost]
            present = tuple(sorted(
                rng.choice(others, size=k, replace=False).tolist()))
            want = tuple(j for j in range(k) if j not in present)
            surv = np.ascontiguousarray(every[:, list(present), :])
            base = await legacy.decode_cells(codec, present, want, surv)
            perf = _BatchPerf()
            ECBatcher.declare_counters(perf)
            od = ECBatcher(perf=perf,
                           conf=_conf(osd_ec_overdecompose=3))
            got = await od.decode_cells(codec, present, want, surv)
            np.testing.assert_array_equal(
                base, got, err_msg=f"trial {trial} k={k} m={m} "
                                   f"present={present}")
            for i, j in enumerate(want):
                np.testing.assert_array_equal(got[:, i, :],
                                              cells[:, j, :])
            d = perf.c
            assert d["ec_overdecompose_rounds"] >= 1
            # ledger: used-once-per-block + shed == submitted copies
            assert d["ec_overdecompose_subtasks"] == \
                2 * d["ec_overdecompose_shed"]
    run(t(), timeout=120)


def test_overdecompose_repair_parity_clay():
    """The sub-chunk repair kind rides the same over-decomposed
    dispatch: bandwidth-optimal Clay repair through row blocks is
    byte-identical to the single dispatch."""
    async def t():
        codec = load_codec({"plugin": "clay", "k": "3", "m": "2",
                            "backend": "host"}, device="cpu")
        su = _su_for(codec)
        rng = np.random.default_rng(11)
        cells = rng.integers(0, 256, (13, codec.k, su), dtype=np.uint8)
        parity = np.stack([codec.encode_chunks(c) for c in cells])
        every = np.concatenate([cells, parity], axis=1)
        lost = 0
        avail = sorted(set(range(5)) - {lost})
        assert codec.is_repair({lost}, set(avail))
        legacy = ECBatcher(perf=None, conf=_conf())
        plan = codec.minimum_to_decode([lost], avail)
        sub = su // codec.get_sub_chunk_count()
        order = sorted(plan)
        runs = plan[order[0]]
        surv = np.stack([
            np.concatenate([every[:, ch, o * sub:(o + cnt) * sub]
                            for o, cnt in runs], axis=1)
            for ch in order], axis=1)
        base = await legacy.repair_cells(codec, tuple(order), (lost,),
                                         surv)
        od = ECBatcher(perf=None, conf=_conf(osd_ec_overdecompose=2))
        got = await od.repair_cells(codec, tuple(order), (lost,), surv)
        np.testing.assert_array_equal(base, got)
        np.testing.assert_array_equal(got[:, 0, :], every[:, lost, :])
    run(t(), timeout=120)


class _EngineProbe:
    """Minimal device-engine codec recording which engine each decode
    round ran on — host hook vs device batch."""
    profile = {"plugin": "probe"}
    technique = ""
    k, m = 2, 1
    backend = "device"
    bytewise_linear = False
    device = torch.device("cpu")

    def __init__(self):
        self.calls = []

    def resolved_backend(self):
        return "device"

    def decode_cells_host(self, present, want, blk):
        self.calls.append("host")
        return np.ascontiguousarray(blk[:, :len(want), :])

    def decode_batch(self, present, surviving, want=None):
        # the port's batcher hands the device engine int32 word tensors
        self.calls.append("device")
        return surviving[:, :len(want), :].clone()


def test_cold_shape_shield_promotes_after_volume():
    """A decode survivor pattern stays on the host engine until its
    cumulative bytes cross osd_ec_cold_shape_bytes; the promotion
    pre-warms the device kernel on a background thread (rounds keep
    landing host meanwhile — the compile never sits on a waiting
    read), and only then does the pattern take the device path. Each
    pattern keeps its own ledger, and 0 disables the shield
    outright."""
    perf = _BatchPerf()
    ECBatcher.declare_counters(perf)
    b = ECBatcher(perf=perf, conf=_conf(osd_ec_cold_shape_bytes=100))
    codec = _EngineProbe()
    cells = np.arange(4 * 2 * 8, dtype=np.uint8).reshape(4, 2, 8)
    key = ("dec", ("probe", "", 2, 1, "device"), 8, (0, 1), (2,))
    for _ in range(2):  # 64 B/round: cold at 0 and at 64 cumulative
        out = b._decode_sync(codec, (0, 1), (2,), cells)
        np.testing.assert_array_equal(out, cells[:, :1, :])
    assert codec.calls == ["host", "host"]
    assert perf.c["ec_decode_cold_host"] == 2
    # crossing the threshold: THIS round still lands host while the
    # background warm runs the device dispatch once off the read path
    out = b._decode_sync(codec, (0, 1), (2,), cells)  # 128 >= 100
    np.testing.assert_array_equal(out, cells[:, :1, :])
    # the counter proves the round itself landed host (the warm
    # thread's device call interleaves into `calls` at its own pace)
    assert perf.c["ec_decode_cold_host"] == 3
    assert codec.calls.count("host") == 3
    for _ in range(200):  # the warm thread flips the promotion flag
        if b._shape_warm.get(key) is True:
            break
        time.sleep(0.01)
    assert b._shape_warm[key] is True
    assert codec.calls.count("device") == 1  # the warm dispatch itself
    out = b._decode_sync(codec, (0, 1), (2,), cells)  # promoted
    np.testing.assert_array_equal(out, cells[:, :1, :])
    assert codec.calls.count("device") == 2
    assert perf.c["ec_decode_cold_host"] == 3
    # a different survivor pattern is its own ledger: cold again
    b._decode_sync(codec, (0, 2), (1,), cells)
    assert codec.calls[-1] == "host"
    # threshold 0 = shield off: straight to the device engine
    off = ECBatcher(perf=None, conf=_conf(osd_ec_cold_shape_bytes=0))
    fresh = _EngineProbe()
    off._decode_sync(fresh, (0, 1), (2,), cells)
    assert fresh.calls == ["device"]


# ----------------------------------- the hedge lint rules on the port
#
# The port's tpulint (``ceph_tpu_torch/analysis``) reads the port's copies
# of the cluster tier at their own paths; the JAX package's reads the
# reference's files. The two hedge rules must find the same in both.

HEDGE_RULE_FILES = ("pg.py", "osd.py", "client.py", "hedge.py",
                    "ecbatch.py")


def lint_twins(name: str, rule: str):
    from pathlib import Path

    from ceph_tpu import analysis as ref_analysis
    from ceph_tpu_torch import analysis

    root = Path(__file__).resolve().parent.parent
    path = f"ceph_tpu_torch/cluster/{name}"
    ref_path = f"ceph_tpu/cluster/{name}"
    got = analysis.lint_source((root / path).read_text(), path,
                               only=[rule])
    want = ref_analysis.lint_source((root / ref_path).read_text(),
                                    ref_path, only=[rule])
    return ([(f.rule, f.message) for f in got],
            [(f.rule, f.message) for f in want])


@pytest.mark.parametrize("name", HEDGE_RULE_FILES)
def test_hedge_fanout_rule_finds_on_the_port_what_it_finds_in_the_reference(
        name):
    got, want = lint_twins(name, "hedge-fanout-discipline")
    assert got == want


@pytest.mark.parametrize("name", HEDGE_RULE_FILES)
def test_hedge_task_rule_finds_on_the_port_what_it_finds_in_the_reference(
        name):
    got, want = lint_twins(name, "hedge-task-discipline")
    assert got == want


def test_hedge_fanout_rule_flags_a_gather_over_reply_waits_in_the_port_pg():
    """The port's rule is live on the port's text: a gather over reply
    waits appended to the port's pg.py is flagged."""
    from pathlib import Path

    from ceph_tpu_torch import analysis

    root = Path(__file__).resolve().parent.parent
    src = (root / "ceph_tpu_torch" / "cluster" / "pg.py").read_text() + (
        "\n\nasync def read_shards(osd, waits):\n"
        "    return await asyncio.gather(\n"
        "        *(osd.await_reply(t, f, o) for t, f, o in waits))\n")
    fs = analysis.lint_source(src, "ceph_tpu_torch/cluster/pg.py",
                              only=["hedge-fanout-discipline"])
    assert any("hedged_fanout" in f.message for f in fs)


# ------------------------------------------- seeded straggler thrash


def test_straggler_thrash_converges_with_hedges(monkeypatch):
    """Tier-1 straggler thrash: a ~5 s seeded schedule with up to two
    persistently slow OSDs under concurrent oracle writers converges
    byte-exact, the verdict's hedge ledger proves hedges fired AND won
    while the leak-free invariant holds, and the schedule replays
    draw-for-draw (legacy availability draws untouched)."""
    monkeypatch.delenv("CEPH_TPU_HEDGE", raising=False)

    async def t():
        c = await make_ec_cluster(seed=4321)
        c.client.op_timeout = 150.0
        # straggle_scale: median inflation 150 ms — far above the
        # 50 ms hedge floor (hedges fire AND win) yet far below the
        # sub-op timeout, so a cold-cache/loaded run cannot tip slow
        # shards into spurious unreadability mid-recovery
        thr = Thrasher(c, 2, seed=4321, duration=5.0, max_unavail=2,
                       bitrot_p=0.0, partitions=False, n_objects=6,
                       obj_size=16 << 10, writers=3,
                       settle_timeout=120.0, stragglers=2,
                       straggle_scale=0.15, straggle_sigma=0.2)
        assert thr.schedule == build_schedule(
            4321, 5.0, 5, max_unavail=2, partitions=False,
            stragglers=2)
        # the straggler stream must not shift the availability draws
        legacy = build_schedule(4321, 5.0, 5, max_unavail=2,
                                partitions=False)
        assert [e for e in thr.schedule
                if e.kind not in ("straggle", "unstraggle")] == legacy
        assert any(e.kind == "straggle" for e in thr.schedule)
        verdict = await thr.run()
        assert verdict["passed"], verdict
        assert verdict["converged"]
        assert verdict["oracle_mismatches"] == []
        assert verdict["stragglers"]["applied"] > 0
        hedge = verdict["hedge_counters"]
        assert hedge["ec_hedges_fired"] > 0
        assert hedge["ec_hedges_won"] > 0, hedge
        assert hedge["ec_hedges_canceled"] == \
            hedge["ec_hedges_fired"] - hedge["ec_hedges_won"]
        # post-thrash task/reply census back at baseline
        for _ in range(40):
            if all(not o.pending for o in c.osds if o is not None):
                break
            await asyncio.sleep(0.1)
        assert all(not o.pending for o in c.osds if o is not None)
        await c.stop()
    run(t(), timeout=300)
