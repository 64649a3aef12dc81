"""The port's ECBatcher (``ceph_tpu_torch.cluster.ecbatch``) on CPU
codecs: the JAX package's batcher unit tier (tests/test_ec_batcher.py),
its fail-closed tests (tests/test_faults.py) and its over-decomposition
and cold-shape tests (tests/test_hedging.py) rewritten over the port,
plus one schedule run through both packages' batchers that must give
the same bytes, CRCs and perf counters. Tolerance: exact equality
(integer cells and CRCs)."""
import asyncio
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ceph_tpu.cluster.ecbatch import ECBatcher as JECBatcher
from ceph_tpu.ec import load_codec as jload_codec
from ceph_tpu.utils import config as jcfg
from ceph_tpu.utils.fault import FaultInjector as JFaultInjector
from ceph_tpu.utils.perf import PerfCounters as JPerfCounters
from ceph_tpu_torch import kernels, native
from ceph_tpu_torch.cluster import FLUSH_REASONS, ECBatcher, codec_profile_key
from ceph_tpu_torch.cluster import ecbatch
from ceph_tpu_torch.ec import load_codec
from ceph_tpu_torch.ops import gf8
from ceph_tpu_torch.utils import config as cfg
from ceph_tpu_torch.utils.fault import FaultInjector, InjectedError
from ceph_tpu_torch.utils.perf import PerfCounters
from test_torch_native import jax_native_whole  # noqa: F401

# The plain versions are small tensor ops: one intra-op thread each keeps
# the parallel test workers from spinning every core.
torch.set_num_threads(1)

DEV_PROFILE = {"plugin": "rs_tpu", "k": "3", "m": "2", "backend": "device"}


def codec_for(profile=None, **extra):
    return load_codec({**(profile or DEV_PROFILE), **extra}, device="cpu")


def run(coro, timeout=120):
    asyncio.run(asyncio.wait_for(coro, timeout))


def make_perf() -> PerfCounters:
    perf = PerfCounters("test")
    ECBatcher.declare_counters(perf)
    return perf


def make_conf(**overrides) -> cfg.ConfigProxy:
    conf = cfg.proxy()
    conf.apply(overrides)
    return conf


def rand_cells(b: int, k: int = 3, su: int = 256,
               seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 256, (b, k, su), dtype=np.uint8)


def host_parity(codec, cells: np.ndarray) -> np.ndarray:
    """(B, k, su) -> (B, m, su) via the numpy GF reference."""
    b, k, su = cells.shape
    flat = np.ascontiguousarray(cells.transpose(1, 0, 2)).reshape(k, -1)
    par = gf8.gf_matmul(codec.matrix, flat)
    return np.ascontiguousarray(
        par.reshape(codec.m, b, su).transpose(1, 0, 2))


# ------------------------------------------------------------ unit tier


def test_fused_crcs_match_native_bit_for_bit():
    """Device-path CRCs come back from the fused dispatch and must
    equal native.crc32c over every data AND parity cell."""
    codec = codec_for()
    perf = make_perf()

    async def t():
        batcher = ECBatcher(perf)
        cells = rand_cells(5, seed=1)
        parity, crcs = await batcher.encode_cells(codec, cells)
        assert crcs is not None and crcs.shape == (5, 5)
        assert crcs.dtype == np.uint32 and parity.dtype == np.uint8
        assert (parity == host_parity(codec, cells)).all()
        every = np.concatenate([cells, parity], axis=1)  # (5, k+m, su)
        for b in range(5):
            for j in range(5):
                want = native.crc32c(np.ascontiguousarray(every[b, j]))
                assert int(crcs[b, j]) == want

    run(t())
    assert perf.dump()["ec_batches"] == 1


def test_host_engine_returns_no_crcs():
    """The host engine keeps its two-pass shape: parity only, CRCs stay
    the caller's separate native pass."""
    codec = codec_for(backend="host")

    async def t():
        batcher = ECBatcher()
        cells = rand_cells(4, seed=2)
        parity, crcs = await batcher.encode_cells(codec, cells)
        assert crcs is None
        assert (parity == host_parity(codec, cells)).all()

    run(t())


@pytest.mark.parametrize("backend", ["device", "host", "auto"])
def test_batched_decode_matches_codec_decode(backend):
    """decode_cells must agree with per-object codec.decode for data
    rows AND for a wanted parity row (stacked recovery matrix)."""
    codec = codec_for(backend=backend)

    async def t():
        batcher = ECBatcher()
        cells = rand_cells(6, seed=3)
        parity, _ = await batcher.encode_cells(codec, cells)
        every = np.concatenate([cells, parity], axis=1)
        # lose data shard 1 and parity shard 3: survivors 0, 2, 4
        present = (0, 2, 4)
        surv = np.ascontiguousarray(every[:, list(present), :])
        out = await batcher.decode_cells(codec, present, (0, 1, 2, 3),
                                         surv)
        assert (out[:, :3, :] == cells).all()
        assert (out[:, 3, :] == every[:, 3, :]).all()
        arrs = {p: every[0, p].copy() for p in present}
        ref = codec.decode([1], arrs)
        assert (out[0, 1, :] == ref[1]).all()

    run(t())


def test_cross_tick_submissions_merge_into_one_batch():
    """With a batch window armed, stripes submitted on DIFFERENT
    reactor ticks coalesce into one dispatch."""
    codec = codec_for()
    perf = make_perf()
    conf = make_conf(osd_ec_batch_window=0.2,
                     osd_ec_batch_target_stripes=2)

    async def t():
        batcher = ECBatcher(perf, conf=conf, idle_probe=lambda: False)
        t1 = asyncio.ensure_future(
            batcher.encode_cells(codec, rand_cells(1, seed=4)))
        await asyncio.sleep(0.01)  # a later tick, window still open
        t2 = asyncio.ensure_future(
            batcher.encode_cells(codec, rand_cells(1, seed=5)))
        await asyncio.gather(t1, t2)

    run(t())
    d = perf.dump()
    assert d["ec_batches"] == 1
    assert d["ec_batch_stripes"]["sum"] == 2
    assert d["ec_flush_size"] == 1
    assert d["ec_queue_wait_us"]["count"] == 2


def test_deadline_flush_fires_on_sparse_queue():
    """A lone stripe with a busy op queue (idle_probe False) waits out
    the window, then the deadline flushes it."""
    codec = codec_for()
    perf = make_perf()
    conf = make_conf(osd_ec_batch_window=0.05,
                     osd_ec_batch_target_stripes=1000)

    async def t():
        batcher = ECBatcher(perf, conf=conf, idle_probe=lambda: False)
        t0 = time.perf_counter()
        await batcher.encode_cells(codec, rand_cells(1, seed=6))
        assert time.perf_counter() - t0 >= 0.04

    run(t())
    d = perf.dump()
    assert d["ec_flush_deadline"] == 1
    assert d["ec_batches"] == 1


def test_mclock_idle_fast_flush_skips_the_window():
    """When the op scheduler reports idle, nothing else can contribute
    stripes — the batch must NOT wait out the window."""
    codec = codec_for()
    perf = make_perf()
    conf = make_conf(osd_ec_batch_window=5.0,
                     osd_ec_batch_target_stripes=1000)

    async def t():
        batcher = ECBatcher(perf, conf=conf, idle_probe=lambda: True)
        t0 = time.perf_counter()
        await batcher.encode_cells(codec, rand_cells(1, seed=7))
        assert time.perf_counter() - t0 < 1.0

    run(t())
    assert perf.dump()["ec_flush_fast"] == 1


def test_double_buffer_accumulates_while_in_flight():
    """Stripes arriving while a batch is on the executor accumulate and
    dispatch as ONE drain batch at completion."""
    codec = codec_for()
    perf = make_perf()
    real = codec.encode_crc_batch

    def slow(data, cell_bytes):
        time.sleep(0.3)
        return real(data, cell_bytes)

    codec.encode_crc_batch = slow

    async def t():
        batcher = ECBatcher(perf)
        first = asyncio.ensure_future(
            batcher.encode_cells(codec, rand_cells(1, seed=8)))
        for _ in range(400):  # wait until batch 1 is ON the executor
            if batcher._inflight:
                break
            await asyncio.sleep(0.005)
        assert batcher._inflight
        rest = [asyncio.ensure_future(
            batcher.encode_cells(codec, rand_cells(1, seed=9 + i)))
            for i in range(3)]
        await asyncio.gather(first, *rest)

    run(t())
    d = perf.dump()
    assert d["ec_batches"] == 2
    assert d["ec_flush_drain"] == 1
    assert d["ec_batch_stripes"]["sum"] == 4


def test_failure_rejects_every_waiter_exactly_once():
    """A failed dispatch must reject all waiters, count a failure, and
    contribute NOTHING to the throughput counters."""
    codec = codec_for()
    perf = make_perf()
    codec.encode_crc_batch = lambda data, cell_bytes: (_ for _ in ()).throw(
        RuntimeError("injected"))

    async def t():
        batcher = ECBatcher(perf)
        waits = [asyncio.ensure_future(
            batcher.encode_cells(codec, rand_cells(1, seed=20 + i)))
            for i in range(3)]
        results = await asyncio.gather(*waits, return_exceptions=True)
        assert all(isinstance(r, RuntimeError) for r in results)
        healthy = codec_for()
        parity, _ = await batcher.encode_cells(healthy,
                                               rand_cells(1, seed=30))
        assert parity.shape == (1, 2, 256)

    run(t())
    d = perf.dump()
    assert d["ec_batch_failures"] == 1
    assert d["ec_batch_failures_dispatch"] == 3
    assert d["ec_batches"] == 1  # only the healthy dispatch counted
    assert d["ec_batch_stripes"]["sum"] == 1


def test_bucket_key_is_profile_stable_not_id_based():
    """Two codec instances from the same profile share a bucket (and a
    batch); id()-reuse aliasing cannot happen by construction."""
    c1, c2 = codec_for(), codec_for()
    assert c1 is not c2
    assert codec_profile_key(c1) == codec_profile_key(c2)
    assert codec_profile_key(c1) == ("rs_tpu", "reed_sol_van", 3, 2,
                                     "device")
    assert codec_profile_key(codec_for(k="4")) != codec_profile_key(c1)
    assert codec_profile_key(codec_for(backend="host")) != \
        codec_profile_key(c1)
    perf = make_perf()

    async def t():
        batcher = ECBatcher(perf)
        a = asyncio.ensure_future(
            batcher.encode_cells(c1, rand_cells(1, seed=40)))
        b = asyncio.ensure_future(
            batcher.encode_cells(c2, rand_cells(1, seed=41)))
        (pa, _), (pb, _) = await asyncio.gather(a, b)
        assert (pa == host_parity(c1, rand_cells(1, seed=40))).all()
        assert (pb == host_parity(c2, rand_cells(1, seed=41))).all()

    run(t())
    assert perf.dump()["ec_batches"] == 1


def test_declared_counters_and_flush_reasons_match_reference():
    perf, jperf = make_perf(), JPerfCounters("j")
    JECBatcher.declare_counters(jperf)
    assert perf.dump() == jperf.dump()
    assert FLUSH_REASONS == ("size", "deadline", "fast", "tick", "drain")


# ------------------------------------------------------ fail-closed


def _one_stripe(seed):
    return np.random.default_rng(seed).integers(
        0, 256, (1, 3, 256), dtype=np.uint8)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_ec_batcher_fails_closed_per_op(backend):
    """An injected dispatch error fails ONLY the op whose stripes still
    fail alone: batch-mates recover via isolation, the queue keeps
    flowing, and the failure counters split by cause."""
    codec = codec_for(backend=backend)
    perf = make_perf()
    fault = FaultInjector()
    fault.arm("ec_batch", count=2)  # batch dispatch + first retry

    async def t():
        b = ECBatcher(perf, fault=fault)
        waits = [asyncio.ensure_future(b.encode_cells(codec, _one_stripe(i)))
                 for i in range(3)]
        results = await asyncio.gather(*waits, return_exceptions=True)
        failures = [r for r in results if isinstance(r, RuntimeError)]
        ok = [r for r in results if not isinstance(r, BaseException)]
        assert len(failures) == 1 and len(ok) == 2
        for parity, _crcs in ok:
            assert parity.shape == (1, 2, 256)
        parity, _ = await b.encode_cells(codec, _one_stripe(99))
        assert parity.shape == (1, 2, 256)

    run(t())
    d = perf.dump()
    assert d["ec_batch_failures"] == 1
    assert d["ec_batch_failures_injected"] == 1
    assert d["ec_batch_failures_dispatch"] == 0
    assert d["ec_batch_isolated"] == 2


def test_ec_batcher_failure_release_is_single_shot():
    """The failure path must release the bucket exactly once: a fresh
    batch that starts while the failed batch's isolation retries are
    still grinding owns the in-flight marker."""
    codec = codec_for(backend="host")
    perf = make_perf()

    async def t():
        b = ECBatcher(perf)
        seen = {}
        fail_gate = asyncio.Event()   # holds B1's failure path open
        b2_entered = asyncio.Event()
        b2_gate = asyncio.Event()     # holds B2 mid-dispatch
        state = {"calls": 0}
        real_disp = b._dispatch_once
        real_fail = b._fail_closed

        async def disp(loop, key, codec_, cells_):
            seen.setdefault("key", key)
            state["calls"] += 1
            if state["calls"] == 1:
                raise InjectedError("injected batch failure")
            if state["calls"] == 2:
                b2_entered.set()
                await b2_gate.wait()
            return await real_disp(loop, key, codec_, cells_)

        async def held_fail(loop, key, items, exc):
            await fail_gate.wait()
            await real_fail(loop, key, items, exc)

        b._dispatch_once = disp
        b._fail_closed = held_fail

        fut1 = asyncio.ensure_future(b.encode_cells(codec, _one_stripe(1)))
        while state["calls"] < 1:       # B1 dispatched and failed
            await asyncio.sleep(0.001)
        await asyncio.sleep(0.01)       # except path released + parked
        fut2 = asyncio.ensure_future(b.encode_cells(codec, _one_stripe(2)))
        await asyncio.wait_for(b2_entered.wait(), 5)
        key = seen["key"]
        assert key in b._inflight       # B2 owns the bucket
        fail_gate.set()                 # B1's _run finishes now
        await asyncio.sleep(0.05)
        assert key in b._inflight, \
            "failure path released the bucket twice"
        b2_gate.set()
        parity, _ = await asyncio.wait_for(fut2, 10)
        assert parity.shape == (1, 2, 256)
        with pytest.raises(RuntimeError):
            await fut1

    run(t())
    d = perf.dump()
    assert d["ec_batch_failures"] == 1
    assert d["ec_batch_failures_injected"] == 1


def test_close_fails_queued_waiters():
    codec = codec_for()

    async def t():
        b = ECBatcher(conf=make_conf(osd_ec_batch_window=5.0,
                                     osd_ec_batch_target_stripes=1000),
                      idle_probe=lambda: False)
        fut = asyncio.ensure_future(b.encode_cells(codec, _one_stripe(3)))
        await asyncio.sleep(0.01)
        assert b.parked() == 1
        b.close()
        with pytest.raises(RuntimeError, match="batched EC dispatch failed"):
            await fut
        assert b.parked() == 0

    run(t())


# --------------------------------------- over-decomposition, shield


def _su_for(codec, base=1024):
    """A stripe_unit that is a fixed point of get_chunk_size."""
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


@pytest.mark.parametrize("backend", ["host", "device"])
def test_overdecompose_decode_parity_random_draws(backend):
    """Over-decomposed decode is bit-identical to the single dispatch
    across random (k, m, erasure) draws, and the sub-task ledger
    balances: every block resolves once, its hedge duplicate is shed."""
    async def t():
        rng = np.random.default_rng(20260806)
        for trial in range(4):
            k = int(rng.integers(2, 6))
            m = int(rng.integers(1, 4))
            codec = codec_for({"plugin": "rs_tpu", "k": str(k),
                               "m": str(m), "backend": backend})
            su = _su_for(codec, 256)
            b = int(rng.integers(9, 48))
            cells = rng.integers(0, 256, (b, k, su), dtype=np.uint8)
            legacy = ECBatcher(perf=None,
                               conf={"osd_ec_cold_shape_bytes": 0})
            parity, _ = await legacy.encode_cells(codec, cells)
            every = np.concatenate([cells, parity], axis=1)
            lost = int(rng.integers(0, k))
            others = [x for x in range(k + m) if x != lost]
            present = tuple(sorted(
                rng.choice(others, size=k, replace=False).tolist()))
            want = tuple(j for j in range(k) if j not in present)
            surv = np.ascontiguousarray(every[:, list(present), :])
            base = await legacy.decode_cells(codec, present, want, surv)
            perf = _BatchPerf()
            ECBatcher.declare_counters(perf)
            od = ECBatcher(perf=perf, conf={"osd_ec_overdecompose": 3,
                                            "osd_ec_cold_shape_bytes": 0})
            got = await od.decode_cells(codec, present, want, surv)
            np.testing.assert_array_equal(
                base, got, err_msg=f"trial {trial} k={k} m={m} "
                                   f"present={present}")
            for i, j in enumerate(want):
                np.testing.assert_array_equal(got[:, i, :], cells[:, j, :])
            d = perf.c
            assert d["ec_overdecompose_rounds"] >= 1
            assert d["ec_overdecompose_subtasks"] == \
                2 * d["ec_overdecompose_shed"]
    run(t())


def test_repair_cells_has_no_batched_subchunk_repair_yet():
    """An rs codec has no batched sub-chunk repair (only Clay, a
    regenerating code, has one: ``test_repair_cells_rebuilds_a_clay_cell``):
    the dispatch fails closed with the reference's error."""
    codec = codec_for()
    perf = make_perf()

    async def t():
        b = ECBatcher(perf)
        with pytest.raises(RuntimeError, match="batched EC dispatch"):
            await b.repair_cells(codec, (1, 2), (0,), rand_cells(2, 2, 64))

    run(t())
    assert perf.dump()["ec_batch_failures_dispatch"] == 1
    with pytest.raises(RuntimeError, match="no batched sub-chunk repair"):
        ECBatcher()._repair_sync(codec, (1, 2), (0,), rand_cells(2, 2, 64))


def test_repair_cells_rebuilds_a_clay_cell():
    """Clay's batched sub-chunk repair through repair_cells: d helpers'
    repair planes (1/q of each cell) rebuild the lost cell byte for
    byte, counted as a decode batch."""
    codec = codec_for({"plugin": "clay", "k": "4", "m": "2", "d": "5"})
    su = codec.get_chunk_size(4 * 1024)
    cells = rand_cells(3, 4, su, seed=7)
    every = np.concatenate([cells, np.stack(
        [codec.encode_chunks(c) for c in cells])], axis=1)
    lost = 3
    plan = codec.minimum_to_decode([lost], [i for i in range(6) if i != lost])
    order = sorted(plan)
    sub = su // codec.get_sub_chunk_count()
    slices = np.stack([np.concatenate(
        [every[:, c, o * sub:(o + n) * sub] for o, n in plan[c]], axis=1)
        for c in order], axis=1)
    assert slices.shape == (3, codec.d, su // codec.q)
    perf = make_perf()

    async def t():
        b = ECBatcher(perf)
        got = await b.repair_cells(codec, tuple(order), (lost,), slices)
        assert np.array_equal(got[:, 0], every[:, lost])

    run(t())
    d = perf.dump()
    assert d["ec_decode_batches"] == 1 and d["ec_batch_failures"] == 0


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
        self.calls.append("device")
        return surviving[:, :len(want), :].clone()


def test_cold_shape_shield_promotes_after_volume():
    """A decode survivor pattern stays on the host engine until its
    cumulative bytes cross osd_ec_cold_shape_bytes; the promotion warms
    the device path on a background thread (rounds keep landing host
    meanwhile), and only then does the pattern take the device path.
    Each pattern keeps its own ledger, and 0 disables the shield."""
    perf = _BatchPerf()
    ECBatcher.declare_counters(perf)
    b = ECBatcher(perf=perf, conf={"osd_ec_cold_shape_bytes": 100})
    codec = _EngineProbe()
    cells = np.arange(4 * 2 * 8, dtype=np.uint8).reshape(4, 2, 8)
    key = ("dec", ("probe", "", 2, 1, "device"), 8, (0, 1), (2,))
    for _ in range(2):  # 64 B/round: cold at 0 and at 64 cumulative
        out = b._decode_sync(codec, (0, 1), (2,), cells)
        np.testing.assert_array_equal(out, cells[:, :1, :])
    assert codec.calls == ["host", "host"]
    assert perf.c["ec_decode_cold_host"] == 2
    out = b._decode_sync(codec, (0, 1), (2,), cells)  # 128 >= 100
    np.testing.assert_array_equal(out, cells[:, :1, :])
    assert perf.c["ec_decode_cold_host"] == 3
    assert codec.calls.count("host") == 3
    for _ in range(200):  # the warm thread flips the promotion flag
        if b._shape_warm.get(key) is True:
            break
        time.sleep(0.01)
    assert b._shape_warm[key] is True
    assert b.warm_seconds[key] >= 0.0
    assert codec.calls.count("device") == 1  # the warm dispatch itself
    out = b._decode_sync(codec, (0, 1), (2,), cells)  # promoted
    np.testing.assert_array_equal(out, cells[:, :1, :])
    assert codec.calls.count("device") == 2
    assert perf.c["ec_decode_cold_host"] == 3
    b._decode_sync(codec, (0, 2), (1,), cells)
    assert codec.calls[-1] == "host"
    off = ECBatcher(perf=None, conf={"osd_ec_cold_shape_bytes": 0})
    fresh = _EngineProbe()
    off._decode_sync(fresh, (0, 1), (2,), cells)
    assert fresh.calls == ["device"]


def test_cold_shape_default_is_the_references():
    assert ecbatch.COLD_SHAPE_BYTES == 256 << 20
    assert ECBatcher()._cold_shape_bytes() == 256 << 20
    assert ECBatcher(conf=make_conf())._cold_shape_bytes() == 256 << 20


# ----------------------------------------- the port's own decisions


@pytest.mark.parametrize("knobs", [{"osd_ec_mesh_devices": 2},
                                   {"osd_ec_mesh_devices": 8,
                                    "osd_ec_mesh_width": 2},
                                   {"parallel_repair_mode": "allgather"},
                                   {"parallel_repair_mode": "psum_bits"}])
@pytest.mark.parametrize("as_dict", [False, True])
def test_mesh_knobs_raise(knobs, as_dict):
    """Each knob set constructs a batcher and dispatches over the
    virtual CPU mesh (``pin_virtual(8)``) exactly where the JAX batcher
    resolves a mesh for the same conf (a plain dict without
    ``osd_ec_mesh_width`` resolves none in either package), with the
    one-device batcher's bytes and CRCs. The same knobs with a mesh that
    cannot be had (4096 slots, past the pinned 8 and the machine's
    cards) raise at dispatch: the port never drops to one device."""
    from ceph_tpu_torch import parallel

    parallel.pin_virtual(8)
    conf = dict(knobs) if as_dict else make_conf(**knobs)
    jconf = dict(knobs) if as_dict else jcfg.proxy()
    if not as_dict:
        jconf.apply(knobs)
    codec = codec_for()
    cells = rand_cells(6, seed=len(knobs))

    async def t():
        b, single = ECBatcher(conf=conf), ECBatcher()
        pm, cm = await b.encode_cells(codec, cells)
        ps, cs = await single.encode_cells(codec, cells)
        assert np.array_equal(pm, ps) and np.array_equal(cm, cs)
        every = np.concatenate([cells, ps], axis=1)
        surv = np.ascontiguousarray(every[:, [0, 2, 4]])
        got = await b.decode_cells(codec, (0, 2, 4), (1,), surv)
        assert np.array_equal(got[:, 0], cells[:, 1])
        return b

    b = asyncio.run(asyncio.wait_for(t(), 120))
    assert (b.mesh() is None) == (JECBatcher(conf=jconf).mesh() is None)
    big = {**knobs, "osd_ec_mesh_devices": 4096, "osd_ec_mesh_width": 2}
    refused = ECBatcher(conf=dict(big) if as_dict else make_conf(**big))
    with pytest.raises(RuntimeError, match="pin_virtual"):
        refused._encode_sync(codec, cells)


def test_mesh_knob_set_at_runtime_fails_the_dispatch():
    """An oversized mesh count set at run time fails the dispatch (the
    op sees the batcher's failure), never a quiet one-device run: the
    batcher resolves its mesh at the first dispatch, and a mesh that
    cannot be had raises there and is not cached."""
    conf = make_conf(osd_ec_mesh_devices=1)
    perf = make_perf()
    codec = codec_for()

    async def t():
        b = ECBatcher(perf, conf=conf)
        conf.set("osd_ec_mesh_devices", 4096)
        with pytest.raises(RuntimeError, match="batched EC dispatch"):
            await b.encode_cells(codec, _one_stripe(5))
        with pytest.raises(RuntimeError, match="pin_virtual"):
            b._encode_sync(codec, _one_stripe(5))
        assert not b._mesh_resolved

    run(t())
    assert perf.dump()["ec_batch_failures_dispatch"] == 1
    assert perf.dump()["ec_batches"] == 0


def test_host_backend_encodes_and_decodes_through_native(monkeypatch):
    codec = codec_for(backend="host")
    assert codec.resolved_backend() == "host"
    assert codec_for().resolved_backend() == "device"
    assert codec_for(backend="auto").resolved_backend() == "device"
    calls = []
    real_encode, real_matmul = native.rs_encode, native.rs_matmul

    def rs_encode(*a, **k):
        calls.append("rs_encode")
        return real_encode(*a, **k)

    def rs_matmul(*a, **k):
        calls.append("rs_matmul")
        return real_matmul(*a, **k)

    monkeypatch.setattr(native, "rs_encode", rs_encode)
    monkeypatch.setattr(native, "rs_matmul", rs_matmul)

    def no_device(*a, **k):
        raise AssertionError("backend=host reached the device seam")

    codec.encode_crc_batch = no_device
    codec.decode_batch = no_device
    cells = rand_cells(7, seed=11)

    async def t():
        b = ECBatcher()
        parity, crcs = await b.encode_cells(codec, cells)
        assert crcs is None and (parity == host_parity(codec, cells)).all()
        every = np.concatenate([cells, parity], axis=1)
        out = await b.decode_cells(codec, (1, 3, 4), (0, 2),
                                   np.ascontiguousarray(every[:, [1, 3, 4]]))
        assert (out == cells[:, [0, 2]]).all()

    run(t())
    # rs_encode is rs_matmul under the coding matrix; then the decode
    assert calls == ["rs_encode", "rs_matmul", "rs_matmul"]
    # the byte API of a host codec runs on the C++ core too
    calls.clear()
    chunks = codec.encode(range(5), cells.tobytes())
    assert calls == ["rs_matmul"] and len(chunks) == 5


def test_staged_results_never_alias_inputs_or_later_batches():
    codec = codec_for()
    cells = rand_cells(4, seed=12)

    async def t():
        b = ECBatcher()
        parity, crcs = await b.encode_cells(codec, cells)
        held = parity.copy(), crcs.copy()
        assert not np.shares_memory(parity, cells)
        for i in range(3):
            p2, c2 = await b.encode_cells(codec, rand_cells(4, seed=13 + i))
            assert not np.shares_memory(p2, parity)
        assert np.array_equal(parity, held[0])
        assert np.array_equal(crcs, held[1])

    run(t())


def test_transposed_view_submission_equals_contiguous():
    """The RMW path submits the (T, k, su) transpose of its shard-major
    staging buffer; the one staging copy reads it as it lies."""
    codec = codec_for()
    shard_major = np.ascontiguousarray(
        rand_cells(6, seed=14).transpose(1, 0, 2))
    view = shard_major.transpose(1, 0, 2)
    assert not view.flags.c_contiguous

    async def t():
        b = ECBatcher()
        (pv, cv), (pc, cc) = await asyncio.gather(
            b.encode_cells(codec, view),
            b.encode_cells(codec, np.ascontiguousarray(view)))
        assert np.array_equal(pv, pc) and np.array_equal(cv, cc)
        assert np.array_equal(pv, host_parity(codec, view))

    run(t())


def test_no_card_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_codec(dict(DEV_PROFILE))
    with pytest.raises(RuntimeError, match="CUDA"):
        load_codec({**DEV_PROFILE, "backend": "host"})


def test_launch_counter_is_exact_under_threads(monkeypatch):
    """Eight threads launching at once lose no count (the counter is
    bumped under the kernel's lock)."""
    k = kernels.Kernel("probe", "gf_matmul.cu", "probe", [])
    k._fn = lambda *args: 0

    class _Stream:
        cuda_stream = 0

    monkeypatch.setattr(torch.cuda, "device", lambda d: threading.Lock())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: _Stream())
    per_thread = 20000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [k.launch("cuda") for _ in range(per_thread)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert k.launches == 8 * per_thread


# ------------------------------------- one schedule, both packages


def _schedule():
    """Groups of submissions; each group is submitted in one reactor
    tick and awaited before the next. (kind, present, want, cells)."""
    rng = np.random.default_rng(20261016)

    def cells(b, k=3):
        return rng.integers(0, 256, (b, k, 256), dtype=np.uint8)

    shard_major = np.ascontiguousarray(cells(4).transpose(1, 0, 2))
    enc = [
        [("enc", None, None, cells(1)) for _ in range(3)],  # fault fires
        [("enc", None, None, cells(5)), ("enc", None, None, cells(1)),
         ("enc", None, None, cells(1))],                    # size flush
        [("enc", None, None, shard_major.transpose(1, 0, 2)),
         ("enc", None, None, cells(2))],                    # views
    ]
    return enc


async def _drive(batcher, codec, groups, wait_warm):
    outs = []
    for group in groups:
        futs = []
        for kind, present, want, c in group:
            if kind == "enc":
                futs.append(batcher.encode_cells(codec, c))
            else:
                futs.append(batcher.decode_cells(codec, present, want, c))
        res = await asyncio.gather(*futs, return_exceptions=True)
        outs.append(res)
        for _ in range(2000):
            if all(wait_warm(batcher)):
                break
            await asyncio.sleep(0.01)
    return outs


def test_same_schedule_same_bytes_crcs_and_counters_as_reference():
    """One schedule (tick and size flushes, an injected batch failure
    with isolation retries, transposed views, cold and promoted decode
    patterns, a wanted parity row) through the JAX package's ECBatcher
    and the port's: equal bytes, uint32 CRCs and perf counters (the
    queue-wait values aside)."""
    enc = _schedule()
    groups = list(enc)
    data = np.concatenate([c for g in enc for _, _, _, c in g])
    flat = np.ascontiguousarray(data.transpose(1, 0, 2)).reshape(3, -1)
    par = gf8.gf_matmul(gf8.vandermonde_rs_matrix(3, 2), flat)
    every = np.concatenate(
        [data, par.reshape(2, len(data), 256).transpose(1, 0, 2)], axis=1)
    surv = {p: np.ascontiguousarray(every[:6, list(p)])
            for p in ((0, 2, 4), (1, 2, 3), (0, 1, 2))}
    dec = [
        [("dec", (0, 2, 4), (1, 3), surv[(0, 2, 4)][:3]),
         ("dec", (0, 2, 4), (1, 3), surv[(0, 2, 4)][3:])],   # cold, host
        [("dec", (0, 2, 4), (1, 3), surv[(0, 2, 4)])],       # crosses: warm
        [("dec", (0, 2, 4), (1, 3), surv[(0, 2, 4)])],       # promoted
        [("dec", (1, 2, 3), (0, 4), surv[(1, 2, 3)]),
         ("dec", (0, 1, 2), (3,), surv[(0, 1, 2)])],         # new patterns
    ]
    groups += dec
    conf_knobs = {"osd_ec_batch_window": 0.0,
                  "osd_ec_batch_target_stripes": 4,
                  "osd_ec_cold_shape_bytes": 3000}

    def warm_done(b):
        return list(b._shape_warm.values())

    jperf = JPerfCounters("j")
    JECBatcher.declare_counters(jperf)
    jfault = JFaultInjector()
    jfault.arm("ec_batch", count=1, stripes=3)
    jconf = jcfg.proxy()
    jconf.apply(conf_knobs)
    perf = make_perf()
    fault = FaultInjector()
    fault.arm("ec_batch", count=1, stripes=3)

    async def both():
        jb = JECBatcher(jperf, conf=jconf, fault=jfault)
        want = await _drive(jb, jload_codec(dict(DEV_PROFILE)), groups,
                            warm_done)
        b = ECBatcher(perf, conf=make_conf(**conf_knobs), fault=fault)
        got = await _drive(b, codec_for(), groups, warm_done)
        return want, got, b

    want, got, b = asyncio.run(asyncio.wait_for(both(), 300))
    assert len(got) == len(want) == len(groups)
    for gi, (g_got, g_want) in enumerate(zip(got, want)):
        for r_got, r_want in zip(g_got, g_want):
            assert not isinstance(r_got, BaseException), (gi, r_got)
            if isinstance(r_want, tuple):
                parity, crcs = r_got
                jparity, jcrcs = (np.asarray(x) for x in r_want)
                assert parity.dtype == jparity.dtype == np.uint8
                assert crcs.dtype == jcrcs.dtype == np.uint32
                assert np.array_equal(parity, jparity), gi
                assert np.array_equal(crcs, jcrcs), gi
            else:
                assert r_got.dtype == np.asarray(r_want).dtype == np.uint8
                assert np.array_equal(r_got, np.asarray(r_want)), gi
    # every rebuilt row is the original cell
    rebuilt = got[len(enc)][0]
    assert np.array_equal(rebuilt[:, 0], data[:3, 1])
    assert np.array_equal(rebuilt[:, 1], every[:3, 3])
    d, jd = perf.dump(), jperf.dump()
    d.pop("ec_queue_wait_us")
    assert jd.pop("ec_queue_wait_us")["count"] > 0
    assert d == jd
    assert d["ec_batch_isolated"] == 3 and d["ec_batch_failures"] == 1
    assert d["ec_flush_size"] >= 1 and d["ec_flush_tick"] >= 1
    assert d["ec_decode_cold_host"] == 4  # cold, crossing, 2 new patterns
    assert d["ec_decode_batches"] == 5
    assert all(b._shape_warm.values())
