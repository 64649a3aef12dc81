"""The port's utility modules (``ceph_tpu_torch.utils``: config, perf,
fault) against the JAX package's copies: the option schema option by
option, and the same call sequences through both ConfigProxy,
PerfCounters and FaultInjector objects. Tolerance: exact equality."""
import asyncio
import random

import pytest

from ceph_tpu.utils import config as jcfg
from ceph_tpu.utils import fault as jfault
from ceph_tpu.utils import perf as jperf
from ceph_tpu_torch.utils import config as cfg
from ceph_tpu_torch.utils import fault
from ceph_tpu_torch.utils import perf
from test_torch_native import jax_native_whole  # noqa: F401

FIELDS = ("name", "type", "default", "min", "max", "enum", "runtime")


def test_schema_has_every_reference_option():
    assert cfg.SCHEMA.names() == jcfg.SCHEMA.names()


@pytest.mark.parametrize("name", jcfg.SCHEMA.names())
def test_option_equals_reference(name):
    got, want = cfg.SCHEMA.get(name), jcfg.SCHEMA.get(name)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), (name, f)
    assert type(got.default) is type(want.default)
    assert cfg.proxy()[name] == jcfg.proxy()[name]


@pytest.mark.parametrize("name,value", [
    ("osd_pg_log_keep", "256"), ("osd_pg_log_keep", 0),
    ("store_kind", "rocks"), ("walstore_compact_bytes", "8K"),
    ("walstore_compact_bytes", "1MiB"), ("walstore_fsync", "yes"),
    ("walstore_fsync", "maybe"), ("osd_ec_cold_shape_bytes", "1g"),
    ("osd_ec_batch_window", "0.02"), ("debug_default", 21),
    ("parallel_repair_mode", "psum_bits"), ("osd_hedge_delay_factor", 0.5),
    ("osd_ec_batch_target_stripes", "x"),
])
def test_coerce_equals_reference(name, value):
    opt, jopt = cfg.SCHEMA.get(name), jcfg.SCHEMA.get(name)
    try:
        want = jopt.coerce(value)
    except jcfg.ConfigError:
        with pytest.raises(cfg.ConfigError):
            opt.coerce(value)
        return
    got = opt.coerce(value)
    assert got == want and type(got) is type(want)


def test_proxy_set_observe_freeze_like_reference():
    seen, jseen = [], []
    c, jc = cfg.proxy(), jcfg.proxy()
    c.observe("osd_heartbeat_grace", lambda n, v: seen.append((n, v)))
    jc.observe("osd_heartbeat_grace", lambda n, v: jseen.append((n, v)))
    for proxy in (c, jc):
        proxy.apply({"osd_heartbeat_grace": 5.0, "store_kind": "walstore",
                     "osd_ec_batch_target_stripes": "64"})
        proxy.set("osd_heartbeat_grace", 5.0)  # no change -> no fire
        proxy.set("osd_heartbeat_grace", "6")
        proxy.reset("osd_ec_batch_target_stripes")
        proxy.freeze()
    assert seen == jseen == [("osd_heartbeat_grace", 5.0),
                             ("osd_heartbeat_grace", 6.0)]
    with pytest.raises(cfg.ConfigError):
        c.set("store_kind", "memstore")
    with pytest.raises(cfg.ConfigError):
        c.get("no_such_option")
    assert c.diff() == jc.diff()
    assert c.show() == jc.show()
    assert c.is_set("store_kind") and not c.is_set("osd_pg_log_keep")


def _drive_perf(mod):
    p = mod.PerfCounters("osd.0")
    p.add_u64_counter("ops")
    p.add_gauge("load")
    p.add_time_avg("lat")
    p.add_histogram("batch")
    p.inc("ops")
    p.inc("ops", 4)
    p.set("load", 0.7)
    p.tinc("lat", 0.5)
    p.tinc("lat", 1.5)
    for v in (0, 0.5, 1, 3, 64, 100, 1 << 20):
        p.observe("batch", v)
    with pytest.raises(KeyError):
        p.add_gauge("load")
    coll = mod.PerfCountersCollection()
    q = coll.create("mon")
    q.add_u64_counter("x")
    q.inc("x", 3)
    with pytest.raises(KeyError):
        coll.create("mon")
    return p.dump(), coll.dump()


def test_perf_counters_dump_equals_reference():
    assert _drive_perf(perf) == _drive_perf(jperf)
    p = perf.PerfCounters("t")
    p.add_time_avg("lat")
    with p.time("lat"):
        pass
    assert p.dump()["lat"]["avgcount"] == 1


def _drive_faults(mod, seed):
    inj = mod.FaultInjector()
    fired_sites = []
    inj.on_fire = fired_sites.append
    inj.arm("ec_batch", count=2)
    inj.arm("ec_sub_read", p=0.3, rng=random.Random(seed), oid="a")
    inj.arm("torn_write", count=-1, shard=1)
    hits = []
    for i in range(40):
        hits.append(inj.hit("ec_batch", kind="enc", stripes=i))
        hits.append(inj.hit("ec_sub_read", oid="a" if i % 3 else "b"))
        hits.append(inj.hit("torn_write", shard=i % 2))
        hits.append(inj.hit("unarmed"))
    fired = {s: inj.fired(s) for s in ("ec_batch", "ec_sub_read",
                                       "torn_write", "unarmed")}
    all_fired = inj.fired_all()
    inj.disarm("torn_write")
    after = inj.hit("torn_write", shard=1)
    inj.clear()
    return hits, fired, all_fired, after, fired_sites, inj.fired("ec_batch")


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_fault_injector_equals_reference(seed):
    got = _drive_faults(fault, seed)
    assert got == _drive_faults(jfault, seed)
    assert got[1]["ec_batch"] == 2
    assert issubclass(fault.InjectedError, RuntimeError)


def test_fault_pause_delays_only_when_armed():
    inj = fault.FaultInjector()

    async def t():
        assert await inj.pause("ec_local_read") is False
        inj.arm("ec_local_read", count=1, delay=0.01)
        assert await inj.pause("ec_local_read") is True
        assert await inj.pause("ec_local_read") is False
        inj.arm("slow", delay_log=(-6.0, 0.1), rng=random.Random(3))
        assert await inj.pause("slow") is True

    asyncio.run(asyncio.wait_for(t(), 30))
    assert inj.fired("ec_local_read") == 1 and inj.fired("slow") == 1
