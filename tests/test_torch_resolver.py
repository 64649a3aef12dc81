"""One seeded lookup schedule through the JAX package's PlacementResolver
and the port's (batches on the CPU: the bulk engine's plain version).
The schedule covers sync and async lookups, prewarm, an epoch bump in the
middle of a window, a replaced map that goes cold, warms and dispatches,
an unsupported map and a batch below the minimum. Every row and every
counter must be equal. Tolerance: exact equality."""
import asyncio
import types

import numpy as np
import pytest
import torch

from ceph_tpu.placement import crushmap as jcm
from ceph_tpu.placement import encoding as jenc
from ceph_tpu.placement import osdmap as josd
from ceph_tpu.placement import resolver as jres
from ceph_tpu.utils import config as jcfg
from ceph_tpu_torch import convert
from ceph_tpu_torch.placement import osdmap as posd
from ceph_tpu_torch.placement import resolver as pres
from ceph_tpu_torch.utils import config as pcfg
from test_torch_native import jax_native_whole  # noqa: F401

torch.set_num_threads(1)

JAX = types.SimpleNamespace(resolver=jres, osdmap=josd, cfg=jcfg,
                            kwargs={}, carry=lambda blob: jenc.decode_osdmap(
                                blob)[0])
PORT = types.SimpleNamespace(resolver=pres, osdmap=posd, cfg=pcfg,
                             kwargs={"device": "cpu"},
                             carry=convert.osdmap_from_reference)


def _reference_blob(seed: int, local_tries: int = 0) -> bytes:
    """An OSDMap built in the JAX package: a 4 x 6 host tree with a
    replicated pool (64 PGs) and an EC pool (32 PGs), as its wire bytes."""
    crush = jcm.build_hierarchy(osds_per_host=4, n_hosts=6)
    crush.tunables.choose_local_tries = local_tries
    crush.add_rule(jcm.replicated_rule(0, root=-1, failure_domain_type=1))
    crush.add_rule(jcm.ec_rule(1, root=-1, failure_domain_type=1))
    om = josd.OSDMap(crush, 24)
    om.add_pool(josd.Pool(id=1, name="r", size=3, pg_num=64, crush_rule=0))
    om.add_pool(josd.Pool(id=2, name="e", size=5, min_size=4, pg_num=32,
                          crush_rule=1, type="erasure"))
    rng = np.random.default_rng(seed)
    om.osds[int(rng.integers(24))].weight = 0x8000
    om.pg_upmap_items[(1, 7)] = [(int(rng.integers(24)), 23)]
    om.pg_temp[(2, 5)] = [1, 5, 9, 13, 17]
    return jenc.encode_osdmap(om)


def _rows(got):
    return [(tuple(up), upp, tuple(acting), ap) for up, upp, acting, ap in got]


async def _schedule(pkg, seed: int = 20261017) -> tuple[list, dict, dict]:
    """Drive one resolver through the schedule; -> (rows, counters at
    each stage, final counters)."""
    rng = np.random.default_rng(seed)
    blob = _reference_blob(seed)
    om = pkg.carry(blob)
    conf = pkg.cfg.proxy()
    conf.set("client_placement_batch_min", 8)
    r = pkg.resolver.PlacementResolver(conf=conf, batch=True, **pkg.kwargs)
    rows, stages = [], {}
    inc_cls = pkg.osdmap.Incremental

    async def storm(osdmap, pool_id, pss):
        rows.extend(_rows(await asyncio.gather(
            *(r.afull(osdmap, (pool_id, int(ps))) for ps in pss))))

    # sync surface: misses resolve on the host, repeats hit the memo
    for ps in rng.integers(0, 64, 12):
        rows.append(_rows([r.full(om, (1, int(ps)))])[0])
        rows.append((tuple(r.up_acting(om, (1, int(ps)))[0]),))
    stages["sync"] = r.stats.dump()
    # first async storm: cold shape, host serves
    await storm(om, 1, range(64))
    stages["cold"] = r.stats.dump()
    # prewarm both pools: device batches of the size target
    rows.append((await r.prewarm(om, [1, 2]),))
    stages["prewarm"] = r.stats.dump()
    # an epoch bump, then warm storms over both pools
    om.apply_incremental(inc_cls(epoch=om.epoch + 1, weights={3: 0}))
    await storm(om, 1, range(64))
    await storm(om, 2, range(32))
    stages["warm"] = r.stats.dump()
    # an epoch bump while a window is open: answers come from the new map
    conf.set("client_placement_batch_window", 0.02)
    futs = [asyncio.ensure_future(r.afull(om, (1, ps))) for ps in range(40)]
    om.apply_incremental(inc_cls(epoch=om.epoch + 1, down=[9],
                                 weights={9: 0}))
    rows.extend(_rows(await asyncio.gather(*futs)))
    conf.set("client_placement_batch_window", 0.002)
    stages["mid_window"] = r.stats.dump()
    # a replaced map (same epoch, new objects): cold twice, a background
    # warm, then device batches
    om2 = pkg.carry(blob)
    om2.epoch = om.epoch
    await storm(om2, 1, range(64))
    om2.apply_incremental(inc_cls(epoch=om2.epoch + 1, weights={5: 0x4000}))
    await storm(om2, 1, range(64))
    for _ in range(400):
        if r.stats.placement_bg_warms >= 1:
            break
        await asyncio.sleep(0.01)
    om2.apply_incremental(inc_cls(epoch=om2.epoch + 1, weights={5: 0x10000}))
    await storm(om2, 1, range(64))
    stages["replaced"] = r.stats.dump()
    # a batch below the minimum resolves on the host
    om2.apply_incremental(inc_cls(epoch=om2.epoch + 1))
    await storm(om2, 2, range(5))
    stages["below_min"] = r.stats.dump()
    # an unsupported map (local retries): rejected once, host serves
    om3 = pkg.carry(_reference_blob(seed, local_tries=2))
    await storm(om3, 1, range(64))
    stages["unsupported"] = r.stats.dump()
    assert r._compiles[id(om3.crush)].rejected
    # the sync surface after all that
    for ps in range(0, 32, 3):
        rows.append(_rows([r.full(om3, (2, ps))])[0])
        assert rows[-1] == _rows([om3.pg_to_up_acting_full((2, ps))])[0]
    r.close()
    return rows, stages, r.stats.dump()


def test_one_schedule_through_both_resolvers_is_equal():
    saved = jres._DEVICE_BROKEN
    try:
        jrows, jstages, jfinal = asyncio.run(_schedule(JAX))
    finally:
        jres._DEVICE_BROKEN = saved
    prows, pstages, pfinal = asyncio.run(_schedule(PORT))
    assert pstages == jstages
    assert pfinal == jfinal
    assert prows == jrows
    # the schedule took every route
    assert pfinal["placement_batch_lookups"] >= 6
    assert pfinal["placement_bg_warms"] >= 1
    assert pfinal["placement_epoch_invalidations"] >= 5
    assert pstages["cold"]["placement_batch_lookups"] == 0


def test_port_rows_equal_the_host_pipeline():
    async def run():
        om = PORT.carry(_reference_blob(5))
        r = pres.PlacementResolver(batch=True, device="cpu")
        assert await r.prewarm(om, [1, 2]) == 96
        om.apply_incremental(posd.Incremental(epoch=2, weights={2: 0}))
        for pool_id, n in ((1, 64), (2, 32)):
            got = await asyncio.gather(*(r.afull(om, (pool_id, ps))
                                         for ps in range(n)))
            for ps, g in enumerate(got):
                assert g == om.pg_to_up_acting_full((pool_id, ps))
        return r.stats.dump()

    stats = asyncio.run(run())
    assert stats["placement_batch_lookups"] == 4
    assert stats["placement_batched_pgids"] == 192


def test_engine_failure_reaches_the_waiters(monkeypatch):
    """With no card, a resolver left on the default device cannot run a
    batch, and says so. prewarm raises. The first two cold storms are
    the host's by policy, and the second one's background warm fails;
    the next batch of that rule raises the warm's error to every waiter.
    The sync surface still serves from the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    async def run():
        om = PORT.carry(_reference_blob(6))
        r = pres.PlacementResolver(batch=True)
        with pytest.raises(RuntimeError, match="no.* available|none is"):
            await r.prewarm(om, [1])
        for epoch in (2, 3):
            om.apply_incremental(posd.Incremental(epoch=epoch))
            got = await asyncio.gather(*(r.afull(om, (1, ps))
                                         for ps in range(64)))
            for ps, g in enumerate(got):
                assert g == om.pg_to_up_acting_full((1, ps))
        entry = r._compiles[id(om.crush)]
        for _ in range(100):
            if entry.warm_errors:
                break
            await asyncio.sleep(0.01)
        assert list(entry.warm_errors) == [(0, 3)]
        om.apply_incremental(posd.Incremental(epoch=4))
        got = await asyncio.gather(*(r.afull(om, (1, ps))
                                     for ps in range(64)),
                                   return_exceptions=True)
        assert all(isinstance(g, RuntimeError) and "CUDA" in str(g)
                   for g in got)
        assert not entry.warm_errors
        assert r.full(om, (1, 0)) == om.pg_to_up_acting_full((1, 0))
        return r.stats.dump()

    stats = asyncio.run(run())
    assert stats["placement_batch_lookups"] == 0
    assert stats["placement_bg_warms"] == 0
    assert stats["placement_host_resolves"] == 129


@pytest.mark.parametrize("lever", ["env", "arg"])
def test_ab_lever_disables_batching(monkeypatch, lever):
    if lever == "env":
        monkeypatch.setenv("CEPH_TPU_PLACEMENT_BATCH", "0")

    async def run():
        om = PORT.carry(_reference_blob(7))
        kwargs = {} if lever == "env" else {"batch": False}
        r = pres.PlacementResolver(device="cpu", **kwargs)
        got = await asyncio.gather(*(r.afull(om, (1, ps))
                                     for ps in range(64)))
        for ps, g in enumerate(got):
            assert g == om.pg_to_up_acting_full((1, ps))
        assert await r.prewarm(om, [1]) == 0
        return r.stats.dump()

    stats = asyncio.run(run())
    assert stats["placement_batch_lookups"] == 0
    assert stats["placement_host_resolves"] == 64
