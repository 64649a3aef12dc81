"""The cases of ``tests/test_swarm.py`` on the port's harness
(``ceph_tpu_torch.tools.swarm``), every run on ``device="cpu"`` (the
kernels' plain versions), copied with only their imports and device
changed; the reference's bounds and its ``slow`` mark stay as they are.
The reference's own words follow.

Swarm harness (tools/swarm.py): scaled-down tier-1 proofs of the
serving-plane claims — percentile reporting per op shape, batched
placement engagement under Zipf skew, mClock tenant isolation at
saturation, and the combined thrash-during-swarm scenario. Bench
config 10 runs the same engine at production shape (2,400 clients /
O(10^4) in-flight); these keep the contracts honest per-commit.
"""
import asyncio

import pytest
import torch

from ceph_tpu_torch.tools import swarm

# one intra-op thread: the plain versions are small tensor ops
torch.set_num_threads(1)

#: 4 KiB-only mix: tier-1 runs skip the 4 MiB EC shape (it exists to
#: load the batcher, which test_ec_batcher already proves; here it
#: would just burn suite seconds)
MIX_4K = {"put4k": 0.5, "get4k": 0.4, "omap": 0.1}


def test_swarm_smoke_reports_percentiles_per_shape():
    out = asyncio.run(swarm.run_swarm(
        device="cpu",
        clients=100, duration=0.9, seed=3, n_osds=4,
        n_rados_clients=2, window=128, actor_depth=4,
        mix=MIX_4K, prewarm=False))
    assert out["ops"] > 0
    assert out["op_errors"] == {}
    for shape in MIX_4K:
        rep = out["shapes"][shape]
        assert rep["ops"] > 0
        assert rep["p50_ms"] <= rep["p99_ms"] <= rep["p999_ms"]
    # the window machinery actually pipelined (not serial awaits)
    assert out["inflight_peak"] > 20
    assert out["distinct_objects_touched"] > 10


def test_swarm_batched_placement_engages_under_zipf():
    out = asyncio.run(swarm.run_swarm(
        device="cpu",
        clients=120, duration=1.2, seed=4, n_osds=4,
        n_rados_clients=2, window=192, actor_depth=4,
        mix=MIX_4K, prewarm=True, placement_batch=True))
    place = out["placement"]
    assert place["placement_batch_lookups"] > 0
    # Zipf-skewed traffic over stable pg tables: overwhelmingly hits
    assert place["hit_rate"] > 0.90
    # A/B arm: lever off => zero batched lookups, same service
    ab = asyncio.run(swarm.run_swarm(
        device="cpu",
        clients=60, duration=0.8, seed=4, n_osds=4,
        n_rados_clients=1, window=96, actor_depth=4,
        mix=MIX_4K, prewarm=False, placement_batch=False))
    assert ab["placement"]["placement_batch_lookups"] == 0
    assert ab["ops"] > 0


@pytest.mark.slow
def test_swarm_mclock_tenant_isolation():
    """The satellite proof: a reservation-backed latency tenant keeps
    bounded tails and its reservation throughput while a bulk tenant
    saturates the same daemons (cluster/scheduler.py knobs under
    load, finally counter-proven). @slow: the isolation margin is a
    CONTENTION measurement — under a full parallel tier-1 suite the
    host itself starves both tenants and the ratio flakes; tier-2
    runs it on a quiet box where the scheduler, not the CI load, is
    what's measured."""
    out = asyncio.run(swarm.run_swarm(
        device="cpu",
        clients=220, duration=3.0, seed=5, n_osds=4,
        n_rados_clients=2, window=512, actor_depth=6, mix=MIX_4K,
        prewarm=False,
        qos={"reservation_ops_s": 20.0, "lat_actors": 6,
             "pace_s": 0.01}))
    q = out["qos"]
    # saturation really happened: the bulk tenant queued deeply
    assert out["inflight_sustained"] > 200
    assert q["bulk_p99_ms"] > 0
    # isolation: the latency tenant's p99 is decisively below the
    # bulk tenant's (reservation-phase dequeue jumps the queue)
    assert q["lat_p99_ms"] < q["bulk_p99_ms"] / 2, q
    # and its achieved rate is real service, not starvation (floor is
    # deliberately generous for 2-core CI: the reservation admits it
    # to a worker per service slot; shared-CPU service time bounds
    # the absolute rate, starvation would read ~0)
    assert q["lat_achieved_ops_s"] >= 5.0, q


def test_swarm_thrash_arm_converges():
    """Combined scenario: a seeded kill/revive schedule DURING the
    swarm; post-heal the cluster must converge and the epoch bumps
    must show up in the resolver's invalidation counter."""
    out = asyncio.run(swarm.run_swarm(
        device="cpu",
        clients=40, duration=2.0, seed=6, n_osds=5,
        n_rados_clients=2, window=128, actor_depth=4, mix=MIX_4K,
        prewarm=True, thrash_secs=1.5))
    assert out["thrash"]["converged"]
    assert out["thrash"]["events"], "schedule must have fired"
    assert out["ops"] > 0
    # epoch-bump -> invalidation -> re-resolve correctness is pinned
    # deterministically in test_placement_resolver; here the map churn
    # may land after the short swarm window, so only the serving
    # verdict (convergence + service) is asserted
