"""swarm: the million-object multi-tenant serving harness.

The bench drove one client at 16-deep for nine rounds; production
serves millions of users.  This harness closes that gap in ONE process:
thousands of simulated clients (lightweight actors sharing a few
RadosClient aio windows — the write-path pipelining is what lets one reactor
sustain O(10^4) in-flight ops) issue Zipf-skewed traffic across
multiple pools/namespaces with mixed op shapes:

- ``put4k`` / ``get4k`` — 4 KiB RGW-ish PUT/GET on a replicated pool,
  object popularity Zipf-drawn from a million-name space (hot-key
  contention and per-object ordering chains are the p999 story);
- ``put4m`` — 4 MiB RBD-ish full-stripe writes on an EC pool (the
  config-6 shape under swarm interference);
- ``omap`` — omap-heavy bucket-index ops (setkeys + get on shared
  index shards).

Reported per shape: p50/p99/p999 latency AND MiB/s — arXiv:1804.10331's
point that load balancing is a tail-latency problem, not a bandwidth
one, is only visible in percentiles.  Alongside: aggregate in-flight
occupancy (sampled; the >= 10^4 sustained claim is measured, not
asserted), the placement-resolver counter block (cache hits/misses,
batched device lookups — the serving plane's evidence), and dispatch
counters from every OSD.

Modes:

- ``qos=...`` — mClock isolation proof: a bulk tenant (weight-only,
  64 KiB hammering) and a latency tenant (reservation-backed, paced
  4 KiB) on the SAME daemons; the verdict carries each tenant's
  achieved ops/s and percentiles so "the reservation held" is a number
  (cluster/scheduler.py knobs finally proven under saturation).
- ``thrash_secs > 0`` — a seeded kill/revive schedule runs DURING the
  swarm (the combined scenario the ROADMAP asked for); the verdict
  demands post-heal convergence.
- ``placement_batch=False`` — the A/B arm (CEPH_TPU_PLACEMENT_BATCH=0
  equivalent): pure memo+host placement, so the batched resolver's win
  is attributable.

Sharded fabric mode (``run_fabric`` / ``--fabric``): offered load
comes from N REACTOR PROCESSES, each owning a disjoint client slice
with its own event loop — the GIL stops bounding offered load at one
process's ceiling.  Workers report per-shape latency HISTOGRAMS
(utils/lathist.py) over a JSON-line results pipe; the parent merges
histograms and reads exact p50/p99/p999 off the merged counts.
Percentiles are NEVER averaged across workers, and nothing pickled
crosses the pipe.  Backends: ``local`` (each worker boots its own
in-process cluster — the sharded-everything upper bound), ``tcp`` /
``shm`` (workers dial a shared ProcCluster of real daemon processes
over the chosen messenger backend).

CLI:
    python -m ceph_tpu_torch.tools.swarm --clients 2000 --duration 8
    python -m ceph_tpu_torch.tools.swarm --qos --duration 6
    python -m ceph_tpu_torch.tools.swarm --thrash-secs 5 --clients 500
    python -m ceph_tpu_torch.tools.swarm --fabric --backend shm --workers 4

ceph_tpu_torch's own copy of ``tools/swarm.py``. ``--device`` (the
``device`` keyword of ``run_swarm`` and ``run_fabric``) names where the
clusters' codecs and placement and the swarm's clients run: the CUDA
card when left out (with no card the cluster raises; it never drops to
the CPU), ``cpu`` for the plain versions. The EC pool's ``put4m``
writes run K1 and K2, and the clients' batched placement lookups K4.
``--fabric`` spawns its workers as ``python -m
ceph_tpu_torch.tools.swarm --fabric-worker`` and its ``ProcCluster`` is
the port's, every daemon and worker on the same device.
"""
from __future__ import annotations

import argparse
import asyncio
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]

from ..utils.lathist import LatHist

#: pool ids (outside the test-suite's habitual 1/2)
POOL_SMALL = 21   # replicated: put4k/get4k/omap
POOL_BIG = 22     # erasure: put4m
POOL_LAT = 23     # replicated: the latency tenant's private pool

#: default op mix (actor weights)
DEFAULT_MIX = {"put4k": 0.45, "get4k": 0.40, "omap": 0.10,
               "put4m": 0.05}

#: fabric results-pipe line marker (one JSON line per worker; the
#: parent takes the LAST marked line so stray daemon chatter on the
#: same fd never corrupts the protocol)
_FABRIC_TAG = "CTPU_FABRIC1 "


def _shape_report(hist: LatHist, data_bytes: int, dt: float) -> dict:
    return {
        "ops": hist.count,
        "ops_s": round(hist.count / dt, 1) if dt else 0.0,
        "mib_s": round(data_bytes / dt / 2**20, 2) if dt else 0.0,
        "p50_ms": round(hist.percentile(0.50), 2),
        "p99_ms": round(hist.percentile(0.99), 2),
        "p999_ms": round(hist.percentile(0.999), 2),
    }


class _Recorder:
    """Per-shape latency/byte/miss ledger, fed by completion
    callbacks on the loop.  Latencies land in mergeable log-bucket
    histograms (utils/lathist.py), never raw sample lists: one
    recorder per REACTOR PROCESS, and the fabric parent merges
    bucket counts — merging percentiles would be wrong the moment
    there is a second source of load."""

    def __init__(self) -> None:
        self.hist: dict[str, LatHist] = {}
        self.bytes: dict[str, int] = {}
        self.errors: dict[str, int] = {}
        self.get_misses = 0
        self.objects: set = set()

    def note(self, shape: str, dt: float, nbytes: int,
             exc: BaseException | None) -> None:
        if exc is not None:
            if shape == "get4k" and isinstance(exc, KeyError):
                self.get_misses += 1  # Zipf tail read-before-write
            else:
                self.errors[shape] = self.errors.get(shape, 0) + 1
                return
        h = self.hist.get(shape)
        if h is None:
            h = self.hist[shape] = LatHist()
        h.note_s(dt)
        self.bytes[shape] = self.bytes.get(shape, 0) + nbytes


async def _actor(aid: int, rec: _Recorder, clients: list,
                 big_sem: asyncio.Semaphore, mix: dict, seed: int,
                 n_objects: int, zipf_s: float, payload4k: bytes,
                 payload4m: bytes, t_end: float, depth: int) -> None:
    """One simulated client: submit through a shared aio window,
    record completion latency per op shape. ``depth`` bounds the
    actor's own in-flight ops (the window bounds the process);
    ``big_sem`` additionally bounds 4 MiB ops process-wide — each one
    stages (k+m, T, su) server-side, so an unbounded swarm of them
    would measure the allocator, not the serving plane."""
    from ..cluster import messages as M
    from ..cluster.client import ObjectOperation

    rng = np.random.default_rng((seed << 20) ^ aid)
    cl = clients[aid % len(clients)]
    shapes = list(mix)
    weights = np.array([mix[s] for s in shapes], dtype=np.float64)
    weights /= weights.sum()
    ns = f"t{aid % 4}"   # namespace by actor cohort
    sem = asyncio.Semaphore(depth)
    loop = asyncio.get_running_loop()

    def draw_name(space: int) -> str:
        rank = int(rng.zipf(zipf_s))
        return f"o-{min(rank, space)}"

    while loop.time() < t_end:
        shape = shapes[int(rng.choice(len(shapes), p=weights))]
        await sem.acquire()
        is_big = shape == "put4m"
        if is_big:
            await big_sem.acquire()
        t0 = time.perf_counter()
        try:
            if shape == "put4k":
                name = f"{ns}-{draw_name(n_objects)}"
                comp = await cl.aio_write_full(POOL_SMALL, name,
                                               payload4k)
                nbytes = len(payload4k)
            elif shape == "get4k":
                name = f"{ns}-{draw_name(n_objects)}"
                comp = await cl.aio_submit(
                    POOL_SMALL, name,
                    [M.osd_op("read", offset=0, length=-1)])
                nbytes = len(payload4k)
            elif is_big:
                name = f"big-{int(rng.integers(64))}"
                comp = await cl.aio_write_full(POOL_BIG, name,
                                               payload4m)
                nbytes = len(payload4m)
            else:  # omap index op
                op = ObjectOperation()
                key = f"k{int(rng.integers(4096))}".encode()
                op.omap_set({key: payload4k[:64]})
                op.omap_get_keys()
                name = f"idx-{ns}-{int(rng.integers(64))}"
                comp = await cl.aio_operate(POOL_SMALL, name, op)
                nbytes = 128
        except Exception:
            sem.release()
            if is_big:
                big_sem.release()
            continue
        rec.objects.add(name)

        def done(c, shape=shape, t0=t0, nbytes=nbytes, is_big=is_big):
            sem.release()
            if is_big:
                big_sem.release()
            try:
                r = c.result()
            except BaseException as e:
                rec.note(shape, time.perf_counter() - t0, 0, e)
            else:
                if shape == "get4k" and getattr(r, "outs", None):
                    nbytes = len(r.outs[0][1])
                rec.note(shape, time.perf_counter() - t0, nbytes, None)

        comp.add_done_callback(done)
    # drain this actor's own in-flight before returning
    for _ in range(depth):
        await sem.acquire()


async def _sample_inflight(clients: list, samples: list,
                           stop: asyncio.Event) -> None:
    """Timestamped aggregate in-flight samples: the sustained claim is
    computed over the OFFERED-load phase (samples before t_end) — the
    post-deadline drain of 10^4-deep queues runs for as long as the
    tail latency says and would dilute the mean with the decay."""
    loop = asyncio.get_running_loop()
    while not stop.is_set():
        samples.append((loop.time(),
                        sum(cl._aio_inflight for cl in clients)))
        try:
            await asyncio.wait_for(stop.wait(), 0.05)
        except asyncio.TimeoutError:
            pass


async def _run_thrash_arm(cluster, seed: int, secs: float) -> dict:
    """A seeded kill/revive schedule DURING the swarm (no partitions:
    the swarm clients would be cut too, measuring the partition, not
    the serving plane). Heals everything afterwards; convergence is
    awaited by the caller."""
    from ..cluster.faults import build_schedule

    sched = build_schedule(seed, secs, cluster.n_osds, max_unavail=1,
                           partitions=False)
    loop = asyncio.get_running_loop()
    t0 = loop.time()
    applied = []
    for ev in sched:
        delay = t0 + ev.t - loop.time()
        if delay > 0:
            await asyncio.sleep(delay)
        if ev.kind == "kill" and cluster.osds[ev.target] is not None:
            await cluster.kill_osd(ev.target)
            applied.append([ev.t, "kill", ev.target])
        elif ev.kind == "revive" and cluster.osds[ev.target] is None:
            await cluster.revive_osd(ev.target)
            applied.append([ev.t, "revive", ev.target])
    for i, osd in enumerate(cluster.osds):
        if osd is None:
            await cluster.revive_osd(i)
    return {"events": applied, "scheduled": len(sched)}


async def run_swarm(*, clients: int = 2000, duration: float = 8.0,
                    seed: int = 1, n_osds: int = 10,
                    n_rados_clients: int = 4, window: int = 4096,
                    actor_depth: int = 8, n_objects: int = 1_000_000,
                    zipf_s: float = 1.1, mix: dict | None = None,
                    placement_batch: bool = True, prewarm: bool = True,
                    thrash_secs: float = 0.0,
                    qos: dict | None = None, device=None) -> dict:
    """Drive the swarm against a fresh in-process cluster and return
    the measured payload (bench config 10's body and the tier-1
    swarm tests' engine)."""
    from ..cluster.vstart import TestCluster
    from ..placement.osdmap import Pool
    from ..utils import config as cfg

    mix = dict(mix or DEFAULT_MIX)
    c = TestCluster(n_osds=n_osds, osd_conf={
        "osd_ec_batch_window": 0.01,
        "osd_ec_batch_target_stripes": 48,
        "osd_op_concurrency": 32,
        "osd_client_message_size_cap": 256 << 20,
    }, device=device)
    await c.start()

    def make_client(name: str):
        conf = cfg.proxy()
        conf.set("client_max_inflight", window)
        # 10^4-deep pipelines run at seconds of queueing latency by
        # design; the default 2 s resend cap would duplicate-storm
        conf.set("client_backoff_max", 30.0)
        conf.set("client_placement_batch_min", 8)
        from ..cluster.client import RadosClient

        return RadosClient(c.bus, name=name, op_timeout=300.0,
                           conf=conf, placement_batch=placement_batch,
                           device=c.device)

    swarm_clients = [make_client(f"swarm.{i}")
                     for i in range(n_rados_clients)]
    for cl in swarm_clients:
        await cl.connect()
    ec_size = 6
    await c.client.create_pool(Pool(
        id=POOL_SMALL, name="swarm-small", size=3, min_size=2,
        pg_num=64, crush_rule=0))
    await c.client.create_pool(Pool(
        id=POOL_BIG, name="swarm-big", size=ec_size, min_size=4,
        pg_num=16, crush_rule=1, type="erasure",
        ec_profile={"plugin": "rs_tpu", "k": "4", "m": "2",
                    "stripe_unit": "65536"}))
    if qos:
        await c.client.create_pool(Pool(
            id=POOL_LAT, name="swarm-lat", size=3, min_size=2,
            pg_num=32, crush_rule=0))
    await c.wait_active(60)

    rng = np.random.default_rng(seed)
    payload4k = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    payload4m = rng.integers(0, 256, 4 << 20, dtype=np.uint8).tobytes()

    # warm the pipeline (compiles, pool maps) outside the measured run
    await swarm_clients[0].write_full(POOL_SMALL, "warm", payload4k)
    if mix.get("put4m"):
        await swarm_clients[0].write_full(POOL_BIG, "warm", payload4m)
    warmed = 0
    if prewarm and placement_batch:
        # serving-process startup warm: compile the bulk-CRUSH engine
        # and device-resolve every pool's pg table so cold jit never
        # rides a client op (counted in placement_batch_lookups)
        for cl in swarm_clients:
            pools = [POOL_SMALL, POOL_BIG] + ([POOL_LAT] if qos else [])
            warmed += await cl._placement.prewarm(cl.osdmap, pools)

    rec = _Recorder()
    samples: list[int] = []
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    sampler = loop.create_task(_sample_inflight(swarm_clients,
                                                samples, stop))
    big_sem = asyncio.Semaphore(16)
    t_end = loop.time() + duration
    t0 = time.perf_counter()

    tasks = [loop.create_task(_actor(
        a, rec, swarm_clients, big_sem, mix, seed, n_objects, zipf_s,
        payload4k, payload4m, t_end, actor_depth))
        for a in range(clients)]

    qos_out: dict = {}
    qos_tasks: list = []
    lat_rec = _Recorder()
    if qos:
        # tenants: bulk rides the swarm clients above (they are the
        # saturating load); the latency tenant gets its OWN clients,
        # pool, and a reservation-backed mClock class on every OSD
        res = float(qos.get("reservation_ops_s", 50.0))
        lat_actors = int(qos.get("lat_actors", 8))
        pace = float(qos.get("pace_s", 0.02))
        for osd in c.osds:
            if osd is None:
                continue
            osd.set_qos_tenant("swarm-lat", "tenant_lat",
                               reservation=max(1.0, res / n_osds) * 2,
                               weight=1.0)
            osd.set_qos_tenant("swarm.", "tenant_blk",
                               reservation=0.0, weight=4.0)
        lat_clients = [make_client(f"swarm-lat.{i}") for i in range(2)]
        for cl in lat_clients:
            await cl.connect()
        await lat_clients[0].write_full(POOL_LAT, "warm", payload4k)
        lat_mix = {"put4k": 0.5, "get4k": 0.5}

        async def lat_actor(aid: int) -> None:
            # private pool: redirect by overriding the pool constant
            # via a tiny shim actor (depth 1, paced = offered rate)
            cl = lat_clients[aid % len(lat_clients)]
            rng = np.random.default_rng((seed << 16) ^ (aid + 7))
            while loop.time() < t_end:
                name = f"lat-{int(rng.integers(256))}"
                t1 = time.perf_counter()
                try:
                    if rng.random() < 0.5:
                        await cl.write_full(POOL_LAT, name, payload4k)
                    else:
                        try:
                            await cl.read(POOL_LAT, name)
                        except KeyError:
                            pass
                except (IOError, asyncio.TimeoutError) as e:
                    lat_rec.note("lat4k", time.perf_counter() - t1,
                                 0, e)
                else:
                    lat_rec.note("lat4k", time.perf_counter() - t1,
                                 len(payload4k), None)
                await asyncio.sleep(pace)

        qos_tasks = [loop.create_task(lat_actor(a))
                     for a in range(lat_actors)]
        qos_out = {"reservation_ops_s": res, "lat_actors": lat_actors,
                   "offered_ops_s": round(lat_actors / pace
                                          if pace else 0.0, 1),
                   "mix": lat_mix}

    thrash_out: dict = {}
    if thrash_secs > 0:
        thrash_out = await _run_thrash_arm(c, seed, min(thrash_secs,
                                                        duration))

    await asyncio.gather(*tasks)
    for cl in swarm_clients:
        await cl.writes_wait()
    dt = time.perf_counter() - t0
    if qos_tasks:
        await asyncio.gather(*qos_tasks)
    stop.set()
    await sampler

    converged = True
    if thrash_secs > 0:
        try:
            await c.wait_clean(120)
        except asyncio.TimeoutError:
            converged = False

    # ---- ledgers
    from ..placement.resolver import PlacementStats
    place = PlacementStats.aggregate(
        [cl.placement_stats() for cl in swarm_clients])
    osd_tot: dict = {}
    for osd in c.osds:
        if osd is None:
            continue
        d = osd.perf.dump()
        for key in ("op", "op_w", "op_r", "ec_batches",
                    "ov_apply_calls", "ov_apply_extents",
                    "ec_batch_failures", "client_op_retries"):
            if key in d:
                osd_tot[key] = osd_tot.get(key, 0) + int(d[key])
    window_stats = [dict(cl.window_stats) for cl in swarm_clients]
    occ_mean = [round(w["sum"] / w["count"], 1) if w["count"] else 0.0
                for w in window_stats]

    shapes_out = {
        s: _shape_report(rec.hist.get(s) or LatHist(),
                         rec.bytes.get(s, 0), dt)
        for s in mix
    }
    active = [v for t, v in samples if t <= t_end]
    # drop the leading ramp (actors spinning up): sustained is the
    # steady back 80% of the offered-load phase
    mid = active[len(active) // 5:] or active
    sustained = round(float(np.mean(mid)), 1) if mid else 0.0
    peak = max((v for _t, v in samples), default=0)
    total_bytes = sum(rec.bytes.values())
    total_ops = sum(h.count for h in rec.hist.values())

    out = {
        "clients": clients,
        "rados_clients": n_rados_clients,
        "window_per_client": window,
        "duration_s": round(dt, 2),
        "seed": seed,
        "n_osds": n_osds,
        "zipf_s": zipf_s,
        "namespace_objects": n_objects,
        "distinct_objects_touched": len(rec.objects),
        "ops": total_ops,
        "ops_s": round(total_ops / dt, 1) if dt else 0.0,
        "mib_s": round(total_bytes / dt / 2**20, 2) if dt else 0.0,
        "inflight_sustained": sustained,
        "inflight_peak": peak,
        "window_occupancy_mean": occ_mean,
        "get_misses": rec.get_misses,
        "op_errors": rec.errors,
        "shapes": shapes_out,
        "placement": place,
        "placement_batch": placement_batch,
        "placement_prewarmed_pgids": warmed,
        "osd_counters": osd_tot,
    }
    if qos:
        lat_ms = _shape_report(lat_rec.hist.get("lat4k") or LatHist(),
                               lat_rec.bytes.get("lat4k", 0), dt)
        bulk_ref = shapes_out.get("put4k", {})
        qos_out.update({
            "lat_tenant": lat_ms,
            "lat_achieved_ops_s": lat_ms.get("ops_s", 0.0),
            "bulk_p99_ms": bulk_ref.get("p99_ms", 0.0),
            "lat_p99_ms": lat_ms.get("p99_ms", 0.0),
        })
        out["qos"] = qos_out
    if thrash_secs > 0:
        out["thrash"] = {**thrash_out, "converged": converged}
    for cl in swarm_clients:
        await cl.close()
    await c.stop()
    return out


# --------------------------------------------------------------- fabric
#
# Sharded reactors: the parent never drives load itself — it spawns N
# worker PROCESSES (fresh interpreters via Popen: spawn semantics, so
# no fork ever follows a JAX runtime init), coordinates a file-based
# start barrier, and merges the per-shape histograms each worker ships
# back as one JSON line on stdout.


def _fabric_client_conf(window: int):
    from ..utils import config as cfg

    conf = cfg.proxy()
    conf.set("client_max_inflight", window)
    conf.set("client_backoff_max", 30.0)
    conf.set("client_placement_batch_min", 8)
    return conf


async def _fabric_worker(cfg_d: dict) -> dict:
    """One reactor shard: own event loop, disjoint client slice,
    private recorder.  Returns the JSON-safe result payload (histogram
    bucket dicts — never pickles, never raw sample lists)."""
    import resource

    w = int(cfg_d["worker"])
    seed = int(cfg_d["seed"])
    mix = dict(cfg_d["mix"])
    duration = float(cfg_d["duration"])
    depth = int(cfg_d.get("depth", 8))
    window = int(cfg_d.get("window", 1024))
    actors = int(cfg_d["clients"])
    n_objects = int(cfg_d.get("n_objects", 100_000))
    zipf_s = float(cfg_d.get("zipf_s", 1.1))
    barrier = Path(cfg_d["barrier"])
    device = cfg_d.get("device")

    from ..cluster.client import RadosClient
    from ..placement.osdmap import Pool

    cluster = None
    bus = None
    if cfg_d["mode"] == "local":
        # sharded-everything arm: this worker owns a PRIVATE
        # in-process cluster — the upper bound where nothing is shared
        from ..cluster.vstart import TestCluster

        cluster = TestCluster(n_osds=int(cfg_d.get("n_osds", 6)),
                              osd_conf=dict(cfg_d.get("osd_conf", {})),
                              device=device)
        await cluster.start()
        swarm_clients = [RadosClient(
            cluster.bus, name=f"fw{w}.{i}", op_timeout=300.0,
            conf=_fabric_client_conf(window), device=device)
            for i in range(int(cfg_d.get("n_rados_clients", 2)))]
        for cl in swarm_clients:
            await cl.connect()
        await cluster.client.create_pool(Pool(
            id=POOL_SMALL, name="fab-small", size=3, min_size=2,
            pg_num=32, crush_rule=0))
        await cluster.client.create_pool(Pool(
            id=POOL_BIG, name="fab-big", size=6, min_size=4,
            pg_num=16, crush_rule=1, type="erasure",
            ec_profile={"plugin": "rs_tpu", "k": "4", "m": "2",
                        "stripe_unit": "65536"}))
        await cluster.wait_active(60)
    else:
        # shared ProcCluster: dial the daemons' book over the chosen
        # messenger backend (tcp or shm)
        from ..msg.netbus import NetBus

        bus = NetBus(cfg_d["book"], backend=cfg_d["backend"])
        await bus.start()
        swarm_clients = [RadosClient(
            bus, name=f"fw{w}.{i}", op_timeout=300.0,
            conf=_fabric_client_conf(window), device=device)
            for i in range(int(cfg_d.get("n_rados_clients", 2)))]
        for cl in swarm_clients:
            await cl.connect()

    rng = np.random.default_rng(seed)
    payload4k = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    payload4m = rng.integers(0, 256, 4 << 20, dtype=np.uint8).tobytes()
    # warm outside the measured window (compiles, maps, pool waits)
    await swarm_clients[0].write_full(POOL_SMALL, f"warm-{w}",
                                      payload4k)
    if mix.get("put4m"):
        await swarm_clients[0].write_full(POOL_BIG, f"warm-{w}",
                                          payload4m)

    # barrier: ready -> wait for go (simultaneous offered load across
    # every shard; a shard that starts early would measure an idle
    # cluster)
    (barrier / f"w{w}.ready").write_text(str(os.getpid()))
    go = barrier / "go"
    deadline = time.monotonic() + 120
    while not go.exists():
        if time.monotonic() > deadline:
            raise TimeoutError("fabric start barrier never opened")
        await asyncio.sleep(0.02)

    rec = _Recorder()
    loop = asyncio.get_running_loop()
    big_sem = asyncio.Semaphore(8)
    t_end = loop.time() + duration
    ru0 = resource.getrusage(resource.RUSAGE_SELF)
    t0 = time.perf_counter()
    tasks = [loop.create_task(_actor(
        (w << 16) | a, rec, swarm_clients, big_sem, mix,
        seed + w, n_objects, zipf_s, payload4k, payload4m, t_end,
        depth)) for a in range(actors)]
    await asyncio.gather(*tasks)
    for cl in swarm_clients:
        await cl.writes_wait()
    dt = time.perf_counter() - t0
    ru1 = resource.getrusage(resource.RUSAGE_SELF)
    cpu_s = (ru1.ru_utime - ru0.ru_utime) + (ru1.ru_stime
                                             - ru0.ru_stime)

    out = {
        "worker": w,
        "dt": round(dt, 3),
        "cpu_s": round(cpu_s, 3),
        "ops": sum(h.count for h in rec.hist.values()),
        "objects": len(rec.objects),
        "get_misses": rec.get_misses,
        "errors": rec.errors,
        "shapes": {
            s: {"hist": h.to_json(), "bytes": rec.bytes.get(s, 0)}
            for s, h in rec.hist.items()
        },
    }
    for cl in swarm_clients:
        await cl.close()
    if cluster is not None:
        await cluster.stop()
    if bus is not None:
        await bus.close()
    return out


def _fabric_worker_main(cfg_json: str) -> int:
    out = asyncio.run(_fabric_worker(json.loads(cfg_json)))
    sys.stdout.write(_FABRIC_TAG + json.dumps(out) + "\n")
    sys.stdout.flush()
    return 0


async def run_fabric(*, backend: str = "tcp", n_workers: int = 2,
                     clients_per_worker: int = 200,
                     duration: float = 4.0, seed: int = 1,
                     n_osds: int = 6, mix: dict | None = None,
                     data_dir: str | None = None, window: int = 1024,
                     depth: int = 8, n_objects: int = 100_000,
                     zipf_s: float = 1.1,
                     osd_conf: dict | None = None,
                     device=None) -> dict:
    """Sharded fabric run: N reactor processes against one topology.

    ``backend="local"``: every worker boots a private in-process
    cluster (nothing shared — the pure sharding upper bound).
    ``"tcp"`` / ``"shm"``: ONE shared ProcCluster of real daemon
    processes; workers dial its book over the chosen messenger.
    Returns the merged verdict: per-shape histograms merged bucket-
    wise (exact percentiles), plus the cpu-seconds ledger split into
    worker and daemon halves.
    """
    import shutil
    import tempfile

    if backend not in ("local", "tcp", "shm"):
        raise ValueError(f"unknown fabric backend {backend!r}")
    mix = dict(mix or DEFAULT_MIX)
    osd_conf = dict(osd_conf or {
        "osd_ec_batch_window": 0.01,
        "osd_ec_batch_target_stripes": 48,
        "osd_op_concurrency": 32,
        "osd_client_message_size_cap": 256 << 20,
    })
    own_dir = data_dir is None
    data_dir = data_dir or tempfile.mkdtemp(prefix="ctpu-fabric-")
    barrier = Path(data_dir) / "barrier"
    shutil.rmtree(barrier, ignore_errors=True)
    barrier.mkdir(parents=True)

    cluster = None
    cpu_daemons0 = 0.0
    if backend != "local":
        from ..cluster.procstart import ProcCluster
        from ..placement.osdmap import Pool

        cluster = ProcCluster(data_dir, n_osds=n_osds,
                              objectstore="memstore", backend=backend,
                              osd_conf=osd_conf, device=device)
        await cluster.start()
        await cluster.client.create_pool(Pool(
            id=POOL_SMALL, name="fab-small", size=3, min_size=2,
            pg_num=32, crush_rule=0))
        await cluster.client.create_pool(Pool(
            id=POOL_BIG, name="fab-big", size=6, min_size=4,
            pg_num=16, crush_rule=1, type="erasure",
            ec_profile={"plugin": "rs_tpu", "k": "4", "m": "2",
                        "stripe_unit": "65536"}))
        await cluster.wait_active(60)

    env = dict(os.environ)
    env["PYTHONPATH"] = str(_REPO) + os.pathsep + env.get(
        "PYTHONPATH", "")
    procs: list[subprocess.Popen] = []
    logs = []
    try:
        for w_i in range(n_workers):
            cfg_d = {
                "mode": "local" if backend == "local" else "proc",
                "backend": backend,
                "book": (cluster.book if cluster is not None
                         else ""),
                "barrier": str(barrier),
                "worker": w_i,
                "n_workers": n_workers,
                "clients": clients_per_worker,
                "duration": duration,
                "seed": seed,
                "mix": mix,
                "window": window,
                "depth": depth,
                "n_objects": n_objects,
                "zipf_s": zipf_s,
                "n_osds": n_osds,
                "osd_conf": osd_conf,
                "device": None if device is None else str(device),
            }
            log = open(Path(data_dir) / f"worker.{w_i}.err", "wb")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "ceph_tpu_torch.tools.swarm",
                 "--fabric-worker", json.dumps(cfg_d)],
                stdout=subprocess.PIPE, stderr=log, env=env))

        # barrier: all shards ready -> open the gate together
        deadline = time.monotonic() + 120
        while True:
            ready = sum((barrier / f"w{i}.ready").exists()
                        for i in range(n_workers))
            if ready == n_workers:
                break
            for i, p in enumerate(procs):
                if p.poll() is not None:
                    raise RuntimeError(
                        f"fabric worker {i} died before the barrier "
                        f"(rc={p.returncode}, see "
                        f"{data_dir}/worker.{i}.err)")
            if time.monotonic() > deadline:
                raise TimeoutError("fabric workers never all readied")
            await asyncio.sleep(0.05)
        if cluster is not None:
            cpu_daemons0 = cluster.cpu_seconds()
        (barrier / "go").write_text("go")

        # results pipe: one tagged JSON line per worker
        loop = asyncio.get_running_loop()
        outs = []
        for i, p in enumerate(procs):
            raw = await asyncio.wait_for(
                loop.run_in_executor(None, p.communicate),
                duration + 600)
            lines = [ln for ln in raw[0].decode().splitlines()
                     if ln.startswith(_FABRIC_TAG)]
            if p.returncode != 0 or not lines:
                raise RuntimeError(
                    f"fabric worker {i} failed (rc={p.returncode}, "
                    f"see {data_dir}/worker.{i}.err)")
            outs.append(json.loads(lines[-1][len(_FABRIC_TAG):]))
        cpu_daemons = (cluster.cpu_seconds() - cpu_daemons0
                       if cluster is not None else 0.0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
        if cluster is not None:
            await cluster.stop()

    # merge: histograms bucket-wise, byte/err counters by sum; the
    # wall clock of the run is the SLOWEST shard's window (offered
    # load overlapped for at least that long)
    dt = max(o["dt"] for o in outs)
    hists: dict[str, LatHist] = {}
    bytes_: dict[str, int] = {}
    errors: dict[str, int] = {}
    for o in outs:
        for s, d in o["shapes"].items():
            hists.setdefault(s, LatHist()).merge(
                LatHist.from_json(d["hist"]))
            bytes_[s] = bytes_.get(s, 0) + int(d["bytes"])
        for s, n in o.get("errors", {}).items():
            errors[s] = errors.get(s, 0) + int(n)
    shapes_out = {s: _shape_report(hists[s], bytes_.get(s, 0), dt)
                  for s in hists}
    cpu_workers = sum(o["cpu_s"] for o in outs)
    write_bytes = sum(bytes_.get(s, 0) for s in bytes_
                      if s.startswith("put"))
    total_bytes = sum(bytes_.values())
    write_mib = write_bytes / 2**20
    cpu_total = cpu_workers + cpu_daemons
    out = {
        "backend": backend,
        "workers": n_workers,
        "clients_per_worker": clients_per_worker,
        "host_cpus": os.cpu_count(),
        "duration_s": round(dt, 2),
        "seed": seed,
        "n_osds": n_osds,
        "ops": sum(o["ops"] for o in outs),
        "ops_s": round(sum(o["ops"] for o in outs) / dt, 1)
        if dt else 0.0,
        "mib_s": round(total_bytes / dt / 2**20, 2) if dt else 0.0,
        "write_mib_s": round(write_mib / dt, 2) if dt else 0.0,
        "get_p99_ms": shapes_out.get("get4k", {}).get("p99_ms", 0.0),
        "cpu_s_workers": round(cpu_workers, 2),
        "cpu_s_daemons": round(cpu_daemons, 2),
        "cpu_s_per_mib": (round(cpu_total / write_mib, 4)
                          if write_mib else 0.0),
        "get_misses": sum(o.get("get_misses", 0) for o in outs),
        "op_errors": errors,
        "distinct_objects_touched": sum(o["objects"] for o in outs),
        "shapes": shapes_out,
    }
    if own_dir:
        shutil.rmtree(data_dir, ignore_errors=True)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="ceph_tpu_torch.tools.swarm",
                                 description=__doc__,
                                 formatter_class=argparse
                                 .RawDescriptionHelpFormatter)
    ap.add_argument("--clients", type=int, default=2000)
    ap.add_argument("--duration", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--osds", type=int, default=10)
    ap.add_argument("--window", type=int, default=4096)
    ap.add_argument("--rados-clients", type=int, default=4)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--objects", type=int, default=1_000_000)
    ap.add_argument("--zipf", type=float, default=1.1)
    ap.add_argument("--thrash-secs", type=float, default=0.0)
    ap.add_argument("--qos", action="store_true",
                    help="mClock tenant-isolation mode")
    ap.add_argument("--no-placement-batch", action="store_true",
                    help="A/B arm: disable the batched resolver")
    ap.add_argument("--fabric", action="store_true",
                    help="sharded fabric mode: N reactor processes")
    ap.add_argument("--workers", type=int, default=2,
                    help="fabric: reactor process count")
    ap.add_argument("--backend", default="tcp",
                    choices=["local", "tcp", "shm"],
                    help="fabric: topology/messenger backend")
    ap.add_argument("--device", default=None,
                    help="torch device of the clusters' codecs and "
                         "placement and of the swarm's clients "
                         "(default: the CUDA card)")
    ap.add_argument("--fabric-worker", metavar="CFGJSON",
                    help=argparse.SUPPRESS)  # internal child entry
    args = ap.parse_args(argv)
    if args.fabric_worker:
        return _fabric_worker_main(args.fabric_worker)
    if args.fabric:
        out = asyncio.run(run_fabric(
            backend=args.backend, n_workers=args.workers,
            clients_per_worker=max(1, args.clients // args.workers),
            duration=args.duration, seed=args.seed, n_osds=args.osds,
            window=args.window, depth=args.depth,
            n_objects=args.objects, zipf_s=args.zipf,
            device=args.device))
        print(json.dumps(out, indent=1, sort_keys=True))
        return 0
    out = asyncio.run(run_swarm(
        clients=args.clients, duration=args.duration, seed=args.seed,
        n_osds=args.osds, window=args.window,
        n_rados_clients=args.rados_clients, actor_depth=args.depth,
        n_objects=args.objects, zipf_s=args.zipf,
        thrash_secs=args.thrash_secs,
        qos={"reservation_ops_s": 50.0} if args.qos else None,
        placement_batch=not args.no_placement_batch,
        device=args.device))
    print(json.dumps(out, indent=1, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
