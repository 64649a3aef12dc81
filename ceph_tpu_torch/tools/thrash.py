"""thrash: seeded EC thrash runner with a JSON verdict, on the port.

ceph_tpu_torch's own copy of ``tools/thrash.py`` (``main``'s arguments,
``_ec_profile``, ``_run`` and ``_run_proc``): assemble a TestCluster in
one process (or, with ``--proc``, a ProcCluster of daemon processes) on
``--device``, create a k/m EC pool, run a
deterministic fault schedule (OSD kill/revive/flap, one rolling
partition, bitrot on a fraction of reads) under concurrent
oracle-checked writers, then demand convergence — active+clean, a
deep-scrub round finding nothing after one repair pass, and byte-exact
oracle reads.

Usage:
    python3 -m ceph_tpu_torch.tools.thrash --seed 20260803 --duration 20
    python3 -m ceph_tpu_torch.tools.thrash --seed 7 --device cpu \
        --profile liberation
    python3 -m ceph_tpu_torch.tools.thrash --proc --backend shm \
        --seed 20260803 --duration 20 --osds 6 --objects 24 --settle 150

``--device`` names where the cluster's codecs and placement run (the
CUDA card when left out; with ``--proc``, every OSD process's device).
``--chip-loss`` runs the EC pool over the device mesh (``parallel/``):
``--chips`` slots of ``--mesh-width``, a virtual mesh on ``--device``
(pinned with ``parallel.pin_virtual``) unless the machine has that many
cards, collective repair by ``allgather``; the verdict gains the mesh
ledger. ``--schedule-only`` prints the schedule for any arguments.

Exit codes: 0 the verdict passed, 1 it failed, 2 usage error.
Same seed => same schedule => same verdict (the replayability
contract the fault plane exists for).
"""
from __future__ import annotations

import argparse
import asyncio
import json
import sys


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="ceph_tpu_torch.tools.thrash", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=0,
                    help="fault-plane seed (default %(default)s)")
    ap.add_argument("--duration", type=float, default=20.0,
                    help="thrash phase seconds (default %(default)s)")
    ap.add_argument("--osds", type=int, default=5)
    ap.add_argument("--mons", type=int, default=1,
                    help=">1 runs a Paxos quorum and enables mon "
                         "failover events")
    ap.add_argument("--k", type=int, default=3)
    ap.add_argument("--m", type=int, default=2)
    ap.add_argument("--profile", default="rs",
                    choices=("rs", "clay", "blaum_roth", "liberation",
                             "lrc"),
                    help="EC codec family for the thrashed pool "
                         "(default %(default)s). Non-RS arms exercise "
                         "each repair-economics codec's verify-on-read"
                         " + batched decode/repair path; blaum_roth/"
                         "liberation force m=2 (RAID6 codes); lrc "
                         "splits into two locality groups "
                         "(l=(k+m)/2) when k and m are even, else "
                         "one (l=k+m) — stored chunks grow by one "
                         "local parity per group, so --osds must "
                         "cover the codec's chunk_count")
    ap.add_argument("--pg-num", type=int, default=8)
    ap.add_argument("--max-unavail", type=int, default=None,
                    help="max simultaneously killed/partitioned OSDs "
                         "(default: m)")
    ap.add_argument("--bitrot", type=float, default=0.01,
                    help="P(bit-flip) per shard read (default 1%%)")
    ap.add_argument("--chip-loss", action="store_true",
                    help="thrash the multi-chip data plane: run the "
                         "pool on a forced host-device mesh (device "
                         "engine, collective repair) and schedule "
                         "mesh-chip losses — a dark chip fails EC "
                         "device dispatches on its owning OSDs")
    ap.add_argument("--chips", type=int, default=8,
                    help="mesh device count for --chip-loss "
                         "(default %(default)s)")
    ap.add_argument("--mesh-width", type=int, default=2,
                    help="mesh width axis for --chip-loss (must "
                         "divide --chips; default %(default)s)")
    ap.add_argument("--stragglers", type=int, default=0,
                    help="straggle/unstraggle events keeping up to N "
                         "OSDs persistently slow (seeded lognormal "
                         "service-time inflation; the hedged-read "
                         "arm of the fault mix — default off)")
    ap.add_argument("--proc", action="store_true",
                    help="thrash a ProcCluster: REAL daemon processes "
                         "(kill -9 means kill -9), durable stores, "
                         "the asok deep-scrub verdict. Partitions "
                         "and bitrot are in-process fault-plane "
                         "verbs and are disabled in this mode")
    ap.add_argument("--backend", default="tcp",
                    choices=("tcp", "shm"),
                    help="--proc messenger backend "
                         "(default %(default)s)")
    ap.add_argument("--objectstore", default="walstore",
                    help="--proc daemon store kind "
                         "(default %(default)s)")
    ap.add_argument("--no-partitions", action="store_true")
    ap.add_argument("--objects", type=int, default=8)
    ap.add_argument("--obj-size", type=int, default=24 << 10)
    ap.add_argument("--writers", type=int, default=4)
    ap.add_argument("--settle", type=float, default=90.0,
                    help="post-heal convergence deadline seconds")
    ap.add_argument("--device", default=None,
                    help="torch device of the cluster's codecs and "
                         "placement (default: the CUDA card)")
    ap.add_argument("--schedule-only", action="store_true",
                    help="print the deterministic schedule and exit "
                         "(no cluster)")
    args = ap.parse_args(argv)
    if args.profile in ("blaum_roth", "liberation"):
        args.m = 2  # RAID6 code families
    if args.profile == "lrc":
        # k/m/l generation adds one local parity per group; size grows
        args.m = max(args.m, 2)
    if args.k < 2 or args.m < 1 or args.osds < args.k + args.m:
        ap.error("need osds >= k + m, k >= 2, m >= 1")
    if args.chip_loss and args.chips % args.mesh_width:
        ap.error(f"--mesh-width {args.mesh_width} does not divide "
                 f"--chips {args.chips}")
    max_unavail = args.max_unavail if args.max_unavail is not None \
        else args.m

    from ..cluster.faults import build_schedule

    if args.schedule_only:
        sched = build_schedule(args.seed, args.duration, args.osds,
                               max_unavail=max_unavail,
                               partitions=not args.no_partitions,
                               mon_flaps=args.mons > 1,
                               chip_loss=args.chip_loss,
                               n_chips=args.chips,
                               stragglers=args.stragglers)
        print(json.dumps({"seed": args.seed,
                          "events": [[e.t, e.kind, e.target]
                                     for e in sched]}, indent=1))
        return 0

    if args.chip_loss:
        # a mesh of --chips slots: n cards where the machine has them,
        # else a virtual mesh of --chips slots on --device
        from .. import parallel

        parallel.pin_virtual(args.chips)

    if args.proc:
        verdict = asyncio.run(_run_proc(args, max_unavail))
    else:
        verdict = asyncio.run(_run(args, max_unavail))
    print(json.dumps(verdict, indent=1, sort_keys=True))
    return 0 if verdict["passed"] else 1


def _ec_profile(args, backend: str) -> dict:
    """ec_profile for the thrashed pool per --profile (the codec arm
    of the repair-economics pipeline; rs stays the legacy default)."""
    if args.profile == "rs":
        return {"plugin": "rs_tpu", "k": str(args.k),
                "m": str(args.m), "backend": backend}
    if args.profile in ("blaum_roth", "liberation"):
        return {"plugin": "bitmatrix", "technique": args.profile,
                "k": str(args.k), "m": "2", "backend": backend}
    if args.profile == "clay":
        return {"plugin": "clay", "k": str(args.k), "m": str(args.m),
                "backend": backend}
    # lrc: two locality groups when k and m split evenly, else one
    groups = 2 if args.k % 2 == 0 and args.m % 2 == 0 else 1
    l = (args.k + args.m) // groups  # noqa: E741 (reference name)
    return {"plugin": "lrc", "k": str(args.k), "m": str(args.m),
            "l": str(l), "backend": backend}


async def _run(args, max_unavail: int) -> dict:
    from ..cluster.faults import Thrasher
    from ..cluster.vstart import TestCluster
    from ..ec import load_codec
    from ..placement.osdmap import Pool

    osd_conf = None
    backend = "auto"
    if args.chip_loss:
        # the multi-chip serving path under thrash: device engine,
        # mesh-sharded encode staging, collective repair — the arm
        # that proves a chip loss degrades and repairs through the
        # mesh, not just through messenger fan-in
        osd_conf = {
            "osd_ec_mesh_devices": args.chips,
            "osd_ec_mesh_width": args.mesh_width,
            "parallel_repair_mode": "allgather",
        }
        backend = "device"
    profile = _ec_profile(args, backend)
    size = load_codec(dict(profile),
                      device=args.device).get_chunk_count()
    if args.osds < size:
        raise SystemExit(
            f"--profile {args.profile} stores {size} chunks: need "
            f"--osds >= {size}")
    c = TestCluster(n_osds=args.osds, n_mons=args.mons,
                    fault_seed=args.seed, osd_conf=osd_conf,
                    device=args.device)
    await c.start()
    # the oracle's ordering contract: one tid per op for the whole
    # thrash — the op must outlive any partition, so the deadline
    # has to exceed the thrash+settle horizon
    c.client.op_timeout = args.duration + args.settle + 60.0
    pool_id = await c.client.create_pool(Pool(
        id=2, name="thrash", size=size, min_size=args.k,
        pg_num=args.pg_num, crush_rule=1, type="erasure",
        ec_profile=profile))
    await c.wait_active(30)
    thrasher = Thrasher(
        c, pool_id, seed=args.seed, duration=args.duration,
        max_unavail=max_unavail, bitrot_p=args.bitrot,
        partitions=not args.no_partitions, mon_flaps=args.mons > 1,
        n_objects=args.objects, obj_size=args.obj_size,
        writers=args.writers, settle_timeout=args.settle,
        chip_loss=args.chip_loss, n_chips=args.chips,
        stragglers=args.stragglers)
    try:
        verdict = await thrasher.run()
        verdict["health"] = c.mon.health()
        verdict["ec_profile"] = args.profile
        econ: dict = {}
        for o in c.osds:
            if o is None:
                continue
            d = o.perf.dump()
            for key in ("ec_batches", "ec_decode_batches",
                        "ec_batch_isolated", "ec_read_crc_err",
                        "ec_read_repairs", "ec_repair_subchunk",
                        "ec_repair_bytes_fetched",
                        "ec_repair_bytes_rebuilt"):
                econ[key] = econ.get(key, 0) + int(d.get(key, 0))
        verdict["ec_counters"] = econ
        if args.chip_loss:
            from ..parallel import runtime

            # the mesh ledger proves the serving path actually ran
            # sharded (encode dispatches > 0) and repaired through
            # collectives (decode dispatches) with zero host gathers
            verdict["mesh"] = runtime.STATS.dump()
    finally:
        await c.stop()
    return verdict


async def _run_proc(args, max_unavail: int) -> dict:
    """Process-tier thrash: the same seeded schedule applied to a
    ProcCluster of REAL daemon processes over the chosen messenger
    backend (tcp or shm).  kill means SIGKILL of an OS process;
    revive means a cold daemon restart against its durable store.
    Partition/bitrot/straggle events are in-process fault-plane verbs
    with no cross-process equivalent, so the schedule is built with
    partitions off and any residual non-kill event is skipped (and
    counted, so seed⇒schedule determinism stays auditable).

    Verdict demands: post-heal active+clean, byte-exact oracle reads,
    a zero-inconsistency asok deep-scrub round, and a leak-free hedge
    ledger (canceled == fired - won) summed across daemons."""
    import shutil
    import tempfile

    import numpy as np

    from ..cluster.faults import build_schedule
    from ..cluster.procstart import ProcCluster
    from ..ec import load_codec
    from ..placement.osdmap import Pool

    profile = _ec_profile(args, "auto")
    size = load_codec(dict(profile),
                      device=args.device).get_chunk_count()
    if args.osds < size:
        raise SystemExit(
            f"--profile {args.profile} stores {size} chunks: need "
            f"--osds >= {size}")
    sched = build_schedule(args.seed, args.duration, args.osds,
                           max_unavail=max_unavail, partitions=False)

    data_dir = tempfile.mkdtemp(prefix="ctpu-thrash-proc-")
    c = ProcCluster(data_dir, n_osds=args.osds, n_mons=args.mons,
                    objectstore=args.objectstore,
                    backend=args.backend, device=args.device)
    applied: list[list] = []
    skipped = 0
    writes = {"ok": 0, "err": 0}
    oracle: dict[str, bytes] = {}
    try:
        await c.start()
        c.client.op_timeout = args.duration + args.settle + 60.0
        pool_id = await c.client.create_pool(Pool(
            id=2, name="thrash", size=size, min_size=args.k,
            pg_num=args.pg_num, crush_rule=1, type="erasure",
            ec_profile=profile))
        await c.wait_active(60)

        stop_ev = asyncio.Event()

        async def writer(wid: int) -> None:
            r = np.random.default_rng((args.seed << 8) ^ wid)
            while not stop_ev.is_set():
                name = f"obj-{int(r.integers(args.objects))}"
                data = r.integers(0, 256, args.obj_size,
                                  dtype=np.uint8).tobytes()
                try:
                    await c.client.write_full(pool_id, name, data)
                except Exception:
                    writes["err"] += 1
                else:
                    # full-object writes through ONE client serialize
                    # per name, so last-acked == authoritative
                    oracle[name] = data
                    writes["ok"] += 1
                await asyncio.sleep(0.05)

        writers = [asyncio.get_running_loop().create_task(writer(i))
                   for i in range(args.writers)]

        loop = asyncio.get_running_loop()
        t0 = loop.time()
        for ev in sched:
            delay = t0 + ev.t - loop.time()
            if delay > 0:
                await asyncio.sleep(delay)
            proc = c.procs.get(f"osd.{ev.target}")
            if ev.kind == "kill" and proc is not None:
                c.kill_osd(ev.target)
                applied.append([round(ev.t, 2), "kill", ev.target])
            elif ev.kind == "revive" and proc is None:
                await c.revive_osd(ev.target)
                applied.append([round(ev.t, 2), "revive", ev.target])
            else:
                skipped += 1
        for i in range(args.osds):
            if c.procs.get(f"osd.{i}") is None:
                await c.revive_osd(i)

        stop_ev.set()
        await asyncio.gather(*writers, return_exceptions=True)

        converged = True
        try:
            await c.wait_active(args.settle)
        except asyncio.TimeoutError:
            converged = False

        byte_exact = converged
        mismatches = 0
        if converged:
            for name, want in sorted(oracle.items()):
                try:
                    got = await c.client.read(pool_id, name)
                except Exception:
                    got = None
                if got is None or bytes(got) != want:
                    mismatches += 1
            byte_exact = mismatches == 0

        scrub_pgs = 0
        scrub_inconsistent = 0
        hedges = {"ec_hedges_fired": 0, "ec_hedges_won": 0,
                  "ec_hedges_canceled": 0}
        scrub_repaired = 0
        if converged:
            # one repair pass, then a round that must find NOTHING
            # (the in-process thrasher's deep-scrub contract)
            rep1 = await c.scrub_all()
            scrub_repaired = sum(v["repaired"] for v in rep1.values())
            rep = await c.scrub_all()
            scrub_pgs = len(rep)
            scrub_inconsistent = sum(len(v["inconsistent"])
                                     for v in rep.values())
            for i in range(args.osds):
                if c.procs.get(f"osd.{i}") is None:
                    continue
                d = await c.asok(f"osd.{i}", "perf dump")
                for key in hedges:
                    hedges[key] += int(d.get(key, 0))
        hedge_leak_free = (hedges["ec_hedges_canceled"]
                           == hedges["ec_hedges_fired"]
                           - hedges["ec_hedges_won"])

        passed = (converged and byte_exact
                  and scrub_inconsistent == 0 and hedge_leak_free
                  and writes["ok"] > 0)
        return {
            "passed": passed,
            "mode": "proc",
            "backend": args.backend,
            "objectstore": args.objectstore,
            "seed": args.seed,
            "duration_s": args.duration,
            "n_osds": args.osds,
            "ec_profile": args.profile,
            "events": applied,
            "events_scheduled": len(sched),
            "events_skipped": skipped,
            "writes": writes,
            "oracle_objects": len(oracle),
            "converged": converged,
            "byte_exact": byte_exact,
            "oracle_mismatches": mismatches,
            "scrub_pgs": scrub_pgs,
            "scrub_repaired_first_pass": scrub_repaired,
            "scrub_inconsistent": scrub_inconsistent,
            "hedges": hedges,
            "hedge_leak_free": hedge_leak_free,
            "daemon_cpu_s": round(c.cpu_seconds(), 2),
        }
    finally:
        await c.stop()
        shutil.rmtree(data_dir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
