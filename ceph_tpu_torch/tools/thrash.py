"""thrash: seeded EC thrash runner with a JSON verdict, on the port.

ceph_tpu_torch's own copy of the in-process arm of ``tools/thrash.py``
(``main``'s arguments, ``_ec_profile`` and ``_run``): assemble an
in-process TestCluster on ``--device``, create a k/m EC pool, run a
deterministic fault schedule (OSD kill/revive/flap, one rolling
partition, bitrot on a fraction of reads) under concurrent
oracle-checked writers, then demand convergence — active+clean, a
deep-scrub round finding nothing after one repair pass, and byte-exact
oracle reads.

Usage:
    python3 -m ceph_tpu_torch.tools.thrash --seed 20260803 --duration 20
    python3 -m ceph_tpu_torch.tools.thrash --seed 7 --device cpu \
        --profile liberation

``--device`` names where the cluster's codecs and placement run (the
CUDA card when left out). ``--chip-loss`` needs the multi-device data
plane (``parallel/``, ROADMAP §1 item 6) and ``--proc`` the process
tier (``procstart``, item 4); each raises ``NotImplementedError`` until
its module is ported, as does ``--mons`` > 1 (``paxos_mon``, item 4).
``--schedule-only`` prints the schedule for any arguments.

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
        raise NotImplementedError(
            "--chip-loss needs parallel/, which the port has not taken "
            "yet (ROADMAP §1 item 6)")
    if args.proc:
        raise NotImplementedError(
            "--proc needs cluster/procstart.py, which the port has not "
            "taken yet (ROADMAP §1 item 4)")
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

    profile = _ec_profile(args, "auto")
    size = load_codec(dict(profile),
                      device=args.device).get_chunk_count()
    if args.osds < size:
        raise SystemExit(
            f"--profile {args.profile} stores {size} chunks: need "
            f"--osds >= {size}")
    c = TestCluster(n_osds=args.osds, n_mons=args.mons,
                    fault_seed=args.seed, device=args.device)
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
    finally:
        await c.stop()
    return verdict


if __name__ == "__main__":
    sys.exit(main())
